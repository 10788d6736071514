"""Configuration dataclasses.

Port counterpart of `butterfly_tpu/config.py` (reference: BfFacSpec,
include/bf/fac.h:6-29): `FacSpec` and `DeviceConfig`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class FacSpec:
    """Streaming-factorizer configuration (reference: BfFacSpec,
    include/bf/fac.h:6-29).

    Attributes:
      row_tree / col_tree: the row (index) tree and column (e.g. frequency)
        tree driving the factorization.
      row_tree_init_depth: depth of the initial row cut when feeding a new
        column-tree leaf (reference: rowTreeInitDepth).
      tol: relative truncation tolerance for the blockwise SVDs.
      min_num_rows / min_num_cols: blocks thinner than this pass through
        uncompressed (reference: minNumRows/minNumCols).
      compare_relative_errors: if True, after every merge check the merged
        factorization against the stored dense block with a random matvec
        (reference: compareRelativeErrors, src/fac_streamer.c:286-301).
    """

    row_tree: Any
    col_tree: Any
    row_tree_init_depth: int = 1
    tol: float = 1e-15
    min_num_rows: int = 20
    min_num_cols: int = 20
    compare_relative_errors: bool = False


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Device apply-path configuration, the counterpart of the JAX
    package's `DeviceConfig` (`use_kernel` in place of `use_pallas`).

    Nothing in either package reads it (`grep DeviceConfig`): each plan
    takes its dtype and engine from its own arguments. It is kept so that
    code written against the JAX package's configuration has its
    counterpart.

    dtype: dtype of the packed factors on the device. float32 keeps the
      rel err against dense near 1e-7 a level; bfloat16 runs K1 on the
      tensor cores (WGMMA); float64 has no kernel and takes the plain path.
    block_pad: pad block dims up to a multiple of this. On the TPU this
      was the MXU tile. On Hopper the sizes that matter are K2's 128 x 128
      cell tile and the 64-row step of a WGMMA instruction (K1's bf16
      engine): a block padded to 128 fills both; smaller pads keep tiny
      problems from padding waste.
    use_kernel: apply through the hand-written CUDA kernels (K1, K2) where
      the tensors lie on the card, else the plain PyTorch passes.
    """

    dtype: Any = torch.float32
    block_pad: int = 128
    use_kernel: bool = True
