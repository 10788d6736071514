"""Carry weights across from the JAX package's layout.

The JAX package (`butterfly_tpu`) and the port store a butterfly in the
same layout: a (NB, m0, k0) leaf and (hi, R, R, lo, m, k) levels. These
functions take those parameters as numpy arrays — e.g. `np.asarray` of a
JAX `UniformButterfly`'s factors — and build the port's objects, so that a
test can hand both packages the same operator. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from butterfly_tpu_torch.fac.distill import DistilledButterfly
from butterfly_tpu_torch.ops.butterfly import UniformButterfly
from butterfly_tpu_torch.utils.device import resolve_device

__all__ = ["uniform_butterfly_from_numpy", "distilled_from_numpy"]


def _tensor(a, device, dtype):
    t = torch.from_numpy(np.array(a))  # a copy: JAX's arrays are read-only
    return t.to(device=device, dtype=dtype or t.dtype)


def uniform_butterfly_from_numpy(
    leaf: np.ndarray | None,
    levels: Sequence[np.ndarray],
    radix: int = 2,
    precision=None,
    device=None,
    dtype: torch.dtype | None = None,
) -> UniformButterfly:
    """The port's UniformButterfly from numpy factors in the JAX layout.
    dtype=None keeps the arrays' own dtype (numpy has no bfloat16: pass
    float32 arrays and dtype=torch.bfloat16 for a bfloat16 operator)."""
    device = resolve_device(device)
    return UniformButterfly(
        None if leaf is None else _tensor(leaf, device, dtype),
        [_tensor(W, device, dtype) for W in levels],
        radix=radix, precision=precision,
    )


def distilled_from_numpy(
    leaf: np.ndarray,
    levels: Sequence[np.ndarray],
    row_perm: np.ndarray,
    rank: int,
    max_sv_discarded: float,
    sigma_max: float = 0.0,
    precision="highest",
    device=None,
    dtype: torch.dtype | None = None,
) -> DistilledButterfly:
    """The port's DistilledButterfly from a JAX one's weights and fields."""
    bf = uniform_butterfly_from_numpy(leaf, levels, 2, precision, device,
                                      dtype)
    return DistilledButterfly(
        bf=bf, row_perm=np.asarray(row_perm), rank=int(rank),
        max_sv_discarded=float(max_sv_discarded), sigma_max=float(sigma_max),
    )
