"""Configuration dataclasses.

Port counterpart of `butterfly_tpu/config.py` (reference: BfFacSpec,
include/bf/fac.h:6-29). Only `FacSpec` is ported so far; the device apply
configuration waits for the packed-plan slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any


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
