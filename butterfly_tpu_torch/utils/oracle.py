"""Row-sampled dense oracle for large-N accuracy checks.

Port counterpart of `butterfly_tpu/utils/oracle.py`, copied (numpy only)
so that the port imports nothing of the JAX package.

The reference validates every compressed operator against a FULL dense
ground truth (examples/simple/helm2_bie.c:131-207), which is impossible at
the scales this framework targets (a 65536-point dense Helmholtz matrix is
68 GB). The row-sampled oracle keeps the same evidence standard at any N:
draw a random row subset, assemble those exact kernel rows densely, and
compare the compressed apply's output at exactly those rows. Cost is
O(rows * N) instead of O(N^2); the estimate is an unbiased sample of the
row-wise error distribution.
"""

from __future__ import annotations

import numpy as np

__all__ = ["row_oracle_rel_err"]


def row_oracle_rel_err(
    got,
    exact_rows_fn,
    n: int,
    num_rows: int = 128,
    seed: int = 0,
):
    """Relative l2 error of `got` ((n, k) compressed-apply output) against
    exact values on a sampled row subset.

    exact_rows_fn(rows) must return the EXACT (len(rows), k) output rows
    (e.g. dense kernel rows times the same input). Returns (rel_err, rows).
    """
    got = np.asarray(got)
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(n, size=min(num_rows, n), replace=False))
    want = np.asarray(exact_rows_fn(rows))
    denom = np.linalg.norm(want)
    rel = float(np.linalg.norm(got[rows] - want) / max(denom, 1e-300))
    return rel, rows
