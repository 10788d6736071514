"""Point-set helpers.

Replacement for the reference's BfPoints1/2/3 containers
(include/bf/points.h, src/points.c). Points are plain NumPy arrays of shape
(n, d) (host) — no container class needed; this module holds the geometric
operations the reference attaches to them.

Port counterpart of `butterfly_tpu/geom/points.py`, copied unchanged so that
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check


def as_points(x, dim: int | None = None) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    check(x.ndim == 2, "points must be (n, d)", InvalidArgumentsError)
    if dim is not None:
        check(x.shape[1] == dim, f"points must be (n, {dim})", InvalidArgumentsError)
    return x


def pairwise_dists(X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """All-pairs Euclidean distances, shape (len(X), len(Y))
    (reference: bfPoints2PairwiseDists, src/points.c).

    Computed from coordinate differences (not the gram-matrix identity) so
    coincident points give exactly 0 and near-diagonal distances keep full
    relative accuracy — both matter for kernel diagonals and quadrature
    corrections. Row-blocked to cap peak memory at ~32 MB.
    """
    X, Y = as_points(X), as_points(Y)
    m, n = X.shape[0], Y.shape[0]
    out = np.empty((m, n), dtype=np.float64)
    block = max(1, (1 << 21) // max(n, 1))  # ~2M entries per slab
    for i0 in range(0, m, block):
        i1 = min(i0 + block, m)
        diff = X[i0:i1, None, :] - Y[None, :, :]
        np.sqrt(np.einsum("ijd,ijd->ij", diff, diff), out=out[i0:i1])
    return out


def insert_points_sorted(points: np.ndarray, new_points: np.ndarray) -> np.ndarray:
    """Merge `new_points` into an already-sorted 1-D point set, keeping order
    (reference: bfPoints1InsertPointsSorted, used src/lbo.c:120)."""
    points = np.asarray(points, dtype=np.float64).ravel()
    new_points = np.asarray(new_points, dtype=np.float64).ravel()
    out = np.concatenate([points, new_points])
    out.sort(kind="stable")
    return out


def bounding_box(X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(min, max) corners of the axis-aligned bounding box."""
    X = as_points(X)
    check(X.shape[0] > 0, "bounding_box of empty point set")
    return X.min(axis=0), X.max(axis=0)
