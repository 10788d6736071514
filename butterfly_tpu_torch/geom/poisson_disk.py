"""Poisson-disk (blue noise) sampling — scatterer center placement
(reference: src/poisson_disk_sampling.c, Bridson's algorithm).

Port counterpart of `butterfly_tpu/geom/poisson_disk.py`, copied verbatim:
the same grid-accelerated dart throwing with NumPy on the host, drawing
from the caller's `np.random.Generator` in the same order, so one seed
places the same scatterers in both packages.
"""

from __future__ import annotations

import numpy as np


def sample_poisson_disk(
    lo, hi, min_dist: float, k: int = 30, rng: np.random.Generator | None = None
) -> np.ndarray:
    """Sample points in the box [lo, hi] ⊂ R^2 with pairwise distance >=
    `min_dist`, trying `k` candidates per active point
    (reference: bfPoints2SamplePoissonDisk, src/poisson_disk_sampling.c:110-166).
    """
    if rng is None:
        rng = np.random.default_rng(0)
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    width, height = hi - lo
    h = min_dist / np.sqrt(2.0)
    nx, ny = int(width / h) + 1, int(height / h) + 1
    cell = -np.ones((nx, ny), dtype=np.int64)

    samples: list[np.ndarray] = []

    def cell_coords(p):
        return int((p[0] - lo[0]) / h), int((p[1] - lo[1]) / h)

    def point_valid(p):
        i0, j0 = cell_coords(p)
        for di in range(-2, 3):
            for dj in range(-2, 3):
                i, j = i0 + di, j0 + dj
                if 0 <= i < nx and 0 <= j < ny and cell[i, j] >= 0:
                    q = samples[cell[i, j]]
                    if np.hypot(p[0] - q[0], p[1] - q[1]) < min_dist:
                        return False
        return True

    first = lo + rng.random(2) * (hi - lo)
    samples.append(first)
    i0, j0 = cell_coords(first)
    cell[i0, j0] = 0
    active = [0]

    while active:
        idx = rng.integers(len(active))
        x = samples[active[idx]]
        accepted = False
        for _ in range(k):
            # Uniform sample in the [r, 2r] annulus around x via rejection.
            while True:
                dy = (rng.random(2) * 2 - 1) * 2 * min_dist
                R = np.hypot(dy[0], dy[1])
                if min_dist <= R <= 2 * min_dist:
                    break
            y = x + dy
            if not (lo[0] <= y[0] <= hi[0] and lo[1] <= y[1] <= hi[1]):
                continue
            if point_valid(y):
                samples.append(y)
                ci, cj = cell_coords(y)
                cell[ci, cj] = len(samples) - 1
                active.append(len(samples) - 1)
                accepted = True
                break
        if not accepted:
            active.pop(idx)

    return np.asarray(samples)
