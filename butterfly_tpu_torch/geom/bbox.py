"""Axis-aligned bounding boxes (reference: src/bbox.c, include/bf/bbox.h).

Port counterpart of `butterfly_tpu/geom/bbox.py`, copied unchanged so that
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Bbox:
    """Axis-aligned box in d dims; `lo`/`hi` are length-d arrays."""

    lo: np.ndarray
    hi: np.ndarray

    @classmethod
    def of_points(cls, X: np.ndarray) -> "Bbox":
        X = np.asarray(X, dtype=np.float64)
        return cls(X.min(axis=0).copy(), X.max(axis=0).copy())

    @property
    def dim(self) -> int:
        return len(self.lo)

    @property
    def center(self) -> np.ndarray:
        return 0.5 * (self.lo + self.hi)

    @property
    def extent(self) -> np.ndarray:
        return self.hi - self.lo

    def rescale_to_cube(self) -> "Bbox":
        """Grow to a cube/square about the center
        (reference: bfBbox2RescaleToSquare, src/bbox.c)."""
        c = self.center
        h = 0.5 * float(np.max(self.extent))
        # Clamp against the original box: c±h can round inward by 1 ulp on the
        # longest axis, which would exclude boundary points from the root box.
        return Bbox(np.minimum(self.lo, c - h), np.maximum(self.hi, c + h))

    def contains(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        return np.all((X >= self.lo) & (X <= self.hi), axis=-1)

    def bounding_circle(self) -> tuple[np.ndarray, float]:
        """(center, radius) of the circumscribed ball
        (reference: bfQuadtreeNodeGetBoundingCircle, src/quadtree_node.c:321)."""
        return self.center, 0.5 * float(np.linalg.norm(self.extent))

    def child_box(self, octant: int) -> "Bbox":
        """The 2^d-ant sub-box indexed by octant bits: bit k set means upper
        half along axis k (reference: childBbox construction,
        src/quadtree_node.c:199-216, with axis-0 as the high bit there; we use
        bit k = axis k which is equivalent up to child labeling)."""
        c = self.center
        lo = self.lo.copy()
        hi = self.hi.copy()
        for k in range(self.dim):
            if (octant >> k) & 1:
                lo[k] = c[k]
            else:
                hi[k] = c[k]
        return Bbox(lo, hi)
