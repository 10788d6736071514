"""Circles and proxy-point sampling (reference: src/circle.c, include/bf/circle.h).

Port counterpart of `butterfly_tpu/geom/circle.py`, copied unchanged so that
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Circle:
    """Circle in the plane (reference: BfCircle)."""

    center: tuple[float, float]
    r: float

    def sample_points(self, n: int) -> np.ndarray:
        """n equispaced points on the circle, starting at angle 0
        (reference: bfCircle2SamplePoints, src/circle.c:12-34)."""
        theta = 2.0 * np.pi * np.arange(n) / n
        return np.stack(
            [
                self.r * np.cos(theta) + self.center[0],
                self.r * np.sin(theta) + self.center[1],
            ],
            axis=1,
        )

    def sample_unit_normals(self, n: int) -> np.ndarray:
        """Outward unit normals at the sampled points
        (reference: bfCircle2SampleUnitNormals, src/circle.c:36-58)."""
        theta = 2.0 * np.pi * np.arange(n) / n
        return np.stack([np.cos(theta), np.sin(theta)], axis=1)

    def contains_points(self, X: np.ndarray) -> bool:
        """(reference: bfCircle2ContainsPoints, src/circle.c:64-69)."""
        X = np.asarray(X, dtype=np.float64)
        d = np.linalg.norm(X - np.asarray(self.center), axis=1)
        return bool(np.all(d <= self.r))


def circles_are_separated(c1: Circle, c2: Circle, margin: float = 10 * np.finfo(np.float64).eps) -> bool:
    """True if the circles don't touch
    (reference: bfQuadtreeNodesAreSeparated, src/quadtree_node.c:393-401)."""
    R = float(np.hypot(c1.center[0] - c2.center[0], c1.center[1] - c2.center[1]))
    return R > c1.r + c2.r + margin
