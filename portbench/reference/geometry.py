"""The ellipse's boundary discretization, in float64 NumPy.

Points at equal steps of the parameter t (x = center + R(a cos t, b sin t)),
outward unit normals R(b cos t, a sin t)/|.|, and trapezoid weights
h |dx/dt| with h = 2 pi / n: the discretization of the upstream's
`bfEllipseSampleLinspaced`, worked out here from the ellipse alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Boundary:
    points: np.ndarray   # (n, 2)
    normals: np.ndarray  # (n, 2), outward
    weights: np.ndarray  # (n,)

    @property
    def n(self) -> int:
        return self.points.shape[0]


def rotation(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def ellipse(spec: dict, n: int) -> Boundary:
    """`spec`: semi_major, semi_minor, center, theta (the configuration's
    `ellipse` entry)."""
    a, b = float(spec["semi_major"]), float(spec["semi_minor"])
    R = rotation(float(spec["theta"]))
    c = np.asarray(spec["center"], np.float64)
    h = 2.0 * np.pi / n
    t = h * np.arange(n)
    cos, sin = np.cos(t), np.sin(t)
    points = np.stack([a * cos, b * sin], 1) @ R.T + c
    nrm = np.stack([b * cos, a * sin], 1)
    normals = (nrm / np.linalg.norm(nrm, axis=1)[:, None]) @ R.T
    speed = np.hypot(a * sin, b * cos)
    return Boundary(points, normals, h * speed)


def inside(spec: dict, scale: float, r: np.ndarray, phi: np.ndarray):
    """Points of the ellipse scaled by `scale` about its center, at polar
    coordinates (r in [0, 1], phi) of the unit disk mapped onto it: area-
    uniform r = sqrt(u) maps to area-uniform points."""
    a, b = float(spec["semi_major"]), float(spec["semi_minor"])
    R = rotation(float(spec["theta"]))
    c = np.asarray(spec["center"], np.float64)
    p = np.stack([scale * a * r * np.cos(phi), scale * b * r * np.sin(phi)], 1)
    return p @ R.T + c
