"""Ellipses — scatterer geometry for BIE problems
(reference: src/ellipse.c, include/bf/ellipse.h).

Vectorized NumPy redesign of the reference's per-point loops; the equispaced /
inverse-curvature resamplers replace its O(n^2) search with searchsorted.

Port counterpart of `butterfly_tpu/geom/ellipse.py`, copied unchanged so that
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _rot(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


@dataclasses.dataclass(frozen=True)
class Ellipse:
    """Ellipse with semi-axes a >= b, center, and rotation angle theta
    (reference: BfEllipse, include/bf/ellipse.h:6-11)."""

    semi_major: float
    semi_minor: float
    center: tuple[float, float]
    theta: float = 0.0

    @property
    def perimeter(self) -> float:
        """Perimeter by the Gauss–Kummer series
        (reference: bfEllipseGetPerimeter, src/ellipse.c:13-31)."""
        a, b = self.semi_major, self.semi_minor
        h = (a - b) / (a + b)
        from scipy.special import gamma

        total, term, m = 0.0, 1.0, 1
        while abs(term) > 1e-15:
            total += term
            term = (gamma(1.5) / (gamma(1.5 - m) * gamma(1 + m))) ** 2 * h ** (2 * m)
            m += 1
        return float(np.pi * (a + b) * total)

    def _frame(self, theta_param: np.ndarray):
        """Points, unit tangents, outward unit normals, and speed |dp/dθ| at
        the given parameter angles (reference: sampling core,
        src/ellipse.c:40-76)."""
        a, b = self.semi_major, self.semi_minor
        R = _rot(self.theta)
        c = np.asarray(self.center)

        p = np.stack([a * np.cos(theta_param), b * np.sin(theta_param)], axis=1)
        points = p @ R.T + c

        t = np.stack([-a * np.sin(theta_param), b * np.cos(theta_param)], axis=1)
        speed = np.linalg.norm(t, axis=1)
        t_unit = t / speed[:, None]

        n = np.stack([-a * np.cos(theta_param), -b * np.sin(theta_param)], axis=1)
        n = n - np.sum(n * t_unit, axis=1)[:, None] * t_unit  # reject onto tangent
        n /= np.linalg.norm(n, axis=1)[:, None]
        normals = -(n @ R.T)  # outward-facing
        tangents = t_unit @ R.T
        return points, tangents, normals, speed

    def sample_linspaced(self, n: int):
        """Parameter-uniform samples with trapezoid arc-length weights
        (reference: bfEllipseSampleLinspaced, src/ellipse.c:34-77).

        Returns (points (n,2), unit_tangents (n,2), unit_normals (n,2),
        weights (n,)).
        """
        h = 2.0 * np.pi / n
        theta = h * np.arange(n)
        points, tangents, normals, speed = self._frame(theta)
        weights = h * speed
        return points, tangents, normals, weights

    def sample_equispaced(self, n: int):
        """Approximately arc-length-equispaced samples
        (reference: bfEllipseSampleEquispaced, src/ellipse.c:79-135)."""
        dtheta = 2.0 * np.pi / n
        grid = dtheta * np.arange(n + 1)
        a, b = self.semi_major, self.semi_minor
        seg = np.hypot(np.diff(a * np.cos(grid)), np.diff(b * np.sin(grid)))
        D = np.concatenate([[0.0], np.cumsum(seg)])
        d = (D[-1] / n) * np.arange(n)
        j = np.clip(np.searchsorted(D, d, side="right") - 1, 0, n - 1)
        lam = (d - D[j]) / (D[j + 1] - D[j])
        theta = (j + lam) * dtheta
        points, tangents, normals, _ = self._frame(theta)
        return points, tangents, normals
