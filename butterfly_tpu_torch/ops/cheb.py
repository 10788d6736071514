"""Chebyshev interpolation and operator polynomials.

Replacement for the reference's cheb module (src/cheb.c, include/bf/cheb.h)
and the matrix-function recurrence in its covariance example
(chebmul, examples/covariance/cheb_cov.c:30-51):

- `ChebFit`: interpolate f on [a, b] at Chebyshev nodes (coefficients via the
  DCT relation), Clenshaw evaluation, max-error estimate.
- `cheb_matvec`: apply p(S~) w where S~ is the operator S affinely mapped to
  [-1, 1] — the three-term recurrence that turns a spectral density into a
  matrix-free covariance apply.

Port counterpart of `butterfly_tpu/ops/cheb.py`, copied: host numpy, as in
the JAX package.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check

__all__ = ["ChebFit", "cheb_matvec"]


class ChebFit:
    """Chebyshev interpolant of f on [a, b] (reference: BfCheb/BfChebStd)."""

    def __init__(self, f: Callable[[np.ndarray], np.ndarray], a: float, b: float,
                 order: int):
        check(b > a and order >= 1, "bad Chebyshev domain/order",
              InvalidArgumentsError)
        self.a, self.b, self.order = float(a), float(b), int(order)
        # Chebyshev-Gauss nodes mapped to [a, b]
        k = np.arange(order)
        t = np.cos(np.pi * (k + 0.5) / order)
        x = 0.5 * (a + b) + 0.5 * (b - a) * t
        fx = np.asarray(f(x), dtype=np.float64)
        # coefficients c_j = (2/N) sum_k f(x_k) T_j(t_k)   (c_0 halved)
        T = np.cos(np.pi * (k[:, None] + 0.5) * k[None, :] / order)  # T[k, j]
        c = 2.0 / order * (fx @ T)
        c[0] *= 0.5
        self.c = c

    def _to_std(self, x: np.ndarray) -> np.ndarray:
        return (2.0 * np.asarray(x) - (self.a + self.b)) / (self.b - self.a)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        """Clenshaw evaluation (reference: bfChebEval)."""
        t = self._to_std(x)
        b1 = np.zeros_like(t)
        b2 = np.zeros_like(t)
        for cj in self.c[:0:-1]:
            b1, b2 = 2.0 * t * b1 - b2 + cj, b1
        return t * b1 - b2 + self.c[0]

    def max_error(self, f: Callable[[np.ndarray], np.ndarray],
                  num_samples: int = 1000) -> float:
        """(reference: bfChebGetErrorEstimate)"""
        x = np.linspace(self.a, self.b, num_samples)
        return float(np.abs(self(x) - np.asarray(f(x))).max())


def cheb_matvec(apply_S: Callable[[np.ndarray], np.ndarray], cheb: ChebFit,
                w: np.ndarray) -> np.ndarray:
    """Apply the Chebyshev matrix polynomial p(S) w, where p interpolates f
    on [cheb.a, cheb.b] ⊇ spec(S)
    (reference: chebmul, examples/covariance/cheb_cov.c:30-51).

    Uses the T-recurrence on the affinely mapped operator
    S~ = (2 S - (a+b) I) / (b - a):
      y0 = w,  y1 = S~ w,  y_{k+1} = 2 S~ y_k - y_{k-1},
      p(S) w = sum_k c_k y_k.
    """
    a, b = cheb.a, cheb.b
    alpha = 2.0 / (b - a)
    beta = -(a + b) / (b - a)

    def apply_Std(v):
        return alpha * np.asarray(apply_S(v)) + beta * v

    c = cheb.c
    y2 = np.asarray(w, dtype=np.float64)
    x = c[0] * y2
    if len(c) == 1:
        return x
    y1 = apply_Std(y2)
    x = x + c[1] * y1
    for k in range(2, len(c)):
        y = 2.0 * apply_Std(y1) - y2
        x = x + c[k] * y
        y2, y1 = y1, y
    return x
