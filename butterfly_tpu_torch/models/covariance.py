"""Gaussian-process covariance operators on meshes.

Replacement for the reference's covariance example family
(examples/covariance/*): a covariance operator defined spectrally through
the Laplace-Beltrami operator,

    C = Phi gamma(Lam) Phi^T,      L Phi = M Phi Lam,  Phi^T M Phi = I,

with the squared-exponential or Matern spectral density gamma. Two apply
paths, exactly the reference's "exact vs fast" pair:

- `chebyshev_covariance_apply`: matrix-free C w via a Chebyshev polynomial
  of M^{-1} L (reference: cheb_cov.c) — no eigendecomposition at all.
- `CompressedCovariance`: C through the butterfly-COMPRESSED eigenvector
  matrix from the streaming LBO pipeline (reference: lbo_cov.c), giving fast
  covariance matvecs and GP sampling z = Phi gamma(Lam)^{1/2} omega.

Port counterpart of `butterfly_tpu/models/covariance.py`, copied: both
applies run on the host (numpy and scipy), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from butterfly_tpu_torch.models.lbo import LboCompression
from butterfly_tpu_torch.ops.cheb import ChebFit, cheb_matvec
from butterfly_tpu_torch.utils.errors import check

__all__ = [
    "squared_exponential_density",
    "matern_density",
    "chebyshev_covariance_apply",
    "CompressedCovariance",
]


def squared_exponential_density(kappa: float) -> Callable[[np.ndarray], np.ndarray]:
    """gamma(lam) = exp(-kappa lam^2)
    (reference: gamma_, examples/covariance/cheb_cov.c:20-24)."""
    return lambda lam: np.exp(-kappa * np.asarray(lam) ** 2)


def matern_density(kappa: float, nu: float) -> Callable[[np.ndarray], np.ndarray]:
    """Matern spectral density, normalized so gamma(0) = 1
    (reference: cheb_cov.c:25-27)."""
    return lambda lam: np.abs(1 + kappa**2 * np.asarray(lam)) ** (-nu / 4 - 0.5)


def chebyshev_covariance_apply(
    L: sp.spmatrix,
    M: sp.spmatrix,
    gamma: Callable[[np.ndarray], np.ndarray],
    w: np.ndarray,
    lam_max: float,
    order: int = 64,
) -> np.ndarray:
    """C w = gamma(M^{-1} L) w via a Chebyshev matrix polynomial — the
    eigendecomposition-free path (reference: cheb_cov.c main loop).

    The M-solve per application uses a prefactorized sparse Cholesky/LU.
    """
    Ms = sp.csc_matrix(M)
    solve_M = spla.factorized(Ms)
    Ls = sp.csr_matrix(L)

    def apply_S(v):
        return solve_M(Ls @ v)

    cheb = ChebFit(gamma, 0.0, lam_max * 1.001, order)
    return cheb_matvec(apply_S, cheb, w)


@dataclasses.dataclass
class CompressedCovariance:
    """Covariance through a butterfly-compressed eigenbasis
    (reference: lbo_cov.c)."""

    lbo: LboCompression

    def _phi_apply(self, coeffs: np.ndarray) -> np.ndarray:
        """Phi @ coeffs in ORIGINAL vertex order."""
        y_tree = self.lbo.fac.as_linop().matmat(coeffs)
        out = np.empty_like(y_tree)
        out[self.lbo.row_tree.perm] = y_tree
        return out

    def _phi_t_apply(self, v: np.ndarray) -> np.ndarray:
        """Phi^T @ v (v in original vertex order)."""
        return self.lbo.fac.as_linop().rmatmat(v[self.lbo.row_tree.perm])

    def apply(self, gamma: Callable[[np.ndarray], np.ndarray],
              w: np.ndarray) -> np.ndarray:
        """C w = Phi gamma(Lam) Phi^T w."""
        lam = self.lbo.freqs**2
        return self._phi_apply(gamma(lam)[..., None] * self._phi_t_apply(w)
                               if np.ndim(w) > 1
                               else gamma(lam) * self._phi_t_apply(w))

    def sample(self, gamma: Callable[[np.ndarray], np.ndarray],
               omega: np.ndarray) -> np.ndarray:
        """GP sample z = Phi gamma(Lam)^{1/2} omega for white noise omega."""
        lam = self.lbo.freqs**2
        half = np.sqrt(np.maximum(gamma(lam), 0.0))
        return self._phi_apply(half * omega if omega.ndim == 1
                               else half[:, None] * omega)
