"""Device-resident eigenband solvers for the LBO pipeline.

Port counterpart of `butterfly_tpu/ops/device_eigs.py`. The reference
computes eigenbands with ARPACK shift-invert Lanczos, each iteration an
UMFPACK sparse solve on the host (src/linalg.c:472-1000). This module
computes them on the card, in two regimes:

- **dense path** (n <= `dense_cutoff`): one generalized eigendecomposition:
  M-Cholesky reduction to a standard symmetric problem
  (`torch.linalg.cholesky`, `torch.linalg.solve_triangular`) and
  `torch.linalg.eigh`. On a CUDA tensor these are cuSOLVER's potrf, cuBLAS's
  trsm and, for one unbatched matrix, cuSOLVER's divide-and-conquer syevd
  (PyTorch takes the Jacobi syevjBatched only for batches of matrices of
  order <= 32, which this module never forms).
- **LOBPCG path** (large n): constrained, Jacobi-preconditioned,
  M-generalized block LOBPCG on the pencil (L, M) with sparse CSR products
  (`torch.sparse_csr_tensor @ dense`: cuSPARSE SpMM on the card, a library
  product as the JAX package's BCOO is) and no inner linear solves.
  Previously converged eigenvectors enter as constraints (deflation), so a
  session walks the spectrum bottom-up band by band, the access pattern of
  the LBO column tree (src/lbo.c:70-150).

`DeviceEigSession` serves both behind `next_band(lo, hi) -> (vals, vecs)`,
used by `models/lbo.py`.

What changed for the card: float64 is the default on every device (the
H100 has it at full rate in its tensor cores; the JAX package falls back to
float32 on the TPU and loosens its basis-breakdown threshold to 1e-6 there,
neither of which is copied), and the whitening scales columns first (see
`_m_whiten`: without it, LOBPCG stalls above its acceptance threshold on
meshes of 642 vertices and more). The step is a plain function on tensors: there
is no `jax.jit` to keep. LOBPCG's start blocks come from
`np.random.default_rng(seed)` bit for bit; its first search direction P
comes from a `torch.Generator` seeded 17 in place of `jax.random.key(17)`,
so the pairs agree with the JAX package's to tolerance, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check
from butterfly_tpu_torch.utils.logging import log_info

__all__ = ["DeviceEigSession", "dense_generalized_eigh_device",
           "lobpcg_generalized"]


def _dense(A, device, dtype) -> torch.Tensor:
    if sp.issparse(A):
        A = A.toarray()
    return torch.as_tensor(np.asarray(A), dtype=dtype, device=device)


def _sparse_csr(A, device, dtype=torch.float64) -> torch.Tensor:
    """A scipy sparse matrix as a `torch.sparse_csr_tensor` on `device`."""
    A = sp.csr_matrix(A)
    return torch.sparse_csr_tensor(
        torch.as_tensor(A.indptr, dtype=torch.int64),
        torch.as_tensor(A.indices, dtype=torch.int64),
        torch.as_tensor(A.data, dtype=dtype), size=A.shape,
        check_invariants=True,
    ).to(device)


def _eigh_generalized(Ld: torch.Tensor, Md: torch.Tensor):
    """(lam, X) of Ld x = lam Md x, X M-orthonormal, on the tensors'
    device: M = C C^T, A = C^{-1} L C^{-T}, eigh(A) = (lam, V),
    X = C^{-T} V."""
    C = torch.linalg.cholesky(Md)
    T1 = torch.linalg.solve_triangular(C, Ld, upper=False)
    A = torch.linalg.solve_triangular(C, T1.T, upper=False).T
    A = 0.5 * (A + A.T)
    lam, V = torch.linalg.eigh(A)
    X = torch.linalg.solve_triangular(C.T, V, upper=True)
    return lam, X


def dense_generalized_eigh_device(L, M, device=None, dtype=torch.float64):
    """All eigenpairs of L x = lam M x, computed on `device` (default: the
    card). Returns host numpy (vals ascending, vecs (n, n) M-orthonormal)."""
    device = resolve_device(device)
    lam, X = _eigh_generalized(_dense(L, device, dtype),
                               _dense(M, device, dtype))
    return lam.cpu().numpy(), X.cpu().numpy()


def _m_whiten(S, MS, delta):
    """M-whiten a (possibly near-dependent) block: scale each column to unit
    M-norm, eigendecompose the Gram G = S^T M S and scale by 1/sqrt(d) on
    the well-conditioned directions (SVQB). Near-dependent directions
    (d <= delta*dmax) are NOT scaled up (their columns become ~zero) and
    are flagged in `good`; callers mask their Ritz values with a large
    penalty so they are never selected: the static-shape analogue of scipy
    lobpcg's drop-and-restart on basis breakdown.

    The JAX package whitens without the column scaling, so a residual
    direction W of M-norm below sqrt(delta) = 1e-6 counts as dependent and
    is dropped: its residuals stop at 1.7e-6 of the spectral scale, above
    its own 1e-6 acceptance, from icosphere(3) on (the session then raises
    "made no progress"). Scaled first, W survives however small it is."""
    dg = (S * MS).sum(dim=0)
    sc = torch.where(dg > 0, 1.0 / torch.sqrt(dg.clamp(min=1e-300)),
                     torch.zeros_like(dg))
    S, MS = S * sc, MS * sc
    G = 0.5 * ((S.T @ MS) + (MS.T @ S))
    d, Q = torch.linalg.eigh(G)
    dmax = d[-1].clamp(min=1e-300)
    good = d > delta * dmax
    inv = torch.where(good, 1.0 / torch.sqrt(torch.maximum(d, delta * dmax)),
                      torch.zeros_like(d))
    W = Q * inv[None, :]
    return S @ W, MS @ W, good


def lobpcg_generalized(L_mv, M_mv, X0, Y=None, MY=None, precond=None,
                       tol: float = 1e-9, maxit: int = 500, seed: int = 17):
    """Smallest-m eigenpairs of the SPD pencil (L, M) by constrained,
    preconditioned block LOBPCG with M-inner products.

    L_mv / M_mv: callables (n, k) -> (n, k) on X0's device and dtype. X0
    (n, m) start block (a tensor). Y: (n, p) converged eigenvectors to
    deflate (M-orthonormal); every basis vector is kept M-orthogonal to
    span(Y), so the returned pairs are the next m up the spectrum. P starts
    from a `torch.Generator` seeded `seed`.

    Returns (vals (m,), vecs (n, m), res (m,)) as tensors, ascending; res is
    each residual norm over the block's spectral scale max |theta|.
    """
    X = X0
    n, m = X.shape
    delta = 1e-12 if X.dtype == torch.float64 else 1e-6
    have_Y = Y is not None and Y.shape[1] > 0
    if have_Y:
        MY = M_mv(Y) if MY is None else MY

    def deflate(V):
        return V - Y @ (MY.T @ V) if have_Y else V

    def masked_ritz(S, MS, good):
        """Rayleigh-Ritz on a whitened basis with bad directions penalized
        out of the smallest-m window."""
        AS = L_mv(S)
        Hs = 0.5 * ((S.T @ AS) + (AS.T @ S))
        penalty = 10.0 * (1.0 + Hs.abs().max())
        Hs = Hs + torch.diag(torch.where(good, torch.zeros_like(Hs[0]),
                                         penalty))
        return torch.linalg.eigh(Hs)

    def spectral_scale(theta):
        # the block's scale, NOT per-column |theta|: the LBO kernel mode has
        # theta ~ 1e-13 and would never "converge" under a relative test
        return theta.abs().max().clamp(min=1e-300)

    def step(X, P):
        Xd = deflate(X)
        X, MX, goodX = _m_whiten(Xd, M_mv(Xd), delta)
        ts, Cs = masked_ritz(X, MX, goodX)
        theta = ts[:m]
        X = X @ Cs[:, :m]
        MX = MX @ Cs[:, :m]
        R = L_mv(X) - MX * theta[None, :]
        rnorm = torch.linalg.vector_norm(R, dim=0) / spectral_scale(theta)
        W = R if precond is None else precond(R)
        W = deflate(W)
        S = torch.cat([X, W, P], dim=1)
        S, MS, good = _m_whiten(S, M_mv(S), delta)
        ts, Cs = masked_ritz(S, MS, good)
        C = Cs[:, :m]
        Xn = S @ C
        # implicit P: the part of the new X outside the old X block
        Cp = C.clone()
        Cp[:m] = 0.0
        return Xn, S @ Cp, rnorm

    gen = torch.Generator(device=X.device).manual_seed(seed)
    P = deflate(torch.randn(X.shape, generator=gen, dtype=X.dtype,
                            device=X.device))
    for _ in range(maxit):
        X, P, rnorm = step(X, P)
        if float(rnorm.max()) < tol:
            break
    # final Ritz cleanup and honest residuals for the returned pairs
    Xd = deflate(X)
    X, MX, goodX = _m_whiten(Xd, M_mv(Xd), delta)
    theta, Q = masked_ritz(X, MX, goodX)
    theta = theta[:m]
    X = X @ Q[:, :m]
    MX = MX @ Q[:, :m]
    R = L_mv(X) - MX * theta[None, :]
    res = torch.linalg.vector_norm(R, dim=0) / spectral_scale(theta)
    return theta, X, res


class DeviceEigSession:
    """Bottom-up eigenband server over the pencil (L, M) on `device`
    (default: the card), in `dtype` (float64 by default).

    next_band(lo, hi) returns every eigenpair with lam in [lo, hi), in
    ascending order, computing lazily: bands must be requested left to
    right (the LBO column-tree order). A band is complete when the session
    has converged eigenpairs strictly beyond `hi` (or the whole spectrum),
    as the reference's bracket logic (getPairsCoveringInterval,
    src/linalg.c:818-899). The converged vectors stay on the device (they
    are the deflation space); each band comes back to the host as numpy.
    """

    def __init__(self, L, M, dense_cutoff: int = 1024, device=None,
                 dtype=torch.float64, chunk: int = 32, tol: float = 1e-9,
                 maxit: int = 500, seed: int = 0):
        self.device = resolve_device(device)
        self.n = L.shape[0]
        check(L.shape == M.shape and L.shape[0] == L.shape[1],
              "L, M must be square and congruent", InvalidArgumentsError)
        self._dtype = dtype
        self._chunk = chunk
        self._tol = tol
        self._maxit = maxit
        self._rng = np.random.default_rng(seed)
        self._served = 0  # eigenpairs already handed out (left to right)

        if self.n <= dense_cutoff:
            lam, X = _eigh_generalized(_dense(L, self.device, dtype),
                                       _dense(M, self.device, dtype))
            self._vals, self._vecs = lam.cpu().numpy(), X
            self._complete = True
            log_info("device eigs: dense path n=%d", self.n)
        else:
            Ls = _sparse_csr(L, self.device, dtype)
            Ms = _sparse_csr(M, self.device, dtype)
            self._L_mv = lambda V: Ls @ V
            self._M_mv = lambda V: Ms @ V
            dL = np.maximum(np.asarray(sp.csr_matrix(L).diagonal()), 0.0)
            dL = dL + 1e-6 * max(dL.mean(), 1e-300)
            dinv = torch.as_tensor(1.0 / dL, dtype=dtype,
                                   device=self.device)[:, None]
            self._precond = lambda R: R * dinv
            self._vals = np.empty(0)
            self._vecs = torch.zeros((self.n, 0), dtype=dtype,
                                     device=self.device)
            self._complete = False
            log_info("device eigs: LOBPCG path n=%d chunk=%d", self.n, chunk)

    def _extend(self):
        """Converge (a prefix of) the next `chunk` eigenpairs above the
        current set. Only the contiguous converged prefix is accepted: the
        tail of a LOBPCG block always lags, and accepting it would poison
        the deflation space for every later band."""
        m = min(self._chunk + 8, self.n - self._vals.size)
        if m <= 0:
            self._complete = True
            return
        X0 = torch.as_tensor(self._rng.standard_normal((self.n, m)),
                             dtype=self._dtype, device=self.device)
        Y = self._vecs if self._vals.size else None
        vals, vecs, res = lobpcg_generalized(
            self._L_mv, self._M_mv, X0, Y=Y, precond=self._precond,
            tol=self._tol, maxit=self._maxit)
        res = res.cpu().numpy()
        # residual acceptance: the eigenvalue error is QUADRATIC in the
        # (spectral-scale-relative) residual for symmetric pencils, so
        # res <= 1e-6 certifies ~1e-12-relative eigenvalues; Jacobi-
        # preconditioned LOBPCG typically stagnates around 1e-7 here
        accept_tol = max(100 * self._tol, 1e-6)
        bad = np.flatnonzero(res > accept_tol)
        k = int(bad[0]) if bad.size else res.size
        if self._vals.size + k >= self.n:
            k = self.n - self._vals.size
        check(k > 0,
              f"device LOBPCG made no progress (res[0] {res[0]:.2e})")
        self._vals = np.concatenate([self._vals, vals[:k].cpu().numpy()])
        self._vecs = torch.cat([self._vecs, vecs[:, :k]], dim=1)
        if self._vals.size >= self.n:
            self._complete = True

    def next_band(self, lo: float, hi: float):
        """All eigenpairs with lam in [lo, hi) as host numpy (vals, vecs);
        bands must be requested in ascending order (lo >= previous hi)."""
        while not self._complete and (
            self._vals.size == 0 or self._vals[-1] < hi
        ):
            self._extend()
        vals = self._vals
        i0 = self._served if not np.isfinite(lo) else int(
            np.searchsorted(vals, lo, side="left"))
        i0 = max(i0, self._served)
        i1 = vals.size if not np.isfinite(hi) else int(
            np.searchsorted(vals, hi, side="left"))
        check(i1 >= i0, "bands must be requested left to right",
              InvalidArgumentsError)
        self._served = i1
        return vals[i0:i1].copy(), self._vecs[:, i0:i1].cpu().numpy()
