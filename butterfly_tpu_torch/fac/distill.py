"""Distill a real butterfly-compressible operator into a UniformButterfly.

Port counterpart of the host half of `butterfly_tpu/fac/distill.py`
(`distill_butterfly`, :216-259, and `_distill_from_cols`, :262-351). The
construction is the same host float64 NumPy code; only the result is built
as the port's `UniformButterfly`, with torch tensors on the chosen device.
The batched host distillation and the device distillation wait for a later
slice.

The streaming factorizer (fac/streamer.py) produces *ragged*
factorizations, with data-dependent ranks per block (reference:
include/bf/fac.h:33-42). The fused kernel needs the uniform FFT form; this
module re-compresses a real operator into it via the complementary-low-rank
merge recursion — the same nested-basis idea as the reference's randomized
middle-out sampler (examples/fast_direct_solver/fast_direct_solver.py:404-607)
and the merge-and-split core (src/fac.c:1080-1294), with every level emitted
as one dense (hi, R, R, lo, r, r) tensor.

Construction (host, float64, setup-time):

  state t: for every pair (row node w at depth t, col node C at depth L-t)
  we hold a row basis U[w,C] (|w| x r) with Phi[w, C] ~= U[w,C] @ coef,
  where coef = the r activation values the butterfly carries for that pair.

  - leaf: truncated SVD of each column block Phi[:, c] ~= (U S) V^T; the
    leaf factor stores V^T (r x cs); the SCALED basis B = U S seeds the
    recursion (row node = root).
  - level t: merge col siblings (d = 0, 1) and split the row node into its
    children (new output digit c): the stacked scaled basis
    T = [B[w,c0]|child rows, B[w,c1]|child rows]; its rank-r truncated SVD
    T ~= (U' S') G gives the new scaled basis B' = U' S' and the
    orthonormal r x 2r transfer matrix G that becomes the level weight.
  - last level: no re-truncation — the weight is T itself, i.e. the output
    rows.

The OUTPUT block order is the bit-reversed row-block order;
`DistilledButterfly.row_perm` carries the permutation.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from butterfly_tpu_torch.ops.butterfly import UniformButterfly
from butterfly_tpu_torch.ops.linop import LinOp
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check

__all__ = ["DistilledButterfly", "distill_butterfly"]


def _svd(T: np.ndarray):
    """SVD with a gesvd fallback (gesdd occasionally fails to converge on
    rank-deficient stacked bases — same LAPACK caveat the reference hits via
    LAPACKE_zgesvd, src/mat_dense_complex.c:1550)."""
    try:
        return np.linalg.svd(T, full_matrices=False)
    except np.linalg.LinAlgError:
        import scipy.linalg

        return scipy.linalg.svd(T, full_matrices=False,
                                lapack_driver="gesvd")


def _svd_scaled(T: np.ndarray):
    """(U*s, s, Vt) of a tall (h, w) matrix via the (w, w) Gram
    eigendecomposition — BLAS3 GEMM + small eigh instead of a tall
    bidiagonalization. Squares the condition number, so singular values
    below ~sqrt(eps_f64)*sigma_max (~1e-8 rel) come back noisy; the
    distillation only needs directions above its truncation tolerance.
    Falls back to the full SVD for near-square inputs."""
    h, w = T.shape
    if h < 4 * w:
        U, s, Vt = _svd(T)
        return U * s, s, Vt
    M = T.T @ T
    evals, V = np.linalg.eigh(M)           # ascending
    s = np.sqrt(np.maximum(evals[::-1], 0.0))
    V = V[:, ::-1]
    return T @ V, s, V.T


# Below this relative tolerance the Gram trick's squared conditioning makes
# dropped-singular-value reports noise (see _svd_scaled docstring); the
# distillation then switches to the full bidiagonalization SVD.
_GRAM_TOL_FLOOR = 1e-7


def _svd_full_scaled(T: np.ndarray):
    """Same contract as _svd_scaled but always via the full SVD."""
    U, s, Vt = _svd(T)
    return U * s, s, Vt


def _revbits(x: int, nbits: int) -> int:
    y = 0
    for _ in range(nbits):
        y = (y << 1) | (x & 1)
        x >>= 1
    return y


@dataclasses.dataclass
class DistilledButterfly:
    """A UniformButterfly + the row-block permutation tying it to the
    original operator: bf.apply(x)[g*bs:(g+1)*bs] reproduces the rows of
    original block revbits(g), i.e.  A[row_perm] @ x == bf.apply(x)."""

    bf: UniformButterfly
    row_perm: np.ndarray       # (n,) butterfly-row -> original-row index
    rank: int
    max_sv_discarded: float    # max singular value dropped by any truncation
    sigma_max: float = 0.0     # largest leaf singular value (scale estimate)

    @property
    def shape(self):
        return self.bf.shape

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Apply in butterfly row order (rows permuted by row_perm)."""
        return self.bf.apply(x)

    def apply_canonical(self, x: torch.Tensor) -> torch.Tensor:
        """Apply and restore the original row order (one gather)."""
        y = self.bf.apply(x)
        inv = np.empty_like(self.row_perm)
        inv[self.row_perm] = np.arange(self.row_perm.size)
        return y[torch.as_tensor(inv, device=y.device)]

    def nbytes(self) -> int:
        return self.bf.nbytes()


def _col_block(A, j0: int, j1: int) -> np.ndarray:
    """Dense (n, j1-j0) column block of an ndarray or LinOp (for a
    compressed LinOp this is a cheap fac apply to unit columns)."""
    if isinstance(A, np.ndarray):
        return np.asarray(A[:, j0:j1], dtype=np.float64)
    n, m = A.shape
    E = np.zeros((m, j1 - j0))
    E[np.arange(j0, j1), np.arange(j1 - j0)] = 1.0
    return np.asarray(A.matmat(E), dtype=np.float64)


def distill_butterfly(
    A,
    num_blocks: int,
    rank: int | None = None,
    dtype=torch.float32,
    tol: float = 1e-6,
    device=None,
) -> DistilledButterfly:
    """Compress a real (n, m) operator into a rank-`rank` UniformButterfly
    with `num_blocks` blocks (power of 2; n and m divisible by it), whose
    weights are `dtype` tensors on `device`.

    A may be a dense ndarray or any real LinOp (e.g. a streamed
    PartialFac's as_linop()).

    rank=None picks the rank adaptively: start at leaf width + 16 and
    double the margin until every truncation's dropped singular value is
    below tol * (largest leaf singular value) — the same
    relative-truncation criterion as the streamer's truncated_svd
    (reference: bfTruncSpecGetNumTerms, src/linalg.c:26-35). The column
    blocks of A are fetched once and cached across adaptive retries.
    """
    device = resolve_device(device)
    n, m = A.shape
    NB = num_blocks
    check(NB >= 2 and (NB & (NB - 1)) == 0,
          "num_blocks must be a power of 2", InvalidArgumentsError)
    check(n % NB == 0 and m % NB == 0,
          f"n={n}, m={m} must divide num_blocks={NB}", InvalidArgumentsError)
    if isinstance(A, LinOp):
        check(not np.issubdtype(A.dtype, np.complexfloating),
              "distill_butterfly is real-only (embed complex ops first)",
              InvalidArgumentsError)
    cs = m // NB
    cols = [_col_block(A, c * cs, (c + 1) * cs) for c in range(NB)]
    if rank is None:
        margin = 16
        while True:
            d = _distill_from_cols(cols, n, m, NB, cs + margin, dtype,
                                   device, tol=tol)
            if (d.max_sv_discarded <= tol * max(d.sigma_max, 1e-300)
                    or cs + margin >= min(n, m)):
                return d
            margin *= 2
    return _distill_from_cols(cols, n, m, NB, rank, dtype, device, tol=tol)


def _distill_from_cols(
    cols: list, n: int, m: int, NB: int, rank: int, dtype,
    device: torch.device, tol: float = 1e-6,
) -> DistilledButterfly:
    L = int(round(math.log2(NB)))
    cs, bs = m // NB, n // NB
    r = rank
    check(r >= 1, "rank must be >= 1", InvalidArgumentsError)
    svd_scaled = _svd_scaled if tol >= _GRAM_TOL_FLOOR else _svd_full_scaled

    max_dropped = 0.0
    sigma_max = 0.0

    # ---- leaf: per col block, Phi[:, c] ~= U_c @ Vt_c ------------------
    leaf = np.zeros((NB, r, cs))
    U = []  # state t=0: U[g] is (n, r), g = col leaf index
    for c in range(NB):
        # carry the SCALED basis B = U diag(s) so later truncations rank
        # directions by actual data magnitude; the emitted factor is the
        # orthonormal part
        US, s, Vt = svd_scaled(cols[c])
        if s.size:
            sigma_max = max(sigma_max, float(s[0]))
        k = min(r, s.size)
        if s.size > k:
            max_dropped = max(max_dropped, float(s[k]))
        leaf[c, :k, :] = Vt[:k]
        Ug = np.zeros((n, r))
        Ug[:, :k] = US[:, :k]
        U.append(Ug)

    # ---- levels --------------------------------------------------------
    levels = []
    for t in range(L):
        hi, lo = NB // 2 ** (t + 1), 2 ** t
        half = n // 2 ** (t + 1)   # rows per row node at depth t+1
        last = t == L - 1
        m_out = bs if last else r
        W = np.zeros((hi, 2, 2, lo, m_out, r))
        U_new = [None] * NB
        for h in range(hi):
            for ll in range(lo):
                g0 = (h * 2 + 0) * lo + ll
                g1 = (h * 2 + 1) * lo + ll
                for b in (0, 1):             # row child = output digit c
                    sl = slice(b * half, (b + 1) * half)
                    T = np.concatenate([U[g0][sl], U[g1][sl]], axis=1)
                    if last:
                        # final level: weights ARE the output rows
                        W[h, b, 0, ll] = T[:, :r]
                        W[h, b, 1, ll] = T[:, r:]
                        continue
                    US, s, Vt = svd_scaled(T)
                    k = min(r, s.size)
                    if s.size > k:
                        max_dropped = max(max_dropped, float(s[k]))
                    G = Vt[:k]                        # (k, 2r) orthonormal
                    W[h, b, 0, ll, :k, :] = G[:, :r]
                    W[h, b, 1, ll, :k, :] = G[:, r:]
                    Un = np.zeros((half, r))
                    Un[:, :k] = US[:, :k]             # scaled basis
                    g_out = (h * lo * 2) + b * lo + ll  # == h*2^{t+1}+b*2^t+ll
                    U_new[g_out] = Un
        if not last:
            U = U_new
        levels.append(W)

    # output block g holds original row block revbits(g)
    row_perm = np.concatenate([
        np.arange(_revbits(g, L) * bs, (_revbits(g, L) + 1) * bs)
        for g in range(NB)
    ])

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64).to(device=device,
                                                           dtype=dtype)

    # "highest": IEEE float32 products, which the <=1e-6 accuracy line needs
    bf = UniformButterfly(dev(leaf), [dev(W) for W in levels], radix=2,
                          precision="highest")
    return DistilledButterfly(
        bf=bf, row_perm=row_perm, rank=r, max_sv_discarded=max_dropped,
        sigma_max=sigma_max,
    )
