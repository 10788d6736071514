"""Distill a real butterfly-compressible operator into a UniformButterfly.

Port counterpart of `butterfly_tpu/fac/distill.py`: `distill_butterfly`
(:216-259), the batched host distillation `distill_butterfly_batch`
(:354-478; here one recursion with the former, `_distill_from_cols`
:262-351, mapped over a thread pool) and `interleaved_real_op` (:67-92)
are the same host float64 NumPy code; only
the result is built as the port's `UniformButterfly`, with torch tensors
on the chosen device. `stacked_to_interleaved` (:95-113) converts between
the two real embeddings of a complex operator on the tensor's device.
`distill_butterfly_device` (:488-616) runs the same recursion on the
tensor's device: batched QR and SVD with `torch.linalg` in place of
`jnp.linalg`, float32, the products under "highest" precision (IEEE
float32, never TF32).

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from butterfly_tpu_torch.ops.butterfly import UniformButterfly, _f32_precision
from butterfly_tpu_torch.ops.linop import FuncOp, LinOp
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check

__all__ = [
    "DistilledButterfly",
    "distill_butterfly",
    "distill_butterfly_batch",
    "distill_butterfly_device",
    "interleaved_real_op",
    "stacked_to_interleaved",
]


def interleaved_real_op(A) -> LinOp:
    """Real (2n, 2m) view of a complex operator with Re/Im INTERLEAVED per
    index: row 2i = Re row i, row 2i+1 = Im row i (same for columns).

    Interleaving (rather than stacking halves) keeps every contiguous index
    range spatially coherent, so each complementary (row node, col node)
    block is the local 2x2 embedding of the corresponding complex block and
    its rank is exactly 2x the complex rank — the butterfly property
    survives and the embedded operator distills like a real one.
    """
    n, m = A.shape

    def matmat(X):
        X = np.asarray(X)
        z = X[0::2] + 1j * X[1::2]
        y = A.matmat(z)
        out = np.empty((2 * n, X.shape[1]))
        out[0::2] = y.real
        out[1::2] = y.imag
        return out

    return FuncOp((2 * n, 2 * m), matmat, dtype=np.float64)


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


def stacked_to_interleaved(M: torch.Tensor) -> torch.Tensor:
    """Re-index a STACKED real embedding ([Re; Im] halves, the packed-plan
    convention) into the INTERLEAVED one (row 2i = Re_i, row 2i+1 = Im_i)
    on whatever device M lives on. Interleaving restores spatial coherence
    of contiguous index ranges, which the partition's block windows need."""
    n2, m2 = M.shape
    n, m = n2 // 2, m2 // 2
    rp = torch.stack([torch.arange(n), n + torch.arange(n)], 1).reshape(-1)
    cp = torch.stack([torch.arange(m), m + torch.arange(m)], 1).reshape(-1)
    return M.index_select(0, rp.to(M.device)).index_select(1, cp.to(M.device))


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
            d = _distill_from_cols(cols, n, NB, cs + margin, dtype,
                                   device, tol=tol)
            if (d.max_sv_discarded <= tol * max(d.sigma_max, 1e-300)
                    or cs + margin >= min(n, m)):
                return d
            margin *= 2
    return _distill_from_cols(cols, n, NB, rank, dtype, device, tol=tol)


def _distill_from_cols(
    cols: list, n: int, NB: int, rank: int, dtype, device: torch.device,
    tol: float = 1e-6, map_fn=map,
) -> DistilledButterfly:
    """The merge recursion over `cols`: the column blocks, each (n, cs), of
    B same-shape operators, NB blocks each in order. B > 1 folds the batch
    into the block axis: with only log2(NB) levels the merge pairs never
    cross a member's NB-group, and the result applies block-diag(M_b).
    `map_fn` maps a step's independent SVDs (a thread pool's map in
    `distill_butterfly_batch`)."""
    L = int(round(math.log2(NB)))
    NBt, cs, bs = len(cols), cols[0].shape[1], n // NB
    r = rank
    check(r >= 1, "rank must be >= 1", InvalidArgumentsError)
    svd_scaled = _svd_scaled if tol >= _GRAM_TOL_FLOOR else _svd_full_scaled

    # ---- leaf: per col block, Phi[:, c] ~= U_c @ Vt_c ------------------
    def do_leaf(c):
        # carry the SCALED basis B = U diag(s) so later truncations rank
        # directions by actual data magnitude; the emitted factor is the
        # orthonormal part
        US, s, Vt = svd_scaled(cols[c])
        k = min(r, s.size)
        Ug = np.zeros((n, r))
        Ug[:, :k] = US[:, :k]
        return (Vt[:k], Ug, float(s[0]) if s.size else 0.0,
                float(s[k]) if s.size > k else 0.0)

    leaf = np.zeros((NBt, r, cs))
    U = []  # state t=0: U[g] is (n, r), g = col leaf index
    max_dropped = sigma_max = 0.0
    for c, (Vtk, Ug, smax, dropped) in enumerate(map_fn(do_leaf,
                                                         range(NBt))):
        leaf[c, :Vtk.shape[0], :] = Vtk
        U.append(Ug)
        sigma_max = max(sigma_max, smax)
        max_dropped = max(max_dropped, dropped)

    # ---- levels --------------------------------------------------------
    levels = []
    for t in range(L):
        hi, lo = NBt // 2 ** (t + 1), 2 ** t
        half = n // 2 ** (t + 1)   # rows per row node at depth t+1
        last = t == L - 1

        def merge(task, U=U, lo=lo, half=half, last=last):
            h, ll, b = task                  # b: row child = output digit
            g0 = (h * 2 + 0) * lo + ll
            g1 = (h * 2 + 1) * lo + ll
            sl = slice(b * half, (b + 1) * half)
            T = np.concatenate([U[g0][sl], U[g1][sl]], axis=1)
            if last:
                # final level: weights ARE the output rows
                return T, None, 0.0
            US, s, Vt = svd_scaled(T)
            k = min(r, s.size)
            Un = np.zeros((half, r))
            Un[:, :k] = US[:, :k]             # scaled basis
            # Vt[:k] is (k, 2r), orthonormal
            return Vt[:k], Un, float(s[k]) if s.size > k else 0.0

        W = np.zeros((hi, 2, 2, lo, bs if last else r, r))
        U_new = [None] * NBt
        tasks = [(h, ll, b) for h in range(hi) for ll in range(lo)
                 for b in (0, 1)]
        for (h, ll, b), (G, Un, dropped) in zip(tasks, map_fn(merge, tasks)):
            W[h, b, 0, ll, :G.shape[0], :] = G[:, :r]
            W[h, b, 1, ll, :G.shape[0], :] = G[:, r:]
            U_new[(h * lo * 2) + b * lo + ll] = Un  # == h*2^{t+1}+b*2^t+ll
            max_dropped = max(max_dropped, dropped)
        U = U_new
        levels.append(W)

    # output block g holds original row block revbits(g)
    sub_perm = _row_perm_for(NB, bs)
    return DistilledButterfly(
        bf=_host_butterfly(leaf, levels, dtype, device),
        row_perm=np.concatenate([b * n + sub_perm
                                 for b in range(NBt // NB)]),
        rank=r, max_sv_discarded=max_dropped, sigma_max=sigma_max,
    )


def _host_butterfly(leaf: np.ndarray, levels: list, dtype,
                    device: torch.device) -> UniformButterfly:
    """The UniformButterfly of host float64 factors, cast to `dtype` on
    `device`."""

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64).to(device=device,
                                                           dtype=dtype)

    # "highest": IEEE float32 products, which the <=1e-6 accuracy line needs
    return UniformButterfly(dev(leaf), [dev(W) for W in levels], radix=2,
                            precision="highest")


def distill_butterfly_batch(
    M: np.ndarray,
    num_blocks: int,
    rank: int,
    dtype=torch.float32,
    workers: int | None = None,
    device=None,
) -> DistilledButterfly:
    """HOST float64 batched distillation: same contract as
    `distill_butterfly_device` — M is a (B, n, m) batch of same-shape
    operators, the batch folds into the block axis, and the result is ONE
    UniformButterfly applying block-diag(M_b) with log2(num_blocks) levels,
    its weights `dtype` tensors on `device` (default: the card).

    Every factor is computed in float64 and only the final weights are cast
    to `dtype`, so the distilled apply reaches the float32 storage floor
    (~1e-7), where the float32 device distillation floors at ~1e-6. The
    per-pair SVDs at each level are independent, so they run on a thread
    pool (LAPACK releases the GIL); reference analogue: the truncated-SVD
    cascade of the merge-and-split core, src/fac.c:867-1049, which is also
    host LAPACK.
    """
    device = resolve_device(device)
    M = np.asarray(M, np.float64)
    if M.ndim == 2:
        M = M[None]
    B, n, m = M.shape
    NB = num_blocks
    check(NB >= 2 and (NB & (NB - 1)) == 0,
          "num_blocks must be a power of 2", InvalidArgumentsError)
    check(n % NB == 0 and m % NB == 0,
          f"n={n}, m={m} must divide num_blocks={NB}", InvalidArgumentsError)
    cs = m // NB
    cols = [M[b][:, c * cs:(c + 1) * cs] for b in range(B) for c in range(NB)]
    with ThreadPoolExecutor(max_workers=workers or min(8, B * NB)) as pool:
        return _distill_from_cols(cols, n, NB, int(rank), dtype, device,
                                  map_fn=pool.map)


def _row_perm_for(NB: int, bs: int) -> np.ndarray:
    """Butterfly row -> original row: output block g holds original row
    block revbits(g)."""
    L = int(round(math.log2(NB)))
    return np.concatenate([
        np.arange(_revbits(g, L) * bs, (_revbits(g, L) + 1) * bs)
        for g in range(NB)
    ])


def distill_butterfly_device(
    M,
    num_blocks: int,
    rank: int,
    dtype=None,
    device=None,
) -> DistilledButterfly:
    """Device-resident distillation: the same complementary-low-rank merge
    recursion as `distill_butterfly`, but every step — column-block QR,
    stacked-basis QR, small SVDs, basis updates — runs as ONE batched
    `torch.linalg` call per level on M's device. The input is a dense
    (n, m) operator, or a BATCH (B, n, m) of same-shape operators folded
    into the block axis (independent sub-butterflies concatenate along
    every level's `hi` axis; the result is ONE UniformButterfly applying
    block-diag(M_b) with log2(num_blocks) levels). A tensor M stays on its
    device, a numpy M goes to `device` (default: the card). Nothing
    round-trips through the host.

    Numerics: float32, products at "highest" precision (IEEE, no TF32);
    tall factors go through QR (never a Gram square), so the singular-value
    noise floor is ~1e-6*sigma_max — the distilled apply meets ~1e-6
    relative error against the input operator, not better. Use the host
    (float64) path when deeper accuracy is required.

    Every level's stacked-basis batch is zero-padded to n/2 rows, as in the
    JAX package (there for one compiled QR and SVD), so a level whose rows
    fall below the rank still yields r transfer rows.
    """
    if not isinstance(M, torch.Tensor):
        M = torch.as_tensor(np.asarray(M)).to(resolve_device(device))
    M = M.to(dtype or torch.float32)
    if M.ndim == 2:
        M = M[None]
    B, n, m = M.shape
    NB = num_blocks
    check(NB >= 2 and (NB & (NB - 1)) == 0,
          "num_blocks must be a power of 2", InvalidArgumentsError)
    check(n % NB == 0 and m % NB == 0,
          f"n={n}, m={m} must divide num_blocks={NB}", InvalidArgumentsError)
    L = int(round(math.log2(NB)))
    cs, bs = m // NB, n // NB
    NBt = B * NB                                # total leaf blocks
    r = int(rank)
    check(r >= 1, "rank must be >= 1", InvalidArgumentsError)
    check(n % 2 == 0, "n must be even", InvalidArgumentsError)
    h_pad = n // 2

    def svd(R):
        # cuSOLVER's QR-iteration SVD: the default Jacobi driver (gesvdj)
        # left the 1024 x 512 DCT's distilled apply at 2.9e-4 on the H100,
        # gesvd at 1.6e-6, the CPU's LAPACK level
        return torch.linalg.svd(R, full_matrices=False,
                                driver="gesvd" if R.is_cuda else None)

    with _f32_precision("highest"):
        # ---- leaf: QR of each column block, SVD of its R --------------
        k = min(r, cs)
        C = M.reshape(B, n, NB, cs).permute(0, 2, 1, 3).reshape(NBt, n, cs)
        Q, R = torch.linalg.qr(C, mode="reduced")
        U_, s, Vt = svd(R)
        leaf = M.new_zeros((NBt, r, cs))
        leaf[:, :k, :] = Vt[:, :k, :]
        U = M.new_zeros((NBt, n, r))
        U[:, :, :k] = Q @ (U_[:, :, :k] * s[:, None, :k])
        sigma_max = float(s[:, 0].max())
        max_dropped = float(s[:, k].max()) if cs > k else 0.0

        levels = []
        for t in range(L):
            hi, lo = NBt // 2 ** (t + 1), 2 ** t
            half = n // 2 ** (t + 1)
            # U indexed by g=(h*2+d)*lo+ll; T[h,b,ll] = (half, (d, r))
            T = U.reshape(hi, 2, lo, 2, half, r).permute(
                0, 3, 2, 4, 1, 5).reshape(NBt, half, 2 * r)
            if t == L - 1:
                # final level: the weights ARE the output rows
                levels.append(T.reshape(hi, 2, lo, bs, 2, r).permute(
                    0, 1, 4, 2, 3, 5).contiguous())
                break
            Tp = torch.nn.functional.pad(T, (0, 0, 0, h_pad - half))
            Q, R = torch.linalg.qr(Tp, mode="reduced")
            U_, s, Vt = svd(R)
            G = Vt[:, :r, :]                               # (NBt, r, 2r)
            US = Q @ (U_[:, :, :r] * s[:, None, :r])       # (NBt, h_pad, r)
            if s.shape[1] > r:
                max_dropped = max(max_dropped, float(s[:, r:].max()))
            levels.append(G.reshape(hi, 2, lo, r, 2, r).permute(
                0, 1, 4, 2, 3, 5).contiguous())
            U = US[:, :half, :]

    bf = UniformButterfly(leaf, levels, radix=2, precision="highest")
    sub_perm = _row_perm_for(NB, bs)
    return DistilledButterfly(
        bf=bf,
        row_perm=np.concatenate([b * n + sub_perm for b in range(B)]),
        rank=r, max_sv_discarded=max_dropped, sigma_max=sigma_max,
    )
