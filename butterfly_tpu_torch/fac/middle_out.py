"""Randomized middle-out MULTILEVEL butterfly sampling of matrix-free
operators.

Port counterpart of `butterfly_tpu/fac/middle_out.py`: the same host
float64 code, copied so that the port imports nothing of the JAX package.

A redesign of the reference's randomized reflector compression
(sample_middle_out_butterfly,
examples/fast_direct_solver/fast_direct_solver.py:404-607). The operator R,
accessible only through (r)matvecs, is compressed into

    R  ~=  blkdiag(U_a) . C . blkdiag(V_b)^H

where — unlike a one-level randomized SVD — each U_a and V_b is itself a
MULTILEVEL butterfly: for every column block b a Gaussian sketch Omega_b is
pushed through R, the per-row-block orthonormal bases Q_ab of Y = R Omega are
FED INTO a per-row-node FacStreamer over an index tree with p-column leaves
(reference: rowFacStreamers feeds, fast_direct_solver.py:521-527), and
symmetrically for the adjoint side. The middle factor C is the butterfly
shuffle: one p x p coupling block per (a, b) pair, recovered by least squares
against the sketches (reference: lstsq middle blocks,
fast_direct_solver.py:557-563), placed at block (a*N + b, b*M + a) — the
perfect-shuffle block pattern of MatBlockCoo (reference:
fast_direct_solver.py:565-599).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from butterfly_tpu_torch.config import FacSpec
from butterfly_tpu_torch.fac.streamer import FacStreamer
from butterfly_tpu_torch.ops.linop import (
    BlockCoo,
    BlockDiag,
    Dense,
    LinOp,
    Product,
)
from butterfly_tpu_torch.trees import uniform_tree
from butterfly_tpu_torch.utils.errors import check
from butterfly_tpu_torch.utils.prng import host_rng

__all__ = ["sample_middle_out_butterfly"]


def _orth_cols(Y: np.ndarray, p: int) -> np.ndarray:
    """Leading-p orthonormal column basis of Y (rank-revealing SVD)."""
    if Y.shape[1] == 0 or Y.shape[0] == 0:
        return np.zeros((Y.shape[0], 0), dtype=Y.dtype)
    U = np.linalg.svd(Y, full_matrices=False)[0]
    return np.ascontiguousarray(U[:, :p])


def _index_tree(num_blocks: int, p: int):
    """Index tree whose leaves hold exactly p points, mirroring a uniform
    partition into num_blocks blocks (reference: bfTreeNewForMiddleFac,
    src/tree.c:92-108)."""
    depth = max(int(np.round(np.log2(max(num_blocks, 1)))), 0)
    check(2**depth == num_blocks, "block count must be a power of two")
    return uniform_tree(num_blocks * p, 2, depth)


def sample_middle_out_butterfly(
    matvec: Callable[[np.ndarray], np.ndarray],
    rmatvec: Callable[[np.ndarray], np.ndarray],
    row_offsets: Sequence[int],
    col_offsets: Sequence[int],
    rank: int,
    oversample: int = 10,
    tol: float = 1e-10,
    dtype=np.float64,
    rng: np.random.Generator | None = None,
    return_parts: bool = False,
    deep: bool = True,
) -> LinOp:
    """Compress R (shape implied by the offsets) into a multilevel
    middle-out butterfly.

    matvec/rmatvec must accept (n, k) matrices. row_offsets/col_offsets are
    the block boundaries of the top-level row/col partitions (power-of-two
    block counts); `rank` is the per-block rank budget p, `oversample` the
    extra sketch columns q.
    """
    if rng is None:
        rng = host_rng()
    row_offsets = np.asarray(row_offsets)
    col_offsets = np.asarray(col_offsets)
    m, n = int(row_offsets[-1]), int(col_offsets[-1])
    M, N = len(row_offsets) - 1, len(col_offsets) - 1
    p, q = int(rank), int(oversample)
    check(p >= 1, "rank must be positive")
    check(
        all(row_offsets[a + 1] - row_offsets[a] >= p for a in range(M))
        and all(col_offsets[b + 1] - col_offsets[b] >= p for b in range(N)),
        "every block must hold at least `rank` points",
    )

    iscomplex = np.issubdtype(np.dtype(dtype), np.complexfloating)

    def randn(*shape):
        X = rng.standard_normal(shape)
        if iscomplex:
            X = (X + 1j * rng.standard_normal(shape)) / np.sqrt(2)
        return X.astype(dtype)

    # Per-node streamers over index trees with p-point leaves
    # (reference: rowFacStreamers/colFacStreamers,
    # fast_direct_solver.py:477-489). With deep=False the bases stay
    # one-level (stacked Q blocks) — much cheaper to build, and usually
    # smaller too when the sketched bases carry no hierarchical structure.
    def streamer(block_rows: int, index_tree) -> FacStreamer:
        row_depth = max(int(np.ceil(np.log2(max(block_rows // max(p, 1), 2)))), 1)
        spec = FacSpec(
            row_tree=uniform_tree(block_rows, 2, row_depth),
            col_tree=index_tree,
            row_tree_init_depth=1,
            tol=tol,
            min_num_rows=p,
            min_num_cols=p,
        )
        return FacStreamer(spec, auto_skip_empty_leaves=True)

    if deep:
        col_index_tree = _index_tree(N, p)
        row_index_tree = _index_tree(M, p)
        row_streamers = [
            streamer(int(row_offsets[a + 1] - row_offsets[a]), col_index_tree)
            for a in range(M)
        ]
        col_streamers = [
            streamer(int(col_offsets[b + 1] - col_offsets[b]), row_index_tree)
            for b in range(N)
        ]
    else:
        row_streamers = col_streamers = None
        Q_cols: list[list[np.ndarray]] = [[] for _ in range(M)]
        Qt_rows: list[list[np.ndarray]] = [[] for _ in range(N)]

    omega_blocks = [
        randn(int(col_offsets[b + 1] - col_offsets[b]), p + q) for b in range(N)
    ]
    omega_tilde_blocks = [
        randn(int(row_offsets[a + 1] - row_offsets[a]), p + q) for a in range(M)
    ]

    A_blocks = np.empty((M, N), dtype=object)
    B_blocks = np.empty((M, N), dtype=object)

    # Column sweeps: sample each block column's range, stream the left
    # butterfly factors, record the lstsq system matrices
    # (reference: fast_direct_solver.py:505-527).
    for b in range(N):
        j0, j1 = int(col_offsets[b]), int(col_offsets[b + 1])
        Omega = np.zeros((n, p + q), dtype=dtype)
        Omega[j0:j1] = omega_blocks[b]
        Y = np.asarray(matvec(Omega))
        for a in range(M):
            i0, i1 = int(row_offsets[a]), int(row_offsets[a + 1])
            Q = _orth_cols(Y[i0:i1], p)
            if deep:
                row_streamers[a].feed(Q)
            else:
                Q_cols[a].append(Q)
            A_blocks[a, b] = np.conj(omega_tilde_blocks[a]).T @ Q

    if deep:
        check(all(s.is_done() for s in row_streamers),
              "row streaming incomplete")

    # Row sweeps via the adjoint: stream the right factors, record the
    # lstsq load matrices (reference: fast_direct_solver.py:530-552).
    for a in range(M):
        i0, i1 = int(row_offsets[a]), int(row_offsets[a + 1])
        OmegaT = np.zeros((m, p + q), dtype=dtype)
        OmegaT[i0:i1] = omega_tilde_blocks[a]
        Z = np.asarray(rmatvec(OmegaT))  # = R^H OmegaT, (n, p+q)
        for b in range(N):
            j0, j1 = int(col_offsets[b]), int(col_offsets[b + 1])
            Qt = _orth_cols(Z[j0:j1], p)
            if deep:
                col_streamers[b].feed(Qt)
            else:
                Qt_rows[b].append(Qt)
            B_blocks[a, b] = np.conj(Z[j0:j1]).T @ Qt

    if deep:
        check(all(s.is_done() for s in col_streamers),
              "col streaming incomplete")

    # Middle coupling blocks by least squares
    # (reference: fast_direct_solver.py:556-563).
    middle = np.empty((M, N), dtype=object)
    for a in range(M):
        for b in range(N):
            C, *_ = np.linalg.lstsq(A_blocks[a, b], B_blocks[a, b], rcond=None)
            middle[a, b] = C

    # Assemble: blkdiag of multilevel left facs, perfect-shuffle middle,
    # blkdiag of multilevel right facs adjoint
    # (reference: fast_direct_solver.py:565-607). All streamers share a
    # column index tree, so their facs have EQUAL factor counts and the
    # blkdiag-of-products distributes exactly into a product of blkdiags —
    # keeping every factor single-stage so the packed executors
    # (ops/packed.py, ops/hostpack.py) can flatten the result.
    #
    # Storage adaptivity (improvement over the reference's fixed scheme):
    # when the sketched bases carry no hierarchical structure the streamed
    # fac stores MORE than the plain stacked basis — per side, keep the
    # smaller of {multilevel fac, one-level dense basis blkdiag}.
    if deep:
        U_mats = [s.get_fac().as_linop().matmat(np.eye(N * p, dtype=dtype))
                  for s in row_streamers]
        V_mats = [s.get_fac().as_linop().matmat(np.eye(M * p, dtype=dtype))
                  for s in col_streamers]

        def _side(streamers, mats) -> LinOp:
            fac_bytes = sum(s.get_fac().nbytes() for s in streamers)
            thin_bytes = sum(m_.nbytes for m_ in mats)
            if fac_bytes <= thin_bytes:
                return _blockdiag_of_facs([s.get_fac() for s in streamers])
            return BlockDiag([_as_dense(m_) for m_ in mats])

        left = _side(row_streamers, U_mats)
        right = _side(col_streamers, V_mats).adjoint()
    else:
        U_mats = [np.concatenate(qs, axis=1) for qs in Q_cols]
        V_mats = [np.concatenate(qs, axis=1) for qs in Qt_rows]
        left = BlockDiag([_as_dense(u) for u in U_mats])
        right = BlockDiag([_as_dense(v) for v in V_mats]).adjoint()

    row_off = np.concatenate([[0], np.cumsum(
        [middle[a, b].shape[0] for a in range(M) for b in range(N)]
    )])
    col_off = np.concatenate([[0], np.cumsum(
        [middle[a_, b_].shape[1] for b_ in range(N) for a_ in range(M)]
    )])
    row_inds, col_inds, blocks = [], [], []
    for a in range(M):
        for b in range(N):
            row_inds.append(a * N + b)
            col_inds.append(b * M + a)
            blocks.append(_as_dense(middle[a, b]))
    mid = BlockCoo(row_off, col_off, row_inds, col_inds, blocks)
    op = Product([left, mid, right])
    if not return_parts:
        return op
    # thin parts for BLAS-speed build-time applies: U_a / V_b materialized
    # (m_a, N*p) / (n_b, M*p); C as an (M, N, p, p) array
    C = np.zeros((M, N, p, p), dtype=dtype)
    for a in range(M):
        for b in range(N):
            C[a, b] = middle[a, b]
    parts = dict(U=U_mats, V=V_mats, C=C, row_offsets=np.asarray(row_offsets),
                 col_offsets=np.asarray(col_offsets), p=p)
    return op, parts


def _as_dense(x: np.ndarray):
    return Dense(np.ascontiguousarray(x))


def _blockdiag_of_facs(facs) -> Product:
    """blkdiag of PartialFacs with equal factor counts, distributed into a
    Product of per-factor BlockDiags: blkdiag(Psi_a W0_a ...) ==
    blkdiag(Psi_a) . blkdiag(W0_a) . ..."""
    nw = facs[0].num_w
    check(all(f.num_w == nw for f in facs), "facs must have equal W depth")
    factors = [BlockDiag([f.Psi for f in facs])]
    for k in range(nw):
        factors.append(BlockDiag([f.W[k] for f in facs]))
    return Product(factors)
