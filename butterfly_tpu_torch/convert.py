"""Carry operators and weights across from the JAX package.

The JAX package (`butterfly_tpu`) and the port store a butterfly in the
same layout: a (NB, m0, k0) leaf and (hi, R, R, lo, m, k) levels. These
functions take those parameters as numpy arrays — e.g. `np.asarray` of a
JAX `UniformButterfly`'s factors — and build the port's objects, so that a
test can hand both packages the same operator. `linop_from_numpy` rebuilds
a host `LinOp` tree (such as a multilevel Helmholtz factorization) and
`cells_from_numpy` a list of cells, `fast_direct_solver_from_numpy` a
hierarchical-LU factorization, `compressed_table_from_numpy` a retrieval
table's factors, `kr_corrector_from_numpy` a Kapur-Rokhlin accumulate
corrector, `lbo_compression_from_numpy` a compressed LBO eigenbasis.
Nothing here imports JAX or the JAX
package: the JAX objects are read by class name and fields.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from butterfly_tpu_torch.fac import solver as S
from butterfly_tpu_torch.fac.distill import DistilledButterfly
from butterfly_tpu_torch.fac.streamer import PartialFac
from butterfly_tpu_torch.models.lbo import LboCompression
from butterfly_tpu_torch.models.retrieval import CompressedTable
from butterfly_tpu_torch.ops import linop as L
from butterfly_tpu_torch.ops.butterfly import UniformButterfly
from butterfly_tpu_torch.ops.cellsp import Cell
from butterfly_tpu_torch.ops.quadrature import KrAccumCorrector
from butterfly_tpu_torch.trees import IntervalTree, Tree, TreeNode
from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError

__all__ = ["cells_from_numpy", "compressed_table_from_numpy",
           "distilled_from_numpy",
           "fast_direct_solver_from_numpy", "kr_corrector_from_numpy",
           "lbo_compression_from_numpy", "linop_from_numpy", "uniform_butterfly_from_numpy"]


def _tensor(a, device, dtype):
    t = torch.from_numpy(np.array(a))  # a copy: JAX's arrays are read-only
    return t.to(device=device, dtype=dtype or t.dtype)


def uniform_butterfly_from_numpy(
    leaf: np.ndarray | None,
    levels: Sequence[np.ndarray],
    radix: int = 2,
    precision=None,
    device=None,
    dtype: torch.dtype | None = None,
) -> UniformButterfly:
    """The port's UniformButterfly from numpy factors in the JAX layout.
    dtype=None keeps the arrays' own dtype (numpy has no bfloat16: pass
    float32 arrays and dtype=torch.bfloat16 for a bfloat16 operator)."""
    device = resolve_device(device)
    return UniformButterfly(
        None if leaf is None else _tensor(leaf, device, dtype),
        [_tensor(W, device, dtype) for W in levels],
        radix=radix, precision=precision,
    )


def distilled_from_numpy(
    leaf: np.ndarray,
    levels: Sequence[np.ndarray],
    row_perm: np.ndarray,
    rank: int,
    max_sv_discarded: float,
    sigma_max: float = 0.0,
    precision="highest",
    device=None,
    dtype: torch.dtype | None = None,
) -> DistilledButterfly:
    """The port's DistilledButterfly from a JAX one's weights and fields."""
    bf = uniform_butterfly_from_numpy(leaf, levels, 2, precision, device,
                                      dtype)
    return DistilledButterfly(
        bf=bf, row_perm=np.asarray(row_perm), rank=int(rank),
        max_sv_discarded=float(max_sv_discarded), sigma_max=float(sigma_max),
    )


def compressed_table_from_numpy(Psi: np.ndarray, V: np.ndarray, device=None,
                                dtype: torch.dtype | None = None
                                ) -> CompressedTable:
    """The port's CompressedTable from a JAX one's factors: Psi (NB, s,
    rank) and V (NB, rank, d) as numpy arrays. dtype=None keeps their own
    dtype."""
    device = resolve_device(device)
    return CompressedTable(_tensor(Psi, device, dtype),
                           _tensor(V, device, dtype))


def linop_from_numpy(op) -> L.LinOp:
    """The port's `LinOp` tree for a JAX-package `LinOp` tree, holding the
    same numpy arrays (nothing is copied).

    Carries Dense, Diag, Identity, Zero, Perm, Scaled, Product, Sum, Diff,
    BlockDiag, BlockCoo, BlockDense and Coo, recursively; any other class
    raises InvalidArgumentsError."""
    name = type(op).__name__
    conv = linop_from_numpy
    if name == "Dense":
        return L.Dense(op.data)
    if name == "Diag":
        return L.Diag(op.diag, tuple(op.shape))
    if name == "Identity":
        return L.Identity(op.shape[0], op.dtype)
    if name == "Zero":
        return L.Zero(tuple(op.shape), op.dtype)
    if name == "Perm":
        return L.Perm(op.perm, op.dtype)
    if name == "Scaled":
        return L.Scaled(op.alpha, conv(op.op))
    if name == "Product":
        return L.Product([conv(f) for f in op.factors])
    if name == "Sum":
        return L.Sum([conv(t) for t in op.terms])
    if name == "Diff":
        return L.Diff(conv(op.a), conv(op.b))
    if name == "BlockDiag":
        return L.BlockDiag([conv(b) for b in op.blocks])
    if name == "BlockCoo":
        return L.BlockCoo(op.row_offsets, op.col_offsets, op.row_inds,
                          op.col_inds, [conv(b) for b in op.blocks])
    if name == "BlockDense":
        return L.BlockDense([[conv(b) for b in row] for row in op.grid])
    if name == "Coo":
        return L.Coo(tuple(op.shape), op.row_inds, op.col_inds, op.values)
    raise InvalidArgumentsError(f"cannot carry a {name} across")


def kr_corrector_from_numpy(corr) -> KrAccumCorrector:
    """The port's `KrAccumCorrector` for a JAX-package one: the same
    (n, 2*order) coefficient and index tables."""
    return KrAccumCorrector(np.asarray(corr.coef), np.asarray(corr.idx))


def cells_from_numpy(cells) -> list[Cell]:
    """The port's `Cell`s for a list of JAX-package cells: the same dst,
    src_buf and src_blk, and the same weight (a float32 tile, None for a
    plain add, or a ("dev", stack, index) reference)."""
    out = []
    for c in cells:
        w = c.w
        if w is not None and not isinstance(w, tuple):
            w = np.asarray(w, np.float32)
        out.append(Cell(int(c.dst), int(c.src_buf), int(c.src_blk), w))
    return out


def fast_direct_solver_from_numpy(fds) -> S.FastDirectSolver:
    """The port's `FastDirectSolver` for a JAX-package one: the same node
    tree, the leaves' LU factors and pivots as numpy arrays, each node's
    A12/A21 carried with `linop_from_numpy` (a sampled operator as its
    stored LinOp, without the build-time cache). Nothing is factorized
    again."""

    def node(nd):
        name = type(nd).__name__
        if name == "_DenseLU":
            leaf = S._DenseLU.__new__(S._DenseLU)
            leaf._lu = tuple(np.array(a) for a in nd._lu)
            leaf.shape = tuple(nd.shape)
            return leaf
        if name != "_HlNode":
            raise InvalidArgumentsError(f"cannot carry a {name} across")
        return S._HlNode(int(nd.m), node(nd.lu1), node(nd.lu2),
                         offdiag(nd.A12), offdiag(nd.A21))

    def offdiag(op):
        if type(op).__name__ == "_SampledOp":
            return S._SampledOp(linop_from_numpy(op.op), None)
        return linop_from_numpy(op)

    out = S.FastDirectSolver.__new__(S.FastDirectSolver)
    # the build settings (tol, base_size, rank, cutoff, split bounds, ...)
    # are plain Python values
    out.__dict__.update({k: v for k, v in vars(fds).items() if k != "_root"})
    out._root = node(fds._root)
    return out


def lbo_compression_from_numpy(lbo) -> LboCompression:
    """The port's `LboCompression` for a JAX-package one: the same
    `PartialFac` operators (Psi and the W factors, carried with
    `linop_from_numpy`), frequencies, row-tree permutation and dense bytes.
    The row tree comes across as its root and permutation, the row cut as
    bare nodes with the same index ranges, and the column tree is rebuilt
    over the same interval and depth with the frequencies attached."""
    fac, rt, ct = lbo.fac, lbo.row_tree, lbo.col_tree
    perm = np.array(rt.perm, dtype=np.int64)
    row_tree = Tree(TreeNode(None, 0, 0, perm.size), perm)
    depth = max(nd.depth for nd in ct.root.subtree_nodes())
    col_tree = IntervalTree(ct.a, ct.b, arity=ct.arity, depth=depth)
    freqs = np.array(lbo.freqs, dtype=np.float64)
    col_tree.set_points(freqs)
    row_nodes = [TreeNode(None, nd.depth, nd.i0, nd.i1)
                 for nd in fac.row_nodes]
    pf = PartialFac(col_tree.root, row_nodes, linop_from_numpy(fac.Psi),
                    [linop_from_numpy(w) for w in fac.W])
    return LboCompression(fac=pf, freqs=freqs, row_tree=row_tree,
                          col_tree=col_tree, dense_bytes=int(lbo.dense_bytes))
