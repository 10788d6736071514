"""Analytic 2-D Helmholtz butterfly factorization.

TPU-native redesign of the reference's analytic factorization engine
(src/fac_helm2.c:42-1002). The mathematical construction is identical —
proxy-circle re-expansion on a quadtree, one block-diagonal charge-shift
factor at the leaves, block-COO shift factors per level pair, and a final
block-diagonal evaluation factor — but the output is the compositional
`LinOp` algebra (BlockDiag / BlockCoo / Product / BlockDense) built from
batched NumPy kernel assembly rather than a vtable object graph, and is then
compiled by `ops/packed.py` into level-synchronous batched GEMMs for the MXU.

Construction is host-side setup work; apply is the device hot path.

Port counterpart of `butterfly_tpu/fac/helm2.py`, copied unchanged in
substance (host float64) so that the port imports nothing of the JAX
package; its output is the port's `LinOp` tree, which
`fac/partition.py` compiles for the card.
"""

from __future__ import annotations

import numpy as np

from butterfly_tpu_torch.geom.circle import Circle
from butterfly_tpu_torch.ops.helm2 import USES_SRC_NORMALS, USES_TGT_NORMALS, Helm2
from butterfly_tpu_torch.ops.linop import (
    BlockCoo,
    BlockDense,
    BlockDiag,
    Dense,
    LinOp,
    Product,
)
from butterfly_tpu_torch.trees.point_tree import PointTree, PointTreeNode
from butterfly_tpu_torch.trees.tree import level_is_internal, level_num_points
from butterfly_tpu_torch.utils.errors import RuntimeButterflyError, check

#: Blocks with fewer entries than this are kept dense
#: (reference: MAX_DENSE_MATRIX_SIZE, src/fac_helm2.c:20).
MAX_DENSE_MATRIX_SIZE = 128 * 128

#: Rank-estimate constants (reference: C=1, eps=1e-15 at call sites,
#: src/fac_helm2.c:102,291-296).
RANK_EST_C = 1.0
RANK_EST_EPS = 1e-15


def _circ(node: PointTreeNode) -> Circle:
    return node.bounding_circle()


def _all_rank_estimates_ok(helm: Helm2, tgt_node: PointTreeNode, src_level) -> bool:
    """Butterfliability test: every a-priori rank must be no larger than the
    node's point count (reference: allRankEstimatesAreOK,
    src/fac_helm2.c:511-530)."""
    tgt_circ = _circ(tgt_node)
    for src_node in src_level:
        try:
            rank = helm.rank_estimate(_circ(tgt_node), _circ(src_node),
                                      RANK_EST_C, RANK_EST_EPS)
        except RuntimeButterflyError:
            return False
        if rank > src_node.num_points:
            return False
    _ = tgt_circ
    return True


def prepare(helm: Helm2, src_node: PointTreeNode, tgt_node: PointTreeNode):
    """Choose compatible source/target level traversals and count factors
    (reference: bfFacHelm2Prepare, src/fac_helm2.c:551-651).

    Returns (src_levels, tgt_levels, num_factors) where src_levels is indexed
    from the subtree root down and num_factors == 0 means "not butterfliable"
    — the source iterator walks src_levels in REVERSE (leaves -> root) while
    the target iterator walks tgt_levels forward (root -> leaves).
    """
    if src_node.is_leaf or tgt_node.is_leaf:
        return None, None, 0

    src_levels = [list(l) for l in _levels_below(src_node)]
    tgt_levels = [list(l) for l in _levels_below(tgt_node)]

    # Deepest consecutively-internal depth of the target subtree
    # (reference: maxAllowableDepthBelowTgtNode, src/fac_helm2.c:583-591).
    T = tgt_node.depth
    max_allowable = T
    i = 1
    while i < len(tgt_levels) and level_is_internal(tgt_levels[i]):
        max_allowable += 1
        i += 1

    num_src_points = src_node.num_points
    S = src_node.depth + len(src_levels) - 1  # absolute depth of deepest level
    li = len(src_levels) - 1

    def up():
        nonlocal S, li
        S -= 1
        li -= 1

    # Skip source levels deeper than the target tree allows
    # (reference: src/fac_helm2.c:612-615).
    while li > 0 and S > max_allowable:
        up()
    # Skip until the level is complete (holds every subtree point)
    # (reference: src/fac_helm2.c:617-622).
    while li > 0 and level_num_points(src_levels[li]) != num_src_points:
        up()
    # Skip until the level is internal (reference: src/fac_helm2.c:624-628).
    while li > 0 and not level_is_internal(src_levels[li]):
        up()
    # Move up while rank estimates exceed point counts
    # (reference: src/fac_helm2.c:634-638).
    while li > 0 and S > T and not _all_rank_estimates_ok(
        helm, tgt_node, src_levels[li]
    ):
        up()

    if li <= 0 or not _all_rank_estimates_ok(helm, tgt_node, src_levels[li]):
        return None, None, 0

    num_factors = S - T + 2
    # Source traversal: src_levels[li], src_levels[li-1], ..., src_levels[0].
    return src_levels[: li + 1], tgt_levels, num_factors


def _levels_below(node: PointTreeNode):
    out = []
    frontier = [node]
    while frontier:
        out.append(frontier)
        frontier = [c for n in frontier for c in n.children]
    return out


def _make_first_factor(
    helm: Helm2, tree: PointTree, src_level, tgt_level
) -> BlockDiag:
    """Leaf-level charge shift: one re-expansion per source node onto its
    proxy circle (reference: makeFirstFactor, src/fac_helm2.c:42-160)."""
    check(len(tgt_level) == 1, "first factor expects a single target node")
    helm_proxy = helm.proxy()
    tgt_circ = _circ(tgt_level[0])

    use_normals = helm_proxy.layer_pot in USES_SRC_NORMALS
    # batch leaves by (num_points, rank) shape class (see _make_inner_factor)
    metas = []
    for src_node in src_level:
        src_circ = _circ(src_node)
        src_pts = tree.node_points(src_node)
        src_normals = tree.node_normals(src_node) if use_normals else None
        p = helm.rank_estimate(src_circ, tgt_circ, RANK_EST_C, RANK_EST_EPS)
        metas.append((src_node, src_circ, src_pts, src_normals, p))

    groups: dict = {}
    for bi, m in enumerate(metas):
        key = (len(m[2]), m[4])
        groups.setdefault(key, []).append(bi)

    blocks: list = [None] * len(metas)
    for (npts, p), idxs in groups.items():
        so, se, tg, no, ne = [], [], [], [], []
        for bi in idxs:
            _, src_circ, src_pts, src_normals, _p = metas[bi]
            so.append(src_pts)
            se.append(src_circ.sample_points(p))
            tg.append(tgt_circ.sample_points(p))
            if use_normals:
                no.append(src_normals)
                ne.append(src_circ.sample_unit_normals(p))
        Z = helm_proxy.reexpansion_matrices_batched(
            np.stack(so), np.stack(se), np.stack(tg),
            np.stack(no) if use_normals else None,
            np.stack(ne) if use_normals else None,
        )
        for b, bi in enumerate(idxs):
            blocks[bi] = Dense(Z[b])
    return BlockDiag(blocks)


def _enumerate_children(level):
    """(parent_index, child) pairs in LR order — the deeper level's nodes."""
    out = []
    for pi, node in enumerate(level):
        for child in node.children:
            out.append((pi, child))
    return out


def _make_inner_factor(
    helm: Helm2, prev: LinOp, src_level, tgt_level
) -> BlockCoo:
    """Inner shift factor as block-COO with the butterfly sparsity pattern
    (reference: makeFactor, src/fac_helm2.c:222-401).

    Block rows are (target child, source parent) pairs; block cols are
    (target parent, source child) pairs; block (i, j) re-expands charges from
    the source child circle onto the source parent circle, matched on the
    target child circle.
    """
    helm_proxy = helm.proxy()
    src_children = _enumerate_children(src_level)  # previous (deeper) src level
    tgt_children = _enumerate_children(tgt_level)
    num_src_nodes = len(src_level)
    num_src_children = len(src_children)
    num_tgt_children = len(tgt_children)

    num_block_rows = num_tgt_children * num_src_nodes
    num_block_cols = num_src_children * len(tgt_level)

    # Column sizes equal the previous factor's block-row sizes
    # (reference: src/fac_helm2.c:258-265).
    prev_row_offsets = _row_offsets_of(prev)
    check(num_block_cols == len(prev_row_offsets) - 1,
          "butterfly level bookkeeping mismatch")
    col_sizes = np.diff(prev_row_offsets)

    # First pass: per-block rank estimates; row size = max rank over the row
    # (reference: src/fac_helm2.c:275-318).
    row_sizes = np.zeros(num_block_rows, dtype=np.int64)
    entries = []  # (i, j, src_parent, src_child, tgt_parent, tgt_child)
    block_index = 0
    for tci, (tpi, tgt_child) in enumerate(tgt_children):
        for sci, (spi, src_child) in enumerate(src_children):
            i = tci * num_src_nodes + spi
            j = tpi * num_src_children + sci
            rank_or = helm.rank_estimate(
                _circ(src_child), _circ(tgt_level[tpi]), RANK_EST_C, RANK_EST_EPS
            )
            rank_eq = helm.rank_estimate(
                _circ(src_level[spi]), _circ(tgt_child), RANK_EST_C, RANK_EST_EPS
            )
            rank = max(rank_or, rank_eq)
            row_sizes[i] = max(row_sizes[i], rank)
            entries.append((i, j, spi, src_child, tpi, tgt_child))
            block_index += 1

    row_offsets = np.concatenate([[0], np.cumsum(row_sizes)])
    col_offsets = np.concatenate([[0], np.cumsum(col_sizes)])

    # Second pass: sample proxy circles and build shift matrices, BATCHED
    # by (num_rows, num_cols) shape class so each class costs one stacked
    # kernel evaluation + one stacked SVD least-squares instead of
    # per-block Python calls (reference loop: src/fac_helm2.c:324-391; the
    # batching is the TPU-era redesign — per-block np.linalg.lstsq overhead
    # was ~44% of setup time at n=8k).
    use_normals = helm_proxy.layer_pot in USES_SRC_NORMALS
    groups: dict = {}
    for e in entries:
        i, j = e[0], e[1]
        key = (int(row_sizes[i]), int(col_sizes[j]))
        groups.setdefault(key, []).append(e)

    row_inds, col_inds, blocks = [], [], []
    placed = {}
    for (num_rows, num_cols), es in groups.items():
        sc_pts, s_pts, tc_pts, sc_nrm, s_nrm = [], [], [], [], []
        for (i, j, spi, src_child, tpi, tgt_child) in es:
            src_child_circ = _circ(src_child)
            src_circ = _circ(src_level[spi])
            tgt_child_circ = _circ(tgt_child)
            sc_pts.append(src_child_circ.sample_points(num_cols))
            s_pts.append(src_circ.sample_points(num_rows))
            tc_pts.append(tgt_child_circ.sample_points(num_rows))
            if use_normals:
                sc_nrm.append(src_child_circ.sample_unit_normals(num_cols))
                s_nrm.append(src_circ.sample_unit_normals(num_rows))
        Z = helm_proxy.reexpansion_matrices_batched(
            np.stack(sc_pts), np.stack(s_pts), np.stack(tc_pts),
            np.stack(sc_nrm) if use_normals else None,
            np.stack(s_nrm) if use_normals else None,
        )
        for b, (i, j, *_rest) in enumerate(es):
            placed[(i, j)] = Dense(Z[b])
    # emit in the original enumeration order (stable block layout)
    for (i, j, *_rest) in entries:
        row_inds.append(i)
        col_inds.append(j)
        blocks.append(placed[(i, j)])

    return BlockCoo(row_offsets, col_offsets, row_inds, col_inds, blocks)


def _row_offsets_of(op: LinOp) -> np.ndarray:
    if isinstance(op, (BlockDiag, BlockCoo)):
        return np.asarray(op.row_offsets)
    raise RuntimeButterflyError(f"expected block operator, got {type(op)}")


def _make_last_factor(
    helm: Helm2, tree: PointTree, prev: LinOp, src_level, tgt_level
) -> BlockDiag:
    """Final evaluation factor: kernel matrices from the top source proxy
    circle to the true target points (reference: makeLastFactor,
    src/fac_helm2.c:403-509)."""
    check(len(src_level) == 1, "last factor expects a single source node")
    src_circ = _circ(src_level[0])
    prev_row_offsets = _row_offsets_of(prev)
    check(len(tgt_level) == len(prev_row_offsets) - 1,
          "last-factor block count mismatch")

    blocks = []
    for bi, tgt_node in enumerate(tgt_level):
        p = int(prev_row_offsets[bi + 1] - prev_row_offsets[bi])
        src_circ_pts = src_circ.sample_points(p)
        src_normals = (
            src_circ.sample_unit_normals(p)
            if helm.layer_pot in USES_SRC_NORMALS
            else None
        )
        tgt_pts = tree.node_points(tgt_node)
        tgt_normals = (
            tree.node_normals(tgt_node)
            if helm.layer_pot in USES_TGT_NORMALS
            else None
        )
        Z = helm.kernel_matrix(src_circ_pts, tgt_pts, src_normals, tgt_normals)
        blocks.append(Dense(Z))
    return BlockDiag(blocks)


def make(
    helm: Helm2,
    src_tree: PointTree,
    tgt_tree: PointTree,
    src_levels,
    tgt_levels,
    num_factors: int,
) -> Product:
    """Chain the factors into a Product, first-applied factor last
    (reference: bfFacHelm2Make, src/fac_helm2.c:653-704)."""
    check(num_factors >= 2, "need at least two factors")
    factors: list[LinOp] = []

    src_li = len(src_levels) - 1  # deepest chosen source level
    tgt_li = 0

    factors.append(
        _make_first_factor(helm, src_tree, src_levels[src_li], tgt_levels[tgt_li])
    )
    for _ in range(num_factors - 2):
        src_li -= 1  # up one source level
        factors.append(
            _make_inner_factor(
                helm, factors[-1], src_levels[src_li], tgt_levels[tgt_li]
            )
        )
        tgt_li += 1  # down one target level
    factors.append(
        _make_last_factor(
            helm, tgt_tree, factors[-1], src_levels[src_li], tgt_levels[tgt_li]
        )
    )
    return Product(list(reversed(factors)))


def make_single(
    helm: Helm2,
    src_tree: PointTree,
    tgt_tree: PointTree,
    src_node: PointTreeNode | None = None,
    tgt_node: PointTreeNode | None = None,
) -> LinOp:
    """Butterfly-factorize the kernel block mapping src_node's points to
    tgt_node's points (reference: bfFacHelm2MakeSingleLevel,
    src/fac_helm2.c:706-729). Falls back to dense if not butterfliable."""
    src_node = src_node if src_node is not None else src_tree.root
    tgt_node = tgt_node if tgt_node is not None else tgt_tree.root
    src_levels, tgt_levels, num_factors = prepare(helm, src_node, tgt_node)
    if num_factors == 0:
        return _dense_block(helm, src_tree, tgt_tree, src_node, tgt_node)
    return make(helm, src_tree, tgt_tree, src_levels, tgt_levels, num_factors)


def _dense_block(
    helm: Helm2, src_tree: PointTree, tgt_tree: PointTree, src_node, tgt_node
) -> Dense:
    """(reference: facHelm2MakeMultilevel_dense, src/fac_helm2.c:741-775)"""
    src_pts = src_tree.node_points(src_node)
    tgt_pts = tgt_tree.node_points(tgt_node)
    src_normals = (
        src_tree.node_normals(src_node) if helm.layer_pot in USES_SRC_NORMALS else None
    )
    tgt_normals = (
        tgt_tree.node_normals(tgt_node) if helm.layer_pot in USES_TGT_NORMALS else None
    )
    return Dense(helm.kernel_matrix(src_pts, tgt_pts, src_normals, tgt_normals))


def _multilevel_block(
    helm: Helm2, src_tree: PointTree, tgt_tree: PointTree, src_node, tgt_node
) -> LinOp:
    """One block of the multilevel partition
    (reference: facHelm2MakeMultilevel_rec per-block body,
    src/fac_helm2.c:886-895)."""
    m, n = tgt_node.num_points, src_node.num_points
    if m * n < MAX_DENSE_MATRIX_SIZE:
        return _dense_block(helm, src_tree, tgt_tree, src_node, tgt_node)
    if tgt_node.is_separated_from(src_node):
        return make_single(helm, src_tree, tgt_tree, src_node, tgt_node)
    # Not separated: recurse into the children grid
    # (reference: facHelm2MakeMultilevel_diag, src/fac_helm2.c:814-857).
    if src_node.is_leaf or tgt_node.is_leaf:
        return _dense_block(helm, src_tree, tgt_tree, src_node, tgt_node)
    grid = [
        [
            _multilevel_block(helm, src_tree, tgt_tree, src_child, tgt_child)
            for src_child in src_node.children
        ]
        for tgt_child in tgt_node.children
    ]
    return BlockDense(grid)


def make_multilevel(
    helm: Helm2, src_tree: PointTree, tgt_tree: PointTree, start_depth: int = 2
) -> LinOp:
    """HODLR-style multilevel butterfly factorization of the full kernel
    matrix (reference: bfFacHelm2MakeMultilevel, src/fac_helm2.c:943-1002):
    partition both trees at `start_depth` (level 2 is the first with
    well-separated boxes), then per block: dense if small, a single butterfly
    if separated, else recurse."""
    src_nodes = src_tree.nodes_at_depth(start_depth)
    tgt_nodes = tgt_tree.nodes_at_depth(start_depth)
    check(len(src_nodes) > 0 and len(tgt_nodes) > 0,
          "trees too shallow for multilevel factorization")
    grid = [
        [
            _multilevel_block(helm, src_tree, tgt_tree, src_node, tgt_node)
            for src_node in src_nodes
        ]
        for tgt_node in tgt_nodes
    ]
    return BlockDense(grid)
