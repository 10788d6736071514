"""Fiedler tree: recursive spectral bisection of a triangle mesh.

Replacement for the reference's fiedler_tree (src/fiedler_tree.c,
src/fiedler_tree_node.c:161-256): each node's vertex set is split by the
sign of the Fiedler vector (first nonconstant LBO eigenfunction) of its
submesh. This yields the geometry-adapted row tree used for streaming LBO
compression (reference: examples/lbo/bf_lbo.c:234-240).

Like the reference, sign splits get nodal-domain BFS topology repair
(fiedler_tree_node.c:161-256): if a sign class is disconnected on the
vertex-adjacency graph, every component except the largest is flood-filled
into the other side, so both children stay connected. Degenerate splits
fall back to a balanced median split of the Fiedler values (or of the
longest coordinate axis if the eigensolve fails) — same tree contract.
The exact zero-level-set submesh with edge splitting is available as
`Trimesh.level_set_submesh` (reference:
src/trimesh.get_level_set_submesh.c).

Port counterpart of `butterfly_tpu/trees/fiedler_tree.py`, copied. The
coordinate fallback catches only what the eigensolve raises on a tiny or
degenerate part (ARPACK's and SuperLU's RuntimeErrors, ValueError for too
few vertices), not every exception.
"""

from __future__ import annotations

import numpy as np

from butterfly_tpu_torch.geom.trimesh import Trimesh
from butterfly_tpu_torch.trees.tree import Tree, TreeNode
from butterfly_tpu_torch.utils.errors import check
from butterfly_tpu_torch.utils.logging import log_debug


__all__ = ["FiedlerTree"]


class FiedlerTree(Tree):
    """Binary spectral-bisection tree over mesh vertices."""

    def __init__(self, mesh: Trimesh, leaf_size: int = 64, max_depth: int = 32):
        check(leaf_size >= 2, "leaf_size must be >= 2")
        self.mesh = mesh
        self.leaf_size = leaf_size
        perm = np.arange(mesh.num_verts, dtype=np.int64)
        root = TreeNode(None, 0, 0, mesh.num_verts)
        self._build(root, perm, mesh, np.arange(mesh.num_verts), max_depth)
        super().__init__(root, perm)

    def _split_values(self, mesh: Trimesh) -> np.ndarray:
        """Fiedler values per vertex, with coordinate fallback."""
        try:
            phi = mesh.fiedler_vector()
            if np.ptp(phi) > 0:
                return phi
        except (RuntimeError, ValueError) as exc:  # tiny/degenerate parts
            log_debug("fiedler eigensolve fell back to coords: %s", exc)
        extent = mesh.verts.max(axis=0) - mesh.verts.min(axis=0)
        return mesh.verts[:, int(np.argmax(extent))]

    def _build(self, node: TreeNode, perm, mesh: Trimesh, vert_ids, max_depth):
        """vert_ids: original vertex ids of perm[node.i0:node.i1] in order."""
        if node.num_points <= self.leaf_size or node.depth >= max_depth:
            return
        phi = self._split_values(mesh)
        neg = phi < np.median(phi)
        # guard: median split must be proper
        if neg.all() or not neg.any():
            neg = np.zeros(len(phi), dtype=bool)
            neg[: len(phi) // 2] = True
        else:
            neg = _repair_nodal_domains(mesh, neg)
        order = np.argsort(~neg, kind="stable")  # negatives first
        perm[node.i0 : node.i1] = vert_ids[order]
        n_neg = int(neg.sum())
        for q, (lo, hi, mask) in enumerate(
            [
                (node.i0, node.i0 + n_neg, neg),
                (node.i0 + n_neg, node.i1, ~neg),
            ]
        ):
            if hi <= lo:
                continue
            child = TreeNode(node, node.depth + 1, lo, hi)
            child.index = q
            node.children.append(child)
            sub, old_idx = mesh.submesh(mask)
            child_vert_ids = vert_ids[old_idx]
            # submesh() reorders verts to mask order; perm slice must match
            perm[lo:hi] = child_vert_ids
            self._build(child, perm, sub, child_vert_ids, max_depth)


def _repair_nodal_domains(mesh: Trimesh, neg: np.ndarray) -> np.ndarray:
    """BFS flood-fill repair of a disconnected sign split (reference:
    fiedler tree nodal-domain repair, src/fiedler_tree_node.c:161-256).

    For each sign class, keep its largest connected component on the vertex
    adjacency graph and flip every smaller component to the other side.
    Repeats once from the other side so both children end up connected; if
    flipping would empty a side, the original split is returned unchanged.
    """
    import scipy.sparse.csgraph as csgraph

    A = mesh.vertex_adjacency()
    out = neg.copy()
    for side in (True, False):
        idx = np.flatnonzero(out == side)
        if idx.size == 0:
            return neg
        sub = A[np.ix_(idx, idx)]
        ncomp, labels = csgraph.connected_components(sub, directed=False)
        if ncomp <= 1:
            continue
        counts = np.bincount(labels)
        keep = int(np.argmax(counts))
        flip = idx[labels != keep]
        out[flip] = not side
    if out.all() or not out.any():
        return neg
    return out
