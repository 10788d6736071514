"""1-D interval trees with deferred point attachment.

Replacement for the reference interval tree (src/interval_tree.c,
src/interval_tree_node.c; API include/bf/interval_tree.h:28-31): a complete
k-ary tree built EMPTY over [a, b] to a fixed depth, with points attached
later WITHOUT rebuilding — this is the frequency/column tree used by the
streaming LBO factorization (src/lbo.c:41-68,127).

Port counterpart of `butterfly_tpu/trees/interval_tree.py`, copied.
"""

from __future__ import annotations

import numpy as np

from butterfly_tpu_torch.trees.tree import Tree, TreeNode
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check


__all__ = ["IntervalTree", "IntervalTreeNode"]


class IntervalTreeNode(TreeNode):
    """Node covering [a, b) — or [a, b] if rightmost — at its level
    (reference: BfIntervalTreeNode, include/bf/interval_tree_node.h:23-37)."""

    __slots__ = ("a", "b", "is_leftmost", "is_rightmost")

    def __init__(self, parent, depth, a, b, is_leftmost, is_rightmost):
        super().__init__(parent, depth, 0, 0)
        self.a = float(a)
        self.b = float(b)
        self.is_leftmost = bool(is_leftmost)
        self.is_rightmost = bool(is_rightmost)


class IntervalTree(Tree):
    """Complete k-ary interval tree over [a, b], built empty
    (reference: bfIntervalTreeInitEmpty)."""

    def __init__(self, a: float, b: float, arity: int = 2, depth: int = 4):
        check(b > a, "need b > a", InvalidArgumentsError)
        check(arity >= 2 and depth >= 0, "bad arity/depth", InvalidArgumentsError)
        self.a, self.b = float(a), float(b)
        self.arity = arity
        self.points: np.ndarray | None = None

        root = IntervalTreeNode(None, 0, a, b, True, True)
        frontier = [root]
        for _ in range(depth):
            nxt = []
            for node in frontier:
                edges = np.linspace(node.a, node.b, arity + 1)
                for q in range(arity):
                    child = IntervalTreeNode(
                        node,
                        node.depth + 1,
                        edges[q],
                        edges[q + 1],
                        node.is_leftmost and q == 0,
                        node.is_rightmost and q == arity - 1,
                    )
                    child.index = q
                    node.children.append(child)
                    nxt.append(child)
            frontier = nxt
        super().__init__(root, np.empty(0, dtype=np.int64))

    def set_points(self, points: np.ndarray) -> None:
        """Attach a (will-be-sorted) 1-D point set: recompute every node's
        [i0, i1) index range by bisection, leaving the tree topology untouched
        (reference: bfIntervalTreeSetPoints with rebuildTree=false,
        include/bf/interval_tree.h:31, used src/lbo.c:127)."""
        points = np.asarray(points, dtype=np.float64).ravel()
        order = np.argsort(points, kind="stable")
        self.points = points[order]
        self.perm = order.astype(np.int64)
        for node in self.root.subtree_nodes():
            node.i0 = int(np.searchsorted(self.points, node.a, side="left"))
            if node.is_rightmost:
                node.i1 = int(np.searchsorted(self.points, node.b, side="right"))
            else:
                node.i1 = int(np.searchsorted(self.points, node.b, side="left"))
        self.root.i0, self.root.i1 = 0, len(self.points)
