"""Generic host-side trees over permuted point sets.

TPU-native redesign of the reference tree stack (src/tree.c, src/tree_node.c,
src/tree_level_iter.c, src/tree_iter_post_order.c; structs
include/bf/tree.h:30-39, include/bf/tree_node.h:23-56):

- Trees are built ONCE on the host (NumPy) at setup time and then exported as
  flat per-level index tables (`level_table`) for fully vectorized device
  kernels — the device never chases pointers.
- A node stores its ABSOLUTE index range [i0, i1) into the tree-ordered point
  set (the reference stores relative per-child offsets + parent chains,
  tree_node.h:23-56; absolute ranges make the flat export trivial).
- `Tree.perm[k]` is the original index of the k-th point in tree order
  (reference: tree->perm used via bfTreeNodeGetIndexPtrConst).
"""

from __future__ import annotations

from typing import Callable, Iterator, Sequence

import numpy as np

from butterfly_tpu_torch.utils.errors import check


class TreeNode:
    """k-ary tree node with an absolute index range into tree order."""

    __slots__ = ("parent", "children", "depth", "i0", "i1", "index")

    def __init__(self, parent: "TreeNode | None", depth: int, i0: int, i1: int):
        self.parent = parent
        self.children: list[TreeNode] = []
        self.depth = depth
        self.i0 = int(i0)
        self.i1 = int(i1)
        self.index = 0  # sibling index, set by the builder

    # -- reference parity helpers ---------------------------------------

    @property
    def num_points(self) -> int:
        """(reference: bfTreeNodeGetNumPoints)"""
        return self.i1 - self.i0

    @property
    def is_leaf(self) -> bool:
        """(reference: bfTreeNodeIsLeaf)"""
        return len(self.children) == 0

    @property
    def first_index(self) -> int:
        """(reference: bfTreeNodeGetFirstIndex)"""
        return self.i0

    @property
    def last_index(self) -> int:
        """(reference: bfTreeNodeGetLastIndex)"""
        return self.i1

    def subtree_nodes(self) -> Iterator["TreeNode"]:
        """Pre-order traversal of the subtree rooted here."""
        stack = [self]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(reversed(node.children))

    def post_order(self) -> Iterator["TreeNode"]:
        """Post-order traversal (children before parents) of this subtree
        (reference: BfTreeIterPostOrder, src/tree_iter_post_order.c) — the
        order the streaming factorizer merges column nodes in."""
        for child in self.children:
            yield from child.post_order()
        yield self

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(depth={self.depth}, i0={self.i0}, "
            f"i1={self.i1}, nchild={len(self.children)})"
        )


class Tree:
    """A tree over a permuted point set.

    perm[k] = original index of the k-th point in tree order; a node's points
    are `points[perm[node.i0:node.i1]]`.
    """

    def __init__(self, root: TreeNode, perm: np.ndarray):
        self.root = root
        self.perm = np.asarray(perm, dtype=np.int64)

    @property
    def num_points(self) -> int:
        return self.root.num_points

    def reverse_perm(self) -> np.ndarray:
        """Inverse permutation: tree position of each original index
        (reference: bfPermGetReversePerm)."""
        rev = np.empty_like(self.perm)
        rev[self.perm] = np.arange(self.perm.size)
        return rev

    # -- traversal -------------------------------------------------------

    def levels(self, from_node: TreeNode | None = None) -> list[list[TreeNode]]:
        """Nodes grouped by depth in LR level order, starting at `from_node`
        (reference: BfTreeLevelIter with BF_TREE_TRAVERSAL_LR_LEVEL_ORDER,
        include/bf/tree_level_iter.h:7-22). Reverse the list for the
        reverse-level-order traversal driving butterfly source levels."""
        node = from_node if from_node is not None else self.root
        out: list[list[TreeNode]] = []
        frontier = [node]
        while frontier:
            out.append(frontier)
            frontier = [c for n in frontier for c in n.children]
        return out

    def nodes_at_depth(self, depth: int) -> list[TreeNode]:
        """(reference: bfTreeGetLevelPtrArray)"""
        levels = self.levels()
        return levels[depth] if depth < len(levels) else []

    def get_node(self, depth: int, index: int) -> TreeNode:
        """(reference: bfTreeGetNode)"""
        return self.nodes_at_depth(depth)[index]

    @property
    def max_depth(self) -> int:
        return len(self.levels()) - 1

    def post_order(self) -> Iterator[TreeNode]:
        return self.root.post_order()

    def map(self, fn: Callable[[TreeNode], None], order: str = "pre") -> None:
        """Apply `fn` over all nodes (reference: bfTreeMap)."""
        it = self.post_order() if order == "post" else self.root.subtree_nodes()
        for node in it:
            fn(node)

    # -- flat device export ----------------------------------------------

    def level_table(self, depth: int) -> dict[str, np.ndarray]:
        """Flat per-level arrays for device kernels: i0/i1 ranges plus the
        parent's position in the previous level's table."""
        nodes = self.nodes_at_depth(depth)
        parents = self.nodes_at_depth(depth - 1) if depth > 0 else []
        parent_pos = {id(n): i for i, n in enumerate(parents)}
        return {
            "i0": np.array([n.i0 for n in nodes], dtype=np.int32),
            "i1": np.array([n.i1 for n in nodes], dtype=np.int32),
            "parent": np.array(
                [parent_pos.get(id(n.parent), -1) for n in nodes], dtype=np.int32
            ),
        }


def level_is_internal(nodes: Sequence[TreeNode]) -> bool:
    """True if no node on this level is a leaf
    (reference: bfTreeLevelIterCurrentLevelIsInternal)."""
    return all(not n.is_leaf for n in nodes)


def level_num_points(nodes: Sequence[TreeNode]) -> int:
    """(reference: bfTreeLevelIterGetNumPoints)"""
    return sum(n.num_points for n in nodes)


def node_span_is_contiguous(nodes: Sequence[TreeNode]) -> bool:
    """(reference: node span contiguity checks, src/node_span.c)"""
    for a, b in zip(nodes[:-1], nodes[1:]):
        if a.i1 != b.i0:
            return False
    return True


def uniform_tree(n: int, arity: int, depth: int) -> Tree:
    """A complete `arity`-ary tree of the given depth over n points split as
    evenly as possible, identity permutation. Used for algebraic
    factorizations where no geometry drives the splits (reference analogue:
    bfTreeNewForMiddleFac, src/tree.c:92-108)."""
    check(n > 0 and depth >= 0 and arity >= 2, "bad uniform_tree args")
    root = TreeNode(None, 0, 0, n)
    frontier = [root]
    for _ in range(depth):
        next_frontier = []
        for node in frontier:
            edges = np.linspace(node.i0, node.i1, arity + 1).astype(np.int64)
            for q in range(arity):
                if edges[q + 1] > edges[q]:
                    child = TreeNode(node, node.depth + 1, edges[q], edges[q + 1])
                    child.index = q
                    node.children.append(child)
                    next_frontier.append(child)
        frontier = next_frontier
    return Tree(root, np.arange(n, dtype=np.int64))
