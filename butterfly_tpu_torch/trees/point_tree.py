"""Spatial 2^d-ary point trees: quadtree (d=2) and octree (d=3).

Port counterpart of `butterfly_tpu/trees/point_tree.py`, copied so that the
port imports nothing of the JAX package. As there, `PointTree` builds
through the native C++ treekit (`csrc/treekit.cpp` via `trees/native.py`,
`_try_native`) unless called with `use_native=False`, which takes the NumPy
builder (`_build`), the oracle. Both give the same tree: the same `perm`,
node ranges, octants and boxes (`tests/test_torch_native.py`). Unlike the
JAX package, which quietly takes NumPy when its kit is missing, a treekit
that does not build or load raises.

TPU-native redesign of the reference quadtree/octree
(src/quadtree.c, src/quadtree_node.c:123-199, src/octree.c,
src/octree_node.c): one generic dimension-parametric builder using vectorized
NumPy partitioning of the permutation (the reference does an in-place 4-way
pointer sift per node). Built once host-side; consumed through flat tables.
"""

from __future__ import annotations

import numpy as np

from butterfly_tpu_torch.geom.bbox import Bbox
from butterfly_tpu_torch.geom.circle import Circle
from butterfly_tpu_torch.trees.tree import Tree, TreeNode
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check


class PointTreeNode(TreeNode):
    """Spatial node: adds the node's box (reference: BfQuadtreeNode.bbox/split,
    include/bf/quadtree_node.h:22-39)."""

    __slots__ = ("bbox",)

    def __init__(self, parent, depth, i0, i1, bbox: Bbox):
        super().__init__(parent, depth, i0, i1)
        self.bbox = bbox

    @property
    def split(self) -> np.ndarray:
        return self.bbox.center

    def bounding_circle(self) -> Circle:
        """Circumscribed circle of the node box (reference:
        bfQuadtreeNodeGetBoundingCircle, src/quadtree_node.c:321-330)."""
        c, r = self.bbox.bounding_circle()
        return Circle((float(c[0]), float(c[1])), r)

    def is_separated_from(self, other: "PointTreeNode") -> bool:
        """Bounding-sphere separation test (reference:
        bfQuadtreeNodesAreSeparated, src/quadtree_node.c:393-401)."""
        c1, r1 = self.bbox.bounding_circle()
        c2, r2 = other.bbox.bounding_circle()
        R = float(np.linalg.norm(np.asarray(c1) - np.asarray(c2)))
        return R > r1 + r2 + 10 * np.finfo(np.float64).eps


class PointTree(Tree):
    """2^d-ary spatial tree over points of shape (n, d).

    Children are indexed by octant bits (bit k set = upper half along axis k)
    and ordered by that index; empty octants get no node, matching the
    reference's skipped NULL children (src/quadtree_node.c:240-268).
    """

    def __init__(self, points: np.ndarray, leaf_size: int = 1,
                 max_depth: int = 64, normals: np.ndarray | None = None,
                 use_native: bool = True):
        points = np.asarray(points, dtype=np.float64)
        check(points.ndim == 2, "points must be (n, d)", InvalidArgumentsError)
        n, d = points.shape
        check(n > 0, "empty point set", InvalidArgumentsError)
        check(1 <= d <= 3, "PointTree supports d in {1,2,3}", InvalidArgumentsError)
        if normals is not None:
            normals = np.asarray(normals, dtype=np.float64)
            check(normals.shape == points.shape, "normals must match points")

        self.points = points
        self.normals = normals
        self.leaf_size = int(leaf_size)

        if use_native:
            root, perm = self._try_native(points, max_depth)
            super().__init__(root, perm)
            return

        # Root box is the bounding box rescaled to a cube
        # (reference: bfQuadtreeNodeInitRoot, src/quadtree_node.c:283-305).
        bbox = Bbox.of_points(points).rescale_to_cube()
        perm = np.arange(n, dtype=np.int64)
        root = PointTreeNode(None, 0, 0, n, bbox)
        self._build(root, perm, max_depth)
        super().__init__(root, perm)

    def _try_native(self, points, max_depth):
        """Build through the native C++ treekit (`csrc/treekit.cpp` via
        `trees/native.py`); raises if it does not build or load."""
        from butterfly_tpu_torch.trees.native import build_point_tree_native

        perm, tab = build_point_tree_native(points, self.leaf_size, max_depth)
        d = points.shape[1]
        nodes: list[PointTreeNode] = []
        for k in range(len(tab["i0"])):
            bbox = Bbox(tab["lo"][k, :d].copy(), tab["hi"][k, :d].copy())
            parent = nodes[tab["parent"][k]] if tab["parent"][k] >= 0 else None
            node = PointTreeNode(
                parent, int(tab["depth"][k]), int(tab["i0"][k]),
                int(tab["i1"][k]), bbox,
            )
            node.index = int(tab["octant"][k]) if tab["octant"][k] >= 0 else 0
            if parent is not None:
                parent.children.append(node)
            nodes.append(node)
        return nodes[0], perm

    def _build(self, node: PointTreeNode, perm: np.ndarray, max_depth: int) -> None:
        """Recursive octant partition of perm[i0:i1]
        (reference: quadtreeNodeInitRecursive, src/quadtree_node.c:123-199,
        leaf threshold quadtree_node.c:17)."""
        if node.num_points <= self.leaf_size or node.depth >= max_depth:
            return
        idx = perm[node.i0 : node.i1]
        pts = self.points[idx]
        if np.all(pts == pts[0]):
            return  # identical points can never be split; stop recursing
        center = node.bbox.center
        d = pts.shape[1]
        # Octant code per point: bit k set iff coordinate k is in the upper
        # half-open side (reference uses `> split`; ties go to the lower box).
        codes = np.zeros(len(idx), dtype=np.int64)
        for k in range(d):
            codes |= (pts[:, k] > center[k]).astype(np.int64) << k
        order = np.argsort(codes, kind="stable")
        perm[node.i0 : node.i1] = idx[order]
        counts = np.bincount(codes, minlength=1 << d)
        offsets = np.concatenate([[0], np.cumsum(counts)]) + node.i0
        for q in range(1 << d):
            if counts[q] == 0:
                continue
            child = PointTreeNode(
                node, node.depth + 1, offsets[q], offsets[q + 1],
                node.bbox.child_box(q),
            )
            child.index = q
            node.children.append(child)
            self._build(child, perm, max_depth)

    # -- point access ----------------------------------------------------

    def node_points(self, node: TreeNode) -> np.ndarray:
        """Points of `node` in tree order (reference: bfQuadtreeNodeGetPoints,
        src/quadtree_node.c:332-362)."""
        return self.points[self.perm[node.i0 : node.i1]]

    def node_normals(self, node: TreeNode) -> np.ndarray | None:
        """(reference: bfQuadtreeNodeGetUnitNormals, src/quadtree_node.c:364-391)"""
        if self.normals is None:
            return None
        return self.normals[self.perm[node.i0 : node.i1]]


def Quadtree(points, leaf_size: int = 1, normals=None) -> PointTree:
    """2-D quadtree (reference: src/quadtree.c)."""
    points = np.asarray(points, dtype=np.float64)
    check(points.shape[1] == 2, "Quadtree needs (n, 2) points", InvalidArgumentsError)
    return PointTree(points, leaf_size=leaf_size, normals=normals)


def Octree(points, leaf_size: int = 32, normals=None) -> PointTree:
    """3-D octree (reference: src/octree.c; maxLeafSize include/bf/octree.h:39)."""
    points = np.asarray(points, dtype=np.float64)
    check(points.shape[1] == 3, "Octree needs (n, 3) points", InvalidArgumentsError)
    return PointTree(points, leaf_size=leaf_size, normals=normals)


def nearest_neighbors(tree: PointTree, query: np.ndarray, k: int) -> np.ndarray:
    """k nearest original-point indices for each query point
    (reference: octree.get_nearest_neighbors.c). Exact, via best-first box
    descent with a pruning radius."""
    query = np.atleast_2d(np.asarray(query, dtype=np.float64))
    out = np.empty((len(query), k), dtype=np.int64)
    pts = tree.points
    for qi, q in enumerate(query):
        # Best-first search over nodes keyed by box distance.
        import heapq

        heap: list[tuple[float, int, TreeNode]] = []
        counter = 0
        best: list[tuple[float, int]] = []  # max-heap via negated dist

        def box_dist(node: PointTreeNode) -> float:
            lo, hi = node.bbox.lo, node.bbox.hi
            d = np.maximum(np.maximum(lo - q, 0.0), q - hi)
            return float(np.linalg.norm(d))

        heapq.heappush(heap, (box_dist(tree.root), counter, tree.root))
        while heap:
            dist, _, node = heapq.heappop(heap)
            if len(best) == k and dist > -best[0][0]:
                break
            if node.is_leaf:
                idx = tree.perm[node.i0 : node.i1]
                for j in idx:
                    dj = float(np.linalg.norm(pts[j] - q))
                    if len(best) < k:
                        heapq.heappush(best, (-dj, int(j)))
                    elif dj < -best[0][0]:
                        heapq.heapreplace(best, (-dj, int(j)))
            else:
                for child in node.children:
                    counter += 1
                    heapq.heappush(heap, (box_dist(child), counter, child))
        out[qi] = [j for _, j in sorted((-d, j) for d, j in best)]
    return out
