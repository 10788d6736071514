from butterfly_tpu_torch.trees.interval_tree import IntervalTree, IntervalTreeNode
from butterfly_tpu_torch.trees.point_tree import (
    Octree,
    PointTree,
    PointTreeNode,
    Quadtree,
    nearest_neighbors,
)
from butterfly_tpu_torch.trees.tree import (
    Tree,
    TreeNode,
    level_is_internal,
    level_num_points,
    node_span_is_contiguous,
    uniform_tree,
)

__all__ = [
    "IntervalTree",
    "IntervalTreeNode",
    "Octree",
    "PointTree",
    "PointTreeNode",
    "Quadtree",
    "nearest_neighbors",
    "Tree",
    "TreeNode",
    "level_is_internal",
    "level_num_points",
    "node_span_is_contiguous",
    "uniform_tree",
]
