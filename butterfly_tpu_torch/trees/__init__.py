from butterfly_tpu_torch.trees.tree import (
    Tree,
    TreeNode,
    level_is_internal,
    level_num_points,
    node_span_is_contiguous,
    uniform_tree,
)

__all__ = [
    "Tree",
    "TreeNode",
    "level_is_internal",
    "level_num_points",
    "node_span_is_contiguous",
    "uniform_tree",
]
