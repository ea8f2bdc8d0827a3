from kdtree_tpu_torch.models.tree import KDTree, TreeSpec, node_levels, tree_spec

__all__ = ["KDTree", "TreeSpec", "node_levels", "tree_spec"]
