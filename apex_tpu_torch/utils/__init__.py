from apex_tpu_torch.utils.tree import (  # noqa: F401
    global_norm, tree_all_finite, tree_cast, tree_leaves, tree_map,
    tree_select,
)
