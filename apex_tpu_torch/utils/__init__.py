from apex_tpu_torch.utils.backoff import backoff_sleep  # noqa: F401
from apex_tpu_torch.utils.bits import uint_view_dtype  # noqa: F401
from apex_tpu_torch.utils.fsio import fsync_dir, write_atomic  # noqa: F401
from apex_tpu_torch.utils.ranks import rank_default, world_default  # noqa: F401
from apex_tpu_torch.utils.tree import (  # noqa: F401
    global_norm, tree_all_finite, tree_cast, tree_leaves, tree_map,
    tree_select,
)
