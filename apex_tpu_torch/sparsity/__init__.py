"""apex_tpu_torch.sparsity — 2:4 structured sparsity (ASP), the port of
``apex_tpu.sparsity``."""

from apex_tpu_torch.sparsity.masklib import (
    create_mask, m4n2_1d, m4n2_2d_greedy, m4n2_2d_best, density,
)
from apex_tpu_torch.sparsity.asp import (
    ASP, ASPState, compute_sparse_masks, prune, default_whitelist,
)

__all__ = [
    "create_mask", "m4n2_1d", "m4n2_2d_greedy", "m4n2_2d_best", "density",
    "ASP", "ASPState", "compute_sparse_masks", "prune",
    "default_whitelist",
]
