"""Weight reparameterization (``apex.reparameterization``): the port of
``apex_tpu/reparam``."""

from apex_tpu_torch.reparam.weight_norm import (  # noqa: F401
    WeightNorm, apply_weight_norm, remove_weight_norm,
)

__all__ = ["WeightNorm", "apply_weight_norm", "remove_weight_norm"]
