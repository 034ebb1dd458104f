from apex_tpu_torch.optim.fused import (  # noqa: F401
    FusedAdam, FusedLAMB, FusedOptState, FusedSGD,
)
