from apex_tpu_torch.optim.fused import (  # noqa: F401
    FusedLAMB, FusedOptState, FusedSGD,
)
