from apex_tpu_torch.optim.fused import (  # noqa: F401
    FusedAdagrad, FusedAdam, FusedLAMB, FusedNovoGrad, FusedOptState,
    FusedSGD,
)
