from apex_tpu_torch.optim.distributed import (  # noqa: F401
    DistributedFusedAdam, DistributedFusedLAMB, ShardedOptState,
)
from apex_tpu_torch.optim.fused import (  # noqa: F401
    FusedAdagrad, FusedAdam, FusedLAMB, FusedNovoGrad, FusedOptState,
    FusedSGD,
)
