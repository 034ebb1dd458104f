"""apex_tpu_torch.parallel: data parallelism over ``torch.distributed``.

Port of ``apex_tpu/parallel``: meshes over process groups (``mesh``, with
``use_mesh`` binding axis names), the gradient sync and DDP
(``distributed``), bucketed and compressed all-reduce (``comm``),
SyncBatchNorm (``sync_batchnorm``), LARC, the collective-scope registry
and multi-process bring-up (``launch``). Every collective is counted and
named in ``collectives``. ZeRO (``optim/distributed.py``), the
hierarchical sync and ring attention are later work (ROADMAP.md queue A).
"""

from apex_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, DATA_INTER_AXIS, DATA_INTRA_AXIS, EXPERT_AXIS, MODEL_AXIS,
    PIPE_AXIS, SEQ_AXIS, axis_index, axis_size, data_parallel_mesh,
    hierarchical_data_mesh, local_batch, make_mesh, resolve_group, use_mesh,
)
from apex_tpu_torch.parallel.collectives import (  # noqa: F401
    counts as collective_counts, reset_counts as reset_collective_counts,
)
from apex_tpu_torch.parallel.comm import (  # noqa: F401
    bucket_plan, bucket_table, bucketed_all_reduce, init_residual,
    wire_bytes,
)
from apex_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedDataParallel, Reducer, flat_all_reduce, flat_tree_all_reduce,
    replica_broadcast, replicate, sync_gradients,
)
from apex_tpu_torch.parallel.larc import LARC, larc_rewrite_grads  # noqa
from apex_tpu_torch.parallel.launch import (  # noqa: F401
    distributed_init, elastic_run, enable_crash_dumps, is_distributed,
    maybe_print, process_count, process_index, shrink_schedule,
)
from apex_tpu_torch.parallel.registry import (  # noqa: F401
    COLLECTIVE_SCOPES, CollectiveScope, known_patterns, scope_axis,
    scope_entry,
)
from apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    SyncBatchNorm, convert_sync_batchnorm, sync_batch_norm, sync_moments,
    syncbn_stats_groups,
)
