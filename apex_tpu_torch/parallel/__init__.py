"""apex_tpu_torch.parallel: data parallelism over ``torch.distributed``.

Port of ``apex_tpu/parallel``: meshes over process groups (``mesh``, with
``use_mesh`` binding axis names), the gradient sync and DDP
(``distributed``), bucketed and compressed all-reduce (``comm``),
the hierarchical compressed sync on a factored mesh (``hierarchy``: its
planner ``plan_comm`` over ``lint.mesh_model``), ring and Ulysses
sequence-parallel attention (``ring``), SyncBatchNorm
(``sync_batchnorm``), LARC, the collective-scope registry and
multi-process bring-up (``launch``). Every collective is counted and named
in ``collectives``. ZeRO's sharded optimizers are
``apex_tpu_torch.optim.DistributedFusedAdam`` / ``DistributedFusedLAMB``.
"""

from apex_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, DATA_INTER_AXIS, DATA_INTRA_AXIS, EXPERT_AXIS, MODEL_AXIS,
    PIPE_AXIS, SEQ_AXIS, axes_of, axes_size, axis_index, axis_size,
    data_parallel_mesh, hierarchical_data_mesh, linear_index, local_batch,
    make_mesh, resolve_group, use_mesh,
)
from apex_tpu_torch.parallel.collectives import (  # noqa: F401
    counts as collective_counts, reset_counts as reset_collective_counts,
)
from apex_tpu_torch.parallel.comm import (  # noqa: F401
    bucket_plan, bucket_table, bucketed_all_reduce, init_residual,
    wire_bytes,
)
from apex_tpu_torch.parallel import hierarchy  # noqa: F401
from apex_tpu_torch.parallel.hierarchy import (  # noqa: F401
    CommPlan, Hop, hierarchical_pmean, hierarchical_sync, plan_comm,
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
from apex_tpu_torch.parallel.ring import (  # noqa: F401
    ring_attention, ulysses_attention,
)
from apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    SyncBatchNorm, convert_sync_batchnorm, sync_batch_norm, sync_moments,
    syncbn_stats_groups,
)
