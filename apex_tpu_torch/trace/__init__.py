"""apex_tpu_torch.trace — the heartbeat file helpers of ``apex_tpu.trace``.

Only :mod:`~apex_tpu_torch.trace.straggler`'s file helpers are ported
(what ``cluster.ClusterMembership.gc_stale`` needs); the tracer, flight
recorder, hang watchdog and straggler detector are ROADMAP.md queue A,
item 11.
"""

from apex_tpu_torch.trace.straggler import (HB_PREFIX, gc_stale_heartbeats,
                                            heartbeat_path, read_heartbeats)

__all__ = ["HB_PREFIX", "heartbeat_path", "read_heartbeats",
           "gc_stale_heartbeats"]
