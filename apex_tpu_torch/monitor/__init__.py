"""apex_tpu_torch.monitor — runtime training-health telemetry.

The port of ``apex_tpu.monitor``'s first part (ROADMAP.md queue A, item
11 part 1):

- **device** (:mod:`~apex_tpu_torch.monitor.metrics`): a :class:`Metrics`
  tuple of 0-d device counters/gauges (loss scale, overflow/skip/growth/
  backoff counts, grad & param norms) carried on the train state with no
  host sync — ``amp.Amp(..., monitor=True)`` and
  ``FP16_Optimizer(..., monitor=True)`` maintain it;
- **host** (:mod:`~apex_tpu_torch.monitor.logger` /
  :mod:`~apex_tpu_torch.monitor.sinks`): :class:`MetricsLogger` with
  pluggable sinks (stdout table / JSONL / CSV), a rolling step-time and
  throughput estimator, one device-to-host copy a flush, and the event
  channels every subsystem streams into;
- :mod:`~apex_tpu_torch.monitor.goodput` — :class:`GoodputLedger`
  decomposes each step's wall clock into compute / exposed-comm /
  input-wait / host-callback / ckpt-stall / recompile / guard-rewind
  buckets off the :class:`apex_tpu_torch.trace.Tracer` timeline, with a
  closure check and a per-mesh-axis split of the comm buckets through
  :func:`~apex_tpu_torch.monitor.collectives.scope_axis_row`.

Waiting for part 2: numerics, dynamics, convergence, linkbench,
comm_drift, check and the byte half of ``collectives``; for part 3: what
reads ``prof/`` (``MetricsLogger.attach``, MFU, memory samples).
"""

from apex_tpu_torch.monitor.collectives import scope_axis_row, scope_hop
from apex_tpu_torch.monitor.goodput import (BUCKETS, GoodputLedger,
                                            StepLedger, classify_span)
from apex_tpu_torch.monitor.logger import CHANNELS, ChannelSpec, MetricsLogger
from apex_tpu_torch.monitor.metrics import (METRIC_FIELDS, Metrics,
                                            metrics_init, metrics_snapshot,
                                            metrics_to_dict)
from apex_tpu_torch.monitor.sinks import CSVSink, JSONLSink, Sink, StdoutSink

__all__ = [
    "Metrics", "metrics_init", "metrics_to_dict", "metrics_snapshot",
    "METRIC_FIELDS",
    "MetricsLogger", "CHANNELS", "ChannelSpec",
    "Sink", "StdoutSink", "JSONLSink", "CSVSink",
    "scope_hop", "scope_axis_row",
    "GoodputLedger", "StepLedger", "BUCKETS", "classify_span",
]
