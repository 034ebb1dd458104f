"""apex_tpu_torch.trace — distributed tracing + flight recorder.

The port of ``apex_tpu.trace``: the forensic layer over
:mod:`apex_tpu_torch.monitor` (which tells you *that* training is
unhealthy) — span-level step timelines, crash dumps, hang detection and
NaN provenance, so a wedged multi-rank run is diagnosable from
artifacts:

- **spans** (:mod:`~apex_tpu_torch.trace.spans`): ``trace.span("fwd")``
  context manager/decorator opening a ``torch.profiler.record_function``
  range over a host wall-clock timeline per step (:class:`Tracer`),
  exported as Chrome-trace JSON (Perfetto-loadable) and a
  :class:`StepTimeline` table. Spans measure eager host time: device time
  shows only where the host waits inside a span;
- **flight recorder** (:mod:`~apex_tpu_torch.trace.recorder`): bounded
  ring of the last N step records with chained ``sys.excepthook`` /
  ``SIGTERM`` / ``atexit`` handlers that dump a JSONL crash report;
- **hang watchdog** (:mod:`~apex_tpu_torch.trace.watchdog`): a daemon
  thread that fires when no step completes within a deadline, dumping
  all Python thread stacks plus the flight record and tagging the
  silent rank;
- **NaN provenance** (:mod:`~apex_tpu_torch.trace.debug_nans`): opt-in
  per-span finiteness probes folded on the device, read back once by
  :func:`first_nan`; the off path returns its argument untouched;
- **straggler detection** (:mod:`~apex_tpu_torch.trace.straggler`):
  per-rank shared-fs step heartbeats + a lockstep reader flagging
  persistent laggards with the slowest span class on the lagging rank —
  the early-warning tier below the watchdog
  (:meth:`HangWatchdog.early_warning`);
- **pod observatory** (:mod:`~apex_tpu_torch.trace.podview`): merges N
  ranks' span streams onto one clock, splits every collective into
  wait-for-laggard vs wire time with (rank, span) blame, extracts the
  per-step critical path and exports a merged Perfetto trace +
  ``podview``-channel events.

``parallel.enable_crash_dumps`` wires a tracer, a recorder, a watchdog
and a collective deadline in one call.
"""

from apex_tpu_torch.trace.debug_nans import (debug_nans, debug_nans_enabled,
                                             first_nan, nan_probe,
                                             reset_nan_state)
from apex_tpu_torch.trace.podview import (ClockAlignment, CollectiveSkew,
                                          PodSpan, PodTimeline, RankClock,
                                          RankTimeline, align_clocks,
                                          load_span_events)
from apex_tpu_torch.trace.recorder import FlightRecorder, StepRecord, rank_path
from apex_tpu_torch.trace.spans import (SpanEvent, StepTimeline, StepTrace,
                                        Tracer, current_tracer, span, step)
from apex_tpu_torch.trace.straggler import (HB_PREFIX, HeartbeatWriter,
                                            StragglerDetector,
                                            StragglerReport, StragglerWatch,
                                            gc_stale_heartbeats,
                                            heartbeat_path, read_heartbeats)
from apex_tpu_torch.trace.watchdog import HangWatchdog

__all__ = [
    "span", "step", "Tracer", "SpanEvent", "StepTrace", "StepTimeline",
    "current_tracer",
    "FlightRecorder", "StepRecord", "rank_path",
    "HangWatchdog",
    "HeartbeatWriter", "StragglerDetector", "StragglerReport",
    "StragglerWatch", "read_heartbeats",
    "PodSpan", "PodTimeline", "RankTimeline", "RankClock",
    "ClockAlignment", "CollectiveSkew", "align_clocks",
    "load_span_events",
    "debug_nans", "debug_nans_enabled", "nan_probe", "first_nan",
    "reset_nan_state",
    "HB_PREFIX", "heartbeat_path", "gc_stale_heartbeats",
]
