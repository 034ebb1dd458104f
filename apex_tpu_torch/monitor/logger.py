"""The host half of the telemetry subsystem: buffered fetch + sinks.

The port of ``apex_tpu/monitor/logger.py``. ``MetricsLogger`` receives
the on-device :class:`~apex_tpu_torch.monitor.Metrics` tuple of each step
and *buffers the device tensors* — nothing is read back until
``flush()`` (every ``flush_every`` records, or at ``close()``), which
packs every buffered field into one int32 tensor (the f32 gauges as
their bits) and makes ONE device-to-host copy of it, so the transfer
amortizes over N steps and the step loop never waits on telemetry.
``record()`` itself costs a list append and a clock read.

On top of the device counters the logger derives host-side health:

- rolling **step time** (wall clock between ``record()`` calls) and
  **throughput** over a sliding window;
- **MFU**, when the per-step FLOPs are known: ``attach()`` **runs the
  step once** and takes them from :mod:`apex_tpu_torch.prof.cost` (aten
  ops by the formula registry, the hand kernels by the cost registry),
  the peak from :func:`apex_tpu_torch.prof.device_peak_flops` (the CPU
  and unknown cards report ``mfu=None``, never a misleading 0);
- **collective bytes per step** from the same run, read off the port's
  collective ledger (:mod:`apex_tpu_torch.monitor.collectives`, as
  ``DistributedDataParallel.collective_bytes`` reads it).

``sample_memory`` and ``attach_{memory,shard,roofline}_report`` emit the
:mod:`apex_tpu_torch.prof` reports on their channels, and
``attach_lint_report`` an :class:`apex_tpu_torch.lint.Report` on the lint
channel.

Typical wiring::

    logger = monitor.MetricsLogger(
        sinks=[monitor.StdoutSink(), monitor.JSONLSink("metrics.jsonl")],
        flush_every=10)
    logger.attach(train_step, scratch_state, batch)  # runs the step once
    for batch in data:
        state, loss = train_step(state, batch)  # state carries .metrics
        logger.record(state.metrics)
    logger.close()
"""

from __future__ import annotations

import atexit
import collections
import math
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.monitor.metrics import Metrics, metrics_to_dict
from apex_tpu_torch.monitor.sinks import Sink, StdoutSink

__all__ = ["MetricsLogger", "ChannelSpec", "CHANNELS"]


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def _fetch(buf: List[Metrics]) -> List[List]:
    """Every buffered record's fields as host numbers, from one
    device-to-host copy per device: the fields packed into one int32
    tensor (f32 gauges bit-cast), copied, and unpacked."""
    out: List[Optional[List]] = [None] * len(buf)
    by_dev: Dict = {}
    for i, m in enumerate(buf):
        by_dev.setdefault(m.step.device, []).append(i)
    nf = len(Metrics._fields)
    for dev, idx in by_dev.items():
        packed = torch.stack([
            (t if t.dtype == torch.int32 else
             t.to(torch.float32).view(torch.int32)).reshape(())
            for i in idx for t in buf[i]]).cpu()
        for k, i in enumerate(idx):
            row = packed[k * nf:(k + 1) * nf]
            out[i] = [(row[j].view(torch.float32).item()
                       if buf[i][j].dtype != torch.int32
                       else int(row[j])) for j in range(nf)]
    return out


class ChannelSpec(NamedTuple):
    """One declarative row of the event-channel registry: adding a
    channel is adding a row here (ctor kwarg ``{name}_sink=``, the
    ``record_*`` method, close handling and non-finite nulling all
    derive from it) — not another 30-line clone of the previous
    channel's plumbing."""

    name: str                 #: channel name; ctor kwarg = f"{name}_sink"
    kinds: Tuple[str, ...]    #: event kinds on this channel (the
                              #: ``check_metrics_schema.py --kind`` enum)
    method: str               #: the logger's record-method name
    null_nonfinite: bool      #: null Infinity/NaN before emit (the
                              #: strict-JSON contract); channels whose
                              #: emitters never produce non-finite
                              #: numbers skip the walk
    nested_null: bool = False  #: also null one level of nested dicts
                               #: (goodput's buckets_ms)
    why_unbuffered: str = ""  #: one line: why this channel must never
                              #: buffer (every record_* channel is
                              #: unbuffered; the buffered path is the
                              #: Metrics pytree via record()/flush())


#: the event-channel registry. Every channel is UNBUFFERED (events are
#: rare and forensic — a record that only landed at flush time could be
#: lost to the very crash/escalation it documents); the per-channel
#: ``why_unbuffered`` line carries the channel-specific version of that
#: argument. Validate a channel's stream with
#: ``check_metrics_schema.py --kind <name>`` (``trace`` events use
#: ``--kind trace``; the registry rows and the validator's tables are
#: kept in lockstep — scripts/check_metrics_schema.py names each
#: emitter module).
CHANNELS: Tuple[ChannelSpec, ...] = (
    ChannelSpec("trace", ("span", "step", "crash", "watchdog"),
                "record_event", False,
                why_unbuffered="host-side span/step/crash events from "
                "apex_tpu_torch.trace; losing them to a crash would defeat "
                "the point"),
    ChannelSpec("memory", ("memory", "memory_report", "retrace",
                           "compile"), "record_memory", True,
                why_unbuffered="retrace warnings and allocator samples "
                "are rare; an OOM dump must not wait on a flush"),
    ChannelSpec("lint", ("lint_report", "lint_finding"),
                "record_lint", False,
                why_unbuffered="lint runs are rare AOT audits"),
    ChannelSpec("ckpt", ("ckpt_save", "ckpt_restore",
                         "ckpt_escalation"), "record_ckpt", True,
                why_unbuffered="an escalation record buffered to flush "
                "time would be lost to the very crash it documents"),
    ChannelSpec("guard", ("guard_anomaly", "guard_action",
                          "guard_rewind"), "record_guard", True,
                why_unbuffered="a rewind record could be lost to the "
                "escalation it precedes; a NaN-loss anomaly's z is "
                "non-finite by construction"),
    ChannelSpec("goodput", ("goodput", "straggler", "linkfit"),
                "record_goodput", True, nested_null=True,
                why_unbuffered="per-step attribution and straggler "
                "warnings are forensic; a zero-wall warmup step has "
                "no finite goodput fraction (nested buckets nulled)"),
    ChannelSpec("roofline", ("roofline", "regress", "tune"),
                "record_roofline", True,
                why_unbuffered="roofline joins, sentinel verdicts and "
                "autotune sweep/consult records are rare AOT/offline "
                "audits"),
    ChannelSpec("cluster", ("cluster_lease", "cluster_generation",
                            "cluster_fence", "cluster_coord"),
                "record_cluster", True,
                why_unbuffered="a fence refusal usually precedes the "
                "zombie exit it documents"),
    ChannelSpec("integrity", ("integrity_check", "integrity_vote",
                              "integrity_repair"), "record_integrity",
                True,
                why_unbuffered="a divergence vote could be lost to "
                "the rewind/escalation it precedes"),
    ChannelSpec("numerics", ("numerics_check", "scale_update",
                             "precision_verdict"), "record_numerics",
                True,
                why_unbuffered="scale backoffs and precision verdicts "
                "are rare and may immediately precede the overflow "
                "skip they explain"),
    ChannelSpec("podview", ("pod_align", "pod_skew", "pod_drift"),
                "record_podview", True,
                why_unbuffered="pod merges and drift reports are rare "
                "offline/audit joins, and a skew-blame record may "
                "immediately precede the straggler escalation it "
                "explains (an unaligned rank's residual is null)"),
    ChannelSpec("sharding", ("sharding_mesh", "sharding"),
                "record_sharding", True,
                why_unbuffered="per-axis attribution rows are rare AOT "
                "audits (shard_report / mesh_explain pre-flights), and "
                "an unmeasured link's predicted_s is null by contract"),
    ChannelSpec("dynamics", ("dynamics_check", "gns",
                             "convergence_verdict"), "record_dynamics",
                True,
                why_unbuffered="dynamics checks ride the amortized "
                "host-poll cadence already, a convergence flag may "
                "immediately precede the abort it argues for, and an "
                "undefined GNS estimate is null by contract"),
)

def _null_nonfinite(rec: Dict, nested: bool) -> None:
    """Null non-finite numbers in place (Infinity/NaN are not valid
    strict JSON; the schema contract is finite-or-null — the *event*
    behind a non-finite gauge is already counted elsewhere)."""
    for k, v in rec.items():
        if isinstance(v, float) and not math.isfinite(v):
            rec[k] = None
        elif nested and isinstance(v, dict):
            rec[k] = {kk: (None if isinstance(vv, float)
                           and not math.isfinite(vv) else vv)
                      for kk, vv in v.items()}


def _channel_method(spec: ChannelSpec):
    def _record(self, event: Dict) -> None:
        sink = getattr(self, f"{spec.name}_sink")
        if sink is None or self._closed:
            return
        rec = dict(event)
        if spec.null_nonfinite:
            _null_nonfinite(rec, spec.nested_null)
        sink.emit(rec)

    _record.__name__ = spec.method
    _record.__doc__ = (
        f"Emit one {spec.name}-channel event (``kind`` in "
        f"{spec.kinds}) — a plain-dict pass-through, no device "
        f"access, NOTHING buffered: {spec.why_unbuffered}. "
        + ("Non-finite numbers are nulled to keep the strict-JSON "
           "contract. " if spec.null_nonfinite else "")
        + f"Validate the stream with ``check_metrics_schema.py "
        f"--kind {spec.name}``.")
    return _record


class MetricsLogger:
    """See the module docstring. The logger is a context manager and
    registers itself with ``atexit``, so a crashed run never loses its
    buffered tail: ``__exit__`` flushes on exceptions too, and an
    un-``close()``d logger (hard ``sys.exit``, unhandled error above the
    ``with``) is flushed at interpreter exit.

    Beyond the buffered metrics stream, the logger carries one
    **unbuffered event channel per** :data:`CHANNELS` **row** — pass
    ``{name}_sink=`` (``trace_sink=``, ``guard_sink=``, …,
    ``podview_sink=``) and feed events through the matching
    ``record_*`` method; each channel's stream validates under
    ``check_metrics_schema.py --kind {name}``. Events never mix with
    the metrics wire format.
    """

    def __init__(self, sinks: Optional[Sequence[Sink]] = None, *,
                 flush_every: int = 10, window: int = 50,
                 peak_flops: Optional[float] = None,
                 flops_per_step: Optional[float] = None,
                 collective_bytes_per_step: Optional[int] = None,
                 logical_collective_bytes: Optional[int] = None,
                 donation_safe: bool = False,
                 **channel_sinks: Optional[Sink]):
        self.sinks: List[Sink] = (list(sinks) if sinks is not None
                                  else [StdoutSink()])
        self.flush_every = max(int(flush_every), 1)
        self.flops_per_step = flops_per_step
        self.collective_bytes_per_step = collective_bytes_per_step
        if peak_flops is None:
            from apex_tpu_torch.prof.report import device_peak_flops
            peak_flops = device_peak_flops() or None
        self.peak_flops = peak_flops
        self.memory_report = None      # last attached prof.MemoryReport
        self.lint_report = None        # last attached lint.Report
        self.roofline_report = None    # last attached RooflineReport
        self.shard_report = None       # last attached prof.ShardReport
        valid = {f"{c.name}_sink" for c in CHANNELS}
        unknown = set(channel_sinks) - valid
        if unknown:
            raise TypeError(
                f"MetricsLogger got unknown channel sink(s) "
                f"{sorted(unknown)}; known channels: {sorted(valid)}")
        for spec in CHANNELS:
            setattr(self, f"{spec.name}_sink",
                    channel_sinks.get(f"{spec.name}_sink"))
        #: the uncompressed payload one step semantically moves (e.g.
        #: ``4 * n_params`` for an fp32 grad sync) — enables the
        #: per-record ``wire_to_logical`` ratio
        self.logical_collective_bytes = logical_collective_bytes
        #: per-dtype wire breakdown ``{dtype: bytes}`` (the stdout
        #: table's wire column); set by the caller
        self.collective_bytes_by_dtype: Optional[Dict[str, int]] = None
        #: clone each recorded tuple (``metrics_snapshot``) — for a
        #: caller that updates the carried tensors in place; the port's
        #: amp and FP16_Optimizer update out of place
        self.donation_safe = donation_safe
        self._buf: List = []
        self._times: List[float] = []
        self._last_time: Optional[float] = None
        self._window = collections.deque(maxlen=max(int(window), 2))
        self._closed = False
        atexit.register(self._atexit_close)

    # -- per-step statics ----------------------------------------------------

    def attach(self, step_fn, *args, **kwargs) -> "MetricsLogger":
        """Per-step statics from ONE run of ``step_fn(*args, **kwargs)``
        — it **runs the step** (give a throwaway state): model FLOPs
        (:class:`apex_tpu_torch.prof.cost.CostCounter`) and collective
        bytes with their per-dtype split (the collective ledger). Statics
        the caller set in the constructor are kept; nothing runs when
        both are set."""
        if (self.flops_per_step is not None
                and self.collective_bytes_per_step is not None):
            return self
        from apex_tpu_torch.monitor.collectives import (
            collective_bytes, collective_bytes_by_dtype, ledger_counts)
        from apex_tpu_torch.prof.cost import CostCounter
        with CostCounter() as c:
            counts = ledger_counts(step_fn, *args, **kwargs)
        if self.flops_per_step is None:
            self.flops_per_step = c.flops if c.flops > 0 else None
        if self.collective_bytes_by_dtype is None:
            per: Dict[str, int] = {}
            for per_op in collective_bytes_by_dtype(counts=counts).values():
                for dt, nbytes in per_op.items():
                    per[dt] = per.get(dt, 0) + nbytes
            self.collective_bytes_by_dtype = per
        if self.collective_bytes_per_step is None:
            self.collective_bytes_per_step = collective_bytes(
                counts=counts)["total"]
        return self

    # -- per-step path (cheap, never syncs) ----------------------------------

    def record(self, metrics: Metrics, **extra) -> None:
        """Buffer one device snapshot. ``extra`` keys (host scalars only)
        are merged into the emitted record at flush."""
        if self.donation_safe:
            from apex_tpu_torch.monitor.metrics import metrics_snapshot
            metrics = metrics_snapshot(metrics)
        now = time.perf_counter()
        self._buf.append((metrics, dict(extra)) if extra else (metrics, None))
        self._times.append(now)
        self._window.append(now)
        if len(self._buf) >= self.flush_every:
            self.flush()

    # -- amortized fetch + emit ----------------------------------------------

    def _throughput(self) -> Optional[float]:
        if len(self._window) < 2:
            return None
        dt = self._window[-1] - self._window[0]
        if dt <= 0:
            return None
        return (len(self._window) - 1) / dt

    def flush(self) -> None:
        """One device-to-host copy for every buffered snapshot, then
        emit."""
        if not self._buf:
            return
        buf, times = self._buf, self._times
        self._buf, self._times = [], []
        host = _fetch([m for m, _ in buf])
        thru = self._throughput()
        for (_, extra), m, t in zip(buf, host, times):
            rec: Dict = metrics_to_dict(m)
            if self._last_time is None:
                rec["step_time_ms"] = None
            else:
                rec["step_time_ms"] = (t - self._last_time) * 1e3
            self._last_time = t
            rec["throughput_steps_per_s"] = thru
            rec["mfu"] = (self.flops_per_step * thru / self.peak_flops
                          if thru and self.flops_per_step
                          and self.peak_flops else None)
            rec["collective_bytes"] = self.collective_bytes_per_step
            rec["wire_by_dtype"] = self.collective_bytes_by_dtype
            rec["logical_bytes"] = self.logical_collective_bytes
            if (self.logical_collective_bytes
                    and self.collective_bytes_per_step is not None):
                rec["wire_to_logical"] = (self.collective_bytes_per_step
                                          / self.logical_collective_bytes)
            else:
                rec["wire_to_logical"] = None
            rec["wall_time"] = time.time()
            if extra:
                rec.update(extra)
            # non-finite gauges (diverged loss, ...) become null on the
            # wire: Infinity/NaN are not valid strict JSON, and the
            # schema contract is finite-or-null (the *event* is already
            # counted in overflow_count)
            for k, v in rec.items():
                if isinstance(v, float) and not math.isfinite(v):
                    rec[k] = None
            for sink in self.sinks:
                sink.emit(rec)

    # -- event channels ------------------------------------------------------
    # record_event / record_memory / ... / record_dynamics are generated
    # from the CHANNELS registry after the class body. Typical wirings:
    # ``tracer.subscribe(lambda st: logger.record_event(st.to_event(
    # rank)))``, ``CheckpointManager(event_sink=logger.record_ckpt)``,
    # ``GuardPolicy(event_sink=logger.record_guard)``,
    # ``GoodputLedger.subscribe(logger.record_goodput)``,
    # ``ClusterMembership(event_sink=logger.record_cluster)``.

    def sample_memory(self, step: Optional[int] = None, *,
                      device=None, **extra) -> Optional[Dict]:
        """Sample the caching allocator (``torch.cuda.memory_stats``, a
        host-side read: no kernel, no sync) and emit one
        ``kind="memory"`` event; on the CPU the values are null, so the
        stream's shape is the same. Returns the record (None without a
        memory sink)."""
        from apex_tpu_torch.prof.memory import device_memory_sample
        if self.memory_sink is None or self._closed:
            return None
        rec: Dict = {"kind": "memory", "step": step, "rank": _rank(),
                     "wall_time": time.time()}
        rec.update(device_memory_sample(device))
        if extra:
            rec.update(extra)
        self.record_memory(rec)
        return rec

    def attach_memory_report(self, report) -> "MetricsLogger":
        """Attach a :class:`apex_tpu_torch.prof.MemoryReport`: emits one
        ``kind="memory_report"`` event and keeps the report (hand it to
        ``FlightRecorder.attach_memory_report`` too, so a crash dump names
        the biggest buffers)."""
        self.memory_report = report
        if report is not None:
            self.record_memory(report.to_event(rank=_rank()))
        return self

    def attach_shard_report(self, report, step: Optional[int] = None,
                            **to_events_kwargs) -> "MetricsLogger":
        """Attach a :class:`apex_tpu_torch.prof.ShardReport`: emits its
        ``sharding_mesh`` header and one ``kind="sharding"`` row per axis
        on the sharding channel (extra kwargs pass to
        :meth:`~apex_tpu_torch.prof.ShardReport.to_events`)."""
        self.shard_report = report
        if report is not None:
            for ev in report.to_events(rank=_rank(), step=step,
                                       **to_events_kwargs):
                self.record_sharding(ev)
        return self

    def attach_lint_report(self, report,
                           step: Optional[int] = None) -> "MetricsLogger":
        """Attach an :class:`apex_tpu_torch.lint.Report`: emits its
        ``lint_report`` header + one ``lint_finding`` event per finding
        on the lint channel and keeps the report on ``self.lint_report``."""
        self.lint_report = report
        if report is not None:
            for ev in report.to_events(step=step):
                self.record_lint(ev)
        return self

    def attach_roofline_report(self, report, step: Optional[int] = None,
                               top: Optional[int] = None
                               ) -> "MetricsLogger":
        """Attach a :class:`apex_tpu_torch.prof.RooflineReport`: one
        ``kind="roofline"`` event per row (``top`` bounds it)."""
        self.roofline_report = report
        if report is not None:
            for ev in report.to_events(rank=_rank(), step=step, top=top):
                self.record_roofline(ev)
        return self

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        for sink in self.sinks:
            sink.close()
        for spec in CHANNELS:
            sink = getattr(self, f"{spec.name}_sink")
            if sink is not None:
                sink.close()
        self._closed = True
        atexit.unregister(self._atexit_close)

    def _atexit_close(self) -> None:
        try:
            self.close()
        except Exception:
            pass          # a dead device at exit must not mask the exit

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        # flushes buffered rows on the exception path too — the tail of
        # a crashed run's metrics reaches the sinks before unwind
        self.close()


# materialize one record method per registry row (record_event,
# record_memory, ..., record_dynamics) — the registry is the single
# source of truth for channel names, nulling policy and docstrings
for _spec in CHANNELS:
    setattr(MetricsLogger, _spec.method, _channel_method(_spec))
del _spec
