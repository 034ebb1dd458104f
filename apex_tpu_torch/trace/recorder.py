"""Flight recorder: a bounded ring of step records + crash dumps.

The port of ``apex_tpu/trace/recorder.py``. A wedged or dead multi-rank
job must be diagnosable from artifacts, not reproduction. The recorder
keeps the last N completed steps — span timings, the
:class:`apex_tpu_torch.monitor.Metrics` tuple (buffered as device
tensors, read back only at dump time, so recording never syncs), loss
scale, collective bytes, rank/host ids — and writes a JSONL crash
report on any abnormal exit:

- unhandled exception (``sys.excepthook``, chained to the previous hook);
- SIGTERM (the preemption signal on managed clusters; previous handler
  chained; ``escalation.on_preempt()`` first when an
  :class:`apex_tpu_torch.ckpt.EscalationPolicy` is wired);
- ``atexit`` as a safety net, only when an exception/signal was seen but
  no dump was written (a clean exit writes nothing).

The dump is one header line (``kind="crash"``: reason, rank, hostname,
pid, last-completed span, in-flight spans, in-flight collective,
recent guard interventions and straggler blame reports, exception +
traceback) followed by one ``kind="step"`` line per buffered
step — the schema ``scripts/check_metrics_schema.py --kind trace``
validates. The rank is ``torch.distributed``'s when a process group is
up, else ``RANK``, else 0; on multi-process runs :func:`rank_path` keeps
the ranks' files apart.

Device reads at dump time are bounded: a ``.cpu()`` of a metrics tensor
(or the NaN-provenance scalar) queued behind a wedged kernel or
collective blocks forever, so the dump reads them on a daemon thread
and gives up after a timeout — the host-side span timings still land.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import signal
import socket
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from apex_tpu_torch.trace.spans import StepTrace, Tracer
from apex_tpu_torch.utils.ranks import rank_default as _rank
from apex_tpu_torch.utils.ranks import world_default as _process_count

__all__ = ["FlightRecorder", "StepRecord", "rank_path"]


def _bounded(fn, timeout_s: float, name: str):
    """``(ok, value)`` of ``fn()`` run on a daemon thread, waiting at most
    ``timeout_s``: a device read queued behind a wedged stream never
    returns, and the dump must not hang with it."""
    box: Dict[str, Any] = {}
    done = threading.Event()

    def work():
        try:
            box["value"] = fn()
        except Exception as e:
            box["err"] = e
        done.set()

    threading.Thread(target=work, daemon=True, name=name).start()
    if not done.wait(timeout_s) or "value" not in box:
        return False, None
    return True, box["value"]


def rank_path(path: str, rank: Optional[int] = None) -> str:
    """Per-rank dump path: ``crash.jsonl`` → ``crash.rank0.jsonl``.

    Identity on single-process runs, so local scripts get the filename
    they asked for; ranked on multi-process runs (or when ``rank`` is
    given) so N hosts never clobber one file.
    """
    if rank is None:
        if _process_count() <= 1:
            return path
        rank = _rank()
    root, ext = os.path.splitext(path)
    return f"{root}.rank{rank}{ext or '.jsonl'}"


class StepRecord:
    """One ring-buffer entry. Metrics stay on the device until dump()."""

    __slots__ = ("step", "dur_ms", "spans", "metrics", "extra", "wall_time")

    def __init__(self, step, dur_ms, spans, metrics, extra):
        self.step = step
        self.dur_ms = dur_ms
        self.spans = spans            # [(name, dur_ms)]
        self.metrics = metrics        # monitor.Metrics (device) or None
        self.extra = extra            # host scalars (loss scale override, ...)
        self.wall_time = time.time()

    def to_event(self, rank: int, fetch_metrics: bool = True) -> Dict:
        """``fetch_metrics=False`` skips the device read — required on
        the hang path, where a read-back queued behind the wedged
        stream would block the watchdog thread forever."""
        rec: Dict[str, Any] = {
            "kind": "step", "step": self.step, "rank": rank,
            "dur_ms": self.dur_ms, "wall_time": self.wall_time,
            "spans": [{"name": n, "dur_ms": round(d, 4)}
                      for n, d in self.spans],
        }
        if self.metrics is not None and not fetch_metrics:
            rec["metrics"] = None
            rec["metrics_error"] = "not fetched (hung runtime)"
        elif self.metrics is not None:
            from apex_tpu_torch.monitor.metrics import metrics_to_dict
            try:
                m = metrics_to_dict(self.metrics)
                # strict-JSON contract: non-finite gauges become null,
                # same as MetricsLogger.flush
                import math
                for k, v in m.items():
                    if isinstance(v, float) and not math.isfinite(v):
                        m[k] = None
                rec["metrics"] = m
                if m.get("loss_scale") is not None:
                    rec["loss_scale"] = m["loss_scale"]
            except Exception as e:           # dead device mid-crash
                rec["metrics"] = None
                rec["metrics_error"] = repr(e)[:200]
        if self.extra:
            rec.update(self.extra)
        return rec


class FlightRecorder:
    """Ring buffer of the last ``capacity`` steps + crash-dump handlers.

    ::

        tracer = trace.Tracer()
        recorder = trace.FlightRecorder("dumps/crash.jsonl", capacity=64,
                                        tracer=tracer)
        recorder.install()                  # excepthook / SIGTERM / atexit
        ...
        recorder.record_metrics(state.metrics)   # inside trace.step()

    ``collective_bytes``/``extra`` statics attach to every subsequent
    record. Paths get :func:`rank_path` applied so multi-process runs
    dump per rank.
    """

    def __init__(self, path: str = "apex_tpu_crash.jsonl", *,
                 capacity: int = 64, tracer: Optional[Tracer] = None,
                 collective_bytes: Optional[int] = None,
                 escalation=None):
        self.path = rank_path(path)
        #: optional :class:`apex_tpu_torch.ckpt.EscalationPolicy`: its
        #: ``on_preempt`` runs FIRST in the SIGTERM handler, so a
        #: managed-cluster preemption commits the last host checkpoint
        #: snapshot durably *before* the crash dump is written — lost
        #: work becomes a resume point
        self.escalation = escalation
        self.capacity = max(int(capacity), 1)
        self._ring: "collections.deque[StepRecord]" = collections.deque(
            maxlen=self.capacity)
        self.tracer = tracer
        if tracer is not None:
            tracer.subscribe(self.on_step)
        self.collective_bytes = collective_bytes
        self.extra_statics: Dict[str, Any] = {}
        # JSON-able digest of the step's memory footprint
        # (prof.MemoryReport.summary()) — embedded in the crash header so
        # an OOM dump names the biggest buffers instead of just dying
        self.memory_report: Optional[Dict[str, Any]] = None
        # bounded ring of recent guard interventions (note_guard) —
        # embedded in the crash header: a post-mortem must show whether
        # the run was already skipping/rewinding before it died
        self._guard_events: "collections.deque[Dict]" = collections.deque(
            maxlen=16)
        # bounded ring of straggler reports (note_straggler) — a hang
        # or collective timeout is routinely PRECEDED by one rank
        # lagging; the dump must name that rank and its slowest span,
        # not just this rank's heartbeat view
        self._straggler_reports: "collections.deque[Dict]" = \
            collections.deque(maxlen=16)
        self._installed = False
        self._dumped = False
        self._abnormal_seen = False
        self._last_completed_span: Optional[str] = None
        self._prev_excepthook = None
        self._prev_sigterm = None
        self._pending = None          # (metrics, extra) for the open step
        # RLock, not Lock: the SIGTERM handler runs on the main thread
        # and calls dump() -> lock; if the signal lands while record()
        # holds the lock on that same thread, a plain Lock deadlocks the
        # handler forever (and the process then ignores SIGTERM)
        self._lock = threading.RLock()

    # -- recording -----------------------------------------------------------

    def on_step(self, st: StepTrace) -> None:
        """Tracer subscriber: fold a finished StepTrace into the ring."""
        pending, self._pending = self._pending, None
        metrics, extra = pending if pending is not None else (None, {})
        if st.aborted:
            extra = dict(extra, aborted=True)
        self.record(step=st.step, dur_ms=st.dur_ms,
                    spans=[(s.name, s.dur_ms) for s in st.spans],
                    metrics=metrics, **extra)
        completed = [s for s in st.spans if not s.aborted]
        if completed:
            self._last_completed_span = completed[-1].name

    def record(self, *, step: Optional[int] = None,
               dur_ms: Optional[float] = None,
               spans: Optional[List] = None,
               metrics=None, **extra) -> None:
        """Append one step record (never fetches from device)."""
        merged = dict(self.extra_statics)
        if self.collective_bytes is not None:
            merged["collective_bytes"] = self.collective_bytes
        merged.update(extra)
        with self._lock:
            self._ring.append(StepRecord(step, dur_ms, spans or [],
                                         metrics, merged))

    def record_metrics(self, metrics, **extra) -> None:
        """Attach a Metrics snapshot to the current step — call next to
        ``MetricsLogger.record``, inside or right after the
        ``trace.step()`` block; costs a slot write, no sync. Inside an
        open step the snapshot is held pending and folded into that
        step's record when it completes; otherwise it attaches to the
        latest ring entry (or starts one)."""
        if (self.tracer is not None
                and self.tracer._current is not None):
            self._pending = (metrics, dict(extra))
            return
        with self._lock:
            if self._ring and self._ring[-1].metrics is None:
                self._ring[-1].metrics = metrics
                if extra:
                    self._ring[-1].extra.update(extra)
                return
        self.record(metrics=metrics, **extra)

    def attach_memory_report(self, report) -> "FlightRecorder":
        """Attach the step's :class:`apex_tpu_torch.prof.MemoryReport`
        (or its ``summary()`` dict). Stored as a plain dict — no live
        references, so dumping never touches the (possibly wedged)
        device."""
        if report is None:
            self.memory_report = None
        elif isinstance(report, dict):
            self.memory_report = dict(report)
        else:
            self.memory_report = report.summary()
        return self

    def note_guard(self, event: Dict) -> None:
        """Record one :mod:`apex_tpu_torch.guard` event (anomaly / action /
        rewind) for crash forensics — wire ``GuardPolicy(recorder=...)``.
        Plain-dict copy into a bounded ring; the newest 16 land in the
        crash header as ``guard_events``. No device access, never
        raises."""
        try:
            self._guard_events.append(dict(event))
        except Exception:
            pass

    def note_straggler(self, event: Dict) -> None:
        """Record one ``kind="straggler"`` event (the detector's
        span-level blame: lagging rank, z, slowest span + its goodput
        class) for crash forensics — wire
        ``StragglerWatch(recorder=...)``. The newest 16 land in the
        crash header as ``straggler_reports``. No device access,
        never raises."""
        try:
            self._straggler_reports.append(dict(event))
        except Exception:
            pass

    @property
    def last_completed_span(self) -> Optional[str]:
        if self.tracer is not None and self.tracer.last_completed_span:
            return self.tracer.last_completed_span
        return self._last_completed_span

    # -- crash handlers ------------------------------------------------------

    def install(self) -> "FlightRecorder":
        """Install excepthook/SIGTERM/atexit handlers (all chained).

        Only from the main thread: ``signal.signal`` works nowhere else,
        and a recorder without its SIGTERM handler would lose the
        preemption dump silently."""
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError(
                "FlightRecorder.install() must run on the main thread: "
                "signal.signal (the SIGTERM dump) works only there")
        self._prev_sigterm = signal.signal(signal.SIGTERM, self._sigterm)
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        atexit.register(self._atexit)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        # == (not `is`): each attribute read makes a new bound method, so
        # the JAX package's `is` never matches and leaves its hook in
        if sys.excepthook == self._excepthook:
            sys.excepthook = self._prev_excepthook or sys.__excepthook__
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass
        atexit.unregister(self._atexit)
        self._installed = False

    def _excepthook(self, etype, value, tb) -> None:
        self._abnormal_seen = True
        try:
            self.dump(reason="exception", exc=(etype, value, tb))
        finally:
            (self._prev_excepthook or sys.__excepthook__)(etype, value, tb)

    def _sigterm(self, signum, frame) -> None:
        self._abnormal_seen = True
        if self.escalation is not None:
            try:
                self.escalation.on_preempt()
            except Exception:
                pass          # the dump below must still land
        self.dump(reason="signal:SIGTERM")
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    def _atexit(self) -> None:
        # safety net only: an abnormal path was seen but no dump landed
        # (e.g. the excepthook itself died). Clean exits write nothing.
        if self._abnormal_seen and not self._dumped:
            self.dump(reason="atexit-after-abnormal")

    # -- the dump ------------------------------------------------------------

    def header(self, reason: str, exc=None,
               read_device: bool = True) -> Dict:
        hdr: Dict[str, Any] = {
            "kind": "crash", "reason": reason,
            "rank": _rank(), "process_count": _process_count(),
            "hostname": socket.gethostname(), "pid": os.getpid(),
            "wall_time": time.time(),
            "last_completed_span": self.last_completed_span,
            "in_flight_spans": (self.tracer.open_spans
                                if self.tracer is not None else []),
            "in_flight_collective": (self.tracer.in_flight_collective
                                     if self.tracer is not None else None),
            "n_steps_recorded": len(self._ring),
        }
        if self.memory_report is not None:
            hdr["memory_report"] = self.memory_report
        if self._guard_events:
            hdr["guard_events"] = list(self._guard_events)
        if self._straggler_reports:
            hdr["straggler_reports"] = list(self._straggler_reports)
        from apex_tpu_torch.trace.debug_nans import _first, first_nan
        if read_device and _first:
            ok, hit = _bounded(first_nan, 5.0,
                               "apex_tpu_torch.trace.dump-first-nan")
            if ok and hit is not None:
                hdr["first_nan_span"] = hit["span"]
        if exc is not None:
            etype, value, tb = exc
            hdr["exception"] = "".join(
                traceback.format_exception_only(etype, value))[:2000].strip()
            hdr["traceback"] = [l.rstrip() for l in
                                traceback.format_tb(tb, limit=40)]
        return hdr

    def _fetch_metrics_bounded(self, records: List[StepRecord],
                               timeout_s: float = 5.0) -> bool:
        """Read every buffered Metrics tuple back with a bounded wait
        (one device-to-host copy, on a daemon thread), replacing them in
        place with host values. Returns False on timeout/error — a crash
        can leave a stream wedged on a dead collective or a runaway
        kernel, and an unbounded read there would hang the crash handler
        and lose the whole dump."""
        idx = [i for i, r in enumerate(records) if r.metrics is not None]
        if not idx:
            return True
        from apex_tpu_torch.monitor.logger import _fetch
        ok, host = _bounded(lambda: _fetch([records[i].metrics
                                            for i in idx]),
                            timeout_s, "apex_tpu_torch.trace.dump-fetch")
        if not ok:
            return False
        for i, h in zip(idx, host):
            records[i].metrics = h
        return True

    def dump_records(self, f, rank: int, fetch_metrics: bool = True,
                     records: Optional[List[StepRecord]] = None) -> None:
        """Serialize the ring (one ``kind="step"`` line each) to an open
        file — the one implementation behind both the crash dump and the
        watchdog's hang dump."""
        if records is None:
            with self._lock:
                records = list(self._ring)
        for rec in records:
            f.write(json.dumps(rec.to_event(
                rank, fetch_metrics=fetch_metrics)) + "\n")

    def dump(self, reason: str = "manual", exc=None,
             path: Optional[str] = None) -> str:
        """Write the crash report; returns the path written."""
        out = path or self.path
        d = os.path.dirname(out)
        if d:
            os.makedirs(d, exist_ok=True)
        rank = _rank()
        with self._lock:
            records = list(self._ring)
        fetched = self._fetch_metrics_bounded(records)
        with open(out, "w") as f:
            f.write(json.dumps(self.header(reason, exc,
                                           read_device=fetched)) + "\n")
            self.dump_records(f, rank, fetch_metrics=fetched,
                              records=records)
        self._dumped = True
        return out
