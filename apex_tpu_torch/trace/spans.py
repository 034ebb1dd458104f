"""Span API + per-step host timeline — the forensic half of annotation.

The port of ``apex_tpu/trace/spans.py``. ``span("fwd")`` is a context
manager / decorator that opens a ``torch.profiler.record_function(name)``
range while a profiler runs (the range ``torch.profiler`` groups host and
device time by, as ``scripts/torch_bert_profile.py`` reads it) AND records a wall-clock
(begin, duration) event into the active :class:`Tracer`'s per-step
timeline. The timeline is emitted two ways:

- :meth:`Tracer.chrome_trace` / :meth:`Tracer.write_chrome_trace` —
  Chrome-trace-format JSON (``{"traceEvents": [...]}``) that loads in
  Perfetto / ``chrome://tracing``;
- :meth:`Tracer.timeline` — a :class:`StepTimeline` table (one row per
  step, one column per span) plus ``kind="span"``/``kind="step"`` JSONL
  events for the monitor trace-event channel
  (``scripts/check_metrics_schema.py --kind trace`` validates them).

**Eager timing, not trace-time timing.** The JAX package's spans inside
a jitted function run once, at trace time, and its host spans around a
dispatch measure an asynchronous submit. PyTorch runs eagerly: every
span runs on every step and measures the host time the ops inside it
took to dispatch. CUDA is asynchronous too, so a span's duration holds
device time only where the host waits on the device inside it (``.item()``,
``.cpu()``, ``torch.cuda.synchronize()``): wrap the read-back that ends a
step in its own span, or keep it inside the span whose time it should
carry. No NVTX range is emitted (``torch.cuda.nvtx`` raises on a CPU
build, and no NVTX reader runs on the card's machine).

Passive by default: with no Tracer entered and no profiler running,
``span`` costs a thread-local read and one ``torch.autograd.
_profiler_enabled()`` check — no device kernel and no host sync. The
``record_function`` range opens only while a profiler runs (when it
does not, entering one costs ≈ 15 µs of host time for nothing), so a
span opened before a profiler started has no range in its trace.

**The tracer stack is thread-local.** A helper thread entering its own
tracer never corrupts the train loop's; the other side of that is that
a span opened on another thread sees no tracer. For CUDA tensors the
autograd engine runs the backward on its own device thread, so a span
inside a custom ``autograd.Function.backward`` is passive on the card
(its ``record_function`` range still opens under a profiler), while on
the CPU the engine runs the backward on the calling thread and the span
lands in the caller's tracer. The JAX package has no span inside a backward, and
neither has the port.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

from apex_tpu_torch.utils.ranks import rank_default

__all__ = ["span", "step", "Tracer", "SpanEvent", "StepTrace",
           "StepTimeline", "current_tracer", "current_scope"]

# active Tracer stack (innermost last). Thread-local so a watchdog /
# helper thread entering its own tracer never corrupts the train loop's.
_tls = threading.local()


def _stack() -> List["Tracer"]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


#: open scope watchers (``prof.memory_report``): while one is open, spans
#: keep a thread-local stack of their names for :func:`current_scope`
SCOPE_WATCH = [0]


def _scopes() -> List[str]:
    st = getattr(_tls, "scopes", None)
    if st is None:
        st = _tls.scopes = []
    return st


def current_scope() -> str:
    """The names of the spans open on this thread, ``/``-joined (kept only
    while a scope watcher is open; ``""`` otherwise)."""
    return "/".join(_scopes())


def current_tracer() -> Optional["Tracer"]:
    """The innermost active Tracer on this thread, or None (passive)."""
    st = _stack()
    return st[-1] if st else None


class SpanEvent:
    """One span occurrence: name, begin time, duration.

    ``aborted`` marks a span unwound by an exception — it was in flight,
    not completed, when the step died (the duration then measures begin
    → unwind)."""

    __slots__ = ("name", "kind", "t_start", "dur_ms", "depth", "aborted")

    def __init__(self, name: str, kind: str, t_start: float,
                 dur_ms: float, depth: int, aborted: bool = False):
        self.name = name
        self.kind = kind          # "span" | "collective" | "compile"
        self.t_start = t_start    # perf_counter seconds (trace-relative)
        self.dur_ms = dur_ms
        self.depth = depth        # nesting depth inside the step
        self.aborted = aborted

    def to_event(self, step: Optional[int], rank: int) -> Dict:
        ev = {"kind": "span", "name": self.name, "span_kind": self.kind,
              "step": step, "rank": rank, "t_ms": self.t_start * 1e3,
              "dur_ms": self.dur_ms, "depth": self.depth}
        if self.aborted:
            ev["aborted"] = True
        return ev


class StepTrace:
    """The span timeline of one step (plus whatever rides along)."""

    def __init__(self, step: Optional[int], t_start: float):
        self.step = step
        self.t_start = t_start
        self.dur_ms: Optional[float] = None
        self.spans: List[SpanEvent] = []
        self.aborted = False

    def span_ms(self) -> Dict[str, float]:
        """Total duration per span name (summed over occurrences)."""
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.dur_ms
        return out

    def to_event(self, rank: int) -> Dict:
        ev = {"kind": "step", "step": self.step, "rank": rank,
              "t_ms": self.t_start * 1e3, "dur_ms": self.dur_ms,
              "spans": [{"name": s.name, "dur_ms": round(s.dur_ms, 4)}
                        for s in self.spans]}
        if self.aborted:
            ev["aborted"] = True
        return ev


class StepTimeline:
    """Tabular view of a list of StepTraces: steps x span columns."""

    def __init__(self, steps: List[StepTrace]):
        self.steps = steps

    def columns(self) -> List[str]:
        cols: List[str] = []
        for st in self.steps:
            for s in st.spans:
                if s.name not in cols:
                    cols.append(s.name)
        return cols

    def table(self, width: int = 12) -> str:
        cols = self.columns()
        heads = ["step", "total_ms"] + cols
        lines = [" ".join(h[-width:].rjust(width) for h in heads)]
        for st in self.steps:
            per = st.span_ms()
            row = [str(st.step if st.step is not None else "-"),
                   f"{st.dur_ms:.2f}" if st.dur_ms is not None else "n/a"]
            row += [f"{per[c]:.2f}" if c in per else "-" for c in cols]
            lines.append(" ".join(v.rjust(width) for v in row))
        return "\n".join(lines)


class Tracer:
    """Collects StepTraces from ``span``/``step`` used under it.

    ::

        tracer = trace.Tracer()
        with tracer:
            for batch in data:
                with trace.step():
                    with trace.span("dispatch"):
                        state, loss = train_step(state, batch)
                        loss.item()
                    with trace.span("fetch"):
                        logger.record(state.metrics)
        tracer.write_chrome_trace("timeline.json")
        print(tracer.timeline().table())

    ``on_step`` (a callable taking the finished StepTrace) is the fan-out
    hook: the flight recorder and the hang watchdog both subscribe
    through it, as can :meth:`apex_tpu_torch.monitor.MetricsLogger.
    record_event`. ``max_steps`` bounds the retained timeline (older
    steps drop off; forensic retention belongs to the FlightRecorder's
    ring buffer).
    """

    def __init__(self, *, max_steps: int = 1024,
                 on_step: Optional[Callable[[StepTrace], None]] = None):
        self.max_steps = max(int(max_steps), 1)
        self._on_step: List[Callable[[StepTrace], None]] = (
            [on_step] if on_step else [])
        self.steps: List[StepTrace] = []
        self._t0 = time.perf_counter()
        self._step_count = 0
        self._current: Optional[StepTrace] = None
        self._open: List[Any] = []     # (name, kind, t_begin) stack
        self.last_completed_span: Optional[str] = None
        # spans unwound by an exception since the last step began: they
        # were IN FLIGHT when the step died (the unwind closes the
        # context managers, so open_spans alone would read empty by the
        # time a crash handler looks) — innermost first, (name, kind)
        self.aborted_spans: List[Any] = []
        self._lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self) -> "Tracer":
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        st = _stack()
        if self in st:
            st.remove(self)

    def subscribe(self, fn: Callable[[StepTrace], None]) -> None:
        self._on_step.append(fn)

    # -- step boundaries -----------------------------------------------------

    def begin_step(self, step: Optional[int] = None) -> StepTrace:
        if step is None:
            step = self._step_count
        self._step_count = step + 1
        self.aborted_spans = []
        self._current = StepTrace(step, time.perf_counter() - self._t0)
        return self._current

    def end_step(self, aborted: bool = False) -> Optional[StepTrace]:
        st = self._current
        if st is None:
            return None
        st.dur_ms = (time.perf_counter() - self._t0 - st.t_start) * 1e3
        st.aborted = aborted
        self._current = None
        if not aborted:
            # the step completed: any span unwound by a caught-and-
            # recovered exception inside it is no longer in flight
            self.aborted_spans = []
        with self._lock:
            self.steps.append(st)
            if len(self.steps) > self.max_steps:
                del self.steps[:len(self.steps) - self.max_steps]
        for fn in list(self._on_step):
            try:
                fn(st)
            except Exception:
                pass          # observers never break the train loop
        return st

    # -- span recording (called by the span context manager) -----------------

    def _span_begin(self, name: str, kind: str) -> None:
        self._open.append((name, kind, time.perf_counter() - self._t0))

    def _span_end(self, aborted: bool = False) -> None:
        if not self._open:
            return
        name, kind, t0 = self._open.pop()
        now = time.perf_counter() - self._t0
        ev = SpanEvent(name, kind, t0, (now - t0) * 1e3,
                       depth=len(self._open), aborted=aborted)
        if aborted:
            # an exception unwound this span — it was in flight, not
            # completed; keep it visible to crash handlers
            self.aborted_spans.append((name, kind))
        else:
            self.last_completed_span = name
        target = self._current
        if target is not None:
            target.spans.append(ev)

    def add_span_event(self, name: str, kind: str, dur_ms: float,
                       t_end: Optional[float] = None) -> None:
        """Record a span *retroactively* — an event whose duration was
        only known after the fact. The event is back-dated so the
        timeline shows it where it actually ran; it lands in the
        current step (or the latest retained one, so post-step events
        are not lost). ``t_end`` is a ``time.perf_counter()`` reading."""
        now = (time.perf_counter() if t_end is None else t_end) - self._t0
        ev = SpanEvent(name, kind, now - dur_ms * 1e-3, dur_ms,
                       depth=len(self._open))
        target = self._current
        if target is not None:
            target.spans.append(ev)
            return
        with self._lock:
            if self.steps:
                self.steps[-1].spans.append(ev)
            else:
                st = StepTrace(None, ev.t_start)
                st.dur_ms = dur_ms
                st.spans.append(ev)
                self.steps.append(st)

    @property
    def open_spans(self) -> List[str]:
        """Names of in-flight spans, outermost first: still-open ones
        plus any already unwound by the in-progress exception."""
        return ([name for name, _, _ in self._open]
                + [name for name, _ in reversed(self.aborted_spans)])

    @property
    def in_flight_collective(self) -> Optional[str]:
        """Deepest in-flight span tagged ``kind="collective"``, if any
        (exception-unwound collectives included)."""
        for name, kind in self.aborted_spans:
            if kind == "collective":
                return name
        for name, kind, _ in reversed(self._open):
            if kind == "collective":
                return name
        return None

    def in_flight_collective_age(self) -> Optional[Any]:
        """``(name, age_seconds, start)`` of the deepest OPEN
        ``kind="collective"`` span, or None. The age is host wall time
        since the span opened — what
        :class:`apex_tpu_torch.cluster.CollectiveDeadline` polls to tell
        a *hung* collective (one span instance open past the deadline)
        from a *slow* one (which closes and reopens, resetting the
        age); ``start`` is the span's fixed open timestamp on the
        tracer clock — the stable instance identity its fire-once
        logic keys on. Exception-unwound collectives are excluded:
        they already belong to the crash handlers, not a liveness
        poll."""
        now = time.perf_counter() - self._t0
        for name, kind, t0 in reversed(list(self._open)):
            if kind == "collective":
                return name, max(now - t0, 0.0), t0
        return None

    # -- exports -------------------------------------------------------------

    def timeline(self) -> StepTimeline:
        with self._lock:
            return StepTimeline(list(self.steps))

    def step_events(self, rank: Optional[int] = None) -> List[Dict]:
        """``kind="step"`` JSONL events for every retained step."""
        r = rank_default() if rank is None else rank
        with self._lock:
            return [st.to_event(r) for st in self.steps]

    def span_events(self, rank: Optional[int] = None) -> List[Dict]:
        """Flat ``kind="span"`` JSONL events for every retained span."""
        r = rank_default() if rank is None else rank
        out: List[Dict] = []
        with self._lock:
            for st in self.steps:
                out.extend(s.to_event(st.step, r) for s in st.spans)
        return out

    def chrome_trace(self, rank: Optional[int] = None) -> Dict:
        """Chrome-trace-format dict (loads in Perfetto/chrome://tracing).

        One complete-duration ("ph": "X") event per span plus one per
        step; pid is the process rank so multi-rank dumps merge into one
        per-rank-track view, and ``process_name``/``thread_name``
        metadata events ("ph": "M") label each rank's track ("rank N").
        """
        r = rank_default() if rank is None else rank
        events: List[Dict] = [
            {"name": "process_name", "ph": "M", "pid": r, "tid": 0,
             "args": {"name": f"rank {r}"}},
            {"name": "process_sort_index", "ph": "M", "pid": r, "tid": 0,
             "args": {"sort_index": r}},
            {"name": "thread_name", "ph": "M", "pid": r, "tid": 0,
             "args": {"name": f"rank {r} steps"}},
        ]
        with self._lock:
            for st in self.steps:
                if st.dur_ms is not None:
                    events.append({
                        "name": f"step {st.step}", "ph": "X", "cat": "step",
                        "ts": st.t_start * 1e6, "dur": st.dur_ms * 1e3,
                        "pid": r, "tid": 0,
                        "args": {"step": st.step}})
                for s in st.spans:
                    events.append({
                        "name": s.name, "ph": "X", "cat": s.kind,
                        "ts": s.t_start * 1e6, "dur": s.dur_ms * 1e3,
                        "pid": r, "tid": 1 + s.depth,
                        "args": {"step": st.step}})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metadata": {"producer": "apex_tpu_torch.trace", "rank": r}}

    def write_chrome_trace(self, path: str,
                           rank: Optional[int] = None) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(rank), f)
        return path


class span:
    """``with trace.span("fwd"): ...`` / ``@trace.span("fwd")``.

    Opens a ``torch.profiler.record_function(name)`` range while a
    profiler runs and, under an active :class:`Tracer` on this thread,
    records a wall-clock event in it. ``kind="collective"`` tags the span for the flight recorder's
    in-flight-collective forensics and the goodput ledger's
    ``comm_wire`` bucket. As a decorator, when
    :func:`apex_tpu_torch.trace.debug_nans` mode is on, the wrapped
    function's outputs are additionally probed for finiteness under this
    span's name (see :mod:`apex_tpu_torch.trace.debug_nans`).
    """

    __slots__ = ("name", "kind", "_rf", "_tracer", "_scoped")

    def __init__(self, name: str, *, kind: str = "span"):
        self.name = name
        self.kind = kind
        self._rf = None
        self._tracer: Optional[Tracer] = None
        self._scoped = False

    def __enter__(self) -> "span":
        if SCOPE_WATCH[0]:
            _scopes().append(self.name)
            self._scoped = True
        self._tracer = current_tracer()
        if self._tracer is not None:
            self._tracer._span_begin(self.name, self.kind)
        if _profiler_enabled():
            self._rf = record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self._tracer is not None:
            self._tracer._span_end(aborted=bool(exc and exc[0]))
            self._tracer = None
        if self._scoped:
            _scopes().pop()
            self._scoped = False

    def __call__(self, fn: Callable) -> Callable:
        from apex_tpu_torch.trace.debug_nans import nan_probe

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(self.name, kind=self.kind):
                out = fn(*args, **kwargs)
            return nan_probe(self.name, out)

        return wrapped


class step:
    """``with trace.step(): ...`` — delimits one train step's timeline.

    Nested ``span``s land in this step's StepTrace; on exit the finished
    StepTrace fans out to the tracer's subscribers (flight recorder,
    watchdog heartbeat, metric-logger trace channel). A no-op when no
    Tracer is active.
    """

    __slots__ = ("_step", "_tracer")

    def __init__(self, step: Optional[int] = None):
        self._step = step
        self._tracer: Optional[Tracer] = None

    def __enter__(self) -> "step":
        self._tracer = current_tracer()
        if self._tracer is not None:
            self._tracer.begin_step(self._step)
        return self

    def __exit__(self, *exc) -> None:
        if self._tracer is not None:
            self._tracer.end_step(aborted=bool(exc and exc[0]))
            self._tracer = None
