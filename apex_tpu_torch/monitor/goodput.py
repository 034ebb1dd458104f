"""Goodput ledger: where each step's wall clock actually went.

The port's copy of ``apex_tpu/monitor/goodput.py`` (pure Python over
span records). It joins the host span timeline the
:class:`apex_tpu_torch.trace.Tracer` records, checkpoint ``stall_ms``
from the ckpt event channel and guard action events into one per-step
ledger of named buckets:

======================  ======================================================
bucket                  what lands in it
======================  ======================================================
``compute``             dispatch + device wait of the step program itself
``comm_skew``           wait-for-laggard share of exposed collectives —
                        joined from the pod observatory's cross-rank
                        entry-skew measurement (``note_pod_skew``; zero
                        without pod data)
``comm_wire``           host spans tagged ``kind="collective"``, minus any
                        joined skew — the share the fabric actually took
``input_wait``          data loading / host input spans (``data/*``,
                        ``input/*``, ``load*``)
``host_callback``       host fetches and callbacks (``fetch*``, ``host/*``,
                        ``callback/*``) — the sync points
``ckpt_stall``          checkpoint capture stall joined from ``ckpt_save``
                        events (``note_ckpt``) plus ``ckpt/*`` spans
``recompile``           ``kind="compile"`` spans, which
                        :class:`apex_tpu_torch.prof.CompileWatcher` emits
                        for a watched call that built a kernel (nvcc, the
                        host compiler), JIT-compiled a Triton
                        specialization or compiled a ``torch.compile``
                        graph
``guard_rewind``        guard intervention wall time joined from guard
                        action/rewind events (``note_guard``) + ``guard/*``
``other``               wall time no span covered (the residual)
======================  ======================================================

In the port a span measures eager host time (see
:mod:`apex_tpu_torch.trace.spans`): ``compute`` holds the device wait only
where the read-back that waits sits inside a compute span, so a loop
keeps its ``loss.item()`` inside ``dispatch``.

Attribution is a sweep over the step's span intervals — at every
instant exactly one bucket owns the clock (the deepest covering span
wins), so nested and overlapping spans never double-count and the
bucket sum **closes over the measured step wall time** by construction;
:meth:`GoodputLedger.check_closure` asserts the closure within a stated
tolerance (5% by default).

The two exposed-communication buckets additionally carry a **per-axis
split** (:attr:`StepLedger.comm_axes_ms`): each collective span's name
is joined through the planned-collective registry
(:func:`apex_tpu_torch.monitor.collectives.scope_axis_row`), unregistered
scopes landing in an explicit ``"unknown"`` row, and the axis sums equal
the buckets exactly.

**Goodput fraction** = useful-step time ÷ wall time, where useful =
the ``compute`` bucket. :meth:`rolling_goodput` averages it over a
window; :meth:`table` renders the per-step ledger; :meth:`to_events`
emits ``kind="goodput"`` JSONL events for the
``MetricsLogger(goodput_sink=...)`` channel
(``scripts/check_metrics_schema.py --kind goodput`` validates).

Typical wiring::

    tracer = trace.Tracer()
    ledger = monitor.GoodputLedger(tracer)      # subscribes to steps
    logger = monitor.MetricsLogger(goodput_sink=monitor.JSONLSink(p))
    ledger.subscribe(logger.record_goodput)     # stream per-step events
    with tracer:
        for i, batch in enumerate(data):
            with trace.step(i):
                with trace.span("dispatch"):
                    state, loss = train_step(state, batch)
                    loss.item()
                with trace.span("fetch"):
                    logger.record(state.metrics)
    print(ledger.table())

Purely host-side: the ledger reads finished
:class:`~apex_tpu_torch.trace.StepTrace` records, never the device.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["BUCKETS", "GoodputLedger", "StepLedger", "classify_span"]

#: the ledger's bucket names, report order. ``compute`` is the goodput
#: numerator; ``other`` is the residual no span covered. ``comm_skew``
#: + ``comm_wire`` together are the exposed-communication time the
#: pre-podview ledger reported as one ``exposed_comm`` bucket
#: (:attr:`StepLedger.exposed_comm` keeps that sum readable).
BUCKETS = ("compute", "comm_skew", "comm_wire", "input_wait",
           "host_callback", "ckpt_stall", "recompile", "guard_rewind",
           "other")

#: span-name prefixes per bucket (checked before the kind rules; first
#: match wins, longest prefix first at classify time)
_NAME_PREFIXES: Tuple[Tuple[str, str], ...] = (
    ("data/", "input_wait"), ("input/", "input_wait"),
    ("load", "input_wait"),
    ("fetch", "host_callback"), ("host/", "host_callback"),
    ("callback/", "host_callback"),
    ("ckpt/", "ckpt_stall"),
    ("guard/", "guard_rewind"),
    ("compile/", "recompile"),
)


def classify_span(name: str, kind: str = "span") -> str:
    """Bucket for one span: the span ``kind`` ("collective"/"compile")
    takes precedence, then the name-prefix table, else ``compute``."""
    if kind == "collective":
        # the span sweep cannot see cross-rank entry skew; collective
        # time lands in comm_wire and note_pod_skew moves the measured
        # wait-for-laggard share to comm_skew after the fact
        return "comm_wire"
    if kind == "compile":
        return "recompile"
    for prefix, bucket in _NAME_PREFIXES:
        if name.startswith(prefix):
            return bucket
    return "compute"


class StepLedger:
    """One step's attribution: wall time + per-bucket milliseconds."""

    __slots__ = ("step", "wall_ms", "buckets", "wall_time",
                 "comm_axes_ms")

    def __init__(self, step: Optional[int], wall_ms: float,
                 buckets: Dict[str, float],
                 comm_axes_ms: Optional[Dict[str, Dict[str, float]]]
                 = None):
        self.step = step
        self.wall_ms = wall_ms
        self.buckets = buckets        # {bucket: ms}, every BUCKETS key
        #: per-mesh-axis split of the exposed-communication buckets:
        #: ``{axis: {"wire": ms, "skew": ms}}`` — axes joined from each
        #: collective span's scope through the planned-collective
        #: registry (scope_axis_row; unregistered scopes land in
        #: ``"unknown"``). The axis sums equal the comm_wire/comm_skew
        #: buckets by construction.
        self.comm_axes_ms = comm_axes_ms or {}
        self.wall_time = time.time()

    @property
    def attributed_ms(self) -> float:
        """Span-covered milliseconds (everything but ``other``)."""
        return sum(v for k, v in self.buckets.items() if k != "other")

    @property
    def exposed_comm(self) -> float:
        """Total exposed-collective milliseconds — the pre-podview
        single bucket, now the ``comm_skew + comm_wire`` sum."""
        return self.buckets["comm_skew"] + self.buckets["comm_wire"]

    @property
    def goodput_frac(self) -> Optional[float]:
        if not self.wall_ms or self.wall_ms <= 0:
            return None
        return self.buckets["compute"] / self.wall_ms

    def closure_error(self) -> float:
        """Relative attribution-closure error: |sum(buckets) − wall| /
        wall. ``other`` absorbs uncovered time, so the error is exactly
        the OVER-attribution a double count would introduce."""
        if not self.wall_ms or self.wall_ms <= 0:
            return 0.0
        return abs(sum(self.buckets.values()) - self.wall_ms) \
            / self.wall_ms

    def to_event(self, rank: int = 0) -> Dict:
        gf = self.goodput_frac
        return {"kind": "goodput", "step": self.step, "rank": rank,
                "wall_ms": round(self.wall_ms, 4),
                "buckets_ms": {k: round(v, 4)
                               for k, v in self.buckets.items()},
                "comm_axes_ms": {
                    ax: {k: round(v, 4) for k, v in parts.items()}
                    for ax, parts in self.comm_axes_ms.items()},
                "goodput_frac": round(gf, 6) if gf is not None else None,
                "closure_err": round(self.closure_error(), 6),
                "wall_time": self.wall_time}


def _attribute(spans, wall_ms: float,
               classify: Callable[[str, str], str]
               ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Sweep a step's span intervals into bucket milliseconds.

    Boundary sweep: between any two adjacent span boundaries exactly
    one span owns the clock — the deepest covering one (ties: the
    latest-starting, i.e. the one entered last) — so nesting and the
    back-dated compile spans :func:`Tracer.add_span_event` injects can
    never double-count an instant. Uncovered time is NOT emitted here;
    the caller assigns ``wall − covered`` to ``other``.

    Returns ``(buckets, comm_axis_ms)``: the second dict splits the
    ``comm_wire`` bucket per mesh axis by joining each winning
    collective span's name through the planned-collective registry
    (:func:`apex_tpu_torch.monitor.collectives.scope_axis_row` — the one
    shared join; unregistered scopes land in ``"unknown"``), so
    ``sum(comm_axis_ms.values()) == buckets["comm_wire"]`` exactly.
    """
    out = {b: 0.0 for b in BUCKETS}
    axes: Dict[str, float] = {}
    if not spans:
        return out, axes
    from apex_tpu_torch.monitor.collectives import scope_axis_row
    # (t0, t1, depth, order, bucket, name) in step-relative ms
    base = min(s.t_start for s in spans)
    ivals = []
    for order, s in enumerate(spans):
        t0 = (s.t_start - base) * 1e3
        ivals.append((t0, t0 + max(s.dur_ms, 0.0), s.depth, order,
                      classify(s.name, s.kind), s.name))
    bounds = sorted({b for iv in ivals for b in iv[:2]})
    for lo, hi in zip(bounds, bounds[1:]):
        if hi <= lo:
            continue
        covering = [iv for iv in ivals if iv[0] <= lo and iv[1] >= hi]
        if not covering:
            continue
        win = max(covering, key=lambda iv: (iv[2], iv[3]))
        bucket, name = win[4], win[5]
        out[bucket] += hi - lo
        if bucket == "comm_wire":
            ax = scope_axis_row(name)
            axes[ax] = axes.get(ax, 0.0) + (hi - lo)
    return out, axes


class GoodputLedger:
    """Per-step wall-time decomposition + rolling goodput fraction.

    Subscribe it to a :class:`apex_tpu_torch.trace.Tracer` (pass the tracer,
    or call :meth:`on_step` yourself) and join the other event channels
    through :meth:`note_ckpt` / :meth:`note_guard`. ``subscribe``
    callbacks receive each finished step's ``kind="goodput"`` event —
    wire :meth:`apex_tpu_torch.monitor.MetricsLogger.record_goodput` there.
    ``max_steps`` bounds the retained ledger like the Tracer's
    timeline.
    """

    def __init__(self, tracer=None, *, window: int = 50,
                 tolerance: float = 0.05, max_steps: int = 1024,
                 classify: Callable[[str, str], str] = classify_span,
                 rank: Optional[int] = None):
        self.window = max(int(window), 1)
        self.tolerance = float(tolerance)
        self.max_steps = max(int(max_steps), 1)
        self.classify = classify
        if rank is None:
            from apex_tpu_torch.utils.ranks import rank_default
            rank = rank_default()
        self.rank = rank
        self.steps: List[StepLedger] = []
        self._on_step: List[Callable[[Dict], None]] = []
        self._frac = collections.deque(maxlen=self.window)
        # stalls joined from event channels, waiting for their step:
        # {step (or None=next): ms}
        self._pending: Dict[str, Dict] = {"ckpt_stall": {},
                                          "guard_rewind": {},
                                          "comm_skew": {}}
        if tracer is not None:
            tracer.subscribe(self.on_step)

    def subscribe(self, fn: Callable[[Dict], None]) -> None:
        self._on_step.append(fn)

    # -- event-channel joins --------------------------------------------------

    def _note(self, bucket: str, ms: float, step: Optional[int]) -> None:
        if ms is None or ms <= 0:
            return
        pend = self._pending[bucket]
        pend[step] = pend.get(step, 0.0) + float(ms)

    def note_ckpt(self, event: Dict) -> None:
        """Join one ``ckpt_save`` event's capture ``stall_ms`` into the
        matching step's ``ckpt_stall`` bucket (pass the same events the
        ``MetricsLogger(ckpt_sink=)`` channel gets — wire the
        CheckpointManager's ``event_sink`` to both). Events for steps
        already folded attach to the next finished step instead, so a
        post-step save is never lost."""
        if event.get("kind") != "ckpt_save":
            return
        self._note("ckpt_stall", event.get("stall_ms") or 0.0,
                   event.get("step"))

    def note_guard(self, event: Dict) -> None:
        """Join one guard event (``guard_action``/``guard_rewind``) —
        its host-side ``dur_ms`` (rewind restore time, when the policy
        recorded one) lands in ``guard_rewind``; events without a
        duration still mark the step (0 ms — the in-graph skip costs no
        wall time by design)."""
        if event.get("kind") not in ("guard_action", "guard_rewind"):
            return
        self._note("guard_rewind", event.get("dur_ms") or 0.0,
                   event.get("step"))

    def note_pod_skew(self, skew_ms: float,
                      step: Optional[int] = None) -> None:
        """Join this rank's pod-measured wait-for-laggard milliseconds
        (``PodTimeline.rank_step_skew()[rank, step]``) into the
        matching step's ``comm_skew`` bucket. The move comes OUT of
        ``comm_wire`` only (a skew claim larger than the measured
        collective time is clamped — pod blame can reclassify exposed
        collective time, never invent it), so the bucket sum still
        closes over wall time exactly."""
        self._note("comm_skew", skew_ms, step)

    def _take_pending(self, bucket: str, step: Optional[int]) -> float:
        pend = self._pending[bucket]
        ms = pend.pop(step, 0.0) if step is not None else 0.0
        # stale entries for already-folded steps attach here rather
        # than leak: anything keyed at or before this step, or unkeyed
        for k in list(pend):
            if k is None or (step is not None and isinstance(k, int)
                             and k <= step):
                ms += pend.pop(k)
        return ms

    # -- the fold -------------------------------------------------------------

    def on_step(self, st) -> None:
        """Tracer subscriber: fold one finished
        :class:`~apex_tpu_torch.trace.StepTrace` into the ledger."""
        wall = st.dur_ms if st.dur_ms is not None else 0.0
        buckets, axis_wire = _attribute(st.spans, wall, self.classify)
        covered = sum(buckets.values())
        buckets["other"] += max(wall - covered, 0.0)
        skew_moved = 0.0
        for bucket, donors in (("ckpt_stall", ("other", "compute")),
                               ("guard_rewind", ("other", "compute")),
                               # pod skew only reclassifies exposed
                               # collective time — see note_pod_skew
                               ("comm_skew", ("comm_wire",))):
            joined = self._take_pending(bucket, st.step)
            # a joined stall MOVES measured time, never invents it —
            # the sum still closes over wall. Drain the residual first:
            # a stall spent outside every span (the Snapshotter-capture
            # case) is sitting in `other` by construction, and only a
            # stall that overlapped the dispatch window should come out
            # of compute.
            for donor in donors:
                if joined <= 0:
                    break
                take = min(joined, buckets[donor])
                if take > 0:
                    buckets[donor] -= take
                    buckets[bucket] += take
                    joined -= take
                    if bucket == "comm_skew":
                        skew_moved += take
        # the per-axis view of the same move: pod skew reclassifies
        # each axis's wire share proportionally (no axis-resolved skew
        # measurement exists — blame follows the wire it delayed), so
        # the axis sums still equal the comm_wire/comm_skew buckets
        comm_axes: Dict[str, Dict[str, float]] = {}
        wire_total = sum(axis_wire.values())
        for ax, ms in axis_wire.items():
            share = (skew_moved * ms / wire_total) if wire_total else 0.0
            comm_axes[ax] = {"wire": ms - share, "skew": share}
        rec = StepLedger(st.step, wall, buckets, comm_axes)
        self.steps.append(rec)
        if len(self.steps) > self.max_steps:
            del self.steps[:len(self.steps) - self.max_steps]
        gf = rec.goodput_frac
        if gf is not None:
            self._frac.append(gf)
        ev = rec.to_event(self.rank)
        for fn in list(self._on_step):
            try:
                fn(dict(ev))
            except Exception:
                pass          # observers never break the train loop

    # -- reports --------------------------------------------------------------

    def rolling_goodput(self) -> Optional[float]:
        """Mean goodput fraction over the last ``window`` steps."""
        if not self._frac:
            return None
        return sum(self._frac) / len(self._frac)

    def check_closure(self, tolerance: Optional[float] = None,
                      skip_first: int = 0) -> Tuple[bool, float]:
        """(ok, worst_error): does every retained step's bucket sum
        close over its measured wall time within ``tolerance``?
        ``skip_first`` excludes warmup steps (step 0 folds the trace +
        compile; its compile span is back-dated into the step but the
        closure there is still exact — the knob exists for callers
        whose warmup spans *straddle* the step boundary)."""
        tol = self.tolerance if tolerance is None else float(tolerance)
        worst = 0.0
        for rec in self.steps[skip_first:]:
            worst = max(worst, rec.closure_error())
        return worst <= tol, worst

    def to_events(self, rank: Optional[int] = None) -> List[Dict]:
        """``kind="goodput"`` events for every retained step."""
        r = self.rank if rank is None else rank
        return [rec.to_event(r) for rec in self.steps]

    def totals(self) -> Dict[str, float]:
        """Summed per-bucket milliseconds over the retained ledger."""
        out = {b: 0.0 for b in BUCKETS}
        for rec in self.steps:
            for b, v in rec.buckets.items():
                out[b] += v
        return out

    def comm_axes_totals(self) -> Dict[str, Dict[str, float]]:
        """Summed per-axis exposed-comm milliseconds over the retained
        ledger: ``{axis: {"wire": ms, "skew": ms}}`` — the "zero axis
        cost 0.8 ms exposed, dp axis 0.3 ms" rollup."""
        out: Dict[str, Dict[str, float]] = {}
        for rec in self.steps:
            for ax, parts in rec.comm_axes_ms.items():
                slot = out.setdefault(ax, {"wire": 0.0, "skew": 0.0})
                for k, v in parts.items():
                    slot[k] = slot.get(k, 0.0) + v
        return out

    def table(self, width: int = 10) -> str:
        """Aligned per-step ledger: wall, every bucket, goodput%."""
        heads = ["step", "wall_ms"] + list(BUCKETS) + ["goodput"]
        lines = [" ".join(h[-width:].rjust(width) for h in heads)]
        for rec in self.steps:
            gf = rec.goodput_frac
            row = [str(rec.step if rec.step is not None else "-"),
                   f"{rec.wall_ms:.2f}"]
            row += [f"{rec.buckets[b]:.2f}" for b in BUCKETS]
            row.append(f"{gf:.1%}" if gf is not None else "n/a")
            lines.append(" ".join(v.rjust(width) for v in row))
        tot = self.totals()
        wall = sum(r.wall_ms for r in self.steps)
        row = ["total", f"{wall:.2f}"]
        row += [f"{tot[b]:.2f}" for b in BUCKETS]
        rg = self.rolling_goodput()
        row.append(f"{rg:.1%}" if rg is not None else "n/a")
        lines.append(" ".join(v.rjust(width) for v in row))
        axes = self.comm_axes_totals()
        if axes:
            lines.append("exposed comm by axis: " + "  ".join(
                f"{ax} wire {p['wire']:.2f} skew {p['skew']:.2f}"
                for ax, p in sorted(axes.items())))
        return "\n".join(lines)
