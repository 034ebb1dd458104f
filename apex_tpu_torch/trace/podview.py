"""Pod observatory: merge N ranks' span timelines into one pod view.

The port's copy of ``apex_tpu/trace/podview.py`` (pure Python over
``kind="span"`` events, identical in both packages).

Every other telemetry layer is per-rank: the goodput ledger attributes
one process's wall clock, the flight recorder dumps one rank's ring,
and the straggler detector sees only heartbeat lag. This module joins
the ranks' ``kind="span"`` JSONL streams (each on its own arbitrary
``perf_counter`` origin) into one :class:`PodTimeline` and answers the
two questions a per-rank view structurally cannot:

- **who made the pod wait** — for every collective instance, how much
  of its time was *wait-for-laggard* (entry skew, charged to the last
  arriver and the host span it was running) versus *wire time*
  (last-entry → exit);
- **is the link model stale** — the measured wire times are the join
  key :func:`apex_tpu_torch.monitor.comm_drift.wire_from_pod` compares
  against ``CommPlan.hop_seconds``.

**Clock alignment contract.** Ranks share no clock; what they share is
that a blocking collective's *exit* is simultaneous across its
participants up to the collective latency α. Collective spans are
matched across ranks by ``(step, name, occurrence-within-step)`` —
stable under out-of-order arrival because occurrences are renumbered in
local-time order — and the per-rank offsets minimize the squared
spread of matched exit times (:func:`align_clocks`): a bipartite least
squares solved by alternating the consensus exit per collective and
the offset per rank, gauged so the reference rank's offset is zero.
``fit_drift=True`` additionally fits a per-rank linear clock *rate*
term (crystals on different hosts genuinely tick at slightly different
rates over a long run). A rank that shares no collective with the rest
cannot be aligned — it merges at offset 0 with ``aligned=False``
rather than silently pretending; a single-rank merge is the degenerate
identity. The residual RMS per rank states how well the model fits —
on a real pod it is bounded below by α, so treat sub-α blame deltas
as noise.

**Blame semantics.** For one matched collective instance, on the
aligned clock: ``skew_ms = last entry − first entry`` (the pod-wide
wait the laggard caused), ``wire_ms = exit − last entry`` (the time
the fabric actually took once everyone arrived). The blame lands on
the last-arriving rank AND the deepest non-collective span that rank
was still running when the others were already waiting — "rank 2 held
bucket00/dcn for 40 ms finishing ``data/load``" is actionable, "the
collective was slow" is not. :meth:`PodTimeline.critical_path` chains
those records per step: the sequence of (laggard rank, blamed span)
waits plus wire segments that actually determined step wall time.

Outputs: merged Perfetto-loadable Chrome trace with per-rank
``process_name`` metadata (:meth:`PodTimeline.chrome_trace`),
``kind="pod_align"`` / ``kind="pod_skew"`` events for the ``podview``
metrics channel (``MetricsLogger(podview_sink=...)``;
``scripts/check_metrics_schema.py --kind podview`` validates), and
per-(rank, step) skew milliseconds for the goodput ledger's
``comm_skew``/``comm_wire`` split
(:meth:`PodTimeline.rank_step_skew` →
:meth:`apex_tpu_torch.monitor.GoodputLedger.note_pod_skew`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["PodSpan", "RankTimeline", "RankClock", "ClockAlignment",
           "CollectiveSkew", "PodTimeline", "align_clocks",
           "load_span_events"]


class PodSpan:
    """One span occurrence on one rank, on that rank's LOCAL clock
    (milliseconds since its tracer's origin) until aligned."""

    __slots__ = ("name", "kind", "step", "rank", "t_ms", "dur_ms",
                 "depth", "aborted")

    def __init__(self, name: str, kind: str, step: Optional[int],
                 rank: int, t_ms: float, dur_ms: float, depth: int = 0,
                 aborted: bool = False):
        self.name = name
        self.kind = kind
        self.step = step
        self.rank = rank
        self.t_ms = t_ms
        self.dur_ms = dur_ms
        self.depth = depth
        self.aborted = aborted

    @property
    def end_ms(self) -> float:
        return self.t_ms + self.dur_ms

    @classmethod
    def from_event(cls, ev: Dict) -> "PodSpan":
        return cls(name=ev["name"], kind=ev.get("span_kind", "span"),
                   step=ev.get("step"), rank=int(ev.get("rank", 0)),
                   t_ms=float(ev["t_ms"]), dur_ms=float(ev["dur_ms"]),
                   depth=int(ev.get("depth", 0)),
                   aborted=bool(ev.get("aborted", False)))


def load_span_events(events: Iterable) -> Dict[int, "RankTimeline"]:
    """``{rank: RankTimeline}`` from a mixed event stream — dicts
    (``kind="span"`` kept, everything else skipped), JSON lines, or an
    open file. The one loader the audit and offline tooling share."""
    per: Dict[int, List[PodSpan]] = {}
    for ev in events:
        if isinstance(ev, str):
            ev = ev.strip()
            if not ev:
                continue
            try:
                ev = json.loads(ev)
            except ValueError:
                continue          # torn tail of a live append
        if not isinstance(ev, dict) or ev.get("kind") != "span":
            continue
        s = PodSpan.from_event(ev)
        per.setdefault(s.rank, []).append(s)
    return {r: RankTimeline(r, spans) for r, spans in per.items()}


class RankTimeline:
    """One rank's spans, sorted into local-time order (out-of-order
    arrival — a late-flushed JSONL segment — is harmless: matching
    keys on occurrence index within the sorted order)."""

    def __init__(self, rank: int, spans: Sequence[PodSpan]):
        self.rank = rank
        self.spans: List[PodSpan] = sorted(
            spans, key=lambda s: (s.step if s.step is not None else -1,
                                  s.t_ms))

    def collectives(self) -> Dict[Tuple, PodSpan]:
        """``{(step, name, occurrence): span}`` over the completed
        ``kind="collective"`` spans — the cross-rank match keys."""
        out: Dict[Tuple, PodSpan] = {}
        counts: Dict[Tuple, int] = {}
        for s in self.spans:
            if s.kind != "collective" or s.aborted:
                continue
            base = (s.step, s.name)
            occ = counts.get(base, 0)
            counts[base] = occ + 1
            out[(s.step, s.name, occ)] = s
        return out


@dataclasses.dataclass
class RankClock:
    """One rank's clock model: ``aligned(t) = t + offset_ms +
    drift · (t − t_ref_ms)``."""

    rank: int
    offset_ms: float = 0.0
    drift: float = 0.0            # dimensionless rate error (s/s)
    t_ref_ms: float = 0.0
    residual_ms: Optional[float] = None  # RMS misfit over its matches
    n_shared: int = 0             # matched collective instances
    aligned: bool = False

    def align(self, t_ms: float) -> float:
        return t_ms + self.offset_ms + self.drift * (t_ms - self.t_ref_ms)


class ClockAlignment:
    """The fitted per-rank clock models + the reference-rank gauge."""

    def __init__(self, clocks: Dict[int, RankClock], reference: int):
        self.clocks = clocks
        self.reference = reference

    def align(self, rank: int, t_ms: float) -> float:
        clock = self.clocks.get(rank)
        return t_ms if clock is None else clock.align(t_ms)

    def to_events(self, wall_time: Optional[float] = None) -> List[Dict]:
        """One ``kind="pod_align"`` event per rank (podview channel)."""
        wt = time.time() if wall_time is None else wall_time
        out = []
        for r in sorted(self.clocks):
            c = self.clocks[r]
            out.append({
                "kind": "pod_align", "rank": r,
                "offset_ms": round(c.offset_ms, 4),
                "drift_ppm": round(c.drift * 1e6, 4),
                "residual_ms": (round(c.residual_ms, 4)
                                if c.residual_ms is not None else None),
                "n_shared": c.n_shared, "aligned": c.aligned,
                "reference": self.reference, "wall_time": wt})
        return out


def _fit_rank(points: List[Tuple[float, float]], t_ref: float,
              fit_drift: bool) -> Tuple[float, float]:
    """(offset, drift) minimizing Σ (offset + drift·(e−t_ref) − y)²
    over points (e, y). Closed form; drift needs ≥ 3 points spanning
    some time (a degenerate spread falls back to offset-only)."""
    n = len(points)
    ys = [y for _, y in points]
    if not fit_drift or n < 3:
        return sum(ys) / n, 0.0
    xs = [e - t_ref for e, _ in points]
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    if sxx < 1e-9:
        return my, 0.0
    sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    drift = sxy / sxx
    return my - drift * mx, drift


def align_clocks(timelines: Dict[int, RankTimeline], *,
                 reference: Optional[int] = None,
                 fit_drift: bool = False, iters: int = 60,
                 tol_ms: float = 1e-7) -> ClockAlignment:
    """Fit per-rank clock offsets (and optional drift) from shared
    collective exits. See the module docstring for the contract; the
    solver is alternating least squares — exact for the offset-only
    bipartite problem, and the drift refit reuses the same loop."""
    coll = {r: tl.collectives() for r, tl in timelines.items()}
    # keys observed on >= 2 ranks constrain the fit; exits per key
    shared: Dict[Tuple, Dict[int, float]] = {}
    for r, per in coll.items():
        for key, s in per.items():
            shared.setdefault(key, {})[r] = s.end_ms
    shared = {k: v for k, v in shared.items() if len(v) >= 2}

    n_shared = {r: sum(1 for v in shared.values() if r in v)
                for r in timelines}
    constrained = [r for r in sorted(timelines) if n_shared[r] > 0]
    if reference is None:
        reference = (constrained[0] if constrained
                     else min(timelines) if timelines else 0)
    all_exits = [e for v in shared.values() for e in v.values()]
    t_ref = sum(all_exits) / len(all_exits) if all_exits else 0.0

    clocks = {r: RankClock(rank=r, t_ref_ms=t_ref,
                           n_shared=n_shared.get(r, 0))
              for r in timelines}
    for _ in range(max(int(iters), 1)):
        consensus = {key: sum(clocks[r].align(e) for r, e in v.items())
                     / len(v) for key, v in shared.items()}
        worst = 0.0
        for r in constrained:
            pts = [(e, consensus[key] - e)
                   for key, v in shared.items()
                   for rr, e in v.items() if rr == r]
            off, drift = _fit_rank(pts, t_ref, fit_drift)
            worst = max(worst, abs(off - clocks[r].offset_ms))
            clocks[r].offset_ms, clocks[r].drift = off, drift
        # gauge: the reference rank's model is the identity (without
        # this the whole pod's clock floats freely between iterations)
        ref = clocks[reference]
        g_off, g_drift = ref.offset_ms, ref.drift
        for r in constrained:
            c = clocks[r]
            c.offset_ms -= g_off
            c.drift -= g_drift
        if worst < tol_ms:
            break

    consensus = {key: sum(clocks[r].align(e) for r, e in v.items())
                 / len(v) for key, v in shared.items()}
    for r, c in clocks.items():
        res = [(consensus[key] - c.align(e)) ** 2
               for key, v in shared.items()
               for rr, e in v.items() if rr == r]
        if res:
            c.residual_ms = (sum(res) / len(res)) ** 0.5
        # the reference is aligned by definition (single-rank merges
        # included); everyone else needs at least one shared collective
        c.aligned = (r == reference) or c.n_shared > 0
    return ClockAlignment(clocks, reference)


@dataclasses.dataclass
class CollectiveSkew:
    """One matched collective instance, split on the aligned clock:
    wait-for-laggard (``skew_ms``, blamed) vs wire (``wire_ms``)."""

    step: Optional[int]
    name: str
    occurrence: int
    n_ranks: int
    entries: Dict[int, float]     # {rank: aligned entry ms}
    exit_ms: float                # aligned consensus exit
    skew_ms: float                # last entry − first entry
    wire_ms: float                # exit − last entry (clamped ≥ 0)
    blamed_rank: Optional[int]    # the last arriver
    blamed_span: Optional[str]    # what it was running meanwhile

    def to_event(self, wall_time: Optional[float] = None) -> Dict:
        return {"kind": "pod_skew", "step": self.step, "name": self.name,
                "occurrence": self.occurrence, "n_ranks": self.n_ranks,
                "skew_ms": round(self.skew_ms, 4),
                "wire_ms": round(self.wire_ms, 4),
                "blamed_rank": self.blamed_rank,
                "blamed_span": self.blamed_span,
                "wall_time": (time.time() if wall_time is None
                              else wall_time)}


class PodTimeline:
    """N ranks' span timelines on one aligned clock.

    Build with :meth:`merge` from the ranks' ``kind="span"`` event
    streams (``Tracer.span_events`` per rank, however they were
    shipped). Everything downstream — skew blame, critical path, the
    merged Chrome trace, the podview events — reads aligned times.
    """

    def __init__(self, timelines: Dict[int, RankTimeline],
                 alignment: ClockAlignment):
        self.timelines = timelines
        self.alignment = alignment
        self.ranks = sorted(timelines)

    @classmethod
    def merge(cls, events, *, reference: Optional[int] = None,
              fit_drift: bool = False) -> "PodTimeline":
        """Merge a flat event iterable (or ``{rank: events}`` dict)
        into one aligned timeline."""
        if isinstance(events, dict):
            flat: List = []
            for evs in events.values():
                flat.extend(evs)
            events = flat
        timelines = load_span_events(events)
        return cls(timelines, align_clocks(timelines,
                                           reference=reference,
                                           fit_drift=fit_drift))

    def aligned(self, span: PodSpan) -> Tuple[float, float]:
        """(start_ms, end_ms) of one span on the pod clock."""
        a = self.alignment
        return (a.align(span.rank, span.t_ms),
                a.align(span.rank, span.end_ms))

    # -- blame ----------------------------------------------------------------

    def _blame_span(self, rank: int, step: Optional[int],
                    lo: float, hi: float) -> Optional[str]:
        """The deepest non-collective span ``rank`` was running inside
        the wait window [lo, hi) — what the pod was actually waiting
        on. Ties go to the latest-started (the innermost entered)."""
        tl = self.timelines.get(rank)
        if tl is None or hi <= lo:
            return None
        best, best_key = None, None
        for s in tl.spans:
            if s.step != step or s.kind == "collective":
                continue
            t0, t1 = self.aligned(s)
            if t0 < hi and t1 > lo:
                key = (s.depth, t0)
                if best_key is None or key > best_key:
                    best, best_key = s.name, key
        return best

    def collective_skew(self) -> List[CollectiveSkew]:
        """Every matched collective instance's skew/wire split, in
        aligned-time order."""
        shared: Dict[Tuple, Dict[int, PodSpan]] = {}
        for r, tl in self.timelines.items():
            for key, s in tl.collectives().items():
                shared.setdefault(key, {})[r] = s
        out: List[CollectiveSkew] = []
        for key, per in shared.items():
            if len(per) < 2:
                continue
            step, name, occ = key
            entries = {r: self.aligned(s)[0] for r, s in per.items()}
            exits = [self.aligned(s)[1] for s in per.values()]
            exit_ms = sum(exits) / len(exits)
            first = min(entries.values())
            last_rank = max(entries, key=entries.get)
            last = entries[last_rank]
            out.append(CollectiveSkew(
                step=step, name=name, occurrence=occ, n_ranks=len(per),
                entries=entries, exit_ms=exit_ms,
                skew_ms=last - first,
                wire_ms=max(exit_ms - last, 0.0),
                blamed_rank=last_rank,
                blamed_span=self._blame_span(last_rank, step,
                                             first, last)))
        out.sort(key=lambda c: (c.step if c.step is not None else -1,
                                min(c.entries.values())))
        return out

    def rank_step_skew(self) -> Dict[Tuple[int, Optional[int]], float]:
        """``{(rank, step): ms}`` each rank spent waiting for laggards
        inside collectives — per collective, rank r waited
        ``last_entry − entry_r``. This is the pod-measured join the
        goodput ledger's ``comm_wire → comm_skew`` move consumes
        (:meth:`apex_tpu_torch.monitor.GoodputLedger.note_pod_skew`)."""
        out: Dict[Tuple[int, Optional[int]], float] = {}
        for c in self.collective_skew():
            last = max(c.entries.values())
            for r, entry in c.entries.items():
                wait = last - entry
                if wait > 0:
                    k = (r, c.step)
                    out[k] = out.get(k, 0.0) + wait
        return out

    def critical_path(self, step: Optional[int] = None) -> List[Dict]:
        """The per-step cross-rank critical chain: collectives in
        aligned order, each contributing its wire segment plus the
        wait segment charged to (laggard rank, blamed span). The
        chain's segments are what actually determined step wall time —
        compute that overlapped another rank's wait never appears."""
        segs: List[Dict] = []
        for c in self.collective_skew():
            if step is not None and c.step != step:
                continue
            if c.skew_ms > 0:
                segs.append({"segment": "wait", "step": c.step,
                             "collective": c.name,
                             "occurrence": c.occurrence,
                             "rank": c.blamed_rank,
                             "span": c.blamed_span,
                             "dur_ms": round(c.skew_ms, 4)})
            segs.append({"segment": "wire", "step": c.step,
                         "collective": c.name,
                         "occurrence": c.occurrence,
                         "rank": None, "span": None,
                         "dur_ms": round(c.wire_ms, 4)})
        return segs

    # -- exports --------------------------------------------------------------

    def to_events(self, wall_time: Optional[float] = None) -> List[Dict]:
        """``pod_align`` + ``pod_skew`` events for the podview channel
        (``MetricsLogger(podview_sink=...).record_podview``)."""
        wt = time.time() if wall_time is None else wall_time
        return (self.alignment.to_events(wall_time=wt)
                + [c.to_event(wall_time=wt)
                   for c in self.collective_skew()])

    def chrome_trace(self) -> Dict:
        """One merged Chrome-trace dict, all ranks on the aligned
        clock, with per-rank ``process_name``/``process_sort_index``
        metadata so Perfetto renders labeled "rank N" tracks instead
        of anonymous colliding pids."""
        events: List[Dict] = []
        for r in self.ranks:
            clock = self.alignment.clocks.get(r)
            label = f"rank {r}" if clock is None or clock.aligned \
                else f"rank {r} (unaligned)"
            events += [
                {"name": "process_name", "ph": "M", "pid": r, "tid": 0,
                 "args": {"name": label}},
                {"name": "process_sort_index", "ph": "M", "pid": r,
                 "tid": 0, "args": {"sort_index": r}},
            ]
            for s in self.timelines[r].spans:
                t0, _ = self.aligned(s)
                events.append({
                    "name": s.name, "ph": "X", "cat": s.kind,
                    "ts": t0 * 1e3, "dur": s.dur_ms * 1e3,
                    "pid": r, "tid": 1 + s.depth,
                    "args": {"step": s.step}})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metadata": {"producer": "apex_tpu_torch.trace.podview",
                             "reference_rank": self.alignment.reference,
                             "ranks": self.ranks}}

    def write_chrome_trace(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path
