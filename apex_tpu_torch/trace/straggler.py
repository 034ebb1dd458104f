"""Cross-rank straggler detection from shared-filesystem heartbeats.

The port of ``apex_tpu/trace/straggler.py``; the files are the JAX
package's, read and written interchangeably. The hang watchdog
(:mod:`apex_tpu_torch.trace.watchdog`) catches the binary failure — no
step for ``deadline_s`` — but one rank 30% slower than its peers gates
every collective at its pace and nothing raises. This module is the
early-warning tier below the hard stall deadline:

- each rank appends one JSON line per finished step to its own file
  ``hb.rank{r:05d}.jsonl`` under a shared directory
  (:class:`HeartbeatWriter`; records ``{"step", "rank", "wall_time",
  "dur_ms", "spans", "generation"}``), retrying transient IO errors
  through the jittered :func:`apex_tpu_torch.utils.backoff.backoff_sleep`;
- a **lockstep reader** (:class:`StragglerDetector`) aligns the ranks'
  heartbeats by step and, per common step, computes each rank's
  step-duration lag against the median rank (each host's own clock, so
  a constant cross-host clock offset cancels); a rank is a *persistent
  laggard* when its robust z-score (``lag / (1.4826·MAD + floor)``)
  exceeds the threshold for ``hysteresis`` consecutive newest steps;
- a flagged report names **the slowest span class on the lagging rank**
  from its own heartbeat's span breakdown;
- :class:`StragglerWatch` polls the detector on a daemon thread and
  feeds :meth:`apex_tpu_torch.trace.HangWatchdog.early_warning`.

:func:`read_heartbeats` (torn-tail tolerant, optionally scoped to one
cluster generation) and :func:`gc_stale_heartbeats` (the relaunch
hygiene pass ``cluster.ClusterMembership.gc_stale(heartbeat_dir=)``
runs) are the file helpers. Events are ``kind="straggler"`` JSONL on the
goodput channel (``MetricsLogger(goodput_sink=...)``;
``scripts/check_metrics_schema.py --kind goodput`` validates)::

    tracer = trace.Tracer()
    hb = trace.HeartbeatWriter(shared_dir)     # rank-inferred
    tracer.subscribe(hb.on_step)
    # rank 0 (or a sidecar) additionally reads:
    det = trace.StragglerDetector(shared_dir)
    watch = trace.StragglerWatch(det, watchdog=wd,
                                 event_sink=logger.record_goodput)
    watch.start()
"""

from __future__ import annotations

import dataclasses
import os
import json
import threading
import time
from typing import Callable, Dict, List, Optional

from apex_tpu_torch.utils.backoff import backoff_sleep
from apex_tpu_torch.utils.ranks import rank_default

__all__ = ["HB_PREFIX", "heartbeat_path", "read_heartbeats",
           "gc_stale_heartbeats", "HeartbeatWriter", "StragglerDetector",
           "StragglerReport", "StragglerWatch"]

#: heartbeat file name prefix (``hb.rank00003.jsonl``)
HB_PREFIX = "hb.rank"


def heartbeat_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"{HB_PREFIX}{rank:05d}.jsonl")


class HeartbeatWriter:
    """Append one heartbeat line per finished step to this rank's file.

    Subscribe :meth:`on_step` to a Tracer (or call :meth:`beat`
    manually). Each record is ``{"step", "rank", "wall_time",
    "dur_ms", "spans": {name: ms}}`` — small enough that a per-step
    append on a shared fs is noise next to the step itself. Appends
    retry ``attempts`` times through the shared jittered backoff and
    then drop the beat (a lost heartbeat must never break the train
    loop — the reader treats a silent rank as the watchdog's problem,
    not this tier's)."""

    def __init__(self, directory: str, rank: Optional[int] = None, *,
                 attempts: int = 3, generation: Optional[int] = None):
        self.rank = rank_default() if rank is None else int(rank)
        self.directory = directory
        self.attempts = max(int(attempts), 1)
        #: cluster-epoch fence token stamped on every beat (see
        #: apex_tpu_torch.cluster): a reader scoped to the current generation
        #: ignores a dead previous attempt's records instead of
        #: mistaking them for a silent rank. None = untagged (treated
        #: as generation 0 by generation-scoped readers).
        self.generation = generation
        os.makedirs(directory, exist_ok=True)
        self.path = heartbeat_path(directory, self.rank)
        self.n_written = 0
        self.n_dropped = 0

    def set_generation(self, generation: Optional[int]) -> None:
        """Re-tag after a coordinated bump (survivors keep their writer
        across the epoch change)."""
        self.generation = generation

    def on_step(self, st) -> None:
        """Tracer subscriber (:class:`~apex_tpu_torch.trace.StepTrace`)."""
        spans: Dict[str, float] = {}
        for s in st.spans:
            spans[s.name] = spans.get(s.name, 0.0) + s.dur_ms
        self.beat(st.step, dur_ms=st.dur_ms, spans=spans)

    def beat(self, step: Optional[int], *, dur_ms: Optional[float] = None,
             spans: Optional[Dict[str, float]] = None,
             wall_time: Optional[float] = None) -> bool:
        rec = {"step": step, "rank": self.rank,
               "wall_time": time.time() if wall_time is None else wall_time,
               "dur_ms": round(dur_ms, 4) if dur_ms is not None else None,
               "spans": {k: round(v, 4)
                         for k, v in (spans or {}).items()}}
        if self.generation is not None:
            rec["generation"] = int(self.generation)
        line = json.dumps(rec) + "\n"
        for attempt in range(self.attempts):
            try:
                with open(self.path, "a") as f:
                    f.write(line)
                self.n_written += 1
                return True
            except OSError:
                if attempt + 1 < self.attempts:
                    backoff_sleep(attempt, cap_s=0.2)
        self.n_dropped += 1
        return False


def read_heartbeats(directory: str, *,
                    generation: Optional[int] = None
                    ) -> Dict[int, Dict[int, Dict]]:
    """``{rank: {step: record}}`` over every rank file present.

    Malformed lines (a reader racing a writer's partial append) are
    skipped; a later complete record for the same step wins.

    ``generation`` scopes the read to one cluster epoch: records whose
    ``generation`` tag differs (untagged records count as generation 0)
    are ignored, and a rank whose file carries NO current-generation
    records is omitted entirely — a dead previous attempt's heartbeats
    must not read as a live-but-silent rank of the new epoch (the
    exact bug an ``elastic_run`` restart over stale files exhibits).
    """
    out: Dict[int, Dict[int, Dict]] = {}
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        if not (name.startswith(HB_PREFIX) and name.endswith(".jsonl")):
            continue
        try:
            rank = int(name[len(HB_PREFIX):-len(".jsonl")])
        except ValueError:
            continue
        per: Dict[int, Dict] = {}
        try:
            with open(os.path.join(directory, name)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue           # torn tail of a live append
                    if generation is not None:
                        g = rec.get("generation")
                        g = g if isinstance(g, int) else 0
                        if g != int(generation):
                            continue       # another epoch's record
                    step = rec.get("step")
                    if isinstance(step, int):
                        per[step] = rec
        except OSError:
            continue
        if per:
            out[rank] = per
    return out


def gc_stale_heartbeats(directory: str,
                        current_generation: int) -> List[str]:
    """Delete heartbeat files whose NEWEST record belongs to an older
    generation — the ``elastic_run`` relaunch hygiene pass (see
    :func:`apex_tpu_torch.cluster.relaunch`): without it, a rank that died
    in generation N leaves a file whose last beat reads as a "silent
    rank" to every future detector poll. A file carrying any
    current-generation record is kept (a survivor's history is still
    its history). Returns removed paths."""
    removed: List[str] = []
    cur = int(current_generation)
    for rank, per in read_heartbeats(directory).items():
        # one read serves both questions (a second generation-scoped
        # pass would double the shared-fs traffic of the restart path)
        if any((rec.get("generation") if isinstance(
                rec.get("generation"), int) else 0) == cur
               for rec in per.values()):
            continue               # a survivor's history stays
        p = heartbeat_path(directory, rank)
        try:
            os.remove(p)
            removed.append(p)
        except OSError:
            pass
    return removed


@dataclasses.dataclass
class StragglerReport:
    """One persistent laggard: who, how far behind, and where it
    spends the time."""

    rank: int
    step: int                     # newest common step analyzed
    lag_ms: float                 # arrival lag vs the median rank
    z: float                      # robust z-score of that lag
    consecutive: int              # flagged steps in a row (newest back)
    slowest_span: Optional[str]   # largest span on the laggard's beat
    span_class: Optional[str]     # its goodput bucket (classify_span)
    slowest_span_ms: Optional[float]
    n_ranks: int

    def to_event(self) -> Dict:
        return {"kind": "straggler", "step": self.step, "rank": self.rank,
                "lag_ms": round(self.lag_ms, 4), "z": round(self.z, 4),
                "consecutive": self.consecutive,
                "slowest_span": self.slowest_span,
                "span_class": self.span_class,
                "slowest_span_ms": (round(self.slowest_span_ms, 4)
                                    if self.slowest_span_ms is not None
                                    else None),
                "n_ranks": self.n_ranks, "wall_time": time.time()}


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


class StragglerDetector:
    """Lockstep reader over the heartbeat directory.

    Per common step each rank's **step duration** (the host-measured
    ``dur_ms`` in its heartbeat) is compared against the median rank:
    ``lag = dur_rank − median(dur)``, ``z = lag / (1.4826·MAD +
    lag_floor_ms)`` (MAD over the ranks' lags; the floor keeps tightly
    synchronized meshes from flagging microsecond jitter — the same
    denominator-regularization recipe as the guard's spike detector).
    Durations are measured by each host's own monotonic clock, so a
    constant cross-host wall-clock offset — indistinguishable from a
    laggard if arrival times were compared — cancels entirely; the
    ``wall_time`` arrival comparison is only the fallback for beats
    that carry no ``dur_ms``. A rank is reported only after
    ``hysteresis`` consecutive newest steps above ``z_threshold`` AND
    ``lag_floor_ms`` of absolute lag — statistically slow but cheap is
    not actionable."""

    def __init__(self, directory: str, *, window: int = 16,
                 z_threshold: float = 4.0, hysteresis: int = 3,
                 lag_floor_ms: float = 1.0, min_ranks: int = 2,
                 generation: Optional[int] = None):
        self.directory = directory
        self.window = max(int(window), 1)
        self.z_threshold = float(z_threshold)
        self.hysteresis = max(int(hysteresis), 1)
        self.lag_floor_ms = float(lag_floor_ms)
        self.min_ranks = max(int(min_ranks), 2)
        #: when set, only heartbeats of this cluster epoch are judged —
        #: a dead previous attempt's records neither flag laggards nor
        #: read as silent ranks (pass the current generation after an
        #: elastic relaunch; see apex_tpu_torch.cluster)
        self.generation = generation

    def check(self) -> List[StragglerReport]:
        """Read every rank's heartbeats and report persistent laggards
        (empty = healthy, or not enough ranks/steps to judge)."""
        beats = read_heartbeats(self.directory,
                                generation=self.generation)
        if len(beats) < self.min_ranks:
            return []
        common = set.intersection(*(set(per) for per in beats.values()))
        if not common:
            return []
        steps = sorted(common)[-self.window:]
        ranks = sorted(beats)
        # per analyzed step: {rank: (lag_ms, z)}
        lag_z: List[Dict[int, tuple]] = []
        for step in steps:
            # step durations, each measured by its own host's clock —
            # immune to cross-host wall-clock offset
            vals = {r: beats[r][step].get("dur_ms") for r in ranks}
            if any(not isinstance(v, (int, float))
                   for v in vals.values()):
                # fallback: arrival wall times (clock-skew-sensitive;
                # only for heartbeats written without a duration)
                ts = {r: beats[r][step].get("wall_time") for r in ranks}
                if any(not isinstance(t, (int, float))
                       for t in ts.values()):
                    continue
                vals = {r: t * 1e3 for r, t in ts.items()}
            med = _median(list(vals.values()))
            lags = {r: v - med for r, v in vals.items()}
            mad = _median([abs(l) for l in lags.values()])
            denom = 1.4826 * mad + self.lag_floor_ms
            lag_z.append({r: (lags[r], lags[r] / denom) for r in ranks})
        if not lag_z:
            return []
        out: List[StragglerReport] = []
        newest = steps[-1]
        for r in ranks:
            consecutive = 0
            for per_step in reversed(lag_z):
                lag, z = per_step[r]
                if z > self.z_threshold and lag > self.lag_floor_ms:
                    consecutive += 1
                else:
                    break
            if consecutive < self.hysteresis:
                continue
            lag, z = lag_z[-1][r]
            spans = beats[r][newest].get("spans") or {}
            slowest = max(spans, key=spans.get) if spans else None
            from apex_tpu_torch.monitor.goodput import classify_span
            out.append(StragglerReport(
                rank=r, step=newest, lag_ms=lag, z=z,
                consecutive=consecutive, slowest_span=slowest,
                span_class=(classify_span(slowest)
                            if slowest is not None else None),
                slowest_span_ms=(spans[slowest]
                                 if slowest is not None else None),
                n_ranks=len(ranks)))
        return out


class StragglerWatch:
    """Daemon-thread poller: detector → events + watchdog early warning.

    Every ``poll_s`` it runs :meth:`StragglerDetector.check`; each
    report is emitted through ``event_sink`` (wire
    ``MetricsLogger.record_goodput``) and handed to the watchdog's
    :meth:`~apex_tpu_torch.trace.HangWatchdog.early_warning` — alerting tier
    only, never the escalation path (``on_stall`` stays the hard
    deadline's). Re-reports a still-lagging rank at most once per
    ``renotify_s``. ``recorder`` additionally feeds every report to
    :meth:`apex_tpu_torch.trace.FlightRecorder.note_straggler`, so a later
    crash dump's header names the rank (and span) the pod was already
    waiting on — the renotify debounce does NOT apply there: the ring
    is bounded and forensics want the freshest picture."""

    def __init__(self, detector: StragglerDetector, *,
                 poll_s: float = 5.0, watchdog=None,
                 event_sink: Optional[Callable[[Dict], None]] = None,
                 renotify_s: float = 60.0, recorder=None):
        self.detector = detector
        self.poll_s = float(poll_s)
        self.watchdog = watchdog
        self.event_sink = event_sink
        self.recorder = recorder
        self.renotify_s = float(renotify_s)
        self._last_notified: Dict[int, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.flag_count = 0

    def poll_once(self) -> List[StragglerReport]:
        reports = self.detector.check()
        now = time.monotonic()
        for rep in reports:
            if self.recorder is not None:
                # undebounced: the crash-header ring wants every fresh
                # report, not one per renotify window
                self.recorder.note_straggler(rep.to_event())
            last = self._last_notified.get(rep.rank)
            if last is not None and now - last < self.renotify_s:
                continue
            self._last_notified[rep.rank] = now
            self.flag_count += 1
            ev = rep.to_event()
            if self.event_sink is not None:
                try:
                    self.event_sink(dict(ev))
                except Exception:
                    pass
            if self.watchdog is not None:
                self.watchdog.early_warning(ev)
        return reports

    def start(self) -> "StragglerWatch":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="apex_tpu_torch.trace.straggler",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(self.poll_s * 2, 1.0))
        self._thread = None

    def __enter__(self) -> "StragglerWatch":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:
                pass          # a broken poll must not kill the daemon
