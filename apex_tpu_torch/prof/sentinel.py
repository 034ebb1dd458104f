"""Noise-aware perf-regression sentinel over bench JSON trajectories.

The port's copy of ``apex_tpu/prof/sentinel.py`` — pure Python, kept
equal to it so both give the same verdicts, fingerprints and events on
the same rows.

The repo accumulates one driver-captured bench row per round
(``BENCH_r01.json`` …) and, until now, a human eyeballed them. This
module is the automated gate: it extracts the perf-relevant columns
from each row (throughput, ms/step, MFU, peak HBM bytes, wire ratios,
goodput fraction, lint error counts, compile counts), builds a
**robust median/MAD baseline** per metric over the trajectory, and
judges the newest row with **direction-aware** thresholds — only the
degradation direction can regress (an MFU *gain* is never flagged), and
the threshold adapts to the trajectory's own noise:

    threshold = max(z · 1.4826 · MAD, rel_floor · |median|, abs_floor)

Rows without extractable metrics (a failed bench run commits its error
tail with ``"parsed": null``) are skipped with a note, never flagged —
a crashed bench is the driver's verdict to make, not this gate's; and
each metric needs ``min_history`` (default 2) prior finite values
before it can fire, so a brand-new column never false-positives on its
first appearance.

Accepted regressions are **waived** apexlint-style: a committed
``scripts/perf_baseline.json`` maps stable fingerprints
(``regress|<metric>``) to waiver entries, optionally carrying
``allow_to`` — the worst value the waiver covers, so a waived
regression that keeps degrading re-fires. The CLI is
``scripts/perf_sentinel.py`` (exit 1 on unwaived regression; run by
``run_tier1.sh --smoke`` over the committed trajectory, asserted with a
seeded-regression positive + no-change negative twin by
``scripts/roofline_audit.py --cpu8``). Events: ``kind="regress"``
through ``MetricsLogger(roofline_sink=…)``;
``check_metrics_schema.py --kind roofline`` validates.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["MetricSpec", "METRICS", "Verdict", "SentinelReport",
           "extract_metrics", "load_rows", "check_row",
           "check_trajectory", "load_baseline", "save_baseline",
           "metric_specs_from_baseline"]

#: degradation directions (the schema enum): "higher" = higher is
#: better (a drop regresses), "lower" = lower is better (a rise does)
DIRECTIONS = ("higher", "lower")


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One judged bench column."""

    name: str
    path: Tuple[str, ...]         # key path into the bench JSON row
    direction: str                # "higher" | "lower" (better)
    rel_floor: float = 0.05       # min relative degradation to flag
    z: float = 3.0                # MAD z-score threshold
    abs_floor: float = 0.0        # min absolute degradation to flag
    counter: bool = False         # integer count: ANY increase flags


#: the judged columns of a default ``bench.py`` row. ``ms_per_step`` is
#: derived (batch / img_s); counters (lint/compile error counts) flag on
#: any increase — their MAD is 0 by construction on a healthy repo.
METRICS: Tuple[MetricSpec, ...] = (
    MetricSpec("device_img_s", ("value",), "higher"),
    MetricSpec("ms_per_step", ("__ms_per_step__",), "lower"),
    MetricSpec("mfu", ("extra", "mfu"), "higher"),
    MetricSpec("peak_hbm_bytes", ("extra", "peak_hbm_bytes"), "lower",
               rel_floor=0.10),
    MetricSpec("wire_ratio_bf16",
               ("extra", "ddp_comm_modes", "modes", "bf16", "ratio"),
               "lower", rel_floor=0.02),
    MetricSpec("wire_ratio_int8",
               ("extra", "ddp_comm_modes", "modes", "int8", "ratio"),
               "lower", rel_floor=0.02),
    MetricSpec("goodput_frac", ("extra", "goodput_frac"), "higher",
               rel_floor=0.10),
    # the pod observatory columns (bench _pod_row; the merge/blame/
    # drift math behind them is asserted by scripts/pod_audit.py).
    # Floors are generous: skew gauges run-to-run jitter in single-ms,
    # and drift ratios on an emulated fabric swing with load
    MetricSpec("pod_goodput", ("extra", "pod_goodput"), "higher",
               rel_floor=0.10),
    MetricSpec("comm_skew_p99", ("extra", "comm_skew_p99"), "lower",
               rel_floor=0.50, abs_floor=5.0),
    MetricSpec("comm_drift_ratio", ("extra", "comm_drift_ratio"),
               "lower", rel_floor=0.50, abs_floor=2.0),
    MetricSpec("lint_errors", ("extra", "lint_errors"), "lower",
               counter=True),
    MetricSpec("lint_spmd_errors", ("extra", "lint_spmd_errors"),
               "lower", counter=True),
    MetricSpec("sentinel_regressions", ("extra", "sentinel_regressions"),
               "lower", counter=True),
    MetricSpec("n_compiles", ("extra", "n_compiles"), "lower",
               rel_floor=0.5),
)


def metric_specs_from_baseline(path_or_data) -> List[MetricSpec]:
    """Extra judged metrics declared in the committed perf-baseline
    file — the ``"metrics"`` list next to ``"waivers"``::

        {"metrics": [{"name": "ddp_wire_bytes",
                      "path": ["extra", "ddp_comm_modes", "modes",
                               "hier_int8", "wire_bytes"],
                      "direction": "lower", "rel_floor": 0.02,
                      "reason": "..."}], ...}

    A deployment (or a PR landing a new bench column) gates custom
    metrics without forking the METRICS table; the entries are
    direction-aware and waiverable exactly like the built-ins
    (fingerprint ``regress|<name>``). A missing file or section is
    empty; malformed entries raise — a silently-dropped gate is worse
    than a loud config error."""
    if isinstance(path_or_data, str):
        try:
            with open(path_or_data) as f:
                data = json.load(f)
        except OSError:
            return []
    else:
        data = path_or_data or {}
    out: List[MetricSpec] = []
    for i, entry in enumerate(data.get("metrics", []) or []):
        if not isinstance(entry, dict) or "name" not in entry \
                or "path" not in entry or "direction" not in entry:
            raise ValueError(
                f"metrics[{i}]: want {{name, path, direction}} "
                f"(+optional rel_floor/z/abs_floor/counter), got "
                f"{entry!r}")
        if entry["direction"] not in DIRECTIONS:
            raise ValueError(f"metrics[{i}]: direction must be one of "
                             f"{DIRECTIONS}, got "
                             f"{entry['direction']!r}")
        out.append(MetricSpec(
            name=str(entry["name"]),
            path=tuple(str(k) for k in entry["path"]),
            direction=entry["direction"],
            rel_floor=float(entry.get("rel_floor", 0.05)),
            z=float(entry.get("z", 3.0)),
            abs_floor=float(entry.get("abs_floor", 0.0)),
            counter=bool(entry.get("counter", False))))
    return out


def _get_path(row: Dict, path: Tuple[str, ...]) -> Optional[float]:
    cur: Any = row
    for key in path:
        if not isinstance(cur, dict) or key not in cur:
            return None
        cur = cur[key]
    if isinstance(cur, bool) or not isinstance(cur, (int, float)):
        return None
    return float(cur)


def extract_metrics(row: Optional[Dict],
                    specs: Sequence[MetricSpec] = METRICS
                    ) -> Dict[str, float]:
    """The judged metric values present in one bench JSON row
    (missing/null columns are simply absent — older rows predate newer
    columns). ``specs`` extends the table with baseline-declared
    metrics (:func:`metric_specs_from_baseline`)."""
    if not isinstance(row, dict):
        return {}
    row = dict(row)
    value = _get_path(row, ("value",))
    batch = _get_path(row, ("extra", "batch"))
    if value and batch:
        row["__ms_per_step__"] = batch / value * 1e3
    out: Dict[str, float] = {}
    for spec in specs:
        v = _get_path(row, spec.path)
        if v is not None:
            out[spec.name] = v
    return out


def load_rows(paths: Sequence[str],
              specs: Sequence[MetricSpec] = METRICS
              ) -> List[Dict[str, Any]]:
    """Load bench rows from files, tolerating both wire formats: a
    plain ``bench.py`` JSON line, or the driver capture wrapper
    (``{"n": …, "rc": …, "parsed": {…}|null}``). Returns
    [{"path", "row" (may be None), "metrics", "note"}] in input
    order."""
    out = []
    for path in paths:
        note = None
        try:
            with open(path) as f:
                text = f.read()
            # driver files may concatenate objects; take the first
            # decodable one (the capture of this round's default bench)
            dec = json.JSONDecoder()
            obj, _ = dec.raw_decode(text.lstrip())
        except (OSError, ValueError) as e:
            out.append({"path": path, "row": None, "metrics": {},
                        "note": f"unreadable ({e})"})
            continue
        row = obj
        if isinstance(obj, dict) and "parsed" in obj:
            row = obj.get("parsed")
            if row is None:
                why = obj.get("failure_reason")
                att = obj.get("attempts")
                note = (f"no parsed bench row (rc={obj.get('rc')}"
                        + (f"; {att} probe attempts" if att else "")
                        + (f"; {why}" if why else "") + ") — skipped")
        metrics = extract_metrics(row, specs)
        if row is not None and not metrics and note is None:
            note = "no judged metrics in row — skipped"
        out.append({"path": path, "row": row, "metrics": metrics,
                    "note": note})
    return out


# --- the robust gate ---------------------------------------------------------

@dataclasses.dataclass
class Verdict:
    """One metric's judgement against its trajectory baseline."""

    metric: str
    direction: str
    latest: Optional[float]
    baseline: Optional[float]        # median over history
    mad: Optional[float]
    threshold: Optional[float]
    degradation: Optional[float]     # >0 = got worse (direction-aware)
    n_history: int
    regressed: bool = False
    waived: bool = False
    note: Optional[str] = None

    @property
    def fingerprint(self) -> str:
        return f"regress|{self.metric}"

    def to_event(self, rank: int = 0) -> Dict:
        """``kind="regress"`` event (``check_metrics_schema.py --kind
        roofline`` validates)."""
        rnd = lambda v: None if v is None else round(v, 6)
        return {"kind": "regress", "rank": rank, "metric": self.metric,
                "direction": self.direction, "latest": rnd(self.latest),
                "baseline": rnd(self.baseline), "mad": rnd(self.mad),
                "threshold": rnd(self.threshold),
                "degradation": rnd(self.degradation),
                "n_history": self.n_history,
                "regressed": bool(self.regressed),
                "waived": bool(self.waived),
                "fingerprint": self.fingerprint}


def check_row(history: Sequence[float], latest: float, spec: MetricSpec,
              *, min_history: int = 2) -> Verdict:
    """Judge one metric value against its history (median/MAD,
    direction-aware). Never flags with fewer than ``min_history``
    prior values."""
    hist = [float(v) for v in history]
    v = Verdict(metric=spec.name, direction=spec.direction,
                latest=latest, baseline=None, mad=None, threshold=None,
                degradation=None, n_history=len(hist))
    if len(hist) < min_history:
        v.note = f"insufficient history ({len(hist)} < {min_history})"
        return v
    med = statistics.median(hist)
    mad = statistics.median([abs(x - med) for x in hist])
    v.baseline, v.mad = med, mad
    degradation = (med - latest) if spec.direction == "higher" \
        else (latest - med)
    v.degradation = degradation
    if spec.counter:
        v.threshold = spec.abs_floor
        v.regressed = degradation > v.threshold
        return v
    v.threshold = max(spec.z * 1.4826 * mad,
                      spec.rel_floor * abs(med), spec.abs_floor)
    v.regressed = degradation > v.threshold
    return v


@dataclasses.dataclass
class SentinelReport:
    """All verdicts for one judged row (or a full replay)."""

    verdicts: List[Verdict]
    subject: Optional[str]            # path/name of the judged row
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def regressions(self) -> List[Verdict]:
        return [v for v in self.verdicts if v.regressed and not v.waived]

    @property
    def ok(self) -> bool:
        return not self.regressions

    def table(self) -> str:
        lines = [f"{'metric':<22} {'dir':<7} {'latest':>12} "
                 f"{'baseline':>12} {'thresh':>10} {'verdict':<10}"]
        for v in self.verdicts:
            if v.note and v.baseline is None:
                verdict = "skip"
            elif v.regressed and v.waived:
                verdict = "WAIVED"
            elif v.regressed:
                verdict = "REGRESSED"
            else:
                verdict = "ok"
            fmt = lambda x: "-" if x is None else f"{x:.6g}"
            lines.append(f"{v.metric:<22} {v.direction:<7} "
                         f"{fmt(v.latest):>12} {fmt(v.baseline):>12} "
                         f"{fmt(v.threshold):>10} {verdict:<10}")
        for n in self.notes:
            lines.append(f"  note: {n}")
        return "\n".join(lines)

    def to_events(self, rank: int = 0) -> List[Dict]:
        return [v.to_event(rank=rank) for v in self.verdicts]


def check_trajectory(rows: Sequence[Dict[str, Any]], *,
                     waivers: Optional[Dict[str, Dict]] = None,
                     min_history: int = 2,
                     specs: Sequence[MetricSpec] = METRICS
                     ) -> SentinelReport:
    """Judge the NEWEST metric-bearing row of a trajectory against all
    earlier metric-bearing rows.

    ``rows`` as from :func:`load_rows` (each ``{"path", "metrics",
    "note"}``; plain metric dicts also accepted as
    ``{"metrics": …}``). Metric-less rows contribute notes, not
    baselines or verdicts."""
    waivers = waivers or {}
    notes = [f"{r.get('path', f'row {i}')}: {r['note']}"
             for i, r in enumerate(rows) if r.get("note")]
    bearing = [r for r in rows if r.get("metrics")]
    if not bearing:
        return SentinelReport(verdicts=[], subject=None,
                              notes=notes + ["no metric-bearing rows"])
    subject = bearing[-1]
    history = bearing[:-1]
    verdicts: List[Verdict] = []
    for spec in specs:
        latest = subject["metrics"].get(spec.name)
        if latest is None:
            continue
        hist = [r["metrics"][spec.name] for r in history
                if spec.name in r["metrics"]]
        v = check_row(hist, latest, spec, min_history=min_history)
        if v.regressed:
            waiver = waivers.get(v.fingerprint)
            if waiver is not None:
                allow_to = waiver.get("allow_to")
                better = (lambda a, b: a >= b) \
                    if spec.direction == "higher" else (lambda a, b: a <= b)
                if allow_to is None or better(latest, float(allow_to)):
                    v.waived = True
                    v.note = f"waived: {waiver.get('reason', '(no reason)')}"
        verdicts.append(v)
    return SentinelReport(verdicts=verdicts,
                          subject=subject.get("path"), notes=notes)


def replay_trajectory(rows: Sequence[Dict[str, Any]], *,
                      waivers: Optional[Dict[str, Dict]] = None,
                      min_history: int = 2,
                      specs: Sequence[MetricSpec] = METRICS
                      ) -> List[SentinelReport]:
    """Judge EVERY metric-bearing row against its prefix — the
    backtest proving the gate stays quiet on the committed history
    (``roofline_audit`` asserts it, then seeds a regression and asserts
    it fires)."""
    reports = []
    bearing_seen = 0
    for i in range(len(rows)):
        if not rows[i].get("metrics"):
            continue
        bearing_seen += 1
        if bearing_seen <= min_history:
            continue                    # nothing judgeable yet
        reports.append(check_trajectory(rows[:i + 1], waivers=waivers,
                                        min_history=min_history,
                                        specs=specs))
    return reports


# --- the committed waiver file (apexlint-baseline style) ---------------------

def load_baseline(path: str) -> Dict[str, Dict]:
    """{fingerprint: waiver} from a committed perf-baseline JSON
    (missing file = empty — the gate starts strict)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except OSError:
        return {}
    waivers = data.get("waivers", {})
    if not isinstance(waivers, dict):
        raise ValueError(f"{path}: 'waivers' must be an object")
    return {k: (v if isinstance(v, dict) else {"reason": str(v)})
            for k, v in waivers.items()}


def save_baseline(path: str, report: SentinelReport, *,
                  reason: str = "accepted regression") -> Dict:
    """Write the current regressions as waivers (the ``--write-baseline``
    workflow): each gets ``allow_to`` = its latest value, so further
    degradation past the accepted point re-fires."""
    waivers = load_baseline(path)
    for v in report.regressions:
        waivers[v.fingerprint] = {"reason": reason,
                                  "metric": v.metric,
                                  "allow_to": v.latest,
                                  "baseline_was": v.baseline}
    data = {"version": 1, "waivers": waivers}
    try:                      # a refresh must not drop the declared
        with open(path) as f:  # extra-metrics section
            prev = json.load(f)
        if prev.get("metrics"):
            data["metrics"] = prev["metrics"]
    except (OSError, ValueError):
        pass
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    return data
