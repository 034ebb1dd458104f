"""Finding/Report plumbing shared by every apexlint pass.

The port of ``apex_tpu/lint/findings.py``. A lint run produces
:class:`Finding` records — one per rule violation, each carrying the rule
id, severity, a human message, a fix-it hint, and machine evidence (op /
scope path / bytes) — collected into a :class:`Report` that renders a
table, serializes to the ``lint`` JSONL channel
(``MetricsLogger(lint_sink=...)``), and applies a baseline suppression
file so previously-accepted findings don't block CI.

A :class:`Finding` with the same fields gives the same fingerprint and the
same event dict as the JAX package's, so one baseline file serves both.
Rule ids and slugs are the JAX package's, letter for letter (baselines and
dashboards key on them); the titles and fix-its speak of the card and of
PyTorch.

Severities:

- **error** — waste or a per-step host sync that will cost the run
  (host sync, f64 creep, a reused generator state). CI gates on these.
- **warning** — a smell that is sometimes intentional (an f32 matmul
  under an amp policy, an unordered float accumulate).
- **info** — advisory.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Sequence

from apex_tpu_torch.utils.format import fmt_bytes

__all__ = ["Finding", "Report", "Rule", "RULES", "SEVERITIES",
           "DTYPE_NAMES", "PROVENANCES",
           "load_baseline", "save_baseline"]

#: severity names, most severe first (index = sort key)
SEVERITIES = ("error", "warning", "info")

#: dtype evidence vocabulary for the precision pass (APX3xx): the
#: numerics format ladder plus fp64
DTYPE_NAMES = ("fp8_e4m3", "fp8_e5m2", "fp16", "bf16", "fp32", "fp64")

#: the scale-provenance lattice the precision pass propagates
PROVENANCES = ("unscaled", "loss-scaled", "site-scaled",
               "unscaled-after-narrow")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One lint rule's identity: stable id, default severity, fix-it."""

    id: str            # stable id, e.g. "APX101"
    slug: str          # human name, e.g. "donation-miss"
    severity: str      # default severity
    title: str         # one-line description
    fix: str           # generic fix-it hint (findings may specialize)


#: the rule catalog — ids and slugs are stable across releases and across
#: the two packages (baselines and dashboards key on them)
RULES: Dict[str, Rule] = {r.slug: r for r in (
    # trace pass (the record of one run)
    Rule("APX001", "rng-key-reuse", "error",
         "two random draws start from the same generator state — the "
         "draws are the same bits, not independent",
         "draw each stream from its own torch.Generator, seeded once "
         "outside the step (never re-seed it inside)"),
    Rule("APX002", "f64-creep", "error",
         "float64 values in the step — the card runs f64 at a small "
         "fraction of its f32 rate and it doubles the bytes moved",
         "cast to float32 at the boundary (or find the Python/numpy "
         "double that promoted the tensor and .float() it)"),
    Rule("APX003", "fp32-matmul-in-amp", "warning",
         "an fp32 matmul/conv runs inside an active bf16/fp16 amp policy "
         "— it runs at the f32 rate, not the bf16 tensor-core rate",
         "cast the operands to the policy compute dtype (amp.auto_cast "
         "region, or check the cast list covers this op)"),
    Rule("APX004", "host-callback-in-step", "error",
         "the step syncs with the host (.item(), a data-dependent shape, "
         "a device-to-host copy) — every step waits for the card",
         "keep .item()/.cpu()/nonzero out of the steady-state step (read "
         "telemetry through MetricsLogger between steps)"),
    # compiled-program pass
    Rule("APX101", "donation-miss", "error",
         "a params/opt-state-sized input is not reused by any output — "
         "the buffer is double-allocated every step",
         "write the new state into the carried buffers or drop the old "
         "state's references before the next step"),
    Rule("APX102", "implicit-resharding", "warning",
         "a collective is not attributable to any known named scope — "
         "likely an implicit reshard",
         "name the intended collective (trace.span/ddp.sync) or fix the "
         "layout so the step stops moving data"),
    Rule("APX103", "host-transfer", "error",
         "the steady-state step moves data between host and card",
         "keep device→host fetches out of the step; amortize telemetry "
         "through MetricsLogger"),
    Rule("APX104", "tile-padding", "info",
         "matmul operand dims are off the card's tile grid — the kernel "
         "pads to its tile and the padding is wasted bytes and tensor-"
         "core work",
         "size matmul dims to multiples of the kernel's tile where the "
         "model allows; for shapes the model fixes, run "
         "scripts/torch_kernel_tune.py --update-db to sweep tuned "
         "launches into scripts/torch_kernel_tuning_db.json — a shape a "
         "committed tuning entry covers stays informational"),
    # SPMD pass (cross-rank congruence + topology)
    Rule("APX201", "spmd-divergence", "error",
         "ranks disagree on a collective's order, group or dtype — every "
         "rank in the group deadlocks at the first diverging op",
         "run one program on every rank (identical code + mesh on every "
         "process); make the collective schedule a pure function of "
         "shared config"),
    Rule("APX202", "implicit-full-gather", "warning",
         "an all-gather outside every registered collective scope — a "
         "replicated operand the program never asked for, paid in wire "
         "bytes and device memory",
         "keep the operand sharded or register the gather as a planned "
         "scope"),
    Rule("APX203", "dcn-flat-collective", "warning",
         "a flat one-hop reduction crosses the slow link with whole-"
         "group replica groups — the slow link carries the full payload",
         "reduce hierarchically: reduce-scatter within the fast domain, "
         "reduce across it over the slow link, all-gather back "
         "(parallel.hierarchical_data_mesh factors the axis)"),
    Rule("APX204", "nondeterminism", "error",
         "a nondeterministic or non-replayable draw runs in the step — "
         "it breaks guard's bitwise rewind-and-replay oracle",
         "draw from a torch.Generator carried with the step's state; "
         "keep host values off the commit path; accumulate in an order "
         "the step fixes (a sort, or deterministic algorithms)"),
    # precision pass (dtype-provenance dataflow over the same record)
    Rule("APX301", "unscaled-narrow-cast", "error",
         "a cast narrows to fp8/fp16 without a dominating scale multiply "
         "— small magnitudes flush to zero and large ones saturate; the "
         "cast O4 must never emit",
         "multiply by a per-site scale (ScaleHistory / "
         "precision_report's recommended_scale) immediately before "
         "the cast, or widen the target dtype"),
    Rule("APX302", "double-rounding", "warning",
         "chained narrowing casts (f32 -> bf16 -> fp8) round the "
         "mantissa twice — one scaled cast from the wide value loses "
         "strictly less",
         "cast once from the widest live value (keep the f32 source "
         "and emit a single scaled narrow cast)"),
    Rule("APX303", "scale-leak", "error",
         "loss-scaled gradient taint reaches a committed (non-scalar) "
         "output without an unscale on every path — the update is "
         "silently multiplied by the loss scale",
         "unscale_grads before the optimizer / param-delta add "
         "(amp.Amp.backward does this; divide by the scale on every "
         "path that commits)"),
    Rule("APX304", "master-weight-violation", "error",
         "update arithmetic runs entirely in the half dtype on a "
         "half-precision carried param under a master-weights policy "
         "— small updates are lost to rounding against the f32 master "
         "contract",
         "keep the committed params in f32 (amp.Amp.init builds the "
         "masters; apply updates to the f32 copy and re-cast)"),
    Rule("APX305", "half-accumulation", "warning",
         "a matmul/conv or sum accumulates in fp16/fp8 (bf16 for "
         "reductions) without a widened accumulator — long "
         "accumulation chains lose low-order bits",
         "ask for an f32 result (out_dtype=torch.float32 on the "
         "matmul), or upcast the reduction operand to f32"),
    Rule("APX306", "wire-dtype-unsafe", "error",
         "a collective's wire dtype is narrower than the measured "
         "per-site precision_report verdict for its subsystem — the "
         "reduction quantizes below the measured safe format",
         "widen the collective dtype, or apply the verdict's "
         "recommended scale before the reduction; int8 error-feedback "
         "compression is exempt by design"),
)}

_RULES_BY_ID = {r.id: r for r in RULES.values()}


@dataclasses.dataclass
class Finding:
    """One rule violation with its evidence."""

    rule: str                      # Rule.slug
    message: str                   # specialized human message
    severity: Optional[str] = None  # default: the rule's severity
    op: Optional[str] = None       # aten op / kernel name
    scope: Optional[str] = None    # state path / step phase / call path
    bytes: Optional[int] = None    # wasted / moved bytes, when estimable
    count: int = 1                 # occurrences folded into this finding
    fix: Optional[str] = None      # specialized fix-it (default: rule's)
    # cross-rank / topology evidence (the APX2xx SPMD pass; None for
    # single-program findings — excluded from fingerprints so a
    # baselined finding survives a mesh-shape change)
    axes: Optional[List[str]] = None   # mesh axes the groups span
    ranks: Optional[List[int]] = None  # the diverging rank pair
    hop: Optional[str] = None          # link class: "ici" | "dcn"
    # precision evidence (the APX3xx pass; None elsewhere — excluded
    # from fingerprints like the SPMD fields, so a baselined finding
    # survives a dtype-pair drift)
    dtype_from: Optional[str] = None   # source dtype (DTYPE_NAMES)
    dtype_to: Optional[str] = None     # target/required dtype
    scale_provenance: Optional[str] = None  # PROVENANCES entry

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown lint rule {self.rule!r}")
        if self.severity is None:
            self.severity = RULES[self.rule].severity
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")
        if self.fix is None:
            self.fix = RULES[self.rule].fix
        if self.hop is not None and self.hop not in ("ici", "dcn"):
            raise ValueError(f"unknown hop class {self.hop!r}")
        if self.axes is not None:
            self.axes = [str(a) for a in self.axes]
        if self.ranks is not None:
            self.ranks = [int(r) for r in self.ranks]
        for dt in (self.dtype_from, self.dtype_to):
            if dt is not None and dt not in DTYPE_NAMES:
                raise ValueError(f"unknown dtype name {dt!r} "
                                 f"(expected one of {DTYPE_NAMES})")
        if (self.scale_provenance is not None
                and self.scale_provenance not in PROVENANCES):
            raise ValueError(
                f"unknown scale provenance {self.scale_provenance!r} "
                f"(expected one of {PROVENANCES})")

    @property
    def id(self) -> str:
        return RULES[self.rule].id

    def fingerprint(self) -> str:
        """Stable identity for baseline suppression: rule + where.
        Bytes/counts are excluded — a baselined finding stays
        suppressed when its size drifts."""
        return f"{self.rule}|{self.op or ''}|{self.scope or ''}"

    def to_event(self, fn: Optional[str] = None,
                 step: Optional[int] = None) -> Dict:
        """``kind="lint_finding"`` event for the lint JSONL channel."""
        return {"kind": "lint_finding", "rule": self.rule, "id": self.id,
                "severity": self.severity, "message": self.message,
                "fix": self.fix, "op": self.op, "scope": self.scope,
                "bytes": self.bytes, "count": self.count, "fn": fn,
                "step": step, "axes": self.axes, "ranks": self.ranks,
                "hop": self.hop, "dtype_from": self.dtype_from,
                "dtype_to": self.dtype_to,
                "scale_provenance": self.scale_provenance}


def _fmt_bytes(n: Optional[float]) -> str:
    return fmt_bytes(n, none="")


class Report:
    """Ordered collection of findings from one lint run."""

    def __init__(self, findings: Iterable[Finding], *,
                 fn_name: Optional[str] = None, suppressed: int = 0):
        self.findings: List[Finding] = sorted(
            findings, key=lambda f: (SEVERITIES.index(f.severity),
                                     f.id, f.scope or "", f.op or ""))
        self.fn_name = fn_name
        #: findings dropped by a baseline file (apply_baseline)
        self.suppressed = suppressed

    def __len__(self) -> int:
        return len(self.findings)

    def __iter__(self):
        return iter(self.findings)

    def by_severity(self) -> Dict[str, int]:
        out = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            out[f.severity] += 1
        return out

    def by_rule(self, rule: str) -> List[Finding]:
        return [f for f in self.findings if f.rule == rule]

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def max_severity(self) -> Optional[str]:
        return self.findings[0].severity if self.findings else None

    def wasted_bytes(self, rule: Optional[str] = None) -> int:
        """Sum of byte evidence across findings (optionally one rule)."""
        return sum(f.bytes or 0 for f in self.findings
                   if rule is None or f.rule == rule)

    # -- baseline suppression ------------------------------------------------

    def apply_baseline(self, baseline: Optional[Sequence[str]]) -> "Report":
        """New Report without findings whose fingerprint is baselined."""
        if not baseline:
            return self
        accepted = set(baseline)
        kept = [f for f in self.findings
                if f.fingerprint() not in accepted]
        return Report(kept, fn_name=self.fn_name,
                      suppressed=self.suppressed
                      + (len(self.findings) - len(kept)))

    # -- renderings ----------------------------------------------------------

    def table(self) -> str:
        head = f"apexlint: {len(self.findings)} finding(s)"
        if self.fn_name:
            head += f" on {self.fn_name}"
        sev = self.by_severity()
        head += (f" ({sev['error']} error, {sev['warning']} warning, "
                 f"{sev['info']} info"
                 + (f"; {self.suppressed} baselined" if self.suppressed
                    else "") + ")")
        lines = [head]
        if not self.findings:
            lines.append("  clean.")
            return "\n".join(lines)
        lines.append(f"  {'id':<7} {'severity':<8} {'rule':<22} "
                     f"{'bytes':>10}  evidence")
        for f in self.findings:
            where = f.scope or f.op or ""
            if f.op and f.scope:
                where = f"{f.scope} [{f.op}]"
            if f.count > 1:
                where += f" (x{f.count})"
            lines.append(f"  {f.id:<7} {f.severity:<8} {f.rule:<22} "
                         f"{_fmt_bytes(f.bytes):>10}  {where[:70]}")
            lines.append(f"          {f.message[:100]}")
            lines.append(f"          fix: {f.fix[:100]}")
        return "\n".join(lines)

    def summary(self) -> Dict:
        """JSON-able digest of the report."""
        return {"n_findings": len(self.findings),
                "by_severity": self.by_severity(),
                "suppressed": self.suppressed,
                "wasted_bytes": self.wasted_bytes(),
                "rules": sorted({f.rule for f in self.findings})}

    def to_events(self, step: Optional[int] = None) -> List[Dict]:
        """``kind="lint_report"`` header + one ``lint_finding`` event per
        finding (emit via ``MetricsLogger.record_lint`` /
        ``attach_lint_report``)."""
        ev: Dict = {"kind": "lint_report", "fn": self.fn_name,
                    "step": step, "suppressed": self.suppressed}
        ev.update({"n_findings": len(self.findings),
                   "by_severity": self.by_severity()})
        return [ev] + [f.to_event(self.fn_name, step)
                       for f in self.findings]


# -- baseline files -----------------------------------------------------------

def load_baseline(path: str) -> List[str]:
    """Fingerprints from a baseline file.

    Format: ``{"version": 1, "suppress": ["rule|op|scope", ...]}``.
    A missing file is an empty baseline (new error findings must break the
    gate).
    """
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return []
    if not isinstance(data, dict) or not isinstance(
            data.get("suppress"), list):
        raise ValueError(f"{path}: not a lint baseline "
                         '(expected {"version": 1, "suppress": [...]})')
    return [str(s) for s in data["suppress"]]


def save_baseline(path: str, report: Report) -> int:
    """Write every finding of ``report`` as the new baseline; returns
    the number of suppressions written."""
    fps = sorted({f.fingerprint() for f in report.findings})
    with open(path, "w") as f:
        json.dump({"version": 1, "suppress": fps}, f, indent=1)
        f.write("\n")
    return len(fps)
