"""Per-op roofline attribution: measured time vs attainable time.

The port of ``apex_tpu/prof/roofline.py``. It joins each op's *measured*
device time (a :class:`~apex_tpu_torch.prof.xplane.TraceProfile`) with
its *analytic* cost (:mod:`apex_tpu_torch.prof.cost`), prices it against
the card's peaks and reports the ops whose time sits above their bound::

    rep = prof.profile_step(step, state, toks, labels)
    roof = prof.roofline_report(rep)
    roof.check_closure(0.05); roof.by_family(); roof.worst_gaps(5)

- **hand kernels**: every kernel launched inside a wrapper's
  ``apex_tpu_torch::<kernel>`` range (opened only under a profiler)
  belongs to that call; the call's cost is the registry's, logged at the
  call (``StepReport.kernel_calls``), matched to the ranges in order;
- **aten ops**: a kernel belongs to the innermost ``cpu_op`` open at its
  launch; the cost is the counted run's for the same op and operand
  shapes (``record_shapes=True``), walking out to the parent op (an
  ``aten::copy_`` inside ``aten::to``) when the innermost was not counted;
  otherwise FLOPs from the formula registry and no bytes;
- **the bound** is the larger of bytes over the memory rate and FLOPs
  over the peak of the op's type (bf16/fp16 tensor cores, or f32), int
  ops at the f32 rate — the formula ``chip_smoke.py``'s kernel rows use,
  so a hand kernel's attainable time is its row's bound.

``efficiency`` = attainable/measured clamped to [0, 1] as in the JAX
package; :attr:`RooflineRow.raw_efficiency` is the unclamped ratio (a
row above 1 means an over-counted cost, or a working set the 50 MB L2
serves). ``check_closure`` holds the attributed time against the trace's
summed kernel time. Events: ``kind="roofline"``
(``check_metrics_schema.py --kind roofline``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

from apex_tpu_torch.prof.report import (PEAK_F32_FLOPS, PEAK_FLOPS,
                                        PEAK_HBM_BW, PEAK_TABLES,
                                        device_kind, lookup_peak)

__all__ = ["RooflineRow", "RooflineReport", "roofline_report",
           "classify_family", "FAMILIES", "BOUND_CLASSES"]

FAMILIES = ("attention", "layer_norm", "mlp", "bn_act", "xentropy",
            "optimizer", "gemm", "conv", "collective", "copy", "other")
BOUND_CLASSES = ("compute", "memory", "unknown")

_FAMILY_PATTERNS: Tuple[Tuple[str, str], ...] = (
    ("flash_attention", "attention"),
    ("flash_attn", "attention"),
    ("flash_generic", "attention"),
    ("attention", "attention"),
    ("attn", "attention"),
    ("layer_norm", "layer_norm"),
    ("layernorm", "layer_norm"),
    ("fused_layer_norm", "layer_norm"),
    ("bn_relu", "bn_act"),
    ("bn_act", "bn_act"),
    ("bn_bwd", "bn_act"),
    ("bn_sums", "bn_act"),
    ("bn_dx", "bn_act"),
    ("batchnorm", "bn_act"),
    ("conv_bn", "bn_act"),
    ("xentropy", "xentropy"),
    ("cross_entropy", "xentropy"),
    ("softmax_xent", "xentropy"),
    ("mlp", "mlp"),
    ("dense", "mlp"),
    ("lamb", "optimizer"),
    ("adam", "optimizer"),
    ("fused_sgd", "optimizer"),
    ("apply_gradients", "optimizer"),
    ("optim", "optimizer"),
    ("multi_tensor", "optimizer"),
    ("sgd", "optimizer"),
    ("adagrad", "optimizer"),
    ("novograd", "optimizer"),
)

_DTYPE_BYTES = {"float32": 4, "float": 4, "f32": 4, "bfloat16": 2,
                "bf16": 2, "float16": 2, "f16": 2, "fp16": 2, "half": 2,
                "float8_e4m3fn": 1, "float8_e5m2": 1, "fp8_e4m3": 1,
                "fp8_e5m2": 1, "float64": 8, "int64": 8, "int32": 4}
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def classify_family(scope: str, opcode: str = "",
                    category: str = "") -> str:
    """Kernel family of an op from its scope path (and, for a hand
    kernel, its ``apex_tpu_torch::<kernel>`` opcode), with the kernel
    category as the structural fallback."""
    kernel = opcode if opcode.startswith("apex_tpu_torch::") else ""
    s = f"{scope or ''}/{kernel}".lower()
    for pat, fam in _FAMILY_PATTERNS:
        if pat in s:
            return fam
    if category == "collective" or opcode.startswith("c10d::"):
        return "collective"
    if category == "gemm" or opcode in ("aten::mm", "aten::addmm",
                                        "aten::bmm", "aten::baddbmm"):
        return "gemm"
    if category == "conv" or "convolution" in opcode:
        return "conv"
    if category in ("copy", "cast") or opcode in ("aten::copy_",
                                                  "aten::_to_copy"):
        return "copy"
    return "other"


@dataclasses.dataclass
class RooflineRow:
    """One op's measured-vs-attainable verdict."""

    name: str                     # join key: op and shapes, or kernel+sig
    opcode: str                   # "aten::mm", "apex_tpu_torch::..."
    family: str
    scope: str
    flops: float                  # per execution
    bytes: float                  # per execution
    occurrences: int              # executions in the trace (0 AOT-only)
    measured_us: Optional[float]  # avg device us per execution, or None
    compute_us: float
    memory_us: float
    bound: str
    dtype: str
    shape: str
    mxu_cap: float = 1.0          # kept for the JAX row layout; 1 here
    hlo: str = ""                 # the kernels' names, here

    @property
    def attainable_us(self) -> float:
        return max(self.compute_us, self.memory_us)

    @property
    def raw_efficiency(self) -> Optional[float]:
        """attainable/measured, unclamped."""
        if self.measured_us is None or self.measured_us <= 0:
            return None
        att = self.attainable_us
        return att / self.measured_us if att > 0 else None

    @property
    def efficiency(self) -> Optional[float]:
        """attainable/measured in [0, 1]; None without a measurement or
        a bound."""
        raw = self.raw_efficiency
        return None if raw is None else min(1.0, raw)

    @property
    def gap_us(self) -> Optional[float]:
        if self.measured_us is None or self.attainable_us <= 0:
            return None
        return max(0.0, (self.measured_us - self.attainable_us)
                   * max(self.occurrences, 1))

    @property
    def fingerprint(self) -> str:
        dims = _SHAPE_RE.search(self.shape)
        shape = f"{dims.group(1)}[{dims.group(2)}]" if dims else self.shape
        return f"{self.family}|{self.opcode}|{self.scope}|{shape}"

    def to_event(self, rank: int = 0, step: Optional[int] = None) -> Dict:
        return {"kind": "roofline", "rank": rank, "step": step,
                "op": self.name, "opcode": self.opcode,
                "family": self.family, "scope": self.scope,
                "bound": self.bound, "flops": self.flops,
                "bytes": self.bytes,
                "attainable_us": round(self.attainable_us, 3),
                "measured_us": (None if self.measured_us is None
                                else round(self.measured_us, 3)),
                "efficiency": (None if self.efficiency is None
                               else round(self.efficiency, 4)),
                "gap_us": (None if self.gap_us is None
                           else round(self.gap_us, 3)),
                "occurrences": self.occurrences, "dtype": self.dtype,
                "fingerprint": self.fingerprint}


def _fmt_us(v: Optional[float]) -> str:
    return "n/a" if v is None else f"{v:.1f}"


@dataclasses.dataclass
class RooflineReport:
    """Per-op roofline ledger of one profiled (or counted) step."""

    rows: List[RooflineRow]
    device_kind: str
    peak_flops: float
    hbm_bw: float
    profile_total_us: float           # summed kernel time attributed
    module_total_us: float            # summed kernel time in the trace
    module_runs: int

    @property
    def measured(self) -> bool:
        return any(r.measured_us is not None for r in self.rows)

    def check_closure(self, tolerance: float = 0.05
                      ) -> Tuple[bool, float]:
        """The rows' measured time must cover the trace's kernel time
        within ``tolerance``: (ok, relative error)."""
        attributed = sum((r.measured_us or 0.0) * max(r.occurrences, 1)
                         for r in self.rows)
        total = self.module_total_us
        if total <= 0:
            return True, 0.0
        err = abs(attributed - total) / total
        return err <= tolerance, err

    def by_family(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for r in self.rows:
            occ = max(r.occurrences, 1)
            agg = out.setdefault(r.family, {
                "measured_us": 0.0, "attainable_us": 0.0,
                "flops": 0.0, "bytes": 0.0, "n_ops": 0})
            agg["n_ops"] += 1
            agg["flops"] += r.flops * occ
            agg["bytes"] += r.bytes * occ
            agg["attainable_us"] += r.attainable_us * occ
            if r.measured_us is not None:
                agg["measured_us"] += r.measured_us * occ
        for agg in out.values():
            m, a = agg["measured_us"], agg["attainable_us"]
            agg["efficiency"] = (round(min(1.0, a / m), 4)
                                 if m > 0 and a > 0 else None)
        return dict(sorted(out.items(),
                           key=lambda kv: -kv[1]["measured_us"]))

    def by_scope(self, depth: int = 2) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for r in self.rows:
            occ = max(r.occurrences, 1)
            key = "/".join([p for p in r.scope.split("/") if p][:depth]) \
                or "(unscoped)"
            agg = out.setdefault(key, {"measured_us": 0.0,
                                       "attainable_us": 0.0})
            agg["attainable_us"] += r.attainable_us * occ
            if r.measured_us is not None:
                agg["measured_us"] += r.measured_us * occ
        return dict(sorted(out.items(),
                           key=lambda kv: -kv[1]["measured_us"]))

    def what_if(self, plan: Dict[str, str]) -> List[Dict[str, Any]]:
        """Attainable time per op if a precision verdict were applied:
        ``plan`` maps a site (a case-insensitive substring of the scope
        or opcode) to a target format; the bytes and the compute bound
        scale by the byte ratio. Rows as the JAX package gives them."""
        fmt_bytes = {"fp8_e4m3": 1, "fp8_e5m2": 1, "fp16": 2,
                     "bf16": 2, "fp32": 4}
        out: List[Dict[str, Any]] = []
        for site, target in plan.items():
            b_new = fmt_bytes.get(target, _DTYPE_BYTES.get(target))
            if b_new is None:
                raise ValueError(f"what_if target {target!r} is not a "
                                 f"known format or dtype")
            needle = site.lower()
            for r in self.rows:
                if needle not in r.scope.lower():
                    continue
                b_cur = _DTYPE_BYTES.get(r.dtype)
                if b_cur is None or b_new >= b_cur:
                    continue
                ratio = b_new / b_cur
                whatif = max(r.compute_us * ratio, r.memory_us * ratio)
                gain = max(0.0, (r.attainable_us - whatif)
                           * max(r.occurrences, 1))
                out.append({
                    "site": site, "op": r.name, "scope": r.scope,
                    "family": r.family, "fingerprint": r.fingerprint,
                    "dtype_from": r.dtype, "dtype_to": target,
                    "bound": r.bound,
                    "attainable_us": round(r.attainable_us, 3),
                    "whatif_attainable_us": round(whatif, 3),
                    "whatif_gain_us": round(gain, 3),
                    "measured_us": (None if r.measured_us is None
                                    else round(r.measured_us, 3)),
                    "occurrences": r.occurrences})
        out.sort(key=lambda e: -e["whatif_gain_us"])
        return out

    def worst_gaps(self, k: int = 5) -> List[Dict[str, Any]]:
        gaps = [r for r in self.rows
                if r.gap_us is not None and r.gap_us > 0]
        gaps.sort(key=lambda r: -r.gap_us)
        return [{"fingerprint": r.fingerprint, "op": r.name,
                 "family": r.family, "scope": r.scope,
                 "dtype": r.dtype, "shape": r.shape,
                 "bound": r.bound,
                 "measured_us": round(r.measured_us, 3),
                 "attainable_us": round(r.attainable_us, 3),
                 "gap_us": round(r.gap_us, 3),
                 "efficiency": round(r.efficiency, 4),
                 "occurrences": r.occurrences}
                for r in gaps[:k]]

    def table(self, top: int = 12) -> str:
        head = (f"roofline — device={self.device_kind or '?'} "
                f"peak={self.peak_flops / 1e12:.0f} TFLOP/s "
                f"hbm={self.hbm_bw / 1e9:.0f} GB/s ops={len(self.rows)}")
        lines = [head,
                 f"{'op':<26} {'family':<11} {'bound':<8} "
                 f"{'meas_us':>8} {'attain':>8} {'eff':>6} {'gap_us':>8}"]
        rows = sorted(self.rows, key=lambda r: -(r.gap_us or 0.0))
        for r in rows[:top]:
            eff = f"{r.efficiency:.0%}" if r.efficiency is not None \
                else "n/a"
            lines.append(
                f"{r.name[:26]:<26} {r.family:<11} {r.bound:<8} "
                f"{_fmt_us(r.measured_us):>8} "
                f"{_fmt_us(r.attainable_us):>8} {eff:>6} "
                f"{_fmt_us(r.gap_us):>8}")
        fams = self.by_family()
        if fams:
            lines.append("by family: " + "  ".join(
                f"{k}={v['measured_us']:.0f}us"
                + (f"@{v['efficiency']:.0%}"
                   if v.get("efficiency") is not None else "")
                for k, v in list(fams.items())[:6]))
        return "\n".join(lines)

    def summary(self, k: int = 3) -> Dict[str, Any]:
        ok, err = self.check_closure()
        gaps = self.worst_gaps(k)
        return {"n_ops": len(self.rows), "measured": self.measured,
                "device": self.device_kind,
                "closure_ok": bool(ok), "closure_err": round(err, 6),
                "worst_gaps": gaps,
                "worst_gap_us": gaps[0]["gap_us"] if gaps else None}

    def to_events(self, rank: int = 0, step: Optional[int] = None,
                  top: Optional[int] = None) -> List[Dict]:
        rows = self.rows if top is None else self.rows[:top]
        return [r.to_event(rank=rank, step=step) for r in rows]


def _classify_bound(flops: float, nbytes: float, compute_us: float,
                    memory_us: float) -> str:
    if compute_us <= 0 and memory_us <= 0:
        return "unknown"
    if flops > 0 and compute_us >= memory_us:
        return "compute"
    return "memory" if nbytes > 0 else "unknown"


def _formula(name: str, dims) -> float:
    """FLOPs of an uncounted aten op from its operand shapes alone."""
    import torch
    try:
        from torch.utils.flop_counter import flop_registry
        packet = getattr(torch.ops.aten, name.split("::", 1)[1])
        fn = flop_registry.get(packet)
        return float(fn(*dims)) if fn is not None else 0.0
    except Exception:
        return 0.0


def roofline_report(report=None, profile=None, *, counter=None,
                    kernel_calls=None, peak_flops: Optional[float] = None,
                    hbm_bw: Optional[float] = None,
                    f32_flops: Optional[float] = None,
                    device_kind_: Optional[str] = None) -> RooflineReport:
    """Join counted per-op costs with measured per-kernel device time.

    ``report``: a :class:`~apex_tpu_torch.prof.report.StepReport` (its
    profile, cost counter and kernel-call log), or pass ``profile``,
    ``counter`` (a :class:`~apex_tpu_torch.prof.cost.CostCounter`) and
    ``kernel_calls`` apart. With a counter and no profile the report is
    analytic only (``measured_us=None``). Peaks default to the card's;
    on the CPU they are 0 and rows classify ``unknown``.
    """
    from apex_tpu_torch.prof.cost import OpEstimate, op_key, trace_dims
    if report is not None:
        profile = report.profile if profile is None else profile
        counter = report.counter if counter is None else counter
        kernel_calls = (report.kernel_calls if kernel_calls is None
                        else kernel_calls)
        kind = report.device if device_kind_ is None else device_kind_
    else:
        kind = device_kind() if device_kind_ is None else device_kind_
    if profile is None and counter is None:
        raise ValueError("roofline_report needs a profile, a cost counter, "
                         "or both")
    peak_flops = lookup_peak(PEAK_FLOPS, kind) if peak_flops is None \
        else peak_flops
    hbm_bw = lookup_peak(PEAK_HBM_BW, kind) if hbm_bw is None else hbm_bw
    f32 = lookup_peak(PEAK_F32_FLOPS, kind) if f32_flops is None \
        else f32_flops
    peaks = {"bf16": peak_flops, "f32": f32,
             "3xtf32": lookup_peak(PEAK_TABLES["3xtf32"], kind)}
    ests = dict(counter.ops) if counter is not None else {}

    def _mk(name, opcode, scope, est, occ, measured, category, kernels):
        flops = est.flops if est else 0.0
        nbytes = est.bytes if est else 0.0
        int_ops = est.int_ops if est else 0.0
        peak = peaks.get(est.peak if est else "bf16", peak_flops)
        compute_us = max(flops / peak if peak > 0 and flops > 0 else 0.0,
                         int_ops / f32 if f32 > 0 and int_ops > 0
                         else 0.0) * 1e6
        memory_us = (nbytes / hbm_bw * 1e6
                     if hbm_bw > 0 and nbytes > 0 else 0.0)
        return RooflineRow(
            name=name, opcode=opcode,
            family=classify_family(scope, opcode, category),
            scope=scope, flops=flops, bytes=nbytes, occurrences=occ,
            measured_us=measured, compute_us=compute_us,
            memory_us=memory_us,
            bound=_classify_bound(flops, nbytes, compute_us, memory_us),
            dtype=est.dtype if est else "?",
            shape=name[len(opcode):] if name.startswith(opcode) else name,
            hlo=",".join(sorted(kernels))[:400])

    rows: List[RooflineRow] = []
    used = set()
    total = attributed = 0.0
    runs = 0
    if profile is not None:
        total, runs = profile.module_total_us, profile.module_runs
        # hand-kernel calls: the k-th range of a kernel <-> its k-th call
        calls: Dict[str, List] = {}
        for name, cost in kernel_calls or ():
            calls.setdefault(name, []).append(cost)
        ranges: Dict[str, List] = {}
        for ev in profile.kernels:
            if ev.kernel:
                ranges.setdefault(ev.kernel, [])
                if ev.kernel_id not in ranges[ev.kernel]:
                    ranges[ev.kernel].append(ev.kernel_id)
        order = {k: {rid: i for i, rid in enumerate(sorted(
            v, key=lambda r: r[1]))} for k, v in ranges.items()}
        groups: Dict[Tuple, Dict] = {}
        for ev in profile.kernels:
            if ev.kernel:
                i = order[ev.kernel][ev.kernel_id]
                cl = calls.get(ev.kernel, [])
                cost = cl[i] if i < len(cl) else (cl[-1] if cl else None)
                sig = cost.sig if cost is not None else "?"
                key = (f"apex_tpu_torch::{ev.kernel}[{sig}]",
                       f"apex_tpu_torch::{ev.kernel}")
                inst = ev.kernel_id
                extra = None if cost is None else OpEstimate(
                    key[0], key[1], cost.flops, cost.bytes, 1,
                    cost.sig.split(":")[1].split(",")[0]
                    if ":" in cost.sig else "?", cost.int_ops, cost.peak)
            else:
                key, inst, extra = None, None, None
                for name, dims, rid in ev.ops:
                    k = op_key(name, trace_dims(dims))
                    if k in ests:
                        key, inst = (k, name), rid
                        break
                if key is None and ev.ops:
                    # an op the counted run did not see: FLOPs from its
                    # operand shapes, bytes unknown
                    name, dims, rid = ev.ops[0]
                    key = (op_key(name, trace_dims(dims)), name)
                    inst = rid
                    extra = OpEstimate(key[0], name, _formula(
                        name, trace_dims(dims)), 0.0, 1, "?")
                elif key is None:
                    key = (f"(unattributed)[{ev.name[:60]}]",
                           "(unattributed)")
                    inst = (None, ev.ts)
            g = groups.setdefault(key, {"us": 0.0, "inst": set(),
                                        "scope": ev.scope, "cat": {},
                                        "extra": extra, "names": set()})
            g["us"] += ev.dur
            g["inst"].add(inst)
            g["cat"][ev.category] = g["cat"].get(ev.category, 0.0) + ev.dur
            g["names"].add(ev.name[:60])
        for (name, opcode), g in groups.items():
            occ = max(len(g["inst"]), 1)
            est = ests.get(name) or g["extra"]
            cat = max(g["cat"].items(), key=lambda kv: kv[1])[0]
            rows.append(_mk(name, opcode, g["scope"], est, occ,
                            g["us"] / occ, cat, g["names"]))
            used.add(name)
            attributed += g["us"]
    for name, est in ests.items():
        if name not in used:
            rows.append(_mk(name, est.opcode, "", est, 0, None, "", ()))
    rows.sort(key=lambda r: (-(r.gap_us or 0.0),
                             -(r.measured_us or 0.0) * max(r.occurrences,
                                                           1),
                             -r.bytes))
    return RooflineReport(rows=rows, device_kind=kind,
                          peak_flops=peak_flops, hbm_bw=hbm_bw,
                          profile_total_us=attributed,
                          module_total_us=total, module_runs=runs)
