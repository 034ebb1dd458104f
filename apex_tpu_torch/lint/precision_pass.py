"""The precision half of apexlint: a dtype-provenance dataflow pass.

The port of ``apex_tpu/lint/precision_pass.py`` (APX301–305): an abstract
interpretation over the same :class:`~apex_tpu_torch.lint.record.
StepRecord` the trace pass reads, propagating per value an abstract

    (dtype, scale-provenance, rounding-depth)

exactly as the JAX pass does per jaxpr var (its docstring states the
lattice and the rules). The record is a straight line of nodes, so the JAX
pass's scan/while fixpoints and cond joins have nothing to walk; each aten
op maps onto the JAX primitive class it implements:

- ``convert_element_type`` → ``_to_copy`` / ``copy_`` across dtypes;
- the value-preserving set → views, ``clone``, ``neg``, ``t``/``permute``/
  ``expand`` and the like;
- the accumulating reductions → ``sum``, ``mean``, ``cumsum``, and an
  ``add`` in the backward (the autograd engine's gradient accumulation,
  JAX's ``add_any``);
- ``dot_general``'s ``preferred_element_type`` → a result dtype wider than
  the operands (``aten.mm.dtype`` / ``bmm.dtype`` with ``out_dtype=`` on
  the card).

The loss-scale token keeps its JAX signature: a scalar carried input
multiplying a computed scalar (``amp.scaler.scale_loss``), cancelled by a
multiply with its reciprocal (``unscale_grads``' ``1.0 / loss_scale``,
which dispatches ``reciprocal`` then a multiply by the literal 1.0) or by
a divide by its source. Hand-kernel nodes are opaque calls, as JAX treats
``pallas_call``: their outputs take the union of their inputs' taint. JAX
also walks a Pallas body for rule hits; a CUDA body cannot be walked, so a
kernel's node declares the findings the JAX pass makes inside its Pallas
body (:data:`KERNEL_FINDINGS`; the lint tests hold that table against the
JAX pass at the tested shapes).

APX306 (the wire-dtype join) and ``precision_preflight`` read the
collective schedule, which ROADMAP item 12b brings.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from apex_tpu_torch.lint.findings import Finding
from apex_tpu_torch.lint.record import Lit, StepRecord
from apex_tpu_torch.lint.trace_pass import MATMUL_OPS, packet

__all__ = ["precision_findings", "analyze_record", "PrecisionAnalysis",
           "LADDER", "MANTISSA_BITS", "KERNEL_FINDINGS"]

#: narrow → wide; numerics.FORMAT_LADDER plus fp64
LADDER: Tuple[str, ...] = ("fp8_e4m3", "fp8_e5m2", "fp16", "bf16",
                           "fp32", "fp64")
_RANK = {name: i for i, name in enumerate(LADDER)}
MANTISSA_BITS = {"fp8_e4m3": 3, "fp8_e5m2": 2, "fp16": 10, "bf16": 7,
                 "fp32": 23, "fp64": 52}
_FP8 = ("fp8_e4m3", "fp8_e5m2")

#: torch dtype → ladder name
_TORCH_TO_LADDER = {torch.float8_e4m3fn: "fp8_e4m3",
                    torch.float8_e5m2: "fp8_e5m2",
                    torch.float16: "fp16", torch.bfloat16: "bf16",
                    torch.float32: "fp32", torch.float64: "fp64"}

#: ops that carry a value through unchanged (modulo layout): every
#: provenance bit survives them
_PRESERVING = frozenset({
    "aten::view", "aten::_unsafe_view", "aten::reshape", "aten::expand",
    "aten::t", "aten::transpose", "aten::permute", "aten::squeeze",
    "aten::unsqueeze", "aten::slice", "aten::select", "aten::narrow",
    "aten::as_strided", "aten::clone", "aten::neg", "aten::detach",
    "aten::alias", "aten::lift_fresh", "aten::_reshape_alias",
    "aten::split", "aten::split_with_sizes", "aten::unbind",
    "aten::chunk", "aten::flip", "aten::contiguous", "aten::squeeze_",
    "aten::unsqueeze_", "aten::t_", "aten::transpose_",
})
_CONVERTS = frozenset({"aten::_to_copy", "aten::copy", "aten::copy_",
                       "aten::_autocast_to_reduced_precision",
                       "aten::_autocast_to_full_precision"})
_MULS = frozenset({"aten::mul", "aten::mul_"})
_DIVS = frozenset({"aten::div", "aten::div_", "aten::true_divide"})
_ADDS = frozenset({"aten::add", "aten::add_", "aten::sub", "aten::sub_",
                   "aten::rsub"})
#: reductions that ACCUMULATE (max/min don't lose mantissa)
_SUM_REDUCTIONS = frozenset({"aten::sum", "aten::mean", "aten::cumsum",
                             "aten::nansum"})
_CLAMPS = frozenset({"aten::clamp", "aten::clamp_min", "aten::clamp_max",
                     "aten::clip", "aten::hardtanh"})
_MAXMIN = frozenset({"aten::maximum", "aten::minimum", "aten::fmax",
                     "aten::fmin"})

#: findings the JAX pass makes inside a kernel's Pallas body, which the
#: kernel's node declares (rule, severity, dtype_from, dtype_to): none at
#: the shapes the lint tests hold every kernel at
KERNEL_FINDINGS: Dict[str, Tuple[Tuple[str, str, str, str], ...]] = {}


def _fmt(dtype) -> Optional[str]:
    return _TORCH_TO_LADDER.get(dtype)


@dataclasses.dataclass
class _AbsVal:
    """Per-value abstract value: dtype + scale provenance + rounding."""

    fmt: Optional[str] = None       # ladder name, None = non-float
    taint: frozenset = frozenset()  # live loss-scale tokens
    inv_of: frozenset = frozenset()  # tokens this value is 1/s of
    scale_src: Optional[int] = None  # token if this IS a scale scalar
    site_scaled: bool = False       # dominated by a scale multiply
    depth: int = 0                  # chained-narrowing-cast count
    min_mant: int = 52              # narrowest mantissa passed through
    carry_shape: Optional[Tuple[int, ...]] = None  # half carried input
    upd_candidate: bool = False     # half update add on a half carry

    def drop_if_nonfloat(self) -> "_AbsVal":
        if self.fmt is None:
            return _AbsVal(fmt=None)
        return self


def _join(a: _AbsVal, b: _AbsVal) -> _AbsVal:
    """Path join (a select): taint is a union — an unscale must happen on
    every path."""
    return _AbsVal(
        fmt=a.fmt if a.fmt == b.fmt else (a.fmt or b.fmt),
        taint=a.taint | b.taint,
        inv_of=a.inv_of & b.inv_of,
        scale_src=a.scale_src if a.scale_src == b.scale_src else None,
        site_scaled=a.site_scaled and b.site_scaled,
        depth=max(a.depth, b.depth),
        min_mant=min(a.min_mant, b.min_mant),
        carry_shape=(a.carry_shape
                     if a.carry_shape == b.carry_shape else None),
        upd_candidate=a.upd_candidate or b.upd_candidate)


@dataclasses.dataclass
class PrecisionAnalysis:
    """Result of one precision-pass run over a record."""

    findings: List[Finding]
    n_cast_sites: int = 0        # float→float casts
    n_matmul_sites: int = 0      # matmul / conv nodes
    n_reduction_sites: int = 0   # accumulating reductions
    n_loss_scale_tokens: int = 0  # scale_loss multiplies seen

    @property
    def n_sites(self) -> int:
        return (self.n_cast_sites + self.n_matmul_sites
                + self.n_reduction_sites)


class _Interp:
    """The abstract interpreter. One instance per analyze_record call."""

    def __init__(self, record: StepRecord, policy=None):
        self.rec = record
        self.policy = policy
        self.findings: List[Finding] = []
        self._seen = set()          # (rule, node index) dedup
        self._next_token = 0
        self._active = set()        # tokens minted at a scale_loss mul
        self.n_cast_sites = 0
        self.n_matmul_sites = 0
        self.n_reduction_sites = 0
        self.uses_loss_scaling = bool(
            getattr(policy, "uses_loss_scaling", False))
        enabled = bool(getattr(policy, "enabled", False))
        self.master_weights = enabled and bool(
            getattr(policy, "master_weights", False))
        self.pure_half = (enabled and not self.master_weights
                          and getattr(policy, "cast_model_type", None)
                          is not None)
        self.apx304_active = self.master_weights or self.pure_half
        self.env: Dict[int, _AbsVal] = {}

    # -- finding emission -----------------------------------------------------

    def _emit(self, key, **kw) -> None:
        k = (kw.get("rule"), key)
        if k in self._seen:
            return
        self._seen.add(k)
        self.findings.append(Finding(**kw))

    # -- abstract eval --------------------------------------------------------

    def _value(self, vid) -> _AbsVal:
        return _AbsVal(fmt=_fmt(self.rec.values[vid].dtype))

    def _read(self, op) -> _AbsVal:
        if isinstance(op, Lit):
            return _AbsVal()
        return self.env.get(op) or self._value(op)

    def _scalar(self, op) -> bool:
        return isinstance(op, Lit) or self.rec.values[op].numel == 1

    def run(self) -> None:
        rec = self.rec
        # carried inputs and pre-existing constants (JAX: invars and
        # constvars): a scalar is a scale candidate, a half non-scalar the
        # APX304 source
        for vid, v in rec.values.items():
            if v.origin not in ("input", "const"):
                continue
            val = _AbsVal(fmt=_fmt(v.dtype))
            if val.fmt is not None:
                if v.numel == 1:
                    val.scale_src = self._next_token
                    self._next_token += 1
                elif (self.apx304_active
                      and val.fmt in ("fp16", "bf16") + _FP8):
                    val.carry_shape = tuple(v.shape)
            self.env[vid] = val
        for node in rec.nodes:
            self._eval(node)
        # -- APX303 / APX304: what reaches the committed outputs
        for i, vid in enumerate(rec.outputs):
            if vid not in self.env:
                continue
            val = self.env[vid]
            if val.fmt is None:
                continue
            scalar = rec.values[vid].numel == 1
            where = rec.output_paths.get(vid, f"outputs[{i}]")
            if val.taint and not scalar:
                self._emit(
                    ("outputs", vid), rule="scale-leak",
                    message=(f"loss-scaled taint reaches committed "
                             f"output {where} ({val.fmt}) — no unscale "
                             "on at least one path"),
                    op="output", scope=where, dtype_from=val.fmt,
                    scale_provenance="loss-scaled")
            if val.upd_candidate and not scalar:
                sev = "error" if self.master_weights else "info"
                self._emit(
                    ("outputs-apx304", vid),
                    rule="master-weight-violation", severity=sev,
                    message=(f"committed output {where} is a {val.fmt} "
                             "update of a same-shaped half carried "
                             "input — no f32 master in the chain"
                             + ("" if self.master_weights else
                                " (pure-half policy: by design)")),
                    op="output", scope=where, dtype_from=val.fmt,
                    dtype_to="fp32")

    def _eval(self, node) -> None:
        ins = [self._read(o) for o in node.operands]
        union = frozenset().union(*(i.taint for i in ins)) \
            if ins else frozenset()
        if node.kind == "kernel":
            for rule, sev, dfrom, dto in KERNEL_FINDINGS.get(node.op, ()):
                self._emit(("kernel", node.op, rule), rule=rule,
                           severity=sev, op=node.op, scope=node.phase,
                           dtype_from=dfrom, dtype_to=dto,
                           message=f"{rule} inside the {node.op} kernel")
            out = _AbsVal(taint=union)
        else:
            out = self._leaf(node, packet(node.op), ins, union)
        for vid in set(node.outputs) | {new for _o, new in node.writes}:
            self.env[vid] = dataclasses.replace(
                out, fmt=_fmt(self.rec.values[vid].dtype)
            ).drop_if_nonfloat()

    # -- leaf transfer --------------------------------------------------------

    def _leaf(self, node, op, ins: List[_AbsVal], union) -> _AbsVal:
        if op in _CONVERTS:
            if op == "aten::copy_" and len(node.operands) >= 2:
                src = ins[1]
            else:
                src = ins[0] if ins else _AbsVal()
            dst = self.rec.values[node.outputs[0]].dtype \
                if node.outputs else None
            return self._convert(node, src, _fmt(dst))

        if op in _PRESERVING:
            src = ins[0] if ins else _AbsVal()
            out = dataclasses.replace(src)
            if (src.carry_shape is not None and node.outputs
                    and tuple(self.rec.values[node.outputs[0]].shape)
                    != src.carry_shape):
                out.carry_shape = None
            return out

        if op in _MULS or op in _DIVS:
            return self._mul_div(node, "mul" if op in _MULS else "div",
                                 ins, union)

        if op == "aten::reciprocal":
            # JAX's div(1.0, s): the reciprocal of a scale source
            src = ins[0] if ins else _AbsVal()
            if src.scale_src is not None and not src.taint:
                return _AbsVal(inv_of=frozenset({src.scale_src}))
            return _AbsVal(taint=union)

        if op in _ADDS:
            if node.phase == "backward" and op in ("aten::add",
                                                   "aten::add_"):
                # the engine's gradient accumulation: JAX's add_any
                self.n_reduction_sites += 1
                self._check_reduction(node, "add", ins)
                return _AbsVal(taint=union)
            return self._add_sub(node, ins, union)

        if op == "aten::where":
            # the condition (operand 0) is control, not a scaled value
            cases = ins[1:] or [_AbsVal()]
            out = cases[0]
            for c in cases[1:]:
                out = _join(out, c)
            return out

        if op in _CLAMPS:
            src = ins[0] if ins else _AbsVal()
            return dataclasses.replace(src, scale_src=None)

        if op in _MAXMIN and len(ins) == 2:
            a_s, b_s = (self._scalar(o) for o in node.operands[:2])
            if a_s or b_s:
                keep = ins[0] if b_s else ins[1]
                return dataclasses.replace(keep, scale_src=None)
            out = _join(ins[0], ins[1])
            return dataclasses.replace(out, site_scaled=False,
                                       scale_src=None)

        if op in MATMUL_OPS:
            self.n_matmul_sites += 1
            self._check_matmul(node)
            return _AbsVal(taint=union)

        if op in _SUM_REDUCTIONS:
            self.n_reduction_sites += 1
            self._check_reduction(node, op.split("::")[1], ins)
            return _AbsVal(taint=union)

        # generic: taint flows through, domination/rounding reset
        return _AbsVal(taint=union)

    def _convert(self, node, src: _AbsVal, dst_fmt) -> _AbsVal:
        out = dataclasses.replace(src)
        if src.fmt is None or dst_fmt is None:
            return _AbsVal(fmt=dst_fmt)        # int↔float: a fresh value
        if src.fmt == dst_fmt:
            return out                         # a copy
        self.n_cast_sites += 1
        src_m = MANTISSA_BITS.get(src.fmt, 52)
        dst_m = MANTISSA_BITS.get(dst_fmt, 52)
        scope, op = node.phase, packet(node.op)
        if dst_m < src_m:                      # narrowing
            provenance = ("loss-scaled" if src.taint else
                          "site-scaled" if src.site_scaled else
                          "unscaled-after-narrow" if src.depth else
                          "unscaled")
            if src.depth >= 1 and dst_m < src.min_mant:
                self._emit(
                    node.index, rule="double-rounding",
                    message=(f"{src.fmt}→{dst_fmt} narrows a value "
                             f"already rounded {src.depth}x (narrowest "
                             f"format seen: {src.min_mant}-bit "
                             "mantissa) — cast once from the wide "
                             "source instead"),
                    op=op, scope=scope, dtype_from=src.fmt,
                    dtype_to=dst_fmt, scale_provenance=provenance)
            # fp8 needs a per-site scale — a global loss scale is not
            # enough (its magnitude is tuned for fp16 grad exponents)
            if dst_fmt in _FP8 and not src.site_scaled:
                self._emit(
                    node.index, rule="unscaled-narrow-cast",
                    message=(f"{src.fmt}→{dst_fmt} cast with no "
                             "dominating per-site scale multiply"
                             + (" (loss scale alone does not place "
                                "this site's exponents)"
                                if src.taint else "")
                             + " — the cast O4 must never emit"),
                    op=op, scope=scope, dtype_from=src.fmt,
                    dtype_to=dst_fmt, scale_provenance=provenance)
            elif (dst_fmt == "fp16"
                  and not (src.site_scaled or src.taint)
                  and not self.uses_loss_scaling):
                self._emit(
                    node.index, rule="unscaled-narrow-cast",
                    severity="warning",
                    message=(f"{src.fmt}→fp16 cast with no scale "
                             "multiply and no loss-scaling policy — "
                             "fp16's 5-bit exponent underflows "
                             "unprotected gradients"),
                    op=op, scope=scope, dtype_from=src.fmt,
                    dtype_to="fp16", scale_provenance=provenance)
            out.depth = src.depth + 1
            out.min_mant = min(src.min_mant, dst_m)
        out.fmt = dst_fmt
        if out.carry_shape is not None and dst_m > src_m:
            # a widened copy of a half carried input is no longer the
            # half carry (an f32 master path exists from here on)
            out.carry_shape = None
        return out

    def _mul_div(self, node, prim, ins: List[_AbsVal], union) -> _AbsVal:
        if len(ins) < 2:
            return _AbsVal(taint=union)
        a, b = ins[:2]
        av, bv = node.operands[:2]
        a_lit, b_lit = isinstance(av, Lit), isinstance(bv, Lit)
        a_scalar, b_scalar = self._scalar(av), self._scalar(bv)
        taint = a.taint | b.taint
        inv_of: frozenset = frozenset()
        scale_src: Optional[int] = None
        site_scaled = False
        if prim == "mul":
            for x, y, y_lit, y_scalar in ((a, b, b_lit, b_scalar),
                                          (b, a, a_lit, a_scalar)):
                if x.scale_src is None:
                    continue
                if (not y_lit and y_scalar and y.scale_src is None
                        and y.fmt is not None):
                    # token minting: the scale_loss signature — the
                    # scale (a scalar carried input) times a computed
                    # scalar (the loss)
                    self._active.add(x.scale_src)
                    taint = taint | {x.scale_src}
                elif x.scale_src in self._active:
                    taint = taint | {x.scale_src}
                else:
                    scale_src = x.scale_src
            # cancellation: multiply by the reciprocal of a live token
            if a.inv_of & b.taint:
                taint = taint - a.inv_of
            if b.inv_of & a.taint:
                taint = taint - b.inv_of
            # a reciprocal times a literal (``(1.0 / s)``'s multiply by
            # 1.0) is still the reciprocal
            if a.inv_of and b_lit and not a.taint:
                inv_of = a.inv_of
            elif b.inv_of and a_lit and not b.taint:
                inv_of = b.inv_of
            site_scaled = a_scalar or b_scalar
        else:                                   # div
            if b.scale_src is not None and b.scale_src in a.taint:
                taint = frozenset(t for t in taint if t != b.scale_src)
            if (b.scale_src is not None and a_scalar and not a.taint
                    and a.scale_src is None):
                inv_of = frozenset({b.scale_src})
            if a.scale_src is not None and b_lit:
                scale_src = a.scale_src
                if a.scale_src in self._active:
                    taint = taint | {a.scale_src}
            site_scaled = b_scalar
        out = _AbsVal(taint=taint, inv_of=inv_of, scale_src=scale_src,
                      site_scaled=site_scaled)
        arr = a if not a_scalar else b
        out.depth = arr.depth
        out.min_mant = arr.min_mant
        return out

    def _add_sub(self, node, ins: List[_AbsVal], union) -> _AbsVal:
        out = _AbsVal(taint=union)
        if not self.apx304_active or len(ins) < 2 or not node.outputs:
            return out
        a, b = ins[:2]
        res = self.rec.values[node.outputs[0]]
        if res.numel == 1:
            return out
        shape = tuple(res.shape)
        halfs = {"fp16", "bf16"} | set(_FP8)
        if (a.fmt in halfs and b.fmt in halfs
                and (a.carry_shape == shape or b.carry_shape == shape)):
            out.upd_candidate = True
            out.carry_shape = shape    # chains of half update arith
        out.upd_candidate = out.upd_candidate or a.upd_candidate \
            or b.upd_candidate
        return out

    def _fmts(self, vids) -> List[str]:
        fmts = [_fmt(self.rec.values[v].dtype) for v in vids]
        return [f for f in fmts if f is not None]

    def _check_matmul(self, node) -> None:
        in_fmts = self._fmts(node.tensor_operands)
        out_fmts = self._fmts(node.outputs[:1])
        if not in_fmts or not out_fmts:
            return
        out_fmt = out_fmts[0]
        narrow = set(in_fmts) <= {"fp16"} | set(_FP8)
        widened = _RANK.get(out_fmt, 9) > max(
            _RANK.get(f, 0) for f in in_fmts)
        if narrow and not widened:
            op = packet(node.op)
            self._emit(
                node.index, rule="half-accumulation",
                message=(f"{op} with {'/'.join(sorted(set(in_fmts)))} "
                         f"operands accumulates in {out_fmt} — ask for "
                         "an f32 result"),
                op=op, scope=node.phase,
                dtype_from=sorted(in_fmts, key=lambda f:
                                  _RANK.get(f, 9))[0],
                dtype_to=out_fmt)

    def _check_reduction(self, node, prim, ins) -> None:
        in_fmts = self._fmts(node.tensor_operands)
        if not in_fmts:
            return
        narrowest = sorted(in_fmts, key=lambda f: _RANK.get(f, 9))[0]
        if narrowest in ("fp16",) + _FP8:
            sev = "warning"
        elif narrowest == "bf16":
            sev = "info"        # bf16 sums do accumulate in bf16 —
            # advisory (bf16 matmuls accumulate in f32 on the tensor
            # cores and are not flagged)
        else:
            return
        out_fmts = self._fmts(node.outputs[:1])
        out_fmt = out_fmts[0] if out_fmts else None
        if out_fmt is not None and _RANK.get(out_fmt, 0) > \
                _RANK.get(narrowest, 0):
            return              # widened accumulator
        op = packet(node.op)
        self._emit(
            node.index, rule="half-accumulation", severity=sev,
            message=(f"{prim} reduces {narrowest} operands directly — "
                     "the accumulator keeps the narrow mantissa"),
            op=op, scope=node.phase,
            dtype_from=narrowest, dtype_to=out_fmt or narrowest)


# -- entry points -------------------------------------------------------------

def analyze_record(record: StepRecord, *, policy=None) -> PrecisionAnalysis:
    """Run the precision dataflow pass over one record; returns findings
    and site counts."""
    interp = _Interp(record, policy=policy)
    interp.run()
    return PrecisionAnalysis(
        findings=_fold(interp.findings),
        n_cast_sites=interp.n_cast_sites,
        n_matmul_sites=interp.n_matmul_sites,
        n_reduction_sites=interp.n_reduction_sites,
        n_loss_scale_tokens=len(interp._active))


def precision_findings(record: StepRecord, *, policy=None) -> List[Finding]:
    """The findings-only view of :func:`analyze_record`."""
    return analyze_record(record, policy=policy).findings


def _fold(findings: List[Finding]) -> List[Finding]:
    """Fold same-fingerprint findings into one with a count (the
    fingerprint excludes dtype evidence, so the fold keeps the first
    occurrence's pair — the baseline workflow stays one line per
    site)."""
    by_fp: Dict[str, Finding] = {}
    for f in findings:
        fp = f.fingerprint() + f"|{f.severity}"
        if fp in by_fp:
            by_fp[fp].count += f.count
        else:
            by_fp[fp] = f
    return list(by_fp.values())
