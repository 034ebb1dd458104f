"""FLOPs and bytes of one run of a step — the port of
``apex_tpu/prof/hlo.py``.

The JAX package asks XLA: the compiled executable's cost analysis, and
per-instruction estimates parsed from its optimized HLO. Eager PyTorch
compiles no program, so the port counts one run instead:

- **aten ops** through a ``TorchDispatchMode`` (:class:`CostCounter`):
  FLOPs by ``torch.utils.flop_counter``'s formula registry (matmuls,
  convolutions, SDPA), bytes as the operands read plus the results
  written (views move nothing);
- **the hand kernels** through the registry :data:`KERNEL_COSTS`: one
  entry per ``ops.KERNELS`` name giving (flops, bytes, int_ops, peak) from
  the call's shapes — the formulas ``chip_smoke.py`` prices each kernel's
  bound with. Those kernels launch through ``ctypes`` and Triton, so no
  counter of PyTorch's sees them; their wrappers
  (:mod:`apex_tpu_torch.ops._priced`) report each call here, and on the
  CPU the plain version's aten ops are hidden from the counter, so the
  CPU and the card count the same FLOPs for the same step. Flash
  attention is priced as the JAX roofline prices it: 4·B·H·Sq·Sk·D
  forward, 10·B·H·Sq·Sk·D backward.

``compiled_hlo``, ``op_estimates_from_text`` and ``iter_instructions``
have no analogue: the port produces no HLO text.

Counting runs the step: a step that updates its state in place (the
port's step builders return a new state, but their arena buffers and
counters move) should be given a throwaway state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu_torch.ops import _priced
from apex_tpu_torch.prof.report import (F32_FLOPS, HBM_BYTES_PER_S,
                                        PEAK_TABLES, device_kind,
                                        lookup_peak)

__all__ = ["Cost", "CostCounter", "OpEstimate", "KERNEL_COSTS",
           "kernel_cost", "bound_ms", "cost_analysis", "op_estimates",
           "op_key", "HASH_OPS"]

#: integer operations of the dropout hash per score element (mix,
#: avalanche, compare, select and scale), counted at the f32 rate of the
#: CUDA cores
HASH_OPS = 20


class Cost(NamedTuple):
    """One call's analytic cost: ``peak`` names the rate its FLOPs run
    at (``"bf16"`` tensor cores or ``"f32"``); ``int_ops`` run at the f32
    rate."""

    flops: float
    bytes: float
    int_ops: float = 0.0
    peak: str = "bf16"
    sig: str = ""


def bound_ms(nbytes: float, flops: float, peak: float,
             int_ops: float = 0.0, hbm: float = HBM_BYTES_PER_S,
             f32: float = F32_FLOPS) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their peak rates."""
    return max(nbytes / hbm, max(flops / peak, int_ops / f32)) * 1e3


def _nbytes(*objs) -> int:
    n = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            n += o.numel() * o.element_size()
        elif isinstance(o, (list, tuple)):
            n += _nbytes(*o)
    return n


def _sig(*ts) -> str:
    return ",".join("x".join(map(str, t.shape)) + ":" + str(t.dtype)[6:]
                    for t in ts if isinstance(t, torch.Tensor))


def _ln_fwd(args, kw, out):
    x, w, b = args[:3]
    return Cost(0.0, _nbytes(x, w, b, out), peak="bf16", sig=_sig(x, w))


def _ln_bwd(args, kw, out):
    g, x, w = args[:3]
    return Cost(0.0, _nbytes(g, x, w, out), peak="bf16", sig=_sig(x, w))


def _ce_fwd(args, kw, out):
    x, labels = args[:2]
    return Cost(0.0, _nbytes(x, labels, out), sig=_sig(x, labels))


def _ce_bwd(args, kw, out):
    x, labels, lse, g = args[:4]
    return Cost(0.0, _nbytes(x, labels, lse, g, out), sig=_sig(x, labels))


def _flash_opts(args, kw, first):
    names = ("bias", "causal", "causal_off", "seed", "rate")
    opts = dict(zip(names, args[first:]))
    opts.update({k: v for k, v in kw.items() if k in names})
    return opts


def _flash(args, kw, out, fwd):
    q, k = args[0], args[1]
    b, sq, h, d = q.shape
    sk = k.shape[1]
    opts = _flash_opts(args, kw, 4 if fwd else 7)
    rate = opts.get("rate") or 0.0
    ins = args[:3] if fwd else args[:6]
    nbytes = _nbytes(*ins, opts.get("bias"), out)
    factor = 4.0 if fwd else 10.0
    return Cost(factor * b * h * sq * sk * d, nbytes,
                HASH_OPS * b * h * sq * sk if rate else 0.0,
                "f32" if q.dtype == torch.float32 else "bf16",
                _sig(q, k) + (f",rate={rate}" if rate else "")
                + (",bias" if opts.get("bias") is not None else ""))


def _elementwise(per_elem: float):
    def cost(args, kw, out):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        n = tensors[0].numel()
        return Cost(per_elem * n, _nbytes(*tensors, out), peak="f32",
                    sig=_sig(tensors[0]))
    return cost


def _bn(per_elem: float):
    def cost(args, kw, out):
        x2 = args[0]
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        return Cost(per_elem * x2.numel(), _nbytes(*tensors, out),
                    peak="f32", sig=_sig(x2))
    return cost


def _mlp(args, kw, out):
    x, weights = args[0], list(args[1])
    biases = args[2] if len(args) > 2 else kw.get("biases")
    operand = args[4] if len(args) > 4 else kw.get("operand_dtype")
    flops = 2.0 * x.shape[0] * sum(w.shape[0] * w.shape[1] for w in weights)
    half = operand is not None or x.dtype in (torch.bfloat16, torch.float16)
    return Cost(flops, _nbytes(x, weights, biases, out),
                peak="bf16" if half else "f32",
                sig=_sig(x, *weights))


#: the registry: ``ops.KERNELS`` name -> ``cost(args, kwargs, out)``
KERNEL_COSTS = {
    "layer_norm_fwd": _ln_fwd,
    "layer_norm_bwd": _ln_bwd,
    "xentropy_fwd": _ce_fwd,
    "xentropy_bwd": _ce_bwd,
    "flash_attn_fwd": lambda a, k, o: _flash(a, k, o, True),
    "flash_attn_bwd": lambda a, k, o: _flash(a, k, o, False),
    "multi_tensor_l2norm": _elementwise(2),
    "lamb_stage1": _elementwise(15),
    "lamb_stage2": _elementwise(3),
    "bn_sums": _bn(5),
    "bn_dx": _bn(6),
    "sgd": _elementwise(6),
    "adam": _elementwise(18),
    "multi_tensor_maxnorm": _elementwise(1),
    "multi_tensor_scale": _elementwise(1),
    "multi_tensor_axpby": _elementwise(3),
    "adagrad": _elementwise(10),
    "novograd": _elementwise(11),
    "mlp_fwd": _mlp,
    "flash_generic_fwd": lambda a, k, o: _flash(a, k, o, True),
    "flash_generic_bwd": lambda a, k, o: _flash(a, k, o, False),
}


def kernel_cost(name: str, args, kwargs, out) -> Cost:
    """The registry cost of one call of the hand kernel ``name``."""
    return KERNEL_COSTS[name](args, kwargs or {}, out)


# --- aten ops ----------------------------------------------------------------

def _dims_of(obj, out: List[Tuple[int, ...]]) -> None:
    if isinstance(obj, torch.Tensor):
        if obj.dim() > 0:
            out.append(tuple(obj.shape))
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _dims_of(o, out)


def op_key(name: str, dims) -> str:
    """The join key of one aten call: its name and the shapes of its
    tensor operands (0-d tensors left out), as the profiler's
    ``Input Dims`` give them with ``record_shapes=True``."""
    return name + str(tuple(tuple(d) for d in dims))


def trace_dims(input_dims) -> List[Tuple[int, ...]]:
    """A profiler event's ``Input Dims`` as :func:`op_key` takes them."""
    out: List[Tuple[int, ...]] = []
    for d in input_dims or ():
        if d and isinstance(d[0], (list, tuple)):
            out.extend(tuple(x) for x in d if x)
        elif d:
            out.append(tuple(d))
    return out


def _op_bytes(t: torch.Tensor) -> int:
    try:
        return min(t.numel() * t.element_size(),
                   t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return t.numel() * t.element_size()


def tensors_of(obj, out: List[torch.Tensor]) -> None:
    """Append every tensor in ``obj`` (nested lists, tuples, dicts) to
    ``out``."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            tensors_of(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            tensors_of(o, out)


#: aten ops that read only the rows their indices name
_GATHERS = ("aten::embedding", "aten::index_select", "aten::gather",
            "aten::index", "aten::take")


def _peak_name(dtype) -> str:
    if dtype in (torch.float32, torch.float64):
        return "f32"
    return "bf16"


@dataclasses.dataclass
class OpEstimate:
    """One aten op (name and operand shapes) or hand kernel (name and
    signature) of a counted run: cost per call, and its call count."""

    name: str               # the join key (op_key) or "apex_tpu_torch::k[sig]"
    opcode: str             # "aten::mm" or "apex_tpu_torch::layer_norm_fwd"
    flops: float            # per call
    bytes: float            # per call: operands read + results written
    count: int
    dtype: str
    int_ops: float = 0.0
    peak: str = "bf16"      # the rate its FLOPs run at: "bf16" | "f32"
    in_bytes: float = 0.0   # per call: the operands' share of ``bytes``


class _Mode(TorchDispatchMode):
    def __init__(self, counter: "CostCounter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _priced.suppressed():
            self.counter._add_op(func, args, kwargs, out)
        return out


class CostCounter:
    """``with CostCounter() as c: step(...)`` counts the FLOPs and bytes
    of every aten op and hand-kernel call the body runs, on every thread
    the autograd engine uses. ``c.flops``, ``c.bytes``, ``c.estimates()``."""

    def __init__(self):
        self.ops: Dict[str, OpEstimate] = {}
        self._mode = _Mode(self)
        try:
            from torch.utils.flop_counter import flop_registry
        except ImportError:          # pragma: no cover - older torch
            flop_registry = {}
        self._flops = flop_registry

    def __enter__(self) -> "CostCounter":
        _priced.COUNTERS.append(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._mode.__exit__(*exc)
        _priced.COUNTERS.remove(self)

    def _add(self, key, opcode, flops, nbytes, dtype, int_ops=0.0,
             peak="bf16", in_bytes=0.0) -> None:
        est = self.ops.get(key)
        if est is None:
            self.ops[key] = OpEstimate(key, opcode, float(flops),
                                       float(nbytes), 1, dtype,
                                       float(int_ops), peak,
                                       float(in_bytes))
        else:
            est.count += 1

    def _add_op(self, func, args, kwargs, out) -> None:
        name = func._schema.name
        dims: List[Tuple[int, ...]] = []
        _dims_of(list(args) + list(kwargs.values()), dims)
        ins: List[torch.Tensor] = []
        tensors_of((args, kwargs), ins)
        outs: List[torch.Tensor] = []
        tensors_of(out, outs)
        fn = self._flops.get(func._overloadpacket)
        flops = 0.0
        if fn is not None:
            try:
                flops = float(fn(*args, **kwargs, out_val=out))
            except Exception:
                flops = 0.0
        if getattr(func, "is_view", False):
            in_bytes = out_bytes = 0
        else:
            out_bytes = sum(_op_bytes(t) for t in outs)
            if name in _GATHERS:
                # a gather reads the rows it gathers, not its whole table
                in_bytes = out_bytes + sum(
                    _op_bytes(t) for t in ins
                    if not (t.is_floating_point() or t.is_complex()))
            else:
                in_bytes = sum(_op_bytes(t) for t in ins)
        dtype = ins[0].dtype if ins else (outs[0].dtype if outs else None)
        self._add(op_key(name, dims), name, flops, in_bytes + out_bytes,
                  str(dtype)[6:] if dtype is not None else "?",
                  peak=_peak_name(dtype), in_bytes=in_bytes)

    def add_kernel(self, name: str, cost: Cost) -> None:
        self._add(f"apex_tpu_torch::{name}[{cost.sig}]",
                  f"apex_tpu_torch::{name}", cost.flops, cost.bytes,
                  cost.sig.split(":")[1].split(",")[0] if ":" in cost.sig
                  else "?", cost.int_ops, cost.peak)


    @property
    def flops(self) -> float:
        return sum(e.flops * e.count for e in self.ops.values())

    @property
    def bytes(self) -> float:
        return sum(e.bytes * e.count for e in self.ops.values())

    def estimates(self, top: Optional[int] = None) -> List[OpEstimate]:
        out = sorted(self.ops.values(),
                     key=lambda e: (-e.flops * e.count, -e.bytes * e.count))
        return out[:top] if top else out


def optimal_seconds(ests, kind: Optional[str] = None) -> float:
    """The sum of every call's bound on the card ``kind`` (0 where its
    peaks are unknown, as on the CPU)."""
    kind = device_kind() if kind is None else kind
    hbm = peak_of("hbm", kind)
    if not hbm:
        return 0.0
    return sum(e.count * bound_ms(e.bytes, e.flops, peak_of(e.peak, kind),
                                  e.int_ops, hbm, peak_of("f32", kind))
               for e in ests) / 1e3


def count(fn, *args, **kwargs) -> CostCounter:
    """Run ``fn(*args, **kwargs)`` once under a :class:`CostCounter`."""
    with CostCounter() as c:
        fn(*args, **kwargs)
    return c


def cost_analysis(fn, *args, **kwargs) -> Dict[str, float]:
    """``{"flops", "bytes_accessed", "optimal_seconds"}`` of one run of
    ``fn(*args, **kwargs)`` (it runs the step)."""
    c = count(fn, *args, **kwargs)
    return {"flops": c.flops, "bytes_accessed": c.bytes,
            "optimal_seconds": optimal_seconds(c.ops.values())}


def op_estimates(fn, *args, top: Optional[int] = None,
                 **kwargs) -> List[OpEstimate]:
    """Per-op estimates of one run of ``fn``, by FLOPs then bytes."""
    return count(fn, *args, **kwargs).estimates(top)


def peak_of(peak: str, kind: Optional[str] = None) -> float:
    """The rate of the peak named ``peak`` (``"bf16"``, ``"f32"`` FLOP/s
    or ``"hbm"`` bytes/s) on the card ``kind``; 0 where it is unknown."""
    return lookup_peak(PEAK_TABLES[peak], kind or device_kind())
