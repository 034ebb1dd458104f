"""Device-memory reports: per-class attribution, peak-live estimate, forecast.

The port of ``apex_tpu/prof/memory.py``. The JAX package reads XLA's
buffer assignment (``memory_analysis()``) and walks the scheduled HLO.
Eager PyTorch has no compiled program, so :func:`memory_report` **runs
the step once** under a ``TorchDispatchMode`` that records every storage
an op's result allocates (its bytes, the op, the named scope open at the
time) and a weakref finalizer on each result that marks when the last
tensor on that storage dies. That gives a liveness walk in op order and a
peak-live estimate with the class mix at the peak (``classes``: what is
live there, as the JAX package's classes are its buffer assignment's),
on the CPU and the card alike:

- **state** tensors (the arguments, walked with their paths, as the JAX
  side walks argument paths) are live for the whole step and classed by
  :func:`classify_arg_path`: ``params``, ``optimizer_state`` (the
  arena's flat moment buffers included), ``inputs``;
- **temps** are classed by :func:`classify_scope` from the open
  ``trace.span`` (``ddp/sync_gradients``, ``bucketNN`` -> ``comm``) and
  the op (the ``c10d`` collectives -> ``comm``), else ``activations``;
- the step's **outputs** (temps still referenced by what it returns) are
  ``outputs``.

:meth:`MemoryReport.forecast` scales the buffers whose leading dimension
is the batch linearly, and :meth:`~MemoryReport.max_batch` sets that
against :func:`hbm_capacity`. Counted bytes are tensor storage bytes, not
the caching allocator's rounded blocks nor library workspaces (cuBLAS).
``device_memory_sample`` reads ``torch.cuda.memory_stats``/``mem_get_info``
(nulls on the CPU).
"""

from __future__ import annotations

import dataclasses
import re
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu_torch.ops import _priced
from apex_tpu_torch.prof.cost import tensors_of
from apex_tpu_torch.utils.format import fmt_bytes

__all__ = ["MemoryReport", "BufferRecord", "memory_report", "hbm_capacity",
           "device_memory_sample", "BUFFER_CLASSES", "classify_arg_path",
           "classify_scope"]

#: attribution classes, in table order (the JAX package's)
BUFFER_CLASSES = ("params", "optimizer_state", "activations", "comm",
                  "inputs", "outputs")

#: the HLO collective opcodes (JAX) and the c10d op names (port) a temp
#: made by which is ``comm``
_COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                   "all-to-all", "collective-permute",
                   "collective-broadcast", "ragged-all-to-all", "c10d::")


def classify_arg_path(path: str) -> str:
    """Attribution class of a state tensor from its path in the state
    (``.opt_state.bufs['float32']``, ``.params['w']``)."""
    p = path.lower()
    if "opt_state" in p or "optimizer" in p:
        return "optimizer_state"
    if "residual" in p:                    # error-feedback comm residuals
        return "comm"
    if "scaler" in p or "metrics" in p:
        return "optimizer_state"           # training-state bookkeeping
    if "params" in p or "master" in p or "batch_stats" in p:
        return "params"
    return "inputs"


def classify_scope(scope: str, opcode: str) -> str:
    """Attribution class of a temp from the scope open when it was made
    and the op that made it."""
    if opcode.startswith(_COLLECTIVE_OPS):
        return "comm"
    if "ddp/sync_gradients" in scope or re.search(r"(^|/)bucket\d", scope):
        return "comm"
    return "activations"


def hbm_capacity(device=None) -> Optional[int]:
    """Device memory capacity in bytes, None on the CPU."""
    if not torch.cuda.is_available() or (
            device is not None and torch.device(device).type != "cuda"):
        return None
    return int(torch.cuda.get_device_properties(
        device or torch.cuda.current_device()).total_memory)


def device_memory_sample(device=None) -> Dict[str, Optional[int]]:
    """One allocator sample (host-side, no device work):
    ``{"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}``; nulls on
    the CPU."""
    if not torch.cuda.is_available() or (
            device is not None and torch.device(device).type != "cuda"):
        return {"bytes_in_use": None, "peak_bytes_in_use": None,
                "bytes_limit": None}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.mem_get_info(device)[1])}


@dataclasses.dataclass
class BufferRecord:
    """One attributed storage of the step."""

    name: str          # state path, or "<op>#<index>" for a temp
    kind: str          # "argument" | "temp" | "output"
    bytes: int         # storage bytes
    shape: str         # shape and dtype of the first tensor seen on it
    cls: str           # one of BUFFER_CLASSES
    scope: str         # state path (arguments) or named scope (temps)
    batch_scaled: bool = False   # leading dim == the given batch size


def _fmt_bytes(n: Optional[float]) -> str:
    return fmt_bytes(n)


@dataclasses.dataclass
class MemoryReport:
    """Per-class, per-buffer device-memory footprint of one step."""

    stats: Dict[str, int]             # at the peak: argument / output /
                                      # temp / total; and "allocated":
                                      # every temp of the step
    classes: Dict[str, int]           # BUFFER_CLASSES -> bytes at the peak
    buffers: List[BufferRecord]       # arguments + temps live at the peak
    peak_live_bytes: int              # arguments + peak live temps
    batch_size: Optional[int]
    batch_bytes: int                  # peak bytes scaling with the batch
    hbm_limit: Optional[int]          # device capacity, None on the CPU
    device_kind: str
    flops: float = 0.0
    #: (fixed, batch-scaled) live bytes after each allocation of the
    #: tracked run, arguments included: a forecast takes the largest
    #: over the run, so a peak that moves with the batch (the update's at
    #: a small batch, the backward's at a large one) is found
    timeline: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)

    @property
    def total_bytes(self) -> int:
        return self.stats["total"]

    def attributed_total(self) -> int:
        """Sum over classes; equals ``total_bytes`` (the peak) by
        construction."""
        return sum(self.classes.values())

    def forecast(self, batch: int) -> Dict[str, Any]:
        """Peak-live bytes at another batch size: batch-scaled buffers
        grow linearly, the rest is fixed."""
        if not self.batch_size or self.batch_size < 1:
            raise ValueError("report was built without batch_size=")
        scale = batch / self.batch_size
        if self.timeline:
            peak = int(max(f + s * scale for f, s in self.timeline))
        else:
            peak = int(self.peak_live_bytes - self.batch_bytes
                       + self.batch_bytes * scale)
        fits = None if self.hbm_limit is None else peak <= self.hbm_limit
        return {"batch": batch, "peak_bytes": peak, "fits": fits,
                "headroom_bytes": (None if self.hbm_limit is None
                                   else self.hbm_limit - peak)}

    def max_batch(self) -> Optional[int]:
        """Largest forecast batch that fits the device's capacity."""
        if self.hbm_limit is None or not self.batch_size:
            return None
        if self.timeline:
            limit, best = self.hbm_limit, None
            for f, s in self.timeline:
                if f > limit:
                    return 0
                if s > 0:
                    b = int((limit - f) / s * self.batch_size)
                    best = b if best is None else min(best, b)
            return best
        if self.batch_bytes <= 0:
            return None
        fixed = self.peak_live_bytes - self.batch_bytes
        if fixed >= self.hbm_limit:
            return 0
        per_item = self.batch_bytes / self.batch_size
        return int((self.hbm_limit - fixed) // per_item)

    def top_buffers(self, n: int = 8) -> List[BufferRecord]:
        return sorted(self.buffers, key=lambda r: -r.bytes)[:n]

    def table(self, top: int = 10) -> str:
        s = self.stats
        lines = [
            f"memory report — device={self.device_kind} at the peak "
            f"{_fmt_bytes(s['total'])} (args {_fmt_bytes(s['argument'])} + "
            f"out {_fmt_bytes(s['output'])} + temp {_fmt_bytes(s['temp'])}"
            f"); {_fmt_bytes(s['allocated'])} allocated over the step",
            f"peak live estimate: {_fmt_bytes(self.peak_live_bytes)}"
            + (f" of {_fmt_bytes(self.hbm_limit)}" if self.hbm_limit else "")
            + (f"; batch-scaled {_fmt_bytes(self.batch_bytes)} "
               f"@ b={self.batch_size}" if self.batch_size else ""),
            f"{'class':<16} {'bytes':>12} {'share':>7}"]
        total = max(self.attributed_total(), 1)
        for cls in BUFFER_CLASSES:
            b = self.classes.get(cls, 0)
            lines.append(f"{cls:<16} {_fmt_bytes(b):>12} "
                         f"{100.0 * b / total:>6.1f}%")
        lines.append(f"top buffers ({min(top, len(self.buffers))} of "
                     f"{len(self.buffers)}):")
        for r in self.top_buffers(top):
            lines.append(f"  {_fmt_bytes(r.bytes):>12} {r.cls:<16} "
                         f"{r.kind:<8} {(r.scope or r.name)[:60]}")
        mb = self.max_batch()
        if mb is not None:
            lines.append(f"forecast: max batch ~{mb} before device "
                         f"capacity")
        return "\n".join(lines)

    def summary(self, top: int = 5) -> Dict[str, Any]:
        return {
            "total_bytes": self.total_bytes,
            "attributed_bytes": self.attributed_total(),
            "peak_live_bytes": self.peak_live_bytes,
            "hbm_limit": self.hbm_limit,
            "batch_size": self.batch_size,
            "batch_bytes": self.batch_bytes,
            "classes": dict(self.classes),
            "top_buffers": [
                {"name": r.name, "bytes": r.bytes, "class": r.cls,
                 "scope": r.scope[:120]} for r in self.top_buffers(top)],
        }

    def to_event(self, rank: int = 0, step: Optional[int] = None) -> Dict:
        """``kind="memory_report"`` event (``check_metrics_schema.py
        --kind memory`` validates)."""
        ev: Dict[str, Any] = {"kind": "memory_report", "rank": rank,
                              "step": step}
        ev.update(self.summary())
        return ev


# --- the liveness tracker ----------------------------------------------------

class _Buf:
    """One tracked storage: born and died are op clocks; refs counts the
    live tensors on it the tracker has seen."""

    __slots__ = ("name", "bytes", "shape", "cls", "scope", "kind", "born",
                 "died", "refs", "lead")

    def __init__(self, name, nbytes, shape, cls, scope, kind, born, lead):
        self.name, self.bytes, self.shape = name, nbytes, shape
        self.cls, self.scope, self.kind = cls, scope, kind
        self.born, self.died, self.refs, self.lead = born, None, 0, lead


def _storage(t: torch.Tensor):
    try:
        st = t.untyped_storage()
        return st.data_ptr(), st.nbytes()
    except (RuntimeError, NotImplementedError):
        return 0, 0


def _desc(t: torch.Tensor) -> str:
    return f"{str(t.dtype)[6:]}{list(t.shape)}"


class _Tracker(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.lock = threading.Lock()
        self.live: Dict[int, _Buf] = {}
        self.all: List[_Buf] = []
        self.clock = 0
        self.live_bytes = 0
        self.peak = 0
        self.peak_clock = 0
        self.n = 0
        self.leads = set()
        self.live_scaled = 0
        self.timeline: List[Tuple[int, int]] = []

    def pin(self, t, name, cls, kind="argument"):
        ptr, nbytes = _storage(t)
        if not ptr or ptr in self.live:
            return
        b = _Buf(name, nbytes, _desc(t), cls, name, kind, -1,
                 t.shape[0] if t.dim() else None)
        b.refs = 1 << 30                     # the caller holds it
        self.live[ptr] = b
        self.all.append(b)

    def _release(self, ptr, buf):
        with self.lock:
            buf.refs -= 1
            if buf.refs == 0 and self.live.get(ptr) is buf:
                del self.live[ptr]
                buf.died = self.clock
                self.live_bytes -= buf.bytes
                if buf.lead in self.leads:
                    self.live_scaled -= buf.bytes

    def note(self, t, op):
        ptr, nbytes = _storage(t)
        if not ptr:
            return
        with self.lock:
            buf = self.live.get(ptr)
            if buf is None:
                from apex_tpu_torch.trace.spans import current_scope
                scope = current_scope()
                buf = _Buf(f"{op}#{self.n}", nbytes, _desc(t),
                           classify_scope(scope, op), scope, "temp",
                           self.clock, t.shape[0] if t.dim() else None)
                self.n += 1
                self.live[ptr] = buf
                self.all.append(buf)
                self.live_bytes += nbytes
                if buf.lead in self.leads:
                    self.live_scaled += nbytes
                self.timeline.append((self.live_bytes, self.live_scaled))
                if self.live_bytes > self.peak:
                    self.peak, self.peak_clock = self.live_bytes, self.clock
            buf.refs += 1
        weakref.finalize(t, self._release, ptr, buf)

    def kernel_out(self, name, out):
        outs: List[torch.Tensor] = []
        tensors_of(out, outs)
        with self.lock:
            self.clock += 1
        for t in outs:
            self.note(t, f"apex_tpu_torch::{name}")

    def __enter__(self):
        _priced.WATCHERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        _priced.WATCHERS.remove(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _priced.suppressed():
            return out                  # the kernel's: recorded on return
        with self.lock:
            self.clock += 1
        op = func._schema.name
        outs: List[torch.Tensor] = []
        tensors_of(out, outs)
        for t in outs:
            self.note(t, op)
        return out


def _paths(obj, prefix, out):
    from apex_tpu_torch.ckpt.snapshot import tree_paths
    for path, leaf in tree_paths(obj):
        if isinstance(leaf, torch.Tensor):
            out.append((prefix + path, leaf))


def memory_report(fn, *args, batch_size: Optional[int] = None,
                  batch_leads=None, device=None, **kwargs) -> MemoryReport:
    """Run ``fn(*args, **kwargs)`` once and report its device memory.

    **It runs the step**: give a step that updates its state a throwaway
    state. Arguments are walked with their paths (``args[0].params['w']``)
    and classed by :func:`classify_arg_path`; ``batch_size`` marks the
    buffers whose leading dimension is the batch, which drive
    :meth:`MemoryReport.forecast`; ``batch_leads`` (default
    ``(batch_size,)``) names every leading dimension that grows with the
    batch (a transformer's ``batch * seq`` token rows, ``batch * heads``).
    ``device`` (default: the device of the first tensor argument) picks
    the capacity and kind reported.
    """
    arg_leaves: List[Tuple[str, torch.Tensor]] = []
    _paths((args, kwargs), "", arg_leaves)
    if device is None:
        device = arg_leaves[0][1].device if arg_leaves else "cpu"
    leads = set(batch_leads) if batch_leads else {batch_size}
    tr = _Tracker()
    if batch_size and batch_size > 1:
        tr.leads = leads
    for path, t in arg_leaves:
        tr.pin(t, path, classify_arg_path(path))
    from apex_tpu_torch.trace import spans as _spans
    _spans.SCOPE_WATCH[0] += 1
    try:
        with tr:
            out = fn(*args, **kwargs)
    finally:
        _spans.SCOPE_WATCH[0] -= 1
    outs: List[Tuple[str, torch.Tensor]] = []
    _paths(out, "out", outs)
    out_ptrs = {_storage(t)[0] for _, t in outs}
    with tr.lock:
        bufs = list(tr.all)
        live_out = {ptr: b for ptr, b in tr.live.items() if ptr in out_ptrs}
    # the footprint at the peak, by class (the JAX package's classes are
    # its buffer assignment's: arguments, outputs and the packed temps)
    classes = {cls: 0 for cls in BUFFER_CLASSES}
    stats = {"argument": 0, "output": 0, "temp": 0, "allocated": 0}
    records: List[BufferRecord] = []
    batch_peak = 0
    out_bufs = set(map(id, live_out.values()))
    for b in bufs:
        if id(b) in out_bufs:
            b.kind, b.cls = "output", "outputs"
        if b.kind != "argument":
            stats["allocated"] += b.bytes
        live_at_peak = b.kind == "argument" or (
            b.born <= tr.peak_clock and (b.died is None
                                         or b.died >= tr.peak_clock))
        if not live_at_peak:
            continue
        stats[b.kind] += b.bytes
        classes[b.cls] += b.bytes
        scaled = bool(batch_size and batch_size > 1 and b.lead in leads)
        if scaled:
            batch_peak += b.bytes
        records.append(BufferRecord(
            name=b.name, kind=b.kind, bytes=b.bytes, shape=b.shape,
            cls=b.cls, scope=b.scope, batch_scaled=scaled))
    stats["total"] = stats["argument"] + stats["output"] + stats["temp"]
    arg_scaled = sum(b.bytes for b in bufs
                     if b.kind == "argument" and b.lead in tr.leads)
    timeline = [(stats["argument"] - arg_scaled + live - scaled,
                 arg_scaled + scaled) for live, scaled in tr.timeline]
    dev = torch.device(device)
    from apex_tpu_torch.prof.report import device_kind
    return MemoryReport(
        stats=stats, classes=classes, buffers=records,
        peak_live_bytes=stats["argument"] + tr.peak,
        batch_size=batch_size, batch_bytes=batch_peak,
        hbm_limit=hbm_capacity(dev) if dev.type == "cuda" else None,
        device_kind=device_kind(dev),
        timeline=timeline if tr.leads else [])
