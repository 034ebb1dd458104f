"""Trace parser — the port of ``apex_tpu/prof/xplane.py``.

The JAX package decodes ``jax.profiler``'s XSpace protobuf. The port reads
``torch.profiler``'s Chrome trace (``*.pt.trace.json``, as
``export_chrome_trace`` and ``tensorboard_trace_handler`` write it):

- **device kernels** are the ``kernel``/``gpu_memcpy``/``gpu_memset``
  events; the device-side spans of ``record_function`` ranges
  (``gpu_user_annotation``) are left out, since counting one would add a
  range's whole extent to the device time;
- each kernel is tied to the host call that launched it (its
  ``correlation`` id names a ``cuda_runtime``/``cuda_driver`` launch
  event) and so to the ranges open on that thread at the launch: the
  innermost aten op (``cpu_op``, with ``Input Dims`` under
  ``record_shapes=True``) and its parents, the hand kernel's
  ``apex_tpu_torch::<kernel>`` range, and the named scopes (``trace.span``
  ranges: ``amp/fwd``, ``ddp/sync_gradients``, ...);
- a kernel's **category** comes from its name (:func:`category`);
  NCCL's kernels (:data:`COLLECTIVE_PREFIXES`) are ``collective``.

:meth:`TraceProfile.from_profiler` parses a live ``torch.profiler``
session through the same reader. The JAX side's protobuf decoder has no
analogue.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

__all__ = ["OpRecord", "KernelEvent", "TraceProfile", "parse_trace",
           "latest_trace", "COLLECTIVE_PREFIXES", "category", "strip_scope",
           "device_kernels", "KERNEL_SCOPE"]

#: kernel-name prefixes of the collectives (NCCL's device kernels); the
#: port's collective scopes (``ddp/sync_gradients``, ``bucketNN``, ...)
#: are the registry's (:mod:`apex_tpu_torch.parallel.registry`)
COLLECTIVE_PREFIXES = ("ncclDevKernel", "ncclKernel")

#: prefix of the range each hand-kernel wrapper opens under a profiler
KERNEL_SCOPE = "apex_tpu_torch::"

#: kernel-name substrings -> category, first match wins
_CATEGORIES = (
    ("flash_attn", ("flash_fwd", "flash_bwd")),
    ("layer_norm", ("ln_fwd_warp<", "ln_fwd_block<", "ln_bwd_warp<",
                    "ln_bwd_block<")),
    ("xentropy", ("_ce_fwd_triton", "_ce_bwd_triton")),
    ("arena_lamb", ("_l2norm_partials_triton", "_l2norm_finish_triton",
                    "_lamb_stage1_triton", "_lamb_stage2_triton")),
    ("bn_sums", ("::bn_sums<",)),
    ("bn_dx", ("_bn_dx_triton",)),
    ("arena_sgd", ("_sgd_triton",)),
    ("arena_adam", ("_adam_triton",)),
    ("mlp_fwd", ("mlp_fused", "mlp_layer")),
    ("conv", ("fprop", "dgrad", "wgrad", "cudnn", "convolve", "conv2d",
              "nchwtonhwc", "nhwctonchw")),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "cublas")),
    ("collective", ("nccl",)),
    ("cast", ("direct_copy_kernel",)),
    ("elementwise", ("elementwise_kernel",)),
    ("reduce", ("reduce_kernel",)),
)

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_RANGE_CATS = ("cpu_op", "user_annotation")


def category(name: str) -> str:
    """The category of a device kernel, from its name."""
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "copy"
    return "other"


def strip_scope(scope: str) -> str:
    """A named-scope path without the profiler's own ranges
    (``ProfilerStep#N``, the :data:`~apex_tpu_torch.prof.report.WINDOW`,
    hand-kernel ranges) — the scope string :meth:`TraceProfile.by_scope`
    and the memory report key on."""
    return "/".join(p for p in scope.split("/")
                    if p and not p.startswith("ProfilerStep#")
                    and not p.startswith(KERNEL_SCOPE))


def device_kernels(prof):
    """The CUDA kernel (and memcpy/memset) events of a live profiler
    session, less the device-side spans of ``record_function`` ranges."""
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


@dataclasses.dataclass
class KernelEvent:
    """One device kernel and the host ranges open at its launch."""

    name: str
    ts: float                     # device start, us
    dur: float                    # us
    category: str
    scope: str                    # named-scope path (user ranges)
    kernel: str                   # hand kernel name, "" for aten's
    kernel_id: Tuple = ()         # (tid, ts) of the hand kernel's range
    ops: Tuple = ()               # enclosing aten ops, innermost first:
                                  # ((name, dims, (tid, ts)), ...)


@dataclasses.dataclass
class OpRecord:
    """Aggregated timing of one kernel name across a trace."""

    name: str           # kernel name
    opcode: str         # launching op: "aten::mm", "apex_tpu_torch::..."
    category: str
    occurrences: int
    total_us: float
    scope: str = ""     # named-scope path of its first launch

    @property
    def avg_us(self) -> float:
        return self.total_us / max(self.occurrences, 1)


@dataclasses.dataclass
class TraceProfile:
    """Parsed device activity of one trace."""

    path: str
    device: str                       # "cuda:0" or "" (no device kernels)
    ops: List[OpRecord]               # sorted by total_us desc
    module_runs: int                  # window ranges (0: whole trace)
    module_total_us: float            # summed kernel time in the windows
    kernels: List[KernelEvent] = dataclasses.field(default_factory=list)

    @classmethod
    def from_profiler(cls, prof, window: Optional[str] = None
                      ) -> "TraceProfile":
        """Parse a finished ``torch.profiler`` session (its Chrome trace,
        through a temp file)."""
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            return parse_trace(path, window=window)
        finally:
            os.unlink(path)

    def by_category(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.ops:
            out[r.category] = out.get(r.category, 0.0) + r.total_us
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def by_scope(self, depth: int = 2) -> Dict[str, float]:
        """Device time per named-scope prefix (``trace.span`` names):
        the first ``depth`` components of the ranges open at each launch;
        ``"(unscoped)"`` where none was."""
        out: Dict[str, float] = {}
        for r in self.ops:
            parts = [p for p in r.scope.split("/") if p]
            key = "/".join(parts[:depth]) if parts else "(unscoped)"
            out[key] = out.get(key, 0.0) + r.total_us
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def table(self, top: int = 20) -> str:
        total = sum(r.total_us for r in self.ops) or 1.0
        lines = [f"{'kernel':<40} {'category':<16} {'count':>6} "
                 f"{'total_us':>12} {'avg_us':>10} {'%':>6}"]
        for r in self.ops[:top]:
            lines.append(
                f"{r.name[:40]:<40} {r.category:<16} {r.occurrences:>6} "
                f"{r.total_us:>12.1f} {r.avg_us:>10.2f} "
                f"{100 * r.total_us / total:>5.1f}%")
        return "\n".join(lines)


def latest_trace(logdir: str) -> Optional[str]:
    """Newest ``*.json`` trace under a logdir, or None."""
    files = glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True)
    return max(files, key=os.path.getmtime) if files else None


def _enclosing(ranges, launches):
    """For each launch ``(ts, key)``, the ranges open at ``ts`` on its
    thread, outermost first. ``ranges``: ``[(ts, end, payload)]``."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    launches = sorted(launches)
    out, stack, i = {}, [], 0
    for ts, key in launches:
        while i < len(ranges) and ranges[i][0] <= ts:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        out[key] = [r for r in stack if r[1] >= ts]
    return out


def parse_trace(logdir_or_file: str, window: Optional[str] = None
                ) -> TraceProfile:
    """Parse a Chrome trace (or the newest one under a directory) into
    per-kernel records.

    ``window``: keep only the kernels launched while a range of that name
    was open (on any thread); ``module_runs`` counts those ranges. With no
    ``window`` (or none in the trace) every kernel counts. A trace with no
    device kernels (a CPU run) gives empty ``ops``.
    """
    path = logdir_or_file
    if os.path.isdir(path):
        found = latest_trace(path)
        if found is None:
            raise FileNotFoundError(f"no *.json trace under {path!r}")
        path = found
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])

    kernels, launches, ranges, windows = [], {}, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        if cat in _DEVICE_CATS:
            kernels.append(e)
        elif cat in _LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e["pid"], e["tid"], e["ts"])
        elif cat in _RANGE_CATS:
            if window is not None and e["name"] == window:
                windows.append((e["ts"], e["ts"] + e.get("dur", 0.0)))
            ranges.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e.get("dur", 0.0), e))

    # the ranges open at each kernel's launch
    per_thread: Dict = {}
    for i, k in enumerate(kernels):
        corr = (k.get("args") or {}).get("correlation")
        if corr in launches:
            pid, tid, ts = launches[corr]
            per_thread.setdefault((pid, tid), []).append((ts, i))
    open_at: Dict[int, Tuple[float, list]] = {}
    for thread, ls in per_thread.items():
        enc = _enclosing(ranges.get(thread, []), ls)
        for ts, i in ls:
            open_at[i] = (ts, enc.get(i, []))

    recs: Dict[str, OpRecord] = {}
    kept: List[KernelEvent] = []
    total = 0.0
    for i, k in enumerate(kernels):
        launch_ts, stack = open_at.get(i, (k["ts"], []))
        if windows and not any(a <= launch_ts <= b for a, b in windows):
            continue
        scope, kname, kid, ops = [], "", (), []
        for ts, _end, ev in stack:
            name = ev["name"]
            if ev.get("cat") == "cpu_op":
                ops.append((name, (ev.get("args") or {}).get("Input Dims"),
                            (ev.get("tid"), ts)))
            elif name.startswith(KERNEL_SCOPE) and name != window:
                kname, kid = name[len(KERNEL_SCOPE):], (ev.get("tid"), ts)
            elif name != window:
                scope.append(name)
        dur = float(k.get("dur", 0.0))
        ev = KernelEvent(
            name=k["name"], ts=k["ts"], dur=dur, category=category(k["name"]),
            scope=strip_scope("/".join(scope)), kernel=kname, kernel_id=kid,
            ops=tuple(reversed(ops)))
        kept.append(ev)
        total += dur
        rec = recs.get(ev.name)
        if rec is None:
            opcode = (KERNEL_SCOPE + kname if kname
                      else ev.ops[0][0] if ev.ops else "")
            rec = recs[ev.name] = OpRecord(
                name=ev.name, opcode=opcode, category=ev.category,
                occurrences=0, total_us=0.0, scope=ev.scope)
        rec.occurrences += 1
        rec.total_us += dur
    device = ""
    if kept:
        dev = (kernels[0].get("args") or {}).get("device")
        device = f"cuda:{dev}" if dev is not None else "cuda"
    ops = sorted(recs.values(), key=lambda r: -r.total_us)
    return TraceProfile(path=path, device=device, ops=ops,
                        module_runs=len(windows), module_total_us=total,
                        kernels=kept)
