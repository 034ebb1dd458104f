"""Compilation observability: build/JIT counters + retrace detector.

The port of ``apex_tpu/prof/compile_watch.py``. What compiles in the
port is not a traced program but:

- the CUDA and host libraries ``ops/_build.py`` builds with ``nvcc``/``g++``
  at their first use (``_build.BUILDS``);
- Triton's JIT specializations of the kernels ``_build.triton_jit`` made,
  one per new (constexpr, integer-divisibility, dtype) signature, counted
  from each kernel's specialization cache (``_build.JITTED``; Triton is
  imported by the kernels, never here);
- ``torch.compile`` graphs in user code (dynamo's ``unique_graphs``
  counter, read only once ``torch._dynamo`` is imported).

:func:`global_counters` sums them for the process.
:meth:`CompileWatcher.watch` wraps a step: per call it diffs the
argument signature (shape/dtype per tensor, value per Python scalar)
against the previous call's, counts a **retrace** when the signature is
one it has not seen (the JAX side's no-cache fallback: eager PyTorch has
no trace cache), reads the counters before and after, and when the call
compiled something records its wall time as a ``kind="compile"`` span in
the active :class:`apex_tpu_torch.trace.Tracer` (goodput's ``recompile``
bucket) and a ``kind="compile"`` event. After ``warn_after`` retraces it
warns. The port's CUDA kernels take their shapes at run time, so a new
shape rebuilds nothing; a Triton kernel recompiles only when a
specialization changes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import sys
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["CompileWatcher", "FunctionWatch", "global_counters",
           "reset_global_counters", "watch", "autotune_scope",
           "in_autotune", "signature", "diff_signatures"]

_base = {"builds": 0, "triton_compiles": 0, "dynamo_graphs": 0}
_autotune_tls = threading.local()


def _triton_specializations() -> int:
    from apex_tpu_torch.ops import _build
    n = 0
    for jf in _build.JITTED:
        caches = getattr(jf, "device_caches", None)
        if caches is not None:
            for v in caches.values():
                n += len(v[0] if isinstance(v, tuple) else v)
        else:
            n += sum(len(c) for c in getattr(jf, "cache", {}).values())
    return n


def _dynamo_graphs() -> int:
    if "torch._dynamo" not in sys.modules:
        return 0
    try:
        from torch._dynamo.utils import counters
        return int(counters["stats"]["unique_graphs"])
    except Exception:
        return 0


def _raw() -> Dict[str, float]:
    from apex_tpu_torch.ops import _build
    return {"builds": _build.BUILDS["nvcc"] + _build.BUILDS["host"],
            "build_secs": _build.BUILDS["secs"],
            "triton_compiles": _triton_specializations(),
            "dynamo_graphs": _dynamo_graphs()}


def global_counters() -> Dict[str, float]:
    """Process-wide counters since the last reset: ``builds`` (nvcc and
    host-compiler runs), ``triton_compiles``, ``dynamo_graphs`` and their
    sum ``compiles``."""
    raw = _raw()
    out = {k: raw[k] - _base.get(k, 0) for k in raw}
    out["compiles"] = (out["builds"] + out["triton_compiles"]
                       + out["dynamo_graphs"])
    return out


def reset_global_counters() -> None:
    raw = _raw()
    for k in _base:
        _base[k] = raw[k]


def in_autotune() -> bool:
    """True while an :func:`autotune_scope` is open on this thread."""
    return getattr(_autotune_tls, "depth", 0) > 0


@contextlib.contextmanager
def autotune_scope():
    """Tag the compiles of watched calls made inside it as
    autotune-origin (``FunctionWatch.n_autotune_compiles``), so a kernel
    sweep never reads as a retrace storm."""
    _autotune_tls.depth = getattr(_autotune_tls, "depth", 0) + 1
    try:
        yield
    finally:
        _autotune_tls.depth -= 1


def _aval_of(x) -> Tuple:
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return (tuple(x.shape), str(x.dtype).replace("torch.", ""))
    return ("static", repr(x)[:80])


def signature(args, kwargs) -> Tuple[Tuple[str, Tuple], ...]:
    """Hashable (path, shape/dtype) signature of a call's arguments,
    paths spelled as ``jax.tree_util.keystr`` spells them."""
    from apex_tpu_torch.ckpt.snapshot import tree_paths
    return tuple((path, _aval_of(leaf))
                 for path, leaf in tree_paths((args, kwargs)))


def diff_signatures(old, new) -> str:
    """What changed between two call signatures — names the argument(s)
    that made the call new."""
    if old is None:
        return "first call"
    old_d, new_d = dict(old), dict(new)
    changes = []
    for path, aval in new_d.items():
        prev = old_d.get(path)
        if prev is None:
            changes.append(f"{path or '<args>'}: new argument {aval}")
        elif prev != aval:
            changes.append(f"{path or '<args>'}: {prev} -> {aval}")
    for path in old_d:
        if path not in new_d:
            changes.append(f"{path or '<args>'}: removed")
    if not changes and len(old) != len(new):
        changes.append(f"argument count {len(old)} -> {len(new)}")
    return "; ".join(changes[:6]) or "unknown (same avals — static or " \
        "tracing-context change)"


@dataclasses.dataclass
class FunctionWatch:
    """Counters for one watched function."""

    name: str
    n_calls: int = 0
    n_traces: int = 0            # distinct signatures called
    n_retraces: int = 0          # signatures beyond the first
    n_compiles: int = 0          # builds + Triton + dynamo, in its calls
    n_autotune_compiles: int = 0
    compile_secs: float = 0.0    # wall time of the calls that compiled
    last_signature: Optional[Tuple] = None
    last_change: Optional[str] = None
    retraces: List[Dict] = dataclasses.field(default_factory=list)
    per_call: List[int] = dataclasses.field(default_factory=list)
    warned: bool = False
    _seen: set = dataclasses.field(default_factory=set)

    def to_events(self, rank: int = 0) -> List[Dict]:
        """``kind="retrace"`` events for the memory channel."""
        return [dict(ev, kind="retrace", rank=rank, fn=self.name)
                for ev in self.retraces]


class CompileWatcher:
    """Watches step functions for new signatures and compiles::

        watcher = prof.CompileWatcher(warn_after=3)
        step = watcher.watch(step_fn, name="train_step")
        ...
        print(watcher.report())

    ``on_event`` callbacks receive each ``kind="retrace"`` /
    ``kind="compile"`` event (``MetricsLogger.record_memory`` streams
    them)."""

    def __init__(self, *, warn_after: int = 3,
                 on_event: Optional[Callable[[Dict], None]] = None):
        self.warn_after = max(int(warn_after), 1)
        self._on_event: List[Callable[[Dict], None]] = (
            [on_event] if on_event else [])
        self.watches: Dict[str, FunctionWatch] = {}

    def subscribe(self, fn: Callable[[Dict], None]) -> None:
        self._on_event.append(fn)

    def __getitem__(self, name: str) -> FunctionWatch:
        return self.watches[name]

    def _emit(self, event: Dict) -> None:
        for fn in list(self._on_event):
            try:
                fn(dict(event))
            except Exception:
                pass               # observers never break the train loop

    def watch(self, fn: Callable, name: Optional[str] = None) -> Callable:
        """Wrap ``fn`` so every call updates its :class:`FunctionWatch`
        (reachable as ``wrapped.watch``)."""
        name = name or getattr(fn, "__name__", None) or repr(fn)[:40]
        rec = self.watches.setdefault(name, FunctionWatch(name=name))

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            sig = signature(args, kwargs)
            before = global_counters()["compiles"]
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            dt_ms = (time.perf_counter() - t0) * 1e3
            compiled = global_counters()["compiles"] - before
            rec.n_calls += 1
            rec.per_call.append(int(compiled))
            if sig not in rec._seen:
                self._on_trace(rec, sig)
            rec._seen.add(sig)
            rec.last_signature = sig
            if compiled:
                self._on_compile(rec, int(compiled), dt_ms)
            return out

        wrapped.watch = rec
        return wrapped

    def _on_compile(self, rec: FunctionWatch, n: int, dt_ms: float) -> None:
        rec.n_compiles += n
        if in_autotune():
            rec.n_autotune_compiles += n
        rec.compile_secs += dt_ms / 1e3
        # the call's wall time bounds the compile from above; back-dated,
        # since it is known only after the call returned
        from apex_tpu_torch.trace.spans import current_tracer
        tracer = current_tracer()
        if tracer is not None:
            tracer.add_span_event(f"compile/{rec.name}", "compile", dt_ms)
        self._emit({"kind": "compile", "fn": rec.name, "dur_ms": dt_ms,
                    "n_compiles": n, "n_traces": rec.n_traces,
                    "changed": rec.last_change,
                    "retrace": rec.n_traces > 1})

    def _on_trace(self, rec: FunctionWatch, sig) -> None:
        rec.n_traces += 1
        change = diff_signatures(rec.last_signature, sig)
        rec.last_change = change
        if rec.n_traces == 1:
            return
        rec.n_retraces += 1
        ev = {"call": rec.n_calls, "changed": change}
        rec.retraces.append(ev)
        self._emit(dict(ev, kind="retrace", fn=rec.name,
                        n_traces=rec.n_traces))
        if rec.n_retraces >= self.warn_after and not rec.warned:
            rec.warned = True
            warnings.warn(
                f"apex_tpu_torch.prof.compile_watch: {rec.name!r} was "
                f"called with {rec.n_retraces} new signatures (last "
                f"change: {change}). A new shape can recompile Triton "
                f"kernels and re-plan the caching allocator — pin the "
                f"changing argument's shape/dtype.",
                RuntimeWarning, stacklevel=3)

    def counters(self) -> Dict[str, Dict]:
        out = {name: {
            "n_calls": r.n_calls, "n_traces": r.n_traces,
            "n_retraces": r.n_retraces, "n_compiles": r.n_compiles,
            "n_autotune_compiles": r.n_autotune_compiles,
            "compile_secs": round(r.compile_secs, 4),
            "last_change": r.last_change,
        } for name, r in self.watches.items()}
        out["_process"] = global_counters()
        return out

    def report(self) -> str:
        lines = [f"{'function':<28} {'calls':>6} {'traces':>7} "
                 f"{'retraces':>9} {'compiles':>9} {'compile_s':>10}"]
        for name, r in sorted(self.watches.items()):
            lines.append(
                f"{name[:28]:<28} {r.n_calls:>6} {r.n_traces:>7} "
                f"{r.n_retraces:>9} {r.n_compiles:>9} "
                f"{r.compile_secs:>10.3f}")
            for ev in r.retraces[-3:]:
                lines.append(f"    retrace @call {ev['call']}: "
                             f"{ev['changed'][:90]}")
        g = global_counters()
        lines.append(f"process totals: {g['builds']} builds "
                     f"({g['build_secs']:.2f}s), {g['triton_compiles']} "
                     f"Triton specializations, {g['dynamo_graphs']} "
                     f"torch.compile graphs")
        return "\n".join(lines)


def watch(fn: Callable, name: Optional[str] = None, *,
          warn_after: int = 3) -> Callable:
    """One-off convenience: wrap ``fn`` under a fresh
    :class:`CompileWatcher` (reachable as ``wrapped.watcher``)."""
    w = CompileWatcher(warn_after=warn_after)
    wrapped = w.watch(fn, name)
    wrapped.watcher = w
    return wrapped
