"""One-stop step profiling: capture, per-kernel report, MFU.

The port of ``apex_tpu/prof/report.py``. ``profile_step`` runs a step
``warmup`` times, times ``iters`` runs on the host, then runs ``iters``
more under ``torch.profiler`` (the **guarded session** below), writes the
session's Chrome trace, parses it (:mod:`apex_tpu_torch.prof.xplane`) and
counts one more run's FLOPs (:mod:`apex_tpu_torch.prof.cost`)::

    rep = prof.profile_step(step, state, toks, labels)
    print(rep.table())
    rep.mfu()                    # None where the card's peak is unknown

**The guarded session.** On the H100 a profiler session loses the records
of its first few kernels (their launches' records stay), more the older
the process. Every session therefore first launches ``_LEAD[0]`` short
spin kernels for the loss to take, then a ~50 ms spin, the measured work
and a last short spin, and counts only if it kept one of the first spins,
the long one and the last; a session that did not is taken again with
twice as many first spins, and the longer lead stays for the rest of the
process (:func:`guarded_session`; ``chip_smoke.device_ms`` and
:func:`profile_step` both go through it). The spins are told apart by
name and left out.

Peaks are the data sheet's, keyed by ``torch.cuda.get_device_name()``;
on the CPU (or a card not in the tables) they are 0 and MFU is ``None``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["trace", "profile_step", "StepReport", "PEAK_FLOPS",
           "PEAK_F32_FLOPS", "PEAK_TF32_FLOPS", "PEAK_HBM_BW",
           "HBM_BYTES_PER_S", "BF16_FLOPS", "TF32_FLOPS", "F32_FLOPS",
           "device_peak_flops", "device_peak_hbm_bw",
           "device_kind", "lookup_peak", "guarded_session", "device_ms",
           "WINDOW"]

#: H100 SXM data sheet: HBM3 bandwidth, dense bf16/fp16 and TF32
#: tensor-core peaks, and the f32 peak outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 494.7e12
F32_FLOPS = 67e12

#: peak dense bf16/fp16 FLOP/s by ``torch.cuda.get_device_name()`` prefix
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": BF16_FLOPS}
#: peak f32 FLOP/s (the rate the f32 elementwise kernels are held to)
PEAK_F32_FLOPS = {"NVIDIA H100 80GB HBM3": F32_FLOPS}
#: peak dense TF32 FLOP/s
PEAK_TF32_FLOPS = {"NVIDIA H100 80GB HBM3": TF32_FLOPS}
#: peak device-memory bytes/s
PEAK_HBM_BW = {"NVIDIA H100 80GB HBM3": HBM_BYTES_PER_S}
#: the tables by the name a cost's ``peak`` gives; "3xtf32" is the rate
#: of f32 products made of three TF32 products each (hi·hi + hi·lo +
#: lo·hi, as the generic flash kernels run f32), a third of TF32's
PEAK_TABLES = {"bf16": PEAK_FLOPS, "f32": PEAK_F32_FLOPS,
               "3xtf32": {k: v / 3 for k, v in PEAK_TF32_FLOPS.items()},
               "hbm": PEAK_HBM_BW}

#: the range :func:`profile_step` opens around its measured runs
WINDOW = "apex_tpu_torch::profile_step"

# clock cycles of the spin that opens each guarded session (~50 ms at the
# H100's 1.98 GHz) and of the short spins around it
PAD_CYCLES, SHORT_CYCLES = 100_000_000, 1000
# short spins each guarded session launches first, doubled for the rest of
# the process whenever a session loses records, up to MAX_LEAD
_LEAD, MAX_LEAD = [64], 16384
# the most leading records one accepted session lost
_LOST = [0]
# the spin kernel's name, as the profiler reports it
_SPIN_NAMES: set = set()


def lookup_peak(table, kind: str) -> float:
    """Device-name prefix match into a peak table, 0.0 when unknown."""
    for k, v in table.items():
        if kind.startswith(k):
            return v
    return 0.0


def device_kind(device=None) -> str:
    """``torch.cuda.get_device_name`` of a CUDA device, else ``"cpu"``."""
    import torch
    if device is not None and torch.device(device).type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(device)


def device_peak_flops(device=None) -> float:
    """Peak dense bf16 FLOP/s of a card, 0.0 if unknown (the CPU)."""
    return lookup_peak(PEAK_FLOPS, device_kind(device))


def device_peak_hbm_bw(device=None) -> float:
    """Peak device-memory bytes/s of a card, 0.0 if unknown (the CPU)."""
    return lookup_peak(PEAK_HBM_BW, device_kind(device))


@contextlib.contextmanager
def trace(logdir: str, *, cuda: bool = True, record_shapes: bool = True):
    """A ``torch.profiler`` session whose Chrome trace is written to
    ``logdir/trace.pt.trace.json`` on exit. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts, record_shapes=record_shapes) as p:
        yield p
    p.export_chrome_trace(os.path.join(logdir, "trace.pt.trace.json"))


# --- the guarded session -----------------------------------------------------

def _session(run, record_shapes=False):
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as p:
        for _ in range(_LEAD[0]):
            torch.cuda._sleep(SHORT_CYCLES)
        torch.cuda._sleep(PAD_CYCLES)
        run()
        torch.cuda._sleep(SHORT_CYCLES)
        torch.cuda.synchronize()
    return p


def spin_names() -> set:
    """The spin kernel's profiler names, from one session of spins."""
    if not _SPIN_NAMES:
        _SPIN_NAMES.update(e.name for e in guarded_session(
            lambda: None, lambda ks: len(ks) >= 3, named=False)[1])
    return _SPIN_NAMES


def bracketed(kernels) -> bool:
    """The session kept one of its first spins, the long one and the
    last."""
    return sum(e.name in _SPIN_NAMES for e in kernels) >= 3


def guarded_session(run: Callable[[], None], kept: Callable = bracketed, *,
                    record_shapes: bool = False, named: bool = True):
    """``(profiler, device kernel events)`` of the first session of
    ``run`` whose kernels pass ``kept``; the lead doubles after each that
    did not. The spins are among the events (``spin_names()`` names
    them)."""
    from apex_tpu_torch.prof.xplane import device_kernels
    if named:
        spin_names()
    while True:
        p = _session(run, record_shapes)
        ks = device_kernels(p)
        if kept(ks):
            if _SPIN_NAMES:
                spins = sum(e.name in _SPIN_NAMES for e in ks)
                _LOST[0] = max(_LOST[0], _LEAD[0] + 2 - spins)
            return p, ks
        if _LEAD[0] >= MAX_LEAD:
            raise AssertionError("profiler sessions lost records after a "
                                 f"{_LEAD[0]}-kernel lead")
        _LEAD[0] *= 2
        print(f"prof: a profiler session lost records; sessions now open "
              f"with {_LEAD[0]} short spins", flush=True)


def device_ms(fn, iters: int = 10, flush=None) -> float:
    """Mean device time of one ``fn()`` call: the summed durations of the
    CUDA kernels it launches over ``iters`` calls in one guarded session,
    each call after ``flush()`` (an L2 sweep, whose kernels are told
    apart by name and left out), after 2 warm-up calls. No host time: not
    the wrapper's, not the gaps between a call's launches."""
    def calls():
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()

    for _ in range(2):
        fn()
    spin_names()
    flush_names = set()
    if flush is not None:
        flush_names = {e.name for e in guarded_session(
            flush, lambda ks: bracketed(ks)
            and len({e.name for e in ks}) > 1)[1]} - _SPIN_NAMES
    skip = _SPIN_NAMES | flush_names
    _, ks = guarded_session(calls, lambda ks: bracketed(ks) and (
        flush is None or sum(e.name in flush_names for e in ks) == iters))
    ks = [e for e in ks if e.name not in skip]
    if not ks:
        raise AssertionError("device_ms: the call launched no kernel")
    return sum(e.time_range.elapsed_us() for e in ks) / 1e3 / iters


# --- profile_step ------------------------------------------------------------

@dataclasses.dataclass
class StepReport:
    """Profile of one step: measured per-kernel times + counted costs."""

    profile: Any                      # xplane.TraceProfile
    cost: Dict[str, float]            # cost.cost_analysis of one run
    wall_us: float                    # host wall time per iteration
    iters: int
    logdir: str
    device: str = "cpu"               # torch.cuda.get_device_name or "cpu"
    counter: Any = None               # cost.CostCounter of the counted run
    kernel_calls: List = dataclasses.field(default_factory=list)

    @property
    def device_us(self) -> float:
        """Measured device time per iteration (the kernels' durations
        summed); the host wall time where no device ran (the CPU)."""
        if self.profile.ops:
            return self.profile.module_total_us / self.iters
        return self.wall_us

    def peak(self, peak_flops: Optional[float] = None) -> float:
        return (lookup_peak(PEAK_FLOPS, self.device)
                if peak_flops is None else peak_flops)

    def mfu(self, peak_flops: Optional[float] = None,
            on: str = "device") -> Optional[float]:
        """Model FLOPs utilization from the device (or ``on="wall"``)
        time; None when the peak or the FLOPs are unknown."""
        peak = self.peak(peak_flops)
        if not peak or not self.cost["flops"]:
            return None
        us = self.device_us if on == "device" else self.wall_us
        return self.cost["flops"] / (us * 1e-6) / peak

    def by_category(self) -> Dict[str, float]:
        return self.profile.by_category()

    def table(self, top: int = 20) -> str:
        mfu = self.mfu()
        mfu_s = "n/a" if mfu is None else f"{mfu:.1%}"
        head = (f"device={self.device} iters={self.iters} "
                f"wall/iter={self.wall_us:.0f}us "
                f"device/iter={self.device_us:.0f}us "
                f"flops={self.cost['flops']:.3g} "
                f"bytes={self.cost['bytes_accessed']:.3g} mfu={mfu_s}")
        cats = "  ".join(f"{k}={v / self.iters:.0f}us" for k, v in
                         list(self.by_category().items())[:8])
        return "\n".join([head, cats, self.profile.table(top=top)])


def _sync(device: str) -> None:
    import torch
    if device != "cpu":
        torch.cuda.synchronize()


def profile_step(fn, *args, iters: int = 5, warmup: int = 2,
                 logdir: Optional[str] = None, keep_trace: bool = False,
                 device: str = "cuda", count_flops: bool = True,
                 **kwargs) -> StepReport:
    """Profile ``fn(*args, **kwargs)`` end to end.

    Runs it ``warmup`` times, ``iters`` times on the host clock, ``iters``
    times in a guarded profiler session (``record_shapes=True``, inside a
    :data:`WINDOW` range) and, with ``count_flops``, once more under a
    cost counter — ``warmup + 2 * iters + 1`` runs in all, so a step that
    updates its state should be given a throwaway state. On the card
    (``device="cuda"``, the default) a session that records no CUDA kernel
    in the window raises; ``device="cpu"`` profiles the CPU alone.

    Without ``logdir`` a temp dir holds the trace and is **removed after
    parsing**; ``keep_trace=True`` keeps it (``python -m
    apex_tpu_torch.prof <dir>`` reads it). An explicit ``logdir`` is the
    caller's to clean up.
    """
    import torch
    from torch.profiler import record_function

    from apex_tpu_torch.ops import _priced
    from apex_tpu_torch.prof import cost as _cost
    from apex_tpu_torch.prof import xplane as _xplane

    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("profile_step: no CUDA device (pass device="
                           "'cpu' to profile the CPU)")
    kind = device_kind(device) if cuda else "cpu"
    own_tmpdir = logdir is None
    logdir = logdir or tempfile.mkdtemp(prefix="apex_tpu_torch_prof_")
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.pt.trace.json")
    calls: List = []

    def window():
        _priced.PROFILED_CALLS.clear()
        _priced.LOG_ON[0] = True
        try:
            with record_function(WINDOW):
                for _ in range(iters):
                    fn(*args, **kwargs)
                _sync(kind)
        finally:
            _priced.LOG_ON[0] = False
        calls[:] = list(_priced.PROFILED_CALLS)
        _priced.PROFILED_CALLS.clear()

    try:
        for _ in range(max(warmup, 1)):
            fn(*args, **kwargs)
        _sync(kind)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args, **kwargs)
        _sync(kind)
        wall = (time.perf_counter() - t0) / iters
        if cuda:
            p, _ = guarded_session(window, record_shapes=True)
        else:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU],
                         record_shapes=True) as p:
                window()
        p.export_chrome_trace(path)
        prof = _xplane.parse_trace(path, window=WINDOW)
        if cuda and not prof.ops:
            raise RuntimeError("profile_step: the session recorded no CUDA "
                               "kernel in its window")
        counter = None
        cost = {"flops": 0.0, "bytes_accessed": 0.0, "optimal_seconds": 0.0}
        if count_flops:
            counter = _cost.count(fn, *args, **kwargs)
            cost = {"flops": counter.flops, "bytes_accessed": counter.bytes,
                    "optimal_seconds": _cost.optimal_seconds(
                        counter.ops.values(), kind)}
    finally:
        if own_tmpdir and not keep_trace:
            shutil.rmtree(logdir, ignore_errors=True)
            logdir = ""
    return StepReport(profile=prof, cost=cost, wall_us=wall * 1e6,
                      iters=iters, logdir=logdir, device=kind,
                      counter=counter, kernel_calls=calls)
