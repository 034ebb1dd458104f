"""Validation of the no-host-sync telemetry contract.

The port of ``apex_tpu/monitor/check.py``. The monitor's device halves
(``Metrics``, the numerics and dynamics folds) must not change how a
step talks to the host: their counters ride the step's own kernels, and
nothing is read back until a logger flushes. The JAX package checks this
on the compiled HLO (one module, no host-traffic instruction). Eager
PyTorch has no module, so :func:`module_count_and_host_ops` runs the
step once and reports what it did instead.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["HOST_SYNC_OPS", "host_sync", "module_count_and_host_ops"]

_aten = torch.ops.aten

#: the aten ops that hand a device value to the host: ``.item()`` and
#: ``bool()`` (``_local_scalar_dense``), and the ops whose output shape
#: depends on the data, which a card must report back first
HOST_SYNC_OPS = (_aten._local_scalar_dense.default, _aten.nonzero.default,
                 _aten.masked_select.default, _aten._unique2.default,
                 _aten.equal.default, _aten.is_nonzero.default)


def host_sync(func, args, kwargs) -> Optional[str]:
    """What an aten call hands to the host, or None: the op's name for an op
    of :data:`HOST_SYNC_OPS`, ``"<op> <device>->cpu"`` for a copy from a
    device to the host (``.cpu()``, ``.tolist()``, ``.numpy()`` of a card
    tensor). The one test of :class:`_SyncSpy` and of the lint's record
    (``lint.record``, rule APX004)."""
    if func in HOST_SYNC_OPS:
        return str(func)
    if func in (_aten._to_copy.default, _aten.copy_.default):
        src = args[1] if func is _aten.copy_.default else args[0]
        dst = (args[0].device if func is _aten.copy_.default
               else kwargs.get("device"))
        if (isinstance(src, torch.Tensor) and src.device.type != "cpu"
                and dst is not None and torch.device(dst).type == "cpu"):
            return f"{func} {src.device}->cpu"
    return None


class _SyncSpy(TorchDispatchMode):
    """Records each host-sync op, and each copy from a device to the host
    (:func:`host_sync`)."""

    def __init__(self):
        super().__init__()
        self.seen: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        seen = host_sync(func, args, kwargs)
        if seen is not None:
            self.seen.append(seen)
        return func(*args, **kwargs)


def module_count_and_host_ops(fn, *args, **kwargs) -> Tuple[int, List[str]]:
    """(device kernels, host syncs) of one ``fn(*args, **kwargs)`` call.

    The first element counts the **kernels** the call launches on a card
    (from ``torch.profiler``, user annotations left out; 0 on the CPU,
    where nothing runs on a device), where the JAX package counts HLO
    modules: eager PyTorch compiles none. The second lists the call's host
    syncs: every op of :data:`HOST_SYNC_OPS` and every device-to-host copy,
    caught at the dispatcher on any device, and on a card also what
    ``torch.cuda.set_sync_debug_mode("warn")`` reports. A monitored step
    must list none."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    spy = _SyncSpy()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        prev = torch.cuda.get_sync_debug_mode() if cuda else 0
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with profile(activities=activities) as prof:
                with spy:
                    fn(*args, **kwargs)
                if cuda:
                    torch.cuda.set_sync_debug_mode(prev)
                    torch.cuda.synchronize()
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(prev)
    host = list(spy.seen)
    host += [str(w.message)[:160] for w in caught
             if "called a synchronizing" in str(w.message)]
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    return len(kernels), host
