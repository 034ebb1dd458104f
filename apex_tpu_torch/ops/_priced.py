"""The cost hook of the kernel wrappers: what prices a hand kernel.

The port's hand kernels launch through ``ctypes`` and Triton, not through
``torch.library``, so neither ``torch.utils.flop_counter`` nor the
profiler's ``record_shapes`` sees them. Each kernel wrapper, and the plain
version that stands in for it on the CPU, is wrapped by :func:`priced`
under its ``ops.KERNELS`` name. While nothing observes, the wrapper costs
a list read and one ``torch.autograd._profiler_enabled()`` call: no
kernel, no host sync, and the launch counts are the kernel's own. While a
profiler runs it opens ``record_function("apex_tpu_torch::<name>")`` (the
range :mod:`apex_tpu_torch.prof.roofline` joins the launched kernels by)
and logs the call's registry cost; while a cost counter
(:class:`apex_tpu_torch.prof.cost.CostCounter`) is open it adds the
call's registry cost to it and hides the plain version's aten ops from
it, so the CPU and the card count the same FLOPs for the same step; a
memory tracker records the call's outputs and not the plain version's
intermediates, for the same reason; a step record
(:func:`apex_tpu_torch.lint.record.record_step`) takes the call as one
kernel node (its inputs, outputs and declared writes), for the same
reason again. A priced call inside another (a plain version calling a
plain version) is not priced again.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, List

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

#: open cost counters, innermost last (process-wide: on a card the
#: autograd engine runs the backward on its own device thread)
COUNTERS: List = []
#: open memory trackers (:func:`apex_tpu_torch.prof.memory_report`): each
#: is handed a priced call's outputs, which it records as the kernel's
WATCHERS: List = []
#: ``(name, cost)`` of every priced call made while a profiler ran and
#: :data:`LOG_ON` was set, in call order (the profiled session clears it)
PROFILED_CALLS: List = []
#: open step records: each is told of a priced call before it runs
#: (``kernel_begin``) and handed its outputs after (``kernel_end``)
RECORDERS: List = []
LOG_ON = [False]
_depth = threading.local()


def suppressed() -> bool:
    """True inside a priced call: its aten ops are the kernel's."""
    return getattr(_depth, "n", 0) > 0


def priced(name: str) -> Callable:
    """Wrap a kernel wrapper or plain version as the kernel ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if (not COUNTERS and not WATCHERS and not RECORDERS
                    and not _profiler_enabled()):
                return fn(*args, **kwargs)
            return _observed(name, fn, args, kwargs)
        return wrapped
    return deco


def _observed(name, fn, args, kwargs):
    if suppressed():
        return fn(*args, **kwargs)
    calls = [r.kernel_begin(name, fn, args, kwargs) for r in RECORDERS]
    _depth.n = 1
    try:
        if _profiler_enabled():
            with record_function(f"apex_tpu_torch::{name}"):
                out = fn(*args, **kwargs)
        else:
            out = fn(*args, **kwargs)
    finally:
        _depth.n = 0
    for r, call in zip(RECORDERS, calls):
        r.kernel_end(call, out)
    for w in WATCHERS:
        w.kernel_out(name, out)
    if COUNTERS or (LOG_ON[0] and _profiler_enabled()):
        from apex_tpu_torch.prof.cost import kernel_cost
        cost = kernel_cost(name, args, kwargs, out)
        if COUNTERS:
            COUNTERS[-1].add_kernel(name, cost)
        if LOG_ON[0] and _profiler_enabled():
            PROFILED_CALLS.append((name, cost))
    return out
