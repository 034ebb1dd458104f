"""NaN provenance: name the first span whose outputs went non-finite.

The port of ``apex_tpu/trace/debug_nans.py``. ``torch.autograd.
detect_anomaly`` localizes a NaN to an autograd node at the cost of a
host sync per node. This mode is coarser and cheaper: opt-in per-span
finiteness probes that ride the step on the device and report, on the
host, the first *span* ("amp/bwd", "fp16/unscale", your own
``@trace.span`` functions) whose outputs held a NaN/Inf — enough to know
which phase of the step to bisect.

Contract: with the mode OFF, :func:`nan_probe` returns its argument
object itself — no kernel, no host traffic. With it ON a probe never
syncs: each one reduces its tensors to one finite flag (the guard's
probe, ``guard.detect._all_finite``: a ``torch._foreach_norm(..., inf)``
per device and dtype, which propagates NaN) and folds ``where(
all_finite, NONE, tag)`` into one int64 device scalar per device with
``torch.minimum``. The tag is the probe's host
serial (program order) shifted past a small id of its span name, so the
minimum is the earliest bad probe in program order, whatever order the
device ran them in, and the host keeps only the table of span names.
:func:`first_nan` is the one read-back (``.item()``, which waits for the
probes queued before it): call it after the step, as the JAX docstring's
"fetch a step output before trusting None" says.

Usage::

    with trace.debug_nans():
        for batch in data:
            state, loss = step(state, batch)
            hit = trace.first_nan()
            if hit is not None:
                raise FloatingPointError(f"non-finite in {hit['span']}")
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional

import torch

from apex_tpu_torch.utils import tree_leaves

__all__ = ["debug_nans", "debug_nans_enabled", "nan_probe", "first_nan",
           "reset_nan_state"]

#: bits of a probe tag that hold its span name's id (the serial above)
_NAME_BITS = 16
#: the "no non-finite value yet" tag: larger than any probe's
_NONE = (1 << 62)

_enabled = False
_lock = threading.Lock()
#: {device: int64 0-d tensor}: the smallest bad tag since the last reset
_first: Dict[torch.device, torch.Tensor] = {}
_names: Dict[str, int] = {}
_name_of: Dict[int, str] = {}
_probe_serial = 0


def debug_nans_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Enable per-span finiteness probes for the steps run inside."""
    global _enabled
    prev = _enabled
    _enabled = bool(enable)
    try:
        yield
    finally:
        _enabled = prev


def reset_nan_state() -> None:
    """Forget any recorded non-finite hit (e.g. at each step boundary)."""
    with _lock:
        _first.clear()


def first_nan() -> Optional[Dict[str, Any]]:
    """The first recorded non-finite span since the last reset, or None.

    ``{"span": name, "order": probe-serial}`` — "first" means the
    earliest probe in program order that saw a non-finite value. Reads
    one scalar back per device (waiting for the probes queued before
    it)."""
    with _lock:
        firsts = list(_first.values())
    if not firsts:
        return None
    tag = min(int(t.item()) for t in firsts)
    if tag >= _NONE:
        return None
    return {"span": _name_of[tag & ((1 << _NAME_BITS) - 1)],
            "order": tag >> _NAME_BITS}


def nan_probe(name: str, tree: Any) -> Any:
    """Probe a tree of tensors for finiteness under the debug_nans mode.

    Mode off (the default): returns ``tree`` itself — nothing runs. Mode
    on: per device, reduces every floating leaf to one ``all finite``
    flag and folds this probe's tag into the device's first-bad scalar
    (no sync). The value itself passes through either way, so probes
    drop into any expression: ``grads = nan_probe("amp/bwd", grads)``.
    """
    if not _enabled:
        return tree
    from apex_tpu_torch.guard.detect import _all_finite
    global _probe_serial
    by_device: dict = {}
    for x in tree_leaves(tree):
        if (isinstance(x, torch.Tensor) and x.is_floating_point()
                and x.numel()):
            by_device.setdefault(x.device, []).append(x.detach())
    if not by_device:
        return tree
    with _lock:
        _probe_serial += 1
        nid = _names.get(name)
        if nid is None:
            nid = _names[name] = len(_names)
            _name_of[nid] = name
        tag = (_probe_serial << _NAME_BITS) | nid
        for device, leaves in by_device.items():
            bad = torch.where(_all_finite(leaves), _NONE, tag)
            prev = _first.get(device)
            _first[device] = bad if prev is None else torch.minimum(prev,
                                                                    bad)
    return tree
