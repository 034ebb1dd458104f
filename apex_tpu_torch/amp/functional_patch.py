"""Reversible patching of torch's functional entry points: O1 for raw ops.

The port of ``apex_tpu.amp.functional_patch``. Inside an ``auto_cast`` of a
policy with ``patch_ops`` (O1), the tensor-core entry points of torch's
namespaces cast their floating inputs to the policy's half dtype and the
softmax family to fp32, the split of the reference Apex's
``torch_overrides.py``:

- half: ``torch.einsum``, ``matmul``, ``mm``, ``bmm``, ``tensordot``,
  ``inner``, ``vdot``, ``dot`` and ``torch.nn.functional.conv{1,2,3}d``,
  ``conv_transpose{1,2,3}d``;
- float: ``torch.softmax``, ``torch.log_softmax`` and
  ``torch.nn.functional.softmax``, ``log_softmax``.

Tensor methods and the ``@`` operator stay unpatched, as the JAX package
leaves array methods alone.

The attribute patches are process-wide and reference-counted: installed by
the outermost ``auto_cast``, restored (every attribute, the same function
object) when it exits. The policy stack is thread-local, so a thread that
never entered ``auto_cast`` sees no cast, and nested scopes apply the
innermost policy's half dtype.

A ``backward()`` called inside the scope runs a custom ``autograd.Function``'s
backward on the caller's thread for CPU tensors and on autograd's own
device thread for CUDA tensors. PyTorch carries the caller's
``at::ThreadLocalState`` (grad mode, autocast, the torch-function mode
stack) into that thread, not Python's ``threading.local``. So while the
patch is in, ``torch.Tensor.backward``, ``torch.autograd.backward`` and
``torch.autograd.grad`` are wrapped too: called inside a scope, each runs
with a pass-through torch-function mode (:class:`_PolicyMode`) holding the
caller's half dtype on the mode stack, and :func:`half_operand_dtype`
falls back to it when the thread's own stack is empty. The backward sees
the policy of the thread that called ``backward()``, on the card as on the
CPU; the forward runs with no mode. Users may register their own ``(module,
attr)`` functions (``amp.register_half_op((mod, "f"))``); a user
registration wins over the built-in treatment of the same attribute.

The patch's reach follows the JAX package's, op for op: the port's modules
that ``auto_cast`` classifies (``Conv``, ``ConvTranspose``) and the fp32
plain versions of its kernels run their torch calls under :func:`suspend`,
where the JAX package reaches ``lax.dot_general`` or a Pallas kernel that
the patch never touches. The fused MLP, whose JAX kernel body calls the
patched ``jnp.dot``, reads :func:`half_operand_dtype` and rounds its
products' operands to it.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch.utils import tree_cast

_HALF_TARGETS = (
    (torch, "einsum"), (torch, "matmul"), (torch, "mm"), (torch, "bmm"),
    (torch, "tensordot"), (torch, "inner"), (torch, "vdot"), (torch, "dot"),
    (F, "conv1d"), (F, "conv2d"), (F, "conv3d"),
    (F, "conv_transpose1d"), (F, "conv_transpose2d"),
    (F, "conv_transpose3d"),
)

_FLOAT_TARGETS = (
    (torch, "softmax"), (torch, "log_softmax"),
    (F, "softmax"), (F, "log_softmax"),
)

# user-registered (module, attr) targets, wrapped before the built-ins
_USER_HALF_TARGETS: list = []
_USER_FLOAT_TARGETS: list = []

_lock = threading.Lock()
_patch_count = 0             # process-wide: are the attribute patches in?
_originals: list = []        # (module, attr, original) in install order
_tls = threading.local()     # per thread: suspend depth, policy stack


class _PolicyMode(torch.overrides.TorchFunctionMode):
    """A pass-through torch-function mode carrying a scope's half dtype into
    the thread autograd runs a backward on (see the module docstring)."""

    def __init__(self, half_dtype):
        super().__init__()
        self.half_dtype = half_dtype

    def __torch_function__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


#: the calls that start autograd's engine, wrapped by :func:`_wrap_autograd`
_AUTOGRAD_TARGETS = ((torch.Tensor, "backward"), (torch.autograd, "backward"),
                     (torch.autograd, "grad"))


def _carried_dtype() -> Optional[torch.dtype]:
    """The innermost :class:`_PolicyMode`'s half dtype in this thread's
    torch-function mode stack, else None."""
    for mode in reversed(torch.overrides._get_current_function_mode_stack()):
        if isinstance(mode, _PolicyMode):
            return mode.half_dtype
    return None


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def _suspended() -> bool:
    return getattr(_tls, "depth", 0) > 0


@contextlib.contextmanager
def suspend():
    """Run with the patches inert on this thread (module bodies whose
    precision ``auto_cast`` already decided; fp32 plain versions)."""
    _tls.depth = getattr(_tls, "depth", 0) + 1
    try:
        yield
    finally:
        _tls.depth -= 1


def unpatched(fn):
    """``fn`` run under :func:`suspend` (an fp32 plain version whose JAX
    counterpart the patch does not reach)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with suspend():
            return fn(*args, **kwargs)
    return wrapped


def half_operand_dtype() -> Optional[torch.dtype]:
    """The innermost policy's half dtype while the patch is installed on
    this thread and not suspended, else None: the dtype a patched
    ``jnp.dot`` would cast its operands to in the JAX package. A thread
    with no stack of its own (autograd's device thread running a backward
    that ``backward()`` started inside a scope) takes the dtype carried
    by the scope's :class:`_PolicyMode`."""
    if _suspended():
        return None
    stack = _stack()
    if stack:
        return stack[-1]
    if _patch_count == 0:
        return None
    return _carried_dtype()


def _wrap_half(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        dt = half_operand_dtype()
        if dt is None:
            return fn(*args, **kwargs)
        return fn(*tree_cast(args, dt), **tree_cast(kwargs, dt))
    wrapped.__wrapped_by_apex_tpu__ = True
    return wrapped


def _wrap_float(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if half_operand_dtype() is None:
            return fn(*args, **kwargs)
        return fn(*tree_cast(args, torch.float32),
                  **tree_cast(kwargs, torch.float32))
    wrapped.__wrapped_by_apex_tpu__ = True
    return wrapped


def _wrap_autograd(fn):
    """Start the engine with the caller's half dtype on the mode stack,
    which the engine hands to its device threads. Torch-function dispatch
    is off for the call: PyTorch pops a mode while its handler runs, so a
    call dispatched through the mode would start the engine without it.
    ``Tensor.backward`` calls ``autograd.backward``: one mode is pushed."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        dt = half_operand_dtype()
        if dt is None or _carried_dtype() == dt:
            return fn(*args, **kwargs)
        with _PolicyMode(dt), torch._C.DisableTorchFunction():
            return fn(*args, **kwargs)
    wrapped.__wrapped_by_apex_tpu__ = True
    return wrapped


def _restore_first(key):
    """Restore ``key``'s first-installed original (the true one) and drop
    every record of it; returns the original, or None if not patched."""
    matches = [i for i, (mod, name, _) in enumerate(_originals)
               if (mod, name) == key]
    if not matches:
        return None
    orig = _originals[matches[0]][2]
    for i in reversed(matches):
        del _originals[i]
    setattr(key[0], key[1], orig)
    return orig


def register_raw_target(module, attr: str, kind: str) -> None:
    """Give ``module.attr`` the patch's ``kind`` ('half' or 'float')
    treatment: at once inside a live scope, and in every later one.
    Registering with the other kind moves the target."""
    if kind not in ("half", "float"):
        raise ValueError(f"kind must be 'half' or 'float', got {kind!r}")
    if not callable(getattr(module, attr)):
        raise TypeError(f"{attr!r} on {module!r} is not callable")
    key = (module, attr)
    with _lock:
        for lst in (_USER_HALF_TARGETS, _USER_FLOAT_TARGETS):
            if key in lst:
                lst.remove(key)
        (_USER_HALF_TARGETS if kind == "half"
         else _USER_FLOAT_TARGETS).append(key)
        if _patch_count > 0:
            _restore_first(key)
            orig = getattr(module, attr)
            _originals.append((module, attr, orig))
            wrap = _wrap_half if kind == "half" else _wrap_float
            setattr(module, attr, wrap(orig))


def unregister_raw_target(module, attr: str) -> None:
    """Drop a user registration (idempotent). Inside a live scope the
    user's wrapper goes at once; a target that is also built in returns to
    its built-in treatment, never to the bare function."""
    key = (module, attr)
    with _lock:
        registered = False
        for lst in (_USER_HALF_TARGETS, _USER_FLOAT_TARGETS):
            if key in lst:
                lst.remove(key)
                registered = True
        if not registered or _patch_count == 0:
            return
        orig = _restore_first(key)
        if orig is None:
            return
        for targets, wrap in ((_HALF_TARGETS, _wrap_half),
                              (_FLOAT_TARGETS, _wrap_float)):
            if key in targets:
                _originals.append((module, attr, orig))
                setattr(module, attr, wrap(orig))
                break


def patch_functional(policy) -> None:
    """Install the casts for ``policy`` (pair with
    :func:`unpatch_functional`; nested calls push the policy)."""
    global _patch_count
    _stack().append(policy.half_dtype)
    with _lock:
        _patch_count += 1
        if _patch_count > 1:
            return
        seen = set()
        for targets, wrap in ((_USER_HALF_TARGETS, _wrap_half),
                              (_USER_FLOAT_TARGETS, _wrap_float),
                              (_HALF_TARGETS, _wrap_half),
                              (_FLOAT_TARGETS, _wrap_float),
                              (_AUTOGRAD_TARGETS, _wrap_autograd)):
            for mod, name in targets:
                if (id(mod), name) in seen:
                    continue
                seen.add((id(mod), name))
                orig = getattr(mod, name)
                _originals.append((mod, name, orig))
                setattr(mod, name, wrap(orig))


def unpatch_functional() -> None:
    global _patch_count
    s = _stack()
    if s:
        s.pop()
    with _lock:
        if _patch_count == 0:
            return
        _patch_count -= 1
        if _patch_count:
            return
        while _originals:
            mod, name, orig = _originals.pop()
            setattr(mod, name, orig)
