"""Op/module annotation for profiling — the port of
``apex_tpu/prof/annotate.py``.

The JAX package names HLO ops with ``jax.named_scope`` and records module
calls through a flax interceptor. In PyTorch:

- :func:`scope` opens a ``torch.profiler.record_function`` range (the
  range the profiler groups host and device time by) and, on a card, an
  NVTX range (``torch.cuda.nvtx.range_push``/``range_pop``);
- :func:`annotate` wraps a function in a :class:`apex_tpu_torch.trace.span`,
  so it lands in the active Tracer's timeline too;
- :func:`annotate_modules` installs global ``nn.Module`` forward pre- and
  post-hooks for the context: each module call records a
  :class:`CallRecord` (module path, method, argument shapes and dtypes)
  and runs inside ``scope("<path>.forward")``. The hooks are removed on
  exit; nothing is monkey-patched. PyTorch runs eagerly, so every call
  records, not only the first (a jitted JAX function records once, at
  trace time).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch
from torch.profiler import record_function

__all__ = ["scope", "annotate", "CallRecord", "annotate_modules"]


class scope:
    """``with scope("name"):`` / ``@scope("name")``: a ``record_function``
    range, plus an NVTX range when a card is present."""

    __slots__ = ("name", "_rf", "_nvtx")

    def __init__(self, name: str):
        self.name = name
        self._rf = None
        self._nvtx = False

    def __enter__(self) -> "scope":
        self._rf = record_function(self.name)
        self._rf.__enter__()
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self.name)
            self._nvtx = True
        return self

    def __exit__(self, *exc) -> None:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
            self._nvtx = False
        self._rf.__exit__(*exc)

    def __call__(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with scope(self.name):
                return fn(*args, **kwargs)
        return wrapped


def annotate(name: str) -> Callable:
    """Decorator: the function runs inside ``trace.span(name)`` — a
    profiler range while one runs, and a span of the active Tracer."""
    def deco(fn: Callable) -> Callable:
        from apex_tpu_torch.trace.spans import span as _span

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with _span(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


def _shape_dtype(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype).replace("torch.", ""))
    if isinstance(x, (list, tuple)):
        return type(x)(_shape_dtype(v) for v in x)
    return repr(x)[:40]


@dataclasses.dataclass
class CallRecord:
    """One module call: path, method, (shape, dtype) summaries."""

    path: str            # dotted module path under the root, e.g. "layers.0"
    method: str          # "forward"
    args: Tuple[Any, ...]
    kwargs: dict


@contextlib.contextmanager
def annotate_modules(records: Optional[List[CallRecord]] = None, *,
                     root: Optional[torch.nn.Module] = None
                     ) -> Iterator[List[CallRecord]]:
    """Record and scope every ``nn.Module`` call in the context.

    Yields the list the records accumulate into. ``root`` names module
    paths from its ``named_modules()`` (``"layers.0.attn"``); a module
    outside it is named by its class. The global hooks see positional
    arguments only, so ``kwargs`` stays empty."""
    out: List[CallRecord] = [] if records is None else records
    names = ({id(m): (n or type(m).__name__)
              for n, m in root.named_modules()} if root is not None else {})
    open_scopes: List[scope] = []

    def pre(module, args):
        path = names.get(id(module), type(module).__name__)
        out.append(CallRecord(path=path, method="forward",
                              args=_shape_dtype(tuple(args)), kwargs={}))
        s = scope(f"{path}.forward")
        s.__enter__()
        open_scopes.append(s)

    def post(module, args, output):
        if open_scopes:
            open_scopes.pop().__exit__(None, None, None)

    from torch.nn.modules import module as _m
    h1 = _m.register_module_forward_pre_hook(pre)
    h2 = _m.register_module_forward_hook(post)
    try:
        yield out
    finally:
        h1.remove()
        h2.remove()
        while open_scopes:
            open_scopes.pop().__exit__(None, None, None)
