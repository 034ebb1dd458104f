"""The step's graph for the lint: a record of one run.

The JAX package's lint reads ``jax.make_jaxpr``'s trace, made without
running anything. The port has no such trace to read: its hand kernels
launch through ``ctypes`` and Triton, not ``torch.library``, so neither
``torch.fx`` nor ``torch.export`` sees them, and neither can run them on
proxy or fake tensors. What the port has is the idiom of
:class:`apex_tpu_torch.prof.cost.CostCounter` and of the memory tracker:
run the step **once** under a ``TorchDispatchMode`` and note what it did.
:func:`record_step` does that and keeps, in order:

- a node for every aten op: its name, its tensor operands and results as
  values (dtype, shape, device), its scalar arguments, the operands it
  writes in place, and for a random op the generator it draws from and
  that generator's state at the draw;
- a node for every hand-kernel call, by its ``ops.KERNELS`` name, with its
  operands, results and declared writes (``ops.KERNEL_WRITES``). The plain
  version's aten ops stay hidden behind :func:`apex_tpu_torch.ops._priced.
  suppressed`, as the cost counter hides them, so the CPU and the card
  record the same graph for the same step.

It marks the carried inputs (the tensors of ``args`` and ``kwargs``) and
the committed outputs (the tensors ``fn`` returns, and the pre-existing
tensors the run wrote in place).

The record holds no tensor of the step (at full width the backward's
intermediates would not fit): tensors are known through a
``WeakIdKeyDictionary``, an in-place write makes a new version of its
value (keyed on ``_version``), and a view shares its base's storage. The
forward and the backward are both recorded, in order: on a card the
autograd engine runs the backward on its own device thread, which the
dispatch mode follows; the record's state is process-wide, not
thread-local.

Running the step once leaves no trace of it: at exit the record puts back
the state of every generator it drew from (and of the default generators)
and the contents of every pre-existing tensor the run wrote in place, each
copied on its first write (from the in-place aten ops, and from the
kernels' declared writes, which bump no ``_version``).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import inspect
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from apex_tpu_torch.monitor.check import host_sync
from apex_tpu_torch.ops import _priced

__all__ = ["Lit", "Value", "Draw", "Node", "StepRecord", "record_step"]


@dataclasses.dataclass(frozen=True)
class Lit:
    """A non-tensor operand of a node (a Python scalar, a dtype, None)."""

    value: Any


@dataclasses.dataclass
class Value:
    """One tensor value of the run: a tensor, or a version of one."""

    vid: int
    dtype: torch.dtype
    shape: Tuple[int, ...]
    device: str
    #: "input" (carried), "const" (pre-existing, not carried), "op" (made
    #: by a node), "version" (a pre-existing storage written through an
    #: alias or a kernel)
    origin: str
    path: Optional[str] = None     # a carried input's path in args/kwargs
    node: Optional[int] = None     # the producing node's index

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n


@dataclasses.dataclass(frozen=True)
class Draw:
    """A random op's generator and the generator's state at the draw."""

    generator: str            # "default cuda:0" or "generator #k (cpu)"
    default: bool             # no generator= (the device's default one)
    made_in_step: bool        # a generator constructed during the run
    state: Tuple              # (device, seed, offset) or (device, hash)


@dataclasses.dataclass
class Node:
    """One aten op or hand-kernel call of the run."""

    index: int
    kind: str                       # "aten" | "kernel"
    op: str                         # "aten::mm.default" | "layer_norm_fwd"
    operands: Tuple = ()            # vid (int) or Lit, args then kwargs
    outputs: Tuple[int, ...] = ()   # vids of the tensor results
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    writes: Tuple[Tuple[int, int], ...] = ()   # (old vid, new vid)
    phase: str = "forward"          # "forward" | "backward"
    draw: Optional[Draw] = None
    host_sync: Optional[str] = None  # monitor.check.host_sync's reason
    scalar_out: Any = None          # a host-sync op's Python result
    #: kernels: pre-existing values its hidden aten ops wrote in place
    hidden_writes: Tuple[int, ...] = ()

    @property
    def tensor_operands(self) -> List[int]:
        return [o for o in self.operands if isinstance(o, int)]


@dataclasses.dataclass
class StepRecord:
    """The record of one run of a step (see the module docstring)."""

    nodes: List[Node]
    values: Dict[int, Value]
    inputs: List[int]               # carried inputs' vids, in arg order
    outputs: List[int]              # committed outputs' vids
    output_paths: Dict[int, str]    # committed output vid -> its path
    written: List[int]              # final vids of written pre-existing
    fn_name: Optional[str] = None

    def kernel_counts(self) -> collections.Counter:
        """Kernel nodes by ``ops.KERNELS`` name."""
        return collections.Counter(n.op for n in self.nodes
                                   if n.kind == "kernel")

    def counts(self) -> Dict[str, int]:
        """Node and value counts, by kind and phase."""
        c = collections.Counter()
        for n in self.nodes:
            c[n.kind] += 1
            c[n.phase] += 1
        return {"nodes": len(self.nodes), "aten": c["aten"],
                "kernel": c["kernel"], "forward": c["forward"],
                "backward": c["backward"], "values": len(self.values),
                "inputs": len(self.inputs), "outputs": len(self.outputs)}


# -- the recorder -------------------------------------------------------------

_ACTIVE: List["_Recorder"] = []
_BASE_GENERATOR = torch.Generator


class _StepGenerator(_BASE_GENERATOR):
    """``torch.Generator`` while a record runs: tells each open record of a
    generator made inside the step."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for r in list(_ACTIVE):
            r.made[self._cdata] = self


_SCHEMAS: Dict[Any, Tuple] = {}


def _schema_facts(func) -> Tuple:
    """(written positional indices, written kwarg names, generator arg
    (index, name) or None, random, argument names) of an aten overload,
    cached."""
    facts = _SCHEMAS.get(func)
    if facts is None:
        pos, kw, gen = [], [], None
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                (kw if a.kwarg_only else pos).append(
                    a.name if a.kwarg_only else i)
            if a.name == "generator":
                gen = (None if a.kwarg_only else i, a.name)
        random = torch.Tag.nondeterministic_seeded in func.tags
        names = tuple(a.name for a in func._schema.arguments)
        facts = _SCHEMAS[func] = (tuple(pos), tuple(kw), gen, random,
                                  names)
    return facts


def _version(t: torch.Tensor) -> int:
    try:
        return t._version
    except Exception:           # inference tensors carry no counter
        return 0


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except Exception:           # sparse or storage-less tensors
        return None


def _tensors(obj, out: List[torch.Tensor]) -> None:
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _tensors(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _tensors(x, out)


def _walk(obj, path: str, out: List[Tuple[str, Any]]) -> None:
    """(path, leaf) of every tensor and generator in a pytree of dicts,
    lists, tuples and named tuples."""
    if isinstance(obj, (torch.Tensor, torch.Generator)):
        out.append((path, obj))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _walk(v, f"{path}[{k!r}]", out)
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for k, v in zip(obj._fields, obj):
            _walk(v, f"{path}.{k}", out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _walk(v, f"{path}[{i}]", out)


def _gen_state(g: torch.Generator) -> Tuple:
    dev = str(g.device)
    if g.device.type == "cpu":
        return (dev, hashlib.sha1(g.get_state().numpy().tobytes())
                .hexdigest())
    return (dev, int(g.initial_seed()), int(g.get_offset()))


def _default_generator(device) -> torch.Generator:
    device = torch.device(device)
    if device.type == "cuda":
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        return torch.cuda.default_generators[idx]
    return torch.default_generator


def _op_device(args, kwargs):
    ts: List[torch.Tensor] = []
    _tensors(list(args), ts)
    if ts:
        return ts[0].device
    dev = kwargs.get("device")
    return torch.device(dev) if dev is not None else torch.device("cpu")


class _Kernel:
    """A priced call between ``kernel_begin`` and ``kernel_end``."""

    def __init__(self, name, operands, kwargs, phase, written):
        self.name, self.operands, self.kwargs = name, operands, kwargs
        self.phase = phase
        self.written = written          # [(tensor, old vid)] declared
        self.hidden_writes: List[int] = []


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.nodes: List[Node] = []
        self.values: Dict[int, Value] = {}
        self.ids = WeakIdKeyDictionary()     # tensor -> (vid, version)
        self.born = WeakIdKeyDictionary()    # tensors made in the run
        self.pre: Dict[int, Any] = {}        # storage key -> storage
        self.saved: Dict[int, Tuple] = {}    # storage key -> (st, copy)
        self.last_write: Dict[int, int] = {}  # storage key -> new vid
        self.written: Dict[int, int] = {}    # pre storage key -> vid
        # generators by their C++ generator (``_cdata``: the dispatcher
        # hands a handler a new Python object for the same generator)
        self.gens: Dict[int, Tuple] = {}     # key -> (gen, state)
        self.gen_labels: Dict[int, str] = {}
        self.carried_gens: Dict[int, torch.Generator] = {}
        self.made: Dict[int, torch.Generator] = {}
        self.lock = threading.Lock()
        self.kernels: Dict[int, List[_Kernel]] = {}   # thread -> stack
        self.pre_paths: Dict[int, str] = {}   # storage key -> path
        self.grads: Dict[int, Tuple] = {}     # id -> (leaf, its .grad)

    # -- values ----------------------------------------------------------

    def _new(self, t: torch.Tensor, origin: str, node=None,
             path=None) -> int:
        vid = len(self.values)
        self.values[vid] = Value(vid, t.dtype, tuple(t.shape),
                                 str(t.device), origin, path, node)
        # inside a handler a view's result does not share its base's
        # version counter yet (autograd links them after the handler
        # returns): a value made by a node takes its version at its first
        # read
        self.ids[t] = (vid, _version(t) if origin in ("input", "const")
                       else None)
        return vid

    def _note_pre(self, t: torch.Tensor) -> None:
        st = _storage(t)
        if st is not None:
            self.pre.setdefault(st._cdata, st)
        if t.is_leaf and t.requires_grad and id(t) not in self.grads:
            self.grads[id(t)] = (t, t.grad)

    def carry(self, t: torch.Tensor, path: str) -> int:
        ent = self.ids.get(t)
        if ent is not None:
            return ent[0]
        self._note_pre(t)
        st = _storage(t)
        if st is not None:
            self.pre_paths.setdefault(st._cdata, path)
        return self._new(t, "input", path=path)

    def vid(self, t: torch.Tensor) -> int:
        """The value ``t`` holds now."""
        ent = self.ids.get(t)
        if ent is None:
            origin = "op" if t in self.born else "const"
            if origin == "const":
                self._note_pre(t)
            return self._new(t, origin)
        vid, ver = ent
        if ver is None:
            self.ids[t] = (vid, _version(t))
            return vid
        if ver != _version(t):
            # written through an alias since: a new version of the value
            st = _storage(t)
            src = self.last_write.get(st._cdata) if st is not None else None
            node = self.values[src].node if src is not None else None
            return self._new(t, "version", node=node)
        return vid

    def _operands(self, args, kwargs, names=()) -> Tuple[Tuple, Dict]:
        """(operands, named non-tensor arguments): tensors as vids and
        other arguments as :class:`Lit`, positional then keyword; a
        non-tensor positional argument is also named by ``names`` (the
        op's schema)."""
        ops: List[Any] = []

        def flat(x):
            if isinstance(x, torch.Tensor):
                ops.append(self.vid(x))
            elif isinstance(x, (list, tuple)):
                for y in x:
                    flat(y)
            else:
                ops.append(Lit(x))

        kw = {}
        for i, a in enumerate(args):
            flat(a)
            if i < len(names) and not isinstance(
                    a, (torch.Tensor, list, tuple)):
                kw[names[i]] = a
        for k, v in kwargs.items():
            ts: List[torch.Tensor] = []
            _tensors(v, ts)
            if ts:
                for t in ts:
                    ops.append(self.vid(t))
            elif not isinstance(v, torch.Generator):
                kw[k] = v
        return tuple(ops), kw

    # -- in-place writes -------------------------------------------------

    def _save(self, t: torch.Tensor) -> None:
        """Copy a pre-existing storage on its first write."""
        st = _storage(t)
        if st is None:
            return
        key = st._cdata
        if key in self.pre and key not in self.saved:
            self.saved[key] = (st, st.clone())

    def _wrote(self, t: torch.Tensor, old: int,
               node: int) -> Tuple[int, int]:
        new = self._new(t, "op", node=node)
        st = _storage(t)
        if st is not None:
            self.last_write[st._cdata] = new
            if st._cdata in self.pre:
                self.written[st._cdata] = new
        return old, new

    # -- generators ------------------------------------------------------

    def _label(self, g: torch.Generator, default: bool) -> str:
        lab = self.gen_labels.get(g._cdata)
        if lab is None:
            lab = (f"default {g.device}" if default else
                   f"generator #{len(self.gen_labels)} ({g.device})")
            self.gen_labels[g._cdata] = lab
        return lab

    def _draw(self, func, args, kwargs, gen_arg) -> Draw:
        g = None
        if gen_arg is not None:
            idx, name = gen_arg
            if idx is not None and idx < len(args):
                g = args[idx]
            else:
                g = kwargs.get(name)
        default = g is None
        if default:
            g = _default_generator(_op_device(args, kwargs))
        key = g._cdata
        if key not in self.gens:
            self.gens[key] = (g, g.get_state())
        return Draw(self._label(g, default), default, key in self.made,
                    _gen_state(g))

    # -- nodes -----------------------------------------------------------

    def _append(self, node: Node) -> None:
        with self.lock:
            node.index = len(self.nodes)
            self.nodes.append(node)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        pos_w, kw_w, gen_arg, random, names = _schema_facts(func)
        targets = [args[i] for i in pos_w if i < len(args)] + \
            [kwargs[k] for k in kw_w if kwargs.get(k) is not None]
        targets = [t for t in targets if isinstance(t, torch.Tensor)]
        if _priced.suppressed():
            for t in targets:
                if t not in self.ids and t not in self.born:
                    self._note_pre(t)
                self._save(t)
            if random:            # a hidden draw still moves its generator
                self._draw(func, args, kwargs, gen_arg)
            pre = [self.ids[t][0] for t in targets if t in self.ids]
            out = func(*args, **kwargs)
            stack = self.kernels.get(threading.get_ident())
            if stack and pre:
                stack[-1].hidden_writes.extend(pre)
            res: List[torch.Tensor] = []
            _tensors(out, res)
            for t in res:
                if t not in self.ids:
                    self.born[t] = True
            return out
        old = [self.vid(t) for t in targets]
        for t in targets:
            self._save(t)
        operands, kw = self._operands(args, kwargs, names)
        node = Node(-1, "aten", f"aten::{func.__name__}", operands,
                    kwargs=kw, phase=_phase())
        if random:
            node.draw = self._draw(func, args, kwargs, gen_arg)
        node.host_sync = host_sync(func, args, kwargs)
        out = func(*args, **kwargs)
        self._append(node)
        writes = [self._wrote(t, o, node.index)
                  for t, o in zip(targets, old)]
        written = {id(t): new for t, (_o, new) in zip(targets, writes)}
        node.writes = tuple(writes)
        res = []
        _tensors(out, res)
        outs = []
        for t in res:
            if id(t) in written:
                outs.append(written[id(t)])
            else:
                self.born[t] = True
                outs.append(self._new(t, "op", node=node.index))
        node.outputs = tuple(outs)
        if node.host_sync is not None and not isinstance(
                out, (torch.Tensor, list, tuple)):
            node.scalar_out = out
        return out

    # -- hand kernels (called by ops._priced) ----------------------------

    def kernel_begin(self, name, fn, args, kwargs) -> _Kernel:
        from apex_tpu_torch.ops import KERNEL_WRITES
        written = []
        declared = KERNEL_WRITES.get(name, ())
        if declared:
            bound = _signature(fn).bind_partial(*args, **kwargs).arguments
            for pname in declared:
                ts: List[torch.Tensor] = []
                _tensors(bound.get(pname), ts)
                for t in ts:
                    vid = self.vid(t)
                    with torch._C._DisableTorchDispatch():
                        self._save(t)
                    written.append((t, vid))
        operands, kw = self._operands(args, kwargs)
        call = _Kernel(name, operands, kw, _phase(), written)
        self.kernels.setdefault(threading.get_ident(), []).append(call)
        return call

    def kernel_end(self, call: _Kernel, out) -> None:
        stack = self.kernels.get(threading.get_ident())
        if stack and stack[-1] is call:
            stack.pop()
        node = Node(-1, "kernel", call.name, call.operands,
                    kwargs=call.kwargs, phase=call.phase,
                    hidden_writes=tuple(call.hidden_writes))
        self._append(node)
        node.writes = tuple(self._wrote(t, old, node.index)
                            for t, old in call.written)
        written = {id(t): new for (t, _), (_o, new) in zip(call.written,
                                                            node.writes)}
        res: List[torch.Tensor] = []
        _tensors(out, res)
        outs = []
        for t in res:
            if id(t) in written:
                outs.append(written[id(t)])
            elif t in self.ids and self.ids[t][1] in (None, _version(t)):
                outs.append(self.ids[t][0])     # an operand passed back
            else:
                outs.append(self._new(t, "op", node=node.index))
        node.outputs = tuple(outs)

    # -- exit --------------------------------------------------------------

    def restore(self) -> None:
        """Put back every written pre-existing storage and every generator
        the run drew from."""
        for st, copy in self.saved.values():
            st.copy_(copy)
        for t, grad in self.grads.values():
            t.grad = grad
        for key, (g, state) in self.gens.items():
            if key not in self.made:
                g.set_state(state)


_SIGS: Dict[Any, inspect.Signature] = {}


def _signature(fn) -> inspect.Signature:
    sig = _SIGS.get(fn)
    if sig is None:
        sig = _SIGS[fn] = inspect.signature(fn)
    return sig


def _phase() -> str:
    return ("backward" if torch._C._current_autograd_node() is not None
            else "forward")


def _default_generators() -> List[torch.Generator]:
    gens = [torch.default_generator]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        gens += list(torch.cuda.default_generators)
    return gens


def record_step(fn, *args, fn_name: Optional[str] = None,
                **kwargs) -> StepRecord:
    """Run ``fn(*args, **kwargs)`` once and return its :class:`StepRecord`.

    The step runs for real, on whatever device its tensors are on; its
    result is dropped, and every generator it drew from and every
    pre-existing tensor it wrote in place are put back as they were, so
    the caller's next step is the one it would have been."""
    rec = _Recorder()
    leaves: List[Tuple[str, Any]] = []
    for i, a in enumerate(args):
        _walk(a, f"args[{i}]", leaves)
    for k, v in kwargs.items():
        _walk(v, f"kwargs[{k!r}]", leaves)
    inputs = []
    for path, leaf in leaves:
        if isinstance(leaf, torch.Generator):
            rec.carried_gens[leaf._cdata] = leaf
        else:
            vid = rec.carry(leaf, path)
            if vid not in inputs:
                inputs.append(vid)
    for g in _default_generators() + list(rec.carried_gens.values()):
        rec.gens[g._cdata] = (g, g.get_state())
    _ACTIVE.append(rec)
    _priced.RECORDERS.append(rec)
    torch.Generator = _StepGenerator
    try:
        with rec:
            result = fn(*args, **kwargs)
        outs: List[Tuple[str, Any]] = []
        _walk(result, "result", outs)
        outputs, paths = [], {}
        for path, leaf in outs:
            if isinstance(leaf, torch.Tensor):
                vid = rec.vid(leaf)
                if vid not in paths:
                    outputs.append(vid)
                    paths[vid] = path
        del result, outs
        for key, vid in rec.written.items():
            if vid not in paths:
                outputs.append(vid)
                paths[vid] = rec.pre_paths.get(key, "<closure>")
    finally:
        torch.Generator = _BASE_GENERATOR
        _priced.RECORDERS.remove(rec)
        _ACTIVE.remove(rec)
        rec.restore()
    if fn_name is None:
        fn_name = getattr(fn, "__name__", None) or type(fn).__name__
    return StepRecord(nodes=rec.nodes, values=rec.values, inputs=inputs,
                      outputs=outputs, output_paths=paths,
                      written=sorted(rec.written.values()),
                      fn_name=fn_name)
