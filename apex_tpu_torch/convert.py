"""Carry weights, BN statistics and optimizer state from the JAX package
to the port.

The flax tree (as nested dicts of numpy arrays) maps name for name onto
the port's ``state_dict``: path components join with ``.``, a Dense
``kernel`` (in, out) becomes a ``Linear.weight`` (out, in), a conv
``kernel`` (kh, kw, I, O) becomes a conv ``weight`` (O, I, kh, kw) in
``channels_last`` memory, a ``ConvTranspose_*`` kernel (kh, kw, I, O)
becomes the spatially flipped (I, O, kh, kw) weight that
``F.conv_transpose2d`` needs for flax's unflipped kernel, and the token
table ``tok_emb/embedding`` becomes ``tok_emb.weight``. The map depends on
the module's kind, not only on the leaf's rank. Optimizer slots
follow the same map: the JAX package's tree slots are trees like the
params, and its arena slots are flat buffers in its own layout (leaves in
``jax.tree_util``'s sorted-key order), which differs from the port's
(leaves in the port's parameter order). ``jax_name`` and
``to_jax_layout``/``from_jax_layout`` run the map backwards for one port
leaf, as the sparsity masks need. A flax ``WeightNorm``'s
``"<layer>/kernel/scale"`` leaf becomes the port module's ``scale``;
``asp_state_from_jax`` carries masks and the wrapped optimizer's state, and ``zero_state_from_jax`` ZeRO's
per-rank shards. ``amp_state_from_jax_checkpoint`` reads a training state
that the JAX package's ``ckpt.CheckpointManager`` wrote to disk (the two
packages share the format) and maps it as ``amp_state_from_jax`` maps one
in memory.
"""

from __future__ import annotations

import ast
import re
import types
from typing import Dict

import numpy as np
import torch

from apex_tpu_torch import arena
from apex_tpu_torch.optim.distributed import ShardedOptState, _padded_len
from apex_tpu_torch.optim.fused import FusedOptState


def _flatten(tree, prefix="", sort=False):
    for k in (sorted(tree) if sort else tree):
        v, name = tree[k], f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, name + ".", sort)
        else:
            yield name, v


#: flax ``nn.WeightNorm``'s scale of the wrapped layer's kernel, a leaf of
#: the ``WeightNorm_<i>`` node beside the layer: the port's ``scale``
_WN_SCALE = re.compile(r"^(.*)WeightNorm_\d+\.[^.]+/kernel/scale$")


def _port_name(name):
    """The port's name of one JAX leaf."""
    wn = _WN_SCALE.match(name)
    if wn:
        return wn.group(1) + "scale"
    for leaf in ("kernel", "embedding"):
        if name.endswith("." + leaf):
            return name[:-len(leaf)] + "weight"
    return name


def _kernel_kind(name, ndim):
    """How a JAX leaf's layout maps to the port's: None (as it is), "dense"
    ((in, out) -> (out, in)), "conv" ((kh, kw, I, O) -> (O, I, kh, kw)) or
    "conv_transpose" (-> the flipped (I, O, kh, kw))."""
    if not name.endswith(".kernel"):
        return None
    if ndim != 4:
        return "dense"
    module = name.split(".")[-2]
    return "conv_transpose" if module.startswith("ConvTranspose") else "conv"


def _port_leaf(name, arr):
    """(port name, array) of one JAX leaf."""
    kind = _kernel_kind(name, arr.ndim)
    if kind == "dense":
        arr = arr.T
    elif kind == "conv_transpose":
        arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
    elif kind == "conv":
        arr = arr.transpose(3, 2, 0, 1)
    return _port_name(name), arr


#: modules whose ``weight`` is a flax ``nn.Embed``'s ``embedding``: the
#: JAX package's token table ``tok_emb`` and flax's automatic ``Embed_<i>``
_EMBED_MODULE = re.compile(r"^(tok_emb|Embed_\d+)$")


def jax_name(name: str) -> str:
    """The JAX package's name of one port leaf, the inverse of the rename
    above: a module's ``weight`` is its ``embedding`` if the module is an
    embedding table, else its ``kernel``."""
    module, _, leaf = name.rpartition(".")
    if leaf != "weight" or not module:
        return name
    table = _EMBED_MODULE.match(module.rpartition(".")[2])
    return f"{module}.{'embedding' if table else 'kernel'}"


def to_jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """A view of the port leaf ``name`` in the JAX package's layout."""
    kind = _kernel_kind(jax_name(name), t.dim())
    if kind == "dense":
        return t.permute(*reversed(range(t.dim())))
    if kind == "conv_transpose":
        return t.permute(2, 3, 0, 1).flip(0, 1)
    if kind == "conv":
        return t.permute(2, 3, 1, 0)
    return t


def from_jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_jax_layout`: a JAX-layout tensor of the
    port leaf ``name`` in the port's layout."""
    kind = _kernel_kind(jax_name(name), t.dim())
    if kind == "dense":
        return t.permute(*reversed(range(t.dim())))
    if kind == "conv_transpose":
        return t.flip(0, 1).permute(2, 3, 0, 1)
    if kind == "conv":
        return t.permute(3, 2, 0, 1)
    return t


def _tensor(arr, device):
    t = torch.tensor(np.ascontiguousarray(arr), device=device)
    return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 \
        else t


def params_from_jax(params, device="cuda") -> Dict[str, torch.Tensor]:
    """``{port name: f32 tensor}`` from a flax ``params`` tree (or any
    tree shaped like it: grads, optimizer slots)."""
    out = {}
    for name, leaf in _flatten(params):
        name, arr = _port_leaf(name, np.asarray(leaf, dtype=np.float32))
        out[name] = _tensor(arr, device)
    return out


#: the RNN stacks' trees (``LSTMCell_<i>.ii.kernel``, ...), the
#: multihead-attention modules' (``ln_scale``, ``q_proj``, ...) and those
#: holding ``WeightNorm``s (the wrapped layer's leaves, and each
#: ``WeightNorm_<i>/"<layer>/kernel/scale"`` as the port module's ``scale``)
#: map as any other tree
rnn_params_from_jax = weight_norm_params_from_jax = params_from_jax


def resnet_variables_from_jax(params, batch_stats, device="cuda"):
    """``({port name: param}, {port name: running statistic})`` from a flax
    conv model's ``params`` and ``batch_stats`` trees (ResNet, DCGAN)."""
    stats = {name: torch.tensor(np.asarray(leaf, np.float32), device=device)
             for name, leaf in _flatten(batch_stats)}
    return params_from_jax(params, device), stats


dcgan_variables_from_jax = resnet_variables_from_jax


def _relayout(bufs, jspec, tspec, order, device):
    """Flat f32 arena buffers in the JAX package's layout (``jspec``; a
    buffer may run past its partition, padding) -> the port's
    (``tspec``): cut into tensors, mapped and packed again."""
    jbufs = {dt: torch.from_numpy(np.array(buf)[:jspec.partition(
        dt).buffer_len]) for dt, buf in bufs.items()}
    named = arena.unflatten(jbufs, jspec)
    mapped = dict(_port_leaf(k, v.numpy()) for k, v in named.items())
    tensors = {k: _tensor(np.asarray(mapped[k], np.float32), device)
               for k in order}
    return arena.flatten(tensors, tspec, cast=torch.float32)


def fused_state_from_jax(state, params, port_params,
                         device="cuda") -> FusedOptState:
    """The port's ``FusedOptState`` from the JAX package's.

    ``state`` is a JAX ``FusedOptState`` (its count and slots as arrays),
    ``params`` the flax params tree it was built for, and ``port_params``
    the port's ``{name: tensor}`` params in the order the port's optimizer
    sees them. Tree slots are mapped name for name; arena slot buffers are
    cut into tensors by the JAX package's layout, mapped, and packed again
    in the port's layout (``arena.plan(port_params)``). An arena slot of
    one value per tensor (NovoGrad's ``vnorm``: a (num_tensors,) vector
    per partition, keyed by dtype like a buffer) is told from a buffer by
    its length and mapped from the JAX partition's tensor order to the
    port's by name.
    """
    order = list(port_params)
    jleaves = dict(_flatten(params, sort=True))
    jspec = arena.plan({k: np.asarray(v) for k, v in jleaves.items()})
    tspec = arena.plan(port_params)
    slots = {}
    for slot, tree in state.slots.items():
        per_tensor = set(tree) == set(jspec.dtypes) and all(
            np.shape(tree[p.dtype]) == (len(p.sizes),)
            for p in jspec.partitions)
        if per_tensor:                          # one value per tensor
            value = {_port_name(jspec.names[i]): v
                     for p in jspec.partitions
                     for i, v in zip(p.leaves, np.asarray(tree[p.dtype],
                                                          np.float32))}
            slots[slot] = {p.dtype: torch.tensor(
                np.array([value[tspec.names[i]] for i in p.leaves],
                         np.float32), device=device)
                for p in tspec.partitions}
        elif set(tree) == set(jspec.dtypes):    # arena buffers, by dtype
            slots[slot] = _relayout(tree, jspec, tspec, order, device)
        else:
            mapped = params_from_jax(tree, device=device)
            slots[slot] = {k: mapped[k] for k in order}
    count = torch.tensor(int(np.asarray(state.count)), dtype=torch.int32,
                         device=device)
    return FusedOptState(count=count, slots=slots)


def zero_state_from_jax(states, params, port_params, rank: int,
                        device="cuda"):
    """Rank ``rank``'s ``optim.ShardedOptState`` from the JAX package's.

    ``states`` are the JAX ``ShardedOptState``s of every rank, in linear
    rank order (numpy or arrays), ``params`` the flax params tree they were
    built for and ``port_params`` the port's ``{name: tensor}`` params in
    the port optimizer's order. Each slot's shards are joined into the
    whole buffer, cut into tensors by the JAX layout, mapped, packed in the
    port's layout (``arena.plan(port_params)``), padded for the world size
    and cut into shards again."""
    world = len(states)
    order = list(port_params)
    jleaves = dict(_flatten(params, sort=True))
    jspec = arena.plan({k: np.asarray(v) for k, v in jleaves.items()})
    tspec = arena.plan(port_params)
    slots = {}
    for slot in states[0].slots:
        whole = {dt: np.concatenate([np.asarray(s.slots[slot][dt],
                                                np.float32)
                                     for s in states])
                 for dt in states[0].slots[slot]}
        bufs = _relayout(whole, jspec, tspec, order, device)
        slots[slot] = {}
        for part in tspec.partitions:
            per = _padded_len(part.buffer_len, world) // world
            buf = torch.nn.functional.pad(
                bufs[part.dtype], (0, per * world - part.buffer_len))
            slots[slot][part.dtype] = buf[rank * per:(rank + 1) * per].clone()
    count = torch.tensor(int(np.asarray(states[0].count)), dtype=torch.int32,
                         device=device)
    return ShardedOptState(count=count, slots=slots)


def asp_state_from_jax(state, params, port_params, device="cuda"):
    """The port's ``sparsity.ASPState`` from the JAX package's: the masks by
    port name in the port's layout (None stays None: a dense leaf), and the
    wrapped optimizer's state through :func:`fused_state_from_jax`."""
    from apex_tpu_torch.sparsity import ASPState

    masks = {}
    for name, m in _flatten(state.masks):
        if m is None:
            masks[_port_name(name)] = None
        else:
            pname, arr = _port_leaf(name, np.asarray(m, dtype=bool))
            masks[pname] = _tensor(arr, device)
    return ASPState(masks={k: masks[k] for k in port_params},
                    inner=fused_state_from_jax(state.inner, params,
                                               port_params, device))


def _opt_state_from_jax(state, params, port_params, device):
    """The port's optimizer state for a JAX ``FusedOptState`` (arena or
    tree slots) or ``ASPState`` built for the flax tree ``params``."""
    if hasattr(state, "masks"):
        return asp_state_from_jax(state, params, port_params, device)
    if hasattr(state, "count") and hasattr(state, "slots"):
        return fused_state_from_jax(state, params, port_params, device)
    raise TypeError(f"no port counterpart for optimizer state "
                    f"{type(state).__name__}")


def _scalers_from_jax(scalers, device):
    from apex_tpu_torch.amp.scaler import LossScaleState, device_scalar
    return tuple(None if s is None else LossScaleState(
        loss_scale=device_scalar(s.loss_scale, torch.float32, device),
        growth_tracker=device_scalar(s.growth_tracker, torch.int32, device))
        for s in scalers)


def _params_like(tree, port_params, device):
    """A flax tree's leaves by port name in ``port_params``' order, each in
    its own float dtype (bf16 and fp16 pass through f32, exactly)."""
    mapped = {}
    for name, leaf in _flatten(tree):
        if isinstance(leaf, torch.Tensor):      # read from a checkpoint
            dtype = leaf.dtype if leaf.dtype in (torch.bfloat16,
                                                 torch.float16) \
                else torch.float32
            arr = leaf.float().numpy()
        else:
            arr = np.asarray(leaf)
            dtype = {"bfloat16": torch.bfloat16,
                     "float16": torch.float16}.get(str(arr.dtype),
                                                   torch.float32)
        pname, a = _port_leaf(name, np.asarray(arr, dtype=np.float32))
        mapped[pname] = _tensor(a, device).to(dtype)
    return {k: mapped[k] for k in port_params}


def metrics_from_jax(metrics, device="cuda"):
    """The port's ``monitor.Metrics`` from the JAX package's (device
    arrays, numpy values, or a checkpoint's tensors), or None for None:
    the counters int32, the gauges f32, bit for bit."""
    from apex_tpu_torch.monitor.metrics import Metrics
    if metrics is None:
        return None
    out = {}
    for name in Metrics._fields:
        v = getattr(metrics, name)
        if isinstance(v, torch.Tensor):
            v = v.numpy()
        arr = np.asarray(v)
        out[name] = torch.tensor(arr.item(), device=device, dtype=(
            torch.int32 if np.issubdtype(arr.dtype, np.integer)
            else torch.float32))
    return Metrics(**out)


def amp_state_from_jax(state, port_params, device="cuda"):
    """The port's ``amp.AmpState`` from the JAX package's: ``step``, the
    optimizer-facing params (f32 masters, or O3's half params) by port
    name in the order of ``port_params`` (the port's ``{name: tensor}``
    params, e.g. ``dict(model.named_parameters())``), the optimizer state
    (:func:`fused_state_from_jax` or :func:`asp_state_from_jax`, laid out
    as the state's own params), the loss scalers and the telemetry
    ``metrics`` (:func:`metrics_from_jax`; None when monitoring was off)."""
    from apex_tpu_torch.amp.api import AmpState
    params = _params_like(state.params, port_params, device)
    return AmpState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=device),
        params=params,
        opt_state=_opt_state_from_jax(state.opt_state, state.params, params,
                                      device),
        scalers=_scalers_from_jax(state.scalers, device),
        metrics=metrics_from_jax(getattr(state, "metrics", None), device))


def fp16_state_from_jax(state, port_params, device="cuda"):
    """The port's ``fp16_utils.FP16OptState`` from the JAX package's: step,
    the f32 masters by port name (in ``port_params``' order), the inner
    optimizer's state (laid out as the masters), the scaler and the
    telemetry ``metrics``."""
    from apex_tpu_torch.fp16_utils import FP16OptState
    masters = _params_like(state.masters, port_params, device)
    scaler = None if state.scaler is None else \
        _scalers_from_jax((state.scaler,), device)[0]
    return FP16OptState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=device),
        masters=masters,
        inner_state=_opt_state_from_jax(state.inner_state, state.masters,
                                        masters, device),
        scaler=scaler,
        metrics=metrics_from_jax(getattr(state, "metrics", None), device))


def scale_history_from_jax(state, device="cuda"):
    """The port's ``amp.ScaleHistoryState`` from the JAX package's."""
    from apex_tpu_torch.amp.scale_history import ScaleHistoryState

    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return ScaleHistoryState(
        amax_history=t(state.amax_history, torch.float32),
        cursor=t(state.cursor, torch.int32),
        scale=t(state.scale, torch.float32),
        growth_tracker=t(state.growth_tracker, torch.int32),
        overflow_count=t(state.overflow_count, torch.int32),
        step=t(state.step, torch.int32))


#: one step of a ``jax.tree_util.keystr`` path: ``.field``, ``['key']`` or
#: ``[index]``
_KEYSTR = re.compile(r"\.([A-Za-z_]\w*)|\[('(?:[^'\\]|\\.)*'|-?\d+)\]")


def _keystr_parts(path: str):
    parts, pos = [], 0
    for m in _KEYSTR.finditer(path):
        if m.start() != pos:
            raise ValueError(f"cannot parse checkpoint path {path!r}")
        pos = m.end()
        parts.append(("attr", m.group(1)) if m.group(1) is not None
                     else ("key", ast.literal_eval(m.group(2))))
    if pos != len(path):
        raise ValueError(f"cannot parse checkpoint path {path!r}")
    return parts


def _tree_from_paths(arrays: Dict[str, torch.Tensor], prefix: str = ""):
    """The JAX tree a checkpoint's ``keystr`` paths describe: NamedTuple
    fields as attributes, dict keys as dicts, indices as tuples."""
    root: dict = {}
    for path, leaf in arrays.items():
        if not path.startswith(prefix):
            continue
        node, parts = root, _keystr_parts(path[len(prefix):])
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def build(node):
        if not isinstance(node, dict):
            return node
        kinds = {k for k, _ in node}
        if kinds == {"attr"}:
            return types.SimpleNamespace(**{n: build(v)
                                            for (_, n), v in node.items()})
        if all(isinstance(n, int) for _, n in node):
            return tuple(build(node[("key", i)])
                         if ("key", i) in node else None
                         for i in range(max(n for _, n in node) + 1))
        return {n: build(v) for (_, n), v in node.items()}

    return build(root)


def amp_state_from_jax_checkpoint(ckpt_dir, port_params, device="cuda", *,
                                  prefix: str = ""):
    """The port's ``amp.AmpState`` from a checkpoint directory the JAX
    package's ``ckpt.CheckpointManager`` committed, and its manifest.

    ``prefix`` is the saved AmpState's path in the checkpointed tree (e.g.
    ``"['amp']"`` for a saved ``{"amp": state, ...}``; "" when the state
    itself was saved). The manifest's JAX key paths are rebuilt into the
    JAX tree (sorted-key param dicts, arena slot buffers in the JAX
    layout) and mapped by :func:`amp_state_from_jax`: port names, port
    layouts, the arena relaid out for ``port_params``. A state whose
    scalers hold no leaves (bf16: ``(None,)``) gets one ``None`` scaler;
    a saved ``metrics`` tuple (``Amp(monitor=True)``) comes across too."""
    from apex_tpu_torch.ckpt import format as _format
    manifest = _format.read_manifest(ckpt_dir)
    arrays = _format.assemble_arrays(ckpt_dir, manifest)
    tree = _tree_from_paths(arrays, prefix)
    tree.scalers = tuple(getattr(tree, "scalers", ()) or ()) or (None,)
    return amp_state_from_jax(tree, port_params, device), manifest
