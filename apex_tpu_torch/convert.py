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
(leaves in the port's parameter order).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from apex_tpu_torch import arena
from apex_tpu_torch.optim.fused import FusedOptState


def _flatten(tree, prefix="", sort=False):
    for k in (sorted(tree) if sort else tree):
        v, name = tree[k], f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, name + ".", sort)
        else:
            yield name, v


def _port_name(name):
    """The port's name of one JAX leaf."""
    for leaf in ("kernel", "embedding"):
        if name.endswith("." + leaf):
            return name[:-len(leaf)] + "weight"
    return name


def _port_leaf(name, arr):
    """(port name, array) of one JAX leaf."""
    if name.endswith(".kernel"):
        module = name.split(".")[-2]
        if arr.ndim != 4:                        # Dense (in, out) -> (out, in)
            arr = arr.T
        elif module.startswith("ConvTranspose"):  # -> flipped (I, O, kh, kw)
            arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
        else:                                    # conv -> (O, I, kh, kw)
            arr = arr.transpose(3, 2, 0, 1)
    return _port_name(name), arr


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


def resnet_variables_from_jax(params, batch_stats, device="cuda"):
    """``({port name: param}, {port name: running statistic})`` from a flax
    conv model's ``params`` and ``batch_stats`` trees (ResNet, DCGAN)."""
    stats = {name: torch.tensor(np.asarray(leaf, np.float32), device=device)
             for name, leaf in _flatten(batch_stats)}
    return params_from_jax(params, device), stats


dcgan_variables_from_jax = resnet_variables_from_jax


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
            jbufs = {dt: torch.from_numpy(np.array(buf))
                     for dt, buf in tree.items()}
            named = arena.unflatten(jbufs, jspec)
            mapped = dict(_port_leaf(k, v.numpy()) for k, v in named.items())
            tensors = {k: _tensor(np.asarray(mapped[k], np.float32), device)
                       for k in order}
            slots[slot] = arena.flatten(tensors, tspec, cast=torch.float32)
        else:
            mapped = params_from_jax(tree, device=device)
            slots[slot] = {k: mapped[k] for k in order}
    count = torch.tensor(int(np.asarray(state.count)), dtype=torch.int32,
                         device=device)
    return FusedOptState(count=count, slots=slots)
