"""Carry BERT weights and optimizer state from the JAX package to the port.

The flax tree (as nested dicts of numpy arrays) maps name for name onto
the port's ``state_dict``: path components join with ``.``, a Dense
``kernel`` (in, out) becomes a ``Linear.weight`` (out, in), and the token
table ``tok_emb/embedding`` becomes ``tok_emb.weight``. Optimizer slots
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


def _port_leaf(name, arr):
    """(port name, array) of one JAX leaf."""
    if name.endswith(".kernel"):
        return name[:-len("kernel")] + "weight", arr.T
    if name.endswith(".embedding"):
        return name[:-len("embedding")] + "weight", arr
    return name, arr


def bert_params_from_jax(params, device="cuda") -> Dict[str, torch.Tensor]:
    """``{port name: tensor}`` from a flax BERT ``params`` tree."""
    out = {}
    for name, leaf in _flatten(params):
        name, arr = _port_leaf(name, np.asarray(leaf, dtype=np.float32))
        out[name] = torch.tensor(arr, device=device)
    return out


def fused_state_from_jax(state, params, port_params,
                         device="cuda") -> FusedOptState:
    """The port's ``FusedOptState`` from the JAX package's.

    ``state`` is a JAX ``FusedOptState`` (its count and slots as arrays),
    ``params`` the flax params tree it was built for, and ``port_params``
    the port's ``{name: tensor}`` params in the order the port's optimizer
    sees them. Tree slots are mapped name for name; arena slot buffers are
    cut into tensors by the JAX package's layout, mapped, and packed again
    in the port's layout (``arena.plan(port_params)``).
    """
    order = list(port_params)
    jleaves = dict(_flatten(params, sort=True))
    jspec = arena.plan({k: np.asarray(v) for k, v in jleaves.items()})
    slots = {}
    for slot, tree in state.slots.items():
        if set(tree) == set(jspec.dtypes):      # arena buffers, by dtype
            jbufs = {dt: torch.from_numpy(np.array(buf))
                     for dt, buf in tree.items()}
            named = arena.unflatten(jbufs, jspec)
            mapped = dict(_port_leaf(k, v.numpy()) for k, v in named.items())
            tensors = {k: torch.tensor(np.asarray(mapped[k], np.float32),
                                       device=device) for k in order}
            slots[slot] = arena.flatten(
                tensors, arena.plan(port_params), cast=torch.float32)
        else:
            mapped = bert_params_from_jax(tree, device=device)
            slots[slot] = {k: mapped[k] for k in order}
    count = torch.tensor(int(np.asarray(state.count)), dtype=torch.int32,
                         device=device)
    return FusedOptState(count=count, slots=slots)
