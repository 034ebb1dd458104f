"""The fp16 helpers over ``{name: tensor}`` dicts.

The port of ``apex_tpu.fp16_utils.fp16util``. Params are the dicts a
``named_parameters()`` gives; the norm-layer exemption is the amp policy's
(a name component that reads as a norm layer: ``bn1``, ``batch_norm``,
``layer_norm``, ``norm``, ...). ``prep_param_lists(flat_master=True)`` keeps
the masters in one flat f32 arena buffer (:mod:`apex_tpu_torch.arena`).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
from torch.func import functional_call

from apex_tpu_torch import arena
from apex_tpu_torch.amp.policy import Policy
from apex_tpu_torch.utils import global_norm, tree_cast, tree_map


def tofp16(tree):
    """Floating leaves cast to fp16."""
    return tree_cast(tree, torch.float16)


def convert_network(params, dtype):
    """``params`` cast to ``dtype``, norm-layer params kept fp32."""
    return tree_cast(params, dtype,
                     predicate=lambda name, _x: not Policy._bn_exempt(name))


def network_to_half(params, half_dtype=torch.float16):
    """Half params with fp32 norms."""
    return convert_network(params, half_dtype)


class FP16Model(nn.Module):
    """Wraps a module: its floating inputs cast to half, and the module run
    at its params cast by :func:`convert_network` (norms fp32) through
    ``functional_call``. The stored params stay fp32: they are the masters
    a wrapping ``FP16_Optimizer`` owns."""

    def __init__(self, network: nn.Module, half_dtype=torch.float16):
        super().__init__()
        self.network = network
        self.half_dtype = half_dtype

    def forward(self, *args, **kwargs):
        args = tree_cast(args, self.half_dtype)
        params = convert_network(dict(self.network.named_parameters()),
                                 self.half_dtype)
        return functional_call(self.network, params, args, kwargs)


class MasterParams(NamedTuple):
    """:func:`prep_param_lists`' masters: ``tree`` (f32 per tensor), or
    ``flat`` = (``{partition dtype: f32 buffer}``, ``ArenaSpec``)."""

    tree: Optional[Any]
    flat: Optional[Tuple[Any, Any]]

    def to_tree(self):
        if self.flat is not None:
            bufs, spec = self.flat
            return arena.unflatten(bufs, spec)
        return self.tree


def prep_param_lists(params, flat_master: bool = False):
    """``(model_params, MasterParams)``: f32 master copies of ``params``;
    with ``flat_master`` one flat f32 arena buffer, which needs params of
    one dtype (mixed dtypes raise, as in the reference)."""
    if flat_master:
        spec = arena.plan(params)
        bufs = arena.flatten(params, spec, cast=torch.float32)
        if len(bufs) > 1:
            raise NotImplementedError(
                "flat_master with mixed model dtypes is not supported (the "
                "reference raises here too)")
        return params, MasterParams(tree=None, flat=(bufs, spec))
    return params, MasterParams(tree=tree_cast(params, torch.float32),
                                flat=None)


def model_grads_to_master_grads(model_grads, master: MasterParams):
    """Model grads as f32 master grads, in the masters' layout."""
    if master.flat is not None:
        return arena.flatten(model_grads, master.flat[1], cast=torch.float32)
    return tree_cast(model_grads, torch.float32)


def master_params_to_model_params(master: MasterParams, model_params):
    """The masters cast to each model param's dtype."""
    tree = master.to_tree()
    return {k: tree[k].to(p.dtype) for k, p in model_params.items()}


def _clip_factor(total, max_norm):
    """min(1, max_norm / (total + 1e-6)) in f32 on the device."""
    return torch.clamp(torch.full_like(total, float(max_norm))
                       / (total + 1e-6), max=1.0)


def clip_grad_norm(grads, max_norm, norm_type=2):
    """Global-norm clipping: ``(clipped, total_norm)``, the norm summed in
    f32 and each grad scaled in f32 and cast back to its dtype."""
    total = global_norm(grads, ord=norm_type)
    scale = _clip_factor(total, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), total


def to_python_float(t):
    """A device scalar read to the host."""
    return float(t)
