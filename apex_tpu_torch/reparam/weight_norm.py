"""Weight normalization: ``w = g · v/‖v‖`` recomputed before every forward.

Port of ``apex_tpu/reparam/weight_norm.py``, which wraps flax's
``nn.WeightNorm`` with its defaults: the wrapped layer's kernel ``v`` is
normalized per output feature (flax's ``feature_axes=-1`` of an (in, out)
kernel; a port weight is (out, in, ...), so the norm runs over every dim
but 0) as ``v · rsqrt(Σ v² + 1e-12)``, then scaled by ``g`` (``scale``,
one per output feature, initialized to ones); only the kernel is
normalized (``variable_filter={"kernel"}``), the bias is used as it is.

The norm is computed in f32 whatever the weight's dtype: the fp16 hazard
the reference's hooks exist for (squares of entries near 1e-4 underflow in
fp16). The normalized weight comes back in the promoted dtype of ``v`` and
``g``, as flax returns it. ``remove_weight_norm`` folds ``g · v/‖v‖``
into a plain weight once, without the ε, as the JAX package's does.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
from torch.func import functional_call

EPS = 1e-12


def _norm_dims(v):
    return tuple(range(1, v.dim()))


def _per_feature(g, v):
    return g.float().view(-1, *([1] * (v.dim() - 1)))


def normalized_weight(v, g, dtype=None):
    """``g · v · rsqrt(Σ v² + ε)`` per output feature (dim 0), in f32, then
    in ``dtype``, by default the promoted dtype of ``v`` and ``g``."""
    v32 = v.float()
    w = v32 * torch.rsqrt((v32 * v32).sum(dim=_norm_dims(v), keepdim=True)
                          + EPS) * _per_feature(g, v)
    return w.to(dtype or torch.promote_types(v.dtype, g.dtype))


def _fold(v, g):
    """``remove_weight_norm``'s ``g · v/‖v‖`` with no ε, in ``v``'s
    dtype."""
    v32 = v.float()
    norm = torch.sqrt((v32 * v32).sum(dim=_norm_dims(v), keepdim=True))
    return (_per_feature(g, v) * v32 / norm).to(v.dtype)


class WeightNorm(nn.Module):
    """``WeightNorm(layer)``: ``layer`` (a port ``Dense``, ``Conv``, or any
    module with one ``weight``) runs with its weight reparameterized as
    direction (``layer.weight``, v) times magnitude (``scale``, g)."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        self.layer = layer
        w = layer.weight
        self.scale = nn.Parameter(torch.ones(w.shape[0], device=w.device))

    def weight(self):
        return normalized_weight(self.layer.weight, self.scale)

    def forward(self, *args, **kwargs):
        params = dict(self.layer.named_parameters())
        params["weight"] = self.weight()
        return functional_call(self.layer, params, args, kwargs)


def apply_weight_norm(layer: nn.Module, name=None, dim: int = 0) -> WeightNorm:
    """``apex.reparameterization.apply_weight_norm(module)``. ``name`` and
    ``dim`` are taken for the signature and ignored, as in the JAX
    package: the norm is per output feature of ``layer.weight``."""
    del name, dim
    return WeightNorm(layer)


def _prefix(name, leaf):
    """``p`` of ``name == p + leaf`` with ``p`` empty or a module path
    ending in ".", else None."""
    if not name.endswith(leaf):
        return None
    p = name[:-len(leaf)]
    return p if p == "" or p.endswith(".") else None


def remove_weight_norm(params: Dict[str, torch.Tensor]):
    """Fold ``g · v/‖v‖`` into a plain weight, once, without the ε: a
    ``{name: tensor}`` params dict (the JAX package's takes the params
    tree) with every ``<prefix>layer.weight`` folded by its
    ``<prefix>scale`` and the scales dropped; load the result into the
    wrapped layers (``<prefix>layer``)."""
    owners = {p for p in (_prefix(k, "scale") for k in params)
              if p is not None and p + "layer.weight" in params}
    out = {}
    for k, v in params.items():
        if _prefix(k, "scale") in owners:
            continue
        p = _prefix(k, "layer.weight")
        out[k] = _fold(v, params[p + "scale"]) if p in owners else v
    return out
