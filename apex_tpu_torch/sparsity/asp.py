"""ASP — automatic sparsity: 2:4 masks woven into training.

Port of ``apex_tpu/sparsity/asp.py`` over the port's flat ``{name:
tensor}`` params. As there, the reference's mutation (mask buffers on
whitelisted modules, a patched ``optimizer.step`` that prunes grads before
and weights after each update) is a transform: masks are state, and
pruning wraps the inner optimizer.

Decisions are taken as the JAX package takes them for the same weights:
the whitelist reads each leaf's JAX name (``convert.jax_name``: the port
calls BERT's token table ``tok_emb.weight``, the JAX package
``tok_emb/embedding``, which it keeps dense), and a mask is computed on the
leaf seen in the JAX layout (``convert.to_jax_layout``: a Dense weight
transposed back to (in, out), a conv's to (kh, kw, I, O)), so the groups of
4 run along the same axis, the JAX kernel's last: its output features.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from apex_tpu_torch import convert
from apex_tpu_torch.sparsity import masklib

_BANNED = ("bias", "scale", "embedding", "norm", "bn")


def default_whitelist(name: str = "", leaf=None) -> bool:
    """The JAX package's whitelist on the leaf's JAX name: prune 2-D+
    leaves, skip any whose path names a bias, scale, embedding or norm."""
    if leaf is None or getattr(leaf, "ndim", 0) < 2:
        return False
    parts = convert.jax_name(name).lower().split(".")
    return not any(b in p for p in parts for b in _BANNED)


class ASPState(NamedTuple):
    masks: Dict[str, Optional[torch.Tensor]]   # bool masks, None = dense
    inner: Any                                 # the wrapped optimizer's state


def compute_sparse_masks(params, pattern: str = "m4n2_1d",
                         whitelist: Optional[Callable] = None):
    """``{name: bool mask or None}`` for ``params``; ``whitelist(name,
    leaf)`` picks the leaves to prune (None: dense). Each mask has its
    leaf's shape and memory format."""
    whitelist = whitelist or default_whitelist
    masks = {}
    for name, leaf in params.items():
        if not whitelist(name, leaf):
            masks[name] = None
            continue
        m = masklib.create_mask(convert.to_jax_layout(name, leaf), pattern)
        masks[name] = torch.empty_like(leaf, dtype=torch.bool).copy_(
            convert.from_jax_layout(name, m))
    return masks


def prune(tree, masks):
    """Zero each leaf where its mask is False (None: as it is)."""
    return {k: x if masks[k] is None
            else torch.where(masks[k], x, x.new_zeros(()))
            for k, x in tree.items()}


class ASP:
    """Optimizer wrapper: prune grads before and params after the inner
    update, the semantics of the reference's patched ``optimizer.step``.
    Works with fused (``step``) and optax-style (``update``) optimizers.

        asp = ASP(FusedAdam(lr=1e-3), pattern="m4n2_1d")
        state = asp.init(params)              # masks computed here
        params, state = asp.step(grads, state, params)
    """

    def __init__(self, optimizer, pattern: str = "m4n2_1d",
                 whitelist: Optional[Callable] = None):
        self.inner = optimizer
        self.pattern = pattern
        self.whitelist = whitelist

    def init(self, params) -> ASPState:
        masks = compute_sparse_masks(params, self.pattern, self.whitelist)
        return ASPState(masks=masks,
                        inner=self.inner.init(prune(params, masks)))

    def recompute_masks(self, state: ASPState, params) -> ASPState:
        """Masks from the current weights (e.g. after loading a dense
        checkpoint)."""
        return state._replace(masks=compute_sparse_masks(
            params, self.pattern, self.whitelist))

    def step(self, grads, state: ASPState, params):
        grads = prune(grads, state.masks)
        if hasattr(self.inner, "step"):
            new_params, inner = self.inner.step(grads, state.inner, params)
        else:
            updates, inner = self.inner.update(grads, state.inner, params)
            new_params = {k: p + updates[k].to(p.dtype)
                          for k, p in params.items()}
        new_params = prune(new_params, state.masks)
        return new_params, ASPState(masks=state.masks, inner=inner)

    def update(self, grads, state: ASPState, params):
        new_params, new_state = self.step(grads, state, params)
        updates = {k: (n.float() - params[k].float()).to(params[k].dtype)
                   for k, n in new_params.items()}
        return updates, new_state
