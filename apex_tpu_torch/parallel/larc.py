"""LARC: layer-wise adaptive rate control.

Port of ``apex_tpu/parallel/larc.py``: an optimizer wrapper that rewrites
each parameter's gradient with its local trust ratio before the inner
optimizer (a fused optimizer of ``apex_tpu_torch.optim``: ``init`` and
``step``, or ``update``) sees it; each leaf of the tree is one "layer".

    larc = LARC(FusedSGD(lr=0.1), trust_coefficient=0.02, clip=True)
    state = larc.init(params)
    params, state = larc.step(grads, state, params)
"""

from __future__ import annotations

import torch

from apex_tpu_torch.utils import tree_map


def larc_rewrite_grads(grads, params, *, lr, trust_coefficient: float = 0.02,
                       clip: bool = True, eps: float = 1e-8,
                       weight_decay: float = 0.0):
    """Per-leaf LARC gradient rewrite: adaptive = trust·‖p‖ / (‖g‖ +
    wd·‖p‖ + eps), capped at 1 relative to ``lr`` in ``clip`` mode;
    g ← (g + wd·p)·adaptive, so the inner optimizer must not apply the
    weight decay again. A zero parameter or gradient norm leaves the
    gradient untouched (no weight decay either). Norms in f32, on the
    device: nothing is read back to the host."""
    if clip and lr is None:
        raise ValueError("clip mode requires lr")

    def _rewrite(g, p):
        if not (isinstance(g, torch.Tensor) and g.is_floating_point()):
            return g
        p32, g32 = p.float(), g.float()
        pn = torch.linalg.vector_norm(p32.reshape(-1))
        gn = torch.linalg.vector_norm(g32.reshape(-1))
        adaptive = trust_coefficient * pn / (gn + pn * weight_decay + eps)
        if clip:
            adaptive = torch.clamp_max(adaptive / lr, 1.0)
        new_g = (g32 + weight_decay * p32) * adaptive
        active = (pn != 0.0) & (gn != 0.0)
        return torch.where(active, new_g, g32).to(g.dtype)

    return tree_map(_rewrite, grads, params)


class LARC:
    """Optimizer wrapper with the reference's constructor signature; the
    inner optimizer exposes ``init`` and ``step`` (or ``update``)."""

    def __init__(self, optimizer, trust_coefficient: float = 0.02,
                 clip: bool = True, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.inner = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps
        self.weight_decay = weight_decay

    def init(self, params):
        return self.inner.init(params)

    def _lr(self, lr):
        if lr is not None:
            return lr
        lr = getattr(self.inner, "lr", None)
        if lr is None:
            raise ValueError("clip mode needs lr: pass lr= or use an inner "
                             "optimizer with a .lr attribute")
        return lr

    def _rewrite(self, grads, params, lr):
        return larc_rewrite_grads(
            grads, params, lr=self._lr(lr) if self.clip else None,
            trust_coefficient=self.trust_coefficient, clip=self.clip,
            eps=self.eps, weight_decay=self.weight_decay)

    def step(self, grads, state, params, *, lr=None):
        grads = self._rewrite(grads, params, lr)
        if hasattr(self.inner, "step"):
            return self.inner.step(grads, state, params)
        updates, state = self.inner.update(grads, state, params)
        return tree_map(lambda p, u: p + u.to(p.dtype), params,
                        updates), state

    def update(self, grads, state, params, *, lr=None):
        return self.inner.update(self._rewrite(grads, params, lr), state,
                                 params)
