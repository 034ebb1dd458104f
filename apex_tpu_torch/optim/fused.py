"""FusedLAMB: LAMB with a global grad-norm clip and per-tensor trust ratios.

Port of ``apex_tpu/optim/fused.py``'s ``FusedLAMB`` with its defaults
(weight_decay 0.01, max_grad_norm 1.0, adam_w_mode, bias_correction) and
its ``"tree"`` strategy: the same f32 per-tensor math, one leaf at a time,
in plain PyTorch. BERT-Large (about 335M params) is above the JAX
package's ``TREE_THRESHOLD``, so ``"auto"`` takes the tree update there
too. Below the threshold the JAX package runs its arena kernels, which
compute the same update; they are not ported yet, so ``"auto"`` runs the
tree update at every size and ``"arena"`` raises.

Functional like the JAX package: ``step(grads, state, params)`` returns
new params and a new state and leaves its inputs untouched.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

_ARENA = ("FusedLAMB(strategy='arena') needs the flat-arena LAMB kernels, "
          "which are not ported yet (ROADMAP.md queue B, arena and "
          "multi-tensor kernels)")


class FusedOptState(NamedTuple):
    """Step count + named f32 slot buffers, one per param."""
    count: torch.Tensor
    slots: Dict[str, Dict[str, torch.Tensor]]


class FusedLAMB:
    slot_names = ("m", "v")

    #: the JAX package's "auto" switches to its tree update at this size
    TREE_THRESHOLD = 8_000_000

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-6,
                 weight_decay=0.01, adam_w_mode=True, bias_correction=True,
                 max_grad_norm=1.0, use_nvlamb=False, strategy="auto"):
        if strategy not in ("auto", "tree", "arena"):
            raise ValueError(f"unknown strategy {strategy!r}")
        if strategy == "arena":
            raise NotImplementedError(_ARENA)
        self.lr = lr
        self.strategy = strategy
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb

    def init(self, params) -> FusedOptState:
        device = next(iter(params.values())).device
        return FusedOptState(
            count=torch.tensor(0, dtype=torch.int32, device=device),
            slots={name: {k: torch.zeros_like(p, dtype=torch.float32)
                          for k, p in params.items()}
                   for name in self.slot_names})

    def _bias_corrections(self, count):
        if not self.bias_correction:
            return 1.0, 1.0
        step = count.float()
        one = torch.ones((), dtype=torch.float32, device=count.device)
        bc1 = 1.0 - torch.pow(one * self.beta1, step)
        bc2 = 1.0 - torch.pow(one * self.beta2, step)
        return bc1, bc2

    def step(self, grads, state: FusedOptState, params):
        """Returns (new_params, new_state)."""
        count = state.count + 1
        lr = self.lr(count) if callable(self.lr) else self.lr
        bc1, bc2 = self._bias_corrections(count)
        b1, b2, eps, wd = self.beta1, self.beta2, self.eps, self.weight_decay

        if self.max_grad_norm:
            sq = sum(torch.sum(torch.square(g.float()))
                     for g in grads.values())
            gnorm = torch.sqrt(sq)
            clip = torch.where(gnorm > self.max_grad_norm,
                               self.max_grad_norm / gnorm, 1.0)
        else:
            clip = 1.0
        plain_identity = not self.use_nvlamb and wd == 0.0

        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            p32 = p.float()
            g32 = grads[k].float() * clip
            if not self.adam_w_mode:
                g32 = g32 + wd * p32
            m2 = b1 * state.slots["m"][k] + (1.0 - b1) * g32
            v2 = b2 * state.slots["v"][k] + (1.0 - b2) * g32 * g32
            u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
            if self.adam_w_mode:
                u = u + wd * p32
            if plain_identity:
                ratio = 1.0
            else:
                pn = torch.sqrt(torch.sum(torch.square(p32)))
                un = torch.sqrt(torch.sum(torch.square(u)))
                ratio = torch.where((pn > 0) & (un > 0), pn / un, 1.0)
            new_p[k] = (p32 - lr * ratio * u).to(p.dtype)
            new_m[k], new_v[k] = m2, v2
        return new_p, FusedOptState(count=count,
                                    slots={"m": new_m, "v": new_v})
