"""Fused optimizers over the flat arena: ``FusedLAMB``.

Port of ``apex_tpu/optim/fused.py``'s ``FusedOptimizer`` base and
``FusedLAMB`` with its defaults (weight_decay 0.01, max_grad_norm 1.0,
adam_w_mode, bias_correction). Two strategies compute the same f32 update:

- ``"arena"``: params, grads and moments live in flat per-dtype buffers
  (:mod:`apex_tpu_torch.arena`) and one launch of each kernel updates a
  whole partition: the global grad norm (``multi_tensor_l2norm``), LAMB
  stage 1, the per-tensor trust ratios (plain PyTorch over static ranges)
  and stage 2. The number of launches does not grow with the number of
  tensors.
- ``"tree"``: per-tensor eager PyTorch, a few launches per tensor.
- ``"auto"`` (default): tree from ``TREE_THRESHOLD`` params up, arena
  below, as in the JAX package.

Functional like the JAX package: ``step(grads, state, params)`` returns
new params and a new state and leaves its inputs untouched. Under the
arena the new params are views of the partition's new flat buffer.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from apex_tpu_torch import arena
from apex_tpu_torch.ops import multi_tensor as MT
from apex_tpu_torch.ops import optim_kernels as K


class FusedOptState(NamedTuple):
    """Step count + named f32 slots: per-param tensors under the tree
    strategy, per-partition flat buffers under the arena
    (``slots["m"]["float32"]`` covers every f32 param)."""
    count: torch.Tensor
    slots: Dict[str, Dict[str, torch.Tensor]]


class FusedOptimizer:
    """Base: strategy choice, arena planning, flatten/unflatten, and the
    fused (``step``) and optax-style (``update``) protocols."""

    #: names of f32 state buffers allocated per partition
    slot_names = ()

    #: "auto" switches to the tree strategy at this many parameters
    TREE_THRESHOLD = 8_000_000

    def __init__(self, lr, strategy: str = "auto"):
        if strategy not in ("auto", "tree", "arena"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.lr = lr
        self.strategy = strategy

    def _use_tree(self, params) -> bool:
        if self.strategy != "auto":
            return self.strategy == "tree"
        return sum(p.numel() for p in params.values()) >= self.TREE_THRESHOLD

    # -- protocol ------------------------------------------------------------

    def init(self, params) -> FusedOptState:
        device = next(iter(params.values())).device
        count = torch.tensor(0, dtype=torch.int32, device=device)
        if self._use_tree(params):
            return FusedOptState(count=count, slots={
                name: {k: torch.zeros_like(p, dtype=torch.float32)
                       for k, p in params.items()}
                for name in self.slot_names})
        spec = arena.plan(params)
        return FusedOptState(count=count, slots={
            name: arena.zeros(spec, dtype=torch.float32, device=device)
            for name in self.slot_names})

    def step(self, grads, state: FusedOptState, params):
        """Fused update: returns (new_params, new_state)."""
        if self._use_tree(params):
            return self._tree_step(grads, state, params)
        spec = arena.plan(params)
        p_bufs = arena.flatten(params, spec)
        g_bufs = arena.flatten(grads, spec, cast=torch.float32)
        count = state.count + 1
        lr = self._resolve_lr(count)

        ctx = self._step_context(spec, g_bufs)
        new_p, new_slots = {}, {name: {} for name in self.slot_names}
        for part in spec.partitions:
            dt = part.dtype
            slots = {name: state.slots[name][dt] for name in self.slot_names}
            p_out, s_out = self._partition_step(
                spec, dt, p_bufs[dt], g_bufs[dt], slots, count, lr, ctx=ctx)
            new_p[dt] = p_out
            for name in self.slot_names:
                new_slots[name][dt] = s_out[name]
        return (arena.unflatten(new_p, spec),
                FusedOptState(count=count, slots=new_slots))

    def update(self, grads, state: FusedOptState, params):
        """optax GradientTransformation protocol (updates = new - old)."""
        new_params, new_state = self.step(grads, state, params)
        updates = {k: (new_params[k].float() - p.float()).to(p.dtype)
                   for k, p in params.items()}
        return updates, new_state

    # -- subclass hooks ------------------------------------------------------

    def _step_context(self, spec, g_bufs):
        """Once-per-step work over all partitions (e.g. global grad norms)."""
        return None

    def _partition_step(self, spec, dt, p, g, slots, count, lr, ctx):
        raise NotImplementedError

    def _tree_step(self, grads, state, params):
        raise NotImplementedError(
            f"{type(self).__name__} has no tree strategy; construct with "
            f"strategy='arena'")

    def _resolve_lr(self, count):
        return self.lr(count) if callable(self.lr) else self.lr


def lamb_trust_ratios(part, p, u, *, use_nvlamb, weight_decay):
    """Per-position LAMB trust ratios over one arena partition: per-tensor
    norms of p and u over the partition's static ranges, ‖p‖/‖u‖ where
    both are positive (else 1), spread back over each tensor's slot (0 in
    the tail). Plain LAMB with wd == 0 takes every ratio as 1; NVLAMB
    applies the ratio even there."""
    if not use_nvlamb and weight_decay == 0.0:
        ratio = torch.ones(len(part.sizes), dtype=torch.float32,
                           device=p.device)
    else:
        p_norms = MT.per_tensor_l2norm_ranges(p, part.offsets, part.sizes)
        u_norms = MT.per_tensor_l2norm_ranges(u, part.offsets, part.sizes)
        ratio = torch.where((p_norms > 0) & (u_norms > 0),
                            p_norms / u_norms, 1.0)
    return MT.spread_per_tensor(ratio, part.offsets, part.padded, p.numel())


class FusedLAMB(FusedOptimizer):
    """LAMB (``apex/optimizers/fused_lamb.py``): global grad-norm clip,
    Adam-style direction, per-tensor trust ratio."""

    slot_names = ("m", "v")

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-6,
                 weight_decay=0.01, adam_w_mode=True, bias_correction=True,
                 max_grad_norm=1.0, use_nvlamb=False, strategy="auto"):
        super().__init__(lr, strategy)
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb

    def _global_clip_scale(self, g_all):
        """Clip factor from the global grad norm over *all* partitions: one
        l2norm launch per partition, none when clipping is off."""
        if not self.max_grad_norm:
            return 1.0
        sq = sum(torch.square(MT.multi_tensor_l2norm(g))
                 for g in g_all.values())
        gnorm = torch.sqrt(sq)
        return torch.where(gnorm > self.max_grad_norm,
                           self.max_grad_norm / gnorm, 1.0)

    def _step_context(self, spec, g_bufs):
        # the global grad norm, once per step over all partitions
        return self._global_clip_scale(g_bufs)

    def _partition_step(self, spec, dt, p, g, slots, count, lr, ctx):
        u, m2, v2 = K.lamb_stage1(
            p, g, slots["m"], slots["v"], beta1=self.beta1, beta2=self.beta2,
            eps=self.eps, weight_decay=self.weight_decay, step=count,
            bias_correction=self.bias_correction,
            adam_w_mode=self.adam_w_mode, clip_scale=ctx)
        ratio_pos = lamb_trust_ratios(spec.partition(dt), p, u,
                                      use_nvlamb=self.use_nvlamb,
                                      weight_decay=self.weight_decay)
        p2 = K.lamb_stage2(p, u, ratio_pos, lr=lr)
        return p2, {"m": m2, "v": v2}

    def _bias_corrections(self, count):
        if not self.bias_correction:
            return 1.0, 1.0
        step = count.float()
        one = torch.ones((), dtype=torch.float32, device=count.device)
        bc1 = 1.0 - torch.pow(one * self.beta1, step)
        bc2 = 1.0 - torch.pow(one * self.beta2, step)
        return bc1, bc2

    def _tree_step(self, grads, state, params):
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
