"""The legacy optimizers: externally scaled gradients.

The port of ``apex_tpu.optim.legacy``: the deprecated contrib
``FusedAdam``, ``FusedSGD`` and ``FusedLAMB`` take still-scaled gradients in
``step(grads, state, params, scale=..., output_dtype=...)``, unscale them
inside the arena kernels (their ``grad_scale``/``clip_scale`` operand) and
may write a reduced-precision copy of the new params in the same pass
(``output_dtype``: the reference's ``output_params``), returned as a third
element. An adapter over :mod:`apex_tpu_torch.ops.optim_kernels`: the
optimizer state is the arena ``FusedOptState`` of
:mod:`apex_tpu_torch.optim.fused`. Deprecated; prefer
``apex_tpu_torch.optim.Fused*`` under ``amp.Amp``.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import arena
from apex_tpu_torch.ops import multi_tensor as MT
from apex_tpu_torch.ops import optim_kernels as K
from apex_tpu_torch.optim import fused
from apex_tpu_torch.optim.fused import FusedOptState


class _LegacyFused:
    """``step(grads, state, params, scale=..., output_dtype=...)`` with the
    unscale inside the kernels, over the flat arena."""

    slot_names = ()

    def init(self, params) -> FusedOptState:
        spec = arena.plan(params)
        device = next(iter(params.values())).device
        return FusedOptState(
            count=torch.tensor(0, dtype=torch.int32, device=device),
            slots={name: arena.zeros(spec, dtype=torch.float32,
                                     device=device)
                   for name in self.slot_names})

    def _step_context(self, g_bufs, inv):
        """Once a step over every partition (LAMB's global-norm clip)."""
        return None

    def step(self, grads, state: FusedOptState, params, *,
             scale: float = 1.0, output_dtype=None):
        """One update from grads scaled by ``scale`` (divided out inside
        the kernels). Returns ``(params', state')``, or ``(params', state',
        copies)`` with the new params also in ``output_dtype``."""
        spec = arena.plan(params)
        p_bufs = arena.flatten(params, spec)
        g_bufs = arena.flatten(grads, spec, cast=torch.float32)
        count = state.count + 1
        lr = self.lr(count) if callable(self.lr) else self.lr
        inv = 1.0 / scale
        ctx = self._step_context(g_bufs, inv)
        new_p, copies = {}, {}
        new_slots = {n: {} for n in self.slot_names}
        for part in spec.partitions:
            dt = part.dtype
            slots = {n: state.slots[n][dt] for n in self.slot_names}
            out = self._kernel(part, p_bufs[dt], g_bufs[dt], slots, count,
                               lr, inv, output_dtype, ctx)
            new_p[dt] = out[0]
            for n, v in zip(self.slot_names,
                            out[1:1 + len(self.slot_names)]):
                new_slots[n][dt] = v
            if output_dtype is not None:
                copies[dt] = out[-1]
        params_out = arena.unflatten(new_p, spec)
        st = FusedOptState(count=count, slots=new_slots)
        if output_dtype is None:
            return params_out, st
        return params_out, st, arena.unflatten(copies, spec)


class FusedAdam(_LegacyFused):
    """The contrib FusedAdam: Adam/AdamW with the unscale in the kernel and
    an optional reduced-precision copy of the params."""

    slot_names = ("m", "v")

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adam_w_mode=True, bias_correction=True):
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction

    def _kernel(self, part, p, g, slots, count, lr, inv, output_dtype, ctx):
        return K.adam_update(
            p, g, slots["m"], slots["v"], lr=lr, beta1=self.beta1,
            beta2=self.beta2, eps=self.eps, weight_decay=self.weight_decay,
            step=count, adam_w_mode=self.adam_w_mode,
            bias_correction=self.bias_correction, grad_scale=inv,
            param_copy_dtype=output_dtype)


class FusedSGD(_LegacyFused):
    """The contrib FusedSGD: momentum SGD whose kernel unscales and writes
    the model copy."""

    slot_names = ("m",)

    def __init__(self, lr=1e-3, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False, wd_after_momentum=False):
        self.lr = lr
        self.momentum = momentum
        self.dampening = dampening
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.wd_after_momentum = wd_after_momentum

    def _kernel(self, part, p, g, slots, count, lr, inv, output_dtype, ctx):
        first = (count == 1) if self.momentum > 0 else False
        return K.sgd_update(
            p, g, slots["m"], lr=lr, momentum=self.momentum,
            dampening=self.dampening, weight_decay=self.weight_decay,
            nesterov=self.nesterov, first_run=first,
            wd_after_momentum=self.wd_after_momentum, grad_scale=inv,
            param_copy_dtype=output_dtype)


class FusedLAMB(_LegacyFused):
    """The contrib FusedLAMB: global grad-norm clip, Adam direction and
    per-tensor trust ratios. The grads arrive scaled, so the clip compares
    ``gnorm · (1/scale)`` with ``max_grad_norm`` and folds the clip factor
    and 1/scale into stage 1's one grad multiplier."""

    slot_names = ("m", "v")

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-6, weight_decay=0.01, adam_w_mode=True,
                 grad_averaging=True, max_grad_norm=1.0, use_nvlamb=False):
        self.lr = lr
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.grad_averaging = grad_averaging
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb

    def _step_context(self, g_bufs, inv):
        if not self.max_grad_norm:
            return inv
        sq = sum(torch.square(MT.multi_tensor_l2norm(g))
                 for g in g_bufs.values())
        gnorm = torch.sqrt(sq) * inv
        clip = torch.where(gnorm > self.max_grad_norm,
                           self.max_grad_norm / gnorm, 1.0)
        return (clip * inv).float()

    def _kernel(self, part, p, g, slots, count, lr, inv, output_dtype, ctx):
        u, m2, v2 = K.lamb_stage1(
            p, g, slots["m"], slots["v"], beta1=self.beta1,
            beta2=self.beta2, eps=self.eps, weight_decay=self.weight_decay,
            step=count, bias_correction=self.bias_correction,
            adam_w_mode=self.adam_w_mode, clip_scale=ctx,
            grad_averaging=self.grad_averaging)
        ratio_pos = fused.lamb_trust_ratios(
            part, p, u, use_nvlamb=self.use_nvlamb,
            weight_decay=self.weight_decay)
        out = K.lamb_stage2(p, u, ratio_pos, lr=lr,
                            param_copy_dtype=output_dtype)
        if output_dtype is not None:
            return out[0], m2, v2, out[1]
        return out, m2, v2
