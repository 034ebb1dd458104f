"""Fused optimizers over the flat arena: ``FusedAdam``, ``FusedLAMB``,
``FusedSGD``, ``FusedAdagrad`` and ``FusedNovoGrad``.

Port of ``apex_tpu/optim/fused.py``'s ``FusedOptimizer`` base,
``FusedAdam`` (eps 1e-8, no weight decay, AdamW mode and bias correction
by default), ``FusedLAMB`` with its defaults (weight_decay 0.01,
max_grad_norm 1.0, adam_w_mode, bias_correction), ``FusedSGD``
(momentum, dampening, nesterov, weight decay before or after the
momentum), ``FusedAdagrad`` (lr 1e-2, eps 1e-10, weight decay folded into
the grad unless ``adagrad_w_mode``) and ``FusedNovoGrad`` (per-tensor
norm EMAs, the reference's defaults). Two strategies compute the same f32
update:

- ``"arena"``: params, grads and moments live in flat per-dtype buffers
  (:mod:`apex_tpu_torch.arena`) and one launch of each kernel updates a
  whole partition: for LAMB the global grad norm (``multi_tensor_l2norm``),
  stage 1, the per-tensor trust ratios (plain PyTorch over static ranges)
  and stage 2; for Adam one ``adam`` launch, for SGD one ``sgd`` launch,
  for Adagrad one ``adagrad`` launch; for NovoGrad the per-tensor grad
  norms and their EMA (plain PyTorch over static ranges) and one
  ``novograd`` launch. The number of launches does not grow with the
  number of tensors.
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

    #: names of f32 state buffers allocated per partition (a subclass's
    #: ``init`` may add slots of another shape; ``step`` carries them all)
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
        new_p, new_slots = {}, {name: {} for name in state.slots}
        for part in spec.partitions:
            dt = part.dtype
            slots = {name: state.slots[name][dt] for name in state.slots}
            p_out, s_out = self._partition_step(
                spec, dt, p_bufs[dt], g_bufs[dt], slots, count, lr, ctx=ctx)
            new_p[dt] = p_out
            for name in state.slots:
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


class FusedAdam(FusedOptimizer):
    """Adam/AdamW (``apex/optimizers/fused_adam.py``); ``adam_w_mode=True``
    decouples the weight decay (AdamW), the reference's default."""

    slot_names = ("m", "v")

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adam_w_mode=True, bias_correction=True,
                 strategy="auto"):
        super().__init__(lr, strategy)
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction

    def _partition_step(self, spec, dt, p, g, slots, count, lr, ctx):
        p2, m2, v2 = K.adam_update(
            p, g, slots["m"], slots["v"], lr=lr, beta1=self.beta1,
            beta2=self.beta2, eps=self.eps, weight_decay=self.weight_decay,
            step=count, adam_w_mode=self.adam_w_mode,
            bias_correction=self.bias_correction)
        return p2, {"m": m2, "v": v2}

    def _tree_step(self, grads, state, params):
        count = state.count + 1
        lr = self._resolve_lr(count)
        bc1, bc2 = K.bias_corrections(self.beta1, self.beta2, count,
                                      self.bias_correction, count.device)
        b1, b2, eps, wd = self.beta1, self.beta2, self.eps, self.weight_decay
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            p32 = p.float()
            g32 = grads[k].float()
            if not self.adam_w_mode:
                g32 = g32 + wd * p32
            m2 = b1 * state.slots["m"][k] + (1.0 - b1) * g32
            v2 = b2 * state.slots["v"][k] + (1.0 - b2) * g32 * g32
            upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
            if self.adam_w_mode:
                upd = upd + wd * p32
            new_p[k] = (p32 - lr * upd).to(p.dtype)
            new_m[k], new_v[k] = m2, v2
        return new_p, FusedOptState(count=count,
                                    slots={"m": new_m, "v": new_v})


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

    def _tree_step(self, grads, state, params):
        count = state.count + 1
        lr = self._resolve_lr(count)
        bc1, bc2 = K.bias_corrections(self.beta1, self.beta2, count,
                                      self.bias_correction, count.device)
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


class FusedSGD(FusedOptimizer):
    """SGD with momentum (``apex/optimizers/fused_sgd.py``). The first
    step sets the momentum buffer to the gradient (PyTorch's rule) through
    ``count == 1``, a device flag that is never read back to the host."""

    slot_names = ("m",)

    def __init__(self, lr=1e-3, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False, wd_after_momentum=False,
                 strategy="auto"):
        super().__init__(lr, strategy)
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "Nesterov momentum requires a momentum and zero dampening")
        self.momentum = momentum
        self.dampening = dampening
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.wd_after_momentum = wd_after_momentum

    def _first(self, count):
        return (count == 1) & (self.momentum > 0)

    def _partition_step(self, spec, dt, p, g, slots, count, lr, ctx):
        p2, m2 = K.sgd_update(
            p, g, slots["m"], lr=lr, momentum=self.momentum,
            dampening=self.dampening, weight_decay=self.weight_decay,
            nesterov=self.nesterov, first_run=self._first(count),
            wd_after_momentum=self.wd_after_momentum)
        return p2, {"m": m2}

    def _tree_step(self, grads, state, params):
        count = state.count + 1
        lr = self._resolve_lr(count)
        first = self._first(count)
        mom, damp, wd = self.momentum, self.dampening, self.weight_decay
        new_p, new_m = {}, {}
        for k, p in params.items():
            p32 = p.float()
            g32 = grads[k].float()
            if not self.wd_after_momentum:
                g32 = g32 + wd * p32
            m2 = torch.where(first, g32,
                             mom * state.slots["m"][k] + (1.0 - damp) * g32)
            upd = g32 + mom * m2 if self.nesterov else m2
            if self.wd_after_momentum:
                upd = upd + wd * p32
            new_p[k], new_m[k] = (p32 - lr * upd).to(p.dtype), m2
        return new_p, FusedOptState(count=count, slots={"m": new_m})


class FusedAdagrad(FusedOptimizer):
    """Adagrad (``apex/optimizers/fused_adagrad.py``): h += g², p −=
    lr·g/(√h + eps); the weight decay is folded into the grad, or
    decoupled with ``adagrad_w_mode``."""

    slot_names = ("h",)

    def __init__(self, lr=1e-2, eps=1e-10, weight_decay=0.0,
                 adagrad_w_mode=False, strategy="auto"):
        super().__init__(lr, strategy)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adagrad_w_mode = adagrad_w_mode

    def _partition_step(self, spec, dt, p, g, slots, count, lr, ctx):
        p2, h2 = K.adagrad_update(
            p, g, slots["h"], lr=lr, eps=self.eps,
            weight_decay=self.weight_decay,
            adagrad_w_mode=self.adagrad_w_mode)
        return p2, {"h": h2}

    def _tree_step(self, grads, state, params):
        count = state.count + 1
        lr = self._resolve_lr(count)
        wd, eps = self.weight_decay, self.eps
        new_p, new_h = {}, {}
        for k, p in params.items():
            p32 = p.float()
            g32 = grads[k].float()
            if not self.adagrad_w_mode:
                g32 = g32 + wd * p32
            h2 = state.slots["h"][k] + g32 * g32
            upd = g32 / (torch.sqrt(h2) + eps)
            if self.adagrad_w_mode:
                upd = upd + wd * p32
            new_p[k], new_h[k] = (p32 - lr * upd).to(p.dtype), h2
        return new_p, FusedOptState(count=count, slots={"h": new_h})


class FusedNovoGrad(FusedOptimizer):
    """NovoGrad (``apex/optimizers/fused_novograd.py``).

    The per-tensor norm EMAs are the ``vnorm`` slot: a (num_tensors,) f32
    vector per partition under the arena, a 0-d f32 per tensor under the
    tree. They hold norms (the reference's ``exp_avg_sq`` stores norms,
    not squares) and blend linearly, β2·v + (1 − β2)·‖g‖; on the first
    step (``count == 1``, a device flag) the norm itself is taken, unless
    ``init_zero``. Defaults as the reference: decoupled decay
    (``reg_inside_moment=False``), bias correction, grad averaging, L2
    norms (``norm_type=2``; 0 takes max norms).
    """

    slot_names = ("m",)

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, bias_correction=True,
                 reg_inside_moment=False, grad_averaging=True, norm_type=2,
                 init_zero=False, strategy="auto"):
        super().__init__(lr, strategy)
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.reg_inside_moment = reg_inside_moment
        self.grad_averaging = grad_averaging
        if norm_type not in (0, 2):
            raise ValueError("FusedNovoGrad only supports l2/inf norm")
        self.norm_type = norm_type
        self.init_zero = init_zero

    def init(self, params) -> FusedOptState:
        state = super().init(params)
        if self._use_tree(params):
            vnorm = {k: torch.zeros((), dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
        else:
            vnorm = {part.dtype: torch.zeros(len(part.sizes),
                                             dtype=torch.float32,
                                             device=state.count.device)
                     for part in arena.plan(params).partitions}
        return state._replace(slots={**state.slots, "vnorm": vnorm})

    def _blend(self, v_prev, norms, count):
        """The new norm EMA: the norm itself on the first step unless
        ``init_zero``, decided on the device."""
        blended = self.beta2 * v_prev + (1.0 - self.beta2) * norms
        if self.init_zero:
            return blended
        return torch.where(count == 1, norms, blended)

    def _partition_step(self, spec, dt, p, g, slots, count, lr, ctx):
        """Per-tensor grad norms over the partition's static ranges, their
        EMA, its spread over the layout (1.0 in gaps and the tail, where g
        and m are 0, so p stays 0 there) and one ``novograd`` launch."""
        part = spec.partition(dt)
        norm = (MT.per_tensor_l2norm_ranges if self.norm_type == 2
                else MT.per_tensor_maxnorm_ranges)
        v = self._blend(slots["vnorm"], norm(g, part.offsets, part.sizes),
                        count)
        vpos = MT.spread_per_tensor(v, part.offsets, part.padded, p.numel(),
                                    fill=1.0)
        p2, m2 = K.novograd_update(
            p, g, slots["m"], vpos, lr=lr, beta1=self.beta1, beta2=self.beta2,
            eps=self.eps, weight_decay=self.weight_decay, step=count,
            grad_averaging=self.grad_averaging,
            bias_correction=self.bias_correction,
            reg_inside_moment=self.reg_inside_moment)
        return p2, {"m": m2, "vnorm": v}

    def _tree_step(self, grads, state, params):
        count = state.count + 1
        lr = self._resolve_lr(count)
        bc1, bc2 = K.bias_corrections(self.beta1, self.beta2, count,
                                      self.bias_correction, count.device,
                                      sqrt2=True)
        b1, wd, eps = self.beta1, self.weight_decay, self.eps
        b3 = (1.0 - b1) if self.grad_averaging else 1.0
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            p32 = p.float()
            g32 = grads[k].float()
            if self.norm_type == 2:
                nrm = torch.sqrt(torch.sum(torch.square(g32)))
            else:
                nrm = torch.amax(torch.abs(g32))
            v = self._blend(state.slots["vnorm"][k], nrm, count)
            denom = v / bc2 + eps
            m = state.slots["m"][k]
            if self.reg_inside_moment:
                m2 = b1 * m + b3 * (g32 / denom + wd * p32)
                p2 = p32 - lr * (m2 / bc1)
            else:
                m2 = b1 * m + b3 * g32
                p2 = p32 - lr * ((m2 / bc1) / denom + wd * p32)
            new_p[k], new_m[k], new_v[k] = p2.to(p.dtype), m2, v
        return new_p, FusedOptState(count=count,
                                    slots={"m": new_m, "vnorm": new_v})
