"""The L1 cross-product grid's net and runner on the port (not a test
module).

``tests/test_l1_cross_product.py`` trains a Conv + BN + Dense + LayerNorm +
Dense net on B8 8x8x3, 10 classes, 6 steps of SGD (lr 0.05, momentum 0.9)
over O0-O3 x {dynamic, static 128, none} x keep_batchnorm_fp32 {on, off}.
This module is the port's side of that grid: the net (:func:`net`), its
init (:func:`init`), the batches (:func:`data`), a plain SGD replica
(:class:`RefSGD`), the runner (:func:`run`: the kernel path or the plain
path) and the comparison of two runs (:func:`compare`). It imports no JAX:
``tests/test_torch_l1_cross_product.py`` holds it against the JAX package
on the CPU, and ``chip_smoke.py`` runs it on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import functional_call

from apex_tpu_torch import amp, ops
from apex_tpu_torch.models.layers import BatchNorm, Conv
from apex_tpu_torch.models.transformer import Dense
from apex_tpu_torch.optim import FusedSGD

BATCH, HW, CH, HIDDEN, CLASSES = 8, 8, 8, 32, 10
STEPS = 6
LR, MOMENTUM = 0.05, 0.9
GRID = [(ol, sn, sv, kb) for ol in ("O0", "O1", "O2", "O3")
        for sn, sv in (("dynamic", "dynamic"), ("static128", 128.0),
                       ("none", None))
        for kb in (True, False)]
# the kernels a step: the LayerNorm pair and the cross-entropy pair once
# each (the arena SGD once a partition)
PER_STEP = {"layer_norm_fwd": 1, "layer_norm_bwd": 1, "xentropy_fwd": 1,
            "xentropy_bwd": 1}

def policy(opt_level, loss_scale, keep_bn, **kw):
    """The cell's policy, or None where validation rejects it (the JAX
    test skips those cells)."""
    try:
        return amp.Policy.from_opt_level(opt_level, loss_scale=loss_scale,
                                         keep_batchnorm_fp32=keep_bn, **kw)
    except ValueError:
        return None


def net(dtype, fused, device):
    """The L1 grid's Net (``Net`` of the JAX test): conv (with bias) -> BN
    (momentum 0.9) -> ReLU -> spatial mean -> fc1 -> LayerNorm (the fused
    op, or its plain reference) -> fc2, every layer computing in
    ``dtype``; params named as the flax ones (``convert.params_from_jax``
    maps a flax init onto it). ``forward(x)`` returns (logits, the new BN
    statistics)."""

    class BiasConv(Conv):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.bias = torch.nn.Parameter(torch.zeros(
                self.weight.shape[0], device=self.weight.device))

        def forward(self, x):
            y = super().forward(x)
            return y + self.bias.to(y.dtype)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = BiasConv(3, CH, (3, 3), dtype=dtype, device=device)
            self.bn = BatchNorm(CH, momentum=0.9, dtype=dtype, device=device)
            self.fc1 = Dense(CH, HIDDEN, device=device, dtype=dtype)
            self.ln_scale = torch.nn.Parameter(torch.ones(HIDDEN,
                                                          device=device))
            self.ln_bias = torch.nn.Parameter(torch.zeros(HIDDEN,
                                                          device=device))
            self.fc2 = Dense(HIDDEN, CLASSES, device=device, dtype=dtype)

        def forward(self, x):
            stats = {}
            x = torch.relu(self.bn(self.conv(x), train=True, stats=stats))
            x = self.fc1(torch.mean(x, dim=(1, 2)))
            ln = (ops.fused_layer_norm_affine if fused
                  else ops.layer_norm_reference)
            x = self.fc2(ln(x, self.ln_scale, self.ln_bias, 1e-5))
            mean, var = stats[self.bn]
            return x, {"bn.mean": mean, "bn.var": var}

    return Net()


class RefSGD:
    """Plain PyTorch replica of FusedSGD's math (the JAX test's
    ``RefSGD``): the momentum buffer is the first gradient, then m = μ·m
    + g, p -= lr·m, per tensor in f32."""

    def __init__(self, lr, momentum):
        self.lr, self.momentum = lr, momentum

    def init(self, params):
        p0 = next(iter(params.values()))
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=p0.device),
                "m": {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in params.items()}}

    def step(self, grads, state, params):
        count = state["count"] + 1
        first = count == 1
        new_p, new_m = {}, {}
        for k, p in params.items():
            g32 = grads[k].float()
            m2 = torch.where(first, g32, self.momentum * state["m"][k] + g32)
            new_p[k] = (p.float() - self.lr * m2).to(p.dtype)
            new_m[k] = m2
        return new_p, {"count": count, "m": new_m}


def data(poison_steps=(), device="cuda"):
    """The grid's batches, as the JAX test draws them (inf in the first
    element of a poisoned step)."""
    rng = np.random.RandomState(0)
    xs = rng.randn(STEPS, BATCH, HW, HW, 3).astype(np.float32)
    for s in poison_steps:
        xs[s, 0, 0, 0, 0] = np.inf
    ys = rng.randint(0, CLASSES, (STEPS, BATCH))
    return (torch.as_tensor(xs, device=device),
            torch.as_tensor(ys, dtype=torch.int64, device=device))


def init(model, seed=0):
    """``model``'s params from a seed (flax's kinds of init: kernels
    lecun-normal, biases 0, norms 1/0) and its BN statistics 0/1."""
    dev = next(model.parameters()).device
    gen = torch.Generator(dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight"):
                fan_in = p[0].numel()
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
            elif name in ("bn.scale", "ln_scale"):
                p.fill_(1.0)
            else:
                p.zero_()
    return ({k: v.detach().clone() for k, v in model.named_parameters()},
            {k: v.detach().clone() for k, v in model.named_buffers()})


def run(policy, fused, poison_steps=(), device="cuda", variables=None,
        steps=STEPS, state=None):
    """Train the grid's Net ``steps`` steps under ``policy``: ``fused`` the
    kernel path (the fused LayerNorm and cross-entropy, FusedSGD on the
    arena), else the plain path (their plain references and ``RefSGD``).
    ``variables`` = (params, BN statistics) by port name (default
    :func:`init`); ``state`` = (AmpState, statistics, first step) to
    continue from. Returns (losses, finite flags, scales, state, stats)."""
    model = net(policy.compute_dtype, fused, device)
    params, bs = variables if variables is not None else init(model)
    xs, ys = data(poison_steps, device)
    tx = (FusedSGD(lr=LR, momentum=MOMENTUM) if fused
          else RefSGD(LR, MOMENTUM))
    amp_opt = amp.Amp(policy, tx)
    ce = (ops.softmax_cross_entropy_loss if fused
          else ops.softmax_cross_entropy_reference)
    if state is None:
        st, first = amp_opt.init(params), 0
    else:
        st, bs, first = state
    losses, finites, scales = [], [], []
    for i in range(first, first + steps):
        def loss_fn(mp):
            logits, new = functional_call(model, {**mp, **bs}, (xs[i],))
            return torch.mean(ce(logits, ys[i])), new

        (loss, new_bs), grads, st, fin = amp_opt.backward(st, loss_fn,
                                                          has_aux=True)
        st = amp_opt.apply_gradients(st, grads, fin)
        bs = {k: v.detach() for k, v in new_bs.items()}
        losses.append(loss.item())
        finites.append(bool(fin) if isinstance(fin, bool)
                       else bool(fin.item()))
        s = st.scalers[0]
        scales.append(None if s is None else s.loss_scale.item())
    return losses, finites, scales, st, bs


def compare(label, fused, ref, tol):
    """Decisions bitwise (finite flags, scales, step), losses and params at
    ``tol`` (relative and absolute); returns the worst float distance."""
    (lf, ff, sf, stf, _), (lr, fr, sr, str_, _) = fused, ref
    if ff != fr or sf != sr or int(stf.step) != int(str_.step):
        raise AssertionError(f"l1 {label}: decisions differ: finite {ff} vs "
                             f"{fr}, scales {sf} vs {sr}")
    worst = 0.0
    for a, b in zip(lf, lr):
        if math.isnan(a) and math.isnan(b):      # a poisoned step, both
            continue
        if not abs(a - b) <= tol + tol * abs(b):
            raise AssertionError(f"l1 {label}: loss {a} vs {b}")
        worst = max(worst, abs(a - b))
    for k, b in str_.params.items():
        a = stf.params[k].float()
        b = b.float()
        err = (a - b).abs().max().item()
        if not err <= tol + tol * b.abs().max().item():
            raise AssertionError(f"l1 {label}: {k} differs by {err:.3e}")
        worst = max(worst, err)
    return worst
