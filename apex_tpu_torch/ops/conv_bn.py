"""Conv → BN (+residual) (+ReLU) as one autograd unit with a
distributed-dgrad backward.

Port of ``apex_tpu/ops/conv_bn.py``. BN's input gradient is linear in three
per-channel-scaled fields,

    dx = A⊙g + B⊙x + C⊙1,   A = γi,  B = −γi²k₂,  C = A·(ik₂μ − k₁)

(g the masked upstream gradient, i = invstd, k₁ = Σg/n, k₂ = Σg·x̂/n), so
the producing convolution's input and weight gradients distribute over the
three terms and dx itself is never formed:

    da = dgrad(g, A⊙W) + dgrad(x, B⊙W) + dgrad-const
    dW = A⊙wgrad(a, g) + B⊙wgrad(a, x) + C⊙wgrad(a, 1)

The per-channel scales fold into the weights along their output channels;
for a unit without a residual the constant term folds into the one
gradient operand that is formed, g′ = mask⊙dz + (ik₂μ − k₁); for a
residual join dr = mask⊙dz is an output anyway and feeds the convolutions
as it is, and the constant term is a dgrad of an N = 1 ones field
broadcast over the batch and a wgrad of the batch-summed input.

The two channel sums are row 12's kernel in its three modes ("relu" for a
ReLU unit without residual, "addrelu" for a ReLU join, which writes dr,
"plain" otherwise): a CUDA tensor launches ``bn_act.bn_sums_kernel``, read
from the ``bn_act`` module when the backward runs, and a CPU tensor takes
``bn_act.bn_sums_plain``. Convolutions are PyTorch (cuDNN), over NHWC
activations viewed as channels-last NCHW, as the JAX package leaves them to
XLA; the transposes are ``aten.convolution_backward``. The forward is the
port's BN forward (``bn_act._fwd_common``) on the conv output.

With ``axis_name`` (and ``axis_index_groups``) the statistics are a group's
across ranks, as the fused BN unit's: the forward combines the moments
over the group and the backward all-reduces the channel sums before the
per-channel terms are formed, as the JAX package's ``psum`` does. The unit
is in neither of ``auto_cast``'s module tables, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from apex_tpu_torch.ops import bn_act
from apex_tpu_torch.parallel.mesh import normalize_groups


class _ConvCfg(NamedTuple):
    """Static conv + BN configuration of one unit."""
    strides: Tuple[int, int]
    padding: Any            # "SAME" | "VALID" | ((lo, hi), (lo, hi))
    relu: bool
    eps: float
    axis_name: Optional[str] = None
    groups: Optional[tuple] = None

    def bn(self) -> bn_act._Cfg:
        return bn_act._Cfg(relu=self.relu, eps=self.eps,
                           axis_name=self.axis_name, groups=self.groups)


def make_conv_cfg(*, strides=(1, 1), padding="SAME", relu: bool,
                  eps: float = 1e-5, axis_name: Optional[str] = None,
                  axis_index_groups=None) -> _ConvCfg:
    if not isinstance(padding, str):
        padding = tuple(tuple(int(p) for p in pair) for pair in padding)
    elif padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be 'SAME', 'VALID' or explicit "
                         f"pairs, got {padding!r}")
    return _ConvCfg(strides=tuple(int(s) for s in strides), padding=padding,
                    relu=bool(relu), eps=float(eps), axis_name=axis_name,
                    groups=normalize_groups(axis_index_groups))


def _geometry(a_shape, w, cfg: _ConvCfg):
    """(explicit pad of a (F.pad's order, or None), conv2d's symmetric
    padding): an uneven "SAME" pad, which conv2d cannot express, is applied
    to the input first, as ``models.layers.Conv`` does."""
    # imported here: models.resnet imports this module
    from apex_tpu_torch.models.layers import _same_pads

    if cfg.padding == "VALID":
        return None, (0, 0)
    pads = (cfg.padding if cfg.padding != "SAME" else
            [_same_pads(n, k, s) for n, k, s in
             zip(a_shape[1:3], w.shape[2:], cfg.strides)])
    if all(lo == hi for lo, hi in pads):
        return None, tuple(lo for lo, _ in pads)
    (ht, hb), (wl, wr) = pads
    return (0, 0, wl, wr, ht, hb), (0, 0)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _conv(a, w, cfg: _ConvCfg):
    """NHWC ``a`` (N, H, W, I) with the (O, I, kh, kw) weight: NHWC out."""
    pre, pad = _geometry(a.shape, w, cfg)
    if pre is not None:
        a = F.pad(a, pre)
    return _nhwc(F.conv2d(_nchw(a), w, stride=cfg.strides, padding=pad))


def _conv_t(g, a, w, cfg: _ConvCfg, which):
    """The transposes of ``_conv`` at (a, w) applied to the NHWC output
    gradient ``g``: ``which`` "a" gives da (a's NHWC shape), "w" dW."""
    pre, pad = _geometry(a.shape, w, cfg)
    ap = a if pre is None else F.pad(a, pre)
    da, dw, _ = torch.ops.aten.convolution_backward(
        _nchw(g), _nchw(ap), w, None, cfg.strides, pad, (1, 1), False,
        (0, 0), 1, (which == "a", which == "w", False))
    if which == "w":
        return dw
    da = _nhwc(da)
    if pre is not None:
        _, _, wl, _, ht, _ = pre
        da = da[:, ht:ht + a.shape[1], wl:wl + a.shape[2]]
    return da


def _fold(w, s):
    """Scale the weight along its output channels (dim 0)."""
    return (w.float() * s.view(-1, 1, 1, 1)).to(w.dtype)


def _channel_terms(sums, scale, mean, invstd, count):
    """A, B and c′ = C/A (γ-free, so a zero γ is safe) from the sums
    (Σg, Σg·x̂), in the JAX package's order of operations."""
    k1, k2 = sums[0] / count, sums[1] / count
    gam = scale.float()
    a_ = gam * invstd
    b_ = -gam * invstd * invstd * k2
    cprime = invstd * k2 * mean - k1
    return a_, b_, cprime


def _sums(x, dz, z, scale, bias, mean, invstd, mode, r_dtype=None):
    """Row 12's channel sums (and dr at "addrelu") over the (M, C) rows."""
    x2, g2 = bn_act._rows(x), bn_act._grad_rows(dz)
    fn = bn_act.bn_sums_kernel if x2.is_cuda else bn_act.bn_sums_plain
    return fn(x2, g2, None if z is None else bn_act._rows(z), scale, bias,
              mean, invstd, mode, r_dtype)


def _distributed_grads(cfg, a, w, x, gp, a_, b_, c_=None):
    """da and dW by term-distributed conv transposes. ``gp`` is the formed
    gradient operand (c′ folded in unless ``c_``, the constant term, is
    given: then it is handled batch-independently)."""
    da = (_conv_t(gp.to(a.dtype), a, _fold(w, a_), cfg, "a")
          + _conv_t(x, a, _fold(w, b_), cfg, "a"))
    dw = (a_.view(-1, 1, 1, 1) * _conv_t(gp.to(x.dtype), a, w, cfg,
                                        "w").float()
          + b_.view(-1, 1, 1, 1) * _conv_t(x, a, w, cfg, "w").float())
    if c_ is not None:
        ones1 = torch.ones((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device)
        da = da + _conv_t(ones1, a[:1], _fold(w, c_), cfg, "a")
        asum = a.float().sum(dim=0, keepdim=True).to(a.dtype)
        dw = dw + c_.view(-1, 1, 1, 1) * _conv_t(ones1, asum, w, cfg,
                                                 "w").float()
    return da, dw


class _ConvBNActFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, scale, bias, cfg):
        x = _conv(a, w, cfg)
        group = bn_act._group(cfg.bn())
        z, mean, var, count, invstd = bn_act._fwd_common(x, None, scale,
                                                         bias, cfg.bn(),
                                                         group)
        bn_act.save_stats(ctx, cfg, group, count, a, w, x, scale, bias, mean,
                          invstd)
        return bn_act.unit_outputs(ctx, group, z, mean, var, count)

    @staticmethod
    def backward(ctx, dz, *_):
        (a, w, x, scale, bias, mean, invstd), count = bn_act.saved_stats(ctx)
        cfg = ctx.cfg
        mode = "relu" if cfg.relu else "plain"
        sums, _ = _sums(x, dz, None, scale, bias, mean, invstd, mode)
        bn_act.group_sums(sums, ctx.group)
        a_, b_, cprime = _channel_terms(sums, scale, mean, invstd, count)
        g32 = dz.float()
        if cfg.relu:
            g32 = torch.where(bn_act._relu_mask(
                bn_act._xhat(x, mean, invstd), scale, bias), g32, 0.0)
        # g′ = mask⊙dz + c′: the one formed operand
        da, dw = _distributed_grads(cfg, a, w, x, g32 + cprime, a_, b_)
        return (da, dw.to(w.dtype), sums[1].to(scale.dtype),
                sums[0].to(bias.dtype), None)


class _ConvBNAddActFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, r, scale, bias, cfg):
        x = _conv(a, w, cfg)
        group = bn_act._group(cfg.bn())
        z, mean, var, count, invstd = bn_act._fwd_common(x, r, scale, bias,
                                                         cfg.bn(), group)
        bn_act.save_stats(ctx, cfg, group, count, a, w, x, scale, bias, mean,
                          invstd, z if cfg.relu else None)
        ctx.r_dtype = r.dtype
        return bn_act.unit_outputs(ctx, group, z, mean, var, count)

    @staticmethod
    def backward(ctx, dz, *_):
        (a, w, x, scale, bias, mean, invstd, z), count = \
            bn_act.saved_stats(ctx)
        cfg = ctx.cfg
        if cfg.relu:
            sums, dr = _sums(x, dz, z, scale, bias, mean, invstd, "addrelu",
                             ctx.r_dtype)
            dr = dr.view(x.shape)
        else:
            dr = dz.to(ctx.r_dtype)
            sums, _ = _sums(x, dr, None, scale, bias, mean, invstd, "plain")
        bn_act.group_sums(sums, ctx.group)
        a_, b_, cprime = _channel_terms(sums, scale, mean, invstd, count)
        da, dw = _distributed_grads(cfg, a, w, x, dr, a_, b_, a_ * cprime)
        return (da, dw.to(w.dtype), dr, sums[1].to(scale.dtype),
                sums[0].to(bias.dtype), None)


def conv_bn_act_train(a, w, scale, bias, cfg: _ConvCfg):
    """Training-mode ``relu?(bn(conv(a, w)))`` over NHWC ``a`` and an (O, I,
    kh, kw) ``w``, with the distributed-dgrad backward. Returns ``(z, mean,
    biased_var, count)`` like :func:`bn_act.bn_act_train`."""
    out = _ConvBNActFn.apply(a, w, scale, bias, cfg)
    return bn_act.unit_result(out, out[0])


def conv_bn_add_act_train(a, w, r, scale, bias, cfg: _ConvCfg):
    """Training-mode ``relu?(bn(conv(a, w)) + r)``, the residual-join unit
    with the distributed backward."""
    out = _ConvBNAddActFn.apply(a, w, r, scale, bias, cfg)
    return bn_act.unit_result(out, out[0])


class ConvBNAct(nn.Module):
    """Conv (no bias) → BN (+residual) (+ReLU) as one unit with the
    distributed-dgrad backward: the JAX package's ``ConvBNAct``.

    Parameters ``weight`` (the flax ``kernel`` (kh, kw, I, O) as (O, I, kh,
    kw), channels-last), ``scale`` and ``bias``, buffers ``mean`` and
    ``var``, named as the flax leaves. Running statistics and ``stats`` as
    :class:`bn_act.FusedBNAct`. ``dtype`` casts the input and residual; the
    weight computes in the input's dtype."""

    def __init__(self, in_features: int, features: int, kernel_size=(1, 1),
                 strides=(1, 1), relu: bool = True, momentum: float = 0.9,
                 epsilon: float = 1e-5, axis_name=None,
                 axis_index_groups=None, init_scale: float = 1.0,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        self.cfg = make_conv_cfg(strides=strides, relu=relu, eps=epsilon,
                                 axis_name=axis_name,
                                 axis_index_groups=axis_index_groups)
        self.momentum, self.init_scale = momentum, init_scale
        self.dtype = dtype
        c = features
        self.weight = nn.Parameter(torch.empty(
            c, in_features, *kernel_size, device=device
        ).contiguous(memory_format=torch.channels_last))
        self.scale = nn.Parameter(torch.full((c,), float(init_scale),
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    def forward(self, a, residual=None, train: bool = True, stats=None):
        if self.dtype is not None:
            a = a.to(self.dtype)
            if residual is not None:
                residual = residual.to(self.dtype)
        w = self.weight.to(a.dtype).contiguous(
            memory_format=torch.channels_last)
        if train and stats is None:
            raise ValueError("training mode returns the new running "
                             "statistics: pass a stats dict")
        if not train:
            x = _conv(a, w, self.cfg)
            inv = torch.rsqrt(self.var + self.cfg.eps)
            r2 = None if residual is None else bn_act._rows(residual)
            z = bn_act._apply(bn_act._rows(x), r2, self.scale, self.bias,
                              self.mean, inv, self.cfg.relu, x.dtype)
            return z.view(x.shape)
        if residual is None:
            z, mean, var, count = conv_bn_act_train(a, w, self.scale,
                                                    self.bias, self.cfg)
        else:
            z, mean, var, count = conv_bn_add_act_train(
                a, w, residual, self.scale, self.bias, self.cfg)
        stats[self] = bn_act.running_stats(self, mean, var, count)
        return z
