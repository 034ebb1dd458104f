"""The flax layers the port's conv models share, over NHWC activations.

Port of the flax modules the JAX package's ResNet and DCGAN call:

- :class:`Conv`: ``nn.Conv(features, kernel_size, strides, padding,
  use_bias=False)``; its weight is the flax kernel (kh, kw, I, O) as
  (O, I, kh, kw).
- :class:`ConvTranspose`: ``nn.ConvTranspose`` with flax's default
  ``transpose_kernel=False``, which dilates the input and convolves it
  with the kernel as it is, *not* flipped. ``F.conv_transpose2d`` is the
  gradient of a convolution and so flips the kernel; the port's weight is
  therefore the flax kernel flipped in both spatial dims, as (I, O, kh,
  kw).
- :class:`BatchNorm`: ``nn.BatchNorm`` with flax's defaults, which are not
  ``F.batch_norm``'s: the running statistics move by ``momentum`` 0.99 of
  their old value, the batch variance is E[x²] − E[x]² clipped at 0
  (``use_fast_variance``), and the running variance takes that biased
  batch variance.

Weights are f32 ``Parameter``s, conv weights in ``channels_last`` memory.
Under an enabled :func:`apex_tpu_torch.amp.auto_cast` each module first
casts its input to the dtype the tables give its class (the convs are
HALF modules, BatchNorm a FLOAT one, as flax's are under the JAX
package's interceptor). It then computes in its explicit ``dtype`` if
given, else in that ``auto_cast`` dtype, else in the promoted dtype of
its input and params, as flax's ``promote_dtype`` does.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from apex_tpu_torch.amp.interceptor import module_cast_dtype


def cast_input(module, x):
    """``x`` in the dtype an enabled ``auto_cast`` gives ``module``'s class
    (the half dtype for HALF modules, f32 for FLOAT ones), else as it is.
    As the JAX package's interceptor, this cast comes first, whatever
    ``module.dtype``: an explicit dtype then promotes the cast input."""
    dt = module_cast_dtype(module)
    return x if dt is None else x.to(dt)


def _compute_dtype(module, *tensors):
    """``module.dtype`` if set, else its ``auto_cast`` dtype, else the
    promoted dtype of ``tensors``."""
    dt = module.dtype or module_cast_dtype(module)
    if dt is not None:
        return dt
    out = tensors[0].dtype
    for t in tensors[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


def _same_pads(size: int, k: int, s: int):
    """(low, high) padding of XLA's "SAME" for one spatial dim."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv_transpose_pads(k: int, s: int, padding: str):
    """(low, high) padding of the dilated input, as ``jax.lax``'s
    ``_conv_transpose_padding`` gives it for "SAME" or "VALID"."""
    if padding == "SAME":
        pad_len = k + s - 2
        lo = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        lo = k - 1
    else:
        raise ValueError(f"ConvTranspose padding must be 'SAME' or 'VALID', "
                         f"got {padding!r}")
    return lo, pad_len - lo


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's lecun-normal: a normal truncated at two standard deviations,
    scaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class Conv(nn.Module):
    """``nn.Conv(features, kernel_size, strides, padding="SAME",
    use_bias=False)`` over NHWC input. "SAME" pads a stride-2 3x3 conv by
    (0, 1), which ``F.conv2d`` cannot express; such an input is padded
    explicitly first."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides=(1, 1), padding=None, dtype=None, device="cuda"):
        super().__init__()
        self.kernel_size, self.strides = tuple(kernel_size), tuple(strides)
        self.padding = padding       # explicit ((lo, hi), (lo, hi)) or SAME
        self.dtype = dtype
        self.fan_in = in_features * math.prod(self.kernel_size)
        self.weight = nn.Parameter(torch.empty(
            features, in_features, *self.kernel_size, device=device
        ).contiguous(memory_format=torch.channels_last))

    def forward(self, x):
        x = cast_input(self, x)
        dt = _compute_dtype(self, x, self.weight)
        w = self.weight.to(dt).contiguous(memory_format=torch.channels_last)
        pads = self.padding or [_same_pads(n, k, s) for n, k, s in zip(
            x.shape[1:3], self.kernel_size, self.strides)]
        x = x.to(dt)
        if any(lo != hi for lo, hi in pads):
            (ht, hb), (wl, wr) = pads
            x = F.pad(x, (0, 0, wl, wr, ht, hb))
            pads = [(0, 0), (0, 0)]
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.strides,
                     padding=tuple(lo for lo, _ in pads))
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """``nn.ConvTranspose(features, kernel_size, strides, padding,
    use_bias=False)`` over NHWC input, flax's unflipped kernel held flipped
    as an (I, O, kh, kw) weight. Padding "SAME" or "VALID" becomes
    ``F.conv_transpose2d``'s ``padding`` and ``output_padding``."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides=(1, 1), padding="SAME", dtype=None, device="cuda"):
        super().__init__()
        self.kernel_size, self.strides = tuple(kernel_size), tuple(strides)
        self.dtype = dtype
        self.fan_in = in_features * math.prod(self.kernel_size)
        pads = [_conv_transpose_pads(k, s, padding)
                for k, s in zip(self.kernel_size, self.strides)]
        self.pad = tuple(k - 1 - lo for k, (lo, _) in
                         zip(self.kernel_size, pads))
        self.output_pad = tuple(hi - lo for lo, hi in pads)
        if min(self.pad) < 0 or any(
                not 0 <= op < s for op, s in zip(self.output_pad,
                                                 self.strides)):
            raise ValueError(f"padding {padding!r} at kernel "
                             f"{self.kernel_size}, strides {self.strides} "
                             f"has no conv_transpose2d form")
        self.weight = nn.Parameter(torch.empty(
            in_features, features, *self.kernel_size, device=device
        ).contiguous(memory_format=torch.channels_last))

    def forward(self, x):
        x = cast_input(self, x)
        dt = _compute_dtype(self, x, self.weight)
        w = self.weight.to(dt).contiguous(memory_format=torch.channels_last)
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2), w,
                               stride=self.strides, padding=self.pad,
                               output_padding=self.output_pad)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """``nn.BatchNorm(use_running_average=not train)`` with flax's
    defaults over the channels (last) axis: params ``scale`` and ``bias``,
    running statistics the buffers ``mean`` and ``var``.

    The statistics and the normalisation are computed in f32 (at least)
    from the input as it arrives (after ``auto_cast``'s f32 cast, never
    cast to an explicit ``dtype``), as flax computes them, as ``(x −
    mean)·(rsqrt(var + eps)·scale) + bias``; the output takes the compute
    dtype. In training the new
    running statistics go into ``stats[self]`` when a dict is given (the
    model collects them); the module's own buffers are not touched."""

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5, dtype=None, device="cuda"):
        super().__init__()
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x, train: bool = True, stats=None):
        x = cast_input(self, x)
        out_dtype = _compute_dtype(self, x, self.scale, self.bias)
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            axes = tuple(range(x.dim() - 1))
            mean = x32.mean(dim=axes)
            var = torch.clamp_min((x32 * x32).mean(dim=axes) - mean * mean,
                                  0.0)
            if stats is not None:
                mom = self.momentum
                stats[self] = tuple(
                    mom * ra + (1.0 - mom) * b.detach()
                    for ra, b in ((self.mean, mean), (self.var, var)))
        else:
            mean, var = self.mean, self.var
        y = (x32 - mean) * (torch.rsqrt(var + self.epsilon) * self.scale)
        return (y + self.bias).to(out_dtype)
