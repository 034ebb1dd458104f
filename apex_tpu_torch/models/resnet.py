"""ResNet (v1.5), channels last, over the port's fused BN(+add)(+ReLU).

Port of ``apex_tpu/models/resnet.py``: NHWC activations, bottleneck
blocks with the stride on the 3x3 conv, every BN a
:class:`apex_tpu_torch.ops.bn_act.FusedBNAct` unit (the JAX package's
``fused=True`` default) with the residual add and ReLU of a block's join
fused into its last unit.

Submodule and parameter names follow the flax auto-naming (``stem_conv``,
``_BN_0.FusedBNAct_0.scale``, ``BottleneckBlock_3.Conv_2.weight``, ...;
running statistics are the buffers ``....FusedBNAct_0.mean``/``var``,
named as the flax ``batch_stats`` leaves), so
:func:`apex_tpu_torch.convert.resnet_variables_from_jax` maps one tree onto
the other name for name. Conv weights are (O, I, kh, kw) in
``channels_last`` memory (the flax kernel is (kh, kw, I, O)). Convolution,
max-pool, the global mean and the final Dense are PyTorch (cuDNN, cuBLAS),
as they are XLA's in the JAX package. The stem is the plain 7x7/2 conv:
the JAX package's default 2x2 space-to-depth form computes the same
function in a shape that suits the TPU's matrix unit.

In training ``ResNet.forward(x)`` returns ``(logits, new_batch_stats)``;
called through ``torch.func.functional_call`` with the params and the
batch statistics, it is the counterpart of flax's
``model.apply(..., mutable=["batch_stats"])``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from apex_tpu_torch.models.layers import Conv, lecun_normal_
from apex_tpu_torch.models.transformer import Dense
from apex_tpu_torch.ops.bn_act import FusedBNAct


class _BN(nn.Module):
    """A BN unit with optional fused residual add and ReLU: the JAX
    package's ``_BN`` on its default ``fused=True`` path."""

    def __init__(self, features: int, axis_name=None, momentum=0.9,
                 epsilon=1e-5, init_scale=1.0, dtype=None, relu=False,
                 fused=True, device="cuda"):
        super().__init__()
        if not fused:
            raise NotImplementedError(
                "the unfused BN path (flax BatchNorm / SyncBatchNorm) is not "
                "ported yet (ROADMAP.md queue A item 7)")
        self.FusedBNAct_0 = FusedBNAct(
            features, relu=relu, momentum=momentum, epsilon=epsilon,
            axis_name=axis_name, init_scale=init_scale, dtype=dtype,
            device=device)

    def forward(self, x, residual=None, train=True, stats=None):
        return self.FusedBNAct_0(x, residual, train=train, stats=stats)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, features: int, strides=(1, 1),
                 bn_axis_name=None, dtype=None, fused_bn=True,
                 device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        bn = dict(axis_name=bn_axis_name, fused=fused_bn, **kw)
        out = features * 4
        # creation order is the flax auto-naming: Conv_3 is the projection,
        # _BN_2 its BN, and the join BN the last _BN
        self.Conv_0 = Conv(in_features, features, (1, 1), **kw)
        self._BN_0 = _BN(features, relu=True, **bn)
        self.Conv_1 = Conv(features, features, (3, 3), strides, **kw)
        self._BN_1 = _BN(features, relu=True, **bn)
        self.Conv_2 = Conv(features, out, (1, 1), **kw)
        self.proj = in_features != out or tuple(strides) != (1, 1)
        if self.proj:
            self.Conv_3 = Conv(in_features, out, (1, 1), strides, **kw)
            self._BN_2 = _BN(out, **bn)
        self.join = f"_BN_{3 if self.proj else 2}"
        self.add_module(self.join, _BN(out, init_scale=0.0, relu=True, **bn))

    def forward(self, x, train=True, stats=None):
        y = self._BN_0(self.Conv_0(x), train=train, stats=stats)
        y = self._BN_1(self.Conv_1(y), train=train, stats=stats)
        y = self.Conv_2(y)
        residual = x
        if self.proj:
            residual = self._BN_2(self.Conv_3(x), train=train, stats=stats)
        return getattr(self, self.join)(y, residual, train=train,
                                        stats=stats)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, features: int, strides=(1, 1),
                 bn_axis_name=None, dtype=None, fused_bn=True,
                 device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        bn = dict(axis_name=bn_axis_name, fused=fused_bn, **kw)
        self.Conv_0 = Conv(in_features, features, (3, 3), strides, **kw)
        self._BN_0 = _BN(features, relu=True, **bn)
        self.Conv_1 = Conv(features, features, (3, 3), **kw)
        self.proj = in_features != features or tuple(strides) != (1, 1)
        if self.proj:
            self.Conv_2 = Conv(in_features, features, (1, 1), strides, **kw)
            self._BN_1 = _BN(features, **bn)
        self.join = f"_BN_{2 if self.proj else 1}"
        self.add_module(self.join,
                        _BN(features, init_scale=0.0, relu=True, **bn))

    def forward(self, x, train=True, stats=None):
        y = self._BN_0(self.Conv_0(x), train=train, stats=stats)
        y = self.Conv_1(y)
        residual = x
        if self.proj:
            residual = self._BN_1(self.Conv_2(x), train=train, stats=stats)
        return getattr(self, self.join)(y, residual, train=train,
                                        stats=stats)


class ResNet(nn.Module):
    """NHWC ResNet; input (N, H, W, 3). ``dtype`` is the activation and
    compute dtype (``policy.compute_dtype`` for mixed precision); params
    are f32 and cast per op, as in the JAX package."""

    def __init__(self, stage_sizes: Sequence[int], block=BottleneckBlock,
                 num_classes: int = 1000, width: int = 64,
                 bn_axis_name=None, dtype: Optional[torch.dtype] = None,
                 fused_bn: bool = True, device="cuda", seed: int = 0):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        kw = dict(dtype=dtype, device=device)
        self.stem_conv = Conv(3, width, (7, 7), (2, 2),
                              padding=((3, 3), (3, 3)), **kw)
        self._BN_0 = _BN(width, bn_axis_name, relu=True, fused=fused_bn,
                         **kw)
        self.blocks = []
        features, i = width, 0
        for s, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = (2, 2) if s > 0 and j == 0 else (1, 1)
                name = f"{block.__name__}_{i}"
                self.add_module(name, block(
                    features, width * 2 ** s, strides, bn_axis_name,
                    fused_bn=fused_bn, **kw))
                self.blocks.append(name)
                features, i = width * 2 ** s * block.expansion, i + 1
        self.Dense_0 = Dense(features, num_classes, **kw)
        if torch.device(device).type != "meta":
            self.reset_parameters(torch.Generator(device).manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every weight from ``generator``: flax's lecun-normal (a
        normal truncated at two standard deviations, scaled to variance
        1/fan_in) for conv and Dense kernels, zero Dense bias; BN scale
        ``init_scale`` (0 for a block's join), bias 0, running mean 0 and
        var 1."""
        for mod in self.modules():
            if isinstance(mod, (Conv, Dense)):
                lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
                if isinstance(mod, Dense):
                    mod.bias.zero_()
            elif isinstance(mod, FusedBNAct):
                mod.scale.fill_(mod.init_scale)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)

    def forward(self, x, train: bool = True):
        stats = {} if train else None
        if self.dtype is not None:
            x = x.to(self.dtype)
        y = self._BN_0(self.stem_conv(x), train=train, stats=stats)
        y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2,
                         padding=1).permute(0, 2, 3, 1)
        for name in self.blocks:
            y = getattr(self, name)(y, train=train, stats=stats)
        logits = self.Dense_0(y.mean(dim=(1, 2)))
        if not train:
            return logits
        new = {}
        for name, mod in self.named_modules():
            if mod in stats:
                new[f"{name}.mean"], new[f"{name}.var"] = stats[mod]
        return logits, new


def ResNet18(**kw):
    return ResNet(stage_sizes=[2, 2, 2, 2], block=BasicBlock, **kw)


def ResNet50(**kw):
    return ResNet(stage_sizes=[3, 4, 6, 3], block=BottleneckBlock, **kw)


def ResNet101(**kw):
    return ResNet(stage_sizes=[3, 4, 23, 3], block=BottleneckBlock, **kw)


#: forward multiply-adds per 224x224 image, times 2 (the torchvision count)
RESNET50_FLOPS_PER_IMAGE = 2 * 4.09e9
