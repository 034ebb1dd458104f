"""ResNet (v1.5), channels last, over the port's fused BN(+add)(+ReLU).

Port of ``apex_tpu/models/resnet.py``: NHWC activations, bottleneck
blocks with the stride on the 3x3 conv, every BN a
:class:`apex_tpu_torch.ops.bn_act.FusedBNAct` unit (the JAX package's
``fused=True`` default) with the residual add and ReLU of a block's join
fused into its last unit. ``fused_bn=False`` takes the JAX package's
autodiff oracle instead: a ``models.layers.BatchNorm`` (flax's
``nn.BatchNorm``), or with ``bn_axis_name`` a
``parallel.SyncBatchNorm`` (``SyncBatchNorm_0``), with the add and ReLU
after it. ``bn_axis_name`` gives every BN unit statistics across the
ranks of that axis of the bound mesh (``parallel.use_mesh``). ``dx_distribute="join"``
makes each bottleneck block's join, and ``"all"`` every conv+BN pair of a
block, one :class:`apex_tpu_torch.ops.conv_bn.ConvBNAct` unit (the
distributed-dgrad backward), with the JAX package's module names: under
"join" the projection is ``Conv_2``/``_BN_2`` and the join
``ConvBNAct_0``; under "all" the units are ``ConvBNAct_0`` to ``_3``.

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

from apex_tpu_torch.models.layers import BatchNorm, Conv, lecun_normal_
from apex_tpu_torch.models.transformer import Dense
from apex_tpu_torch.ops.bn_act import FusedBNAct
from apex_tpu_torch.ops.conv_bn import ConvBNAct
from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

class _BN(nn.Module):
    """A BN unit with optional residual add and ReLU: the JAX package's
    ``_BN``. ``fused=True`` is one ``FusedBNAct_0`` unit; ``fused=False``
    casts x and the residual to ``dtype``, then runs ``BatchNorm_0``
    (flax's ``nn.BatchNorm`` with this unit's momentum, epsilon and
    ``init_scale``), or with ``axis_name`` ``SyncBatchNorm_0`` (momentum
    ``1 − momentum`` in the torch sense, ``scale_init=init_scale``), adds
    and applies the ReLU."""

    def __init__(self, features: int, axis_name=None, momentum=0.9,
                 epsilon=1e-5, init_scale=1.0, dtype=None, relu=False,
                 fused=True, device="cuda"):
        super().__init__()
        self.fused, self.relu, self.dtype = fused, relu, dtype
        self.init_scale = init_scale
        if fused:
            self.FusedBNAct_0 = FusedBNAct(
                features, relu=relu, momentum=momentum, epsilon=epsilon,
                axis_name=axis_name, init_scale=init_scale, dtype=dtype,
                device=device)
            return
        if axis_name is not None:
            self.SyncBatchNorm_0 = SyncBatchNorm(
                features, momentum=1 - momentum, epsilon=epsilon,
                axis_name=axis_name, scale_init=init_scale, device=device)
            return
        self.BatchNorm_0 = BatchNorm(features, momentum=momentum,
                                     epsilon=epsilon, dtype=dtype,
                                     device=device)
        with torch.no_grad():
            self.BatchNorm_0.scale.fill_(init_scale)

    def bn_module(self):
        """The unfused unit's ``BatchNorm_0`` or ``SyncBatchNorm_0``."""
        sync = getattr(self, "SyncBatchNorm_0", None)
        return sync if sync is not None else self.BatchNorm_0

    def forward(self, x, residual=None, train=True, stats=None):
        if self.fused:
            return self.FusedBNAct_0(x, residual, train=train, stats=stats)
        if self.dtype is not None:
            x = x.to(self.dtype)
            if residual is not None:
                residual = residual.to(self.dtype)
        y = self.bn_module()(x, train=train, stats=stats)
        if residual is not None:
            y = y + residual
        return torch.relu(y) if self.relu else y


class BottleneckBlock(nn.Module):
    """``dx_distribute``: None, "join" (the join is a ConvBNAct unit) or
    "all" (every conv+BN pair is one)."""
    expansion = 4

    def __init__(self, in_features: int, features: int, strides=(1, 1),
                 bn_axis_name=None, dtype=None, fused_bn=True,
                 device="cuda", dx_distribute=None):
        super().__init__()
        if dx_distribute not in (None, "join", "all"):
            raise ValueError(f"dx_distribute must be None, 'join' or 'all', "
                             f"got {dx_distribute!r}")
        kw = dict(dtype=dtype, device=device)
        bn = dict(axis_name=bn_axis_name, fused=fused_bn, **kw)
        cba = dict(axis_name=bn_axis_name, **kw)
        out = features * 4
        self.dx_distribute = dx_distribute
        self.proj = in_features != out or tuple(strides) != (1, 1)
        # creation order is the flax auto-naming: by default Conv_3 is the
        # projection, _BN_2 its BN, and the join BN the last _BN; the
        # distributed paths name the projection and the join in their order
        if dx_distribute == "all":
            self.ConvBNAct_0 = ConvBNAct(in_features, features, (1, 1),
                                         relu=True, **cba)
            self.ConvBNAct_1 = ConvBNAct(features, features, (3, 3), strides,
                                         relu=True, **cba)
            if self.proj:
                self.ConvBNAct_2 = ConvBNAct(in_features, out, (1, 1),
                                             strides, relu=False, **cba)
            self.join = f"ConvBNAct_{3 if self.proj else 2}"
            self.add_module(self.join, ConvBNAct(
                features, out, (1, 1), relu=True, init_scale=0.0, **cba))
            return
        self.Conv_0 = Conv(in_features, features, (1, 1), **kw)
        self._BN_0 = _BN(features, relu=True, **bn)
        self.Conv_1 = Conv(features, features, (3, 3), strides, **kw)
        self._BN_1 = _BN(features, relu=True, **bn)
        if dx_distribute == "join":
            if self.proj:
                self.Conv_2 = Conv(in_features, out, (1, 1), strides, **kw)
                self._BN_2 = _BN(out, **bn)
            self.join = "ConvBNAct_0"
            self.ConvBNAct_0 = ConvBNAct(features, out, (1, 1), relu=True,
                                         init_scale=0.0, **cba)
            return
        self.Conv_2 = Conv(features, out, (1, 1), **kw)
        if self.proj:
            self.Conv_3 = Conv(in_features, out, (1, 1), strides, **kw)
            self._BN_2 = _BN(out, **bn)
        self.join = f"_BN_{3 if self.proj else 2}"
        self.add_module(self.join, _BN(out, init_scale=0.0, relu=True, **bn))

    def forward(self, x, train=True, stats=None):
        st = dict(train=train, stats=stats)
        if self.dx_distribute == "all":
            y = self.ConvBNAct_1(self.ConvBNAct_0(x, **st), **st)
            residual = self.ConvBNAct_2(x, **st) if self.proj else x
            return getattr(self, self.join)(y, residual, **st)
        y = self._BN_0(self.Conv_0(x), **st)
        y = self._BN_1(self.Conv_1(y), **st)
        if self.dx_distribute == "join":
            residual = self._BN_2(self.Conv_2(x), **st) if self.proj else x
            return self.ConvBNAct_0(y, residual, **st)
        y = self.Conv_2(y)
        residual = x
        if self.proj:
            residual = self._BN_2(self.Conv_3(x), **st)
        return getattr(self, self.join)(y, residual, **st)


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
    are f32 and cast per op, as in the JAX package. ``fused_bn`` and
    ``dx_distribute`` (bottleneck blocks only) as in the JAX package."""

    def __init__(self, stage_sizes: Sequence[int], block=BottleneckBlock,
                 num_classes: int = 1000, width: int = 64,
                 bn_axis_name=None, dtype: Optional[torch.dtype] = None,
                 fused_bn: bool = True, device="cuda", seed: int = 0,
                 dx_distribute: Optional[str] = None):
        super().__init__()
        block_kw = {}
        if dx_distribute is not None:
            if block is not BottleneckBlock:
                raise ValueError(f"dx_distribute is only implemented for "
                                 f"BottleneckBlock, got {block!r}")
            block_kw["dx_distribute"] = dx_distribute
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
                    fused_bn=fused_bn, **kw, **block_kw))
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
            if isinstance(mod, (Conv, Dense, ConvBNAct)):
                lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
                if isinstance(mod, Dense):
                    mod.bias.zero_()
            bn = (mod.bn_module() if isinstance(mod, _BN) and not mod.fused
                  else mod if isinstance(mod, (FusedBNAct, ConvBNAct))
                  else None)
            if bn is not None:
                bn.scale.fill_(mod.init_scale)
                bn.bias.zero_()
                bn.mean.zero_()
                bn.var.fill_(1.0)

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
