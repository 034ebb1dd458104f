"""NHWC BatchNorm with statistics across a group of ranks: groupbn.

Port of ``apex_tpu/ops/group_bn.py``, ``apex.contrib.groupbn
.BatchNorm2d_NHWC``'s surface: a ``bn_group``-way exchange of the
statistics, with a fused residual add and ReLU. It is
:class:`apex_tpu_torch.parallel.SyncBatchNorm` over stats sub-groups of
``bn_group`` adjacent ranks of ``axis_name`` (``dist.new_group``
sub-groups of the bound mesh), channels last.
"""

from __future__ import annotations

from typing import Optional

from apex_tpu_torch.parallel.sync_batchnorm import (SyncBatchNorm,
                                                    syncbn_stats_groups)


def bn_group_spec(world_size: int, bn_group: int):
    """``axis_index_groups`` of a ``bn_group``-way statistics exchange."""
    return syncbn_stats_groups(world_size, bn_group)


def BatchNorm2d_NHWC(num_features: int, *, fuse_relu: bool = False,
                     bn_group: int = 1, world_size: Optional[int] = None,
                     axis_name: Optional[str] = None,
                     momentum: float = 0.1, epsilon: float = 1e-5,
                     device="cuda") -> SyncBatchNorm:
    """``BatchNorm2d_NHWC(planes, fuse_relu=..., bn_group=...)``: with
    ``bn_group > 1``, ``axis_name`` and ``world_size`` are required and the
    statistics combine across each group of ``bn_group`` adjacent ranks of
    that axis. Call ``bn(x, z)`` for the add+ReLU variant. ``momentum`` is
    the torch convention, as the reference kernel applies it."""
    groups = None
    if bn_group > 1:
        if axis_name is None or world_size is None:
            raise ValueError("bn_group > 1 needs axis_name and world_size")
        groups = bn_group_spec(world_size, bn_group)
    return SyncBatchNorm(
        num_features, epsilon=epsilon, momentum=momentum,
        axis_name=axis_name if bn_group > 1 else None,
        axis_index_groups=groups, channel_axis=-1, fuse_relu=fuse_relu,
        device=device)
