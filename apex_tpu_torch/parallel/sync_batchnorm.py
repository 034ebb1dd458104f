"""SyncBatchNorm: batch normalisation with statistics across ranks.

Port of ``apex_tpu/parallel/sync_batchnorm.py``: per-rank moments in f32
(two-pass, centred), one gather of (mean, biased var, count) over the
stats group, a count-weighted parallel-Welford combine (exact for unequal
per-rank batches), then the normalise with an optional residual add and
ReLU. The triple of a rank is packed into one (2C + 1) f32 buffer, so the
gather is one ``all_gather_into_tensor`` (``collectives.gather_rows``);
gathering is exact, so the combine sees the numbers JAX's three gathers
give it. The backward is autograd through that gather, whose transpose
sums each rank's row of the gradient over the group, as the JAX package's
autodiff of ``all_gather`` does; the γ and β gradients are each rank's own.

Stats sub-groups (``axis_index_groups``, from :func:`syncbn_stats_groups`)
resolve to ``dist.new_group`` sub-groups of the bound mesh
(``mesh.resolve_group``). :func:`convert_sync_batchnorm` makes the port's
``models.layers.BatchNorm`` (flax's ``nn.BatchNorm``) sync inside a
``with`` block, as the JAX package's interceptor retargets flax's.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from apex_tpu_torch.parallel import collectives
from apex_tpu_torch.parallel.mesh import resolve_group

#: the registry scope of every SyncBN collective
SCOPE = "sync_batchnorm"

_CONVERTED = contextvars.ContextVar("apex_tpu_torch_syncbn", default=None)


def syncbn_stats_groups(world_size: int, group_size: int):
    """Partition ``world_size`` ranks into stats groups of ``group_size``:
    ``create_syncbn_process_group``. Returns ``axis_index_groups``."""
    if group_size == 0 or group_size >= world_size:
        return None                               # whole axis
    if group_size == 1:
        # per-rank stats (non-sync BN): None would mean the WHOLE axis
        return [[i] for i in range(world_size)]
    if world_size % group_size:
        raise ValueError(f"world {world_size} % group {group_size} != 0")
    return [list(range(i, i + group_size))
            for i in range(0, world_size, group_size)]


def _bshape(x, reduce_axes):
    return [1 if a in reduce_axes else s for a, s in enumerate(x.shape)]


def _local_moments(x, reduce_axes):
    """Per-channel mean and biased variance in f32, two-pass (centred):
    E[x²] − E[x]² cancels in f32 for large-mean, small-std channels."""
    x32 = x.float()
    mean = x32.mean(dim=reduce_axes)
    var = torch.square(x32 - mean.view(_bshape(x, reduce_axes))).mean(
        dim=reduce_axes)
    return mean, var


def _welford_combine(means, variances, counts):
    """Count-weighted combine of per-rank (mean, biased var, count) along
    a leading rank dim: exact for unequal counts. Returns (mean, var,
    total count), the count a 0-dim tensor."""
    total = counts.sum()
    gmean = (means * counts[:, None]).sum(dim=0) / total
    gvar = ((variances + torch.square(means - gmean[None, :]))
            * counts[:, None]).sum(dim=0) / total
    return gmean, gvar, total


def combine_moments(mean, var, count, group):
    """(mean, var, count) combined over ``group``: one gather of the packed
    (2C + 1) f32 row of each rank, then :func:`_welford_combine`."""
    c = mean.shape[0]
    rows = collectives.gather_rows(
        torch.cat([mean, var, count.view(1)]), group, SCOPE)
    return _welford_combine(rows[:, :c], rows[:, c:2 * c], rows[:, 2 * c])


def _count_tensor(value, like):
    """An f32 0-dim count on ``like``'s device, made without a copy from the
    host (a fill), so no stream waits on it."""
    if isinstance(value, torch.Tensor):
        return value.to(device=like.device, dtype=torch.float32).reshape(())
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def sync_moments(x, *, axis_name: Optional[str], reduce_axes,
                 axis_index_groups=None, valid_count=None):
    """Per-channel (mean, biased var, total count) over the stats group.

    ``valid_count`` handles zero-padded ragged local batches (the unequal
    batch sizes case): the moments divide the sums by it instead of the
    padded element count, so the combine is weighted by true counts. With
    ``axis_name=None`` the moments are this rank's own."""
    reduce_axes = tuple(reduce_axes)
    n_padded = 1
    for a in reduce_axes:
        n_padded *= x.shape[a]
    if valid_count is None:
        mean, var = _local_moments(x, reduce_axes)
        count = _count_tensor(n_padded, x)
    else:
        count = _count_tensor(valid_count, x)
        x32 = x.float()
        mean = x32.sum(dim=reduce_axes) / count
        # centre everywhere, then take out the (n_padded − count) padded
        # zeros, each of which became (−mean)²
        centered_sq = torch.square(
            x32 - mean.view(_bshape(x, reduce_axes))).sum(dim=reduce_axes)
        pad_correction = (n_padded - count) * torch.square(mean)
        var = (centered_sq - pad_correction) / count
    if axis_name is None:
        return mean, var, count
    return combine_moments(mean, var, count,
                           resolve_group(axis_name, axis_index_groups))


def _normalize(x, scale, bias, mean, var, epsilon, channel_axis, z, relu):
    shape = [1] * x.dim()
    shape[channel_axis] = x.shape[channel_axis]
    y = (x.float() - mean.view(shape)) * torch.rsqrt(var + epsilon).view(
        shape)
    if scale is not None:
        y = y * scale.float().view(shape)
    if bias is not None:
        y = y + bias.float().view(shape)
    if z is not None:
        y = y + z.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def sync_batch_norm(x, scale, bias, *, axis_name: Optional[str] = None,
                    axis_index_groups=None, epsilon: float = 1e-5,
                    channel_axis: int = -1, z=None, relu: bool = False,
                    valid_count=None):
    """Training-mode SyncBN, optionally fusing a residual add (``z``) and
    a ReLU. Returns ``(y, mean, biased var, count)``."""
    channel_axis = channel_axis % x.dim()
    reduce_axes = tuple(a for a in range(x.dim()) if a != channel_axis)
    mean, var, count = sync_moments(
        x, axis_name=axis_name, reduce_axes=reduce_axes,
        axis_index_groups=axis_index_groups, valid_count=valid_count)
    y = _normalize(x, scale, bias, mean, var, epsilon, channel_axis, z,
                   relu)
    return y, mean, var, count


class SyncBatchNorm(nn.Module):
    """``apex.parallel.SyncBatchNorm``: BatchNorm whose batch statistics
    reduce over ``axis_name`` (an axis of the bound mesh), optionally over
    stats sub-groups, with a fused residual add and ReLU.

    Parameters ``scale`` (``scale_init``) and ``bias``, buffers ``mean`` and
    ``var``, named as the flax module's. ``momentum`` in the torch sense:
    ``ra = (1 − m)·ra + m·new`` with the unbiased variance. In training,
    ``stats`` (a dict) receives ``stats[self] = (mean, var)``, the new
    running statistics; the buffers are not written. Eval normalises
    with the running statistics, locally."""

    def __init__(self, num_features: int, epsilon: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True, axis_name=None,
                 axis_index_groups: Optional[Sequence[Sequence[int]]] = None,
                 channel_axis: int = -1, fuse_relu: bool = False,
                 scale_init: float = 1.0, device="cuda"):
        super().__init__()
        self.epsilon, self.momentum = epsilon, momentum
        self.track_running_stats = track_running_stats
        self.axis_name, self.axis_index_groups = axis_name, axis_index_groups
        self.channel_axis, self.fuse_relu = channel_axis, fuse_relu
        c = num_features
        self.scale = (nn.Parameter(torch.full((c,), float(scale_init),
                                              device=device))
                      if affine else None)
        self.bias = (nn.Parameter(torch.zeros(c, device=device))
                     if affine else None)
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    def forward(self, x, z=None, train: bool = True, stats=None,
                valid_count=None):
        if not train:
            return _normalize(x, self.scale, self.bias, self.mean, self.var,
                              self.epsilon, self.channel_axis % x.dim(), z,
                              self.fuse_relu)
        y, mean, var, count = sync_batch_norm(
            x, self.scale, self.bias, axis_name=self.axis_name,
            axis_index_groups=self.axis_index_groups, epsilon=self.epsilon,
            channel_axis=self.channel_axis, z=z, relu=self.fuse_relu,
            valid_count=valid_count)
        if self.track_running_stats and stats is not None:
            unbiased = var.detach() * count / torch.clamp_min(count - 1.0,
                                                              1.0)
            m = self.momentum
            stats[self] = ((1 - m) * self.mean + m * mean.detach(),
                           (1 - m) * self.var + m * unbiased)
        return y


@contextlib.contextmanager
def convert_sync_batchnorm(policy_axis_name: str, axis_index_groups=None):
    """Inside the block, every ``models.layers.BatchNorm`` called without
    an axis of its own averages its batch moments over
    ``policy_axis_name`` (and ``axis_index_groups``), as flax's
    ``nn.BatchNorm(axis_name=...)`` does: ``convert_syncbn_model`` without
    module surgery."""
    token = _CONVERTED.set((policy_axis_name, axis_index_groups))
    try:
        yield
    finally:
        _CONVERTED.reset(token)


def converted_axis():
    """``(axis_name, axis_index_groups)`` of the enclosing
    :func:`convert_sync_batchnorm`, or None."""
    return _CONVERTED.get()


def pmean_moments(moments, axis_name, axis_index_groups=None):
    """flax's cross-device moments: the mean over the group of the stacked
    per-rank ``moments`` (one differentiable all-reduce)."""
    group = resolve_group(axis_name, axis_index_groups)
    return collectives.psum(torch.stack(moments), group, SCOPE) \
        / dist.get_world_size(group)
