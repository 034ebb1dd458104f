"""The port's collectives, counted and named.

Every ``torch.distributed`` call of the package goes through this module:
each runs inside ``torch.profiler.record_function(scope)``, with ``scope``
a scope of ``registry.COLLECTIVE_SCOPES`` (``ddp/sync_gradients``,
``bucketNN``, ``sync_batchnorm``, ...), and adds one to ``counts[scope]``,
so a run can show which collectives a step issued (the JAX package names
its ``psum``s with a trace span). NCCL carries them on the card and gloo on
the CPU; they are not kernels of the port.

Every rank must issue the same collectives in the same order, so no
caller skips one at world size 1 or for an empty shard.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist
from torch.profiler import record_function

#: collectives issued, by scope, since the last ``reset_counts()``
counts = collections.Counter()


def reset_counts() -> None:
    counts.clear()


def _issue(scope, fn, *args, **kwargs):
    with record_function(scope):
        fn(*args, **kwargs)
    counts[scope] += 1


def all_reduce(t: torch.Tensor, group, scope: str) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    _issue(scope, dist.all_reduce, t, group=group)
    return t


def all_gather(t: torch.Tensor, group, scope: str) -> torch.Tensor:
    """(group size, *t.shape): every rank's ``t``, in group-rank order."""
    n = dist.get_world_size(group)
    out = torch.empty((n * t.numel(),), dtype=t.dtype, device=t.device)
    _issue(scope, dist.all_gather_into_tensor, out, t.contiguous().view(-1),
           group=group)
    return out.view(n, *t.shape)


def broadcast(t: torch.Tensor, src: int, group, scope: str) -> torch.Tensor:
    """``t`` from global rank ``src`` to every rank of ``group``, in
    place."""
    _issue(scope, dist.broadcast, t, src=src, group=group)
    return t


def all_to_all(t: torch.Tensor, group, scope: str) -> torch.Tensor:
    """Row i of ``t`` (group size, ...) goes to group rank i; returns the
    rows received, row j from group rank j."""
    out = torch.empty_like(t)
    _issue(scope, dist.all_to_all_single, out, t.contiguous(), group=group)
    return out


class _GatherRows(torch.autograd.Function):
    """``all_gather`` whose backward is its transpose, a reduce-scatter:
    each rank receives the sum over ranks of the gradient of its row
    (an all-reduce of the whole gradient, then this rank's row)."""

    @staticmethod
    def forward(ctx, t, group, scope):
        ctx.group, ctx.scope = group, scope
        return all_gather(t, group, scope)

    @staticmethod
    def backward(ctx, grad):
        g = all_reduce(grad.contiguous().clone(), ctx.group, ctx.scope)
        return g[dist.get_rank(ctx.group)], None, None


def gather_rows(t: torch.Tensor, group, scope: str) -> torch.Tensor:
    """Differentiable :func:`all_gather`."""
    return _GatherRows.apply(t, group, scope)


class _Psum(torch.autograd.Function):
    """Out-of-place sum over ``group``; its backward sums the gradient over
    the group too (the transpose of ``psum`` in the JAX package's
    unchecked ``shard_map``)."""

    @staticmethod
    def forward(ctx, t, group, scope):
        ctx.group, ctx.scope = group, scope
        return all_reduce(t.clone(), group, scope)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group,
                          ctx.scope), None, None


def psum(t: torch.Tensor, group, scope: str) -> torch.Tensor:
    """Differentiable out-of-place sum over ``group``."""
    return _Psum.apply(t, group, scope)
