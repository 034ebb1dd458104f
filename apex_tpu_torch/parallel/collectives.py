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

Staging on gloo. A gloo group carries some calls for CUDA tensors and ends
the process on others (``scripts/torch_gloo_probe.py`` tries each on the
card). The calls in ``GLOO_HOST_STAGED`` are therefore staged through host
memory when, and only when, the group's backend is gloo and a tensor is on
a CUDA device: the inputs are copied to the host, the call runs there and
the outputs are copied back. ``staged`` counts them by call. Nothing is
staged on NCCL, and nothing on the CPU.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist
from torch.profiler import record_function

#: collectives issued, by scope, since the last ``reset_counts()``
counts = collections.Counter()

#: calls staged through host memory, by call, since ``reset_counts()``
staged = collections.Counter()

#: calls a gloo group cannot carry for CUDA tensors: on torch 2.11 + CUDA
#: 12.8 on an H100, ``scripts/torch_gloo_probe.py`` finds send/recv ends
#: the process (gloo writes from the device pointer), while all_reduce,
#: broadcast, all_gather, reduce_scatter and all_to_all carry f32, bf16
#: and uint8
GLOO_HOST_STAGED = frozenset({"send_recv"})


def reset_counts() -> None:
    counts.clear()
    staged.clear()


def _host_staged(call, group, tensors) -> bool:
    return (call in GLOO_HOST_STAGED and any(t.is_cuda for t in tensors)
            and dist.get_backend(group) == "gloo")


def _issue(scope, call, fn, outs, ins=(), group=None, **kwargs):
    """``fn(*outs, *ins, group=group, **kwargs)`` inside ``scope``, counted;
    staged through the host where ``GLOO_HOST_STAGED`` says so."""
    host = _host_staged(call, group, outs + ins)
    if host:
        h_outs = tuple(t.cpu() for t in outs)
        h_ins = tuple(t.cpu() for t in ins)
    with record_function(scope):
        if host:
            fn(*h_outs, *h_ins, group=group, **kwargs)
            for t, h in zip(outs, h_outs):
                t.copy_(h)
        else:
            fn(*outs, *ins, group=group, **kwargs)
    counts[scope] += 1
    if host:
        staged[call] += 1


def all_reduce(t: torch.Tensor, group, scope: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` over ``group`` in place (a sum, or ``op``: the integrity
    compare's MIN and MAX); returns ``t``."""
    _issue(scope, "all_reduce", dist.all_reduce, (t,), group=group, op=op)
    return t


def all_gather(t: torch.Tensor, group, scope: str,
               tiled: bool = False) -> torch.Tensor:
    """(group size, *t.shape): every rank's ``t``, in group-rank order;
    ``tiled`` concatenates them along dim 0 instead (JAX's ``tiled=True``),
    so a flat shard gathers into the flat whole."""
    n = dist.get_world_size(group)
    out = torch.empty((n * t.numel(),), dtype=t.dtype, device=t.device)
    _issue(scope, "all_gather", dist.all_gather_into_tensor, (out,),
           (t.contiguous().view(-1),), group=group)
    if tiled:
        return out.view(n * t.shape[0], *t.shape[1:])
    return out.view(n, *t.shape)


def reduce_scatter(t: torch.Tensor, group, scope: str) -> torch.Tensor:
    """Tiled sum-scatter (JAX's ``psum_scatter(tiled=True)``): ``t`` is
    split into group-size tiles along dim 0, and group rank i receives the
    sum over ranks of tile i."""
    n = dist.get_world_size(group)
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({t.shape[0]}) is not a "
                         f"multiple of the group size {n}")
    src = t.contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _issue(scope, "reduce_scatter", dist.reduce_scatter_tensor, (out,),
           (src,), group=group)
    return out


def broadcast(t: torch.Tensor, src: int, group, scope: str) -> torch.Tensor:
    """``t`` from global rank ``src`` to every rank of ``group``, in
    place."""
    _issue(scope, "broadcast", dist.broadcast, (t,), group=group, src=src)
    return t


def all_to_all(t: torch.Tensor, group, scope: str) -> torch.Tensor:
    """Row i of ``t`` (group size, ...) goes to group rank i; returns the
    rows received, row j from group rank j."""
    out = torch.empty_like(t)
    _issue(scope, "all_to_all", dist.all_to_all_single, (out,),
           (t.contiguous(),), group=group)
    return out


def _send_recv(out, t, dst, src, group):
    """One ``batch_isend_irecv`` pair: ``t`` to global rank ``dst``, ``out``
    from global rank ``src``."""
    ops = [dist.P2POp(dist.isend, t, dst, group),
           dist.P2POp(dist.irecv, out, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def _permute(t: torch.Tensor, perm, group, scope: str) -> torch.Tensor:
    """JAX's ``ppermute`` for a whole permutation: ``perm`` lists
    (source, destination) pairs of group ranks, each rank once on each
    side; this rank sends ``t`` to its destination and returns what its
    source sent, over one ``batch_isend_irecv`` pair."""
    me = dist.get_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) != 1 or len(src) != 1:
        raise NotImplementedError("ppermute takes a permutation in which "
                                  "every rank sends once and receives once")
    out = torch.empty_like(t)
    glob = lambda r: dist.get_global_rank(group, r)  # noqa: E731
    _issue(scope, "send_recv", _send_recv, (out,), (t.contiguous(),),
           group=group, dst=glob(dst[0]), src=glob(src[0]))
    return out


class _Permute(torch.autograd.Function):
    """:func:`_permute` whose backward permutes the gradient back, along
    the inverse pairs: how JAX transposes ``ppermute``."""

    @staticmethod
    def forward(ctx, t, perm, group, scope):
        ctx.perm, ctx.group, ctx.scope = perm, group, scope
        return _permute(t, perm, group, scope)

    @staticmethod
    def backward(ctx, grad):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(grad.contiguous(), inverse, ctx.group,
                        ctx.scope), None, None, None


def ppermute(t: torch.Tensor, perm, group, scope: str) -> torch.Tensor:
    """Differentiable JAX ``ppermute`` (:func:`_permute`)."""
    return _Permute.apply(t, tuple(tuple(p) for p in perm), group, scope)


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all`, whose transpose is itself: the gradient of the
    row received from rank j goes back to rank j."""

    @staticmethod
    def forward(ctx, t, group, scope):
        ctx.group, ctx.scope = group, scope
        return all_to_all(t, group, scope)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all(grad.contiguous(), ctx.group, ctx.scope), None, None


def all_to_all_rows(t: torch.Tensor, group, scope: str) -> torch.Tensor:
    """Differentiable :func:`all_to_all`."""
    return _AllToAll.apply(t, group, scope)


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
