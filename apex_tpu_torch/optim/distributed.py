"""ZeRO: the sharded fused optimizers ``DistributedFusedAdam`` and
``DistributedFusedLAMB``.

Port of ``apex_tpu/optim/distributed.py`` (the reference's
``apex.contrib.optimizers.distributed_fused_{adam,lamb}``). Each rank
holds one contiguous shard of the f32 master and moment arena. A step
flattens the gradients into the arena's layout, **reduce-scatters** them
over the data axis (mean), clips by the global norm computed from the
shards' norms, runs the fused update on this rank's shard (the arena
kernels: ``adam``, or LAMB's two stages with per-tensor trust ratios from
the shards' per-tensor norms) and **all-gathers** the new parameters,
optionally in a compressed dtype (``param_gather_dtype``, e.g.
``torch.bfloat16`` or ``torch.float8_e5m2``, which travels as its bytes).
The inbound scatter can be compressed too (``grad_scatter_dtype``).

Ranks and shards: inside ``parallel.use_mesh(mesh)`` the optimizer reads
its axis (or axis tuple) from the bound mesh. Over an axis tuple the
scatter runs each axis in order and the gather in reverse, so the shard a
rank owns is its axis-major linear rank ``i0·n1·… + i1·…``; a mesh made by
``init_device_mesh`` is row-major, so global rank ``g`` owns tile ``g``.
Shards are ``_SHARD_ALIGN`` (512 × 128) aligned, as in JAX, so the shard
layouts equal the JAX package's element for element (for the same arena
layout).

Collectives of a step, each counted under its registry scope: the
``zero/grad_scatter`` reduce-scatter, the ``zero/grad_norm`` sums (the
clip's, and LAMB's two per-tensor ones), and the ``zero/param_gather``
all-gather, one a partition and axis. Device scalars (the step count, the
clip factor) never reach the host.

An overflowing step needs no revert here: ``amp.Amp.apply_gradients``
commits the new state only where the grads were finite. As in JAX, that
flag is the rank's own (ROADMAP.md, queue C caveats).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist

from apex_tpu_torch import arena
from apex_tpu_torch.ops import multi_tensor as MT
from apex_tpu_torch.ops import optim_kernels as K
from apex_tpu_torch.optim.fused import FusedOptimizer
from apex_tpu_torch.parallel import collectives
from apex_tpu_torch.parallel.mesh import (axes_of, axes_size, linear_index,
                                          resolve_group)

Axis = Union[str, Tuple[str, ...]]

#: a shard's length is a multiple of this (the arena kernels' buffer
#: multiple, and the JAX package's 512 x 128 Pallas tile)
_SHARD_ALIGN = 512 * 128

SCATTER_SCOPE = "zero/grad_scatter"
GATHER_SCOPE = "zero/param_gather"
NORM_SCOPE = "zero/grad_norm"


class ShardedOptState(NamedTuple):
    """Step count + sharded f32 slots: ``slots["master"][dt]`` is this
    rank's master shard of the ``dt`` param partition."""
    count: torch.Tensor
    slots: Dict[str, Dict[str, torch.Tensor]]


def partition_lengths(spec) -> Dict[str, int]:
    """``dtype -> logical buffer length`` of an arena spec: the lengths an
    elastic checkpoint records (the port's copy of
    ``apex_tpu.ckpt.elastic.partition_lengths``)."""
    return {p.dtype: int(p.buffer_len) for p in spec.partitions}


def _padded_len(n: int, world: int) -> int:
    per = -(-n // world)
    per = -(-per // _SHARD_ALIGN) * _SHARD_ALIGN
    return per * world


def _psum(x: torch.Tensor, axis_name: Axis, scope: str) -> torch.Tensor:
    """Sum over every axis of ``axis_name``, one all-reduce each."""
    x = x.clone()
    for a in axes_of(axis_name):
        collectives.all_reduce(x, resolve_group(a), scope)
    return x


def _reduce_scatter_mean(buf, axis_name: Axis, world: int, wire_dtype=None):
    """Mean-reducing scatter over (possibly nested) axes, each in order, so
    rank (i0, i1, ...) ends with tile i0·n1·… + i1·…. ``wire_dtype``
    compresses the scatter; the result comes back in ``buf``'s dtype
    before the division. Runs under the ``zero/grad_scatter`` trace span
    (``kind="collective"``), as the JAX package's does."""
    from apex_tpu_torch.trace.spans import span
    out = buf if wire_dtype is None else buf.to(wire_dtype)
    with span(SCATTER_SCOPE, kind="collective"):
        for a in axes_of(axis_name):
            out = collectives.reduce_scatter(out, resolve_group(a),
                                             SCATTER_SCOPE)
    if wire_dtype is not None:
        out = out.to(buf.dtype)
    return out / world


def _all_gather_shard(shard, axis_name: Axis):
    """Inverse of :func:`_reduce_scatter_mean`'s tiling: the axes gathered
    in reverse order. A one-byte float (fp8) travels as its bytes, which
    neither NCCL nor gloo takes as a float type. Runs under the
    ``zero/param_gather`` trace span (``kind="collective"``)."""
    from apex_tpu_torch.trace.spans import span
    out = shard
    as_bytes = shard.dtype.is_floating_point and shard.dtype.itemsize == 1
    if as_bytes:
        out = out.view(torch.uint8)
    with span(GATHER_SCOPE, kind="collective"):
        for a in reversed(axes_of(axis_name)):
            out = collectives.all_gather(out, resolve_group(a),
                                         GATHER_SCOPE, tiled=True)
    return out.view(shard.dtype) if as_bytes else out


class DistributedFusedAdam(FusedOptimizer):
    """Sharded Adam/AdamW over a mesh axis (or axis tuple) of the bound
    mesh; the constructor's knobs are the reference's
    (``distributed_fused_adam.py:30-95``). ``param_gather_dtype`` is the
    compressed all-gather: new params travel in this dtype and are cast to
    the param dtype on arrival."""

    slot_names = ("master", "m", "v")

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adam_w_mode=True, bias_correction=True,
                 axis_name: Axis = "data", max_grad_norm: float = 0.0,
                 param_gather_dtype=None, grad_scatter_dtype=None):
        super().__init__(lr, strategy="arena")
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction
        self.axis_name = axis_name
        self.max_grad_norm = max_grad_norm
        self.param_gather_dtype = param_gather_dtype
        #: wire dtype of the grad reduce-scatter; no error feedback (the f32
        #: master update absorbs the rounding, as in JAX)
        self.grad_scatter_dtype = grad_scatter_dtype

    # -- sharding helpers ----------------------------------------------------

    @staticmethod
    def _pad_full(buf, buffer_len: int, world: int):
        total = _padded_len(buffer_len, world)
        if total == buffer_len:
            return buf
        return torch.nn.functional.pad(buf, (0, total - buffer_len))

    def _scatter_grads(self, spec, grads, world: int):
        """Flatten (one flatten for the tree), pad and reduce-scatter every
        partition."""
        g_bufs = arena.flatten(grads, spec, cast=torch.float32)
        return {part.dtype: _reduce_scatter_mean(
            self._pad_full(g_bufs[part.dtype], part.buffer_len, world),
            self.axis_name, world, wire_dtype=self.grad_scatter_dtype)
            for part in spec.partitions}

    # -- state ---------------------------------------------------------------

    def init(self, params) -> ShardedOptState:
        """This rank's shard of the master and moment state (inside
        ``use_mesh``)."""
        spec = arena.plan(params)
        world = axes_size(self.axis_name)
        rank = linear_index(self.axis_name)
        full_bufs = arena.flatten(params, spec, cast=torch.float32)
        slots = {name: {} for name in self.slot_names}
        for part in spec.partitions:
            dt = part.dtype
            full = self._pad_full(full_bufs[dt], part.buffer_len, world)
            per = full.shape[0] // world
            shard = full[rank * per:(rank + 1) * per].clone()
            slots["master"][dt] = shard
            slots["m"][dt] = torch.zeros_like(shard)
            slots["v"][dt] = torch.zeros_like(shard)
        device = next(iter(params.values())).device
        return ShardedOptState(
            count=torch.tensor(0, dtype=torch.int32, device=device),
            slots=slots)

    def checkpoint_layout(self, params) -> Dict[str, int]:
        """``dtype -> logical buffer length`` of the slot shards: an
        elastic restore re-partitions to another world size from these
        (the logical content of a slot buffer is its first ``buffer_len``
        elements; the rest is zero padding that stays zero)."""
        return partition_lengths(arena.plan(params))

    def state_bytes(self, params, world: Optional[int] = None) -> Dict:
        """Analytic per-rank optimizer-state bytes, host arithmetic only:
        per f32 slot a replicated optimizer holds the whole partition, this
        one ``padded_len / world`` (``ratio`` sits a little above 1/world
        on small models, from the shard alignment). ``world`` defaults to
        the process group's size (1 without one)."""
        if world is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
        spec = arena.plan(params)
        per_slot_rep = sum(p.buffer_len for p in spec.partitions) * 4
        per_slot_shard = sum(_padded_len(p.buffer_len, world) // world
                             for p in spec.partitions) * 4
        n = len(self.slot_names)
        return {
            "world": world, "n_slots": n,
            "per_slot_sharded": per_slot_shard,
            "per_slot_replicated": per_slot_rep,
            "sharded_bytes": n * per_slot_shard,
            "replicated_bytes": n * per_slot_rep,
            "ratio": (n * per_slot_shard) / max(n * per_slot_rep, 1),
        }

    # -- update --------------------------------------------------------------

    def _grad_clip_scale(self, g_shards):
        """The global grad-norm clip from the shards: local sums of squares
        (one ``multi_tensor_l2norm`` launch a partition), summed over the
        axes to the exact global norm."""
        if not self.max_grad_norm:
            return 1.0
        sq = sum(torch.square(MT.multi_tensor_l2norm(g))
                 for g in g_shards.values())
        gnorm = torch.sqrt(_psum(sq, self.axis_name, NORM_SCOPE))
        return torch.where(gnorm > self.max_grad_norm,
                           self.max_grad_norm / gnorm, 1.0)

    def _shard_update(self, part, g, slots, count, lr, clip, world):
        """One partition's update on this rank's shard -> (new slots, the
        buffer to gather)."""
        dt = part.dtype
        res = K.adam_update(
            slots["master"][dt], g, slots["m"][dt], slots["v"][dt],
            lr=lr, beta1=self.beta1, beta2=self.beta2, eps=self.eps,
            weight_decay=self.weight_decay, step=count,
            adam_w_mode=self.adam_w_mode,
            bias_correction=self.bias_correction, grad_scale=clip,
            param_copy_dtype=self.param_gather_dtype)
        p_shard, m2, v2 = res[:3]
        wire = res[3] if self.param_gather_dtype is not None else p_shard
        return {"master": p_shard, "m": m2, "v": v2}, wire

    def step(self, grads, state: ShardedOptState, params):
        """Fused sharded update: returns (new_params, new_state)."""
        spec = arena.plan(params)
        world = axes_size(self.axis_name)
        count = state.count + 1
        lr = self._resolve_lr(count)

        g_shards = self._scatter_grads(spec, grads, world)
        clip = self._grad_clip_scale(g_shards)

        new_p, new_slots = {}, {name: {} for name in self.slot_names}
        for part in spec.partitions:
            dt = part.dtype
            slot_updates, wire = self._shard_update(
                part, g_shards[dt], state.slots, count, lr, clip, world)
            for name, val in slot_updates.items():
                new_slots[name][dt] = val
            gathered = _all_gather_shard(wire, self.axis_name)
            new_p[dt] = gathered[:part.buffer_len].to(getattr(torch, dt))
        return (arena.unflatten(new_p, spec),
                ShardedOptState(count=count, slots=new_slots))


class DistributedFusedLAMB(DistributedFusedAdam):
    """Sharded LAMB (``distributed_fused_lamb.py:7-607``): the Adam pipeline
    with LAMB's two stages, and per-tensor trust ratios from the shards'
    per-tensor norms, summed over the axes to the exact norms."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-6,
                 weight_decay=0.01, adam_w_mode=True, bias_correction=True,
                 axis_name: Axis = "data", max_grad_norm: float = 1.0,
                 use_nvlamb: bool = False, param_gather_dtype=None,
                 grad_scatter_dtype=None):
        super().__init__(lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay, adam_w_mode=adam_w_mode,
                         bias_correction=bias_correction,
                         axis_name=axis_name, max_grad_norm=max_grad_norm,
                         param_gather_dtype=param_gather_dtype,
                         grad_scatter_dtype=grad_scatter_dtype)
        self.use_nvlamb = use_nvlamb

    def _shard_start(self, part, world) -> Tuple[int, int]:
        per = _padded_len(part.buffer_len, world) // world
        return linear_index(self.axis_name) * per, per

    def _per_tensor_sq(self, buf, part, world):
        """Exact global per-tensor sums of squares from this shard's part,
        summed over the axes."""
        start, _ = self._shard_start(part, world)
        return _psum(MT.per_tensor_sq_shard(buf, part.offsets, part.sizes,
                                            start),
                     self.axis_name, NORM_SCOPE)

    def _shard_update(self, part, g, slots, count, lr, clip, world):
        dt = part.dtype
        master = slots["master"][dt]
        u, m2, v2 = K.lamb_stage1(
            master, g, slots["m"][dt], slots["v"][dt],
            beta1=self.beta1, beta2=self.beta2, eps=self.eps,
            weight_decay=self.weight_decay, step=count,
            bias_correction=self.bias_correction,
            adam_w_mode=self.adam_w_mode, clip_scale=clip)
        if not self.use_nvlamb and self.weight_decay == 0.0:
            # plain LAMB without decay takes every ratio as 1 (the JAX
            # package computes the norms and discards them; every rank
            # skips the same two sums here)
            ratio = torch.ones(len(part.sizes), dtype=torch.float32,
                               device=master.device)
        else:
            p_norms = torch.sqrt(self._per_tensor_sq(master, part, world))
            u_norms = torch.sqrt(self._per_tensor_sq(u, part, world))
            ratio = torch.where((p_norms > 0) & (u_norms > 0),
                                p_norms / u_norms, 1.0)
        start, per = self._shard_start(part, world)
        ratio_pos = MT.spread_per_tensor_shard(ratio, part.offsets,
                                               part.sizes, start, per)
        res = K.lamb_stage2(master, u, ratio_pos, lr=lr,
                            param_copy_dtype=self.param_gather_dtype)
        if self.param_gather_dtype is None:
            return {"master": res, "m": m2, "v": v2}, res
        p_shard, wire = res
        return {"master": p_shard, "m": m2, "v": v2}, wire
