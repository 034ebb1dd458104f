"""Bucketed and compressed gradient all-reduce.

Port of ``apex_tpu/parallel/comm.py``. Gradients are packed into
``message_size``-bounded buckets in reverse parameter order (the order
backward produces them), one all-reduce a bucket, each inside a
``bucketNN`` profiler range (``collectives``): the structure of the
reference DDP's ``allreduce_bucket``. Buckets reduce in order on one communicator, so the
JAX package's ``optimization_barrier`` chain has no counterpart here.

Compressed modes, with an optional error-feedback residual:

- ``compress="bf16"``: the bucket all-reduced in bf16 against f32
  masters, half the wire bytes;
- ``compress="int8"``: blockwise-scaled int8 in two phases (all-to-all
  of the quantized shards, dequantize and sum locally in f32,
  re-quantize the summed shard, all-gather), about a quarter of the f32
  bytes plus one f32 scale per ``compress_block`` elements.

The compression error of a step comes back as the residual and is added
to the next step's gradients, so it does not accumulate as bias. The
exact mode (``compress=None``) is the arithmetic of
``distributed.sync_gradients``. The hierarchical schedule, whose hops may
each have their own wire dtype, is ``hierarchy.hierarchical_sync``;
:func:`wire_bytes` and :func:`bucket_table` take its ``CommPlan`` too.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.arena import native
from apex_tpu_torch.parallel import collectives
from apex_tpu_torch.parallel.mesh import DATA_AXIS, resolve_group
from apex_tpu_torch.utils import tree_leaves, tree_map

__all__ = ["Bucket", "bucket_plan", "bucket_table", "wire_bytes",
           "bucketed_all_reduce", "init_residual", "dtype_wire_bytes",
           "DEFAULT_MESSAGE_SIZE", "DEFAULT_COMPRESS_BLOCK",
           "COMPRESS_MODES"]

#: apex DDP parity: ``message_size`` defaults to 1e7 elements
DEFAULT_MESSAGE_SIZE = 10_000_000

#: elements per int8 quantization block (one f32 scale each)
DEFAULT_COMPRESS_BLOCK = 256

COMPRESS_MODES = (None, "bf16", "int8")


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _dtype_name(dtype: torch.dtype) -> str:
    """"float32", "bfloat16", ...: the JAX package's dtype names."""
    return str(dtype).removeprefix("torch.")


class Bucket(NamedTuple):
    """One reduction unit: float leaves of one dtype, contiguous in
    reverse-parameter order, capped at ``message_size`` elements."""
    dtype: str
    leaf_idx: Tuple[int, ...]   # indices into the flattened grad tree
    elems: int

    def bytes(self) -> int:
        return self.elems * getattr(torch, self.dtype).itemsize


def bucket_plan(leaves, message_size: Optional[int] = None) -> List[Bucket]:
    """Static bucket layout of a list of gradient leaves (tensors, or
    anything with ``shape`` and a torch ``dtype``).

    Float leaves group by dtype and are walked in reverse leaf order, so
    the last parameters' gradients land in bucket 0; greedy
    ``message_size`` caps (elements) by the arena's planner; ``None``
    packs each dtype into one bucket."""
    groups: Dict[str, List[int]] = {}
    for i in range(len(leaves) - 1, -1, -1):
        dt = getattr(leaves[i], "dtype", None)
        if isinstance(dt, torch.dtype) and dt.is_floating_point:
            groups.setdefault(_dtype_name(dt), []).append(i)
    out: List[Bucket] = []
    for dt, idxs in groups.items():
        sizes = np.asarray([int(np.prod(leaves[i].shape, dtype=np.int64))
                            for i in idxs], np.int64)
        cap = int(message_size) if message_size else int(sizes.sum()) + 1
        ids, nb = native.plan_buckets(sizes, cap)
        for b in range(nb):
            sel = tuple(i for i, bid in zip(idxs, ids) if bid == b)
            out.append(Bucket(dtype=dt, leaf_idx=sel, elems=int(
                sum(sizes[j] for j, bid in enumerate(ids) if bid == b))))
    return out


def dtype_wire_bytes(elems: int, dtype: Optional[str],
                     compress_block: int = DEFAULT_COMPRESS_BLOCK) -> int:
    """Payload bytes of ``elems`` f32-logical elements at a wire dtype:
    ``None`` f32, ``"bf16"`` half, ``"int8"`` a byte an element plus one
    f32 scale per ``compress_block``."""
    if dtype is None:
        return elems * 4
    if dtype == "bf16":
        return elems * 2
    if dtype == "int8":
        return elems + 4 * (-(-elems // compress_block))
    raise ValueError(f"unknown compress mode {dtype!r}")


def wire_bytes(plan: List[Bucket], compress=None,
               compress_block: int = DEFAULT_COMPRESS_BLOCK) -> int:
    """Payload bytes on the wire for one sync under ``compress``, in
    all-reduce-equivalent units (before the ring's 2·(N−1)/N), so the
    ratio against ``wire_bytes(plan)`` is the compression.

    ``compress`` is one mode for the whole sync, or a
    ``hierarchy.CommPlan``: its hops' per-rank ring-factored bytes are
    summed and divided by the flat all-reduce's ring factor, so flat and
    hierarchical schedules compare in one unit."""
    if hasattr(compress, "hops"):        # a CommPlan (no import cycle)
        total = sum(compress.bucket_wire_bytes(b.elems) for b in plan)
        return int(total / compress.flat_ring_factor())
    return sum(dtype_wire_bytes(b.elems, compress, compress_block)
               for b in plan)


def bucket_table(plan: List[Bucket], compress=None,
                 compress_block: int = DEFAULT_COMPRESS_BLOCK) -> str:
    """Human-readable bytes-per-bucket table; ``compress`` (a mode or a
    ``CommPlan``) appends the wire MiB each bucket moves."""
    head = "  bucket  dtype     tensors      elems        MiB"
    lines = [head + ("   wire MiB" if compress is not None else "")]
    for i, b in enumerate(plan):
        row = (f"  {i:6d}  {b.dtype:8s} {len(b.leaf_idx):7d} "
               f"{b.elems:10d} {b.bytes() / 2 ** 20:10.2f}")
        if compress is not None:
            w = wire_bytes([b], compress, compress_block)
            row += f" {w / 2 ** 20:10.2f}"
        lines.append(row)
    return "\n".join(lines)


def init_residual(grads):
    """Zeroed error-feedback residual for a gradient tree: f32 zeros per
    float leaf (the error lives in master precision), empty (0,) f32
    placeholders for other leaves. It is this rank's own state."""
    def _init(g):
        if _is_float(g):
            return torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        device = g.device if isinstance(g, torch.Tensor) else None
        return torch.zeros((0,), dtype=torch.float32, device=device)
    return tree_map(_init, grads)


# --- codecs ------------------------------------------------------------------

def _quantize_int8(x: torch.Tensor, block: int):
    """Blockwise symmetric int8 of a 1-D f32 ``x``: one f32 scale per
    ``block`` elements. A length not divisible by ``block`` is zero-padded
    to the next boundary (zeros quantize exactly and raise no scale); ``q``
    comes back at the padded length."""
    n = x.shape[0]
    npad = -(-n // block) * block - n
    if npad:
        x = torch.nn.functional.pad(x, (0, npad))
    xb = x.view(-1, block)
    scale = xb.abs().amax(dim=1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xb / safe[:, None]), -127, 127).to(
        torch.int8)
    return q.view(-1), scale


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor, block: int,
                     n: Optional[int] = None):
    out = (q.float().view(-1, block) * scale[:, None]).view(-1)
    return out if n is None or n == out.shape[0] else out[:n]


def _int8_all_reduce(buf: torch.Tensor, group, block: int, scope: str):
    """Two-phase blockwise-quantized all-reduce of an f32 vector whose
    length is a multiple of ``world * block``. Returns ``(sum, err_local,
    err_shard)``: the phase-1 quantization error over the local buffer and
    the phase-2 error over this rank's shard (f32, for error feedback)."""
    world = dist.get_world_size(group)
    per = buf.shape[0] // world
    q, s = _quantize_int8(buf, block)
    err_local = buf - _dequantize_int8(q, s, block)
    qt = collectives.all_to_all(q.view(world, per), group, scope)
    st = collectives.all_to_all(s.view(world, per // block), group, scope)
    deq = qt.float().view(world, per // block, block) * st[:, :, None]
    shard_sum = deq.sum(dim=0).view(per)
    q2, s2 = _quantize_int8(shard_sum, block)
    err_shard = shard_sum - _dequantize_int8(q2, s2, block)
    total_q = collectives.all_gather(q2, group, scope).view(-1)
    total_s = collectives.all_gather(s2, group, scope).view(-1)
    return _dequantize_int8(total_q, total_s, block), err_local, err_shard


# --- the bucketed reduction --------------------------------------------------

def bucketed_all_reduce(grads, axis_name: str = DATA_AXIS, *,
                        message_size: Optional[int] = None,
                        gradient_average: bool = True,
                        gradient_predivide_factor: float = 1.0,
                        allreduce_always_fp32: bool = False,
                        compress: Optional[str] = None, residual=None,
                        compress_block: int = DEFAULT_COMPRESS_BLOCK):
    """Bucketed, backward-ordered and optionally compressed all-reduce of a
    gradient tree over ``axis_name`` of the bound mesh.

    Arithmetic knobs as ``distributed.sync_gradients``. With ``compress``
    the buckets travel through the codec in f32; pass the previous step's
    ``residual`` (from :func:`init_residual`) for error feedback, and the
    return value is ``(synced, new_residual)`` instead of ``synced``."""
    if compress not in COMPRESS_MODES:
        raise ValueError(f"compress must be one of {COMPRESS_MODES}, "
                         f"got {compress!r}")
    if compress is not None and allreduce_always_fp32:
        raise ValueError("compress already fixes the wire dtype; "
                         "allreduce_always_fp32 does not compose with it")
    if compress == "int8" and not isinstance(axis_name, str):
        raise NotImplementedError("int8 all-reduce needs a single named "
                                  "axis (all_to_all shard ownership)")
    group = resolve_group(axis_name)
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    pre = gradient_predivide_factor
    leaves = tree_leaves(grads)
    r_leaves = None
    if residual is not None:
        r_leaves = tree_leaves(residual)
        if len(r_leaves) != len(leaves):
            raise ValueError(
                f"residual has {len(r_leaves)} leaves, grads have "
                f"{len(leaves)}: build it with init_residual(grads)")

    from apex_tpu_torch.trace.spans import span
    out = list(leaves)
    for bi, bkt in enumerate(bucket_plan(leaves, message_size)):
        scope = f"bucket{bi:02d}"
        with span(scope, kind="collective"):
            flat = torch.cat([leaves[i].reshape(-1) for i in bkt.leaf_idx])
            if compress is not None or allreduce_always_fp32:
                flat = flat.float()
            if pre != 1.0:
                flat = flat / pre
            if compress is not None and r_leaves is not None:
                flat = flat + torch.cat([r_leaves[i].reshape(-1)
                                         for i in bkt.leaf_idx])
            err = None
            if compress == "bf16":
                wire = flat.to(torch.bfloat16)
                if r_leaves is not None:
                    err = flat - wire.float()
                red = collectives.all_reduce(wire, group, scope).float()
            elif compress == "int8":
                n0 = flat.shape[0]
                mult = world * compress_block
                npad = -(-n0 // mult) * mult - n0
                fpad = (torch.nn.functional.pad(flat, (0, npad)) if npad
                        else flat)
                red, err_local, err_shard = _int8_all_reduce(
                    fpad, group, compress_block, scope)
                red = red[:n0]
                if r_leaves is not None:
                    # the phase-2 error belongs to this rank's shard: its
                    # owner re-injects it so it enters the next step's sum
                    per = fpad.shape[0] // world
                    err = err_local.clone()
                    err[rank * per:(rank + 1) * per] += err_shard
                    err = err[:n0]
            else:
                # flat is a new tensor (cat copies): reduced in place
                red = collectives.all_reduce(flat, group, scope)
            if gradient_average:
                post = world / pre
                if post != 1.0:
                    red = red / post
            off = 0
            for i in bkt.leaf_idx:
                n = leaves[i].numel()
                out[i] = red[off:off + n].view(leaves[i].shape).to(
                    leaves[i].dtype)
                if err is not None:
                    r_leaves[i] = err[off:off + n].view(leaves[i].shape)
                off += n

    it = iter(out)
    synced = tree_map(lambda _: next(it), grads)
    if residual is None:
        return synced
    rit = iter(r_leaves)
    return synced, tree_map(lambda _: next(rit), residual)
