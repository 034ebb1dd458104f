"""Reductions and elementwise passes over the flat arena: the global L2
and max norms, scale and axpby (Triton kernels), and the per-tensor norms
and spreads of the LAMB trust ratio and the NovoGrad norms (plain
PyTorch).

Port of ``apex_tpu/ops/multi_tensor.py``. Kernels replaced (each reached
through ``_dispatch.launch``):

- ``l2norm_kernel`` ← ``_l2norm_kernel`` (``multi_tensor_l2norm``): ‖x‖₂
  of a flat arena buffer, f32 sums.
- ``maxnorm_kernel`` ← ``_maxnorm_kernel`` (``multi_tensor_maxnorm``):
  max |x| in f32, NaN if any element is NaN.
- ``scale_kernel`` ← ``_scale_kernel`` (``multi_tensor_scale``): s·x in
  f32, cast to the output dtype, and an all-finite flag.
- ``axpby_kernel`` ← ``_axpby_kernel`` (``multi_tensor_axpby``): a·x + b·y
  in f32, cast, and the same flag.

What bounds them on an H100: bytes, one read of each input and one write
of the output (4N bytes for the norms of an f32 buffer of N elements, 8N
for scale and 12N for axpby in f32), with a handful of flops per element.
The TPU kernels carry their sum, max or flag from block to block in one
SMEM scalar, relying on the grid running in order; on Hopper blocks run
in no order. So each has two deterministic stages and no atomics: a fixed
number of programs each walk every ``_PROGRAMS``-th block of the buffer
and write one partial (Σx², max |x| with a NaN count, or a count of
non-finite results), then one program reduces the partials. The norms and
the flag are the same from run to run.

The flag follows the JAX kernels' code: it tests the f32 product before
the cast to the output dtype, so a value that overflows only in the cast
(1e5 scaled by 1 into f16) comes out inf with the flag True, as it does
there (the comment in the JAX kernel and the reference Apex say the
converted value is checked; the code does not).

The per-tensor functions take the arena's static ranges (or, for one
ZeRO shard, those ranges clipped to the shard). They reduce
rows (up to ``_ROW`` wide) of the buffer in one pass and sum each
tensor's rows with one segmented reduction, so their launch count does
not grow with the number of tensors (a loop of per-tensor slices would
put back the launch-bound per-tensor update the arena exists to avoid).
That needs the arena's layout: slot starts on row boundaries and zero
padding after each tensor, which :func:`apex_tpu_torch.arena.flatten`
guarantees (and an update direction ``u`` computed from zero padding is
zero there too).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from apex_tpu_torch.ops import _arena, _build
from apex_tpu_torch.ops._priced import priced

tl = None  # triton.language, bound by _build.triton_jit at the first launch

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)
_PROGRAMS = 1024         # stage-1 programs: every SM holds several
_BLOCK = 4096            # elements per program per step; divides 65536
_ROW = 1024              # widest row the per-tensor reductions use


# --- multi_tensor_l2norm -------------------------------------------------------

def _l2norm_partials_triton(X, PART, n_blocks, BLOCK: "tl.constexpr",
                            PROGRAMS: "tl.constexpr"):
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for b in range(pid, n_blocks, PROGRAMS):
        x = tl.load(X + b.to(tl.int64) * BLOCK + cols).to(tl.float32)
        acc += x * x
    tl.store(PART + pid, tl.sum(acc, axis=0))


def _l2norm_finish_triton(PART, OUT, PROGRAMS: "tl.constexpr"):
    s = tl.sum(tl.load(PART + tl.arange(0, PROGRAMS)), axis=0)
    tl.store(OUT, tl.sqrt_rn(s))


@priced("multi_tensor_l2norm")
def l2norm_kernel(buf):
    """Triton ‖buf‖₂ (f32 0-d tensor) of a flat CUDA arena buffer."""
    n = _arena.check_buffers(buf, dtypes=_FLOATS)
    part = torch.empty(_PROGRAMS, dtype=torch.float32, device=buf.device)
    out = torch.empty((), dtype=torch.float32, device=buf.device)
    _build.triton_jit(_l2norm_partials_triton)[(_PROGRAMS,)](
        buf, part, n // _BLOCK, BLOCK=_BLOCK, PROGRAMS=_PROGRAMS,
        num_warps=8)
    _build.triton_jit(_l2norm_finish_triton)[(1,)](
        part, out, PROGRAMS=_PROGRAMS, num_warps=4)
    l2norm_kernel.launches += 1
    return out


l2norm_kernel.launches = 0


@priced("multi_tensor_l2norm")
def l2norm_plain(buf):
    return torch.sqrt(torch.sum(torch.square(buf.float())))


def multi_tensor_l2norm(buf):
    """Global L2 norm of a flat arena buffer (f32 accumulate), as a 0-d f32
    tensor on the buffer's device."""
    _arena.check_length(buf)
    if buf.is_cuda:
        return l2norm_kernel(buf)
    return l2norm_plain(buf)


# --- multi_tensor_maxnorm ------------------------------------------------------

def _maxnorm_partials_triton(X, PART, NANS, n_blocks, BLOCK: "tl.constexpr",
                             PROGRAMS: "tl.constexpr"):
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    nan = tl.zeros([BLOCK], dtype=tl.int32)
    for b in range(pid, n_blocks, PROGRAMS):
        x = tl.abs(tl.load(X + b.to(tl.int64) * BLOCK + cols).to(tl.float32))
        acc = tl.maximum(acc, x)
        nan = tl.maximum(nan, (x != x).to(tl.int32))
    tl.store(PART + pid, tl.max(acc, axis=0))
    tl.store(NANS + pid, tl.max(nan, axis=0))


def _maxnorm_finish_triton(PART, NANS, OUT, PROGRAMS: "tl.constexpr"):
    idx = tl.arange(0, PROGRAMS)
    m = tl.max(tl.load(PART + idx), axis=0)
    nan = tl.max(tl.load(NANS + idx), axis=0)
    tl.store(OUT, tl.where(nan > 0, float("nan"), m))


@priced("multi_tensor_maxnorm")
def maxnorm_kernel(buf):
    """Triton max |buf| (f32 0-d tensor) of a flat CUDA arena buffer; NaN
    if any element is NaN (``tl.maximum`` drops NaN, so both stages count
    NaNs beside the max)."""
    n = _arena.check_buffers(buf, dtypes=_FLOATS)
    part = torch.empty(_PROGRAMS, dtype=torch.float32, device=buf.device)
    nans = torch.empty(_PROGRAMS, dtype=torch.int32, device=buf.device)
    out = torch.empty((), dtype=torch.float32, device=buf.device)
    _build.triton_jit(_maxnorm_partials_triton)[(_PROGRAMS,)](
        buf, part, nans, n // _BLOCK, BLOCK=_BLOCK, PROGRAMS=_PROGRAMS,
        num_warps=8)
    _build.triton_jit(_maxnorm_finish_triton)[(1,)](
        part, nans, out, PROGRAMS=_PROGRAMS, num_warps=4)
    maxnorm_kernel.launches += 1
    return out


maxnorm_kernel.launches = 0


@priced("multi_tensor_maxnorm")
def maxnorm_plain(buf):
    return torch.amax(torch.abs(buf.float()))


def multi_tensor_maxnorm(buf):
    """Global max-abs (L∞) norm of a flat arena buffer, as a 0-d f32 tensor
    on the buffer's device (0 for an all-zero buffer, NaN if any element
    is NaN)."""
    _arena.check_length(buf)
    if buf.is_cuda:
        return maxnorm_kernel(buf)
    return maxnorm_plain(buf)


# --- multi_tensor_scale and multi_tensor_axpby ---------------------------------

def _axpby_triton(X, Y, S, OUT, BAD, n_blocks, HAS_Y: "tl.constexpr",
                  BLOCK: "tl.constexpr", PROGRAMS: "tl.constexpr"):
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    a = tl.load(S)
    if HAS_Y:
        b = tl.load(S + 1)
    bad = tl.zeros([BLOCK], dtype=tl.int32)
    for blk in range(pid, n_blocks, PROGRAMS):
        offs = blk.to(tl.int64) * BLOCK + cols
        r = a * tl.load(X + offs).to(tl.float32)
        if HAS_Y:
            r = r + b * tl.load(Y + offs).to(tl.float32)
        # not finite: inf fails the comparison, and so does NaN
        bad = tl.maximum(bad, tl.where(tl.abs(r) < float("inf"), 0, 1))
        tl.store(OUT + offs, r.to(OUT.dtype.element_ty))
    tl.store(BAD + pid, tl.max(bad, axis=0))


def _flag_finish_triton(BAD, OUT, PROGRAMS: "tl.constexpr"):
    bad = tl.max(tl.load(BAD + tl.arange(0, PROGRAMS)), axis=0)
    tl.store(OUT, bad == 0)


def _axpby_launch(x, y, scalars, out_dtype):
    """(out, all_finite) of a·x (+ b·y) on flat CUDA buffers."""
    bufs = (x,) if y is None else (x, y)
    n = _arena.check_buffers(*bufs, dtypes=_FLOATS)
    _build.check_operands(x, scalars)
    if scalars.shape != (len(bufs),) or scalars.dtype != torch.float32:
        raise ValueError(f"{len(bufs)} f32 scalars expected")
    out = torch.empty(n, dtype=out_dtype, device=x.device)
    bad = torch.empty(_PROGRAMS, dtype=torch.int32, device=x.device)
    flag = torch.empty((), dtype=torch.bool, device=x.device)
    _build.triton_jit(_axpby_triton)[(_PROGRAMS,)](
        x, x if y is None else y, scalars, out, bad, n // _BLOCK,
        HAS_Y=y is not None, BLOCK=_BLOCK, PROGRAMS=_PROGRAMS, num_warps=8,
        enable_fp_fusion=False)
    _build.triton_jit(_flag_finish_triton)[(1,)](
        bad, flag, PROGRAMS=_PROGRAMS, num_warps=4)
    return out, flag


@priced("multi_tensor_scale")
def scale_kernel(x, scalars, out_dtype):
    """Triton s·x on a flat CUDA buffer; ``scalars`` is the f32 device
    vector (s,). Returns (out in ``out_dtype``, all-finite 0-d bool)."""
    res = _axpby_launch(x, None, scalars, out_dtype)
    scale_kernel.launches += 1
    return res


scale_kernel.launches = 0


@priced("multi_tensor_axpby")
def axpby_kernel(x, y, scalars, out_dtype):
    """Triton a·x + b·y on flat CUDA buffers, without FMA contraction (the
    two products round as in the plain version); ``scalars`` is the f32
    device vector (a, b). Returns (out in ``out_dtype``, all-finite 0-d
    bool)."""
    res = _axpby_launch(x, y, scalars, out_dtype)
    axpby_kernel.launches += 1
    return res


axpby_kernel.launches = 0


@priced("multi_tensor_scale")
def scale_plain(x, scalars, out_dtype):
    r = scalars[0] * x.float()
    return r.to(out_dtype), torch.isfinite(r).all()


@priced("multi_tensor_axpby")
def axpby_plain(x, y, scalars, out_dtype):
    r = scalars[0] * x.float() + scalars[1] * y.float()
    return r.to(out_dtype), torch.isfinite(r).all()


def multi_tensor_scale(buf, scale, *, out_dtype=None):
    """``out = buf * scale`` over a flat arena buffer (f32 math, cast to
    ``out_dtype``, default the buffer's), with an all-finite flag over
    the f32 products. ``scale`` may be a device tensor. Returns ``(out,
    all_finite)``, the flag a 0-d bool tensor that stays on the device."""
    _arena.check_length(buf)
    scalars = _arena.device_scalars((scale,), buf.device)
    fn = scale_kernel if buf.is_cuda else scale_plain
    return fn(buf, scalars, out_dtype or buf.dtype)


def multi_tensor_axpby(a, x, b, y, *, out_dtype=None):
    """``out = a*x + b*y`` over flat arena buffers (f32 math, cast to
    ``out_dtype``, default x's), with an all-finite flag over the f32
    result. ``a`` and ``b`` may be device tensors. Returns ``(out,
    all_finite)``, the flag a 0-d bool tensor on the device."""
    _arena.check_length(x, y)
    scalars = _arena.device_scalars((a, b), x.device)
    fn = axpby_kernel if x.is_cuda else axpby_plain
    return fn(x, y, scalars, out_dtype or x.dtype)


# --- per-tensor norms and spreads over static ranges ---------------------------

class _Layout(NamedTuple):
    row: int                  # row width in elements
    lengths: torch.Tensor     # rows of every segment (tensors and gaps)
    pick: torch.Tensor        # segment index of each tensor
    row_value: torch.Tensor   # per row: its tensor's index, or n for a gap
    count: torch.Tensor       # per row: its leading elements in the range


@functools.lru_cache(maxsize=64)
def _layout(offsets, spans, total, device, exact) -> _Layout:
    """Rows of ``total`` elements covering sorted, disjoint ranges
    ``[off, off + span)``. The row width divides every offset and
    ``total`` (and, with ``exact``, every span); a range's last row is
    partial unless ``exact``, its remainder being arena padding."""
    row = _ROW
    while row > 1 and any(x % row for x in
                          offsets + (total,) + (spans if exact else ())):
        row //= 2
    rows = total // row
    lengths, pick, values, cur = [], [], [], 0
    count = np.zeros(rows, np.int64)
    for j, (off, span) in enumerate(zip(offsets, spans)):
        start, end = off // row, -(-(off + span) // row)
        if start < cur or end > rows:
            raise ValueError("per-tensor ranges must be sorted, disjoint "
                             "and inside the buffer")
        if start > cur:
            lengths.append(start - cur)
            values.append(len(offsets))
        pick.append(len(lengths))
        lengths.append(end - start)
        values.append(j)
        if end > start:
            count[start:end] = row
            count[end - 1] = off + span - (end - 1) * row
        cur = end
    if rows > cur:
        lengths.append(rows - cur)
        values.append(len(offsets))
    as_dev = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                       device=device)
    return _Layout(row, as_dev(lengths), as_dev(pick),
                   as_dev(np.repeat(values, lengths)), as_dev(count))


def _segment_rows(buf, offsets, sizes, ord):
    lay = _layout(tuple(offsets), tuple(sizes), buf.numel(), buf.device,
                  False)
    per_row = torch.linalg.vector_norm(buf.view(-1, lay.row), ord=ord, dim=1,
                                       dtype=torch.float32)
    return per_row, lay


def per_tensor_l2norm_ranges(buf, offsets, sizes):
    """(num_tensors,) f32 L2 norms of ``buf[off:off + size]`` for the
    arena partition's static ``offsets`` / ``sizes``, in a few launches:
    one pass of row norms, one segmented sum over row counts, one
    gather."""
    per_row, lay = _segment_rows(buf, offsets, sizes, 2)
    sums = torch.segment_reduce(torch.square(per_row), "sum",
                                lengths=lay.lengths, unsafe=True)
    return torch.sqrt(sums[lay.pick])


def per_tensor_maxnorm_ranges(buf, offsets, sizes):
    """(num_tensors,) f32 max-abs (L∞) norms over the same static ranges."""
    per_row, lay = _segment_rows(buf, offsets, sizes, float("inf"))
    maxs = torch.segment_reduce(per_row, "max", lengths=lay.lengths,
                                unsafe=True)
    return maxs[lay.pick]


def per_tensor_l2norm(buf, segment_ids, num_tensors):
    """(num_tensors,) f32 L2 norms from a per-position tensor index
    (``arena.segment_ids``: -1 in padding, whose elements are zero)."""
    if not isinstance(segment_ids, torch.Tensor):
        segment_ids = torch.from_numpy(np.array(segment_ids))
    ids = segment_ids.to(device=buf.device, dtype=torch.int64).clamp(min=0)
    sums = torch.zeros(num_tensors, dtype=torch.float32, device=buf.device)
    sums.index_add_(0, ids, torch.square(buf.float()))
    return torch.sqrt(sums)


def spread_per_tensor(values, offsets, padded, total, fill=0.0):
    """Broadcast a (num_tensors,) vector over the arena layout: each
    tensor's value over its padded slot, ``fill`` in gaps and in the tail
    up to ``total`` — ``values[segment_ids]`` in a few launches (one gather
    per row, one broadcast copy)."""
    lay = _layout(tuple(offsets), tuple(padded), int(total), values.device,
                  True)
    ext = torch.cat([values, torch.full((1,), fill, dtype=values.dtype,
                                        device=values.device)])
    return ext[lay.row_value][:, None].expand(-1, lay.row).reshape(-1)


# --- per-tensor norms and spreads over one ZeRO shard --------------------------

def _shard_ranges(offsets, sizes, start, per):
    """Each tensor's range clipped to the shard ``[start, start + per)``,
    in shard coordinates: (starts, spans), empty (span 0) where a tensor
    does not reach the shard. Sorted and disjoint like the arena's."""
    lo = [min(max(off - start, 0), per) for off in offsets]
    hi = [min(max(off + sz - start, 0), per) for off, sz in zip(offsets,
                                                                 sizes)]
    return tuple(lo), tuple(h - l for l, h in zip(lo, hi))


def per_tensor_sq_shard(buf, offsets, sizes, shard_start):
    """(num_tensors,) f32 sums of squares of each tensor's part of ONE shard
    of an arena partition: the sharded norm of ``DistributedFusedLAMB``;
    sum them over the shards (an all-reduce) for the per-tensor norms.

    ``buf`` is this rank's contiguous shard, ``shard_start`` its global
    offset, a host int (the rank is known on the host), and ``offsets`` /
    ``sizes`` the partition's static layout. Each range is clipped to the
    shard once and the rows of the cached layout are reduced as in
    :func:`per_tensor_l2norm_ranges` (a tensor that misses the shard is an
    empty segment and sums to 0), so the launches do not grow with the
    number of tensors and at ``shard_start=0`` over the whole buffer the
    result is that function's squared, bit for bit. Every element enters
    one f32 row sum. Tensors start on rows (arena alignment) and their
    padding is zero, which the JAX package's masks make explicit."""
    lo, spans = _shard_ranges(offsets, sizes, int(shard_start), buf.numel())
    per_row, lay = _segment_rows(buf, lo, spans, 2)
    sums = torch.segment_reduce(torch.square(per_row), "sum",
                                lengths=lay.lengths, unsafe=True)
    return sums[lay.pick]


def spread_per_tensor_shard(values, offsets, sizes, shard_start, per,
                            fill=0.0):
    """Shard-local inverse of :func:`per_tensor_sq_shard`: the (num_tensors,)
    ``values`` over this shard's ``per`` positions, each tensor's value on
    its elements and ``fill`` elsewhere (padding and the tail): what
    ``values[segment_ids]`` gives over the shard, in a few launches (a
    gather per row and one masked broadcast write) from the cached row
    layout of the clipped ranges."""
    lo, spans = _shard_ranges(offsets, sizes, int(shard_start), int(per))
    lay = _layout(lo, spans, int(per), values.device, False)
    ext = torch.cat([values, torch.full((1,), fill, dtype=values.dtype,
                                        device=values.device)])
    cols = torch.arange(lay.row, device=values.device)
    inside = cols[None, :] < lay.count[:, None]
    return torch.where(inside, ext[lay.row_value][:, None],
                       torch.full((), fill, dtype=values.dtype,
                                  device=values.device)).reshape(-1)
