"""Reductions over the flat arena: the global L2 norm (a Triton kernel) and
the per-tensor norms and spreads of the LAMB trust ratio (plain PyTorch).

Port of ``apex_tpu/ops/multi_tensor.py``. Kernel replaced:

- ``l2norm_kernel`` ← ``_l2norm_kernel`` (``multi_tensor_l2norm``'s launch
  through ``_dispatch.launch``): ‖x‖₂ of a flat arena buffer, f32 sums.

What bounds it on an H100: bytes, one read of the buffer (4N bytes for
an f32 buffer of N elements) and a handful of flops per element. The TPU
kernel adds every block into one SMEM scalar, relying on its grid running
in order; on Hopper blocks run in no order. So the reduction has two
deterministic stages and no float atomics: a fixed number of programs
each walk every ``_L2_PROGRAMS``-th block of the buffer and write one f32
partial of Σx², then one program sums the partials and takes the root.
The clip factor LAMB computes from it is the same from run to run.

The per-tensor functions take the arena's static ranges. They reduce
rows (up to ``_ROW`` wide) of the buffer in one pass and sum each
tensor's rows with one segmented reduction, so their launch count does
not grow with the number of tensors (a loop of per-tensor slices would
put back the launch-bound per-tensor update the arena exists to avoid).
That needs the arena's layout: slot starts on row boundaries and zero
padding after each tensor, which :func:`apex_tpu_torch.arena.flatten`
guarantees (and an update direction ``u`` computed from zero padding is
zero there too). The scale, axpby and max-norm kernels of the JAX module
are not ported yet.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from apex_tpu_torch.ops import _arena, _build

tl = None  # triton.language, bound by _build.triton_jit at the first launch

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)
_L2_PROGRAMS = 1024      # stage-1 programs: every SM holds several
_L2_BLOCK = 4096         # elements per program per step; divides 65536
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


def l2norm_kernel(buf):
    """Triton ‖buf‖₂ (f32 0-d tensor) of a flat CUDA arena buffer."""
    n = _arena.check_buffers(buf, dtypes=_FLOATS)
    part = torch.empty(_L2_PROGRAMS, dtype=torch.float32, device=buf.device)
    out = torch.empty((), dtype=torch.float32, device=buf.device)
    _build.triton_jit(_l2norm_partials_triton)[(_L2_PROGRAMS,)](
        buf, part, n // _L2_BLOCK, BLOCK=_L2_BLOCK, PROGRAMS=_L2_PROGRAMS,
        num_warps=8)
    _build.triton_jit(_l2norm_finish_triton)[(1,)](
        part, out, PROGRAMS=_L2_PROGRAMS, num_warps=4)
    l2norm_kernel.launches += 1
    return out


l2norm_kernel.launches = 0


def l2norm_plain(buf):
    return torch.sqrt(torch.sum(torch.square(buf.float())))


def multi_tensor_l2norm(buf):
    """Global L2 norm of a flat arena buffer (f32 accumulate), as a 0-d f32
    tensor on the buffer's device."""
    _arena.check_length(buf)
    if buf.is_cuda:
        return l2norm_kernel(buf)
    return l2norm_plain(buf)


# --- per-tensor norms and spreads over static ranges ---------------------------

class _Layout(NamedTuple):
    row: int                  # row width in elements
    lengths: torch.Tensor     # rows of every segment (tensors and gaps)
    pick: torch.Tensor        # segment index of each tensor
    row_value: torch.Tensor   # per row: its tensor's index, or n for a gap


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
        cur = end
    if rows > cur:
        lengths.append(rows - cur)
        values.append(len(offsets))
    as_dev = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                       device=device)
    return _Layout(row, as_dev(lengths), as_dev(pick),
                   as_dev(np.repeat(values, lengths)))


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
