"""Flat parameter arena: the substrate of the fused optimizer kernels.

Port of ``apex_tpu/arena/arena.py``. Every tensor of a ``{name: tensor}``
dict gets an aligned slot in one flat 1-D buffer per dtype, so that one
kernel launch updates a whole dtype partition of the model instead of a
few launches per tensor.

The layout is the JAX package's: partitions are keyed by the dtype's name
(``"bfloat16"``, ``"float16"``, ``"float32"``) and sorted by it, slots are
``DEFAULT_ALIGNMENT``-aligned, padding is zero, and every buffer is padded
to a multiple of ``BUFFER_MULTIPLE``. Leaves are taken in the dict's
order (the JAX package takes ``jax.tree_util``'s sorted-key order), so the
same model can have other offsets in the two packages; compare them per
tensor after :func:`unflatten`.

    spec = arena.plan(params)                 # static layout, cached
    flat = arena.flatten(params, spec)        # {dtype name: 1-D buffer}
    params2 = arena.unflatten(flat, spec)     # views of ``flat``
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from apex_tpu_torch.arena import native

# Default slot alignment in elements (the JAX package's 8 x 128 tile). The
# per-tensor norms (``ops.multi_tensor``) reduce 1024-wide rows of it.
DEFAULT_ALIGNMENT = 1024

# Every buffer's length is a multiple of this; the arena kernels take only
# such buffers, as the JAX package's launcher does.
BUFFER_MULTIPLE = 512 * 128


def dtype_name(dtype) -> str:
    """The JAX package's name of a dtype: ``torch.bfloat16`` -> ``"bfloat16"``
    (numpy dtypes and names pass through)."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class _Partition:
    """Layout of one dtype's flat buffer (all entries static Python ints)."""
    dtype: str
    sizes: Tuple[int, ...]     # true element counts, leaf order
    offsets: Tuple[int, ...]   # aligned slot starts
    padded: Tuple[int, ...]    # aligned slot sizes
    total: int                 # sum of padded slot sizes
    buffer_len: int            # total rounded up to BUFFER_MULTIPLE
    leaves: Tuple[int, ...]    # index in ``ArenaSpec.names`` of each slot


@dataclasses.dataclass(frozen=True)
class ArenaSpec:
    """Static arena layout of one ``{name: tensor}`` dict."""
    names: Tuple[str, ...]
    leaf_shapes: Tuple[Tuple[int, ...], ...]
    leaf_dtypes: Tuple[str, ...]
    leaf_partition: Tuple[Tuple[str, int], ...]  # (dtype key, index in part.)
    partitions: Tuple[_Partition, ...]
    alignment: int

    @property
    def dtypes(self):
        return tuple(p.dtype for p in self.partitions)

    def partition(self, dtype) -> _Partition:
        key = dtype_name(dtype)
        for p in self.partitions:
            if p.dtype == key:
                return p
        raise KeyError(f"no arena partition for dtype {key}")

    @property
    def total_elements(self) -> int:
        return sum(p.total for p in self.partitions)


def plan(tree, alignment: int = DEFAULT_ALIGNMENT) -> ArenaSpec:
    """The static arena layout of a ``{name: tensor}`` dict (any leaves
    with ``.shape`` and ``.dtype``, numpy arrays too).

    Cached per (names, shapes, dtypes, alignment): an eager step plans
    once, not once per call.
    """
    names = tuple(tree)
    shapes = tuple(tuple(int(d) for d in x.shape) for x in tree.values())
    dtypes = tuple(dtype_name(x.dtype) for x in tree.values())
    return _plan(names, shapes, dtypes, int(alignment))


@functools.lru_cache(maxsize=64)
def _plan(names, shapes, dtypes, alignment) -> ArenaSpec:
    by_dtype: Dict[str, list] = {}
    for i, dt in enumerate(dtypes):
        by_dtype.setdefault(dt, []).append(i)

    partitions = []
    leaf_partition: list = [None] * len(names)
    for dt in sorted(by_dtype):
        idxs = by_dtype[dt]
        sizes = np.array([int(np.prod(shapes[i])) if shapes[i] else 1
                          for i in idxs], np.int64)
        offsets, padded, total = native.plan_layout(sizes, alignment)
        buffer_len = -(-int(total) // BUFFER_MULTIPLE) * BUFFER_MULTIPLE
        partitions.append(_Partition(
            dtype=dt, sizes=tuple(int(s) for s in sizes),
            offsets=tuple(int(o) for o in offsets),
            padded=tuple(int(p) for p in padded), total=int(total),
            buffer_len=buffer_len, leaves=tuple(idxs)))
        for j, i in enumerate(idxs):
            leaf_partition[i] = (dt, j)

    return ArenaSpec(names=names, leaf_shapes=shapes, leaf_dtypes=dtypes,
                     leaf_partition=tuple(leaf_partition),
                     partitions=tuple(partitions), alignment=alignment)


def flatten(tree, spec: ArenaSpec, cast=None) -> Dict[str, torch.Tensor]:
    """Pack a ``{name: tensor}`` dict into per-dtype flat buffers.

    One ``torch.cat`` per partition over the leaves and zero pads (views
    of one zeros tensor), so the copy takes a few launches, not one per
    tensor. Padding is zero, so reductions over a raw buffer (l2 norms,
    finiteness checks) need no mask.

    ``cast`` re-types every buffer (``cast=torch.float32`` flattens f32
    grads in the *param* dict's layout); buffers stay keyed by the
    partition's own dtype name so they line up slot for slot with the
    param buffers.
    """
    if set(tree) != set(spec.names) or len(tree) != len(spec.names):
        raise ValueError("tree and arena spec name different tensors")
    out = {}
    for part in spec.partitions:
        leaves = [tree[spec.names[i]] for i in part.leaves]
        dtype = cast if cast is not None else leaves[0].dtype
        gaps = [pd - s for pd, s in zip(part.padded, part.sizes)]
        tail = part.buffer_len - part.total
        zeros = torch.zeros(max(gaps + [tail]), dtype=dtype,
                            device=leaves[0].device)
        pieces = []
        for x, gap in zip(leaves, gaps):
            pieces.append(x.reshape(-1).to(dtype))
            if gap:
                pieces.append(zeros[:gap])
        if tail:
            pieces.append(zeros[:tail])
        out[part.dtype] = torch.cat(pieces)
    return out


def unflatten(buffers: Dict[str, torch.Tensor], spec: ArenaSpec):
    """Exact inverse of :func:`flatten`, with no copy: every returned
    tensor is a view of its partition's buffer, so it aliases it (writing
    to one writes to the other)."""
    out = {}
    for name, shape, (dt, j) in zip(spec.names, spec.leaf_shapes,
                                    spec.leaf_partition):
        part = spec.partition(dt)
        off = part.offsets[j]
        out[name] = buffers[dt][off:off + part.sizes[j]].view(shape)
    return out


def zeros(spec: ArenaSpec, dtype=None, device=None) -> Dict[str, torch.Tensor]:
    """Fresh zeroed arena buffers (optimizer-state allocation).

    With ``dtype`` set, every partition's buffer takes that dtype (f32
    moments for a bf16 param partition).
    """
    return {p.dtype: torch.zeros(
        p.buffer_len, device=device,
        dtype=dtype if dtype is not None else getattr(torch, p.dtype))
        for p in spec.partitions}


@functools.lru_cache(maxsize=128)
def segment_ids(spec: ArenaSpec, dtype) -> np.ndarray:
    """Host-side i32 map arena position -> tensor index in the partition
    (-1 in padding). Cached per (spec, dtype); treat it as read-only."""
    part = spec.partition(dtype)
    ids = np.full((part.buffer_len,), -1, np.int32)
    for j, (off, size) in enumerate(zip(part.offsets, part.sizes)):
        ids[off:off + size] = j
    ids.setflags(write=False)
    return ids


def valid_mask(spec: ArenaSpec, dtype) -> np.ndarray:
    """Host-side bool mask of non-padding positions."""
    return segment_ids(spec, dtype) >= 0
