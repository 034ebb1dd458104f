"""Bit-pattern reinterpretation: the one dtype-width table the bit-exact
seams share (the integrity fingerprint's fold, the repair broadcast and
the checkpoint format's extension dtypes must agree on how a leaf's bits
are read, so the table lives once).

The port's copy of ``apex_tpu.utils.bits``. ``torch`` has views for every
width, but few operations on its unsigned types, so the fold reads a
leaf's bits through :func:`uint_lanes`: int64 tensors holding the unsigned
32-bit lanes, on which every operation it needs exists on the CPU and the
card.
"""

from __future__ import annotations

import torch

__all__ = ["uint_view_dtype", "uint_lanes", "MASK32"]

#: the low 32 bits of an int64
MASK32 = 0xFFFFFFFF


def uint_view_dtype(dtype: torch.dtype) -> torch.dtype:
    """The integer dtype whose view reinterprets ``dtype``'s bit pattern:
    width-matched for 1- and 2-byte types (``uint8``, ``int16``: read its
    bits as unsigned with ``& 0xFFFF``); 4- and 8-byte types get ``int32``,
    so an 8-byte element becomes a pair of 32-bit lanes, low half first
    (little-endian, as the JAX package's bitcast gives them)."""
    return {1: torch.uint8, 2: torch.int16}.get(dtype.itemsize, torch.int32)


def uint_lanes(flat: torch.Tensor, out=None) -> torch.Tensor:
    """The unsigned 32-bit lanes of a 1-D tensor's elements as int64, in
    the JAX package's fold order (``apex_tpu.guard.integrity._leaf_bits``):
    a float's bits zero-extended, a bool as 0/1, an integer of at most 4
    bytes sign-extended and taken mod 2^32, an 8-byte element as its two
    32-bit halves. ``out`` (int64, long enough) receives them in place.
    Raises TypeError for a dtype it cannot read exactly."""
    dt = flat.dtype
    if dt.is_complex:
        raise TypeError(
            f"fingerprint_tree cannot fold dtype {dt} bit-exactly: a leaf "
            f"the fold skipped would be undetectable (and unrepaired); "
            f"exclude it from the fingerprinted subtree")
    mask = MASK32
    if dt == torch.bool:
        src, mask = flat, None
    elif dt.itemsize == 8:
        src = flat.contiguous().view(torch.int32)
    elif dt.is_floating_point:
        src = flat.contiguous().view(uint_view_dtype(dt))
        mask = (1 << (8 * dt.itemsize)) - 1
    else:
        src = flat
    lanes = (torch.empty(src.numel(), dtype=torch.int64, device=src.device)
             if out is None else out[:src.numel()])
    lanes.copy_(src)
    return lanes if mask is None else lanes.bitwise_and_(mask)
