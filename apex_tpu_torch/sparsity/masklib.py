"""2:4 structured sparsity masks.

Port of ``apex_tpu/sparsity/masklib.py``, in plain PyTorch on any device
(the JAX version is jnp with no kernel). For every group of 4 elements
along the last dimension keep the 2 whose pattern preserves the most
magnitude. ``m4n2_1d`` searches the 6 patterns; ``m4n2_2d_greedy`` and
``m4n2_2d_best`` work per 4x4 block over the last two dims, so the mask is
2:4 along rows and columns (greedy: a descending-magnitude fill with row
and column counters; best: the 90 doubly-2:4 patterns).

The masks are decisions and must equal the JAX package's bit for bit, ties
included: a pattern's score is the sum of its kept magnitudes, rounded as
the JAX package rounds it, and the first best pattern wins (``argmax``);
the greedy fill visits entries by a stable descending sort, lower index
first among equal magnitudes. Scores are elementwise sums in a fixed
order, not a matrix product, so TF32 and a GEMM's order of summation
cannot move a tie.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch
import torch.nn.functional as F

# all C(4,2)=6 binary patterns with exactly 2 of 4 kept
_PATTERNS_4C2 = np.array(
    [p for p in itertools.product((0, 1), repeat=4) if sum(p) == 2],
    np.float32)                                    # (6, 4)


@functools.lru_cache(maxsize=None)
def _patterns_4x4_2d() -> np.ndarray:
    """The 90 4x4 binary patterns whose every row and column keeps exactly
    2 of 4, flattened to (90, 16), in the JAX package's order."""
    rows = _PATTERNS_4C2
    combos = np.stack(np.meshgrid(*([np.arange(6)] * 4),
                                  indexing="ij"), -1).reshape(-1, 4)
    pats = rows[combos]                            # (1296, 4, 4)
    valid = (pats.sum(axis=1) == 2).all(axis=1)    # column sums == 2
    return pats[valid].reshape(-1, 16).astype(np.float32)


def _best_pattern(mags, patterns):
    """Index of the first pattern with the largest score, the sum of the
    magnitudes it keeps: mags (..., k), patterns (p, k). The sum is taken
    as the JAX package's score product is on the CPU (XLA's dot): the even
    and the odd positions apart, each in index order, then the two, so the
    f32 score rounds alike and a near tie falls the same way."""
    lanes = [mags.new_zeros((*mags.shape[:-1], patterns.shape[0]))
             for _ in range(2)]
    for i in range(patterns.shape[1]):
        lanes[i % 2] = lanes[i % 2] + mags[..., i:i + 1] * patterns[:, i]
    return torch.argmax(lanes[0] + lanes[1], dim=-1)


def m4n2_1d(w) -> torch.Tensor:
    """Boolean mask, groups of 4 along the last dim, keep the best 2; tail
    elements (last dim % 4) are always kept."""
    shape = w.shape
    n = shape[-1]
    body_len = (n // 4) * 4
    body = w[..., :body_len].float().abs().reshape(*shape[:-1], n // 4, 4)
    patterns = torch.as_tensor(_PATTERNS_4C2, device=w.device)
    mask = patterns[_best_pattern(body, patterns)]
    mask = mask.reshape(*shape[:-1], body_len) > 0.5
    if body_len < n:
        tail = torch.ones((*shape[:-1], n - body_len), dtype=torch.bool,
                          device=w.device)
        return torch.cat([mask, tail], dim=-1)
    return mask


def _to_blocks(w):
    """(..., R, C) -> (N, 16) 4x4 blocks of the divisible body, and what
    undoes it; tail rows and columns stay dense."""
    *lead, r, c = w.shape
    rb, cb = (r // 4) * 4, (c // 4) * 4
    body = w[..., :rb, :cb].float()
    nlead = int(np.prod(lead)) if lead else 1
    blocks = body.reshape(nlead, rb // 4, 4, cb // 4, 4)
    blocks = blocks.transpose(2, 3).reshape(-1, 16)
    return blocks, (lead, r, c, rb, cb, nlead)


def _from_blocks(mask_flat, meta):
    lead, r, c, rb, cb, nlead = meta
    m = mask_flat.reshape(nlead, rb // 4, cb // 4, 4, 4)
    m = m.transpose(2, 3).reshape(*lead, rb, cb)
    if rb < r:
        m = torch.cat([m, m.new_ones((*lead, r - rb, cb))], dim=-2)
    if cb < c:
        m = torch.cat([m, m.new_ones((*lead, r, c - cb))], dim=-1)
    return m


def m4n2_2d_greedy(w) -> torch.Tensor:
    """Per-4x4-block greedy doubly-2:4 mask: visit the block's entries in
    descending |magnitude| (stable), keep one unless its row or column
    already keeps 2; all blocks step together through the 16 ranks."""
    if w.dim() < 2:
        return m4n2_1d(w)
    blocks, meta = _to_blocks(w)
    n = blocks.shape[0]
    order = torch.argsort(-blocks.abs(), dim=-1, stable=True)
    rowcnt = blocks.new_zeros((n, 4), dtype=torch.int32)
    colcnt = blocks.new_zeros((n, 4), dtype=torch.int32)
    mask = blocks.new_zeros((n, 16), dtype=torch.bool)
    for t in range(16):
        idx = order[:, t]
        r1 = F.one_hot(idx // 4, 4).to(torch.int32)
        c1 = F.one_hot(idx % 4, 4).to(torch.int32)
        can = (((rowcnt * r1).sum(dim=1) < 2)
               & ((colcnt * c1).sum(dim=1) < 2))
        take = can[:, None].to(torch.int32)
        rowcnt = rowcnt + r1 * take
        colcnt = colcnt + c1 * take
        mask = mask | (F.one_hot(idx, 16).to(torch.int32) * take).bool()
    return _from_blocks(mask, meta)


def m4n2_2d_best(w) -> torch.Tensor:
    """Exhaustive per-4x4-block doubly-2:4 mask: the first of the 90 valid
    patterns that keeps the most magnitude."""
    if w.dim() < 2:
        return m4n2_1d(w)
    blocks, meta = _to_blocks(w)
    pats = torch.as_tensor(_patterns_4x4_2d(), device=w.device)
    mask = pats[_best_pattern(blocks.abs(), pats)] > 0.5
    return _from_blocks(mask, meta)


_PATTERNS = {
    "m4n2_1d": m4n2_1d,
    "m4n2_2d_greedy": m4n2_2d_greedy,
    "m4n2_2d_best": m4n2_2d_best,
}


def create_mask(w, pattern: str = "m4n2_1d") -> torch.Tensor:
    """Mask for one tensor; a last dim under 4 is left dense (all True)."""
    if pattern not in _PATTERNS:
        raise ValueError(f"unknown pattern {pattern!r}; "
                         f"have {sorted(_PATTERNS)}")
    if w.shape[-1] < 4:
        return torch.ones(w.shape, dtype=torch.bool, device=w.device)
    return _PATTERNS[pattern](w)


def density(mask) -> float:
    return float(mask.float().mean())
