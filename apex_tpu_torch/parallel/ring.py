"""Ring and Ulysses attention: sequence (context) parallelism.

Port of ``apex_tpu/parallel/ring.py``. Two schemes over a sequence axis of
the bound mesh (``use_mesh``):

- :func:`ring_attention`: q, k, v sharded on the sequence; k and v rotate
  around the ring (``collectives.ppermute``, one send/recv pair a hop) and
  each rank merges the blockwise partial (out, lse) pairs in log space.
  Each block is the port's flash attention with a differentiable lse, so
  autograd derives the reverse ring (the backward of a permute is the
  inverse permute): no hand-written backward.
- :func:`ulysses_attention`: an all-to-all turns sequence-sharded q, k, v
  into head-sharded ones over the whole sequence, flash attention runs
  locally, and a second all-to-all restores the sequence sharding.

Causality across shards rides the kernels' ``causal_offset``: query i
attends key j iff ``i + offset >= j`` with ``offset = my·sq − src·sk``,
handed to the kernel as an int32 tensor on the device, so no O(S²) mask
is built. Under dropout each hop shifts the dropout hash's block
coordinates by its ring position (``dropout_block_offset = [my·nqb,
src·nkb]`` in 512-blocks), so the mask is, bit for bit, the one a single
device draws for the gathered sequence.

Collectives run under the registry's ``ring_*`` scopes (``ring_ppermute``,
``ring_all_to_all``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.ops.attention import (DROPOUT_TILE, flash_attention,
                                          flash_attention_lse)
from apex_tpu_torch.parallel import collectives
from apex_tpu_torch.parallel.mesh import resolve_group

NEG_INF = -1e30
PERMUTE_SCOPE = "ring_ppermute"
ALL_TO_ALL_SCOPE = "ring_all_to_all"


def _merge(o, lse, o_i, lse_i):
    """Merge normalised partial attention (out (B, S, H, D), lse (B, H, S))
    pairs in log space. A 16-bit ``o`` times the f32 weights promotes to
    f32, as in JAX."""
    lse_c = torch.logaddexp(lse, lse_i)
    w = torch.exp(lse - lse_c)
    w_i = torch.exp(lse_i - lse_c)

    def expand(t):                       # (B, H, S) -> (B, S, H, 1)
        return t.transpose(1, 2)[..., None]

    return o * expand(w) + o_i * expand(w_i), lse_c


def ring_attention(q, k, v, axis_name: str, causal: bool = False,
                   scale: Optional[float] = None,
                   dropout_rate: float = 0.0, dropout_seed=None):
    """Blockwise-exact attention over a sequence-sharded ring.

    q, k, v: (B, S_local, H, D), this rank's shard of the sequence on
    ``axis_name`` (the global sequence is the shards in axis order).
    Returns the local output shard (B, S_local, H, D): in q's dtype at
    axis size 1 (no merge runs), in f32 above it (the merge promotes).

    With ``dropout_rate > 0`` the softmax dropout mask is bit for bit the
    single-device mask of the gathered sequence for the same seed. That
    needs local shard lengths that are multiples of the 512 dropout tile;
    anything else raises rather than drawing another mask. The log-space
    merge stays exact under dropout: the partial outputs carry the
    dropped probabilities and lse the undropped normaliser."""
    group = resolve_group(axis_name)
    world = dist.get_world_size(group)
    my = dist.get_rank(group)
    sq, sk = q.shape[1], k.shape[1]
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        if sq % DROPOUT_TILE or sk % DROPOUT_TILE:
            raise ValueError(
                f"ring dropout needs local shard lengths that are "
                f"multiples of the {DROPOUT_TILE} dropout tile (got "
                f"Sq={sq}, Sk={sk}): the mask is a function of the "
                f"global block decomposition and would not match the "
                f"single-device mask")
    nqb, nkb = sq // DROPOUT_TILE, sk // DROPOUT_TILE
    perm = [(i, (i + 1) % world) for i in range(world)]

    def device_int32(values):
        return torch.tensor(values, dtype=torch.int32, device=q.device)

    def block(kv_k, kv_v, src):
        kw = {}
        if dropout_rate > 0.0:
            kw = dict(dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                      dropout_block_offset=device_int32(
                          [my * nqb, src * nkb]))
        if causal:
            return flash_attention_lse(
                q, kv_k, kv_v, scale=scale, causal=True,
                causal_offset=device_int32(my * sq - src * sk), **kw)
        return flash_attention_lse(q, kv_k, kv_v, scale=scale, **kw)

    o, lse = block(k, v, my)
    cur_k, cur_v = k, v
    for step in range(1, world):
        cur_k = collectives.ppermute(cur_k, perm, group, PERMUTE_SCOPE)
        cur_v = collectives.ppermute(cur_v, perm, group, PERMUTE_SCOPE)
        src = (my - step) % world
        o_i, lse_i = block(cur_k, cur_v, src)
        if causal and src > my:
            # the whole block lies past every query's frontier: its rows
            # see no key (lse -1e30 already); merging it is a no-op
            lse_i = torch.full_like(lse_i, NEG_INF)
        o, lse = _merge(o, lse, o_i, lse_i)
    return o


def _split_to_rows(t, dim, world):
    """(world, ...): ``t`` split into ``world`` chunks along ``dim``, chunk
    i as row i."""
    shape = list(t.shape)
    shape[dim:dim + 1] = [world, shape[dim] // world]
    return t.reshape(shape).movedim(dim, 0).contiguous()


def _rows_to_dim(rows, dim):
    """Inverse of :func:`_split_to_rows` with the rows concatenated along
    ``dim`` (of the result without the row axis)."""
    t = rows.movedim(0, dim)
    shape = list(t.shape)
    shape[dim:dim + 2] = [shape[dim] * shape[dim + 1]]
    return t.reshape(shape)


def ulysses_attention(q, k, v, axis_name: str, causal: bool = False,
                      scale: Optional[float] = None,
                      dropout_rate: float = 0.0, dropout_seed=None):
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism: (sequence
    shard, all heads) -> (whole sequence, H/W heads), local flash
    attention, and back. Needs H divisible by the axis size.

    Softmax dropout is refused: after the head re-shard the kernels' mask
    coordinate for a (batch, head) row is ``b·(H/W) + h_local``, where the
    single-device mask hashes ``b·H + h``; no offset repairs the stride
    change, so the mask would silently differ from the single-device
    model's."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "ulysses_attention does not support softmax dropout: after "
            "the all-to-all head re-shard the kernels' batch-head mask "
            "coordinate is local (b*H_local + h_local, stride H_local) "
            "while the single-device mask hashes b*H + h_global (stride "
            "H) — the masks would silently diverge from the "
            "single-device model. Use ring_attention(q, k, v, "
            f"{axis_name!r}, dropout_rate={dropout_rate}, "
            "dropout_seed=...) instead: its sequence-block offsets keep "
            "the mask bitwise-identical to the single-device kernel "
            "(docs/parallel.md#ulysses-dropout).")
    del dropout_seed
    group = resolve_group(axis_name)
    world = dist.get_world_size(group)
    h = q.shape[2]
    if h % world:
        raise ValueError(f"heads {h} not divisible by axis size {world}")

    def scatter_heads(t):            # (B, S/w, H, D) -> (B, S, H/w, D)
        rows = collectives.all_to_all_rows(_split_to_rows(t, 2, world),
                                           group, ALL_TO_ALL_SCOPE)
        return _rows_to_dim(rows, 1)

    def gather_heads(t):             # (B, S, H/w, D) -> (B, S/w, H, D)
        rows = collectives.all_to_all_rows(_split_to_rows(t, 1, world),
                                           group, ALL_TO_ALL_SCOPE)
        return _rows_to_dim(rows, 2)

    qf, kf, vf = map(scatter_heads, (q, k, v))
    of = flash_attention(qf, kf, vf, causal=causal, scale=scale)
    return gather_heads(of)
