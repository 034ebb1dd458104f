"""Elastic restore: re-partition ZeRO shards for a different world size.

The port of ``apex_tpu.ckpt.elastic``. The ZeRO arena layout makes
elasticity *arithmetic* instead of a migration: a slot buffer's logical
content is its first ``buffer_len`` elements (the padding — and
everything the optimizer ever writes past it — is identically zero), and
the only world-size dependence is the trailing padding
``_padded_len(buffer_len, world)`` that makes the buffer divide into
aligned shards. So resuming on a different world is::

    gather (by manifest)  →  truncate to buffer_len  →
    re-pad to _padded_len(buffer_len, new_world)     →
    take this rank's shard

— bitwise-exact: every logical element is a copy, every padding element
is zero on both sides.

In the port a rank's ``ShardedOptState`` holds its own shard of each slot
buffer as a local tensor; the checkpoint writes it as a chunk of the
global buffer (``[rank · per, (rank + 1) · per)``), which is how the JAX
package's multi-process arrays are written too. :func:`zero_layout`
computes the ``path → buffer_len`` map the manifest records by walking
the state for ``ShardedOptState`` nodes and joining their slot dict keys
(the partition dtype names) against the arena plan of the params.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from apex_tpu_torch.optim.distributed import (ShardedOptState,
                                              partition_lengths)

__all__ = ["partition_lengths", "repartition_flat", "zero_layout"]


def repartition_flat(buf: torch.Tensor, logical_len: int,
                     new_total: int) -> torch.Tensor:
    """Re-partition one gathered flat ZeRO buffer to a new padded total.

    ``buf`` is the full gathered buffer from the old world (length
    ``_padded_len(logical_len, old_world)``), ``logical_len`` the arena
    partition's ``buffer_len``, ``new_total`` the target length
    (``_padded_len(logical_len, new_world)``). Truncate + zero-pad;
    content is never resampled."""
    if buf.dim() != 1:
        raise ValueError(f"ZeRO slot buffers are 1-D, got {tuple(buf.shape)}")
    if logical_len > buf.shape[0]:
        raise ValueError(
            f"saved buffer ({buf.shape[0]}) shorter than its recorded "
            f"logical length ({logical_len}) — corrupt manifest?")
    if new_total < logical_len:
        raise ValueError(
            f"target length {new_total} cannot hold the {logical_len} "
            f"logical elements — the new world's shard alignment should "
            f"only ever grow the padded total")
    logical = buf[:logical_len]
    if new_total == logical_len:
        return logical
    out = torch.zeros((new_total,), dtype=buf.dtype, device=buf.device)
    out[:logical_len] = logical
    return out


def _zero_nodes(tree, prefix=""):
    """``(path, ShardedOptState)`` pairs of ``tree``, in the
    ``snapshot.tree_paths`` spelling."""
    if isinstance(tree, ShardedOptState):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _zero_nodes(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _zero_nodes(getattr(tree, f), f"{prefix}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _zero_nodes(v, f"{prefix}[{i}]")


def zero_layout(state: Any, params: Any = None,
                spec: Any = None) -> Dict[str, int]:
    """``path → logical_len`` for every ZeRO slot-buffer leaf in ``state``
    (empty when the state holds no ``ShardedOptState`` — a replicated
    checkpoint needs no elasticity metadata).

    Pass the ``params`` the optimizer was initialized from (or a prebuilt
    ``arena.ArenaSpec``) so the slot dict's dtype keys resolve to
    partition lengths."""
    found = list(_zero_nodes(state))
    if not found:
        return {}
    if spec is None:
        if params is None:
            raise ValueError(
                "state contains ZeRO-sharded optimizer state; pass "
                "params= (or spec=) so the checkpoint can record each "
                "slot buffer's logical length for elastic restore")
        from apex_tpu_torch import arena
        spec = arena.plan(params)
    lengths = partition_lengths(spec)
    out: Dict[str, int] = {}
    for prefix, sos in found:
        for slot, bufs in sos.slots.items():
            for dt in bufs:
                if dt in lengths:
                    out[f"{prefix}.slots[{slot!r}][{dt!r}]"] = lengths[dt]
    return out
