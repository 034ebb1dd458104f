"""The arena's layout planner, in numpy.

The port's own copy of ``apex_tpu/arena/native.py``'s Python planners,
which the JAX package runs when its C++ planner is not built: the same
semantics, and no native library.
"""

from __future__ import annotations

import numpy as np


def _as_i64(arr):
    return np.ascontiguousarray(arr, dtype=np.int64)


def plan_layout(sizes, alignment):
    """(offsets, padded, total) for aligned slot layout."""
    sizes = _as_i64(sizes)
    alignment = max(int(alignment), 1)
    padded = (sizes + alignment - 1) // alignment * alignment
    offsets = (np.concatenate([[0], np.cumsum(padded)[:-1]]).astype(np.int64)
               if len(sizes) else np.zeros(0, np.int64))
    return offsets, padded, int(padded.sum())


def plan_buckets(padded, bucket_elems):
    """(bucket_ids, num_buckets) — greedy size-capped bucketing."""
    padded = _as_i64(padded)
    n = len(padded)
    bucket_elems = max(int(bucket_elems), 1)
    ids = np.zeros(n, np.int64)
    bucket = fill = 0
    for i in range(n):
        if fill > 0 and fill + padded[i] > bucket_elems:
            bucket += 1
            fill = 0
        ids[i] = bucket
        fill += int(padded[i])
    return ids, (bucket + 1 if n else 0)


def plan_shards(total_elems, world_size, alignment):
    """(shard_starts, shard_size) — equal aligned ZeRO shards."""
    alignment = max(int(alignment), 1)
    per = -(-total_elems // world_size)
    per = -(-per // alignment) * alignment
    return np.arange(world_size, dtype=np.int64) * per, int(per)
