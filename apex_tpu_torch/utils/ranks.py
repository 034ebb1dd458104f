"""This process's rank and world size where no caller gave them.

The JAX package falls back to ``jax.process_index()`` /
``jax.process_count()``. The port reads ``torch.distributed``'s rank and
world size when a process group is initialised, else the launcher's
``RANK`` / ``WORLD_SIZE``, else 0 and 1 — each field on its own, so a
caller that passes only one of them still gets its own rank for the
other.
"""

from __future__ import annotations

import os

__all__ = ["rank_default", "world_default"]


def _group():
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist
    except Exception:
        pass
    return None


def rank_default() -> int:
    dist = _group()
    if dist is not None:
        return int(dist.get_rank())
    return int(os.environ.get("RANK", "0"))


def world_default() -> int:
    dist = _group()
    if dist is not None:
        return int(dist.get_world_size())
    return int(os.environ.get("WORLD_SIZE", "1"))
