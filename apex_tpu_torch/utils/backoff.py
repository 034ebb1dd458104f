"""Jittered exponential backoff (the port's copy of
``apex_tpu.utils.backoff``) — the one implementation every
host-side retry seam shares (ckpt shared-fs barrier/manifest/gather,
loader decode IO, elastic restart ladder).

Two properties every caller relies on:

- **de-phased**: jitter draws from ``random.SystemRandom``, never the
  seedable global RNG — N ranks that all called ``random.seed(cfg.seed)``
  for reproducibility would otherwise draw IDENTICAL "jitter" and still
  poll a shared filesystem in lockstep (the thundering herd the jitter
  exists to break), and a retry loop consuming the global stream would
  make user code after it nondeterministic in the number of
  latency-dependent draws;
- **bounded**: ``min(cap_s, base_s · 2^attempt)``, so a caller sitting
  on a latency-sensitive path (a blocking save's commit barrier on the
  main thread, where poll latency is watchdog-heartbeat latency) can
  pin the cap low while still getting exponential shape.
"""

from __future__ import annotations

import random
import time

__all__ = ["backoff_sleep"]

_jitter = random.SystemRandom()


def backoff_sleep(attempt: int, *, base_s: float = 0.02,
                  cap_s: float = 1.0) -> float:
    """Sleep ``min(cap_s, base_s · 2^attempt)`` scaled by a uniform
    [0.5, 1.5) jitter; returns the slept time."""
    t = min(cap_s, base_s * (2.0 ** attempt)) * (0.5 + _jitter.random())
    time.sleep(t)
    return t
