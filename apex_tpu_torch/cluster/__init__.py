"""apex_tpu_torch.cluster — the shared-fs cluster control plane.

The port of ``apex_tpu.cluster``; its files are the JAX package's.

Generation-fenced membership and coordinated multi-rank recovery
(docs/resilience.md#control-plane) — the dynamic complement of
the JAX package's static cross-rank congruence check. Three pieces:

- **membership & fencing** (:mod:`~apex_tpu_torch.cluster.membership`):
  per-rank lease files (the heartbeat one-file-per-rank pattern, TTL'd
  so a crash needs no cleanup) plus a monotonic **generation** epoch
  committed manifest-last; :class:`ClusterMembership` is the ``fence=``
  object :class:`apex_tpu_torch.ckpt.CheckpointManager` accepts — every
  checkpoint write/commit/delete validates its generation token against
  the committed epoch and a stale holder (a resumed zombie) is refused
  with a ``cluster_fence`` event before it can corrupt anything;
- **coordinated recovery** (:mod:`~apex_tpu_torch.cluster.coordinator`):
  :class:`RecoveryCoordinator` turns
  :class:`~apex_tpu_torch.guard.GuardPolicy`'s local rewind/escalate verdicts
  into cluster decisions — signed per-rank intents, deterministic
  resolution (oldest good step wins), a deadline-bounded barrier, and a
  generation bump fencing out stragglers of the old epoch;
  :class:`CollectiveDeadline` watches ``kind="collective"`` spans and
  distinguishes a hung collective from a slow one, feeding
  ``EscalationPolicy.trip("collective:...")``;
- **relaunch hygiene** (:func:`relaunch`): the ``elastic_run v2`` hook
  — bump the generation and garbage-collect stale lease/heartbeat
  files before a shrink-restart, so a dead rank's last heartbeat never
  reads as a "silent rank" of the new epoch.

Everything is host-side only; events are dicts handed to ``event_sink``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from apex_tpu_torch.cluster.coordinator import (CollectiveDeadline,
                                                CoordinationError,
                                                RecoveryCoordinator,
                                                RecoveryDecision,
                                                intent_path)
from apex_tpu_torch.cluster.membership import (GENERATION_PREFIX,
                                               INTENT_PREFIX,
                                               ClusterMembership,
                                               LeaseWriter,
                                               StaleGenerationError,
                                               bump_generation,
                                               cluster_token,
                                               gc_stale_intents,
                                               gc_stale_leases,
                                               generation_path, lease_path,
                                               mac_ok, read_generation,
                                               read_generation_record,
                                               read_leases, sign_payload)

__all__ = [
    "ClusterMembership", "LeaseWriter", "StaleGenerationError",
    "read_generation", "read_generation_record", "bump_generation",
    "read_leases", "lease_path", "gc_stale_leases", "gc_stale_intents",
    "mac_ok", "sign_payload", "cluster_token", "GENERATION_PREFIX", "generation_path",
    "INTENT_PREFIX",
    "RecoveryCoordinator", "RecoveryDecision", "CoordinationError",
    "CollectiveDeadline", "intent_path",
    "relaunch",
]


def relaunch(directory: str, *, reason: str = "elastic_restart",
             rank: Optional[int] = None,
             heartbeat_dir: Optional[str] = None,
             event_sink: Optional[Callable[[Dict], None]] = None) -> int:
    """Fence and clean before a restart — the ``elastic_run v2`` hook.

    Bumps the committed generation (every straggler of the previous
    attempt now fails its fence checks instead of corrupting the new
    run) and garbage-collects lease files — and, when
    ``heartbeat_dir`` is given, straggler heartbeat files — left by
    older generations (a dead rank's last heartbeat otherwise reads as
    a "silent rank" forever). Returns the new generation.

    Idempotent *per restart*, not globally: each call opens a new
    epoch, which is exactly what a relaunch means.
    """
    member = ClusterMembership(directory, rank=rank,
                               event_sink=event_sink)
    member.join()
    new = member.bump(reason)
    member.gc_stale(heartbeat_dir=heartbeat_dir)
    # the relauncher is a controller, not a member: drop its transient
    # lease so the restarted ranks join a clean table (they re-acquire
    # their own leases under the new epoch)
    member.lease.release()
    return new
