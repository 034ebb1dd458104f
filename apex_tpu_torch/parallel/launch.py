"""Multi-process bring-up: ``distributed_init`` and rank helpers.

Port of ``apex_tpu/parallel/launch.py``. :func:`distributed_init` starts
the default ``torch.distributed`` process group with the launcher's
environment conventions (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``; explicit arguments first): NCCL for ``cuda``, gloo for
``device="cpu"``. With no environment and no arguments it does nothing,
as a reference script run without the launcher.

:func:`elastic_run` is the restart-on-smaller-world loop, fenced through
:mod:`apex_tpu_torch.cluster` when given a cluster directory.
:func:`enable_crash_dumps` is the one-call forensics bring-up: a tracer,
a per-rank flight recorder with its handlers installed, and optionally a
hang watchdog and a collective deadline.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["distributed_init", "is_distributed", "process_index",
           "process_count", "maybe_print", "enable_crash_dumps",
           "elastic_run", "shrink_schedule"]


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     init_method: Optional[str] = None, device="cuda",
                     timeout_s: Optional[float] = None) -> None:
    """Start the default process group, tolerating the launcher's env.

    Per field: the argument, else ``MASTER_ADDR:MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``. ``coordinator_address`` ("host:port")
    becomes ``init_method="tcp://host:port"``; ``init_method`` may be
    given instead (``file://``, ``tcp://``). The backend is NCCL for a
    ``cuda`` device, whose index (``LOCAL_RANK``, else the rank modulo the
    cards present) becomes the group's ``device_id``, and gloo for
    ``cpu``. Single process (no env, no args) and a second call are
    no-ops."""
    if dist.is_initialized():
        return
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        port = os.environ.get("MASTER_PORT", "1234")
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{port}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if (coordinator_address is None and init_method is None
            and num_processes is None and process_id is None):
        return                          # single process: nothing to start
    if init_method is None:
        if coordinator_address is None:
            raise ValueError("distributed_init needs coordinator_address, "
                             "init_method or MASTER_ADDR")
        init_method = f"tcp://{coordinator_address}"
    rank = process_id if process_id is not None else 0
    device = torch.device(device)
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if device.type == "cuda":
        index = device.index
        if index is None:
            index = int(os.environ.get(
                "LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(index)
        kwargs["device_id"] = torch.device("cuda", index)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=init_method,
        world_size=num_processes if num_processes is not None else 1,
        rank=rank, **kwargs)


def enable_crash_dumps(path: str = "apex_tpu_crash.jsonl", *,
                       capacity: int = 64,
                       hang_deadline_s: Optional[float] = None,
                       escalation=None,
                       collective_deadline_s: Optional[float] = None,
                       membership=None):
    """One-call forensics bring-up for (multi-process) launches.

    Builds a :class:`apex_tpu_torch.trace.Tracer`, a per-rank
    :class:`~apex_tpu_torch.trace.FlightRecorder` (``path`` gets
    ``trace.rank_path`` applied on multi-process runs) with the
    excepthook/SIGTERM/atexit handlers installed — so call it from the
    main thread — and, when ``hang_deadline_s`` is set, a started
    :class:`~apex_tpu_torch.trace.HangWatchdog`. Call after
    :func:`distributed_init` so the rank is the process group's.

    ``escalation`` (an :class:`apex_tpu_torch.ckpt.EscalationPolicy`)
    wires recovery on top of the forensics: SIGTERM saves the last host
    checkpoint snapshot before the dump, a watchdog stall escalates to
    checkpoint-save → crash-dump → exit 75, and the policy's own dump
    goes to this recorder (``escalation.recorder``, unless it has one).

    ``collective_deadline_s`` adds a started
    :class:`apex_tpu_torch.cluster.CollectiveDeadline` polling the
    tracer's open ``kind="collective"`` spans: one still open past the
    deadline is *hung*, not slow, and trips
    ``escalation.trip("collective:<span>")``. ``membership`` (a
    :class:`apex_tpu_torch.cluster.ClusterMembership`) tags its events
    with the current generation.

    Returns ``(tracer, recorder, watchdog-or-None,
    collective-deadline-or-None)`` — a fixed shape whichever tiers are
    on; enter the tracer around the train loop and wrap steps in
    ``trace.step()`` / ``trace.span`` so dumps carry span timelines.
    """
    from apex_tpu_torch import trace
    tracer = trace.Tracer()
    recorder = trace.FlightRecorder(path, capacity=capacity, tracer=tracer,
                                    escalation=escalation).install()
    if escalation is not None and getattr(escalation, "recorder",
                                          None) is None:
        escalation.recorder = recorder
    watchdog = None
    if hang_deadline_s:
        watchdog = trace.HangWatchdog(
            hang_deadline_s, recorder=recorder, tracer=tracer,
            on_stall=escalation).start()
    deadline = None
    if collective_deadline_s:
        from apex_tpu_torch.cluster import CollectiveDeadline
        deadline = CollectiveDeadline(
            tracer, deadline_s=collective_deadline_s,
            escalation=escalation,
            event_sink=getattr(membership, "event_sink", None),
            generation=(membership.refresh if membership is not None
                        else None)).start()
    return tracer, recorder, watchdog, deadline


def elastic_run(train_fn, *, world_sizes, max_restarts: Optional[int] = None,
                escalation_exit_codes=(75,),
                restart_backoff_s: float = 0.0,
                restart_backoff_cap_s: float = 60.0,
                cluster_dir: Optional[str] = None,
                heartbeat_dir: Optional[str] = None,
                event_sink=None):
    """Restart-on-smaller-world: the single-controller recovery loop (the
    port of ``apex_tpu.parallel.launch.elastic_run``).

    ``train_fn(world, attempt)`` runs the job on ``world`` processes or
    cards (restoring from the latest committed checkpoint itself —
    ``ckpt.CheckpointManager.restore`` re-partitions ZeRO state to any
    world). A completed call returns its result; an escalation —
    :class:`apex_tpu_torch.ckpt.PreemptionError`, or ``SystemExit`` with a
    code in ``escalation_exit_codes`` (a ``train_fn`` that runs ranks as
    subprocesses raises ``SystemExit(75)`` when one exits with
    :data:`apex_tpu_torch.ckpt.ESCALATION_EXIT_CODE`) — shrinks to the next
    size and continues. Any other exception propagates. ``max_restarts``
    bounds the restarts.

    ``restart_backoff_s`` > 0 sleeps a jittered exponential delay
    (``backoff · 2^(attempt-1)``, capped at ``restart_backoff_cap_s``,
    x[0.5, 1.5) jitter) before each relaunch, so controllers escalating at
    once do not re-attach in lockstep.

    ``cluster_dir`` fences every restart: before it, the loop reports the
    lease-expired (dead) ranks, and :func:`apex_tpu_torch.cluster.relaunch`
    commits the next generation (every straggler of the failed attempt is
    then refused by the checkpoint fence) and garbage-collects stale
    leases, intents and, with ``heartbeat_dir``, heartbeat files.
    ``event_sink`` receives the hygiene pass's events.
    """
    from apex_tpu_torch.ckpt import PreemptionError
    from apex_tpu_torch.utils.backoff import backoff_sleep
    sizes = list(world_sizes)
    if not sizes:
        raise ValueError("world_sizes must name at least one mesh size")
    i, attempt = 0, 0
    while True:
        world = sizes[i]
        try:
            return train_fn(world, attempt)
        except PreemptionError as e:
            maybe_print(f"apex_tpu_torch.elastic: escalated on world={world} "
                        f"({e.reason}); shrinking", rank0=True)
        except SystemExit as e:
            if e.code not in escalation_exit_codes:
                raise
            maybe_print(f"apex_tpu_torch.elastic: exit code {e.code} on "
                        f"world={world}; shrinking", rank0=True)
        attempt += 1
        if max_restarts is not None and attempt > max_restarts:
            raise RuntimeError(
                f"elastic_run: {attempt} restarts exhausted "
                f"max_restarts={max_restarts}")
        if i + 1 < len(sizes):
            i += 1
        else:
            raise RuntimeError(
                f"elastic_run: escalated at the smallest mesh size "
                f"{sizes[-1]} — no capacity left to shrink to")
        # back off only before an actual relaunch
        if restart_backoff_s > 0:
            backoff_sleep(attempt - 1, base_s=restart_backoff_s,
                          cap_s=restart_backoff_cap_s)
        if cluster_dir is not None:
            # fence + clean BEFORE the relaunch. The controller only
            # observes the lease table: join() would overwrite a dead
            # rank's lease with its own and drop it from the report
            from apex_tpu_torch import cluster as _cluster
            member = _cluster.ClusterMembership(cluster_dir,
                                                event_sink=event_sink)
            dead = member.expired_ranks()
            if dead:
                maybe_print(f"apex_tpu_torch.elastic: lease-expired ranks "
                            f"{dead} (dead members of the failed attempt)",
                            rank0=True)
            gen = _cluster.relaunch(
                cluster_dir, reason=f"elastic_restart:{attempt}",
                heartbeat_dir=heartbeat_dir, event_sink=event_sink)
            maybe_print(f"apex_tpu_torch.elastic: relaunching under "
                        f"generation {gen}", rank0=True)


def shrink_schedule(world: int, *, min_world: int = 1,
                    factor: int = 2) -> list:
    """The default mesh-shrink ladder: ``world, world//factor, ...`` down
    to ``min_world``."""
    if int(factor) < 2:
        raise ValueError(f"shrink factor must be >= 2, got {factor} "
                         f"(factor 1 would never shrink)")
    out, w = [], int(world)
    while w >= max(int(min_world), 1):
        out.append(w)
        if w == 1:
            break
        w //= int(factor)
    return out


def is_distributed() -> bool:
    return process_count() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


#: print verbosity (``_amp_state.verbosity``): 0 silences maybe_print
verbosity = 1


def maybe_print(msg: str, rank0: bool = False) -> None:
    """Verbosity- and rank-aware print."""
    if verbosity <= 0:
        return
    if rank0 and process_index() != 0:
        return
    print(msg)
