"""Hang watchdog: dump forensics when no step completes in time.

The port of ``apex_tpu/trace/watchdog.py``. The failure mode crash
handlers can't see: a rank wedged inside a collective (a peer died, a
deadlock) or behind a runaway kernel never raises — the process sits in
a device wait forever and the job burns cards silently. The watchdog is
a daemon thread armed by step-completion heartbeats (``notify_step``, or
automatically via a :class:`Tracer` subscription); when ``deadline_s``
passes without one it:

- dumps every Python thread's stack (``sys._current_frames``) — the
  wedged frame names the blocking call;
- dumps the flight recorder (last N steps, in-flight span/collective)
  WITHOUT reading the device (a read queued behind the wedged stream
  would block the watchdog thread too);
- tags which ranks went silent: each rank watches itself, so the rank
  field of the dump that fired IS the silent rank.

**The main thread's wait must release the GIL**, or this thread never
runs. The waits a wedged step sits in do: on an H100 a ``Tensor.item()``
queued behind 30 s of ``torch.cuda._sleep`` (``chip_smoke.py`` phase
``crash_dumps_card``) and a gloo collective whose peer was stopped
(phase ``cluster_zombie_elastic``) both let the watchdog fire within
its poll of the deadline, so the port's step-side reads need no special
wait.

The dump is JSONL in the same trace schema
(``scripts/check_metrics_schema.py --kind trace``).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from apex_tpu_torch.trace.recorder import (FlightRecorder, _process_count,
                                           _rank, rank_path)
from apex_tpu_torch.trace.spans import Tracer

__all__ = ["HangWatchdog"]


def _thread_stacks() -> Dict[str, List[str]]:
    """Formatted stack per live thread, keyed "name (tid)"."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, List[str]] = {}
    for tid, frame in sys._current_frames().items():
        key = f"{names.get(tid, '?')} ({tid})"
        out[key] = [l.rstrip() for l in traceback.format_stack(frame)]
    return out


class HangWatchdog:
    """Fire when no step completes within ``deadline_s``.

    ::

        wd = trace.HangWatchdog(deadline_s=300, recorder=recorder,
                                path="dumps/hang.jsonl")
        wd.start()
        for i, batch in enumerate(data):
            state, loss = train_step(state, batch)
            wd.notify_step(i)            # or tracer-driven via on_step
        wd.stop()

    Fires at most once per stall (re-arms when heartbeats resume);
    ``on_fire`` (called with the dump dict) hooks alerting. The thread is
    a daemon — it never blocks interpreter exit.

    ``on_stall`` is the *escalation* hook — typically an
    :class:`apex_tpu_torch.ckpt.EscalationPolicy` — invoked AFTER the
    hang dump is written: it may save the last host checkpoint snapshot
    and hard-exit the process (``os._exit``), turning a silent wedged
    rank into a restartable failure instead of an indefinite hang. Unlike ``on_fire`` (alerting;
    exceptions swallowed), an ``on_stall`` that exits is the intended
    behavior.
    """

    def __init__(self, deadline_s: float = 300.0, *,
                 recorder: Optional[FlightRecorder] = None,
                 tracer: Optional[Tracer] = None,
                 path: Optional[str] = None,
                 on_fire: Optional[Callable[[Dict], None]] = None,
                 on_stall: Optional[Callable[[Dict], None]] = None,
                 poll_s: Optional[float] = None):
        self.deadline_s = float(deadline_s)
        self.recorder = recorder
        self.tracer = tracer
        if tracer is not None:
            tracer.subscribe(lambda st: self.notify_step(st.step))
        if path is None and recorder is not None:
            # recorder.path is already per-rank; suffixing it again
            # would double the rank tag
            root, ext = os.path.splitext(recorder.path)
            self.path = f"{root}.hang{ext or '.jsonl'}"
        else:
            self.path = rank_path(path) if path else None
        self.on_fire = on_fire
        self.on_stall = on_stall
        self.poll_s = poll_s if poll_s is not None else \
            max(self.deadline_s / 10.0, 0.05)
        self._beat = time.monotonic()
        self._last_step: Optional[int] = None
        self._fired_for_beat: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fire_count = 0
        #: early-warning tier (straggler detection): the last warning
        #: event received and how many arrived — see :meth:`early_warning`
        self.last_warning: Optional[Dict] = None
        self.warning_count = 0

    # -- heartbeat -----------------------------------------------------------

    def notify_step(self, step: Optional[int] = None) -> None:
        """Mark a completed step — re-arms the deadline (thread-safe)."""
        self._last_step = step
        self._beat = time.monotonic()

    def early_warning(self, event: Dict) -> None:
        """The tier BELOW the hard deadline: a peer subsystem (the
        straggler detector, :class:`apex_tpu_torch.trace.StragglerWatch`)
        reports degraded-but-alive progress. Records the event and
        invokes the ``on_fire`` alerting hook (tagged
        ``reason="early-warning"``) — never ``on_stall``: steps are
        still landing, so escalation (checkpoint + exit) would turn a
        slow run into a dead one. Thread-safe, never raises."""
        self.last_warning = dict(event)
        self.warning_count += 1
        if self.on_fire is not None:
            try:
                self.on_fire(dict(event, reason="early-warning"))
            except Exception:
                pass

    def lease_expired(self, event: Dict) -> None:
        """Peer-death tier: a PEER
        rank's cluster lease expired — this rank is healthy but a
        member it collectives with is dead (or paused long enough to
        be fenced as dead). Alerting-only, like :meth:`early_warning`
        (tagged ``tier="lease-expiry"``): the coordinated response —
        shrink + generation bump — belongs to the recovery layer
        (:class:`apex_tpu_torch.cluster.RecoveryCoordinator` /
        ``elastic_run``'s relaunch hygiene), not to a per-rank
        watchdog; escalating every survivor here would turn one dead
        rank into a pod-wide exit storm before the coordinator could
        agree on a checkpoint. Wire it as the ``ClusterMembership``
        caller's hook on :meth:`~apex_tpu_torch.cluster.ClusterMembership.
        expired_ranks` observations. The wedged-collective case (this
        rank BLOCKED on the dead peer) is the hard deadline's job —
        :class:`apex_tpu_torch.cluster.CollectiveDeadline` names the
        collective and does escalate."""
        self.early_warning(dict(event, tier="lease-expiry"))

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "HangWatchdog":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._beat = time.monotonic()
        self._thread = threading.Thread(
            target=self._loop, name="apex_tpu_torch.trace.watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(self.poll_s * 2, 1.0))
        self._thread = None

    def __enter__(self) -> "HangWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the watchdog loop ---------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            beat = self._beat
            idle = time.monotonic() - beat
            if idle < self.deadline_s:
                continue
            if self._fired_for_beat == beat:
                continue                    # already reported this stall
            self._fired_for_beat = beat
            try:
                self.fire(idle_s=idle)
            except Exception:
                pass          # a broken dump must not kill the daemon

    def fire(self, idle_s: Optional[float] = None) -> Dict:
        """Collect + write the hang dump (also callable manually)."""
        self.fire_count += 1
        event: Dict = {
            "kind": "watchdog", "reason": "hang",
            "rank": _rank(), "process_count": _process_count(),
            "silent_ranks": [_rank()],    # self-watch: the firing rank
            "pid": os.getpid(), "wall_time": time.time(),
            "deadline_s": self.deadline_s,
            "seconds_since_last_step": (
                idle_s if idle_s is not None
                else time.monotonic() - self._beat),
            "last_step": self._last_step,
            "last_completed_span": (
                self.recorder.last_completed_span if self.recorder
                else (self.tracer.last_completed_span
                      if self.tracer else None)),
            "in_flight_spans": (self.tracer.open_spans
                                if self.tracer is not None else []),
            "in_flight_collective": (self.tracer.in_flight_collective
                                     if self.tracer is not None else None),
            "stacks": _thread_stacks(),
        }
        if self.path:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(self.path, "w") as f:
                f.write(json.dumps(event) + "\n")
            if self.recorder is not None:
                # append the flight record to the same file for one-stop
                # forensics (ring steps after the watchdog header).
                # fetch_metrics=False: the device is by definition
                # wedged when a hang fires, and a read-back queued
                # behind it blocks forever — host-side span timings
                # still land; the metric values are the one casualty
                with open(self.path, "a") as f:
                    self.recorder.dump_records(f, event["rank"],
                                               fetch_metrics=False)
        if self.on_fire is not None:
            try:
                self.on_fire(event)
            except Exception:
                pass
        if self.on_stall is not None:
            # escalation LAST, after the hang dump is safely on disk:
            # an exit-mode policy never returns (checkpoint-save →
            # crash-dump → os._exit — the designed shrink-and-continue
            # trigger), and a raise-mode policy invoked on this daemon
            # thread completes the save/dump and records its `tripped`
            # flag instead of raising (a raise here could not unwind
            # the wedged main thread; _loop's guard would swallow it).
            self.on_stall(event)
        return event
