"""Fault escalation: silent rank → checkpoint-save → crash-dump → exit.

The port of ``apex_tpu.ckpt.escalate``. The failure mode this closes: a
peer host dies, this rank wedges inside a collective, and the job burns
cards silently forever — no exception, no SIGTERM, nothing for a flight
recorder to hook. A hang watchdog *detects* that state; an
:class:`EscalationPolicy` wired into its ``on_stall`` turns detection
into recovery:

1. **checkpoint**: durably commit the newest already-fetched host
   snapshot (``CheckpointManager.save_last_snapshot`` — zero device
   interaction, so the wedged runtime cannot block it);
2. **crash dump**: ``recorder.dump(reason=...)`` of the
   :class:`apex_tpu_torch.trace.FlightRecorder` (or any object with
   ``dump``) passed as ``recorder=`` — ``parallel.enable_crash_dumps(
   escalation=)`` wires its own;
3. **exit nonzero**: ``os._exit(exit_code)`` — deliberately not
   ``sys.exit``: a normal interpreter teardown would block on the
   wedged runtime's atexit hooks, which is exactly the hang being
   escaped. Default code 75 (``EX_TEMPFAIL``: transient, retry) is what
   an elastic launcher recognizes as shrink-and-continue.

The same policy handles *graceful* preemption: call :meth:`on_preempt`
from a SIGTERM handler the caller installs, and the snapshot checkpoint
commits before the process goes::

    signal.signal(signal.SIGTERM,
                  lambda *_: (policy.on_preempt(), os._exit(143)))
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

__all__ = ["EscalationPolicy", "PreemptionError", "ESCALATION_EXIT_CODE"]

#: EX_TEMPFAIL — the "transient failure, please retry" convention; the
#: elastic_run restart loop treats this exit as shrink-and-continue.
ESCALATION_EXIT_CODE = 75


class PreemptionError(RuntimeError):
    """Raised (instead of exiting) by a ``mode="raise"`` policy — the
    in-process signal an elastic train loop catches to restart on a
    smaller world."""

    def __init__(self, reason: str, ckpt_path: Optional[str] = None):
        super().__init__(f"escalated ({reason}); "
                         f"checkpoint={ckpt_path or 'none'}")
        self.reason = reason
        self.ckpt_path = ckpt_path


class EscalationPolicy:
    """checkpoint-save → crash-dump → nonzero exit, as one callable.

    ::

        policy = ckpt.EscalationPolicy(mgr, recorder=recorder)
        watchdog = HangWatchdog(30.0, on_stall=policy)   # any watchdog

    ``mode="exit"`` (default) hard-exits with ``exit_code`` — correct
    for a wedged rank (see module docstring), and the only mode that
    can actually interrupt one: use it for ``HangWatchdog(on_stall=)``.
    ``mode="raise"`` raises :class:`PreemptionError` — for *main-thread*
    call sites (SIGTERM handlers, manual invocation, an in-process
    elastic train loop that calls the policy itself). Invoked
    from a non-main thread (the watchdog daemon), a raise could not
    unwind the wedged main thread and would be swallowed by the
    watchdog loop's guard — so there the raise-mode policy completes
    the checkpoint+dump, records :attr:`tripped`, and returns; polling
    drivers observe ``tripped`` (the unit tests use exactly this).
    """

    def __init__(self, manager, *, recorder=None,
                 exit_code: int = ESCALATION_EXIT_CODE,
                 mode: str = "exit",
                 event_sink: Optional[Callable[[Dict], None]] = None):
        if mode not in ("exit", "raise"):
            raise ValueError(f"mode must be 'exit' or 'raise', "
                             f"got {mode!r}")
        self.manager = manager
        self.recorder = recorder
        self.exit_code = int(exit_code)
        self.mode = mode
        self.event_sink = event_sink or getattr(manager, "event_sink",
                                                None)
        #: set to the escalation reason once tripped (observable by
        #: polling drivers even in exit mode, for tests)
        self.tripped: Optional[str] = None

    def _emit(self, event: Dict) -> None:
        if self.event_sink is None:
            return
        try:
            from apex_tpu_torch.ckpt.format import tag_generation
            rank = getattr(self.manager, "rank", 0)
            ev = tag_generation(
                dict(event, rank=rank, wall_time=time.time()),
                getattr(self.manager, "fence", None))
            self.event_sink(ev)
        except Exception:
            pass

    def _escalate(self, reason: str, *, exit_after: bool,
                  dump: bool = True) -> Optional[str]:
        self.tripped = reason
        path = None
        try:
            path = self.manager.save_last_snapshot(reason)
        except Exception:
            path = None
        snap = getattr(self.manager, "last_host_snapshot", None)
        self._emit({
            "kind": "ckpt_escalation", "reason": reason,
            "path": path, "step": (snap.step if snap else None),
            "exit_code": self.exit_code if exit_after else None,
            "action": ("checkpoint+dump+exit" if exit_after
                       else "checkpoint+dump"),
        })
        if dump and self.recorder is not None:
            try:
                self.recorder.dump(reason=f"escalation:{reason}")
            except Exception:
                pass
        return path

    # -- hooks -----------------------------------------------------------------

    def trip(self, reason: str) -> None:
        """Escalate NOW with a caller-supplied reason — the public entry
        point for in-band policies (:class:`apex_tpu_torch.guard.GuardPolicy`
        trips it with ``"guard:..."`` when the rewind budget runs out).
        Same ladder as the watchdog path: checkpoint-save → crash-dump →
        ``os._exit`` / :class:`PreemptionError` per ``mode``."""
        import threading
        exit_after = self.mode == "exit"
        path = self._escalate(reason, exit_after=exit_after)
        if exit_after:
            os._exit(self.exit_code)
        if threading.current_thread() is not threading.main_thread():
            # raise-mode off the main thread: a raise here could not
            # unwind the wedged main thread (and the watchdog loop
            # would swallow it) — checkpoint+dump are done, `tripped`
            # is the observable (see class docstring)
            return
        raise PreemptionError(reason, path)

    def on_stall(self, event: Optional[Dict] = None) -> None:
        """HangWatchdog ``on_stall`` hook: the silent-rank path."""
        return self.trip("stall")

    def on_preempt(self) -> Optional[str]:
        """SIGTERM hook: graceful preemption. Saves the snapshot
        checkpoint and returns its path — never dumps and never exits:
        the caller's signal handler owns both."""
        return self._escalate("preempt", exit_after=False, dump=False)

    # the policy object itself is the on_stall callable
    __call__ = on_stall
