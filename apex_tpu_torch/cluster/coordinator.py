"""Coordinated multi-rank recovery: local verdicts → cluster decisions.

The port of ``apex_tpu/cluster/coordinator.py``: the same signed intent
files, so ranks of either package meet in one round and resolve the same
decision. :class:`CollectiveDeadline` polls an
:class:`apex_tpu_torch.trace.Tracer` (any object offering
``in_flight_collective_age()``); ``parallel.enable_crash_dumps(
collective_deadline_s=)`` starts one over its tracer.

:class:`apex_tpu_torch.guard.GuardPolicy` decides *locally* — rank 3's
nonfinite-param probe says "rewind to my newest good checkpoint". At
pod scale that is exactly the split-brain bug: rank 3 rewinds to step 6
while rank 0 (whose checkpoint at 8 is fine) keeps training, and the
next collective silently averages two different histories. The
:class:`RecoveryCoordinator` turns the verdict into a cluster decision
over the same shared filesystem the membership layer uses:

1. every participating rank posts a **signed intent** (one file per
   rank per generation, HMAC'd with the cluster token — a torn write,
   a stray file, or a zombie claiming the wrong generation is refused,
   never miscounted);
2. ranks **resolve deterministically**: wait (jittered, deadline-
   bounded — the ckpt rank-barrier pattern) until every live rank's
   intent is present, then every rank computes the SAME decision from
   the same files — action = worst proposed (escalate > rewind),
   rewind target = *oldest good step wins* (the only step every rank
   can restore);
3. the elected leader (lowest participating rank) **bumps the
   generation** — fencing out every straggler still holding the old
   token — and the others wait to observe the bump before adopting it.

:class:`CollectiveDeadline` is the host-side watchdog on
``kind="collective"`` spans: the step-level :class:`HangWatchdog` can
only say "no step landed"; this tier names *which* collective wedged —
a collective still open after ``deadline_s`` is hung, not slow (a slow
one closes and reopens, resetting its age), and feeds
``EscalationPolicy.trip("collective:<span>")``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from apex_tpu_torch.cluster.membership import (INTENT_PREFIX,
                                               ClusterMembership,
                                               StaleGenerationError,
                                               _read_json_retry,
                                               cluster_token, mac_ok,
                                               sign_payload)
from apex_tpu_torch.utils.backoff import backoff_sleep
from apex_tpu_torch.utils.ranks import rank_default

__all__ = ["RecoveryCoordinator", "RecoveryDecision",
           "CollectiveDeadline", "CoordinationError", "intent_path"]

_INTENT_PREFIX = INTENT_PREFIX

#: severity order of proposable actions — resolution takes the worst
ACTIONS = ("rewind", "escalate")


class CoordinationError(RuntimeError):
    """The recovery barrier could not produce a decision (timeout with
    zero usable intents, or every posted intent was refused)."""


class RecoveryDecision(NamedTuple):
    """The cluster's verdict — identical on every resolving rank, by
    construction (a pure function of the same intent files)."""
    action: str                   # "rewind" | "escalate"
    target_step: Optional[int]    # oldest good step (rewind only)
    generation: int               # epoch the decision was made IN
    new_generation: int           # epoch after the fence bump
    ranks: Tuple[int, ...]        # participating ranks
    leader: int                   # lowest participating rank
    refused: Tuple[int, ...] = () # ranks whose intents were refused


def intent_path(directory: str, generation: int, rank: int) -> str:
    return os.path.join(
        directory, f"{_INTENT_PREFIX}{int(generation):08d}"
                   f".rank{int(rank):05d}.json")


class RecoveryCoordinator:
    """See the module docstring.

    ``membership`` is this rank's :class:`ClusterMembership` (provides
    the fence token, the lease table for liveness, and the event
    sink). One coordinator instance serves the whole run; intents are
    per-generation, so a resolved round's files are inert the moment
    the leader bumps (and :meth:`ClusterMembership.gc_stale` cleans
    them at the next relaunch).
    """

    def __init__(self, membership: ClusterMembership, *,
                 barrier_timeout_s: float = 60.0,
                 event_sink: Optional[Callable[[Dict], None]] = None):
        self.membership = membership
        self.directory = membership.directory
        self.rank = membership.rank
        self.barrier_timeout_s = float(barrier_timeout_s)
        self.event_sink = event_sink or membership.event_sink
        # the signing token is immutable after creation: cache it so
        # the per-step pending() poll never re-reads it from disk
        self._token = cluster_token(self.directory)
        #: ranks refused during the last pending()/resolve() scan
        self.last_refused: Tuple[int, ...] = ()

    # -- events ----------------------------------------------------------------

    def _emit(self, event: Dict) -> None:
        if self.event_sink is None:
            return
        try:
            self.event_sink(dict(event, rank=self.rank,
                                 wall_time=time.time()))
        except Exception:
            pass

    # -- intents ---------------------------------------------------------------

    def propose(self, *, action: str, step: int,
                good_step: Optional[int],
                what: str = "guard") -> str:
        """Post this rank's signed intent for the current generation.

        ``good_step`` is the newest checkpoint step this rank verified
        restorable (:meth:`apex_tpu_torch.guard.GuardPolicy.probe_good_step`)
        — None when it has none, which forces the decision to
        escalate. ``what`` names the subsystem whose verdict triggered
        the round (``"guard"`` for the anomaly ladder,
        ``"integrity"`` for a silent-divergence fall-through with no
        repairable majority) — forensic attribution in the event
        stream, not part of the decision. Re-posting (a retried round)
        atomically replaces the previous intent."""
        if action not in ACTIONS:
            raise ValueError(f"action must be one of {ACTIONS}, "
                             f"got {action!r}")
        gen = self.membership.generation
        payload = {"rank": self.rank, "generation": gen,
                   "action": action, "step": int(step),
                   "good_step": (None if good_step is None
                                 else int(good_step)),
                   "what": str(what),
                   "wall_time": time.time()}
        payload["mac"] = sign_payload(self._token, payload)
        path = intent_path(self.directory, gen, self.rank)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._emit({"kind": "cluster_coord", "action": "propose",
                    "generation": gen, "proposed": action,
                    "step": int(step), "what": str(what),
                    "good_step": payload["good_step"]})
        return path

    def _verify(self, rec: Optional[Dict], *, rank: int,
                generation: int) -> Optional[Dict]:
        """One intent record, or None if it must be refused. A refusal
        emits ``cluster_fence`` ``action="refused_intent"`` — the
        split-brain evidence trail: an intent claiming a generation
        the cluster never committed, a MAC that doesn't verify (torn
        write / wrong cluster / tampering), or a rank mismatch all
        land here."""
        reason = None
        if not isinstance(rec, dict):
            reason = "unreadable"
        else:
            if not isinstance(rec.get("mac"), str) or not isinstance(
                    rec.get("generation"), int):
                reason = "malformed"
            elif not mac_ok(self._token, rec):
                reason = "bad signature"
            elif rec["generation"] != generation:
                reason = (f"claims generation {rec['generation']}, "
                          f"cluster is at {generation}")
            elif rec.get("rank") != rank:
                reason = "rank mismatch"
            elif rec.get("action") not in ACTIONS:
                reason = f"unknown action {rec.get('action')!r}"
        if reason is None:
            return rec
        self._emit({"kind": "cluster_fence", "action": "refused_intent",
                    "generation": (rec.get("generation")
                                   if isinstance(rec, dict)
                                   and isinstance(rec.get("generation"),
                                                  int) else 0),
                    "current_generation": generation,
                    "what": "intent", "step": None, "path": None,
                    "reason": f"rank {rank}: {reason}"})
        return None

    def pending(self) -> Dict[int, Dict]:
        """Verified intents posted for the CURRENT generation, by
        rank. The cheap per-step poll a *healthy* rank uses to notice
        a peer asking for recovery (one listdir; empty in steady
        state)."""
        gen = self.membership.generation
        prefix = f"{_INTENT_PREFIX}{gen:08d}.rank"
        out: Dict[int, Dict] = {}
        refused: List[int] = []
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return out
        for name in names:
            if not (name.startswith(prefix) and name.endswith(".json")):
                continue
            try:
                rank = int(name[len(prefix):-len(".json")])
            except ValueError:
                continue
            rec = self._verify(
                _read_json_retry(os.path.join(self.directory, name),
                                 attempts=1),
                rank=rank, generation=gen)
            if rec is None:
                refused.append(rank)
            else:
                out[rank] = rec
        self.last_refused = tuple(refused)
        return out

    def peer_requested(self) -> bool:
        """True when any OTHER rank has a verified intent pending —
        the signal for a locally-healthy rank to join the round."""
        return any(r != self.rank for r in self.pending())

    # -- resolution ------------------------------------------------------------

    def resolve(self, *, expect_ranks: Optional[List[int]] = None,
                bump: bool = True) -> RecoveryDecision:
        """Barrier on the live ranks' intents, decide, fence.

        ``expect_ranks`` overrides liveness (tests, or a controller
        that already decided who survives); default = the membership
        layer's :meth:`~ClusterMembership.alive_ranks` — a rank whose
        lease expired mid-round cannot block the barrier forever, its
        expiry shrinks the electorate on the next poll. On deadline,
        the round proceeds with the verified intents present (the
        missing ranks are dead or fenced; refusing to decide would
        trade a recoverable fault for a hung cluster) — with zero
        intents it raises :class:`CoordinationError`.

        Every resolving rank computes the same decision; the leader
        (lowest participating rank) commits the generation bump with
        ``expect=`` the deciding epoch, so a double-resolve cannot
        stack bumps; followers wait to observe the bump, then all
        participants re-join under the new epoch.
        """
        gen = self.membership.generation
        deadline = time.monotonic() + self.barrier_timeout_s
        attempt = 0
        timed_out = False
        while True:
            intents = self.pending()
            want = (set(int(r) for r in expect_ranks)
                    if expect_ranks is not None
                    else set(self.membership.alive_ranks()) | {self.rank})
            missing = sorted(want - set(intents))
            if not missing:
                break
            if time.monotonic() > deadline:
                timed_out = True
                self._emit({"kind": "cluster_coord",
                            "action": "barrier_timeout",
                            "generation": gen,
                            "deadline_s": self.barrier_timeout_s,
                            "missing": missing,
                            "n_intents": len(intents)})
                break
            backoff_sleep(attempt, cap_s=0.2)
            attempt += 1
        if not intents:
            raise CoordinationError(
                f"recovery round at generation {gen} produced no "
                f"verified intents within {self.barrier_timeout_s}s "
                f"(refused: {list(self.last_refused)}) — nothing to "
                f"decide with; escalate locally")

        # the decision: a pure function of the verified intents, so
        # every resolving rank lands on the SAME verdict
        ranks = tuple(sorted(intents))
        actions = {r: intents[r]["action"] for r in ranks}
        goods = [intents[r]["good_step"] for r in ranks]
        action = "escalate" if ("escalate" in actions.values()
                                or any(g is None for g in goods)) \
            else "rewind"
        target = (min(int(g) for g in goods)
                  if action == "rewind" else None)
        leader = min(ranks)

        new_gen = gen
        if bump:
            if self.rank == leader:
                try:
                    new_gen = self.membership.bump(
                        f"coordinated_{action}", expect=gen)
                except StaleGenerationError:
                    # a racing resolve already fenced this epoch —
                    # adopt its bump instead of stacking another
                    new_gen = self.membership.rejoin()
            else:
                new_gen = self._wait_for_bump(gen)
                self.membership.rejoin()
        dec = RecoveryDecision(action=action, target_step=target,
                               generation=gen, new_generation=new_gen,
                               ranks=ranks, leader=leader,
                               refused=self.last_refused)
        self._emit({"kind": "cluster_coord", "action": "resolve",
                    "generation": gen, "new_generation": new_gen,
                    "decided": action, "target_step": target,
                    "ranks": list(ranks), "leader": leader,
                    "n_refused": len(self.last_refused),
                    "timed_out": bool(timed_out)})
        return dec

    def run_round(self, policy, step: int, like, source, *,
                  action: str = "rewind",
                  expect_ranks: Optional[List[int]] = None,
                  reason: str = "", what: str = "guard"):
        """One full recovery round driven through a
        :class:`~apex_tpu_torch.guard.GuardPolicy`: vote (this rank's newest
        restorable step), resolve, and apply the cluster decision —
        rewind to the agreed target (NOT this rank's own preference),
        or escalate. Returns ``(decision, (restored, manifest) | None)``.

        This is the loop-side glue: a rank whose own guard verdict
        fired calls it with that verdict's ``action``; a locally-
        healthy rank that noticed :meth:`peer_requested` calls it with
        the default ``action="rewind"`` — its healthy vote still
        matters, because its good step bounds the target from above.
        The integrity rung falls through here too
        (``what="integrity"``): a divergence with no repairable
        majority means no single replica can be trusted as a broadcast
        source, and the only consistent state every rank can reach is
        a committed checkpoint — the same oldest-good-step-wins
        resolution, now repairing a *silent* fault.
        """
        good = policy.probe_good_step(like)
        try:
            self.propose(action=action, step=int(step), good_step=good,
                         what=what)
            dec = self.resolve(expect_ranks=expect_ranks)
        except BaseException:
            # no rewind will consume the probe's cached restored tree
            # (a full model copy) — release it before propagating, or
            # it pins HBM the recovery retry itself needs
            policy.drop_probe_cache()
            raise
        if dec.action == "escalate":
            policy.escalate(
                f"coordinated escalate (generation {dec.generation}; "
                f"ranks {list(dec.ranks)}; {reason})")
            return dec, None           # only raise-mode off-main-thread
        restored = policy.rewind(
            int(step), like, source, target_step=dec.target_step,
            reason=(f"coordinated (generation {dec.generation}->"
                    f"{dec.new_generation}; target {dec.target_step}"
                    + (f"; {reason}" if reason else "") + ")"))
        got = restored[1].get("step")
        if dec.target_step is not None and got != dec.target_step:
            # rewind's fallback chain restored an OLDER step because
            # the agreed target was unloadable HERE (its vote was some
            # other rank's good step) — peers are at the target, this
            # rank is not, and resuming would be the exact divergence
            # the round exists to prevent; fail loudly instead
            policy.escalate(
                f"coordinated rewind diverged: cluster agreed on step "
                f"{dec.target_step} but this rank restored {got} "
                f"(generation {dec.generation}->{dec.new_generation})")
            return dec, None           # only raise-mode off-main-thread
        return dec, restored

    def _wait_for_bump(self, gen: int) -> int:
        """Follower half of the fence bump: poll until the committed
        generation moves past ``gen`` (deadline-bounded — a leader
        that died mid-bump must not hang the followers; on timeout the
        follower bumps itself, the CAS `expect=` making the race
        harmless)."""
        deadline = time.monotonic() + self.barrier_timeout_s
        attempt = 0
        while True:
            cur = self.membership.refresh()
            if cur > gen:
                return cur
            if time.monotonic() > deadline:
                try:
                    return self.membership.bump(
                        "coordinated_leader_timeout", expect=gen)
                except StaleGenerationError:
                    return self.membership.refresh()
            backoff_sleep(attempt, cap_s=0.2)
            attempt += 1


# --- collective-deadline watchdog ---------------------------------------------

class CollectiveDeadline:
    """Name the wedged collective, not just the wedged step.

    Polls ``tracer.in_flight_collective_age()`` on a daemon thread: a
    ``kind="collective"`` span still open after ``deadline_s`` is a
    *hung* collective (a peer died inside it, a deadlock, a stuck DMA)
    — as opposed to a slow one, which completes, closes its span, and
    resets the age on the next call. On fire it emits one
    ``cluster_coord`` ``action="collective_hang"`` event and feeds
    ``escalation.trip("collective:<span name>")`` — the same
    checkpoint-save → crash-dump → exit ladder the step watchdog uses,
    but with the offending collective named in the reason (and hence
    in the crash header and the elastic relaunch logs).

    Fires at most once per span instance (a new collective span re-arms
    it). ``escalation=None`` degrades to observation: events + the
    ``fired`` counter only.
    """

    def __init__(self, tracer, *, deadline_s: float = 120.0,
                 escalation=None,
                 event_sink: Optional[Callable[[Dict], None]] = None,
                 on_hang: Optional[Callable[[Dict], None]] = None,
                 poll_s: Optional[float] = None,
                 generation: Optional[Callable[[], int]] = None):
        self.tracer = tracer
        self.deadline_s = float(deadline_s)
        self.escalation = escalation
        self.event_sink = event_sink
        self.on_hang = on_hang
        self.poll_s = (poll_s if poll_s is not None
                       else max(self.deadline_s / 10.0, 0.05))
        #: callable returning the current fence token for the event
        #: (wire ``generation=member.refresh`` or leave None)
        self.generation = generation
        self.fired = 0
        self._fired_key: Optional[Tuple[str, float]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self) -> Optional[Dict]:
        """One check (also the test entry point): returns the hang
        event when the in-flight collective exceeded the deadline,
        else None."""
        probe = self.tracer.in_flight_collective_age()
        if probe is None:
            self._fired_key = None
            return None
        name, age_s = probe[0], probe[1]
        if age_s < self.deadline_s:
            return None
        # fire once per span INSTANCE: the span's identity is its name
        # plus its (fixed) start instant — the tracer reports the
        # stable start timestamp (a re-derived now−age would drift
        # across polls and could double-fire the escalation)
        start = (probe[2] if len(probe) > 2
                 else round(time.monotonic() - age_s, 1))
        key = (name, start)
        if self._fired_key == key:
            return None
        self._fired_key = key
        self.fired += 1
        event = {"kind": "cluster_coord", "action": "collective_hang",
                 "generation": (int(self.generation())
                                if self.generation is not None else 0),
                 "collective": name, "age_s": round(age_s, 3),
                 "deadline_s": self.deadline_s,
                 "wall_time": time.time()}
        event["rank"] = rank_default()
        if self.event_sink is not None:
            try:
                self.event_sink(dict(event))
            except Exception:
                pass
        if self.on_hang is not None:
            try:
                self.on_hang(dict(event))
            except Exception:
                pass
        if self.escalation is not None:
            # same thread-safety contract as HangWatchdog.on_stall: an
            # exit-mode policy never returns; a raise-mode policy on
            # this daemon thread completes the save/dump and records
            # `tripped` (its documented polling contract)
            self.escalation.trip(f"collective:{name}")
        return event

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "CollectiveDeadline":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="apex_tpu_torch.cluster.collective",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(self.poll_s * 2, 1.0))
        self._thread = None

    def __enter__(self) -> "CollectiveDeadline":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:
                pass          # a broken poll must not kill the daemon
