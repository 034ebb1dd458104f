"""The guard policy ladder: skip → backoff → repair → rewind → escalate.

The port of ``apex_tpu.guard.policy``. The in-step half
(:mod:`apex_tpu_torch.guard.detect`) already *acted* on the common case
before the host ever sees it: skip-class anomalies never commit and the
LR backs off, all inside the step. This module is
the host-side escalation on top — the rungs that need the checkpoint
manager and the data pipeline:

1. **skip / backoff** (in-graph, observed here): each new anomaly is
   emitted as a ``guard_anomaly`` event; the in-graph veto is reported
   as a ``guard_action`` with ``action="skip"``.
1b. **repair** (`update_integrity` / `repair`) — the rung *below*
   rewind, for the silent-divergence class
   (:mod:`apex_tpu_torch.guard.integrity`): when the cross-replica
   fingerprint check names a diverged minority and a strict majority
   still agrees, the minority's parameters are re-broadcast in place
   from the lowest-numbered majority replica (bit-exact, over the
   registered DDP comm), the fingerprint re-verified, and training
   continues — **no checkpoint restore, cursor untouched**. Only when
   no majority exists (every replica disagrees — the collective
   itself is suspect, not one replica) or the repair re-fails does
   the incident fall through to rung 2.
2. **rewind** — when the committed state itself is corrupt
   (nonfinite-param class) or skipping stopped converging (more than
   ``skip_budget`` skips inside a ``skip_window``-step window): restore
   the last *good* snapshot via
   :class:`apex_tpu_torch.ckpt.CheckpointManager` and fast-forward the
   data source's cursor past the offending window, so the resumed run is
   bitwise-equal to a run that never saw those batches. Snapshots whose params are non-finite, or whose files fail the
   manifest hash (a truncated/corrupted checkpoint), are rejected and
   the policy falls back to the next-older committed checkpoint.
3. **escalate** — the rewind budget is exhausted (or no loadable
   checkpoint exists): hand off to the existing
   :class:`apex_tpu_torch.ckpt.EscalationPolicy` (checkpoint + crash dump +
   exit 75), the same path the hang watchdog takes.

Hysteresis: a ``cooldown_steps`` window after each rewind during which
the skip-budget accounting restarts from zero — one rough patch of data
must not chain-rewind; rewind-class (state-corruption) anomalies are
exempt, because waiting cannot un-corrupt params.

Every decision is a ``guard`` event dict delivered to ``event_sink`` (the
JAX package's schema); an :class:`apex_tpu_torch.trace.FlightRecorder`
(or any object with ``note_guard``) passed as ``recorder=`` gets each
through ``note_guard`` so crash dumps carry the
recent interventions.

The per-step host poll (`update`) fetches a handful of scalars from the
``GuardState`` in one device→host copy — it rides the sync the loss read
already forces. ``poll_every=N`` amortizes it further: the in-graph
skip/backoff protection is always on regardless of polling, and the
cumulative counters let a coarse poll recover every missed event; the
only cost of coarser polling is rewind latency (≤ N extra steps inside
the offending window).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np

import torch

from apex_tpu_torch.guard.detect import GuardState
from apex_tpu_torch.utils.ranks import rank_default

__all__ = ["GuardPolicy", "GuardAction", "GuardEscalation"]


class GuardAction(NamedTuple):
    """One `update` / `update_integrity` verdict. ``kind`` ∈ none |
    skip | repair | rewind | escalate (observe-only policies report
    what they *would* do in ``reason`` but always return
    kind="none")."""
    kind: str
    step: int
    classes: Tuple[str, ...] = ()
    reason: str = ""


class GuardEscalation(RuntimeError):
    """Raised by `escalate` when no
    :class:`~apex_tpu_torch.ckpt.EscalationPolicy` is wired — the guard
    refuses to train on irrecoverable state."""


def _host_ints(values) -> list:
    """Device scalars to Python numbers in one device→host copy."""
    flat = torch.stack([v.detach().reshape(()).to(torch.float64)
                        for v in values]).cpu().tolist()
    return flat


def _state_nodes(tree, kinds):
    """Every node of ``tree`` that is an instance of ``kinds``."""
    if isinstance(tree, kinds):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _state_nodes(v, kinds)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _state_nodes(v, kinds)


class GuardPolicy:
    """See the module docstring.

    ``manager`` is a :class:`apex_tpu_torch.ckpt.CheckpointManager`
    (required for the rewind rung); ``escalation`` an
    :class:`apex_tpu_torch.ckpt.EscalationPolicy` (required for the final
    rung — without one, `escalate` raises :class:`GuardEscalation`).
    ``observe_only=True`` turns the policy into a pure witness: every
    event is still emitted, no action is ever taken and `update` never
    asks for one.
    """

    def __init__(self, *, manager=None, escalation=None,
                 event_sink: Optional[Callable[[Dict], None]] = None,
                 integrity_sink: Optional[Callable[[Dict], None]] = None,
                 recorder=None, observe_only: bool = False,
                 rewind_budget: int = 2, skip_budget: int = 4,
                 skip_window: int = 32, cooldown_steps: int = 16,
                 poll_every: int = 1,
                 generation: Optional[Callable[[], int]] = None):
        self.manager = manager
        self.escalation = escalation
        self.event_sink = event_sink
        #: the ``integrity`` event channel (kind="integrity_check"/
        #: "integrity_vote"/"integrity_repair"), separate from
        #: ``event_sink`` because the two channels carry different
        #: schemas
        self.integrity_sink = integrity_sink
        #: callable returning the cluster's committed generation —
        #: integrity events are fenced with it when wired (null
        #: otherwise)
        self.generation = generation
        self.recorder = recorder
        self.observe_only = bool(observe_only)
        self.rewind_budget = int(rewind_budget)
        self.skip_budget = int(skip_budget)
        self.skip_window = int(skip_window)
        self.cooldown_steps = int(cooldown_steps)
        self.poll_every = max(int(poll_every), 1)
        self.rank = rank_default()
        #: rewinds performed so far (the budget's odometer)
        self.rewinds_done = 0
        #: loop step below which skip-budget accounting is suspended
        self.cooldown_until = -1
        self._skip_steps: list = []      # loop steps of recent skips
        self._prev: Optional[Dict[str, int]] = None
        self._last_poll = -1
        #: in-place repairs performed (the integrity rung's odometer)
        self.repairs_done = 0
        #: the last mismatch's quorum verdict (integrity.IntegrityVote)
        #: — kept for forensics; `repair` consumes the ARMED flag, so
        #: a stale verdict from a previous incident can never drive a
        #: broadcast
        self.last_vote = None
        self._vote_armed = False
        #: (fp_min, fp_max, rank_fps) of the last repair's
        #: re-verification — feed ``guard.absorb_verify(ist,
        #: *policy.last_verify)`` so the carried IntegrityState (and
        #: any checkpoint taken this step) reflects the POST-repair
        #: agreement instead of the detection-time disagreement
        self.last_verify = None
        self._iprev: Optional[Dict[str, int]] = None
        self._last_ipoll = -1
        #: (step, like, tree, manifest) of the last probe_good_step
        #: winner — rewind() reuses it when the agreed target IS this
        #: rank's own good step (the healthy-majority case), halving
        #: the shared-fs read traffic of a coordinated recovery round
        self._probe_cache: Optional[tuple] = None

    # -- events ----------------------------------------------------------------

    def _emit_to(self, sink, event: Dict) -> None:
        """The one event-hygiene pipeline both channels share: stamp
        rank + wall time, null non-finite gauges (strict-JSON contract
        — the crash-dump ring serializes these verbatim), note the
        flight recorder, deliver to ``sink`` — and telemetry must
        never break recovery, so every consumer failure is
        swallowed."""
        ev = dict(event, rank=self.rank, wall_time=time.time())
        for k, v in ev.items():
            if isinstance(v, float) and not np.isfinite(v):
                ev[k] = None
        if self.recorder is not None:
            try:
                self.recorder.note_guard(ev)
            except Exception:
                pass
        if sink is None:
            return
        try:
            sink(ev)
        except Exception:
            pass

    def _emit(self, event: Dict) -> None:
        self._emit_to(self.event_sink, event)

    # -- the per-step poll ------------------------------------------------------

    @staticmethod
    def _fetch(gs: GuardState) -> Dict[str, float]:
        """One small host fetch of the policy-relevant scalars."""
        vals = _host_ints((
            gs.anomaly, gs.z, gs.lr_scale, gs.consecutive,
            gs.skip_count, gs.spike_count, gs.grad_explosion_count,
            gs.nonfinite_grad_count, gs.nonfinite_loss_count,
            gs.nonfinite_param_count, gs.replica_divergence_count,
            gs.step))
        keys = ("anomaly", "z", "lr_scale", "consecutive", "skip_count",
                "spike_count", "grad_explosion_count",
                "nonfinite_grad_count", "nonfinite_loss_count",
                "nonfinite_param_count", "replica_divergence_count",
                "step")
        return {k: (float(v) if k in ("z", "lr_scale") else int(v))
                for k, v in zip(keys, vals)}

    def update(self, step: int, gs: GuardState) -> GuardAction:
        """Poll the guard state after loop step ``step`` and decide.

        Returns the ladder verdict; the CALLER performs the returned
        action (`rewind`/`escalate`) — the policy never mutates training
        state behind the loop's back. ``kind="skip"`` is informational:
        the in-graph veto already protected the state.
        """
        step = int(step)
        if (step - self._last_poll) < self.poll_every and step != 0:
            return GuardAction("none", step)
        self._last_poll = step
        cur = self._fetch(gs)
        prev = self._prev or {k: 0 for k in cur}
        self._prev = cur

        # new-event deltas since the last poll (counters are cumulative,
        # so a poll_every > 1 cadence still sees every event)
        deltas = {k: cur[k] - prev.get(k, 0)
                  for k in ("skip_count", "spike_count",
                            "grad_explosion_count", "nonfinite_grad_count",
                            "nonfinite_loss_count",
                            "nonfinite_param_count",
                            "replica_divergence_count")}
        new_any = any(v > 0 for v in deltas.values())
        classes = tuple(
            name for key, name in (
                ("spike_count", "loss_spike"),
                ("grad_explosion_count", "grad_explosion"),
                ("nonfinite_grad_count", "nonfinite_grad"),
                ("nonfinite_loss_count", "nonfinite_loss"),
                ("nonfinite_param_count", "nonfinite_param"),
                ("replica_divergence_count", "replica_divergence"))
            if deltas[key] > 0)
        if not new_any:
            return GuardAction("none", step)

        self._emit({"kind": "guard_anomaly", "step": step,
                    "classes": list(classes),
                    "z": cur["z"], "lr_scale": cur["lr_scale"],
                    "consecutive": cur["consecutive"],
                    "skip_count": cur["skip_count"]})

        # ladder: rewind-class corruption, or skip budget exhausted
        want_rewind = deltas["nonfinite_param_count"] > 0
        reason = "nonfinite_param" if want_rewind else ""
        if deltas["skip_count"] > 0:
            in_cooldown = step < self.cooldown_until
            # one entry PER skip, not per poll — a coarse poll_every
            # must not undercount a storm of skips into never reaching
            # the budget. Skips during the cooldown are NOT recorded:
            # "accounting restarts from zero" means the rough patch the
            # rewind just handled cannot be banked toward an immediate
            # chain-rewind the moment the cooldown expires
            if not in_cooldown:
                self._skip_steps.extend(
                    [step] * int(deltas["skip_count"]))
                self._skip_steps = [s for s in self._skip_steps
                                    if s > step - self.skip_window]
            if (not want_rewind and not in_cooldown
                    and len(self._skip_steps) > self.skip_budget):
                want_rewind = True
                reason = (f"skip_budget: {len(self._skip_steps)} skips "
                          f"in {self.skip_window} steps")

        if want_rewind:
            if self.observe_only:
                self._emit({"kind": "guard_action", "step": step,
                            "action": "observe", "classes": list(classes),
                            "reason": f"would rewind ({reason})"})
                return GuardAction("none", step, classes, reason)
            if self.rewinds_done >= self.rewind_budget:
                self._emit({"kind": "guard_action", "step": step,
                            "action": "escalate",
                            "classes": list(classes),
                            "reason": f"rewind budget exhausted "
                                      f"({self.rewinds_done}/"
                                      f"{self.rewind_budget}); {reason}"})
                return GuardAction("escalate", step, classes, reason)
            self._emit({"kind": "guard_action", "step": step,
                        "action": "rewind", "classes": list(classes),
                        "reason": reason})
            return GuardAction("rewind", step, classes, reason)

        act = "observe" if self.observe_only else "skip"
        self._emit({"kind": "guard_action", "step": step, "action": act,
                    "classes": list(classes),
                    "reason": f"in-graph skip; lr_scale="
                              f"{cur['lr_scale']:.4g}"})
        return GuardAction("none" if self.observe_only else "skip",
                           step, classes)

    # -- the integrity rung: vote + in-place repair ----------------------------

    def _emit_integrity(self, event: Dict) -> None:
        """Like `_emit`, but onto the integrity channel — every event
        fenced with the cluster generation when one is wired (null
        otherwise)."""
        gen = None
        if self.generation is not None:
            try:
                gen = int(self.generation())
            except Exception:
                gen = None
        self._emit_to(self.integrity_sink, dict(event, generation=gen))

    @staticmethod
    def _fetch_integrity(ist) -> Dict[str, int]:
        """One small host fetch of the integrity scalars (the
        per-replica fingerprint vector is fetched only on mismatch)."""
        vals = _host_ints((
            ist.step, ist.check_count, ist.mismatch_count,
            ist.last_check_step, ist.fp_min, ist.fp_max))
        keys = ("step", "check_count", "mismatch_count",
                "last_check_step", "fp_min", "fp_max")
        return {k: int(v) for k, v in zip(keys, vals)}

    def update_integrity(self, step: int, ist) -> GuardAction:
        """Poll the :class:`~apex_tpu_torch.guard.IntegrityState` after loop
        step ``step`` and decide the silent-divergence response.

        On a new mismatch (cumulative ``mismatch_count`` moved since
        the last poll — a coarse ``poll_every`` cadence still sees
        every incident) the gathered per-replica fingerprints are
        fetched and put to a quorum vote
        (:func:`apex_tpu_torch.guard.integrity.vote`):

        - a strict majority → ``kind="repair"`` naming the diverged
          minority and the broadcast source (the caller runs
          :meth:`repair`, NO checkpoint is touched);
        - no majority (all replicas disagree, or a tie) → the
          collective itself is suspect; ``kind="rewind"`` (:meth:`rewind`
          on every rank).

        Like `update`, the policy only *decides*; the caller acts.
        Every decision lands on the integrity channel
        (``integrity_check`` + ``integrity_vote`` events)."""
        step = int(step)
        if (step - self._last_ipoll) < self.poll_every and step != 0:
            return GuardAction("none", step)
        self._last_ipoll = step
        cur = self._fetch_integrity(ist)
        prev = self._iprev or {k: 0 for k in cur}
        self._iprev = cur
        new_mismatches = cur["mismatch_count"] - prev.get(
            "mismatch_count", 0)
        if new_mismatches <= 0:
            return GuardAction("none", step)
        # -1 = "no check since init/resize" (the elastic-resume
        # sentinel) — null on the wire, never a negative counter
        check_step = (cur["last_check_step"]
                      if cur["last_check_step"] >= 0 else None)

        from apex_tpu_torch.guard import integrity as _integrity
        v = _integrity.vote(ist.rank_fps)
        if v.has_majority and not v.minority:
            # the gathered fingerprints all AGREE: the cumulative
            # counter moved but the divergence is already healed — a
            # transient incident whose later checks re-converged
            # before this poll, or the first poll of a fresh policy
            # over a restored IntegrityState whose mismatch_count
            # predates the restart. A repair with nobody to repair
            # would be noise, but the DETECTION is still forensic
            # record: emit the check event (flagged healed, no vote)
            # and stay quiet.
            self._emit_integrity({
                "kind": "integrity_check", "step": step,
                "check_step": check_step,
                "n_ranks": v.n_ranks,
                "mismatch_count": cur["mismatch_count"],
                "new_mismatches": int(new_mismatches),
                "fp_min": cur["fp_min"], "fp_max": cur["fp_max"],
                "healed": True})
            return GuardAction("none", step)
        self.last_vote = v
        self._emit_integrity({
            "kind": "integrity_check", "step": step,
            "check_step": check_step,
            "n_ranks": v.n_ranks,
            "mismatch_count": cur["mismatch_count"],
            "new_mismatches": int(new_mismatches),
            "fp_min": cur["fp_min"], "fp_max": cur["fp_max"]})
        classes = ("replica_divergence",)
        if self.observe_only:
            reason = ("would repair" if v.has_majority
                      else "would rewind (no majority)")
            self._emit_integrity({
                "kind": "integrity_vote", "step": step,
                "action": "observe", "n_ranks": v.n_ranks,
                "minority": list(v.minority),
                "source_rank": v.source_rank,
                "majority_fp": v.majority_fp, "reason": reason})
            return GuardAction("none", step, classes, reason)
        if v.has_majority:
            reason = (f"minority {list(v.minority)} diverged from "
                      f"{v.n_ranks - len(v.minority)}-replica majority")
            self._emit_integrity({
                "kind": "integrity_vote", "step": step,
                "action": "repair", "n_ranks": v.n_ranks,
                "minority": list(v.minority),
                "source_rank": v.source_rank,
                "majority_fp": v.majority_fp, "reason": reason})
            self._vote_armed = True
            return GuardAction("repair", step, classes, reason)
        if self.rewinds_done >= self.rewind_budget:
            # same terminal rung update() enforces for the guard
            # ladder's rewind classes: a deterministic fault that
            # re-diverges after every restore must not loop
            # restore→diverge forever — hand it to the operator
            reason = (f"no majority fingerprint across {v.n_ranks} "
                      f"replicas AND rewind budget exhausted "
                      f"({self.rewinds_done}/{self.rewind_budget})")
            self._emit_integrity({
                "kind": "integrity_vote", "step": step,
                "action": "escalate", "n_ranks": v.n_ranks,
                "minority": list(v.minority), "source_rank": None,
                "majority_fp": None, "reason": reason})
            return GuardAction("escalate", step, classes, reason)
        reason = (f"no majority fingerprint across {v.n_ranks} "
                  f"replicas — the collective itself is suspect; "
                  f"falling through to coordinated rewind")
        self._emit_integrity({
            "kind": "integrity_vote", "step": step,
            "action": "rewind", "n_ranks": v.n_ranks,
            "minority": list(v.minority), "source_rank": None,
            "majority_fp": None, "reason": reason})
        return GuardAction("rewind", step, classes, reason)

    def repair(self, step: int, tree, *, repair_fn, verify_fn,
               reason: str = "") -> Tuple[Any, bool]:
        """Execute the in-place repair `update_integrity` decided.

        ``repair_fn``/``verify_fn`` come from
        :func:`apex_tpu_torch.guard.integrity.make_repair_fn` /
        :func:`make_verify_fn` (the policy never owns a mesh). The
        minority replica's buffers are overwritten with the majority
        source's exact bits, then the fingerprint is re-verified
        before anyone trains on the result. Returns
        ``(repaired_tree, verified)`` — on ``verified=False`` the
        caller MUST fall through to the rewind rung (the audit pins
        this ladder), and the repaired tree should be discarded. On
        success, fold the re-verification into the carried state
        before the next checkpoint — ``ist = guard.absorb_verify(ist,
        *policy.last_verify)`` — so a snapshot taken this step records
        the post-repair agreement, not the detection-time
        disagreement.

        The checkpoint manager and the data cursor are untouched by
        construction: repair is state surgery on the current step, not
        time travel."""
        v = self.last_vote
        if v is None or not v.has_majority or not self._vote_armed:
            raise ValueError(
                "repair called without a FRESH majority vote — "
                "update_integrity must decide immediately before each "
                "repair (a stale verdict from a previous incident "
                "must never choose the broadcast source)")
        self._vote_armed = False     # one vote drives at most one repair
        repaired = repair_fn(tree, int(v.source_rank))
        mn, mx, fps = verify_fn(repaired)
        self.last_verify = (mn, mx, fps)
        lo, hi = _host_ints((mn, mx))
        ok = lo == hi
        if ok:
            self.repairs_done += 1
        self._emit_integrity({
            "kind": "integrity_repair", "step": int(step),
            "action": "repair" if ok else "repair_failed",
            "source_rank": v.source_rank,
            "minority": list(v.minority), "verified": bool(ok),
            "reason": reason or None})
        return repaired, ok

    # -- rewind -----------------------------------------------------------------

    @staticmethod
    def _params_finite(tree) -> bool:
        """Every float leaf finite — EXCEPT inside GuardState nodes,
        whose rolling windows use NaN as the empty-slot marker by
        design (a checkpointed young guard would otherwise read as
        corruption and torpedo every rewind). One host read."""
        flags = []

        def walk(t):
            if isinstance(t, GuardState):
                return
            if isinstance(t, dict):
                for v in t.values():
                    walk(v)
            elif isinstance(t, (list, tuple)):
                for v in t:
                    walk(v)
            elif isinstance(t, torch.Tensor) and t.is_floating_point():
                flags.append(torch.isfinite(t).all())
            elif isinstance(t, np.ndarray) and np.issubdtype(t.dtype,
                                                             np.floating):
                flags.append(torch.as_tensor(bool(np.isfinite(t).all())))

        walk(tree)
        if not flags:
            return True
        dev = flags[0].device
        return bool(torch.stack([f.to(dev) for f in flags]).all())

    def probe_good_step(self, like) -> Optional[int]:
        """The newest checkpoint step this rank can actually restore —
        manifest hash verified AND finite params — or None when no
        loadable checkpoint exists. This is the rank's *vote* in a
        coordinated recovery round (resolution takes the cluster-wide
        minimum — "oldest good step wins" — because that is the only step
        every rank can restore). Costs a restore per rejected candidate;
        acceptable at recovery time — and the winner is cached so the
        :meth:`rewind` that follows in the same round reuses it
        instead of re-gathering the identical checkpoint when the
        cluster target equals this rank's own good step.
        """
        from apex_tpu_torch.ckpt import format as _fmt
        from apex_tpu_torch.ckpt.format import CheckpointError
        self._probe_cache = None
        if self.manager is None:
            return None
        for s in reversed(list(self.manager.all_steps())):
            d = _fmt.step_dir(self.manager.root, s)
            try:
                cand, mf = self.manager.restore(like, ckpt_dir=d)
            except CheckpointError:
                continue
            if self._params_finite(cand):
                self._probe_cache = (int(s), like, cand, mf)
                return int(s)
        return None

    def drop_probe_cache(self) -> None:
        """Release :meth:`probe_good_step`'s cached restored tree — a
        full params+optimizer copy — when no :meth:`rewind` will
        consume it (a coordination round that failed before deciding);
        leaving it pinned could cost the HBM the recovery retry
        itself needs."""
        self._probe_cache = None

    def rewind(self, step: int, like, source, *,
               reason: str = "",
               target_step: Optional[int] = None) -> Tuple[Any, Dict]:
        """Restore the newest *good* snapshot and fast-forward ``source``
        past the offending window.

        ``like`` is the current training tuple (structure + shardings
        define restore targets, exactly :meth:`CheckpointManager.restore`);
        ``source`` any cursor-bearing pipeline (duck-typed:
        ``state()/load_state()/skip_batches()/cursor_index()``) whose
        cursor was captured in each checkpoint's ``extra["cursor"]``.

        Fallback chain: a candidate checkpoint is rejected — and the
        next-older one tried — when its files fail the manifest hash
        (truncation/corruption) or its restored params are non-finite
        (the corruption predates the snapshot). ``target_step`` caps
        the search (only steps ≤ it are candidates) — the coordinated-
        recovery hook: when a recovery round resolved to an older step
        than this rank's own newest good one, the rank MUST honor the
        cluster target or the ranks diverge. Returns
        ``(restored_tree, manifest)``; raises :class:`GuardEscalation`
        (or trips ``escalation``) when nothing loadable remains.
        """
        from apex_tpu_torch.ckpt import format as _fmt
        from apex_tpu_torch.ckpt.format import CheckpointError
        if self.manager is None:
            return self.escalate(f"rewind requested but no "
                                 f"CheckpointManager wired ({reason})")
        cur_index = int(source.cursor_index())
        steps = list(self.manager.all_steps())
        if target_step is not None:
            steps = [s for s in steps if s <= int(target_step)]
        fallbacks = 0
        restored = manifest = None
        probe, self._probe_cache = self._probe_cache, None
        for s in reversed(steps):
            # the probe of this same recovery round already restored
            # and finite-checked this exact candidate — reuse it
            # rather than re-gathering the checkpoint from the shared
            # fs (identity-matched on `like`: a different target tree
            # means a different placement, so no reuse)
            if (probe is not None and probe[0] == s
                    and probe[1] is like):
                restored, manifest = probe[2], probe[3]
                break
            d = _fmt.step_dir(self.manager.root, s)
            try:
                cand, mf = self.manager.restore(like, ckpt_dir=d)
            except CheckpointError:
                fallbacks += 1
                continue
            if not self._params_finite(cand):
                fallbacks += 1
                continue
            restored, manifest = cand, mf
            break
        if restored is None:
            return self.escalate(
                f"rewind found no loadable finite checkpoint under "
                f"{self.manager.root!r} ({fallbacks} rejected; {reason})")
        cursor = (manifest.get("extra") or {}).get("cursor")
        if cursor is None:
            return self.escalate(
                f"checkpoint at step {manifest['step']} carries no data "
                f"cursor in extra['cursor'] — cannot fast-forward past "
                f"the offending window ({reason})")
        source.load_state(cursor)
        skipped = cur_index - int(source.cursor_index())
        if skipped < 0:
            return self.escalate(
                f"data cursor moved backwards across the rewind "
                f"({cur_index} -> {source.cursor_index()}) — the source "
                f"does not match the checkpointed stream ({reason})")
        source.skip_batches(skipped)
        self.rewinds_done += 1
        self.cooldown_until = int(step) + self.cooldown_steps
        self._skip_steps = []
        # resync the counter baseline to the RESTORED guard state: its
        # cumulative counters rewound below the cached high-water mark,
        # and without this a post-rewind anomaly whose counter has not
        # yet re-crossed the stale baseline would difference to <= 0
        # and be silently missed
        from apex_tpu_torch.guard.integrity import IntegrityState
        for leaf in _state_nodes(restored, (GuardState, IntegrityState)):
            if isinstance(leaf, GuardState):
                self._prev = self._fetch(leaf)
            elif isinstance(leaf, IntegrityState):
                # same baseline resync for the integrity counters — a
                # restored mismatch_count below the cached high-water
                # mark would otherwise mask the next real divergence
                self._iprev = self._fetch_integrity(leaf)
        self._emit({"kind": "guard_rewind", "step": int(step),
                    "from_step": int(step),
                    "to_step": int(manifest["step"]),
                    "path": str(self.manager.root),
                    "skipped_batches": int(skipped),
                    "fallbacks": int(fallbacks),
                    "reason": reason or None})
        return restored, manifest

    # -- the last rung ----------------------------------------------------------

    def escalate(self, reason: str):
        """Hand off to the wired
        :class:`~apex_tpu_torch.ckpt.EscalationPolicy`
        (checkpoint + dump + exit 75 / PreemptionError), or raise
        :class:`GuardEscalation` when none is wired."""
        self.drop_probe_cache()    # don't pin a restored tree across it
        self._emit({"kind": "guard_action",
                    "step": int(self._prev["step"]) if self._prev else 0,
                    "action": "escalate", "classes": [],
                    "reason": reason})
        if self.escalation is not None:
            self.escalation.trip(f"guard:{reason}")
            # trip() only returns in raise-mode off the main thread
            # (its documented polling contract); callers of
            # rewind()/escalate() expect a raise or an exit, never a
            # None return they would unpack into a TypeError
        raise GuardEscalation(reason)
