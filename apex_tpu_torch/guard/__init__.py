"""apex_tpu_torch.guard — self-healing training.

The port of ``apex_tpu.guard``: the detect → recover → prove loop.

- **in-step detection** (:mod:`~apex_tpu_torch.guard.detect`): a
  :class:`GuardState` of device tensors carried through the step —
  robust-z loss spikes, grad-norm explosions, nonfinite grad/loss/param
  probes and an amp-style LR backoff, every branch a ``torch.where`` and
  no host sync; skip-class anomalies never commit (``Amp.step(guard=)``).
- **silent-divergence defense** (:mod:`~apex_tpu_torch.guard.integrity`):
  a 32-bit fingerprint of each replica's params, equal to the JAX
  package's on the same tree, compared across the data axis; a quorum
  vote names the minority and the policy repairs it in place with a
  bit-exact broadcast from the majority.
- **the policy ladder** (:mod:`~apex_tpu_torch.guard.policy`):
  :class:`GuardPolicy` escalates per anomaly class — skip/backoff →
  repair → **rewind** to the last good :mod:`apex_tpu_torch.ckpt`
  checkpoint with the data cursor fast-forwarded past the offending
  window → hand-off to :class:`apex_tpu_torch.ckpt.EscalationPolicy`.
- **deterministic chaos** (:mod:`~apex_tpu_torch.guard.chaos`): a seeded,
  replayable :class:`FaultPlan` keyed by (step, rank, site).
"""

from apex_tpu_torch.guard import chaos, integrity
from apex_tpu_torch.guard.chaos import (ChaosHarness, Fault, FaultPlan,
                                        inject_activation, inject_grads)
from apex_tpu_torch.guard.detect import (A_GRAD_EXPLOSION, A_LOSS_SPIKE,
                                         A_NONFINITE_GRAD, A_NONFINITE_LOSS,
                                         A_NONFINITE_PARAM,
                                         A_REPLICA_DIVERGENCE,
                                         ANOMALY_CLASSES, LR_BACKOFF_MASK,
                                         REWIND_MASK, SKIP_MASK, GuardConfig,
                                         GuardState, anomaly_classes,
                                         guard_commit, guard_init,
                                         guard_observe, guard_ok)
from apex_tpu_torch.guard.integrity import (IntegrityConfig,
                                            IntegrityState, IntegrityVote,
                                            absorb_verify, fingerprint_tree,
                                            integrity_check,
                                            integrity_commit,
                                            integrity_init, integrity_ok,
                                            integrity_resize,
                                            make_repair_fn, make_verify_fn,
                                            vote)
from apex_tpu_torch.guard.policy import (GuardAction, GuardEscalation,
                                         GuardPolicy)

__all__ = [
    "GuardConfig", "GuardState", "guard_init", "guard_observe",
    "guard_ok", "guard_commit", "anomaly_classes", "ANOMALY_CLASSES",
    "A_LOSS_SPIKE", "A_GRAD_EXPLOSION", "A_NONFINITE_GRAD",
    "A_NONFINITE_LOSS", "A_NONFINITE_PARAM", "A_REPLICA_DIVERGENCE",
    "SKIP_MASK", "REWIND_MASK", "LR_BACKOFF_MASK",
    "GuardPolicy", "GuardAction", "GuardEscalation",
    "IntegrityConfig", "IntegrityState", "IntegrityVote",
    "integrity_init", "integrity_check", "integrity_ok",
    "integrity_commit", "integrity_resize", "fingerprint_tree",
    "vote", "absorb_verify",
    "make_repair_fn", "make_verify_fn", "integrity",
    "FaultPlan", "Fault", "ChaosHarness", "chaos",
    "inject_grads", "inject_activation",
]
