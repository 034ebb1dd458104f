"""In-step anomaly detection: the ``GuardState`` of device tensors.

The port of ``apex_tpu.guard.detect``. Apex's dynamic loss scaler is the
prototype in-band anomaly policy — detect a bad step from inside the
step, skip it, adapt, continue — but it only covers fp16 grad overflow.
This module generalizes the pattern to loss spikes (poisoned batches),
gradient-norm explosions and non-finite *parameters* (silent state
corruption, which the grad-overflow check can never see because the
damage is already committed).

Design rules, as in the JAX package:

- ``GuardState`` is a NamedTuple of device scalars plus two fixed-length
  rolling windows, carried through the step like the loss-scaler state.
  Every update is a ``torch.where`` on device tensors: detection adds a
  few small kernels to the step and **no host sync**.
- Spike detection is a **robust z-score** against the rolling loss
  window, ``z = (loss - median) / (1.4826·MAD + floor)``, with the JAX
  package's median (:func:`nanmedian`: the midpoint of the two middle
  values, NaN slots left out) — ``torch.nanmedian`` takes the lower one,
  which on the default even window would move every z.
- Anomalous losses are never pushed into the window, the skipped step is
  a commit-or-keep select (:func:`guard_commit`) and ``lr_scale`` follows
  the amp loss-scale schedule (backoff on spike/explosion, recover after
  ``lr_growth_interval`` clean steps).

Escalation beyond skip/backoff (rewind, exit 75) is host-side — see
:class:`apex_tpu_torch.guard.GuardPolicy`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.utils import global_norm, tree_leaves, tree_select

__all__ = [
    "GuardConfig", "GuardState", "guard_init", "guard_observe",
    "guard_ok", "guard_commit", "anomaly_classes", "nanmedian",
    "A_LOSS_SPIKE", "A_GRAD_EXPLOSION", "A_NONFINITE_GRAD",
    "A_NONFINITE_LOSS", "A_NONFINITE_PARAM", "A_REPLICA_DIVERGENCE",
    "SKIP_MASK", "REWIND_MASK", "LR_BACKOFF_MASK", "ANOMALY_CLASSES",
]

# -- anomaly bitmask -----------------------------------------------------------

A_LOSS_SPIKE = 1        #: finite loss, robust z-score above threshold
A_GRAD_EXPLOSION = 2    #: grad norm >> rolling median grad norm
A_NONFINITE_GRAD = 4    #: NaN/Inf gradients (amp overflow generalized)
A_NONFINITE_LOSS = 8    #: NaN/Inf loss value
A_NONFINITE_PARAM = 16  #: NaN/Inf *committed parameters* — state corruption
A_REPLICA_DIVERGENCE = 32  #: cross-replica integrity fingerprints disagree

ANOMALY_CLASSES = {
    A_LOSS_SPIKE: "loss_spike",
    A_GRAD_EXPLOSION: "grad_explosion",
    A_NONFINITE_GRAD: "nonfinite_grad",
    A_NONFINITE_LOSS: "nonfinite_loss",
    A_NONFINITE_PARAM: "nonfinite_param",
    A_REPLICA_DIVERGENCE: "replica_divergence",
}

#: classes whose step is vetoed in the step (commit-or-keep select).
#: Nonfinite params are NOT here: the corruption already lives in the
#: committed state, so refusing this step's update cannot help — that
#: class is the host policy's rewind trigger. Replica divergence IS here:
#: the diverged replica's gradients entered the all-reduce, so the update
#: is polluted on every replica while the host decides repair vs rewind.
SKIP_MASK = (A_LOSS_SPIKE | A_GRAD_EXPLOSION | A_NONFINITE_GRAD
             | A_NONFINITE_LOSS | A_REPLICA_DIVERGENCE)

#: classes that mean the committed state itself is bad: rewind
REWIND_MASK = A_NONFINITE_PARAM

#: classes that back ``lr_scale`` off. Excludes nonfinite grads: under amp
#: that is fp16 overflow, which the loss scale's schedule already answers
LR_BACKOFF_MASK = A_LOSS_SPIKE | A_GRAD_EXPLOSION


def anomaly_classes(mask: int):
    """Host-side helper: bitmask → sorted list of class names."""
    m = int(mask)
    return [name for bit, name in sorted(ANOMALY_CLASSES.items())
            if m & bit]


class GuardConfig(NamedTuple):
    """Static detector configuration. Thresholds are loose by default — a
    guard that false-positives on healthy noise is worse than none."""

    window: int = 32            #: rolling window length (losses + norms)
    min_history: int = 8        #: detections armed only after this many
                                #: accepted observations
    z_threshold: float = 8.0    #: robust z above which a loss is a spike
    z_rel_floor: float = 0.05   #: MAD floor as a fraction of |median|
    grad_factor: float = 20.0   #: grad norm > factor × rolling median
                                #: grad norm = explosion
    check_params: bool = True   #: enable the nonfinite-param probe
    skip_on_spike: bool = True  #: veto the commit on a loss spike
    lr_backoff: float = 0.5     #: lr_scale multiplier on backoff-class
                                #: anomalies
    lr_growth_interval: int = 50  #: clean steps before lr_scale recovers
                                  #: one ×(1/lr_backoff) notch (→ 1.0)
    min_lr_scale: float = 1.0 / 64.0


class GuardState(NamedTuple):
    """The guard: rolling windows + flags + counters, all device tensors
    (checkpointable with the training state, so a rewind restores the
    detector's memory too). ``anomaly``/``z`` describe the LAST observed
    step; the ``*_count`` fields are cumulative and never reset, so a host
    poll at any cadence can difference them to recover missed events."""

    loss_window: torch.Tensor     # f32[window]; NaN = empty slot
    gnorm_window: torch.Tensor    # f32[window]; NaN = empty slot
    pos: torch.Tensor             # i32 ring write position
    count: torch.Tensor           # i32 observations accepted into windows
    step: torch.Tensor            # i32 observed (attempted) steps
    anomaly: torch.Tensor         # i32 bitmask for the last step
    z: torch.Tensor               # f32 last robust z-score
    lr_scale: torch.Tensor        # f32 LR backoff multiplier
    lr_tracker: torch.Tensor      # i32 clean steps since last backoff
    consecutive: torch.Tensor     # i32 consecutive anomalous steps
    spike_count: torch.Tensor     # i32 cumulative per-class counters…
    grad_explosion_count: torch.Tensor
    nonfinite_grad_count: torch.Tensor
    nonfinite_loss_count: torch.Tensor
    nonfinite_param_count: torch.Tensor
    replica_divergence_count: torch.Tensor
    skip_count: torch.Tensor      # i32 cumulative vetoed steps


def guard_init(cfg: GuardConfig = GuardConfig(),
               device="cuda") -> GuardState:
    """Fresh guard state on ``device`` — thread through the step like
    scaler state."""
    w = int(cfg.window)
    if w < 4:
        raise ValueError(f"GuardConfig.window must be >= 4, got {w} "
                         f"(a robust median needs history)")

    def i32(v):
        return torch.full((), v, dtype=torch.int32, device=device)

    def f32(v):
        return torch.full((), v, dtype=torch.float32, device=device)

    nan = torch.full((w,), float("nan"), dtype=torch.float32, device=device)
    return GuardState(
        loss_window=nan, gnorm_window=nan.clone(),
        pos=i32(0), count=i32(0), step=i32(0),
        anomaly=i32(0), z=f32(0.0),
        lr_scale=f32(1.0), lr_tracker=i32(0), consecutive=i32(0),
        spike_count=i32(0), grad_explosion_count=i32(0),
        nonfinite_grad_count=i32(0), nonfinite_loss_count=i32(0),
        nonfinite_param_count=i32(0), replica_divergence_count=i32(0),
        skip_count=i32(0),
    )


def nanmedian(a: torch.Tensor) -> torch.Tensor:
    """The median of a 1-D f32 tensor's non-NaN values as ``jnp.nanmedian``
    gives it: ``(s[lo] + s[hi]) * 0.5`` in f32 over the sorted values, at
    ``lo = (n - 1) // 2`` and ``hi = n // 2`` of the ``n`` non-NaN ones;
    NaN when all are NaN. Device tensors throughout (NaN sorts last)."""
    n = torch.isnan(a).logical_not().sum()
    s = torch.sort(a).values
    idx = torch.stack([torch.div(n - 1, 2, rounding_mode="floor"),
                       torch.div(n, 2, rounding_mode="floor")]).clamp(min=0)
    lo_hi = torch.gather(s, 0, idx)
    med = (lo_hi[0] + lo_hi[1]) * 0.5
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def _robust_z(loss, window, cfg: GuardConfig):
    """Signed robust z-score of ``loss`` against the rolling window; an
    all-empty window yields NaN, which compares False against the
    threshold — the un-armed guard can never fire."""
    med = nanmedian(window)
    mad = nanmedian(torch.abs(window - med))
    scale = 1.4826 * mad + cfg.z_rel_floor * torch.abs(med) + 1e-12
    return (loss - med) / scale


def _all_finite(tree) -> torch.Tensor:
    """One boolean device scalar: True iff every float element of ``tree``
    is finite. Each (device, dtype) group's largest magnitudes come from
    one ``torch._foreach_norm(..., inf)``, which propagates NaN and cannot
    overflow: a few launches for a model's tree, and no copy of it."""
    groups: dict = {}
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor) and x.is_floating_point() and x.numel():
            groups.setdefault((x.device, x.dtype), []).append(x)
    flags = [torch.isfinite(torch.stack(torch._foreach_norm(
        xs, float("inf")))).all() for xs in groups.values()]
    if not flags:
        return torch.tensor(True)
    return torch.stack([f.to(flags[0].device) for f in flags]).all()


def _flag(value, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.bool)
    return torch.full((), bool(value), dtype=torch.bool, device=device)


def guard_observe(gs: GuardState, cfg: GuardConfig, *, loss,
                  grads=None, grad_norm=None, params=None,
                  grads_finite=None, replica_ok=None) -> GuardState:
    """Observe one step: compute this step's anomaly bitmask against the
    PRE-update windows, advance windows/counters/LR schedule. Device
    tensors only; no host sync.

    ``loss`` is required. ``grads`` (a tree) enables the nonfinite-grad
    check and, unless ``grad_norm`` is given, the explosion check;
    ``grads_finite`` (a precomputed flag — e.g. amp's) substitutes for the
    finiteness traversal. ``params`` enables the nonfinite-param probe
    (pass the *committed* params the step started from). ``replica_ok``
    (:func:`apex_tpu_torch.guard.integrity_ok`) raises the skip-class
    ``A_REPLICA_DIVERGENCE`` anomaly when False.
    """
    dev = gs.count.device
    if isinstance(loss, torch.Tensor):
        loss = loss.to(device=dev, dtype=torch.float32)
    else:
        loss = torch.full((), float(loss), dtype=torch.float32, device=dev)
    armed = gs.count >= cfg.min_history

    z = _robust_z(loss, gs.loss_window, cfg)
    loss_finite = torch.isfinite(loss)
    spike = armed & loss_finite & (z > cfg.z_threshold)

    gnorm = None
    if grad_norm is not None:
        gnorm = (grad_norm.to(device=dev, dtype=torch.float32)
                 if isinstance(grad_norm, torch.Tensor)
                 else torch.full((), float(grad_norm), dtype=torch.float32,
                                 device=dev))
    elif grads is not None:
        gnorm = global_norm(grads).to(dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    if gnorm is not None:
        gmed = nanmedian(gs.gnorm_window)
        # an exploding-to-inf norm belongs to the nonfinite class below
        explosion = (armed & (gnorm > cfg.grad_factor * gmed)
                     & torch.isfinite(gnorm))
    else:
        explosion = false

    if grads_finite is not None:
        g_fin = _flag(grads_finite, dev)
    elif grads is not None:
        g_fin = _all_finite(grads).to(dev)
    elif gnorm is not None:
        g_fin = torch.isfinite(gnorm)
    else:
        g_fin = ~false

    if cfg.check_params and params is not None:
        p_fin = _all_finite(params).to(dev)
    else:
        p_fin = ~false

    r_ok = ~false if replica_ok is None else _flag(replica_ok, dev)

    def _bit(cond, bit):
        return torch.where(cond, bit, 0).to(torch.int32)

    anomaly = (_bit(spike, A_LOSS_SPIKE)
               + _bit(explosion, A_GRAD_EXPLOSION)
               + _bit(~g_fin, A_NONFINITE_GRAD)
               + _bit(~loss_finite, A_NONFINITE_LOSS)
               + _bit(~p_fin, A_NONFINITE_PARAM)
               + _bit(~r_ok, A_REPLICA_DIVERGENCE))
    skip_mask = SKIP_MASK if cfg.skip_on_spike else SKIP_MASK & ~A_LOSS_SPIKE
    skipped = (anomaly & skip_mask) != 0
    anomalous = anomaly != 0

    # --- window advance (clean, finite observations only) --------------------
    accept = ~anomalous & loss_finite
    w = gs.loss_window.shape[0]
    at_pos = torch.arange(w, device=dev) == gs.pos
    new_lw = torch.where(at_pos & accept, loss, gs.loss_window)
    new_gw = (torch.where(at_pos & accept, gnorm, gs.gnorm_window)
              if gnorm is not None else gs.gnorm_window)
    new_pos = torch.where(accept, (gs.pos + 1) % w, gs.pos).to(torch.int32)
    new_count = (gs.count + accept.to(torch.int32)).to(torch.int32)

    # --- LR backoff schedule (amp's loss-scale schedule, LR edition) ---------
    # the recovery tracker counts CLEAN steps only
    backoff_now = (anomaly & LR_BACKOFF_MASK) != 0
    backed = torch.clamp(gs.lr_scale * cfg.lr_backoff, min=cfg.min_lr_scale)
    clean = anomaly == 0
    grown_tracker = gs.lr_tracker + clean.to(torch.int32)
    should_grow = clean & (grown_tracker >= cfg.lr_growth_interval)
    grown = torch.clamp(gs.lr_scale / cfg.lr_backoff, max=1.0)
    new_lr = torch.where(backoff_now, backed,
                         torch.where(should_grow, grown, gs.lr_scale))
    new_tracker = torch.where(backoff_now | should_grow, 0,
                              grown_tracker).to(torch.int32)

    def _cnt(cond):
        return cond.to(torch.int32)

    return gs._replace(
        loss_window=new_lw, gnorm_window=new_gw,
        pos=new_pos, count=new_count, step=gs.step + 1,
        anomaly=anomaly,
        # NaN z (empty window, or a NaN loss) propagates as-is
        z=z.to(torch.float32),
        lr_scale=new_lr.to(torch.float32), lr_tracker=new_tracker,
        consecutive=torch.where(anomalous, gs.consecutive + 1,
                                0).to(torch.int32),
        spike_count=gs.spike_count + _cnt(spike),
        grad_explosion_count=gs.grad_explosion_count + _cnt(explosion),
        nonfinite_grad_count=gs.nonfinite_grad_count + _cnt(~g_fin),
        nonfinite_loss_count=gs.nonfinite_loss_count + _cnt(~loss_finite),
        nonfinite_param_count=gs.nonfinite_param_count + _cnt(~p_fin),
        replica_divergence_count=(gs.replica_divergence_count
                                  + _cnt(~r_ok)),
        skip_count=gs.skip_count + _cnt(skipped),
    )


def guard_ok(gs: GuardState, cfg: Optional[GuardConfig] = None):
    """Commit predicate for the step :func:`guard_observe` just scored: True
    when no skip-class anomaly fired (a device bool)."""
    mask = SKIP_MASK
    if cfg is not None and not cfg.skip_on_spike:
        mask &= ~A_LOSS_SPIKE
    return (gs.anomaly & mask) == 0


def guard_commit(gs: GuardState, new_tree, old_tree,
                 cfg: Optional[GuardConfig] = None):
    """Commit ``new_tree`` unless this step was anomalous."""
    return tree_select(guard_ok(gs, cfg), new_tree, old_tree)
