"""Functional dynamic loss scaling with no host syncs.

The port of ``apex_tpu.amp.scaler``. The scaler is explicit state: the
finite flag stays a device tensor, and the schedule and the skip-on-overflow
commit are ``torch.where`` selects, so nothing is read back to the host.

Scale schedule (Apex's ``LossScaler``): init 2**16, growth x2 after 2000
consecutive finite steps, backoff x0.5 on overflow, clamped to
[min_loss_scale, max_loss_scale], max 2**24.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from apex_tpu_torch.utils import tree_all_finite, tree_map, tree_select


class LossScaleConfig(NamedTuple):
    init_scale: float = 2.0 ** 16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    min_loss_scale: Optional[float] = None
    max_loss_scale: float = 2.0 ** 24
    dynamic: bool = True

    @classmethod
    def from_policy_field(cls, loss_scale):
        """Build from a Policy.loss_scale field ('dynamic' | float | None)."""
        if loss_scale is None:
            return None
        if loss_scale == "dynamic":
            return cls(dynamic=True)
        return cls(init_scale=float(loss_scale), dynamic=False)


class LossScaleState(NamedTuple):
    loss_scale: torch.Tensor      # f32 scalar
    growth_tracker: torch.Tensor  # i32 scalar: consecutive finite steps


def loss_scale_init(cfg: Optional[LossScaleConfig],
                    device="cuda") -> Optional[LossScaleState]:
    if cfg is None:
        return None
    return LossScaleState(
        loss_scale=torch.tensor(cfg.init_scale, dtype=torch.float32,
                                device=device),
        growth_tracker=torch.tensor(0, dtype=torch.int32, device=device))


def scale_loss(loss, state: Optional[LossScaleState]):
    """``loss.float() * loss_scale``."""
    loss = loss.float()
    if state is None:
        return loss
    return loss * state.loss_scale


def unscale_grads(grads, state: Optional[LossScaleState], *,
                  upcast_to=torch.float32):
    """Multiply grads by 1/scale in fp32; return (grads, finite flag).

    ``upcast_to=None`` casts each unscaled grad back to its own dtype. On
    overflow the grads are garbage but never consumed: the caller selects
    the old state.
    """
    if state is None:
        finite = tree_all_finite(grads)
        if upcast_to is not None:
            grads = tree_map(lambda g: g.to(upcast_to)
                             if g.is_floating_point() else g, grads)
        return grads, finite
    inv = (1.0 / state.loss_scale).float()

    def _unscale(g):
        if not g.is_floating_point():
            return g
        out = g.float() * inv
        target = g.dtype if upcast_to is None else upcast_to
        return out if target == torch.float32 else out.to(target)

    grads = tree_map(_unscale, grads)
    return grads, tree_all_finite(grads)


def unscale_grads_with_stashed(grads, stashed,
                               state: Optional[LossScaleState], *,
                               stashed_scale=1.0):
    """Gradient accumulation across backwards at (possibly) different
    scales: ``stashed * stashed_scale + grads / scale`` in f32, in one pass
    a leaf, and the finite flag over the result (a device flag)."""
    inv = 1.0 if state is None else (1.0 / state.loss_scale).float()

    def _axpby(g, s):
        if not g.is_floating_point():
            return g
        return g.float() * inv + s.float() * stashed_scale

    out = tree_map(_axpby, grads, stashed)
    return out, tree_all_finite(out)


def loss_scale_update(state: Optional[LossScaleState], grads_finite,
                      cfg: Optional[LossScaleConfig], *, metrics=None):
    """Advance the scale schedule on the device.

    Overflow: scale *= backoff (clamped below by ``min_loss_scale``),
    tracker reset. Else tracker += 1, and at ``growth_interval`` scale *=
    growth (clamped above by ``max_loss_scale``), tracker reset.

    With an :class:`apex_tpu_torch.monitor.Metrics` tuple passed as
    ``metrics=``, the schedule's events are counted on the device
    (overflow / backoff / growth, plus the resulting scale gauge) and
    ``(new_state, metrics')`` is returned instead of just the state.
    """
    if state is None or cfg is None or not cfg.dynamic:
        if metrics is None:
            return state
        dev = metrics.overflow_count.device
        if isinstance(grads_finite, bool):
            overflow = 0 if grads_finite else 1
        else:
            overflow = torch.logical_not(grads_finite.to(dev)).to(
                torch.int32)
        return state, metrics._replace(
            loss_scale=(torch.ones_like(metrics.loss_scale) if state is None
                        else state.loss_scale),
            overflow_count=metrics.overflow_count + overflow)
    scale = state.loss_scale
    tracker = state.growth_tracker
    finite = torch.as_tensor(grads_finite, device=scale.device)

    backoff = scale * cfg.backoff_factor
    if cfg.min_loss_scale is not None:
        backoff = torch.clamp(backoff, min=cfg.min_loss_scale)
    grown_tracker = tracker + 1
    should_grow = grown_tracker >= cfg.growth_interval
    grown = torch.clamp(scale * cfg.growth_factor, max=cfg.max_loss_scale)

    new_scale = torch.where(finite, torch.where(should_grow, grown, scale),
                            backoff).float()
    zero = torch.zeros_like(tracker)
    new_tracker = torch.where(finite,
                              torch.where(should_grow, zero, grown_tracker),
                              zero).to(torch.int32)
    new_state = LossScaleState(loss_scale=new_scale,
                               growth_tracker=new_tracker)
    if metrics is None:
        return new_state
    overflow = torch.logical_not(finite).to(torch.int32)
    grew = torch.logical_and(finite, should_grow).to(torch.int32)
    return new_state, metrics._replace(
        loss_scale=new_scale,
        overflow_count=metrics.overflow_count + overflow,
        backoff_count=metrics.backoff_count + overflow,
        growth_count=metrics.growth_count + grew)


def select_if_finite(grads_finite, new_tree, old_tree):
    """Commit ``new_tree`` where grads were finite, else keep ``old_tree``
    (a ``torch.where`` select: the skipped step)."""
    return tree_select(grads_finite, new_tree, old_tree)


def scaled_backward(fn, params, state: Optional[LossScaleState], *,
                    has_aux: bool = False):
    """Differentiate ``fn(leaves)`` (the loss, or ``(loss, aux)`` with
    ``has_aux``) scaled by ``state``'s loss scale at ``params`` (a ``{name:
    tensor}`` dict; ``leaves`` are its detached copies, the float ones
    requiring grad). Returns ``(out, raw_grads)``: ``out`` detached, the
    grads still scaled, zeros where the loss does not reach a leaf."""
    leaves = {k: v.detach().requires_grad_(v.is_floating_point())
              for k, v in params.items()}
    out = fn(leaves)
    loss = out[0] if has_aux else out
    names = [k for k, v in leaves.items() if v.requires_grad]
    raw = torch.autograd.grad(scale_loss(loss, state),
                              [leaves[k] for k in names], allow_unused=True)
    grads = {k: (torch.zeros_like(leaves[k]) if g is None else g)
             for k, g in zip(names, raw)}
    out = tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                   else t, out)
    return out, grads


def tx_step(tx, grads, opt_state, params):
    """``(new_params, new_opt_state)`` from a fused optimizer's ``step``,
    or from an optax-style ``update`` (updates added in each param's
    dtype) for a ``tx`` with no ``step``."""
    if callable(getattr(tx, "step", None)):
        return tx.step(grads, opt_state, params)
    updates, new_state = tx.update(grads, opt_state, params)
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates), \
        new_state


def device_scalar(value, dtype, device) -> torch.Tensor:
    """A 0-d ``dtype`` tensor on ``device`` from a checkpoint's value (a
    tensor, a numpy array or a Python number)."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(device=device, dtype=dtype).clone()
    return torch.tensor(np.asarray(value).item(), dtype=dtype, device=device)


def value_and_scaled_grad(loss_fn, cfg: Optional[LossScaleConfig], *,
                          has_aux: bool = False, upcast_to=torch.float32):
    """Wrap ``loss_fn(params, *args) -> loss`` into ``f(params,
    scaler_state, *args) -> (out, grads, new_state, finite)``: the loss is
    scaled before the backward, the grads of the float params unscaled in
    f32 with the finite check folded in, and the schedule advanced. ``out``
    holds the unscaled loss (and aux), detached."""

    def wrapped(params, scaler_state, *args, **kwargs):
        out, grads = scaled_backward(
            lambda leaves: loss_fn(leaves, *args, **kwargs), params,
            scaler_state, has_aux=has_aux)
        grads, finite = unscale_grads(grads, scaler_state,
                                      upcast_to=upcast_to)
        return out, grads, loss_scale_update(scaler_state, finite, cfg), \
            finite

    return wrapped
