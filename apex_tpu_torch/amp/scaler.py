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

import torch

from apex_tpu_torch.utils import tree_all_finite, tree_cast, tree_map


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


def unscale_grads(grads, state: Optional[LossScaleState]):
    """Multiply grads by 1/scale in fp32; return (grads, finite flag).

    On overflow the grads are garbage but never consumed: the caller
    selects the old state.
    """
    if state is None:
        return tree_cast(grads, torch.float32), tree_all_finite(grads)
    inv = (1.0 / state.loss_scale).float()
    grads = tree_map(lambda g: g.float() * inv if g.is_floating_point()
                     else g, grads)
    return grads, tree_all_finite(grads)


def loss_scale_update(state: Optional[LossScaleState], grads_finite,
                      cfg: Optional[LossScaleConfig]):
    """Advance the scale schedule on the device.

    Overflow: scale *= backoff (clamped below by ``min_loss_scale``),
    tracker reset. Else tracker += 1, and at ``growth_interval`` scale *=
    growth (clamped above by ``max_loss_scale``), tracker reset.
    """
    if state is None or cfg is None or not cfg.dynamic:
        return state
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
    return LossScaleState(loss_scale=new_scale, growth_tracker=new_tracker)
