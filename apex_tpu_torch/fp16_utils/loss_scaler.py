"""The legacy loss scalers, ``LossScaler`` and ``DynamicLossScaler``.

The port of ``apex_tpu.fp16_utils.loss_scaler``: classful holders of the
functional scaler state of :mod:`apex_tpu_torch.amp.scaler`, with the legacy
defaults (dynamic: init 2**32, halve on overflow, double after 1000 clean
steps, never above the initial scale), which differ from amp's (2**16,
2000, 2**24).
"""

from __future__ import annotations

import torch

from apex_tpu_torch.amp.scaler import (
    LossScaleConfig, loss_scale_init, loss_scale_update, unscale_grads,
)
from apex_tpu_torch.utils import tree_all_finite


class LossScaler:
    """Static scaler."""

    def __init__(self, scale: float = 1.0, device="cuda"):
        self.cfg = LossScaleConfig(init_scale=scale, dynamic=False)
        self.state = loss_scale_init(self.cfg, device)

    @property
    def loss_scale(self) -> float:
        return float(self.state.loss_scale)

    def scale_gradient(self, grads):
        """Grads divided by the scale, in f32."""
        return unscale_grads(grads, self.state)[0]

    def update_scale(self, overflow: bool) -> None:
        pass  # static

    def has_overflow(self, grads) -> bool:
        return not bool(tree_all_finite(grads))

    def backward(self, loss):
        """The scaled loss, to differentiate."""
        return loss.float() * self.state.loss_scale


class DynamicLossScaler(LossScaler):
    """Dynamic scaler with the legacy schedule: ``init_scale`` 2**32,
    ÷``scale_factor`` on overflow, ×``scale_factor`` after
    ``scale_window`` clean steps, capped at ``init_scale``."""

    def __init__(self, init_scale: float = 2.0 ** 32,
                 scale_factor: float = 2.0, scale_window: int = 1000,
                 device="cuda"):
        self.cfg = LossScaleConfig(
            init_scale=init_scale, growth_factor=scale_factor,
            backoff_factor=1.0 / scale_factor, growth_interval=scale_window,
            max_loss_scale=init_scale, dynamic=True)
        self.state = loss_scale_init(self.cfg, device)

    def update_scale(self, overflow: bool) -> None:
        finite = torch.tensor(not overflow,
                              device=self.state.loss_scale.device)
        self.state = loss_scale_update(self.state, finite, self.cfg)
