"""The legacy multi-loss optimizer wrapper, ``OptimWrapper``.

The port of ``apex_tpu.amp.opt``: one optimizer with N independent dynamic
loss scalers. Each ``backward`` unscales one loss at its own scale and adds
its f32 grads onto the stash of the round's earlier losses; ``step`` skips
the update if any loss of the round overflowed, then resets the flag. A
``policy`` given runs each ``loss_fn`` under ``auto_cast(policy)``;
without one the wrapper only scales. Deprecated in the reference too:
prefer :class:`apex_tpu_torch.amp.Amp` with ``num_losses``.
"""

from __future__ import annotations

from typing import Callable

import torch

from apex_tpu_torch.amp.scaler import (
    LossScaleConfig, loss_scale_init, loss_scale_update, scaled_backward,
    tx_step, unscale_grads, unscale_grads_with_stashed,
)
from apex_tpu_torch.utils import tree_select


class OptimWrapper:
    """Per-loss dynamic scalers around one optimizer::

        wrapper = OptimWrapper(tx, num_loss=2)
        wstate = wrapper.init(params)
        _, acc, wstate = wrapper.backward(wstate, params, loss0, 0, None)
        _, acc, wstate = wrapper.backward(wstate, params, loss1, 1, acc)
        params, wstate = wrapper.step(wstate, acc, params)
    """

    def __init__(self, optimizer, num_loss: int = 1,
                 cfg: LossScaleConfig = None, policy=None):
        self.tx = optimizer
        self.num_loss = num_loss
        self.cfg = cfg or LossScaleConfig(dynamic=True)
        self.policy = policy

    def init(self, params):
        device = next(iter(params.values())).device
        return {
            "scalers": tuple(loss_scale_init(self.cfg, device)
                             for _ in range(self.num_loss)),
            "finite": torch.tensor(True, device=device),
            "inner": self.tx.init(params),
        }

    def loss_scale(self, wstate):
        """The current per-loss scales, read to the host."""
        return [float(s.loss_scale) for s in wstate["scalers"]]

    def backward(self, wstate, params, loss_fn: Callable, loss_idx: int,
                 stashed, *args, **kwargs):
        """Grads of ``loss_fn(params, ...)`` unscaled at loss
        ``loss_idx``'s scale and added onto ``stashed`` (None for the
        round's first loss). Returns ``(out, acc_grads, wstate')``."""
        sstate = wstate["scalers"][loss_idx]

        def run(leaves):
            if self.policy is None:
                out = loss_fn(leaves, *args, **kwargs)
            else:
                from apex_tpu_torch.amp.interceptor import auto_cast
                with auto_cast(self.policy):
                    out = loss_fn(leaves, *args, **kwargs)
            # a tuple's first element is the loss, as in the JAX package
            return (out[0] if isinstance(out, tuple) else out), out

        (_, out), grads = scaled_backward(run, params, sstate, has_aux=True)
        if stashed is None:
            acc, finite = unscale_grads(grads, sstate)
        else:
            acc, finite = unscale_grads_with_stashed(grads, stashed, sstate)
        scalers = tuple(
            loss_scale_update(s, finite, self.cfg) if i == loss_idx else s
            for i, s in enumerate(wstate["scalers"]))
        return out, acc, dict(wstate, scalers=scalers,
                              finite=torch.logical_and(wstate["finite"],
                                                       finite))

    def step(self, wstate, grads, params):
        """The inner optimizer's step, skipped if any loss of the round
        overflowed; the flag resets for the next round."""
        new_p, inner = tx_step(self.tx, grads, wstate["inner"], params)
        fin = wstate["finite"]
        new_p = tree_select(fin, new_p, params)
        inner = tree_select(fin, inner, wstate["inner"])
        return new_p, dict(wstate, inner=inner,
                           finite=torch.ones_like(fin))
