"""High-level amp API: :class:`Amp` and :class:`AmpState`.

The port of ``apex_tpu.amp.api``. The training state is a value: fp32
master params as a ``{name: tensor}`` dict, optimizer state, one loss
scaler per loss and a step counter, all on the device. ``backward``
differentiates the loss at the masters with the model-dtype cast inside
the graph, so grads come back w.r.t. the masters; ``apply_gradients``
commits the optimizer's result only where the grads were finite, so a
skipped step moves neither params, optimizer state nor ``step``.

    policy = amp.Policy.from_opt_level("O1")
    amp_opt = amp.Amp(policy, FusedLAMB(lr=1e-3))
    state = amp_opt.init(dict(model.named_parameters()))
    loss, grads, state, finite = amp_opt.backward(state, loss_fn, *batch)
    state = amp_opt.apply_gradients(state, grads, finite)
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.amp.policy import Policy, policy_scope
from apex_tpu_torch.amp.scaler import (
    LossScaleConfig, LossScaleState, loss_scale_init, loss_scale_update,
    scale_loss, unscale_grads,
)
from apex_tpu_torch.utils import tree_cast, tree_map, tree_select

_UNPORTED_HOOK = ("the {} hook of Amp is not ported yet (ROADMAP.md queue A "
                  "item 11, observability; item 10 for guard=)")


class AmpState(NamedTuple):
    """The complete mixed-precision training state.

    ``params`` are the optimizer-facing params: fp32 masters under a
    master-weights policy (O1/O2), model-dtype otherwise (O3).
    """
    step: torch.Tensor
    params: Any
    opt_state: Any
    scalers: Tuple[Optional[LossScaleState], ...]


class Amp:
    """Bundles a precision policy, an optimizer and loss scaling."""

    def __init__(self, policy: Policy, tx, *, num_losses: int = 1,
                 monitor: bool = False):
        if monitor:
            raise NotImplementedError(_UNPORTED_HOOK.format("monitor="))
        self.policy = policy
        self.tx = tx
        self.num_losses = num_losses
        self.scale_cfg = LossScaleConfig.from_policy_field(policy.loss_scale)

    def init(self, params) -> AmpState:
        """Build an AmpState from fp32 params (a ``{name: tensor}`` dict)."""
        params = {k: v.detach() for k, v in params.items()}
        if self.policy.master_weights or self.policy.cast_model_type is None:
            master = tree_cast(params, torch.float32)
        else:
            master = self.policy.cast_params(params)
        device = next(iter(master.values())).device
        return AmpState(
            step=torch.tensor(0, dtype=torch.int32, device=device),
            params=master,
            opt_state=self.tx.init(master),
            scalers=tuple(loss_scale_init(self.scale_cfg, device)
                          for _ in range(self.num_losses)))

    def model_params(self, state: AmpState):
        """Model-dtype view of the params for the forward pass."""
        return self.policy.cast_params(state.params)

    def backward(self, state: AmpState, loss_fn: Callable, *args,
                 loss_id: int = 0, has_aux: bool = False, **kwargs):
        """Scaled backward for one loss.

        ``loss_fn(model_params, *args, **kwargs)`` runs at the masters cast
        to the model dtype. Returns ``(out, grads_fp32, state', finite)``:
        ``finite`` is the Python bool True when the policy has no scaler,
        else a device flag.
        """
        sstate = state.scalers[loss_id]
        masters = {k: v.detach().requires_grad_(v.is_floating_point())
                   for k, v in state.params.items()}
        with policy_scope(self.policy):
            out = loss_fn(self.policy.cast_params(masters), *args, **kwargs)
        loss = out[0] if has_aux else out
        names = [k for k, v in masters.items() if v.requires_grad]
        raw = torch.autograd.grad(scale_loss(loss, sstate),
                                  [masters[k] for k in names],
                                  allow_unused=True)
        grads = {k: (torch.zeros_like(masters[k]) if g is None else g)
                 for k, g in zip(names, raw)}
        out = tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                       else t, out)
        if self.scale_cfg is None:
            return out, tree_cast(grads, torch.float32), state, True
        grads, finite = unscale_grads(grads, sstate)
        new_sstate = loss_scale_update(sstate, finite, self.scale_cfg)
        scalers = tuple(new_sstate if i == loss_id else s
                        for i, s in enumerate(state.scalers))
        return out, grads, state._replace(scalers=scalers), finite

    def apply_gradients(self, state: AmpState, grads,
                        grads_finite) -> AmpState:
        """Optimizer update committed only where grads were finite."""
        new_params, new_opt_state = self.tx.step(grads, state.opt_state,
                                                 state.params)
        params = tree_select(grads_finite, new_params, state.params)
        opt_state = tree_select(grads_finite, new_opt_state, state.opt_state)
        if isinstance(grads_finite, bool):
            step = state.step + (1 if grads_finite else 0)
        else:
            step = state.step + grads_finite.to(torch.int32)
        return state._replace(step=step, params=params, opt_state=opt_state)

    def step(self, state: AmpState, loss_fn: Callable, *args,
             loss_id: int = 0, has_aux: bool = False, guard=None,
             numerics=None, dynamics=None, **kwargs):
        """backward + apply in one call. Returns (state', out, finite)."""
        for name, hook in (("guard=", guard), ("numerics=", numerics),
                           ("dynamics=", dynamics)):
            if hook is not None:
                raise NotImplementedError(_UNPORTED_HOOK.format(name))
        out, grads, state, finite = self.backward(
            state, loss_fn, *args, loss_id=loss_id, has_aux=has_aux,
            **kwargs)
        return self.apply_gradients(state, grads, finite), out, finite
