"""FP16_Optimizer: the explicit master-weights wrapper.

The port of ``apex_tpu.fp16_utils.fp16_optimizer``, a functional state
machine::

    opt = FP16_Optimizer(FusedLAMB(lr=1e-3), dynamic_loss_scale=True)
    state = opt.init(model_params)                # f32 masters + scaler
    out, grads, finite, state = opt.backward(state, loss_fn)
    grads, norm = opt.clip_master_grads(grads, 1.0)
    state = opt.step(state, grads, finite)

``backward`` runs ``loss_fn`` at the masters cast to the half dtype, scales
the loss, takes the grads w.r.t. the f32 masters, unscales them, checks
them and advances the scale schedule; ``step`` commits the inner
optimizer's update only where the grads were finite (masters, optimizer
state and ``step`` hold on an overflow). The legacy dynamic schedule
starts at 2**32 and never grows past its start (``max_loss_scale =
init_scale``), as the reference's.

``monitor=True`` carries an :class:`apex_tpu_torch.monitor.Metrics` tuple
on the state, updated as ``amp.Amp``'s is; the forensic spans
(``fp16/fwd``, ``fp16/unscale``, ``fp16/update``) and NaN probes
(``fp16/fwd``, ``fp16/bwd``, ``fp16/unscale``, ``fp16/update``) sit where
the JAX package's do.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from apex_tpu_torch.amp.scaler import (
    LossScaleConfig, LossScaleState, device_scalar, loss_scale_init,
    loss_scale_update, scaled_backward, tx_step, unscale_grads,
)
from apex_tpu_torch.fp16_utils.fp16util import _clip_factor
from apex_tpu_torch.monitor.metrics import (Metrics, metrics_init,
                                            record_update)
from apex_tpu_torch.trace.debug_nans import nan_probe
from apex_tpu_torch.trace.spans import span as trace_span
from apex_tpu_torch.utils import global_norm, tree_cast, tree_map, tree_select


class FP16OptState(NamedTuple):
    """Step count, f32 masters, the inner optimizer's state and the
    scaler: what the reference's ``state_dict`` saves. ``metrics`` is the
    opt-in telemetry tuple (``FP16_Optimizer(..., monitor=True)``)."""
    step: torch.Tensor
    masters: Any
    inner_state: Any
    scaler: Optional[LossScaleState]
    metrics: Optional[Metrics] = None


class FP16_Optimizer:
    def __init__(self, init_optimizer, *, static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[dict] = None,
                 half_dtype=torch.float16, verbose: bool = False,
                 monitor: bool = False):
        self.tx = init_optimizer
        self.monitor = monitor
        self.half_dtype = half_dtype
        if dynamic_loss_scale:
            args = dynamic_loss_args or {}
            self.cfg = LossScaleConfig(
                init_scale=args.get("init_scale", 2.0 ** 32),
                growth_interval=args.get("scale_window", 1000),
                backoff_factor=1.0 / args.get("scale_factor", 2.0),
                growth_factor=args.get("scale_factor", 2.0),
                max_loss_scale=args.get("init_scale", 2.0 ** 32),
                dynamic=True)
        else:
            self.cfg = LossScaleConfig(init_scale=static_loss_scale,
                                       dynamic=False)
        self.verbose = verbose

    def init(self, model_params) -> FP16OptState:
        """f32 masters from (possibly half) model params."""
        masters = tree_cast({k: v.detach() for k, v in model_params.items()},
                            torch.float32)
        device = next(iter(masters.values())).device
        return FP16OptState(
            step=torch.tensor(0, dtype=torch.int32, device=device),
            masters=masters, inner_state=self.tx.init(masters),
            scaler=loss_scale_init(self.cfg, device),
            metrics=metrics_init(device) if self.monitor else None)

    def model_params(self, state: FP16OptState, like=None):
        """The masters in the half dtype for the forward; ``like`` (a
        params dict) gives each leaf's dtype instead."""
        if like is not None:
            return {k: m.to(like[k].dtype) for k, m in state.masters.items()}
        return tree_cast(state.masters, self.half_dtype)

    def backward(self, state: FP16OptState, loss_fn: Callable, *args,
                 has_aux: bool = False, **kwargs):
        """Scaled backward at the half view of the masters. Returns ``(out,
        master_grads, finite, state')`` with the schedule advanced."""
        sstate = state.scaler

        def run(masters):
            mp = tree_cast(masters, self.half_dtype)
            with trace_span("fp16/fwd"):
                out = loss_fn(mp, *args, **kwargs)
            nan_probe("fp16/fwd", out[0] if has_aux else out)
            return out

        out, grads = scaled_backward(run, state.masters, sstate,
                                     has_aux=has_aux)
        grads = nan_probe("fp16/bwd", grads)
        with trace_span("fp16/unscale"):
            grads, finite = unscale_grads(grads, sstate)
        grads = nan_probe("fp16/unscale", grads)
        if state.metrics is not None:
            new_scaler, metrics = loss_scale_update(
                sstate, finite, self.cfg, metrics=state.metrics)
            metrics = metrics.record_loss(out[0] if has_aux else out)
        else:
            new_scaler = loss_scale_update(sstate, finite, self.cfg)
            metrics = None
        return out, grads, finite, state._replace(scaler=new_scaler,
                                                  metrics=metrics)

    def clip_master_grads(self, grads, max_norm, norm_type=2):
        """Clip the f32 master grads by their global norm: ``(grads,
        norm)``."""
        total = global_norm(grads, ord=norm_type)
        scale = _clip_factor(total, max_norm)
        return tree_map(lambda g: g * scale, grads), total

    def loss_scale(self, state: FP16OptState) -> torch.Tensor:
        return state.scaler.loss_scale

    def step(self, state: FP16OptState, master_grads,
             finite) -> FP16OptState:
        """The inner optimizer's step on the masters, skipped on overflow
        (the telemetry counters advance either way; the grad-norm gauge
        holds its last finite value)."""
        with trace_span("fp16/update"):
            new_masters, new_inner = tx_step(self.tx, master_grads,
                                             state.inner_state, state.masters)
        masters = nan_probe("fp16/update", tree_select(
            finite, new_masters, state.masters))
        inner = tree_select(finite, new_inner, state.inner_state)
        if isinstance(finite, bool):
            new_step = state.step + (1 if finite else 0)
        else:
            new_step = state.step + finite.to(torch.int32)
        metrics = state.metrics
        if metrics is not None:
            metrics = record_update(metrics, finite, master_grads, masters)
        return state._replace(step=new_step, masters=masters,
                              inner_state=inner, metrics=metrics)

    def state_dict(self, state: FP16OptState) -> dict:
        """What the reference's ``FP16_Optimizer.state_dict`` saves."""
        return {
            "loss_scaler": None if state.scaler is None else {
                "loss_scale": state.scaler.loss_scale,
                "unskipped": state.scaler.growth_tracker},
            "first_closure_call_this_step": True,
            "optimizer_state_dict": state.inner_state,
            "fp32_from_fp16": state.masters,
            "step": state.step,
        }

    def load_state_dict(self, state: FP16OptState, sd: dict) -> FP16OptState:
        """``state`` with :meth:`state_dict`'s contents restored (scalers
        and step may be numpy or tensors; they land on ``state``'s device)."""
        dev = state.step.device
        scaler = state.scaler
        if sd.get("loss_scaler") is not None and scaler is not None:
            scaler = LossScaleState(
                loss_scale=device_scalar(sd["loss_scaler"]["loss_scale"],
                                         torch.float32, dev),
                growth_tracker=device_scalar(sd["loss_scaler"]["unskipped"],
                                             torch.int32, dev))
        return state._replace(
            step=device_scalar(sd.get("step", state.step), torch.int32, dev),
            masters=sd["fp32_from_fp16"],
            inner_state=sd["optimizer_state_dict"], scaler=scaler)
