"""High-level amp API: :class:`Amp` and :class:`AmpState`.

The port of ``apex_tpu.amp.api``. The training state is a value: fp32
master params as a ``{name: tensor}`` dict, optimizer state, one loss
scaler per loss and a step counter, all on the device. ``backward``
differentiates the loss at the masters with the model-dtype cast inside
the graph, so grads come back w.r.t. the masters; ``apply_gradients``
commits the optimizer's result only where the grads were finite, so a
skipped step moves neither params, optimizer state nor ``step``.

    amp_opt, state = amp.initialize(dict(model.named_parameters()),
                                    FusedLAMB(lr=1e-3), "O1")
    loss, grads, state, finite = amp_opt.backward(state, loss_fn, *batch)
    state = amp_opt.apply_gradients(state, grads, finite)

Gradient accumulation: ``backward_accumulate`` adds each microbatch's
unscaled f32 grads onto the stash (the dynamic scale may move between
microbatches) and ands the finite flags, so one overflowing microbatch
skips the whole step. ``initialize`` builds the policy preset, the bundle
and its state in one call; ``state_dict``/``load_state_dict`` carry the
scalers (also from the dict the JAX package's ``Amp.state_dict`` gives, as
numpy arrays); ``memory_footprint`` is the analytic byte count of the
state; ``half_function``/``float_function``/``promote_function`` are the
decorators of the reference Apex.

``monitor=True`` carries an :class:`apex_tpu_torch.monitor.Metrics` tuple
on the state (``AmpState.metrics``): the backward records the loss and
the scaler's events, ``apply_gradients`` the grad/param norms and the
step/skip counts — device arithmetic queued with the step, no host sync.
The forensic spans (``amp/fwd``, ``amp/unscale``, ``amp/update``) and the
NaN-provenance probes (``amp/fwd``, ``amp/bwd``, ``amp/unscale``,
``amp/update``) sit where the JAX package's do; both are passive without
a ``trace.Tracer`` and the ``trace.debug_nans`` mode. ``Amp.step``'s
``numerics=`` and ``dynamics=`` hooks fold the numerics and
training-dynamics monitors (:mod:`apex_tpu_torch.monitor.numerics`,
:mod:`apex_tpu_torch.monitor.dynamics`) over the step's cast copy, grads
and update, read-only and with no host sync.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.amp.policy import (
    Policy, _promote, current_policy, policy_scope,
)
from apex_tpu_torch.amp.scaler import (
    LossScaleConfig, LossScaleState, device_scalar, loss_scale_init,
    loss_scale_update, scaled_backward, tx_step, unscale_grads,
    unscale_grads_with_stashed,
)
from apex_tpu_torch.monitor.metrics import (Metrics, metrics_init,
                                            record_update)
from apex_tpu_torch.trace.debug_nans import nan_probe
from apex_tpu_torch.trace.spans import span as trace_span
from apex_tpu_torch.utils import tree_cast, tree_leaves, tree_map, tree_select



class AmpState(NamedTuple):
    """The complete mixed-precision training state.

    ``params`` are the optimizer-facing params: fp32 masters under a
    master-weights policy (O1/O2), model-dtype otherwise (O3). ``metrics``
    is the opt-in telemetry tuple (``Amp(..., monitor=True)``), ``None``
    when monitoring is off, so existing states and checkpoints keep their
    leaves.
    """
    step: torch.Tensor
    params: Any
    opt_state: Any
    scalers: Tuple[Optional[LossScaleState], ...]
    metrics: Optional[Metrics] = None


class Amp:
    """Bundles a precision policy, an optimizer and loss scaling.

    ``monitor=True`` carries a :class:`apex_tpu_torch.monitor.Metrics`
    tuple on the state (see the module docstring); hand ``state.metrics``
    to a :class:`apex_tpu_torch.monitor.MetricsLogger`."""

    def __init__(self, policy: Policy, tx, *, num_losses: int = 1,
                 monitor: bool = False):
        self.policy = policy
        self.tx = tx
        self.num_losses = num_losses
        self.monitor = monitor
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
                          for _ in range(self.num_losses)),
            metrics=metrics_init(device) if self.monitor else None)

    def model_params(self, state: AmpState):
        """Model-dtype view of the params for the forward pass."""
        return self.policy.cast_params(state.params)

    def backward(self, state: AmpState, loss_fn: Callable, *args,
                 loss_id: int = 0, has_aux: bool = False, **kwargs):
        """Scaled backward for one loss.

        ``loss_fn(model_params, *args, **kwargs)`` runs at the masters cast
        to the model dtype. Returns ``(out, grads_fp32, state', finite)``:
        ``finite`` is the Python bool True when the policy has no scaler,
        else a device flag. The ``stashed=None`` case of
        :meth:`backward_accumulate`.
        """
        return self.backward_accumulate(
            state, loss_fn, *args, stashed=None, finite=True,
            loss_id=loss_id, has_aux=has_aux, **kwargs)

    def backward_accumulate(self, state: AmpState, loss_fn: Callable,
                            *args, stashed=None, finite=True,
                            loss_id: int = 0, has_aux: bool = False,
                            **kwargs):
        """Scaled backward whose unscaled f32 grads are added onto
        ``stashed`` (the previous microbatches' f32 grads, or None).

        Each microbatch unscales at the scale current when it runs (the
        dynamic schedule advances per backward); ``finite`` is and-ed with
        this microbatch's flag, so one overflow skips the accumulated step.
        Grads add up as a sum: divide each microbatch's loss by their
        number for a mean. Returns ``(out, acc_grads, state', finite')``::

            acc, fin = None, True
            for mb in microbatches:
                out, acc, state, fin = amp_opt.backward_accumulate(
                    state, loss_fn, mb, stashed=acc, finite=fin)
            state = amp_opt.apply_gradients(state, acc, fin)

        With no scaler ``finite`` passes through unchanged (the Python
        True stays a Python bool); with one, the flags stay device tensors.
        """
        sstate = state.scalers[loss_id]

        # the forensic span and probes of the JAX package's backward:
        # "amp/fwd" names the forward in traces and anchors the NaN
        # provenance; the probes return their argument unless
        # trace.debug_nans is on
        def run(masters):
            mp = self.policy.cast_params(masters)
            with policy_scope(self.policy):
                with trace_span("amp/fwd"):
                    out = loss_fn(mp, *args, **kwargs)
            nan_probe("amp/fwd", out[0] if has_aux else out)
            return out

        out, grads = scaled_backward(run, state.params, sstate,
                                     has_aux=has_aux)
        grads = nan_probe("amp/bwd", grads)
        loss_val = out[0] if has_aux else out
        if self.scale_cfg is None:
            grads = tree_cast(grads, torch.float32)
            if stashed is not None:
                grads = tree_map(lambda s, g: s + g if g.is_floating_point()
                                 else g, stashed, grads)
            if state.metrics is not None:
                m = state.metrics.record_loss(loss_val)
                state = state._replace(metrics=m._replace(
                    loss_scale=torch.ones_like(m.loss_scale)))
            return out, grads, state, finite
        with trace_span("amp/unscale"):
            if stashed is None:
                acc, this_finite = unscale_grads(grads, sstate)
            else:
                acc, this_finite = unscale_grads_with_stashed(grads, stashed,
                                                              sstate)
        acc = nan_probe("amp/unscale", acc)
        if state.metrics is not None:
            new_sstate, metrics = loss_scale_update(
                sstate, this_finite, self.scale_cfg, metrics=state.metrics)
            metrics = metrics.record_loss(loss_val)
        else:
            new_sstate = loss_scale_update(sstate, this_finite,
                                           self.scale_cfg)
            metrics = None
        scalers = tuple(new_sstate if i == loss_id else s
                        for i, s in enumerate(state.scalers))
        if isinstance(finite, bool):
            new_finite = (this_finite if finite
                          else torch.zeros_like(this_finite))
        else:
            new_finite = torch.logical_and(finite, this_finite)
        return out, acc, state._replace(scalers=scalers,
                                        metrics=metrics), new_finite

    def apply_gradients(self, state: AmpState, grads, grads_finite, *,
                        metrics_grad_norm=None) -> AmpState:
        """Optimizer update committed only where grads were finite.

        A fused optimizer's ``step`` gives the new params at once; an
        optax-style ``tx`` with ``update`` and no ``step`` gives updates,
        added to the params in their dtype. Under ``monitor=True`` the
        counters advance on a skipped step too (they are telemetry, not
        training state); the grad-norm gauge holds its last finite value
        across overflows, and ``metrics_grad_norm`` (the guard's true
        norm, when the caller scaled ``grads``) replaces the norm of
        ``grads``."""
        with trace_span("amp/update"):
            new_params, new_opt_state = tx_step(self.tx, grads,
                                                state.opt_state, state.params)
        params = nan_probe("amp/update", tree_select(
            grads_finite, new_params, state.params))
        opt_state = tree_select(grads_finite, new_opt_state, state.opt_state)
        if isinstance(grads_finite, bool):
            step = state.step + (1 if grads_finite else 0)
        else:
            step = state.step + grads_finite.to(torch.int32)
        metrics = state.metrics
        if metrics is not None:
            metrics = record_update(metrics, grads_finite, grads, params,
                                    grad_norm=metrics_grad_norm)
        return state._replace(step=step, params=params, opt_state=opt_state,
                              metrics=metrics)

    def numerics_sites(self, params) -> tuple:
        """The site tuple :meth:`step`'s ``numerics=`` hook observes for
        ``params``-shaped state: one site per leaf for each of ``amp/cast``
        (the model-dtype forward copy), ``amp/grads`` (the unscaled f32
        grads) and ``amp/update`` (the committed update, with the weight
        as its update-to-weight companion), named as the JAX package names
        them. Feed it to :func:`apex_tpu_torch.monitor.numerics.numerics_init`."""
        from apex_tpu_torch.monitor.numerics import site_names
        return site_names({"amp/cast": params, "amp/grads": params,
                           "amp/update": params})

    def dynamics_sites(self, params) -> tuple:
        """The site tuple :meth:`step`'s ``dynamics=`` hook observes: one
        ``dynamics/update`` site per leaf (the committed update, with the
        unscaled f32 grad as the effective-LR companion and the weight as
        the update-to-weight companion). Feed it to
        :func:`apex_tpu_torch.monitor.dynamics.dynamics_init`."""
        from apex_tpu_torch.monitor.dynamics import site_names
        return site_names({"dynamics/update": params})

    def step(self, state: AmpState, loss_fn: Callable, *args,
             loss_id: int = 0, has_aux: bool = False, guard=None,
             numerics=None, dynamics=None, **kwargs):
        """backward + apply in one call. Returns (state', out, finite).

        ``guard=(guard_state, guard_config)`` (or ``(gs, gcfg,
        replica_ok)`` with an integrity verdict) threads the in-step
        anomaly guard (:mod:`apex_tpu_torch.guard`), as the JAX package's
        ``Amp.step`` does: ``guard_observe`` on the loss, the true global
        norm of the unscaled f32 grads and the committed params; the grads
        scaled by ``lr_scale``; the update committed where the grads were
        finite and no skip-class anomaly fired. Returns ``(state', out,
        committed, guard_state')``; nothing is read back to the host.

        Without a loss scaler (bf16) amp has no finiteness flag, and the
        guard takes it from the true norm: the JAX package passes its
        Python ``True`` on, which lets a NaN gradient commit there.

        ``numerics=(numerics_state, numerics_config)`` folds the numerics
        monitor (:func:`apex_tpu_torch.monitor.numerics.numerics_observe`)
        over the model-dtype cast copy of the old params (``amp/cast``),
        the unscaled f32 grads (``amp/grads``, before any guard scaling)
        and the committed update ``new - old`` in f32 with the old params
        as companions (``amp/update``), under :meth:`numerics_sites`. The
        return grows ``numerics_state'`` (after the guard state).
        ``dynamics=(dynamics_state, dynamics_config)``, or ``(ds, dcfg,
        probe)`` with a ``parallel.distributed.dynamics_probe`` result (or
        a zero-arg callable returning one), folds the dynamics monitor
        over the update (``dynamics/update``, :meth:`dynamics_sites`) with
        the grads and the old params as companions; the return grows a
        last element ``dynamics_state'``. The cast copy and the update are
        built only on a fold step; the old params are kept until then (the
        optimizer returns new tensors). Both hooks are read-only: losses
        and params are bit for bit those of the step without them, and
        neither reads anything back to the host.
        """
        out, grads, state, finite = self.backward(
            state, loss_fn, *args, loss_id=loss_id, has_aux=has_aux,
            **kwargs)
        old_params = state.params
        obs_grads = grads
        if guard is None:
            new_state = self.apply_gradients(state, grads, finite)
            ret = (new_state, out, finite)
        else:
            new_state, committed, gs = self._guarded_apply(
                state, grads, finite, out, has_aux, guard)
            ret = (new_state, out, committed, gs)
        if numerics is None and dynamics is None:
            return ret
        from apex_tpu_torch.monitor.numerics import Flat, _leaves, flat_cat
        memo = {}

        def flats():
            # the old params, the grads and the update new - old as flat
            # f32 buffers, once, shared by both hooks
            if not memo:
                old, new = _leaves(old_params), _leaves(new_state.params)
                lengths = tuple(x.numel() for x in old)
                old_flat = flat_cat(old)
                if all(x.is_floating_point() for x in old):
                    delta = flat_cat(new).sub_(old_flat)
                else:
                    delta = flat_cat([n.float() - o.float()
                                      if o.is_floating_point() else n
                                      for n, o in zip(new, old)])
                memo.update(old=Flat(old_flat, lengths),
                            delta=Flat(delta, lengths),
                            grads=Flat(flat_cat(_leaves(obs_grads)),
                                       lengths))
            return memo

        if numerics is not None:
            from apex_tpu_torch.monitor.numerics import numerics_observe
            ns, ncfg = numerics

            def trees():
                cast = self.policy.cast_params(old_params)
                return {"amp/cast": (flats()["old"] if cast is old_params
                                     else cast),
                        "amp/grads": flats()["grads"],
                        "amp/update": flats()["delta"]}

            ret = ret + (numerics_observe(
                ns, ncfg, trees,
                weights={"amp/update": lambda: flats()["old"]}),)
        if dynamics is not None:
            from apex_tpu_torch.monitor.dynamics import dynamics_observe
            ds, dcfg, *probe = dynamics
            ret = ret + (dynamics_observe(
                ds, dcfg, lambda: {"dynamics/update": flats()["delta"]},
                probe=probe[0] if probe else None,
                grads={"dynamics/update": lambda: flats()["grads"]},
                weights={"dynamics/update": lambda: flats()["old"]}),)
        return ret

    def _guarded_apply(self, state, grads, finite, out, has_aux, guard):
        """The guard's observe, LR scaling and commit (``step(guard=)``):
        returns (state', committed, guard_state')."""
        from apex_tpu_torch.guard import guard_observe, guard_ok
        if len(guard) == 3:
            gs, gcfg, replica_ok = guard
        else:
            (gs, gcfg), replica_ok = guard, None
        loss_val = out[0] if has_aux else out
        floats = [g for g in tree_leaves(grads) if g.is_floating_point()]
        true_norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm([g.float() for g in floats])))
        gs = guard_observe(gs, gcfg, loss=loss_val, grad_norm=true_norm,
                           params=state.params,
                           grads_finite=None if finite is True else finite,
                           replica_ok=replica_ok)
        scaled = dict(zip(map(id, floats), torch._foreach_mul(
            floats, gs.lr_scale)))
        grads = tree_map(lambda g: scaled.get(id(g), g), grads)
        committed = guard_ok(gs, gcfg)
        if finite is not True:
            committed = committed & torch.as_tensor(finite).to(
                committed.device)
        return (self.apply_gradients(state, grads, committed,
                                     metrics_grad_norm=true_norm),
                committed, gs)

    # -- memory accounting ---------------------------------------------------

    def memory_footprint(self, params) -> dict:
        """Analytic bytes of the mixed-precision state for ``params``, as
        the JAX package's (dtype names as JAX writes them: "float32").

        Under a master-weights policy (O1/O2) every parameter is held twice:
        the f32 master and the model-dtype forward copy made each step
        (only where the two dtypes differ); O3 keeps one model-dtype copy.
        """
        n = sum(p.numel() for p in tree_leaves(params))
        if self.policy.master_weights or self.policy.cast_model_type is None:
            master_dt = torch.float32
        else:
            master_dt = self.policy.compute_dtype
        model_dt = self.policy.compute_dtype
        master_bytes = n * master_dt.itemsize
        model_copy = (n * model_dt.itemsize
                      if (self.policy.cast_model_type is not None
                          and master_dt != model_dt) else 0)
        scaler_bytes = 8 * self.num_losses if self.scale_cfg is not None \
            else 0
        metrics_bytes = 9 * 4 if self.monitor else 0
        return {
            "n_params": n,
            "master_bytes": master_bytes,
            "model_copy_bytes": model_copy,
            "scaler_bytes": scaler_bytes,
            "metrics_bytes": metrics_bytes,
            "total_bytes": (master_bytes + model_copy + scaler_bytes
                            + metrics_bytes),
            "master_dtype": _dtype_name(master_dt),
            "model_dtype": _dtype_name(model_dt),
        }

    # -- checkpoints ---------------------------------------------------------

    def state_dict(self, state: AmpState) -> dict:
        """The scalers as a plain dict (``amp.state_dict``)."""
        return {
            f"loss_scaler{i}": None if s is None else
            {"loss_scale": s.loss_scale, "unskipped": s.growth_tracker}
            for i, s in enumerate(state.scalers)}

    def load_state_dict(self, state: AmpState, sd) -> AmpState:
        """Restore the scalers from :meth:`state_dict`'s dict, or from the
        JAX package's (numpy or tensor values), onto ``state``'s device."""
        scalers = []
        for i, s in enumerate(state.scalers):
            entry = sd.get(f"loss_scaler{i}")
            if s is None or entry is None:
                scalers.append(s)
                continue
            dev = s.loss_scale.device
            scalers.append(LossScaleState(
                loss_scale=device_scalar(entry["loss_scale"], torch.float32,
                                         dev),
                growth_tracker=device_scalar(entry["unskipped"], torch.int32,
                                             dev)))
        return state._replace(scalers=tuple(scalers))


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")



def initialize(params, tx, opt_level: str = "O1", *,
               half_dtype=torch.bfloat16, num_losses: int = 1,
               verbosity: int = 1, monitor: bool = False,
               **policy_overrides) -> Tuple[Amp, AmpState]:
    """One call: ``amp_opt, state = amp.initialize(params, tx, "O2")``.

    Builds the opt level's policy (keyword overrides win), the ``Amp``
    bundle and its initial state from ``params`` (a ``{name: tensor}``
    dict). ``verbosity=1`` prints the settings on rank 0 through
    ``parallel.launch.maybe_print``; 0 is silent. ``monitor=True`` carries
    the :class:`apex_tpu_torch.monitor.Metrics` tuple on the state."""
    policy = Policy.from_opt_level(opt_level, half_dtype=half_dtype,
                                   **policy_overrides)
    if verbosity > 0:
        from apex_tpu_torch.parallel.launch import maybe_print
        maybe_print(f"apex_tpu_torch.amp: selected optimization level "
                    f"{opt_level}", rank0=True)
        maybe_print("Settings for this optimization level (overrides "
                    "applied):", rank0=True)
        for field in ("enabled", "half_dtype", "cast_model_type",
                      "patch_ops", "keep_batchnorm_fp32", "master_weights",
                      "loss_scale"):
            value = getattr(policy, field)
            if isinstance(value, torch.dtype):
                value = _dtype_name(value)
            maybe_print(f"{field:<24}: {value}", rank0=True)
    amp_opt = Amp(policy, tx, num_losses=num_losses, monitor=monitor)
    return amp_opt, amp_opt.init(params)


# -- the reference Apex's decorators -------------------------------------------

def half_function(fn):
    """Run ``fn`` with floating args cast to the ambient policy's half
    dtype (under a policy that casts: O1's ops or a cast model)."""
    def wrapped(*args, **kwargs):
        p = current_policy()
        if p.enabled and (p.patch_ops or p.cast_model_type is not None):
            args = tree_cast(args, p.half_dtype)
            kwargs = tree_cast(kwargs, p.half_dtype)
        return fn(*args, **kwargs)
    return wrapped


def float_function(fn):
    """Run ``fn`` with floating args cast to fp32 under an enabled
    ambient policy."""
    def wrapped(*args, **kwargs):
        if current_policy().enabled:
            args = tree_cast(args, torch.float32)
            kwargs = tree_cast(kwargs, torch.float32)
        return fn(*args, **kwargs)
    return wrapped


def promote_function(fn):
    """Run ``fn`` with floating args promoted to their widest dtype (a
    Python float counts as f32, as a JAX scalar does)."""
    def wrapped(*args, **kwargs):
        dts = [x.dtype if isinstance(x, torch.Tensor) else torch.float32
               for x in tree_leaves((args, kwargs))
               if isinstance(x, (torch.Tensor, float))]
        if dts:
            target = _promote(dts)
            args = tree_cast(args, target)
            kwargs = tree_cast(kwargs, target)
        return fn(*args, **kwargs)
    return wrapped
