"""The device half of the telemetry subsystem: a ``Metrics`` tuple.

The port of ``apex_tpu/monitor/metrics.py``. The health counters are a
small tuple of 0-d device tensors carried on the train state exactly
like the loss-scaler state: updates are plain tensor arithmetic queued
with the step's own kernels, so monitoring adds **no host sync** — the
host sees the values only when :class:`apex_tpu_torch.monitor.
MetricsLogger` flushes, amortized over N steps.

Design rules:

- every field is a 0-d tensor (counters int32, gauges float32) — the
  tuple is checkpointable and carried step to step;
- updates are out of place: each step's fields are fresh tensors, so a
  record a logger or flight recorder buffered is never mutated by the
  next step (:func:`metrics_snapshot` clones for callers that update in
  place);
- ``step`` counts *attempted* optimizer steps (skipped ones included) so
  a logged stream is strictly monotonic — the committed-step count lives
  on the train state as before;
- cumulative counters (overflow/skip/growth/backoff) never reset; rates
  are a host-side subtraction.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from apex_tpu_torch.utils import tree_leaves

__all__ = ["Metrics", "metrics_init", "metrics_to_dict",
           "metrics_snapshot", "METRIC_FIELDS", "tree_norm", "record_update"]


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    # a Python number becomes a fill kernel: torch.as_tensor(x, device=
    # "cuda") would be a blocking host-to-device copy
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=like.device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


class Metrics(NamedTuple):
    """Training-health counters/gauges — 0-d device tensors."""

    step: torch.Tensor            # i32: attempted optimizer steps
    loss: torch.Tensor            # f32: last (unscaled) loss value
    loss_scale: torch.Tensor      # f32: current loss scale (1 unscaled)
    grad_norm: torch.Tensor       # f32: global L2 norm of the last grads
    param_norm: torch.Tensor      # f32: global L2 norm of the params
    overflow_count: torch.Tensor  # i32: cumulative non-finite-grad events
    skip_count: torch.Tensor      # i32: cumulative skipped optimizer steps
    growth_count: torch.Tensor    # i32: cumulative loss-scale growths
    backoff_count: torch.Tensor   # i32: cumulative loss-scale backoffs

    # -- update helpers (all out of place; no host interaction) --------------

    def record_loss(self, loss) -> "Metrics":
        return self._replace(loss=_f32(loss, self.loss).detach().reshape(()))

    def record_norms(self, grad_norm=None, param_norm=None) -> "Metrics":
        m = self
        if grad_norm is not None:
            m = m._replace(grad_norm=_f32(grad_norm, self.grad_norm))
        if param_norm is not None:
            m = m._replace(param_norm=_f32(param_norm, self.param_norm))
        return m

    def count_step(self, grads_finite) -> "Metrics":
        """Advance the attempt counter; count a skip when not finite
        (a device flag, or the Python bool of a policy with no scaler)."""
        if isinstance(grads_finite, bool):
            return self._replace(step=self.step + 1, skip_count=(
                self.skip_count if grads_finite else self.skip_count + 1))
        fin = grads_finite.to(self.step.device)
        skipped = torch.logical_not(fin).to(torch.int32)
        return self._replace(step=self.step + 1,
                             skip_count=self.skip_count + skipped)


METRIC_FIELDS = Metrics._fields


def metrics_init(device="cpu") -> Metrics:
    """Zeroed metrics on ``device`` — carry them through the step."""
    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return Metrics(step=i32(0), loss=f32(0.0), loss_scale=f32(1.0),
                   grad_norm=f32(0.0), param_norm=f32(0.0),
                   overflow_count=i32(0), skip_count=i32(0),
                   growth_count=i32(0), backoff_count=i32(0))


def metrics_snapshot(m):
    """A copy of a metrics tuple in fresh device buffers (one clone a
    field, queued on the stream, no sync) — for a caller that updates
    the carried tensors in place after recording them."""
    return type(m)(*(t.clone() for t in m))


def metrics_to_dict(m) -> dict:
    """Host-native dict of one metrics snapshot (tensors already on the
    host, or Python/numpy numbers)."""
    out = {}
    for name, v in zip(Metrics._fields, m):
        if isinstance(v, torch.Tensor):
            v = v.item()
        elif hasattr(v, "item"):
            v = v.item()
        out[name] = int(v) if isinstance(v, (bool, int)) else float(v)
    return out


def tree_norm(tree) -> torch.Tensor:
    """Global L2 norm (f32) of a tree's floating leaves: one
    ``torch._foreach_norm`` per (device, dtype) group and the norm of
    those norms — a few kernels for a whole model, where a per-leaf sum
    of squares launches three a leaf."""
    groups: dict = {}
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            groups.setdefault((x.device, x.dtype), []).append(x)
    norms = []
    for xs in groups.values():
        norms.extend(torch._foreach_norm(
            [x if x.dtype == torch.float32 else x.float() for x in xs]))
    if not norms:
        return torch.zeros((), dtype=torch.float32)
    dev = norms[0].device
    return torch.linalg.vector_norm(torch.stack([n.to(dev) for n in norms]))


def record_update(m: Metrics, grads_finite, grads, params,
                  grad_norm=None) -> Metrics:
    """The optimizer step's telemetry (``Amp.apply_gradients``,
    ``FP16_Optimizer.step``): the attempt and skip counters, and the norms
    of ``grads`` (or the given ``grad_norm``, the true norm of grads the
    caller scaled) and of the committed ``params``. The grad-norm gauge
    holds its last finite value across a skipped step: garbage grads'
    norms would put inf on the wire, and the event is in the counters."""
    gnorm = tree_norm(grads) if grad_norm is None else grad_norm
    if isinstance(grads_finite, bool):
        gnorm = gnorm if grads_finite else m.grad_norm
    else:
        gnorm = torch.where(grads_finite.to(gnorm.device), gnorm,
                            m.grad_norm)
    return m.count_step(grads_finite).record_norms(
        grad_norm=gnorm, param_norm=tree_norm(params))
