"""Measured link calibration: sweep collectives, fit α–β, emit a MeshModel.

The port of ``apex_tpu/monitor/linkbench.py``. The gradient-sync planner
(:func:`apex_tpu_torch.parallel.plan_comm`) chooses each hop's wire dtype
from a :class:`~apex_tpu_torch.lint.mesh_model.MeshModel`'s byte rates;
this module measures them:

1. **sweep** (:func:`sweep_axis`): time all-reduce / reduce-scatter /
   all-gather over ONE axis of a ``DeviceMesh`` across a ladder of
   message sizes, each through :mod:`apex_tpu_torch.parallel.collectives`
   (scope ``linkbench/<op>``): one warm call, then the best of ``iters``
   host-clock times, each ended by ``torch.cuda.synchronize()`` on a card
   (best-of: the floor is the link, the jitter the host); each point
   keeps the slowest rank's time (one MAX all-reduce), so every rank fits
   the same model and plans the same collectives;
2. **fit** (:func:`fit_alpha_beta`): least squares ``t = α + β·bytes``
   over the ring-model wire bytes per rank (all-reduce moves
   ``2(N−1)/N`` of the buffer, reduce-scatter / all-gather ``(N−1)/N``);
3. **emit** (:func:`calibrate`): one fit per mesh axis, folded per link
   class (the slowest axis of a class bounds it), into a MeshModel whose
   ``link_bytes_per_s`` is measured and whose ``calibration`` records α,
   bytes/s, the residual, the sample count and the axis.

``kind="linkfit"`` events for the goodput channel come from
:func:`linkfit_events` (``scripts/check_metrics_schema.py --kind goodput``
validates).

Caveat, as the JAX package states its ``--cpu8`` one: NCCL does not take
two ranks on one card, so a sweep on one H100 runs two gloo processes,
and its α and bytes/s describe gloo through that host's memory, not
NVLink. What such a run proves is the pipeline (sweep → fit → MeshModel
→ ``plan_comm``); the rates that matter come from a sweep over cards.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.lint.mesh_model import MeshAxis, MeshModel

__all__ = ["LinkSample", "LinkFit", "sweep_axis", "fit_alpha_beta",
           "calibrate", "linkfit_events", "fit_table",
           "DEFAULT_SIZES", "OPS"]

#: message-size ladder (bytes of the logical buffer): spans the
#: latency-dominated and bandwidth-dominated regimes
DEFAULT_SIZES = (1 << 14, 1 << 17, 1 << 20)

#: collective families swept per axis
OPS = ("all_reduce", "reduce_scatter", "all_gather")

#: ring-model wire-byte factor per rank, as a function of axis size N
_RING_FACTOR = {
    "all_reduce": lambda n: 2.0 * (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_gather": lambda n: (n - 1) / n,
}


@dataclasses.dataclass(frozen=True)
class LinkSample:
    """One timed point: op, axis, logical bytes, ring wire bytes a rank,
    best-of seconds."""

    op: str
    axis: str
    size_bytes: int
    wire_bytes: float
    seconds: float


@dataclasses.dataclass(frozen=True)
class LinkFit:
    """α–β fit of one axis (or link class): ``t = alpha_s + wire_bytes /
    bytes_per_s``."""

    axis: str
    alpha_s: float
    bytes_per_s: float
    residual: float               # relative RMS of the fit
    n_samples: int

    def seconds(self, wire_bytes: float) -> float:
        return self.alpha_s + wire_bytes / self.bytes_per_s

    def to_json(self) -> Dict:
        return {"axis": self.axis,
                "alpha_us": round(self.alpha_s * 1e6, 3),
                "bytes_per_s": float(self.bytes_per_s),
                "residual": round(float(self.residual), 6),
                "n_samples": self.n_samples}


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def _device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _collective(op: str, mesh, axis: str):
    """``fn(x)`` running one (op, axis) collective on the full logical
    buffer ``x`` (each rank holds it whole), so the swept size is the
    collective's payload: an all-reduce of ``x``, a reduce-scatter of
    ``x`` into a shard, an all-gather of this rank's shard back into
    ``x``'s size."""
    from apex_tpu_torch.parallel import collectives
    if op not in OPS:
        raise ValueError(f"unknown op {op!r} (want one of {OPS})")
    group = mesh.get_group(axis)
    n = _axis_sizes(mesh)[axis]
    me = mesh.get_local_rank(axis)
    scope = f"linkbench/{op}"
    if op == "all_reduce":
        return lambda x: collectives.all_reduce(x, group, scope)
    if op == "reduce_scatter":
        return lambda x: collectives.reduce_scatter(x, group, scope)

    def gather(x):
        k = x.shape[0] // n
        return collectives.all_gather(x[me * k:(me + 1) * k], group, scope,
                                      tiled=True)
    return gather


def _best_of(fn, x, iters: int, reps: int = 1) -> float:
    """Seconds of ``reps`` back-to-back calls, best of ``iters`` after one
    warm call; a card is synchronised before and after each timing."""
    cuda = x.is_cuda

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for _ in range(reps):
        fn(x)
    sync()
    best = float("inf")
    for _ in range(max(int(iters), 1)):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(x)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _agree(seconds: List[float], mesh, axis: str) -> List[float]:
    """Every rank's times replaced by the slowest rank's (one MAX
    all-reduce), so that the ranks fit, plan and measure alike: the JAX
    package times one program from one host."""
    import torch.distributed as dist
    from apex_tpu_torch.parallel import collectives
    group = mesh.get_group(axis)
    dev = "cpu" if dist.get_backend(group) == "gloo" else _device(mesh)
    t = torch.tensor(seconds, dtype=torch.float64, device=dev)
    collectives.all_reduce(t, group, "linkbench/agree", op=dist.ReduceOp.MAX)
    return t.tolist()


def sweep_axis(mesh, axis: str, *, sizes: Sequence[int] = DEFAULT_SIZES,
               ops: Sequence[str] = OPS, iters: int = 3) -> List[LinkSample]:
    """Time each (op, size) point over ``axis`` of ``mesh`` (a
    ``DeviceMesh``; every rank calls this); one :class:`LinkSample` a
    point, the slowest rank's time, the same on every rank. Buffers are
    f32 on the mesh's device; sizes are rounded up so every op's sharding
    divides evenly."""
    n = _axis_sizes(mesh)[axis]
    if n < 2:
        raise ValueError(f"axis {axis!r} has size {n}; calibrating a "
                         "link needs >= 2 participants")
    dev = _device(mesh)
    points = []
    for op in ops:
        fn = _collective(op, mesh, axis)
        for size in sizes:
            elems = max(int(size) // 4, n)
            elems += (-elems) % n            # divisible by the axis
            x = torch.arange(elems, dtype=torch.float32, device=dev)
            points.append((op, elems * 4, _best_of(fn, x, iters)))
    seconds = _agree([p[2] for p in points], mesh, axis)
    return [LinkSample(op=op, axis=axis, size_bytes=nbytes,
                       wire_bytes=_RING_FACTOR[op](n) * nbytes, seconds=t)
            for (op, nbytes, _), t in zip(points, seconds)]


def fit_alpha_beta(samples: Sequence[LinkSample],
                   axis: Optional[str] = None) -> LinkFit:
    """Least-squares ``t = α + β·wire_bytes`` over the samples. α is
    clamped non-negative and β strictly positive (a noisy sweep can fit a
    negative slope): the fallback slope is the largest sample's aggregate
    rate, the conservative measurable bound."""
    if not samples:
        raise ValueError("no samples to fit")
    b = np.array([s.wire_bytes for s in samples], np.float64)
    t = np.array([s.seconds for s in samples], np.float64)
    a_mat = np.stack([np.ones_like(b), b], axis=1)
    (alpha, beta), *_ = np.linalg.lstsq(a_mat, t, rcond=None)
    alpha = max(float(alpha), 0.0)
    if beta <= 0:
        i = int(np.argmax(b))
        beta = max(float(t[i] / b[i]), 1e-15)
        alpha = 0.0
    pred = alpha + beta * b
    residual = float(np.sqrt(np.mean((pred - t) ** 2)) / max(
        float(np.mean(t)), 1e-12))
    return LinkFit(axis=axis or samples[0].axis, alpha_s=alpha,
                   bytes_per_s=1.0 / float(beta), residual=residual,
                   n_samples=len(samples))


def calibrate(mesh, template: MeshModel, *,
              sizes: Sequence[int] = DEFAULT_SIZES,
              ops: Sequence[str] = OPS, iters: int = 3,
              name: Optional[str] = None,
              ) -> Tuple[MeshModel, Dict[str, LinkFit], List[LinkSample]]:
    """Sweep every axis of ``template`` of size > 1 over the matching
    ``mesh`` axis and return ``(measured_model, per_axis_fits,
    samples)``. ``template`` declares the topology (axis names, sizes,
    link classes: ``parse_mesh_spec("ici2", link_bytes_per_s=...)``);
    ``mesh`` must carry the same axes at the same sizes. Each link class's
    rate becomes the MINIMUM fitted bandwidth over its axes, and the
    model's ``calibration`` records that class's fit."""
    have = _axis_sizes(mesh)
    for ax in template.axes:
        if ax.size > 1 and ax.name not in have:
            raise ValueError(f"template axis {ax.name!r} missing from "
                             f"mesh axes {tuple(have)}")
        if ax.size > 1 and have[ax.name] != ax.size:
            raise ValueError(f"axis {ax.name!r}: template size {ax.size} "
                             f"!= mesh size {have[ax.name]}")
    fits: Dict[str, LinkFit] = {}
    samples: List[LinkSample] = []
    for ax in template.axes:
        if ax.size < 2:
            continue
        ss = sweep_axis(mesh, ax.name, sizes=sizes, ops=ops, iters=iters)
        samples.extend(ss)
        fits[ax.name] = fit_alpha_beta(ss, axis=ax.name)
    if not fits:
        raise ValueError("template has no axis of size >= 2 to calibrate")
    link_bps: Dict[str, float] = {}
    calibration: Dict[str, Dict] = {}
    for ax in template.axes:
        fit = fits.get(ax.name)
        if fit is None:
            continue
        cur = link_bps.get(ax.link)
        if cur is None or fit.bytes_per_s < cur:
            link_bps[ax.link] = fit.bytes_per_s
            calibration[ax.link] = fit.to_json()
    for ax in template.axes:                 # unswept classes keep theirs
        if ax.link not in link_bps:
            link_bps[ax.link] = template.link_bytes_per_s[ax.link]
    model = MeshModel(
        [MeshAxis(a.name, a.size, a.link) for a in template.axes],
        link_bytes_per_s=link_bps,
        name=name or (f"{template.name}-measured" if template.name
                      else "measured"),
        calibration=calibration)
    return model, fits, samples


def linkfit_events(model: MeshModel,
                   rank: Optional[int] = None) -> List[Dict]:
    """``kind="linkfit"`` events (goodput channel) of a calibrated model,
    one per measured link class."""
    if rank is None:
        import torch.distributed as dist
        rank = dist.get_rank() if dist.is_initialized() else 0
    out: List[Dict] = []
    for link, cal in sorted(model.calibration.items()):
        out.append({"kind": "linkfit", "link": link,
                    "axis": cal.get("axis"),
                    "alpha_us": cal.get("alpha_us"),
                    "bytes_per_s": cal.get("bytes_per_s"),
                    "residual": cal.get("residual"),
                    "n_samples": cal.get("n_samples"),
                    "rank": rank, "wall_time": time.time()})
    return out


def fit_table(fits: Dict[str, LinkFit],
              samples: Sequence[LinkSample] = ()) -> str:
    """Aligned per-axis fit summary (plus the sample count per op)."""
    lines = [f"{'axis':<14} {'alpha_us':>10} {'GB/s':>10} "
             f"{'residual':>9} {'samples':>8}"]
    for axis, fit in sorted(fits.items()):
        lines.append(f"{axis:<14} {fit.alpha_s * 1e6:>10.1f} "
                     f"{fit.bytes_per_s / 1e9:>10.3f} "
                     f"{fit.residual:>9.4f} {fit.n_samples:>8}")
    if samples:
        by_op: Dict[str, int] = {}
        for s in samples:
            by_op[s.op] = by_op.get(s.op, 0) + 1
        lines.append("  swept: " + ", ".join(
            f"{op} x{n}" for op, n in sorted(by_op.items())))
    return "\n".join(lines)
