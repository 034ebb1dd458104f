"""Plan-vs-measured comm drift: is the link model still true?

The port of ``apex_tpu/monitor/comm_drift.py``.
:func:`apex_tpu_torch.parallel.plan_comm` schedules the hierarchical sync
against an α–β :class:`~apex_tpu_torch.lint.mesh_model.MeshModel`,
measured once by :mod:`.linkbench`. Links drift (congestion, a degraded
link, a model calibrated on other hardware), and a plan made against a
stale model picks the wrong wire dtype per hop. This module closes the
loop:

1. **measure** (:func:`measure_hops`): time each hop of a
   :class:`~apex_tpu_torch.parallel.CommPlan` as its own collective
   (linkbench's best-of-``iters`` harness at the hop's payload bytes,
   issued ``Hop.n_collectives()`` times back to back so an int8 hop pays
   its α's), or join the wire times the pod observatory measured
   (:func:`wire_from_pod`, positional against the ``ici``/``dcn``
   collective spans of the hierarchical sync);
2. **join** (:func:`compare`): measured seconds against the plan's
   :meth:`~apex_tpu_torch.parallel.CommPlan.hop_seconds`, one
   :class:`HopDrift` row a hop;
3. **flag** (:class:`CommDriftReport`): a hop whose measured/predicted
   ratio leaves ``[1/tolerance, tolerance]`` marks the model stale, with a
   stable fingerprint per hop site (``comm_drift|{op}|{axis}/{link}``).

``kind="pod_drift"`` events ride the podview channel
(``scripts/check_metrics_schema.py --kind podview`` validates). The
linkbench caveat applies: on two gloo processes sharing one card the
times describe gloo on that host.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

__all__ = ["HopDrift", "CommDriftReport", "measure_hops",
           "wire_from_pod", "compare"]


@dataclasses.dataclass(frozen=True)
class HopDrift:
    """One hop's plan-vs-measured row."""

    hop: int                  # position in plan.hops
    op: str
    axis: str
    link: str                 # "ici" | "dcn"
    dtype: Optional[str]
    predicted_ms: float
    measured_ms: float

    @property
    def ratio(self) -> float:
        """measured / predicted (1.0 = the model holds)."""
        return self.measured_ms / max(self.predicted_ms, 1e-9)

    @property
    def fingerprint(self) -> str:
        """Stable site identity (the drifting milliseconds excluded)."""
        return f"comm_drift|{self.op}|{self.axis}/{self.link}"

    def stale(self, tolerance: float) -> bool:
        r = self.ratio
        return r > tolerance or r < 1.0 / tolerance

    def to_event(self, tolerance: float,
                 wall_time: Optional[float] = None) -> Dict:
        return {"kind": "pod_drift", "hop": self.hop, "op": self.op,
                "axis": self.axis, "link": self.link,
                "dtype": self.dtype,
                "predicted_ms": round(self.predicted_ms, 6),
                "measured_ms": round(self.measured_ms, 6),
                "ratio": round(self.ratio, 4),
                "stale": self.stale(tolerance),
                "fingerprint": self.fingerprint,
                "wall_time": (time.time() if wall_time is None
                              else wall_time)}


@dataclasses.dataclass
class CommDriftReport:
    """All hops' drift rows and the verdict."""

    hops: List[HopDrift]
    tolerance: float              # allowed measured/predicted ratio band
    plan_source: str              # "measured" | "defaults"
    mesh_name: Optional[str] = None

    @property
    def stale(self) -> bool:
        """True when any hop left the tolerance band."""
        return any(h.stale(self.tolerance) for h in self.hops)

    @property
    def drift_ratio(self) -> float:
        """Worst symmetric drift over the hops, ``max(ratio, 1/ratio)``
        (1.0 = perfect agreement)."""
        worst = 1.0
        for h in self.hops:
            r = h.ratio
            worst = max(worst, r, 1.0 / max(r, 1e-9))
        return worst

    def stale_hops(self) -> List[HopDrift]:
        return [h for h in self.hops if h.stale(self.tolerance)]

    def advice(self) -> Optional[str]:
        if not self.stale:
            return None
        sites = ", ".join(h.fingerprint for h in self.stale_hops())
        return (f"link model {self.mesh_name or '(unnamed)'} is stale "
                f"at {sites}: re-calibrate with monitor.linkbench and "
                f"re-plan (plan_comm) against the new MeshModel")

    def to_events(self, wall_time: Optional[float] = None) -> List[Dict]:
        """``kind="pod_drift"`` events (podview channel), hop order."""
        wt = time.time() if wall_time is None else wall_time
        return [h.to_event(self.tolerance, wall_time=wt)
                for h in self.hops]

    def table(self) -> str:
        lines = [f"{'hop':<4} {'op':<15} {'axis/link':<14} "
                 f"{'dtype':<6} {'pred_ms':>10} {'meas_ms':>10} "
                 f"{'ratio':>7} {'stale':>6}"]
        for h in self.hops:
            lines.append(
                f"{h.hop:<4} {h.op:<15} "
                f"{h.axis + '/' + h.link:<14} "
                f"{h.dtype or 'fp32':<6} {h.predicted_ms:>10.4f} "
                f"{h.measured_ms:>10.4f} {h.ratio:>7.2f} "
                f"{str(h.stale(self.tolerance)):>6}")
        verdict = self.advice() or (
            f"link model holds (worst drift "
            f"{self.drift_ratio:.2f}x <= {self.tolerance:.1f}x)")
        return "\n".join(lines + [verdict])


def measure_hops(plan, mesh, grad_bytes: Optional[int] = None, *,
                 iters: int = 3) -> List[float]:
    """Best-of-``iters`` seconds per hop of ``plan``, run on ``mesh`` (a
    ``DeviceMesh`` with the plan's axis names at the plan's sizes; every
    rank calls this). Each hop runs as its own collective over a payload
    of the hop's wire bytes (the dtype's compression modelled by a smaller
    f32 buffer), issued ``hop.n_collectives()`` times back to back; one
    warm call a hop. Every rank returns the slowest rank's times."""
    import torch

    from apex_tpu_torch.monitor import linkbench
    from apex_tpu_torch.parallel import comm as _comm

    nbytes = grad_bytes if grad_bytes is not None else \
        (plan.grad_bytes or 0)
    elems = max(int(nbytes) // 4, 1)
    dev = linkbench._device(mesh)
    out: List[float] = []
    for hop, hop_elems in zip(plan.hops, plan._hop_elems(elems)):
        payload = _comm.dtype_wire_bytes(hop_elems, hop.dtype,
                                         plan.compress_block)
        n = max(payload // 4, hop.size)
        n += (-n) % hop.size          # divisible by the axis
        fn = linkbench._collective(hop.op, mesh, hop.axis)
        x = torch.arange(n, dtype=torch.float32, device=dev)
        out.append(linkbench._best_of(fn, x, iters,
                                      reps=hop.n_collectives()))
    for axis in plan.axis_names:
        out = linkbench._agree(out, mesh, axis)
    return out


def wire_from_pod(pod, plan, *, min_samples: int = 1) -> Optional[List[float]]:
    """Per-hop median wire seconds joined from a
    :class:`~apex_tpu_torch.trace.PodTimeline`, or None when the pod
    carries too few matching spans. The join is positional against the
    span names the hierarchical sync gives its hops (``ici``/``dcn``, in
    hop order): the j-th occurrence of a name within a step maps to hop
    position ``positions[name][j % len(positions[name])]``."""
    positions: Dict[str, List[int]] = {}
    for i, hop in enumerate(plan.hops):
        positions.setdefault(hop.link, []).append(i)
    per_hop: List[List[float]] = [[] for _ in plan.hops]
    for c in pod.collective_skew():
        pos = positions.get(c.name)
        if not pos:
            continue
        hop_i = pos[c.occurrence % len(pos)]
        per_hop[hop_i].append(c.wire_ms * 1e-3)
    if any(len(v) < max(int(min_samples), 1) for v in per_hop):
        return None
    out = []
    for v in per_hop:
        s = sorted(v)
        mid = len(s) // 2
        out.append(s[mid] if len(s) % 2 else (s[mid - 1] + s[mid]) / 2.0)
    return out


def compare(plan, measured_s: Sequence[float], *, tolerance: float = 4.0,
            grad_bytes: Optional[int] = None) -> CommDriftReport:
    """Join measured per-hop seconds against the plan's predicted
    ``hop_seconds`` into a :class:`CommDriftReport`. ``tolerance`` is the
    allowed measured/predicted ratio band (symmetric: 4 accepts
    0.25x–4x)."""
    predicted = plan.hop_seconds(grad_bytes)
    if len(measured_s) != len(plan.hops):
        raise ValueError(
            f"measured {len(measured_s)} hops, plan has "
            f"{len(plan.hops)} ({plan.describe()})")
    rows = [HopDrift(hop=i, op=h.op, axis=h.axis, link=h.link,
                     dtype=h.dtype, predicted_ms=p * 1e3,
                     measured_ms=float(m) * 1e3)
            for i, (h, p, m) in enumerate(
                zip(plan.hops, predicted, measured_s))]
    return CommDriftReport(hops=rows, tolerance=float(tolerance),
                           plan_source=plan.source,
                           mesh_name=plan.mesh_name)
