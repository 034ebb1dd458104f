"""Noise-calibrated convergence A/B harness: the trajectory comparator.

The port of ``apex_tpu/monitor/convergence.py``, host Python only (the
JAX package's module imports no JAX either). "Does trajectory B match
trajectory A?" needs a tolerance, and the right tolerance is the
run-to-run seed noise, which varies by model, batch and step count, so
this module calibrates it instead of guessing it:

- **calibrate** (:func:`calibrate_band`): runs of the SAME configuration
  with paired seeds give a pooled per-step loss-gap sample; the band is
  ``median + z·1.4826·MAD`` of it (a :class:`Band`);
- **compare** (:func:`convergence_report`): walk two trajectories
  step-aligned and name the FIRST step outside the band (``grace`` early
  steps exempt) in a :class:`ConvergenceVerdict`, which serialises as
  the dynamics channel's ``kind="convergence_verdict"`` event
  (``scripts/check_metrics_schema.py --kind dynamics`` validates).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

__all__ = ["Band", "ConvergenceVerdict", "calibrate_band",
           "convergence_report"]

#: MAD → sigma under normality (the perf_sentinel constant)
_MAD_SIGMA = 1.4826


@dataclasses.dataclass(frozen=True)
class Band:
    """A calibrated loss-gap tolerance: ``|loss_a[t] − loss_b[t]| ≤
    threshold`` is "within seed noise"."""

    threshold: float     #: the absolute per-step loss-gap bound
    median_gap: float    #: median |gap| of the calibration trajectory
    mad_gap: float       #: MAD of the calibration |gap|s
    z: float             #: robust-sigma multiplier used
    n_pairs: int         #: calibration run pairs pooled
    n_steps: int         #: calibration steps pooled per pair
    floor: float         #: absolute floor applied

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict) -> "Band":
        return cls(**{f.name: d[f.name]
                      for f in dataclasses.fields(cls)})


def _gaps(a: Sequence[float], b: Sequence[float]) -> List[float]:
    n = min(len(a), len(b))
    return [abs(float(a[t]) - float(b[t])) for t in range(n)]


def _median(xs: List[float]) -> float:
    ys = sorted(xs)
    n = len(ys)
    mid = n // 2
    return ys[mid] if n % 2 else 0.5 * (ys[mid - 1] + ys[mid])


def calibrate_band(runs: Sequence[Sequence[float]], *, z: float = 6.0,
                   floor: float = 1e-9) -> Band:
    """Calibrate the seed-noise band from ≥ 2 paired-seed loss
    trajectories of the SAME config: every pair's per-step |gap|s pool
    into one sample, and the band is ``median + z·1.4826·MAD`` (the
    perf_sentinel statistics applied to convergence), floored at
    ``floor``.

    ``z`` defaults to 6 — deliberately generous: the comparator's job
    is to catch *divergence* (a trajectory leaving the noise cone and
    not coming back), not to referee ULP-level wobble; docs/dynamics.md
    discusses tightening it when more calibration pairs are pooled."""
    runs = [list(map(float, r)) for r in runs]
    if len(runs) < 2:
        raise ValueError(f"calibrate_band needs >= 2 paired-seed runs, "
                         f"got {len(runs)}")
    for i, r in enumerate(runs):
        if len(r) < 2:
            raise ValueError(f"calibration run {i} has {len(r)} steps; "
                             f"need >= 2")
        bad = [v for v in r if not math.isfinite(v)]
        if bad:
            raise ValueError(f"calibration run {i} contains nonfinite "
                             f"losses — calibrate on healthy runs only")
    pooled: List[float] = []
    n_pairs = 0
    n_steps = min(len(r) for r in runs)
    for i in range(len(runs)):
        for j in range(i + 1, len(runs)):
            pooled.extend(_gaps(runs[i], runs[j]))
            n_pairs += 1
    med = _median(pooled)
    mad = _median([abs(g - med) for g in pooled])
    threshold = max(med + z * _MAD_SIGMA * mad, float(floor))
    return Band(threshold=threshold, median_gap=med, mad_gap=mad,
                z=float(z), n_pairs=n_pairs, n_steps=n_steps,
                floor=float(floor))


@dataclasses.dataclass
class ConvergenceVerdict:
    """The A/B comparator's machine-readable answer."""

    verdict: str                    #: "pass" | "flag"
    first_flag_step: Optional[int]  #: first step outside the band
    n_flagged: int                  #: steps outside the band
    n_steps: int                    #: steps compared (min of the two)
    max_gap: float                  #: worst |loss_a − loss_b| seen
    max_gap_step: int               #: where the worst gap sat
    band: Band                      #: the tolerance applied
    grace: int                      #: warmup steps exempted

    @property
    def ok(self) -> bool:
        return self.verdict == "pass"

    @property
    def fingerprint(self) -> str:
        """Stable ``dynamics|convergence|loss`` key — the waiver/pin
        identity (never includes measured numbers or the verdict)."""
        return "dynamics|convergence|loss"

    def to_event(self, rank: int = 0) -> Dict:
        """``kind="convergence_verdict"`` event for the dynamics
        channel (``check_metrics_schema.py --kind dynamics``
        validates)."""
        return {"kind": "convergence_verdict", "rank": rank,
                "step": self.first_flag_step,
                "verdict": self.verdict,
                "first_flag_step": self.first_flag_step,
                "n_flagged": self.n_flagged,
                "n_steps": self.n_steps,
                "max_gap": (self.max_gap
                            if math.isfinite(self.max_gap) else None),
                "band_threshold": self.band.threshold,
                "band_z": self.band.z,
                "fingerprint": self.fingerprint}

    def summary(self) -> str:
        if self.ok:
            return (f"convergence PASS: {self.n_steps} steps within "
                    f"band {self.band.threshold:.4g} (max gap "
                    f"{self.max_gap:.4g} @ step {self.max_gap_step})")
        return (f"convergence FLAG: first excursion at step "
                f"{self.first_flag_step} ({self.n_flagged}/"
                f"{self.n_steps} steps outside band "
                f"{self.band.threshold:.4g}; max gap "
                f"{self.max_gap:.4g} @ step {self.max_gap_step})")


def convergence_report(run_a: Sequence[float],
                       run_b: Sequence[float], *,
                       band: Optional[Band] = None,
                       calibration: Optional[
                           Sequence[Sequence[float]]] = None,
                       z: float = 6.0, floor: float = 1e-9,
                       grace: int = 0) -> ConvergenceVerdict:
    """Compare loss trajectory B against reference A under a
    noise-calibrated band; flag the FIRST step whose |gap| leaves it.

    Pass either ``band`` (a pre-calibrated :class:`Band` — calibrate
    once per config, reuse across comparisons) or ``calibration`` (≥ 2
    paired-seed trajectories; :func:`calibrate_band` runs inline with
    ``z``/``floor``). A nonfinite loss in either run flags immediately
    at that step — divergence to inf/nan is never inside any band.
    ``grace`` exempts the first N steps (warmup, before paired-seed
    trajectories decouple from init noise).
    """
    if band is None:
        if calibration is None:
            raise ValueError("convergence_report needs band= or "
                             "calibration= (>= 2 paired-seed runs)")
        band = calibrate_band(calibration, z=z, floor=floor)
    a = list(map(float, run_a))
    b = list(map(float, run_b))
    n = min(len(a), len(b))
    if n < 1:
        raise ValueError("convergence_report needs non-empty runs")
    first: Optional[int] = None
    n_flagged = 0
    max_gap, max_gap_step = 0.0, 0
    for t in range(n):
        if not (math.isfinite(a[t]) and math.isfinite(b[t])):
            gap = math.inf
        else:
            gap = abs(a[t] - b[t])
        if gap > max_gap:
            max_gap, max_gap_step = gap, t
        if t < grace:
            continue
        if gap > band.threshold:
            n_flagged += 1
            if first is None:
                first = t
    return ConvergenceVerdict(
        verdict="pass" if first is None else "flag",
        first_flag_step=first, n_flagged=n_flagged, n_steps=n,
        max_gap=max_gap, max_gap_step=max_gap_step, band=band,
        grace=int(grace))
