"""Training-dynamics telemetry: gradient noise scale + replica geometry.

The port of ``apex_tpu/monitor/dynamics.py``:

- **the fold** (:func:`dynamics_observe`): every ``check_every`` steps
  the step folds (a) the gradient-noise-scale inputs, the mean
  per-replica squared grad norm against the pooled mean's, which
  :func:`apex_tpu_torch.parallel.distributed.dynamics_probe` hands over
  from the data-parallel sync (one scalar all-reduce under the registered
  ``ddp/dynamics_gns`` scope), into EMAs the host turns into the
  ``B_simple`` estimator; (b) replica-gradient geometry, the per-replica
  cosine against the pooled mean and the Adasum projection coefficient
  ``g_i·ḡ/|g_i|²`` (one all-gather of scalar pairs under
  ``ddp/dynamics_geom``); (c) per-site effective LR
  (``‖update‖/‖grad‖``) and update-to-weight ratios. The result is a
  :class:`DynamicsState` of device tensors, surfaced through
  ``Amp.step(dynamics=(ds, dcfg))``;
- **the verdict** (:func:`dynamics_report`): host numpy, the JAX
  package's estimator algebra (McCandlish et al., arXiv 1812.06162) and
  its median/MAD effective-LR outliers.

The per-site norms of a fold (the update, the grad and the weight of
every site) are per-chunk norms of flat buffers summed per site
(:mod:`.numerics`), so the kernels a fold launches do not grow with the
leaf count beyond ``torch.cat``'s batching. The cadence is decided on
the host, as in :mod:`.numerics`; an off-step launches only the step
counter's add. Events ride the ``dynamics``
channel (``kind="dynamics_check" | "gns" | "convergence_verdict"``;
``scripts/check_metrics_schema.py --kind dynamics`` validates).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.monitor.numerics import (_advance, _companion, _ema_fns,
                                             _flatten, _host_step, _HOST_STEP,
                                             _layout, _n_sites, _norms,
                                             _resolve, register_step)
# one naming convention across the observatories: a dynamics site and a
# numerics site over the same leaf share their suffix
from apex_tpu_torch.monitor.numerics import site_names  # noqa: F401

__all__ = [
    "DynamicsConfig", "DynamicsState", "DynamicsProbe",
    "DynamicsReport", "site_names", "dynamics_init",
    "dynamics_observe", "dynamics_report", "check_events",
    "stats_to_json", "stats_from_json",
]

#: sentinel for "no probe folded yet" in the world field
_NO_WORLD = -1.0
#: sentinel for spectrum rows with no data (cosine lives in [-1, 1])
_NO_COS = -2.0
#: sentinel for per-site gauges with no data yet
_NO_DATA = -1.0


class DynamicsConfig(NamedTuple):
    """Static observatory configuration."""

    check_every: int = 1   #: fold cadence in steps; 1 = every step
    ema: float = 0.9       #: EMA decay (the first check seeds the window)
    local_batch: int = 1   #: per-replica batch b of the GNS estimator;
                           #: the big batch is ``world * local_batch``


class DynamicsProbe(NamedTuple):
    """The per-step scalars :func:`dynamics_observe` folds for GNS and
    geometry, made by ``parallel.distributed.dynamics_probe`` (which owns
    the two registered collectives); every field is the same on every
    replica."""

    local_sq_mean: torch.Tensor  # f32 mean over replicas of |g_local|²
    pooled_sq: torch.Tensor      # f32 |pooled mean gradient|²
    local_sqs: torch.Tensor      # f32[world] per-replica |g_local|²
    dots: torch.Tensor           # f32[world] per-replica g_i · ḡ
    world: torch.Tensor          # f32 replica count


class DynamicsState(NamedTuple):
    """The training-dynamics monitor: scalar, ``[world]`` and ``[n_sites]``
    device tensors, the JAX package's fields and dtypes."""

    step: torch.Tensor            # i32 observed (attempted) steps
    check_count: torch.Tensor     # i32 cumulative folds executed
    last_check_step: torch.Tensor  # i32 step of the last executed fold
    world: torch.Tensor           # f32 replica count; -1 until a probe folds
    local_sq: torch.Tensor        # f32 last-check mean per-replica |g|²
    local_sq_ema: torch.Tensor    # f32 EMA of local_sq
    pooled_sq: torch.Tensor       # f32 last-check |pooled mean|²
    pooled_sq_ema: torch.Tensor   # f32 EMA of pooled_sq
    cos: torch.Tensor             # f32[W] last-check per-replica cosine
                                  #   vs the pooled mean; -2 = no data
    proj: torch.Tensor            # f32[W] last-check Adasum projection
                                  #   coefficient dot_i/|g_i|²; 0 = no data
    cos_min_ema: torch.Tensor     # f32 EMA of the min-over-replicas cosine
    cos_mean_ema: torch.Tensor    # f32 EMA of the mean-over-replicas cosine
    eff_lr: torch.Tensor          # f32[S] last-check ‖update‖/‖grad‖;
                                  #   -1 = site has no grad companion
    eff_lr_ema: torch.Tensor      # f32[S] EMA of eff_lr
    uw_ratio: torch.Tensor        # f32[S] EMA ‖update‖/‖weight‖;
                                  #   -1 = site has no weight companion


def dynamics_init(cfg: DynamicsConfig = DynamicsConfig(), *,
                  sites: Sequence[str], world: int = 1,
                  device="cuda") -> DynamicsState:
    """Fresh dynamics state on ``device`` for a static site tuple and a
    static replica count ``world`` (the data axis size; 1 for a
    single-replica run, which never folds a probe)."""
    if int(cfg.check_every) < 1:
        raise ValueError(f"DynamicsConfig.check_every must be >= 1, "
                         f"got {cfg.check_every}")
    if not 0.0 < float(cfg.ema) < 1.0:
        raise ValueError(f"DynamicsConfig.ema must be in (0, 1), "
                         f"got {cfg.ema}")
    if int(cfg.local_batch) < 1:
        raise ValueError(f"DynamicsConfig.local_batch must be >= 1, "
                         f"got {cfg.local_batch}")
    s = len(tuple(sites))
    if s < 1:
        raise ValueError("dynamics_init needs at least one site")
    w = int(world)
    if w < 1:
        raise ValueError(f"dynamics_init world must be >= 1, got {world}")

    def f(*shape, value=0.0):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    step = torch.zeros((), dtype=torch.int32, device=device)
    register_step(step, 0)
    return DynamicsState(
        step=step, check_count=torch.zeros_like(step),
        last_check_step=torch.full((), -1, dtype=torch.int32,
                                   device=device),
        world=f(value=_NO_WORLD), local_sq=f(), local_sq_ema=f(),
        pooled_sq=f(), pooled_sq_ema=f(),
        cos=f(w, value=_NO_COS), proj=f(w),
        cos_min_ema=f(value=_NO_COS), cos_mean_ema=f(value=_NO_COS),
        eff_lr=f(s, value=_NO_DATA), eff_lr_ema=f(s, value=_NO_DATA),
        uw_ratio=f(s, value=_NO_DATA))


def dynamics_observe(ds: DynamicsState, cfg: DynamicsConfig, trees, *,
                     probe=None, grads: Optional[Dict[str, Any]] = None,
                     weights: Optional[Dict[str, Any]] = None
                     ) -> DynamicsState:
    """Observe one step: fold GNS/geometry/effective-LR statistics every
    ``cfg.check_every`` steps, advance the counter.

    ``trees`` carries the SAME (prefix -> tree) structure the state's
    sites were built from: the per-site *update* tensors (a prefix may
    hold a :class:`~.numerics.Flat`), or a zero-arg callable returning it,
    called only on a fold step. ``grads`` maps a prefix to the matching
    gradient tree (effective LR ``‖update‖/‖grad‖``), ``weights`` to the
    weight tree (update-to-weight ratio); either may be a zero-arg callable
    returning it, called on a fold step only. ``probe`` is a
    :class:`DynamicsProbe` or a zero-arg callable returning one (its
    collectives then run on fold steps only, which every rank agrees on);
    None leaves the GNS/geometry fields at their sentinels. The cadence is
    the host mirror's, as in :func:`.numerics.numerics_observe`.
    Observation is read-only."""
    grads = grads or {}
    weights = weights or {}
    every = int(cfg.check_every)
    host = None
    if every > 1:
        host = _host_step(ds.step)
        if host % every:
            return _advance(ds, host)
    s_total = int(ds.eff_lr.shape[0])
    w_total = int(ds.cos.shape[0])
    tr = _resolve(trees, (("grads", grads), ("weights", weights)))
    effs, uws = [], []
    n_seen = 0
    for prefix in sorted(tr):
        n = _n_sites(tr[prefix])
        n_seen += n
        fl = _flatten(tr[prefix])
        lay = _layout(fl.lengths, fl.flat.device)
        un = _norms(fl, lay)
        none = torch.full((n,), _NO_DATA, dtype=torch.float32,
                          device=un.device)
        for name, companion, out in (("grads", grads, effs),
                                     ("weights", weights, uws)):
            if prefix not in companion:
                out.append(none)
                continue
            c = _companion(companion[prefix])
            if _n_sites(c) != n:
                raise ValueError(
                    f"companion trees for {prefix!r} have {_n_sites(c)} "
                    f"leaves ({name}), trees[{prefix!r}] has {n}")
            cf = _flatten(c)
            out.append(un / torch.clamp(_norms(
                cf, lay if cf.lengths == fl.lengths else None), min=1e-30))
    if n_seen != s_total:
        raise ValueError(f"dynamics_observe saw {n_seen} sites, state has "
                         f"{s_total} — trees must match dynamics_init's "
                         f"sites")
    eff = effs[0] if len(effs) == 1 else torch.cat(effs)
    uw = uws[0] if len(uws) == 1 else torch.cat(uws)
    _, ema_companion = _ema_fns(cfg, None)
    st = ds._replace(
        eff_lr=eff, eff_lr_ema=ema_companion(ds.eff_lr_ema, eff),
        uw_ratio=ema_companion(ds.uw_ratio, uw),
        check_count=ds.check_count + 1, last_check_step=ds.step)
    pr = probe() if callable(probe) else probe
    if pr is not None:
        if int(pr.local_sqs.shape[0]) != w_total:
            raise ValueError(
                f"dynamics_observe probe has world={pr.local_sqs.shape[0]}"
                f", state was initialized with world={w_total} — pass the "
                f"data axis size to dynamics_init")
        # the probe EMAs seed on the first PROBE fold (world < 0: never)
        pema, _ = _ema_fns(cfg, st.world < 0)
        lsq = pr.local_sq_mean.to(torch.float32)
        psq = pr.pooled_sq.to(torch.float32)
        lsqs = pr.local_sqs.to(torch.float32)
        dots = pr.dots.to(torch.float32)
        cos = dots / torch.sqrt(torch.clamp(lsqs * psq, min=1e-30))
        proj = dots / torch.clamp(lsqs, min=1e-30)
        st = st._replace(
            world=pr.world.to(torch.float32),
            local_sq=lsq, local_sq_ema=pema(st.local_sq_ema, lsq),
            pooled_sq=psq, pooled_sq_ema=pema(st.pooled_sq_ema, psq),
            cos=cos, proj=proj,
            cos_min_ema=pema(st.cos_min_ema, torch.min(cos)),
            cos_mean_ema=pema(st.cos_mean_ema, torch.mean(cos)))
    if host is None:
        new = st._replace(step=ds.step + 1)
        prev = _HOST_STEP.get(ds.step)
        if prev is not None:
            register_step(new.step, prev + 1)
        return new
    return _advance(st, host)


# -- the host half: GNS estimator + report --------------------------------------

def _gns_estimate(local_sq: float, pooled_sq: float, world: float,
                  local_batch: int) -> Dict[str, Optional[float]]:
    """The unbiased small/big-batch pair estimator (arXiv 1812.06162
    appendix A): with per-replica batch ``b`` and big batch ``B =
    world·b``, ``|G|²̂ = (B·|G_B|² − b·|G_b|²) / (B − b)``, ``Ŝ =
    (|G_b|² − |G_B|²) / (1/b − 1/B)`` and ``B_simple = Ŝ / |G|²̂``. None
    fields where the estimate is undefined (world <= 1, no probe, or a
    non-positive estimate)."""
    out: Dict[str, Optional[float]] = {
        "g2_est": None, "s_est": None, "gns": None, "b_crit": None}
    if world is None or world <= 1 or local_batch < 1:
        return out
    b = float(local_batch)
    B = float(world) * b
    g2 = (B * pooled_sq - b * local_sq) / (B - b)
    s = (local_sq - pooled_sq) / (1.0 / b - 1.0 / B)
    out["g2_est"] = g2
    out["s_est"] = s
    if g2 > 0 and s > 0:
        gns = s / g2
        out["gns"] = gns
        out["b_crit"] = gns  # B_simple ≈ B_crit (1812.06162 §2.2)
    return out


@dataclasses.dataclass
class DynamicsReport:
    """One observed run's verdict: the GNS estimate, the replica-geometry
    spectrum and the per-site effective-LR rows with outlier flags."""

    step: int
    check_count: int
    world: Optional[float]          # None until a probe folded
    local_batch: int
    gns: Optional[float]            # B_simple; None when undefined
    b_crit: Optional[float]
    g2_est: Optional[float]
    s_est: Optional[float]
    cos_spectrum: List[float]
    proj_spectrum: List[float]
    cos_min: Optional[float]
    cos_mean: Optional[float]
    cos_min_ema: Optional[float]
    sites: List[str]
    eff_lr: List[Optional[float]]   # EMA rows; None = no companion
    uw_ratio: List[Optional[float]]
    outlier_z: float
    #: sites whose effective-LR EMA sits > outlier_z robust sigmas from
    #: the median
    eff_lr_outliers: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)

    @property
    def fingerprint(self) -> str:
        """Stable ``dynamics|gns|global`` key."""
        return "dynamics|gns|global"

    def table(self, top: int = 8) -> str:
        lines = [f"dynamics — step {self.step}, "
                 f"{self.check_count} checks, world="
                 f"{self.world if self.world is not None else '?'}",
                 f"  gns(B_simple)={_fmt(self.gns)} "
                 f"b_crit={_fmt(self.b_crit)} "
                 f"cos_min={_fmt(self.cos_min)} "
                 f"cos_mean={_fmt(self.cos_mean)}",
                 f"{'site':<44} {'eff_lr':>10} {'uw':>10}"]
        rows = sorted(range(len(self.sites)),
                      key=lambda i: -(self.eff_lr[i] or 0.0))
        for i in rows[:top]:
            lines.append(f"{self.sites[i][:44]:<44} "
                         f"{_fmt(self.eff_lr[i]):>10} "
                         f"{_fmt(self.uw_ratio[i]):>10}")
        for o in self.eff_lr_outliers:
            lines.append(f"  OUTLIER {o['site']}: eff_lr="
                         f"{_fmt(o['eff_lr'])} ({o['sigmas']:.1f}σ)")
        return "\n".join(lines)

    def to_events(self, rank: int = 0) -> List[Dict]:
        """The ``kind="gns"`` event row."""
        return [{
            "kind": "gns", "rank": rank, "step": self.step,
            "check_count": self.check_count,
            "gns": _finite_or_none(self.gns),
            "b_crit": _finite_or_none(self.b_crit),
            "local_sq": None, "pooled_sq": None,
            "world": self.world, "local_batch": self.local_batch,
            "cos_min": self.cos_min, "cos_mean": self.cos_mean,
            "fingerprint": self.fingerprint,
        }]


def _fmt(v) -> str:
    return "-" if v is None else f"{v:.4g}"


def _finite_or_none(v):
    return v if v is not None and math.isfinite(v) else None


def _fetch_stats(ds: DynamicsState, sites: Sequence[str]) -> Dict:
    host = {f: getattr(ds, f).detach().cpu().numpy() for f in ds._fields}
    if len(sites) != host["eff_lr"].shape[0]:
        raise ValueError(f"{len(sites)} sites for a state with "
                         f"{host['eff_lr'].shape[0]} rows")
    out = {"sites": tuple(sites)}
    for f in ("step", "check_count", "last_check_step"):
        out[f] = int(host[f])
    for f in ("world", "local_sq", "local_sq_ema", "pooled_sq",
              "pooled_sq_ema", "cos_min_ema", "cos_mean_ema"):
        out[f] = float(host[f])
    for f in ("cos", "proj", "eff_lr", "eff_lr_ema", "uw_ratio"):
        out[f] = host[f]
    return out


def dynamics_report(ds_or_stats, sites: Optional[Sequence[str]] = None,
                    *, local_batch: Optional[int] = None,
                    outlier_z: float = 3.5) -> DynamicsReport:
    """Join the folded statistics into the host-side verdict.
    ``ds_or_stats`` is a :class:`DynamicsState` (with ``sites``; one host
    fetch) or a stats dict from :func:`stats_from_json`. ``local_batch``
    overrides the per-replica batch of the GNS algebra; ``outlier_z`` is
    the robust-sigma threshold of the effective-LR outliers."""
    if isinstance(ds_or_stats, DynamicsState):
        if sites is None:
            raise ValueError("dynamics_report(DynamicsState) needs "
                             "the matching sites tuple")
        stats = _fetch_stats(ds_or_stats, sites)
    else:
        stats = dict(ds_or_stats)
        sites = tuple(stats["sites"])
    b = int(local_batch if local_batch is not None
            else stats.get("local_batch", 1))
    world = stats["world"]
    probed = world is not None and world > 0
    est = _gns_estimate(stats["local_sq_ema"], stats["pooled_sq_ema"],
                        world if probed else None, b)
    cos = np.asarray(stats["cos"], dtype=np.float64)
    proj = np.asarray(stats["proj"], dtype=np.float64)
    if probed:
        w = int(world)
        cos_spec = [float(v) for v in cos[:w]]
        proj_spec = [float(v) for v in proj[:w]]
        cos_min = float(np.min(cos[:w]))
        cos_mean = float(np.mean(cos[:w]))
        cme = float(stats["cos_min_ema"])
    else:
        cos_spec, proj_spec = [], []
        cos_min = cos_mean = cme = None
    eff = np.asarray(stats["eff_lr_ema"], dtype=np.float64)
    uw = np.asarray(stats["uw_ratio"], dtype=np.float64)
    eff_rows = [None if v < 0 else float(v) for v in eff]
    uw_rows = [None if v < 0 else float(v) for v in uw]
    outliers: List[Dict[str, Any]] = []
    have = np.asarray([v for v in eff_rows if v is not None])
    if have.size >= 3:
        med = float(np.median(have))
        mad = float(np.median(np.abs(have - med)))
        sigma = 1.4826 * mad
        if sigma > 0:
            for i, v in enumerate(eff_rows):
                if v is None:
                    continue
                z = abs(v - med) / sigma
                if z > outlier_z:
                    outliers.append({
                        "site": sites[i], "eff_lr": v,
                        "sigmas": round(z, 2),
                        "fingerprint": f"dynamics|eff_lr|{sites[i]}"})
    return DynamicsReport(
        step=stats["step"], check_count=stats["check_count"],
        world=(float(world) if probed else None), local_batch=b,
        gns=est["gns"], b_crit=est["b_crit"],
        g2_est=est["g2_est"], s_est=est["s_est"],
        cos_spectrum=cos_spec, proj_spectrum=proj_spec,
        cos_min=cos_min, cos_mean=cos_mean, cos_min_ema=cme,
        sites=list(sites), eff_lr=eff_rows, uw_ratio=uw_rows,
        outlier_z=outlier_z, eff_lr_outliers=outliers)


# -- events (the dynamics channel) ----------------------------------------------

def check_events(ds: DynamicsState, sites: Sequence[str], *, rank: int = 0,
                 local_batch: int = 1) -> List[Dict]:
    """One ``kind="dynamics_check"`` aggregate row (``site`` null), one
    per-site row and the ``kind="gns"`` estimator row (one fetch)."""
    stats = _fetch_stats(ds, sites)
    rep = dynamics_report(stats, local_batch=local_batch)
    eff = stats["eff_lr_ema"]
    uw = stats["uw_ratio"]
    events: List[Dict] = [{
        "kind": "dynamics_check", "rank": rank, "step": stats["step"],
        "check_count": stats["check_count"], "site": None,
        "n_sites": len(sites),
        "eff_lr": max((v for v in rep.eff_lr if v is not None),
                      default=None),
        "uw_ratio": max((v for v in rep.uw_ratio if v is not None),
                        default=None),
        "cos_min": rep.cos_min, "cos_mean": rep.cos_mean,
        "world": rep.world,
    }]
    for i, site in enumerate(sites):
        events.append({
            "kind": "dynamics_check", "rank": rank, "step": stats["step"],
            "check_count": stats["check_count"], "site": site,
            "n_sites": len(sites),
            "eff_lr": None if eff[i] < 0 else float(eff[i]),
            "uw_ratio": None if uw[i] < 0 else float(uw[i]),
            "cos_min": None, "cos_mean": None, "world": None,
        })
    gns_row = rep.to_events(rank=rank)[0]
    gns_row["local_sq"] = _finite_or_none(stats["local_sq_ema"])
    gns_row["pooled_sq"] = _finite_or_none(stats["pooled_sq_ema"])
    events.append(gns_row)
    return events


# -- fixture round-trip -----------------------------------------------------------

def stats_to_json(ds: DynamicsState, sites: Sequence[str], *,
                  local_batch: int = 1) -> str:
    """Serialise one fetched measurement, as the JAX package writes it."""
    st = _fetch_stats(ds, sites)
    return json.dumps({
        "version": 1, "sites": list(st["sites"]),
        "step": st["step"], "check_count": st["check_count"],
        "last_check_step": st["last_check_step"],
        "world": st["world"], "local_batch": int(local_batch),
        "local_sq": st["local_sq"], "local_sq_ema": st["local_sq_ema"],
        "pooled_sq": st["pooled_sq"],
        "pooled_sq_ema": st["pooled_sq_ema"],
        "cos": [float(v) for v in st["cos"]],
        "proj": [float(v) for v in st["proj"]],
        "cos_min_ema": st["cos_min_ema"],
        "cos_mean_ema": st["cos_mean_ema"],
        "eff_lr": [float(v) for v in st["eff_lr"]],
        "eff_lr_ema": [float(v) for v in st["eff_lr_ema"]],
        "uw_ratio": [float(v) for v in st["uw_ratio"]],
    }, indent=1)


def stats_from_json(text: str) -> Dict:
    """Inverse of :func:`stats_to_json`; feed it to
    :func:`dynamics_report`."""
    data = json.loads(text)
    out = dict(data)
    for k in ("cos", "proj", "eff_lr", "eff_lr_ema", "uw_ratio"):
        out[k] = np.asarray(data[k], dtype=np.float64)
    return out
