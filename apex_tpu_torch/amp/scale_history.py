"""Per-tensor delayed scaling: the loss scaler generalized per site.

The port of ``apex_tpu.amp.scale_history``. :class:`ScaleHistoryState`
keeps, per site, a rolling window of measured amax values, the current
scale, a growth tracker and an overflow count, all device tensors.
:func:`scale_history_update` folds one step's per-site amax and derives
the next step's scale::

    scale = 2 ** floor(log2(max_finite / (margin · max(window))))

clamped to ``[min_scale, max_scale]``: always a power of two. A nonfinite
amax is an overflow (scale × backoff at once, tracker reset, the window
records the previous window max instead); a clean step applies the target
at once when it lowers the scale, and raises it only after
``growth_interval`` clean updates and by at most ``growth_factor``. The
update is the JAX package's arithmetic, bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

__all__ = ["FormatSpec", "FORMAT_TABLE", "ScaleHistoryConfig",
           "ScaleHistoryState", "scale_history_init", "scale_history_update",
           "scale_update_events"]


class FormatSpec(NamedTuple):
    """One floating format's range: ``min_exp``/``max_exp`` the unbiased
    exponents of the smallest normal and the largest finite binade,
    ``max_finite`` the largest representable magnitude."""

    name: str
    mantissa_bits: int
    min_exp: int
    max_exp: int
    max_finite: float


#: the port's copy of ``apex_tpu.monitor.numerics.FORMAT_TABLE`` (e4m3 is
#: the OCP "FN" variant: no inf, max 448)
FORMAT_TABLE: Dict[str, FormatSpec] = {
    "fp8_e4m3": FormatSpec("fp8_e4m3", 3, -6, 8, 448.0),
    "fp8_e5m2": FormatSpec("fp8_e5m2", 2, -14, 15, 57344.0),
    "fp16": FormatSpec("fp16", 10, -14, 15, 65504.0),
    "bf16": FormatSpec("bf16", 7, -126, 127, 3.3895314e38),
    "fp32": FormatSpec("fp32", 23, -126, 127, 3.4028235e38),
}


class ScaleHistoryConfig(NamedTuple):
    """Static per-site delayed-scaling configuration."""

    fmt: str = "fp8_e4m3"          #: target format (FORMAT_TABLE key)
    window: int = 16               #: amax history length in updates
    margin: float = 2.0            #: headroom divisor under max_finite
    growth_factor: float = 2.0     #: largest upward move per interval
    backoff_factor: float = 0.5    #: overflow response
    growth_interval: int = 1       #: clean updates per upward move
    min_scale: float = 2.0 ** -64
    max_scale: float = 2.0 ** 64


class ScaleHistoryState(NamedTuple):
    """Per-site state, one row per site (device tensors)."""

    amax_history: torch.Tensor    # f32 (S, window) rolling amax window
    cursor: torch.Tensor          # i32 next window slot (shared)
    scale: torch.Tensor           # f32 (S,) the next step's scale
    growth_tracker: torch.Tensor  # i32 (S,) consecutive clean updates
    overflow_count: torch.Tensor  # i32 (S,) nonfinite-amax events
    step: torch.Tensor            # i32 updates folded


def scale_history_init(cfg: ScaleHistoryConfig = ScaleHistoryConfig(), *,
                       n_sites: int, device="cuda") -> ScaleHistoryState:
    """Fresh state: scales 1.0, an all-zero window. Every factor the scale
    is multiplied or clipped by must be a power of two, so scaling stays an
    exact exponent shift."""
    if cfg.fmt not in FORMAT_TABLE:
        raise ValueError(f"ScaleHistoryConfig.fmt must be one of "
                         f"{tuple(FORMAT_TABLE)}, got {cfg.fmt!r}")
    if int(cfg.window) < 1:
        raise ValueError(f"window must be >= 1, got {cfg.window}")
    if int(n_sites) < 1:
        raise ValueError(f"n_sites must be >= 1, got {n_sites}")
    if not 0.0 < float(cfg.backoff_factor) < 1.0:
        raise ValueError("backoff_factor must be in (0, 1)")
    if float(cfg.growth_factor) < 1.0:
        raise ValueError("growth_factor must be >= 1")
    for name in ("growth_factor", "backoff_factor", "min_scale",
                 "max_scale"):
        v = float(getattr(cfg, name))
        if not (v > 0 and math.frexp(v)[0] == 0.5):
            raise ValueError(f"ScaleHistoryConfig.{name} must be a power of "
                             f"two (scales stay exact exponent shifts), got "
                             f"{v}")
    s, i32 = int(n_sites), torch.int32
    return ScaleHistoryState(
        amax_history=torch.zeros((s, int(cfg.window)), dtype=torch.float32,
                                 device=device),
        cursor=torch.zeros((), dtype=i32, device=device),
        scale=torch.ones((s,), dtype=torch.float32, device=device),
        growth_tracker=torch.zeros((s,), dtype=i32, device=device),
        overflow_count=torch.zeros((s,), dtype=i32, device=device),
        step=torch.zeros((), dtype=i32, device=device))


def _pow2_floor(x: torch.Tensor) -> torch.Tensor:
    """2**floor(log2(x)) for positive f32 x, from the float's own exponent
    (``frexp``: x = m·2^e with m in [0.5, 1), so the binade is e − 1),
    built bit for bit where it is a normal float; a log2/floor chain
    rounds through the transcendental."""
    _m, e = torch.frexp(x)
    e1 = (e - 1).to(torch.int32)
    normal = (e1 >= -126) & (e1 <= 127)
    bits = ((torch.clamp(e1, -126, 127) + 127) << 23).view(torch.float32)
    return torch.where(normal, bits, torch.ldexp(torch.ones_like(x), e1))


def _f32(v, like):
    """``v`` rounded to f32 (as a weakly typed Python float is) and
    broadcast like ``like``."""
    return torch.full_like(like, float(np.float32(v)), dtype=torch.float32)


def scale_history_update(sh: ScaleHistoryState, cfg: ScaleHistoryConfig,
                         amax) -> ScaleHistoryState:
    """Fold one step's per-site amax (f32 (S,), the measured max|x| of each
    site's tensor; nonfinite = an overflow) and derive the next scales."""
    amax = torch.as_tensor(amax, dtype=torch.float32,
                           device=sh.scale.device)
    if amax.shape != sh.scale.shape:
        raise ValueError(f"amax shape {tuple(amax.shape)} != n_sites "
                         f"{tuple(sh.scale.shape)}")
    fmt = FORMAT_TABLE[cfg.fmt]
    finite = torch.isfinite(amax)
    prev_max = sh.amax_history.amax(dim=1)
    recorded = torch.where(finite, amax, prev_max)
    hist = sh.amax_history.clone()
    hist[:, sh.cursor.long() % cfg.window] = recorded
    window_max = hist.amax(dim=1)

    # f32 arithmetic with the config's numbers rounded to f32 first, as
    # the JAX package's weakly typed Python floats are
    denom = _f32(cfg.margin, window_max) * window_max
    target = torch.where(window_max > 0,
                         _pow2_floor(_f32(fmt.max_finite, denom) / denom),
                         sh.scale)
    target = torch.clamp(target, cfg.min_scale, cfg.max_scale)

    zero = torch.zeros_like(sh.growth_tracker)
    tracker = torch.where(finite, sh.growth_tracker + 1, zero)
    may_grow = tracker >= cfg.growth_interval
    grown = torch.minimum(target, torch.clamp(
        sh.scale * _f32(cfg.growth_factor, sh.scale), max=cfg.max_scale))
    clean = torch.where(target < sh.scale, target,
                        torch.where(may_grow, grown, sh.scale))
    backed_off = torch.clamp(sh.scale * _f32(cfg.backoff_factor, sh.scale),
                             min=cfg.min_scale)
    new_scale = torch.where(finite, clean, backed_off).float()
    new_tracker = torch.where(
        finite, torch.where(may_grow & (grown > sh.scale), zero, tracker),
        zero).to(torch.int32)
    return ScaleHistoryState(
        amax_history=hist,
        cursor=((sh.cursor + 1) % cfg.window).to(torch.int32),
        scale=new_scale,
        growth_tracker=new_tracker,
        overflow_count=(sh.overflow_count
                        + (~finite).to(torch.int32)).to(torch.int32),
        step=(sh.step + 1).to(torch.int32))


def scale_update_events(prev: ScaleHistoryState, new: ScaleHistoryState,
                        sites: Sequence[str], *, rank: int = 0,
                        include_holds: bool = False) -> List[Dict]:
    """Host-side diff of two consecutive states into ``kind=
    "scale_update"`` events, one per site whose scale moved (``grow``,
    ``backoff`` on an overflow, else ``shrink``; ``include_holds`` adds
    ``hold`` rows)."""
    ps, nsc = prev.scale.cpu().numpy(), new.scale.cpu().numpy()
    over = (new.overflow_count - prev.overflow_count).cpu().numpy()
    slot = int(prev.cursor) % prev.amax_history.shape[1]
    amax = new.amax_history[:, slot].cpu().numpy()
    step = int(new.step)
    events: List[Dict] = []
    for i, site in enumerate(sites):
        if nsc[i] > ps[i]:
            action = "grow"
        elif nsc[i] < ps[i]:
            action = "backoff" if over[i] > 0 else "shrink"
        elif include_holds:
            action = "hold"
        else:
            continue
        a: Optional[float] = float(amax[i])
        events.append({"kind": "scale_update", "rank": rank, "step": step,
                       "site": site, "action": action,
                       "scale": float(nsc[i]), "prev_scale": float(ps[i]),
                       "amax": a if math.isfinite(a) else None})
    return events
