"""Per-tensor dynamic-range telemetry: the numerics observatory.

The port of ``apex_tpu/monitor/numerics.py``:

- **the fold** (:func:`numerics_observe`): every ``check_every`` steps
  the step folds, per tracked *site* (a stable string like
  ``"amp/grads/['encoder']['w']"``, spelled as the JAX package's
  ``keystr`` spells it), statistics read off the f32 bit pattern:
  amax/amin and their EMA windows, a biased-exponent histogram (the
  exponent field, ``bits >> 23 & 0xFF``), zero and nonfinite fractions,
  and update-to-weight norm ratios for optimizer-update sites. The
  result is a :class:`NumericsState` of device tensors carried next to
  the guard state; nothing is read back to the host;
- **the format table** (:data:`FORMAT_TABLE`): exponent range and
  mantissa bits of fp32 / bf16 / fp16 / fp8-e4m3 / fp8-e5m2. The
  histogram is kept in exponent space, so the host can price any target
  format and any power-of-two scale (an index shift) against it;
- **the verdict** (:func:`precision_report`) and **the advisor**
  (:func:`placement_advisor`): host numpy, the JAX package's code.

How the fold runs on the card. The JAX package builds each leaf's
statistics with a dozen ``jnp`` ops, which XLA fuses into the one
compiled step. Eager PyTorch would launch each of them per leaf, about
ten thousand kernels a fold for BERT-Large's 876 sites. The port folds
a *prefix* at a time instead: its leaves are concatenated into one flat
f32 buffer (one ``torch.cat``, each leaf padded with zeros to a multiple
of 1024 elements), the exponent of every element is read off its bits
at once, and one int32 ``index_add_`` over ``site * 256 + exponent``
counts all of the prefix's histograms (in 128 lanes a site, summed
after, so that a warp's adds never meet on one counter). Maxima, minima, zero counts and
norms are taken per 1024-element chunk and then per site (a
``scatter_reduce`` or ``scatter_add_`` over each site's own chunks:
int64 for counts, f64 for squared norms). The kernels a fold
launches therefore do not grow with the leaf count, apart from the
``torch.cat`` copies (one launch per 128 inputs). ``torch.bincount`` is
not used: on a CUDA tensor it reads the input's minimum and maximum back
to the host.

One deliberate departure. The JAX package counts its histogram with an
f32 scatter-add, which stops counting at 2^24 elements in a bucket (a
leaf of 16,778,216 ones sums to 16,777,216, and its normalised
histogram to 0.99994). The port counts in int32, which CUDA adds
exactly and in any order to the same result, then normalises in f32 as
the JAX package does. The two agree wherever no bucket passes 2^24
elements; beyond that the port's histogram is the exact one.

Cadence. Off-steps of ``check_every > 1`` fold nothing and launch only
the step counter's add. The JAX package decides this on the device with
a ``lax.cond``; the port decides it on the host, from a host mirror of
``ns.step`` that :func:`numerics_init` (and
:func:`apex_tpu_torch.convert.numerics_state_from_jax`) registers, so the
fold never reads the device. A state whose mirror is unknown is read
once, at its first observation.

Events ride the ``numerics`` channel of :class:`MetricsLogger`
(``kind="numerics_check" | "scale_update" | "precision_verdict"``;
``scripts/check_metrics_schema.py --kind numerics`` validates).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

__all__ = [
    "FormatSpec", "FORMAT_TABLE", "FORMAT_LADDER", "HIST_BINS",
    "NumericsConfig", "NumericsState", "SiteVerdict", "NumericsReport",
    "Flat", "flat_cat", "site_names", "numerics_init", "numerics_observe",
    "finite_ok",
    "scale_amax", "nonfinite_sites", "precision_report",
    "placement_advisor", "format_of_dtype",
    "check_events", "stats_to_json", "stats_from_json",
]

#: biased-exponent histogram resolution: one bucket per f32 exponent
#: value. Exact zeros are excluded (tracked as zero_frac); nonzero
#: subnormals land in bucket 0; bucket 255 (inf/nan) is excluded too
#: (tracked as nonfinite_frac): the histogram is the distribution of
#: finite nonzero magnitudes.
HIST_BINS = 256

#: f32 exponent bias: bucket b holds magnitudes in [2^(b-127), 2^(b-126))
_BIAS = 127

#: elements of the fold's chunks: a leaf is padded with zeros to a
#: multiple of it in the flat buffer, and maxima, minima and norms are
#: taken per chunk, then per site
_CHUNK = 1024
#: counter lanes of a site's histogram: element i counts into lane
#: i % _LANES, so the threads of a warp never add to the same counter and
#: the many warps on one site spread their adds (with one lane a site,
#: the int32 adds on a few hot buckets were the fold's slowest kernel on
#: the card: PERF.md §6)
_LANES = 128
_ABS_MASK = 0x7FFFFFFF


class FormatSpec(NamedTuple):
    """One target floating format's range: ``min_exp``/``max_exp`` are the
    unbiased exponents of the smallest normal and the largest finite
    binade; ``max_finite`` the largest representable magnitude."""

    name: str
    mantissa_bits: int
    min_exp: int
    max_exp: int
    max_finite: float


#: the dtype ladder, narrow to wide. e4m3 is the OCP "FN" variant (no
#: inf, max 448); e5m2 is IEEE-like (max 57344)
FORMAT_TABLE: Dict[str, FormatSpec] = {
    "fp8_e4m3": FormatSpec("fp8_e4m3", 3, -6, 8, 448.0),
    "fp8_e5m2": FormatSpec("fp8_e5m2", 2, -14, 15, 57344.0),
    "fp16": FormatSpec("fp16", 10, -14, 15, 65504.0),
    "bf16": FormatSpec("bf16", 7, -126, 127, 3.3895314e38),
    "fp32": FormatSpec("fp32", 23, -126, 127, 3.4028235e38),
}

#: verdict search order (narrowest safe format wins)
FORMAT_LADDER: Tuple[str, ...] = ("fp8_e4m3", "fp8_e5m2", "fp16",
                                  "bf16", "fp32")

#: dtype name -> FORMAT_TABLE key: the JAX package's names and torch's
_DTYPE_TO_FORMAT = {
    "float32": "fp32", "f32": "fp32", "fp32": "fp32",
    "bfloat16": "bf16", "bf16": "bf16",
    "float16": "fp16", "f16": "fp16", "fp16": "fp16", "half": "fp16",
    "float8_e4m3fn": "fp8_e4m3", "f8e4m3fn": "fp8_e4m3",
    "f8e4m3": "fp8_e4m3", "fp8_e4m3": "fp8_e4m3",
    "float8_e5m2": "fp8_e5m2", "f8e5m2": "fp8_e5m2",
    "fp8_e5m2": "fp8_e5m2",
}


def format_of_dtype(dtype) -> Optional[str]:
    """FORMAT_TABLE key of a dtype (a ``torch.dtype``, a numpy dtype or a
    name as either package spells it), or None when the dtype has no entry
    (ints, f64, ...)."""
    if isinstance(dtype, str):
        return _DTYPE_TO_FORMAT.get(dtype)
    if isinstance(dtype, torch.dtype):
        return _DTYPE_TO_FORMAT.get(str(dtype).replace("torch.", ""))
    return _DTYPE_TO_FORMAT.get(str(np.dtype(dtype).name))


class NumericsConfig(NamedTuple):
    """Static observatory configuration."""

    check_every: int = 1   #: fold cadence in steps; 1 = every step
    ema: float = 0.9       #: EMA decay (the first check seeds the window)


class NumericsState(NamedTuple):
    """The numeric-health monitor: ``[n_sites]`` device tensors, the JAX
    package's fields and dtypes. Row ``i`` of every tensor is site ``i`` of
    :func:`site_names`' tuple."""

    step: torch.Tensor            # i32 observed (attempted) steps
    check_count: torch.Tensor     # i32 cumulative folds executed
    amax: torch.Tensor            # f32[S] last-check max |x| (finite)
    amax_ema: torch.Tensor        # f32[S] EMA of amax
    amin: torch.Tensor            # f32[S] last-check min nonzero |x|
    amin_ema: torch.Tensor        # f32[S] EMA of amin
    exp_hist: torch.Tensor        # f32[S, HIST_BINS] EMA'd normalised
                                  #   biased-exponent histogram
    zero_frac: torch.Tensor       # f32[S] last-check exact-zero fraction
    nonfinite_frac: torch.Tensor  # f32[S] last-check inf/nan fraction
    uw_ratio: torch.Tensor        # f32[S] EMA update/weight norm ratio;
                                  #   -1.0 = site has no weight companion
    last_check_step: torch.Tensor  # i32 step of the last executed fold


class Flat(NamedTuple):
    """A prefix's leaves already concatenated: ``flat`` is one 1-D f32
    tensor in the fold's layout (:func:`flat_cat`: each leaf padded with
    zeros to a multiple of ``_CHUNK`` elements), ``lengths`` the element
    counts of its leaves in site order. Either fold takes one in place of a
    tree (``Amp.step`` hands over its cast copy, grads and update delta
    this way, the delta made by one subtraction of two flat buffers)."""

    flat: torch.Tensor
    lengths: Tuple[int, ...]


# -- sites and leaves -----------------------------------------------------------

def _key_parts(key) -> Tuple[str, ...]:
    """The JAX path components of one dict key of the port: a dotted
    parameter name is the JAX package's nested path, with ``weight``
    renamed as :func:`apex_tpu_torch.convert.jax_name` renames it."""
    from apex_tpu_torch.convert import jax_name
    return tuple(jax_name(str(key)).split("."))


def _walk(tree, path: str = ""):
    """(keystr path, leaf) of a tree in the JAX package's flatten order:
    dict keys sorted by their JAX path components, sequences in order,
    NamedTuple fields as ``.name``; None is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree, key=_key_parts):
            sub = "".join(f"[{c!r}]" for c in _key_parts(k))
            yield from _walk(tree[k], path + sub)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _walk(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}[{i}]")
    else:
        yield path, tree


def _leaves(tree) -> List[torch.Tensor]:
    return [leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
            for _, leaf in _walk(tree)]


def _n_sites(tree) -> int:
    return len(tree.lengths) if isinstance(tree, Flat) else len(
        list(_walk(tree)))


def site_names(trees: Dict[str, Any]) -> Tuple[str, ...]:
    """The stable site tuple for a dict of (prefix -> tree): one site per
    leaf, named ``"{prefix}/{keystr}"`` as the JAX package names it (the
    port's dotted parameter names are JAX's nested paths). Prefixes
    iterate sorted, leaves in the JAX package's flatten order. Use the
    SAME dict structure in :func:`numerics_observe`."""
    names: List[str] = []
    for prefix in sorted(trees):
        for path, _leaf in _walk(trees[prefix]):
            names.append(f"{prefix}/{path}" if path else prefix)
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate numerics sites: {names}")
    return tuple(names)


# -- host mirrors of the step counters -------------------------------------------

_HOST_STEP = WeakIdKeyDictionary()


def register_step(step: torch.Tensor, value: int) -> None:
    """Tell the cadence what ``step`` (a state's device counter) holds, so
    an observation never reads it back."""
    _HOST_STEP[step] = int(value)


def _host_step(step: torch.Tensor) -> int:
    n = _HOST_STEP.get(step)
    return int(step) if n is None else n        # read once, at first use


def _advance(st, host: int):
    """``st`` with its step counter advanced by one (one add)."""
    new = st._replace(step=st.step + 1)
    register_step(new.step, host + 1)
    return new


def _upload(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device`` with no host sync (a pinned, non-blocking
    copy on a card)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def numerics_init(cfg: NumericsConfig = NumericsConfig(), *,
                  sites: Sequence[str], device="cuda") -> NumericsState:
    """Fresh numerics state on ``device`` for a static site tuple (from
    :func:`site_names`); thread it through the step like the guard
    state."""
    if int(cfg.check_every) < 1:
        raise ValueError(f"NumericsConfig.check_every must be >= 1, "
                         f"got {cfg.check_every}")
    if not 0.0 < float(cfg.ema) < 1.0:
        raise ValueError(f"NumericsConfig.ema must be in (0, 1), "
                         f"got {cfg.ema}")
    s = len(tuple(sites))
    if s < 1:
        raise ValueError("numerics_init needs at least one site")

    def z(*shape, value=0.0):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    step = torch.zeros((), dtype=torch.int32, device=device)
    register_step(step, 0)
    return NumericsState(
        step=step, check_count=torch.zeros_like(step),
        amax=z(s), amax_ema=z(s), amin=z(s), amin_ema=z(s),
        exp_hist=z(s, HIST_BINS), zero_frac=z(s), nonfinite_frac=z(s),
        uw_ratio=z(s, value=-1.0),
        last_check_step=torch.full((), -1, dtype=torch.int32,
                                   device=device))


# -- the fold ---------------------------------------------------------------------

def _padded(n: int) -> int:
    return -(-n // _CHUNK) * _CHUNK


def flat_cat(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The leaves as one new 1-D f32 buffer in the fold's layout: each
    leaf flattened and followed by zeros up to a multiple of ``_CHUNK``
    elements (one ``torch.cat``; BERT's leaves need no padding)."""
    parts: List[torch.Tensor] = []
    zeros = None
    for x in leaves:
        x = x.reshape(-1)
        if x.dtype != torch.float32:
            x = x.float()
        parts.append(x)
        pad = _padded(x.numel()) - x.numel()
        if pad:
            if zeros is None:
                zeros = torch.zeros(_CHUNK, dtype=torch.float32,
                                    device=x.device)
            parts.append(zeros[:pad])
    if not parts:
        raise ValueError("a numerics prefix holds no leaf")
    return torch.cat(parts)


def _flatten(tree) -> Flat:
    """A prefix's leaves as a :class:`Flat` (a copy; the caller's tensors
    are never written)."""
    if isinstance(tree, Flat):
        return tree
    leaves = _leaves(tree)
    return Flat(flat_cat(leaves), tuple(x.numel() for x in leaves))


class _Layout(NamedTuple):
    chunk_site: torch.Tensor  # int64[N / _CHUNK]: the site of each chunk
    inv_n: torch.Tensor      # f32[S]: 1/n of each site (0 for empty ones)
    pads: torch.Tensor       # int64[S]: padding zeros of each site


def _layout(lengths: Tuple[int, ...], device) -> _Layout:
    """The per-site constants a fold over ``lengths`` needs, built on the
    device with no host sync. A fold builds them anew and drops them with
    its other buffers: nothing outlives the fold."""
    chunks = np.asarray([_padded(n) // _CHUNK for n in lengths], np.int64)
    chunk_site = torch.repeat_interleave(
        torch.arange(len(lengths), dtype=torch.int64, device=device),
        _upload(chunks, device), output_size=int(chunks.sum()))
    inv = np.asarray([np.float32(1.0 / k) if k else np.float32(0)
                      for k in lengths], np.float32)
    pads = np.asarray([_padded(k) - k for k in lengths], np.int64)
    return _Layout(chunk_site, _upload(inv, device), _upload(pads, device))


def _site_reduce(chunk_vals: torch.Tensor, lay: _Layout, s: int,
                 how: str, init: float) -> torch.Tensor:
    """f32[S]: per-site max or min of per-chunk values (a scatter over a
    site's contiguous chunks; max and min do not depend on the order)."""
    out = torch.full((s,), init, dtype=torch.float32,
                     device=chunk_vals.device)
    return out.scatter_reduce_(0, lay.chunk_site, chunk_vals, how,
                               include_self=True)


def _site_sum(chunk_vals: torch.Tensor, lay: _Layout) -> torch.Tensor:
    """[S]: per-site sum of per-chunk values, by one ``scatter_add_`` over
    each site's own chunks: in int64 for counts (exact), in f64 for
    floats (only the last f64 bits depend on the atomics' order)."""
    v = chunk_vals.double() if chunk_vals.is_floating_point() else \
        chunk_vals.long()
    out = torch.zeros(lay.inv_n.shape[0], dtype=v.dtype, device=v.device)
    return out.scatter_add_(0, lay.chunk_site, v)


def _flat_stats(fl: Flat, lay: _Layout):
    """(amax, amin, normalised histogram, zero_frac, nonfinite_frac) of
    every site of one flattened prefix — the JAX package's
    ``_leaf_stats`` for all of its leaves at once: a fixed number of
    kernels, whatever the leaf count. Maxima and minima are per
    ``_CHUNK``-element chunk, then per site; the histogram is one int32
    ``index_add_`` over ``(site * _LANES + lane) * 256 + exponent``, its
    lanes summed after. The key's offsets are broadcast per chunk and per
    lane (``_CHUNK`` is a multiple of ``_LANES``), so no N-sized constant
    is kept."""
    x, lengths = fl.flat, fl.lengths
    s = len(lengths)
    absb = x.view(torch.int32) & _ABS_MASK
    ax = absb.view(torch.float32)
    finite = ax < math.inf
    amax = _site_reduce(torch.where(finite, ax, 0.0).view(-1, _CHUNK)
                        .amax(1), lay, s, "amax", 0.0)
    low = torch.where(finite & (absb != 0), ax, math.inf)
    amin = _site_reduce(low.view(-1, _CHUNK).amin(1), lay, s, "amin",
                        math.inf)
    del low, finite
    zeros = _site_sum((absb == 0).view(-1, _CHUNK).sum(1), lay)
    key = (absb >> 23).view(-1, _CHUNK)
    del absb
    row = _LANES * HIST_BINS
    key += (lay.chunk_site * row).to(torch.int32)[:, None]
    key += torch.arange(_CHUNK, dtype=torch.int32, device=x.device
                        ).remainder_(_LANES).mul_(HIST_BINS)
    counts = torch.zeros(s * row, dtype=torch.int32, device=x.device)
    counts.index_add_(0, key.view(-1), torch.ones(
        (), dtype=torch.int32, device=x.device).expand(key.numel()))
    del key
    # bucket 0 holds the zeros (the padding's too) beside the subnormals;
    # bucket 255 is inf and NaN
    finite_nz = counts.view(s, _LANES, HIST_BINS).sum(1)
    nonfinite = finite_nz[:, HIST_BINS - 1].clone()
    finite_nz[:, 0] -= zeros
    finite_nz[:, HIST_BINS - 1] = 0
    nz = finite_nz.sum(1)
    hist = finite_nz.to(torch.float32) / torch.clamp(
        nz.to(torch.float32), min=1.0)[:, None]
    amin = torch.where(nz > 0, amin, 0.0)
    zero_frac = (zeros - lay.pads).to(torch.float32) * lay.inv_n
    nonfinite_frac = nonfinite.to(torch.float32) * lay.inv_n
    return amax, amin, hist, zero_frac, nonfinite_frac


def _leaf_stats(x: torch.Tensor):
    """One leaf's (amax, amin_nonzero, normalised exponent histogram,
    zero_frac, nonfinite_frac): the JAX package's ``_leaf_stats``."""
    fl = _flatten({"x": x})
    return tuple(v[0] for v in _flat_stats(fl, _layout(fl.lengths,
                                                        x.device)))


def _norms(tree, lay: Optional[_Layout] = None) -> torch.Tensor:
    """f32[S]: the L2 norm of each site's leaf: per-chunk f32 norms,
    squared and summed per site in f64. ``lay`` is the tree's layout,
    where the caller has built it."""
    fl = _flatten(tree)
    if lay is None:
        lay = _layout(fl.lengths, fl.flat.device)
    sq = torch.linalg.vector_norm(fl.flat.view(-1, _CHUNK), dim=1).square()
    return _site_sum(sq, lay).sqrt().float()


def _mix(prev, cur, d: float, om: float):
    """``d * prev + (1 - d) * cur`` in f32 with the first product fused
    into the add (one rounding), as XLA contracts the JAX package's EMA:
    the f64 product of two f32 values is exact."""
    return (prev.double() * d + (cur * om).double()).float()


def _ema_fns(cfg, first):
    """(ema, ema_companion) of the JAX package's fold: the first check
    seeds a window; a companion slot of -1 never mixes."""
    d = float(np.float32(cfg.ema))
    om = float(np.float32(1.0) - np.float32(cfg.ema))

    def ema(prev, cur):
        return torch.where(first, cur, _mix(prev, cur, d, om))

    def ema_companion(prev, cur):
        return torch.where(cur < 0, prev, torch.where(
            prev >= 0, _mix(prev, cur, d, om), cur))
    return ema, ema_companion


def _resolve(trees, companions):
    tr = trees() if callable(trees) else trees
    for name, companion in companions:
        for k in companion:
            if k not in tr:
                raise ValueError(f"{name} prefix {k!r} has no matching tree "
                                 f"in trees={sorted(tr)}")
    return tr


def _companion(value):
    """A companion tree, or the zero-arg callable that builds it (called on
    a fold step only)."""
    return value() if callable(value) else value


def _check_companion(name, prefix, companion, n):
    got = _n_sites(companion)
    if got != n:
        raise ValueError(f"{name}[{prefix!r}] has {got} leaves, "
                         f"trees[{prefix!r}] has {n}")


def numerics_observe(ns: NumericsState, cfg: NumericsConfig, trees, *,
                     weights: Optional[Dict[str, Any]] = None
                     ) -> NumericsState:
    """Observe one step: fold per-site statistics every
    ``cfg.check_every`` steps, advance the counter. ``trees`` carries the
    SAME (prefix -> tree) structure the state's sites were built from
    (:func:`site_names`), or is a zero-arg callable returning it, called
    only on a fold step (``Amp.step`` builds its cast copy and update
    delta that way). A prefix may hold a :class:`Flat` in place of its
    tree. ``weights`` maps a prefix whose tensors are optimizer *updates*
    to the matching weight tree (or a zero-arg callable returning it);
    those sites also fold the update-to-weight norm ratio.

    A host mirror of the step decides the cadence (module docstring): an
    off-step launches only the counter's add. Observation is read-only:
    the caller's tensors are never written."""
    weights = weights or {}
    every = int(cfg.check_every)
    host = None
    if every > 1:
        host = _host_step(ns.step)
        if host % every:
            return _advance(ns, host)
    s_total = int(ns.amax.shape[0])
    tr = _resolve(trees, (("weights", weights),))
    amaxs, amins, hists, zeros, nonfin, uws = [], [], [], [], [], []
    n_seen = 0
    for prefix in sorted(tr):
        fl = _flatten(tr[prefix])
        n = len(fl.lengths)
        n_seen += n
        lay = _layout(fl.lengths, fl.flat.device)
        amax, amin, hist, zf, nf = _flat_stats(fl, lay)
        amaxs.append(amax)
        amins.append(amin)
        hists.append(hist)
        zeros.append(zf)
        nonfin.append(nf)
        if prefix in weights:
            w = _companion(weights[prefix])
            _check_companion("weights", prefix, w, n)
            wl = _flatten(w)
            uws.append(_norms(fl, lay) / torch.clamp(
                _norms(wl, lay if wl.lengths == fl.lengths else None),
                min=1e-30))
        else:
            uws.append(torch.full((n,), -1.0, dtype=torch.float32,
                                  device=amax.device))
    if n_seen != s_total:
        raise ValueError(f"numerics_observe saw {n_seen} sites, state has "
                         f"{s_total} — trees must match numerics_init's "
                         f"sites")
    cat = (lambda xs: xs[0]) if len(amaxs) == 1 else torch.cat
    amax, amin, zf, nf, uw = map(cat, (amaxs, amins, zeros, nonfin, uws))
    hist = cat(hists)
    ema, ema_companion = _ema_fns(cfg, ns.check_count == 0)
    new = ns._replace(
        amax=amax, amax_ema=ema(ns.amax_ema, amax),
        amin=amin, amin_ema=ema(ns.amin_ema, amin),
        exp_hist=ema(ns.exp_hist, hist),
        zero_frac=zf, nonfinite_frac=nf,
        uw_ratio=ema_companion(ns.uw_ratio, uw),
        check_count=ns.check_count + 1,
        last_check_step=ns.step)
    if host is None:
        new = new._replace(step=ns.step + 1)
        host_prev = _HOST_STEP.get(ns.step)
        if host_prev is not None:
            register_step(new.step, host_prev + 1)
        return new
    return _advance(new, host)


def scale_amax(ns: NumericsState, rows=None) -> torch.Tensor:
    """The amax feed for ``amp.scale_history_update``: per-site last-check
    amax with inf wherever the fold saw nonfinite elements (the state's
    amax is the finite max by design, so it alone never carries the
    overflow signal the scale backoff keys on). ``rows`` gathers a static
    subset of site rows."""
    amax = torch.where(ns.nonfinite_frac > 0, math.inf, ns.amax)
    if rows is None:
        return amax
    return amax[_upload(np.asarray(list(rows), np.int64), amax.device)]


def finite_ok(ns: NumericsState) -> torch.Tensor:
    """Device bool: the last fold saw no nonfinite element at any site."""
    return torch.all(ns.nonfinite_frac == 0)


def nonfinite_sites(ns: NumericsState,
                    sites: Sequence[str]) -> List[Tuple[str, float]]:
    """Host-side: the sites whose last fold saw nonfinite elements, with
    their fractions (the guard vetoes the commit, this names the
    tensor)."""
    nf = ns.nonfinite_frac.detach().cpu().numpy()
    return [(sites[i], float(nf[i])) for i in range(len(sites))
            if nf[i] > 0]


# -- the host half: format pricing + verdicts -------------------------------------

def _coverage(hist, fmt: FormatSpec, scale_exp: int) -> Tuple[float, float]:
    """(underflow, saturation) fraction of the measured distribution if
    cast to ``fmt`` after multiplying by 2**scale_exp: an index shift on
    the exponent histogram. Elements in the top binade count as
    representable (the half-bucket approximation)."""
    h = np.asarray(hist, dtype=np.float64)
    lo = fmt.min_exp - scale_exp + _BIAS          # first safe bucket
    hi = fmt.max_exp - scale_exp + _BIAS          # last safe bucket
    under = float(h[:max(min(lo, HIST_BINS), 0)].sum())
    sat = float(h[max(min(hi + 1, HIST_BINS), 0):].sum())
    return under, sat


def _recommended_scale_exp(amax: float, fmt: FormatSpec,
                           margin: float) -> int:
    """The power-of-two scale exponent centring the measured amax under
    ``fmt.max_finite / margin`` (the delayed-scaling formula)."""
    if amax <= 0 or not math.isfinite(amax):
        return 0
    return int(math.floor(math.log2(fmt.max_finite / (margin * amax))))


@dataclasses.dataclass
class SiteVerdict:
    """One site's measured-range verdict against the format ladder."""

    site: str
    kind: str                     # prefix before the first "/"
    amax: float                   # max(last, ema) measured |x|
    amin: float                   # min nonzero |x| (ema-joined)
    range_bits: Optional[float]   # log2(amax/amin), None w/o data
    zero_frac: float
    nonfinite_frac: float
    uw_ratio: Optional[float]     # None for sites without a companion
    required_dtype: str           # narrowest safe FORMAT_LADDER entry
    recommended_scale: float      # 2**k for the required format
    predicted_underflow_frac: float
    predicted_saturation_frac: float
    current_dtype: Optional[str]  # FORMAT_TABLE key, when known
    by_format: Dict[str, Dict[str, float]]
    #: True when the measured range fits the site's current format
    #: unscaled (no surprise); None when the current dtype is unknown
    ok: Optional[bool] = None

    @property
    def fingerprint(self) -> str:
        """Stable ``numerics|kind|site`` key (never a measured number)."""
        return f"numerics|{self.kind}|{self.site}"

    def to_event(self, rank: int = 0, step: Optional[int] = None) -> Dict:
        """``kind="precision_verdict"`` event."""
        return {"kind": "precision_verdict", "rank": rank, "step": step,
                "site": self.site, "site_kind": self.kind,
                "required_dtype": self.required_dtype,
                "current_dtype": self.current_dtype,
                "predicted_underflow_frac":
                    round(self.predicted_underflow_frac, 6),
                "predicted_saturation_frac":
                    round(self.predicted_saturation_frac, 6),
                "recommended_scale": self.recommended_scale,
                "amax": (None if not math.isfinite(self.amax)
                         else self.amax),
                "ok": self.ok,
                "fingerprint": self.fingerprint}


@dataclasses.dataclass
class NumericsReport:
    """The per-site verdict list of one observed run."""

    rows: List[SiteVerdict]
    underflow_threshold: float
    saturation_threshold: float
    margin: float

    def __iter__(self):
        return iter(self.rows)

    def surprises(self) -> List[SiteVerdict]:
        """Sites whose measured range does NOT fit their current format."""
        return [r for r in self.rows if r.ok is False]

    def worst_gaps(self, k: int = 5) -> List[Dict[str, Any]]:
        """The top-k numerically at-risk sites, ranked by error mass at the
        current format unscaled; JSON-able dicts."""
        gaps = []
        for r in self.rows:
            if r.ok is not False:
                continue
            u, s = _err_at(r, FORMAT_TABLE[r.current_dtype])
            gaps.append((u + s, r, u, s))
        gaps.sort(key=lambda t: -t[0])
        return [{"fingerprint": r.fingerprint, "site": r.site,
                 "kind": r.kind, "current_dtype": r.current_dtype,
                 "required_dtype": r.required_dtype,
                 "underflow_frac": round(u, 6),
                 "saturation_frac": round(s, 6),
                 "recommended_scale": r.recommended_scale}
                for _, r, u, s in gaps[:k]]

    def fp8_candidates(self, k: Optional[int] = None) -> List[Dict[str, Any]]:
        """Sites whose measured range fits an fp8 format with the
        recommended scale, safest first."""
        cands = []
        for r in self.rows:
            if r.required_dtype not in ("fp8_e4m3", "fp8_e5m2"):
                continue
            f8 = r.by_format["fp8_e4m3"]
            cands.append((f8["underflow"] + f8["saturation"], r))
        cands.sort(key=lambda t: (t[0], t[1].site))
        out = [{"fingerprint": r.fingerprint, "site": r.site,
                "kind": r.kind, "required_dtype": r.required_dtype,
                "recommended_scale": r.recommended_scale,
                "predicted_underflow_frac":
                    round(r.predicted_underflow_frac, 6),
                "predicted_saturation_frac":
                    round(r.predicted_saturation_frac, 6)}
               for _, r in cands]
        return out if k is None else out[:k]

    def table(self, top: int = 12) -> str:
        lines = [f"numerics — {len(self.rows)} sites, "
                 f"{len(self.surprises())} surprises "
                 f"(u<{self.underflow_threshold:g} "
                 f"s<{self.saturation_threshold:g})",
                 f"{'site':<38} {'cur':<9} {'req':<9} {'amax':>9} "
                 f"{'scale':>9} {'u%':>7} {'s%':>7}"]
        rows = sorted(self.rows, key=lambda r: (r.ok is not False, r.site))
        for r in rows[:top]:
            lines.append(
                f"{r.site[:38]:<38} {r.current_dtype or '?':<9} "
                f"{r.required_dtype:<9} {r.amax:>9.3g} "
                f"{r.recommended_scale:>9.3g} "
                f"{100 * r.predicted_underflow_frac:>6.2f}% "
                f"{100 * r.predicted_saturation_frac:>6.2f}%")
        return "\n".join(lines)

    def to_events(self, rank: int = 0,
                  step: Optional[int] = None) -> List[Dict]:
        return [r.to_event(rank=rank, step=step) for r in self.rows]


def _err_at(r: SiteVerdict, fmt: FormatSpec) -> Tuple[float, float]:
    """(underflow, saturation) of a verdict at ``fmt`` unscaled, from its
    per-format table."""
    ent = r.by_format.get(fmt.name)
    if ent is None:
        return 0.0, 0.0
    return ent.get("unscaled_underflow", ent["underflow"]), \
        ent.get("unscaled_saturation", ent["saturation"])


def precision_report(ns_or_stats, sites: Optional[Sequence[str]] = None,
                     *, current_dtypes=None,
                     underflow_threshold: float = 1e-3,
                     saturation_threshold: float = 1e-3,
                     margin: float = 2.0) -> NumericsReport:
    """Join measured exponent coverage against :data:`FORMAT_TABLE` into
    the per-site verdict list.

    ``ns_or_stats`` is a :class:`NumericsState` (with ``sites``; one host
    fetch) or a stats dict from :func:`stats_from_json`.
    ``current_dtypes`` maps site -> dtype / format name (or one value for
    all sites); verdicts then carry the ``ok`` no-surprise bit. A format
    is safe for a site when, at its own recommended power-of-two scale,
    predicted underflow <= ``underflow_threshold`` and saturation <=
    ``saturation_threshold``; ``required_dtype`` is the narrowest safe
    ladder entry (fp32 as the fallback)."""
    if isinstance(ns_or_stats, NumericsState):
        if sites is None:
            raise ValueError("precision_report(NumericsState) needs "
                             "the matching sites tuple")
        stats = _fetch_stats(ns_or_stats, sites)
    else:
        stats = dict(ns_or_stats)
        sites = tuple(stats["sites"])

    def _cur(i: int) -> Optional[str]:
        if current_dtypes is None:
            return None
        if isinstance(current_dtypes, dict):
            v = current_dtypes.get(sites[i])
        else:
            v = current_dtypes
        return None if v is None else format_of_dtype(v)

    rows: List[SiteVerdict] = []
    for i, site in enumerate(sites):
        amax = max(float(stats["amax"][i]), float(stats["amax_ema"][i]))
        amin_candidates = [v for v in (float(stats["amin"][i]),
                                       float(stats["amin_ema"][i]))
                           if v > 0]
        amin = min(amin_candidates) if amin_candidates else 0.0
        hist = np.asarray(stats["exp_hist"][i], dtype=np.float64)
        by_format: Dict[str, Dict[str, float]] = {}
        required = "fp32"
        for name in FORMAT_LADDER:
            fmt = FORMAT_TABLE[name]
            k = _recommended_scale_exp(amax, fmt, margin)
            u, s = _coverage(hist, fmt, k)
            u0, s0 = _coverage(hist, fmt, 0)
            by_format[name] = {"underflow": u, "saturation": s,
                               "scale": float(2.0 ** k),
                               "unscaled_underflow": u0,
                               "unscaled_saturation": s0}
            if (required == "fp32" and name != "fp32"
                    and u <= underflow_threshold
                    and s <= saturation_threshold):
                required = name
        req = by_format[required]
        uw = float(stats["uw_ratio"][i])
        cur = _cur(i)
        if cur is None:
            ok = None
        else:
            c = by_format[cur]
            ok = (c["unscaled_underflow"] <= underflow_threshold
                  and c["unscaled_saturation"] <= saturation_threshold)
        rows.append(SiteVerdict(
            site=site, kind=site.split("/", 1)[0], amax=amax, amin=amin,
            range_bits=(math.log2(amax / amin)
                        if amax > 0 and amin > 0 else None),
            zero_frac=float(stats["zero_frac"][i]),
            nonfinite_frac=float(stats["nonfinite_frac"][i]),
            uw_ratio=None if uw < 0 else uw,
            required_dtype=required, recommended_scale=req["scale"],
            predicted_underflow_frac=req["underflow"],
            predicted_saturation_frac=req["saturation"],
            current_dtype=cur, by_format=by_format, ok=ok))
    return NumericsReport(rows=rows, underflow_threshold=underflow_threshold,
                          saturation_threshold=saturation_threshold,
                          margin=margin)


def _fetch_stats(ns: NumericsState, sites: Sequence[str]) -> Dict:
    host = {f: getattr(ns, f).detach().cpu().numpy() for f in ns._fields}
    if len(sites) != host["amax"].shape[0]:
        raise ValueError(f"{len(sites)} sites for a state with "
                         f"{host['amax'].shape[0]} rows")
    out = {"sites": tuple(sites), "step": int(host["step"]),
           "check_count": int(host["check_count"])}
    for f in ("amax", "amax_ema", "amin", "amin_ema", "exp_hist",
              "zero_frac", "nonfinite_frac", "uw_ratio"):
        out[f] = host[f]
    return out


def stats_to_json(ns: NumericsState, sites: Sequence[str]) -> str:
    """Serialise one fetched measurement (the committed-fixture format;
    zero histogram buckets dropped), as the JAX package writes it."""
    st = _fetch_stats(ns, sites)
    hist = [{str(b): round(float(v), 9) for b, v in enumerate(row) if v > 0}
            for row in st["exp_hist"]]
    return json.dumps({
        "version": 1, "sites": list(st["sites"]),
        "step": st["step"], "check_count": st["check_count"],
        "amax": [float(v) for v in st["amax"]],
        "amax_ema": [float(v) for v in st["amax_ema"]],
        "amin": [float(v) for v in st["amin"]],
        "amin_ema": [float(v) for v in st["amin_ema"]],
        "exp_hist": hist,
        "zero_frac": [float(v) for v in st["zero_frac"]],
        "nonfinite_frac": [float(v) for v in st["nonfinite_frac"]],
        "uw_ratio": [float(v) for v in st["uw_ratio"]],
    }, indent=1)


def stats_from_json(text: str) -> Dict:
    """Inverse of :func:`stats_to_json`; feed it to
    :func:`precision_report`."""
    data = json.loads(text)
    s = len(data["sites"])
    hist = np.zeros((s, HIST_BINS), dtype=np.float64)
    for i, row in enumerate(data["exp_hist"]):
        for b, v in row.items():
            hist[i, int(b)] = v
    out = dict(data)
    out["exp_hist"] = hist
    return out


# -- events (the numerics channel) ------------------------------------------------

def check_events(ns: NumericsState, sites: Sequence[str], *, rank: int = 0,
                 current_dtype=None) -> List[Dict]:
    """One ``kind="numerics_check"`` aggregate row (``site`` null) plus one
    per-site row (one fetch of the state). ``current_dtype`` prices the
    per-site underflow/overflow fractions against one format's range
    (bf16 by default; an unknown dtype raises)."""
    st = _fetch_stats(ns, sites)
    if current_dtype is None:
        fmt = FORMAT_TABLE["bf16"]
    else:
        key = format_of_dtype(current_dtype)
        if key is None:
            raise ValueError(
                f"check_events: {current_dtype!r} is not a known "
                f"format/dtype — one of {FORMAT_LADDER} or a float "
                f"dtype name")
        fmt = FORMAT_TABLE[key]
    events: List[Dict] = [{
        "kind": "numerics_check", "rank": rank, "step": st["step"],
        "check_count": st["check_count"], "site": None,
        "n_sites": len(sites),
        "amax": float(np.max(st["amax"])),
        "amin": None,
        "nonfinite_frac": float(np.max(st["nonfinite_frac"])),
        "zero_frac": float(np.mean(st["zero_frac"])),
        "underflow_frac": None, "overflow_frac": None,
        "uw_ratio": None,
    }]
    for i, site in enumerate(sites):
        u, s = _coverage(st["exp_hist"][i], fmt, 0)
        uw = float(st["uw_ratio"][i])
        events.append({
            "kind": "numerics_check", "rank": rank, "step": st["step"],
            "check_count": st["check_count"], "site": site,
            "n_sites": len(sites),
            "amax": float(st["amax"][i]),
            "amin": float(st["amin"][i]),
            "underflow_frac": round(u, 6),
            "overflow_frac": round(s, 6),
            "zero_frac": round(float(st["zero_frac"][i]), 6),
            "nonfinite_frac": round(float(st["nonfinite_frac"][i]), 6),
            "uw_ratio": None if uw < 0 else uw,
        })
    return events


# -- the advisor: perf headroom x numeric safety ----------------------------------

def placement_advisor(roofline_report, report: NumericsReport, *,
                      k: int = 5) -> List[Dict[str, Any]]:
    """Rank precision-placement candidates by measured perf headroom x
    numeric safety: the verdicts' narrower-format candidates joined with
    ``roofline_report.what_if(plan)`` (any object with that method; the
    port's roofline report is ROADMAP.md queue A, item 11 part 3). Sites
    join what-if rows by their ``site`` key."""
    plan = {}
    for r in report.rows:
        if r.required_dtype == "fp32":
            continue
        if r.current_dtype is not None and r.ok is False:
            continue          # numerically unsafe today: not a candidate
        plan[r.site] = r.required_dtype
    if not plan:
        return []
    whatif = roofline_report.what_if(plan)
    by_site: Dict[str, SiteVerdict] = {r.site: r for r in report.rows}
    out = []
    for row in whatif:
        v = by_site.get(row["site"])
        if v is None:
            continue
        err = v.predicted_underflow_frac + v.predicted_saturation_frac
        safety = 1.0 - min(1.0, err / max(
            report.underflow_threshold + report.saturation_threshold,
            1e-12))
        gain = row.get("whatif_gain_us") or 0.0
        out.append({**row, "required_dtype": v.required_dtype,
                    "recommended_scale": v.recommended_scale,
                    "numeric_safety": round(safety, 4),
                    "rank_score": round(gain * safety, 3),
                    "verdict_fingerprint": v.fingerprint})
    out.sort(key=lambda e: -e["rank_score"])
    return out[:k]
