"""Fused BatchNorm → (+residual) → ReLU over channels-last activations.

Port of ``apex_tpu/ops/bn_act.py``: one autograd unit per BN(+add)(+ReLU)
whose backward saves only the conv output ``x``, the per-channel
``(mean, invstd)`` and, for the residual join with ReLU, the unit output
``z`` (the next conv's input, alive anyway); x̂ and the ReLU mask are
recomputed in-register. Kernels replaced (the JAX package's
``_bwd_pallas`` pair; its default ``_bwd_jnp`` computes the same function,
which is what the plain versions below compute):

- ``bn_sums_kernel`` (``csrc/bn_sums.cu``) ← ``_sums_kernel``: per channel
  Σg and Σg·x̂ over the M rows, x̂ = (x−μ)·invstd; the mask is ``x̂γ+β > 0``
  ("relu") or ``z > 0`` ("addrelu", which also writes dr = mask⊙dz).
- ``bn_dx_kernel`` (Triton) ← ``_dx_kernel``: dx = γ·invstd·(g − k1 − x̂·k2)
  with k1 = Σg/n and k2 = Σg·x̂/n ("relu" recomputes the mask; "addrelu"
  passes the pre-masked dr as g).

With ``fp8`` residuals (``make_cfg(fp8=True)``, ``FusedBNAct(
fp8_residuals=True)`` or ``APEX_TPU_FP8_RESIDUALS=1`` when the module is
called, the JAX package's ``_xres_of``) the forward saves x̂ itself as
``float8_e4m3fn`` in place of x, and both kernels take it with ``xhat=True``:
x̂ is read as it is (no centring), the ReLU mask is x̂₈·γ + β > 0, and dx,
still γ·invstd·(g − k1 − x̂₈·k2), is written in x's own dtype.

What bounds them on an H100: bytes. Each is one streaming pass over (M, C)
rows with a few flops per element: the sums read x and g (and z, writing
dr), dx reads x and g and writes dx. All math is in f32 with the JAX
formulas term for term and no FMA contraction, so the recomputed mask
agrees with the plain version bit for bit. The TPU sums kernel adds every
row block into one output block over its in-order grid; Hopper blocks run
in no order, so the sums kernel's blocks each write a partial over rows
fixed by :func:`_bn_sums_plan` (a pure function of the shape and the SM
count), and the last block to finish adds the partials in block order in
the same launch: deterministic, no float atomics. The dx kernel tiles
(BLOCK_M, BLOCK_C) coalesced along C, masked on both axes so any (M, C)
works, and forms k1 and k2 from the sums buffer and the count, so nothing
is read back to the host.

The forward (moments, normalise, add, ReLU) is plain PyTorch, as the JAX
package has jnp there: one-pass f32 moments E[x²]−E[x]² (clamped at 0),
reduced straight from the half input without an f32 copy of it.

Across ranks (``axis_name``, optionally ``axis_index_groups``, resolved
against the bound mesh when the unit runs: ``parallel.use_mesh``), the
local moments are combined by the parallel Welford combine over the group
(one gather of each rank's packed (mean, var, count)), the sums kernel's
(2, C) output is all-reduced over the group before the dx kernel reads it,
and the γ and β gradients are those all-reduced sums, as in the JAX
package (so each rank holds the whole group's dγ and dβ). The group's
count is then a 1-element f32 device tensor that the dx kernel reads (its
``COUNT_PTR`` variant) and the running statistics use, so no count is
read back to the host.

Activations are contiguous NHWC tensors: a unit views them as (M, C) with
``.view`` and never copies one silently. A gradient that autograd hands
over in another layout (a broadcast from the global mean, a slice from a
padding) is copied explicitly and counted in ``layout_copies``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from apex_tpu_torch.ops import _build
from apex_tpu_torch.parallel import collectives
from apex_tpu_torch.parallel.mesh import normalize_groups, resolve_group
from apex_tpu_torch.parallel.sync_batchnorm import SCOPE as SYNC_SCOPE
from apex_tpu_torch.parallel.sync_batchnorm import combine_moments
from apex_tpu_torch.ops._priced import priced

tl = None  # triton.language, bound by _build.triton_jit at the first launch

_MODES = {"plain": 0, "relu": 1, "addrelu": 2}
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)
#: the dtype of a saved x̂ (``fp8`` residuals)
XHAT_DTYPE = torch.float8_e4m3fn
#: set to "1", every FusedBNAct unit called in training saves fp8 residuals
FP8_ENV = "APEX_TPU_FP8_RESIDUALS"
_TILE = 4096        # elements of one (BLOCK_M, BLOCK_C) tile

#: gradients copied into the (M, C) row layout by ``_grad_rows``
layout_copies = 0


# --- Triton dx kernel --------------------------------------------------------

def _bn_dx_triton(X, G, SCALE, BIAS, MEAN, INVSTD, SUMS, DX, M, C, count,
                  COUNT_PTR: "tl.constexpr", RELU: "tl.constexpr",
                  XHAT: "tl.constexpr", BLOCK_M: "tl.constexpr",
                  BLOCK_C: "tl.constexpr"):
    rows = tl.program_id(0).to(tl.int64) * BLOCK_M + tl.arange(0, BLOCK_M)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    mean = tl.load(MEAN + cols, mask=cmask, other=0.0)
    invstd = tl.load(INVSTD + cols, mask=cmask, other=0.0)
    scale = tl.load(SCALE + cols, mask=cmask, other=0.0).to(tl.float32)
    if COUNT_PTR:           # the group's count, an f32 on the device
        count = tl.load(count)
    k1 = tl.div_rn(tl.load(SUMS + cols, mask=cmask, other=0.0), count)
    k2 = tl.div_rn(tl.load(SUMS + C + cols, mask=cmask, other=0.0), count)
    m = (rows < M)[:, None] & cmask[None, :]
    offs = rows[:, None] * C + cols[None, :]
    if XHAT:
        xhat = tl.load(X + offs, mask=m).to(tl.float32)
    else:
        x = tl.load(X + offs, mask=m, other=0.0).to(tl.float32)
        xhat = (x - mean[None, :]) * invstd[None, :]
    g = tl.load(G + offs, mask=m, other=0.0).to(tl.float32)
    if RELU:
        bias = tl.load(BIAS + cols, mask=cmask, other=0.0).to(tl.float32)
        g = tl.where(xhat * scale[None, :] + bias[None, :] > 0, g, 0.0)
    dx = (scale * invstd)[None, :] * (g - k1[None, :] - xhat * k2[None, :])
    tl.store(DX + offs, dx.to(DX.dtype.element_ty), mask=m)


def _tiles(c: int):
    block_c = min(128, 1 << max(4, (c - 1).bit_length()))
    return _TILE // block_c, block_c


def _check_f32(*tensors):
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("BN statistics and sums must be f32")


def _check_unit(x2, g2, scale, bias, mean, invstd, xhat=False):
    """(M, C) rows of a float x (or, with ``xhat``, an e4m3 x̂) and g, and
    per-channel vectors."""
    _build.check_operands(x2, dtypes=(XHAT_DTYPE,) if xhat else _FLOATS)
    _build.check_operands(x2, g2, scale, bias, mean, invstd)
    _build.check_operands(g2, scale, bias, mean, invstd, dtypes=_FLOATS)
    _check_f32(mean, invstd)
    if x2.dim() != 2 or g2.shape != x2.shape:
        raise ValueError(f"expected (M, C) rows of one shape, got "
                         f"{tuple(x2.shape)} and {tuple(g2.shape)}")
    c = x2.shape[1]
    for v in (scale, bias, mean, invstd):
        if v.shape != (c,):
            raise ValueError(f"per-channel vector {tuple(v.shape)} != ({c},)")


# --- the CUDA sums kernel ----------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
           XHAT_DTYPE: 3}
# csrc/bn_sums.cu: threads a block, rows a thread loads at once, and the
# blocks an SM its launch bounds ask for
_THREADS, _UNROLL, _BLOCKS_PER_SM = 512, 4, 1

#: (partials, counters) of the sums kernel, by raw stream handle
_sums_buffers = {}


@functools.lru_cache(maxsize=None)
def _bn_sums_plan(m: int, c: int, sms: int, vec: int = 8) -> tuple:
    """``(tpr, tiles, rows, row_blocks)`` of ``apex_bn_sums`` over (m, c)
    rows, ``vec`` channels a thread: ``tpr`` threads (a power of two up to
    32) cover a tile of ``tpr·vec`` channels, ``tiles`` tiles cover c, and
    ``row_blocks`` blocks a tile take ``rows`` rows each (a multiple of
    what the block loads at once; the last takes the rest), about
    ``_BLOCKS_PER_SM`` blocks an SM in all. A pure function of its
    arguments, so the order of every sum is fixed."""
    chunks = -(-c // vec)
    tpr = min(32, 1 << (chunks - 1).bit_length())
    tiles = -(-chunks // tpr)
    step = _THREADS // tpr * _UNROLL
    blocks = max(1, min(-(-m // step), _BLOCKS_PER_SM * sms // tiles))
    rows = -(-(-(-m // blocks)) // step) * step
    return tpr, tiles, rows, -(-m // rows)


def _sums_workspace(device, stream, n_part, tiles):
    """The sums kernel's f32 partials (>= ``n_part``) and int32 tile
    counters (>= ``tiles``, all 0) for one stream (``_build.workspace``)."""
    return _build.workspace(_sums_buffers, device, stream, n_part, tiles)


#: ``SumsCall`` of ``csrc/bn_sums.cu``, field by field, every field 64 bits.
#: One packed struct crosses ctypes in one argument.
SUMS_CALL_FIELDS = ("x", "g", "z", "scale", "bias", "mean", "invstd", "part",
                    "counters", "out", "dr", "m", "c", "rows", "row_blocks",
                    "tpr_log2", "tiles", "dtypes", "mode", "vector", "xhat")
_SUMS_CALL = struct.Struct("<21q")


@functools.lru_cache(maxsize=None)
def _sums_lib():
    """The C entry point ``apex_bn_sums(const SumsCall*, stream)``."""
    fn = _build.load("bn_sums").apex_bn_sums
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@priced("bn_sums")
def bn_sums_kernel(x2, g2, z2, scale, bias, mean, invstd, mode, r_dtype=None,
                   xhat=False):
    """CUDA channel sums over contiguous (M, C) CUDA rows. Returns (sums
    (2, C) f32: Σg and Σg·x̂, dr in ``r_dtype`` for "addrelu" else
    None). With ``xhat``, ``x2`` is x̂ itself in e4m3 (mean and invstd
    are not read)."""
    _check_unit(x2, g2, scale, bias, mean, invstd, xhat)
    addrelu = mode == "addrelu"
    if addrelu:
        _build.check_operands(x2, z2)
        _build.check_operands(z2, dtypes=_FLOATS)
        if z2.shape != x2.shape:
            raise ValueError("z must have x's (M, C) shape")
    m, c = x2.shape
    dev = x2.device
    sums = torch.empty((2, c), dtype=torch.float32, device=dev)
    dr = torch.empty((m, c), dtype=r_dtype or g2.dtype,
                     device=dev) if addrelu else None
    if m == 0:
        return sums.zero_(), dr
    # 16-byte loads of g (and z, dr); x of g's dtype too, or e4m3 x̂ loaded
    # 16 / g's itemsize bytes at a time
    vec = 16 // g2.element_size()
    vector = (c % vec == 0 and all(
        t.dtype == g2.dtype and t.data_ptr() % 16 == 0
        for t in ((g2, z2, dr) if addrelu else (g2,)))
        and (x2.data_ptr() % vec == 0 if xhat
             else x2.dtype == g2.dtype and x2.data_ptr() % 16 == 0))
    tpr, tiles, rows, blocks = _bn_sums_plan(m, c, _build.sm_count(dev),
                                             vec if vector else 1)
    stream = _build.stream_ptr(x2)
    part, counters = _sums_workspace(dev, stream, blocks * 2 * c, tiles)
    dtypes = (_DTYPES[x2.dtype] | _DTYPES[g2.dtype] << 2
              | (_DTYPES[z2.dtype] << 4 | _DTYPES[dr.dtype] << 6 if addrelu
                 else 0)
              | _DTYPES[scale.dtype] << 8 | _DTYPES[bias.dtype] << 10)
    call = _SUMS_CALL.pack(
        x2.data_ptr(), g2.data_ptr(), z2.data_ptr() if addrelu else 0,
        scale.data_ptr(), bias.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
        part.data_ptr(), counters.data_ptr(), sums.data_ptr(),
        dr.data_ptr() if addrelu else 0, m, c, rows, blocks,
        tpr.bit_length() - 1, tiles, dtypes, _MODES[mode], vector, xhat)
    _build.check(_sums_lib()(call, stream), "bn_sums")
    bn_sums_kernel.launches += 1
    return sums, dr


bn_sums_kernel.launches = 0


@priced("bn_dx")
def bn_dx_kernel(x2, g2, scale, bias, mean, invstd, sums, count, relu,
                 dx_dtype, xhat=False):
    """Triton dx over contiguous (M, C) CUDA rows; ``sums`` is the (2, C)
    f32 output of the sums pass and ``count`` the number of rows the
    statistics cover: a number, or a 1-element f32 tensor on the card (the
    group's count across ranks, read by the kernel). With ``xhat``, ``x2``
    is x̂ itself in e4m3."""
    _check_unit(x2, g2, scale, bias, mean, invstd, xhat)
    _build.check_operands(x2, sums)
    _check_f32(sums)
    count_ptr = isinstance(count, torch.Tensor)
    if count_ptr:
        _build.check_operands(x2, count)
        _check_f32(count)
        if count.numel() != 1:
            raise ValueError(f"count tensor of {count.numel()} elements")
    m, c = x2.shape
    if sums.shape != (2, c):
        raise ValueError(f"sums {tuple(sums.shape)} != (2, {c})")
    block_m, block_c = _tiles(c)
    dx = torch.empty(x2.shape, dtype=dx_dtype, device=x2.device)
    _build.triton_jit(_bn_dx_triton)[(-(-m // block_m), -(-c // block_c))](
        x2, g2, scale, bias, mean, invstd, sums, dx, m, c,
        count if count_ptr else float(count), COUNT_PTR=count_ptr,
        RELU=bool(relu), XHAT=bool(xhat), BLOCK_M=block_m, BLOCK_C=block_c,
        num_warps=8,
        enable_fp_fusion=False)
    bn_dx_kernel.launches += 1
    return dx


bn_dx_kernel.launches = 0


# --- plain versions (the kernels' arithmetic, in PyTorch) --------------------

def _xhat(x2, mean, invstd, xhat=False):
    return x2.float() if xhat else (x2.float() - mean) * invstd


def _relu_mask(xhat, scale, bias):
    return xhat * scale.float() + bias.float() > 0


@priced("bn_sums")
def bn_sums_plain(x2, g2, z2, scale, bias, mean, invstd, mode, r_dtype=None,
                  xhat=False):
    xhat = _xhat(x2, mean, invstd, xhat)
    g = g2.float()
    dr = None
    if mode == "relu":
        g = torch.where(_relu_mask(xhat, scale, bias), g, 0.0)
    elif mode == "addrelu":
        g = torch.where(z2.float() > 0, g, 0.0)
        dr = g.to(r_dtype or g2.dtype)
    return torch.stack([g.sum(dim=0), (g * xhat).sum(dim=0)]), dr


@priced("bn_dx")
def bn_dx_plain(x2, g2, scale, bias, mean, invstd, sums, count, relu,
                dx_dtype, xhat=False):
    xhat = _xhat(x2, mean, invstd, xhat)
    g = g2.float()
    if relu:
        g = torch.where(_relu_mask(xhat, scale, bias), g, 0.0)
    k1, k2 = sums[0] / count, sums[1] / count
    scale32 = scale.float()
    return ((scale32 * invstd) * (g - k1 - xhat * k2)).to(dx_dtype)


# --- forward (plain PyTorch, as the JAX package's jnp) -----------------------

class _Cfg(NamedTuple):
    """Static configuration of one unit. ``fp8``: save x̂ in e4m3 for the
    backward instead of x. ``axis_name`` and ``groups`` (normalised
    ``axis_index_groups``): the statistics' group across ranks."""
    relu: bool
    eps: float
    fp8: bool = False
    axis_name: Optional[str] = None
    groups: Optional[tuple] = None


def make_cfg(*, relu: bool, eps: float = 1e-5, axis_name=None,
             axis_index_groups=None, fp8: bool = False) -> _Cfg:
    return _Cfg(relu=bool(relu), eps=float(eps), fp8=bool(fp8),
                axis_name=axis_name,
                groups=normalize_groups(axis_index_groups))


def _group(cfg: _Cfg):
    """The process group of ``cfg``'s statistics under the bound mesh, or
    None for a unit whose statistics are its own."""
    if cfg.axis_name is None:
        return None
    return resolve_group(cfg.axis_name, cfg.groups)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """The (M, C) view of a contiguous channels-last activation; raises
    rather than copy one."""
    if not t.is_contiguous():
        raise ValueError(
            f"BN unit input of shape {tuple(t.shape)} and strides "
            f"{t.stride()} is not a contiguous channels-last tensor")
    return t.view(-1, t.shape[-1])


def _grad_rows(g: torch.Tensor) -> torch.Tensor:
    """The (M, C) view of an incoming gradient, copied (and counted in
    ``layout_copies``) when autograd hands it over in another layout."""
    global layout_copies
    if not g.is_contiguous():
        layout_copies += 1
        g = g.contiguous()
    return g.view(-1, g.shape[-1])


def _stats(x2):
    """Per-channel (mean, biased var, count): one-pass f32 moments over the
    (M, C) rows, reduced from x's own dtype."""
    n = x2.shape[0]
    mean = torch.sum(x2, dim=0, dtype=torch.float32) / n
    sq = torch.linalg.vector_norm(x2, 2, dim=0, dtype=torch.float32)
    var = torch.clamp_min(sq * sq / n - mean * mean, 0.0)
    return mean, var, float(n)


def _apply(x2, r2, scale, bias, mean, invstd, relu, dtype):
    """``relu?((x − mean)·(invstd·γ) + β (+ r))`` in f32, written in
    ``dtype``. Without autograd (the training unit's forward, inference)
    one f32 intermediate is updated in place: three passes over the rows,
    four with a residual. The eval forward under autograd stays
    differentiable, as flax's is, so there the same ops allocate their
    outputs (``out=`` arguments do not support autograd)."""
    a, b = invstd * scale.float(), bias.float()
    if torch.is_grad_enabled():
        y = torch.addcmul(b, x2 - mean, a)
        y = y if r2 is None else y + r2
        return (torch.relu(y) if relu else y).to(dtype)
    y = x2 - mean
    torch.addcmul(b, y, a, out=y)
    if r2 is not None:
        y.add_(r2)
    z = torch.empty(y.shape, dtype=dtype, device=y.device)
    if relu:
        return torch.maximum(y, y.new_zeros(()), out=z)
    return z.copy_(y)


def _fwd_common(x, r, scale, bias, cfg: _Cfg, group=None):
    """z, mean, var, count and invstd of one unit; with ``group`` the
    statistics (and the count, then a 0-dim f32 tensor) are the group's."""
    x2 = _rows(x)
    mean, var, count = _stats(x2)
    if group is not None:
        mean, var, count = combine_moments(
            mean, var, torch.full((), count, dtype=torch.float32,
                                  device=x.device), group)
    invstd = torch.rsqrt(var + cfg.eps)
    r2 = None if r is None else _rows(r)
    z = _apply(x2, r2, scale, bias, mean, invstd, cfg.relu, x.dtype)
    return z.view(x.shape), mean, var, count, invstd


def _xres_of(x, mean, invstd, cfg: _Cfg):
    """The backward's activation residual: x, or under ``cfg.fp8`` x̂ =
    (x − μ)·invstd in f32 rounded to e4m3 (x̂ has zero mean and unit
    variance per channel, so e4m3's range holds it with no scale)."""
    if not cfg.fp8:
        return x
    # x − μ promotes to f32 in one pass; the product is taken in place
    return (_rows(x) - mean).mul_(invstd).to(XHAT_DTYPE).view(x.shape)


def group_sums(sums, group):
    """The (2, C) channel sums summed over ``group`` in place (the JAX
    unit's ``psum``), or as they are without a group."""
    if group is not None:
        collectives.all_reduce(sums, group, SYNC_SCOPE)
    return sums


def _bwd(cfg: _Cfg, x, scale, bias, mean, invstd, count, z, dz,
         has_residual, r_dtype, dx_dtype, group=None):
    """The two passes: channel sums (+ dr), summed over ``group``, then dx.
    CUDA tensors launch the kernels; CPU tensors take their plain versions.
    ``x`` is the saved residual: x, or x̂ in e4m3 under ``cfg.fp8``."""
    x2, g2 = _rows(x), _grad_rows(dz)
    mode = ("addrelu" if cfg.relu and has_residual
            else "relu" if cfg.relu else "plain")
    sums_fn = bn_sums_kernel if x2.is_cuda else bn_sums_plain
    dx_fn = bn_dx_kernel if x2.is_cuda else bn_dx_plain
    sums, dr2 = sums_fn(x2, g2, None if z is None else _rows(z), scale, bias,
                        mean, invstd, mode, r_dtype, xhat=cfg.fp8)
    group_sums(sums, group)
    g_src = dr2 if mode == "addrelu" else g2
    dx = dx_fn(x2, g_src, scale, bias, mean, invstd, sums, count,
               mode == "relu", dx_dtype, xhat=cfg.fp8).view(x.shape)
    dscale, dbias = sums[1].to(scale.dtype), sums[0].to(bias.dtype)
    if not has_residual:
        return dx, None, dscale, dbias
    # no relu in the unit: the add is the identity, dr is dz itself
    dr = dr2.view(x.shape) if dr2 is not None else dz.to(r_dtype)
    return dx, dr, dscale, dbias


def save_stats(ctx, cfg, group, count, *tensors):
    """Save a unit's residuals: a group's count is a tensor, saved with
    them; a rank's own count is a number on ``ctx``."""
    ctx.save_for_backward(*tensors, count if group is not None else None)
    ctx.cfg, ctx.group = cfg, group
    ctx.count = None if group is not None else count


def saved_stats(ctx):
    """(saved residuals, count) of :func:`save_stats`."""
    *saved, count = ctx.saved_tensors
    return saved, ctx.count if count is None else count


def unit_outputs(ctx, group, z, mean, var, count):
    """A unit's outputs: ``(z, mean, var)``, and the group's count as a
    fourth, non-differentiable output when the statistics are a group's."""
    if group is None:
        ctx.mark_non_differentiable(mean, var)
        return z, mean, var
    ctx.mark_non_differentiable(mean, var, count)
    return z, mean, var, count


def unit_result(out, z_like):
    """``(z, mean, var, count)`` from a unit's outputs; a rank's own count
    is the number of its rows."""
    if len(out) == 4:
        return out
    return (*out, float(z_like.numel() // z_like.shape[-1]))


class _BNActFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, cfg):
        group = _group(cfg)
        z, mean, var, count, invstd = _fwd_common(x, None, scale, bias, cfg,
                                                  group)
        save_stats(ctx, cfg, group, count, _xres_of(x, mean, invstd, cfg),
                   scale, bias, mean, invstd)
        ctx.x_dtype = x.dtype
        return unit_outputs(ctx, group, z, mean, var, count)

    @staticmethod
    def backward(ctx, dz, *_):
        (x, scale, bias, mean, invstd), count = saved_stats(ctx)
        dx, _, dscale, dbias = _bwd(ctx.cfg, x, scale, bias, mean, invstd,
                                    count, None, dz, False, None,
                                    ctx.x_dtype, ctx.group)
        return dx, dscale, dbias, None


class _BNAddActFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r, scale, bias, cfg):
        group = _group(cfg)
        z, mean, var, count, invstd = _fwd_common(x, r, scale, bias, cfg,
                                                  group)
        # z doubles as the ReLU mask source; it is the next conv's input
        save_stats(ctx, cfg, group, count, _xres_of(x, mean, invstd, cfg),
                   scale, bias, mean, invstd, z if cfg.relu else None)
        ctx.r_dtype, ctx.x_dtype = r.dtype, x.dtype
        return unit_outputs(ctx, group, z, mean, var, count)

    @staticmethod
    def backward(ctx, dz, *_):
        (x, scale, bias, mean, invstd, z), count = saved_stats(ctx)
        dx, dr, dscale, dbias = _bwd(ctx.cfg, x, scale, bias, mean, invstd,
                                     count, z, dz, True, ctx.r_dtype,
                                     ctx.x_dtype, ctx.group)
        return dx, dr, dscale, dbias, None


def bn_act_train(x, scale, bias, cfg: _Cfg):
    """Training-mode ``relu?(bn(x))`` over channels-last ``x``. Returns
    ``(z, mean, biased_var, count)``; the statistics carry no gradient.
    ``count`` is the number of rows, or with ``cfg.axis_name`` the group's
    count as a 0-dim f32 tensor."""
    return unit_result(_BNActFn.apply(x, scale, bias, cfg), x)


def bn_add_act_train(x, r, scale, bias, cfg: _Cfg):
    """Training-mode ``relu?(bn(x) + r)``, the residual-join unit. Returns
    ``(z, mean, biased_var, count)``."""
    return unit_result(_BNAddActFn.apply(x, r, scale, bias, cfg), x)


def bn_act_reference(x, scale, bias, *, residual=None, relu=True, eps=1e-5):
    """Plain-PyTorch oracle (centred variance, autograd backward)."""
    x32 = x.float()
    dims = tuple(range(x.dim() - 1))
    mean = x32.mean(dim=dims)
    var = torch.square(x32 - mean).mean(dim=dims)
    y = (x32 - mean) * (torch.rsqrt(var + eps) * scale.float()) + bias.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype), mean, var


# --- module ------------------------------------------------------------------

def running_stats(unit, mean, var, count):
    """The new running statistics of a BN unit (buffers ``mean``, ``var``,
    attribute ``momentum``): unbiased variance, ``ra = m·ra + (1−m)·new``,
    as the JAX package's units update theirs. ``count`` is a number, or a
    group's count as a tensor (kept on the device)."""
    m = unit.momentum
    if isinstance(count, torch.Tensor):
        unbiased = var * count / torch.clamp_min(count - 1.0, 1.0)
    else:
        unbiased = var * count / max(count - 1.0, 1.0)
    return (m * unit.mean + (1 - m) * mean,
            m * unit.var + (1 - m) * unbiased)


class FusedBNAct(nn.Module):
    """BatchNorm with optionally fused residual-add and ReLU, channels last.

    Parameters ``scale``/``bias`` and buffers ``mean``/``var`` are named
    as the flax module's params and ``batch_stats``. Running statistics
    follow the JAX package: unbiased variance, ``ra = m·ra + (1−m)·new``.
    In training, ``stats`` (a dict) receives ``stats[self] = (mean, var)``,
    the new running statistics, the counterpart of flax's
    ``mutable=["batch_stats"]``; the buffers themselves are not written.
    ``fp8_residuals``, or ``APEX_TPU_FP8_RESIDUALS=1`` in the environment
    when the unit is called, saves x̂ in e4m3 for the backward. As in the
    JAX package, a ReLU unit then derives its backward mask from the
    rounded x̂, so an activation within one e4m3 step of 0 may take the
    other side of the mask than in the forward.
    """

    def __init__(self, num_features: int, relu: bool = True,
                 momentum: float = 0.9, epsilon: float = 1e-5,
                 axis_name=None, axis_index_groups=None,
                 init_scale: float = 1.0, dtype: Optional[torch.dtype] = None,
                 fp8_residuals: bool = False, device="cuda"):
        super().__init__()
        self.cfg = make_cfg(relu=relu, eps=epsilon, axis_name=axis_name,
                            axis_index_groups=axis_index_groups,
                            fp8=fp8_residuals)
        self.momentum, self.init_scale = momentum, init_scale
        self.dtype = dtype
        c = num_features
        self.scale = nn.Parameter(torch.full((c,), float(init_scale),
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    def forward(self, x, residual=None, train: bool = True, stats=None):
        if self.dtype is not None:
            x = x.to(self.dtype)
            if residual is not None:
                residual = residual.to(self.dtype)
        if train and stats is None:
            raise ValueError("training mode returns the new running "
                             "statistics: pass a stats dict")
        if not train:
            inv = torch.rsqrt(self.var + self.cfg.eps)
            r2 = None if residual is None else _rows(residual)
            z = _apply(_rows(x), r2, self.scale, self.bias, self.mean, inv,
                       self.cfg.relu, x.dtype)
            return z.view(x.shape)
        cfg = self.cfg
        if os.environ.get(FP8_ENV) == "1":
            cfg = cfg._replace(fp8=True)
        if residual is None:
            z, mean, var, count = bn_act_train(x, self.scale, self.bias, cfg)
        else:
            z, mean, var, count = bn_add_act_train(x, residual, self.scale,
                                                   self.bias, cfg)
        stats[self] = running_stats(self, mean, var, count)
        return z
