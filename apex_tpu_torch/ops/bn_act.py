"""Fused BatchNorm → (+residual) → ReLU over channels-last activations.

Port of ``apex_tpu/ops/bn_act.py``: one autograd unit per BN(+add)(+ReLU)
whose backward saves only the conv output ``x``, the per-channel
``(mean, invstd)`` and, for the residual join with ReLU, the unit output
``z`` (the next conv's input, alive anyway); x̂ and the ReLU mask are
recomputed in-register. Kernels replaced (the JAX package's
``_bwd_pallas`` pair; its default ``_bwd_jnp`` computes the same function,
which is what the plain versions below compute):

- ``bn_sums_kernel`` ← ``_sums_kernel``: per channel Σg and Σg·x̂ over the
  M rows, x̂ = (x−μ)·invstd; the mask is ``x̂γ+β > 0`` ("relu") or ``z > 0``
  ("addrelu", which also writes dr = mask⊙dz).
- ``bn_dx_kernel`` ← ``_dx_kernel``: dx = γ·invstd·(g − k1 − x̂·k2) with
  k1 = Σg/n and k2 = Σg·x̂/n ("relu" recomputes the mask; "addrelu" passes
  the pre-masked dr as g).

What bounds them on an H100: bytes. Each is one streaming pass over (M, C)
rows with a few flops per element: the sums read x and g (and z, writing
dr), dx reads x and g and writes dx. Design: tiles of (BLOCK_M, BLOCK_C)
coalesced along C, masked on both axes so any (M, C) works, all math in
f32 with the JAX formulas term for term and no FMA contraction (so the
recomputed mask agrees with the plain version bit for bit). The TPU sums
kernel adds every row block into one output block over its in-order grid;
Hopper blocks run in no order, so here each program of a (row chunks ×
channel blocks) grid keeps its sums in registers, writes one (2, BLOCK_C)
partial, and ``torch.sum`` adds the partials: deterministic, no float
atomics. k1 and k2 are formed inside the dx kernel from the sums buffer
and the count, so nothing is read back to the host.

The forward (moments, normalise, add, ReLU) is plain PyTorch, as the JAX
package has jnp there: one-pass f32 moments E[x²]−E[x]² (clamped at 0),
reduced straight from the half input without an f32 copy of it.

Activations are contiguous NHWC tensors: a unit views them as (M, C) with
``.view`` and never copies one silently. A gradient that autograd hands
over in another layout (a broadcast from the global mean, a slice from a
padding) is copied explicitly and counted in ``layout_copies``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from apex_tpu_torch.ops import _build

tl = None  # triton.language, bound by _build.triton_jit at the first launch

_MODES = {"plain": 0, "relu": 1, "addrelu": 2}
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)
_TILE = 4096        # elements of one (BLOCK_M, BLOCK_C) tile

#: gradients copied into the (M, C) row layout by ``_grad_rows``
layout_copies = 0


# --- Triton kernels -----------------------------------------------------------

def _bn_sums_triton(X, G, Z, SCALE, BIAS, MEAN, INVSTD, PART, DR, M, C,
                    rows_per_prog, MODE: "tl.constexpr",
                    BLOCK_M: "tl.constexpr", BLOCK_C: "tl.constexpr"):
    pid_m = tl.program_id(0)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    mean = tl.load(MEAN + cols, mask=cmask, other=0.0)[None, :]
    invstd = tl.load(INVSTD + cols, mask=cmask, other=0.0)[None, :]
    if MODE == 1:
        scale = tl.load(SCALE + cols, mask=cmask,
                        other=0.0).to(tl.float32)[None, :]
        bias = tl.load(BIAS + cols, mask=cmask,
                       other=0.0).to(tl.float32)[None, :]
    acc_g = tl.zeros([BLOCK_M, BLOCK_C], dtype=tl.float32)
    acc_gx = tl.zeros([BLOCK_M, BLOCK_C], dtype=tl.float32)
    row0 = pid_m.to(tl.int64) * rows_per_prog
    for i in range(0, rows_per_prog, BLOCK_M):
        rows = row0 + i + tl.arange(0, BLOCK_M)
        m = (rows < M)[:, None] & cmask[None, :]
        offs = rows[:, None] * C + cols[None, :]
        x = tl.load(X + offs, mask=m, other=0.0).to(tl.float32)
        g = tl.load(G + offs, mask=m, other=0.0).to(tl.float32)
        xhat = (x - mean) * invstd
        if MODE == 1:
            g = tl.where(xhat * scale + bias > 0, g, 0.0)
        if MODE == 2:
            z = tl.load(Z + offs, mask=m, other=0.0).to(tl.float32)
            g = tl.where(z > 0, g, 0.0)
            tl.store(DR + offs, g.to(DR.dtype.element_ty), mask=m)
        acc_g += g
        acc_gx += g * xhat
    base = PART + pid_m.to(tl.int64) * 2 * C
    tl.store(base + cols, tl.sum(acc_g, axis=0), mask=cmask)
    tl.store(base + C + cols, tl.sum(acc_gx, axis=0), mask=cmask)


def _bn_dx_triton(X, G, SCALE, BIAS, MEAN, INVSTD, SUMS, DX, M, C, count,
                  RELU: "tl.constexpr", BLOCK_M: "tl.constexpr",
                  BLOCK_C: "tl.constexpr"):
    rows = tl.program_id(0).to(tl.int64) * BLOCK_M + tl.arange(0, BLOCK_M)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    mean = tl.load(MEAN + cols, mask=cmask, other=0.0)
    invstd = tl.load(INVSTD + cols, mask=cmask, other=0.0)
    scale = tl.load(SCALE + cols, mask=cmask, other=0.0).to(tl.float32)
    k1 = tl.div_rn(tl.load(SUMS + cols, mask=cmask, other=0.0), count)
    k2 = tl.div_rn(tl.load(SUMS + C + cols, mask=cmask, other=0.0), count)
    m = (rows < M)[:, None] & cmask[None, :]
    offs = rows[:, None] * C + cols[None, :]
    x = tl.load(X + offs, mask=m, other=0.0).to(tl.float32)
    g = tl.load(G + offs, mask=m, other=0.0).to(tl.float32)
    xhat = (x - mean[None, :]) * invstd[None, :]
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


def _check_unit(x2, g2, scale, bias, mean, invstd):
    _build.check_operands(x2, g2, scale, bias, mean, invstd, dtypes=_FLOATS)
    _check_f32(mean, invstd)
    if x2.dim() != 2 or g2.shape != x2.shape:
        raise ValueError(f"expected (M, C) rows of one shape, got "
                         f"{tuple(x2.shape)} and {tuple(g2.shape)}")
    c = x2.shape[1]
    for v in (scale, bias, mean, invstd):
        if v.shape != (c,):
            raise ValueError(f"per-channel vector {tuple(v.shape)} != ({c},)")


def bn_sums_kernel(x2, g2, z2, scale, bias, mean, invstd, mode, r_dtype=None):
    """Triton channel sums over contiguous (M, C) CUDA rows. Returns
    (sums (2, C) f32: Σg and Σg·x̂, dr in ``r_dtype`` for "addrelu" else
    None)."""
    _check_unit(x2, g2, scale, bias, mean, invstd)
    addrelu = mode == "addrelu"
    if addrelu:
        _build.check_operands(x2, z2, dtypes=_FLOATS)
        if z2.shape != x2.shape:
            raise ValueError("z must have x's (M, C) shape")
    m, c = x2.shape
    block_m, block_c = _tiles(c)
    n_cb = -(-c // block_c)
    # about four programs per SM in all, each walking a run of rows
    sms = torch.cuda.get_device_properties(x2.device).multi_processor_count
    progs = max(1, min(-(-m // block_m), 4 * sms // n_cb))
    rows = -(-m // progs)
    rows = -(-rows // block_m) * block_m
    progs = -(-m // rows)
    part = torch.empty((progs, 2, c), dtype=torch.float32, device=x2.device)
    dr = torch.empty(x2.shape, dtype=r_dtype or g2.dtype,
                     device=x2.device) if addrelu else None
    _build.triton_jit(_bn_sums_triton)[(progs, n_cb)](
        x2, g2, z2 if addrelu else x2, scale, bias, mean, invstd, part,
        dr if addrelu else part, m, c, rows, MODE=_MODES[mode],
        BLOCK_M=block_m, BLOCK_C=block_c, num_warps=8,
        enable_fp_fusion=False)
    bn_sums_kernel.launches += 1
    return part.sum(dim=0), dr       # stage-2 sum of the per-program partials


bn_sums_kernel.launches = 0


def bn_dx_kernel(x2, g2, scale, bias, mean, invstd, sums, count, relu,
                 dx_dtype):
    """Triton dx over contiguous (M, C) CUDA rows; ``sums`` is the (2, C)
    f32 output of the sums pass and ``count`` the number of rows the
    statistics cover."""
    _check_unit(x2, g2, scale, bias, mean, invstd)
    _build.check_operands(x2, sums)
    _check_f32(sums)
    m, c = x2.shape
    if sums.shape != (2, c):
        raise ValueError(f"sums {tuple(sums.shape)} != (2, {c})")
    block_m, block_c = _tiles(c)
    dx = torch.empty(x2.shape, dtype=dx_dtype, device=x2.device)
    _build.triton_jit(_bn_dx_triton)[(-(-m // block_m), -(-c // block_c))](
        x2, g2, scale, bias, mean, invstd, sums, dx, m, c, float(count),
        RELU=bool(relu), BLOCK_M=block_m, BLOCK_C=block_c, num_warps=8,
        enable_fp_fusion=False)
    bn_dx_kernel.launches += 1
    return dx


bn_dx_kernel.launches = 0


# --- plain versions (the kernels' arithmetic, in PyTorch) --------------------

def _xhat(x2, mean, invstd):
    return (x2.float() - mean) * invstd


def _relu_mask(xhat, scale, bias):
    return xhat * scale.float() + bias.float() > 0


def bn_sums_plain(x2, g2, z2, scale, bias, mean, invstd, mode, r_dtype=None):
    xhat = _xhat(x2, mean, invstd)
    g = g2.float()
    dr = None
    if mode == "relu":
        g = torch.where(_relu_mask(xhat, scale, bias), g, 0.0)
    elif mode == "addrelu":
        g = torch.where(z2.float() > 0, g, 0.0)
        dr = g.to(r_dtype or g2.dtype)
    return torch.stack([g.sum(dim=0), (g * xhat).sum(dim=0)]), dr


def bn_dx_plain(x2, g2, scale, bias, mean, invstd, sums, count, relu,
                dx_dtype):
    xhat = _xhat(x2, mean, invstd)
    g = g2.float()
    if relu:
        g = torch.where(_relu_mask(xhat, scale, bias), g, 0.0)
    k1, k2 = sums[0] / count, sums[1] / count
    scale32 = scale.float()
    return ((scale32 * invstd) * (g - k1 - xhat * k2)).to(dx_dtype)


# --- forward (plain PyTorch, as the JAX package's jnp) -----------------------

class _Cfg(NamedTuple):
    """Static configuration of one unit."""
    relu: bool
    eps: float


def make_cfg(*, relu: bool, eps: float = 1e-5, axis_name=None,
             axis_index_groups=None, fp8: bool = False) -> _Cfg:
    if axis_name is not None or axis_index_groups is not None:
        raise NotImplementedError(
            "cross-device BN statistics (axis_name) are not ported yet "
            "(ROADMAP.md queue A, the distributed slice)")
    if fp8:
        raise NotImplementedError("fp8 backward residuals are not ported yet")
    return _Cfg(relu=bool(relu), eps=float(eps))


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


def _fwd_common(x, r, scale, bias, cfg: _Cfg):
    x2 = _rows(x)
    mean, var, count = _stats(x2)
    invstd = torch.rsqrt(var + cfg.eps)
    r2 = None if r is None else _rows(r)
    z = _apply(x2, r2, scale, bias, mean, invstd, cfg.relu, x.dtype)
    return z.view(x.shape), mean, var, count, invstd


def _bwd(cfg: _Cfg, x, scale, bias, mean, invstd, count, z, dz,
         has_residual, r_dtype):
    """The two passes: channel sums (+ dr), then dx. CUDA tensors launch
    the kernels; CPU tensors take their plain versions."""
    x2, g2 = _rows(x), _grad_rows(dz)
    mode = ("addrelu" if cfg.relu and has_residual
            else "relu" if cfg.relu else "plain")
    sums_fn = bn_sums_kernel if x2.is_cuda else bn_sums_plain
    dx_fn = bn_dx_kernel if x2.is_cuda else bn_dx_plain
    sums, dr2 = sums_fn(x2, g2, None if z is None else _rows(z), scale, bias,
                        mean, invstd, mode, r_dtype)
    g_src = dr2 if mode == "addrelu" else g2
    dx = dx_fn(x2, g_src, scale, bias, mean, invstd, sums, count,
               mode == "relu", x.dtype).view(x.shape)
    dscale, dbias = sums[1].to(scale.dtype), sums[0].to(bias.dtype)
    if not has_residual:
        return dx, None, dscale, dbias
    # no relu in the unit: the add is the identity, dr is dz itself
    dr = dr2.view(x.shape) if dr2 is not None else dz.to(r_dtype)
    return dx, dr, dscale, dbias


class _BNActFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, cfg):
        z, mean, var, count, invstd = _fwd_common(x, None, scale, bias, cfg)
        ctx.save_for_backward(x, scale, bias, mean, invstd)
        ctx.cfg, ctx.count = cfg, count
        ctx.mark_non_differentiable(mean, var)
        return z, mean, var

    @staticmethod
    def backward(ctx, dz, _dmean, _dvar):
        x, scale, bias, mean, invstd = ctx.saved_tensors
        dx, _, dscale, dbias = _bwd(ctx.cfg, x, scale, bias, mean, invstd,
                                    ctx.count, None, dz, False, None)
        return dx, dscale, dbias, None


class _BNAddActFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r, scale, bias, cfg):
        z, mean, var, count, invstd = _fwd_common(x, r, scale, bias, cfg)
        # z doubles as the ReLU mask source; it is the next conv's input
        ctx.save_for_backward(x, scale, bias, mean, invstd,
                              z if cfg.relu else None)
        ctx.cfg, ctx.count, ctx.r_dtype = cfg, count, r.dtype
        ctx.mark_non_differentiable(mean, var)
        return z, mean, var

    @staticmethod
    def backward(ctx, dz, _dmean, _dvar):
        x, scale, bias, mean, invstd, z = ctx.saved_tensors
        dx, dr, dscale, dbias = _bwd(ctx.cfg, x, scale, bias, mean, invstd,
                                     ctx.count, z, dz, True, ctx.r_dtype)
        return dx, dr, dscale, dbias, None


def bn_act_train(x, scale, bias, cfg: _Cfg):
    """Training-mode ``relu?(bn(x))`` over channels-last ``x``. Returns
    ``(z, mean, biased_var, count)``; the statistics carry no gradient."""
    z, mean, var = _BNActFn.apply(x, scale, bias, cfg)
    return z, mean, var, float(x.numel() // x.shape[-1])


def bn_add_act_train(x, r, scale, bias, cfg: _Cfg):
    """Training-mode ``relu?(bn(x) + r)``, the residual-join unit. Returns
    ``(z, mean, biased_var, count)``."""
    z, mean, var = _BNAddActFn.apply(x, r, scale, bias, cfg)
    return z, mean, var, float(x.numel() // x.shape[-1])


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

class FusedBNAct(nn.Module):
    """BatchNorm with optionally fused residual-add and ReLU, channels last.

    Parameters ``scale``/``bias`` and buffers ``mean``/``var`` are named
    as the flax module's params and ``batch_stats``. Running statistics
    follow the JAX package: unbiased variance, ``ra = m·ra + (1−m)·new``.
    In training, ``stats`` (a dict) receives ``stats[self] = (mean, var)``,
    the new running statistics, the counterpart of flax's
    ``mutable=["batch_stats"]``; the buffers themselves are not written.
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
        if residual is None:
            z, mean, var, count = bn_act_train(x, self.scale, self.bias,
                                               self.cfg)
        else:
            z, mean, var, count = bn_add_act_train(x, residual, self.scale,
                                                   self.bias, self.cfg)
        m = self.momentum
        unbiased = var * count / max(count - 1.0, 1.0)
        stats[self] = (m * self.mean + (1 - m) * mean,
                       m * self.var + (1 - m) * unbiased)
        return z
