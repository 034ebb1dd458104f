"""Fused LayerNorm: CUDA C++ forward and backward kernels, with a custom
autograd.

Port of ``apex_tpu/ops/layer_norm.py``. Kernels replaced (sources under
``apex_tpu_torch/csrc/``):

- ``ln_fwd_kernel`` (``layer_norm_fwd.cu``) ← ``_ln_fwd_kernel``
  (``_ln_forward``'s pallas_call): per row, centered two-pass mean/var in
  f32, normalize, optional affine, output in the input dtype.
- ``ln_bwd_kernel`` (``layer_norm_bwd.cu``) ← ``_ln_bwd_kernel``
  (``_ln_backward``): recompute the moments from x, dx = rstd·(gw −
  mean(gw) − x̂·mean(gw·x̂)), and f32 dγ/dβ from per-block partials added
  in the same launch.

What bounds them on an H100: bytes. Both are one read of each row operand
and one write, with a few flops per byte (the forward moves 2·N·H
elements, the backward 3·N·H), so they sit far below the card's
operations-per-byte ridge. Both: a warp owns a row and holds it in
registers, loaded and stored as 16-byte vectors where the rows allow
(:func:`_ln_plan`), with γ (and β) read once a block into shared memory;
wider rows take a block a row (the sources' notes). The forward's grid is
persistent; the backward's blocks own runs of rows fixed by the shape
(:func:`_ln_bwd_plan`), add their warps' dγ/dβ in shared memory and write
one partial each, and the last blocks to finish add the partials in a
fixed order (integer tickets, no float atomics), so two launches agree bit
for bit.

Only x (and the weight) is saved for the backward; the moments are
recomputed there, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
import numbers
import struct

import torch
import torch.nn as nn

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._priced import priced

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def _check(x2, *params):
    """(N, H) float rows; affine params f32-or-16-bit vectors of H."""
    _build.check_operands(x2, *[p for p in params if p is not None],
                          dtypes=_FLOATS)
    if x2.dim() != 2:
        raise ValueError(f"expected (N, H) rows, got {tuple(x2.shape)}")
    for p in params:
        if p is not None and p.shape != (x2.shape[1],):
            raise ValueError(f"param {tuple(p.shape)} != ({x2.shape[1]},)")


# --- the CUDA kernels --------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: elements a lane of the warp-a-row kernel's instances (``ln_fwd_warp``)
_EPL = (8, 16, 32, 64)
#: most elements a lane of the scalar path for f32 rows (ptxas spilled
#: the wider instances)
_SCALAR_F32_EPL = 16
#: widest row, in bytes, the block-a-row kernel stages in shared memory
_MAX_STAGED = 231424
#: warps of a block (``kWarps``)
_WARPS = 8
# apex_ln_fwd's paths
_SCALAR, _VECTOR, _STAGED, _STREAMED = range(4)


@functools.lru_cache(maxsize=None)
def _ln_plan(h: int, itemsize: int, aligned: bool) -> tuple:
    """``(path, elements a lane)`` of ``apex_ln_fwd`` for rows of ``h``
    elements of ``itemsize`` bytes. A row of up to 2048 elements takes a
    warp, in registers: as 16-byte vectors (``_VECTOR``) when x's base is
    16-byte ``aligned`` and a row is a whole number of vectors, else one
    element a load (``_SCALAR``; f32 only up to 512, ``_SCALAR_F32_EPL``).
    A wider row takes a block, staged in shared memory when it fits
    (``_STAGED``), else read from device memory (``_STREAMED``), with 0
    elements a lane."""
    for epl in _EPL:
        if 32 * epl >= h:
            if aligned and (h * itemsize) % 16 == 0:
                return _VECTOR, epl
            if itemsize < 4 or epl <= _SCALAR_F32_EPL:
                return _SCALAR, epl
            break
    return (_STAGED if h * itemsize <= _MAX_STAGED else _STREAMED), 0


#: ``LnCall`` of ``csrc/layer_norm_fwd.cu``, field by field: every field 64
#: bits, eps a double. One packed struct crosses ctypes in one argument.
LN_CALL_FIELDS = ("x", "w", "b", "y", "n", "h", "x_dtype", "w_dtype",
                  "b_dtype", "path", "epl", "eps")
_LN_CALL = struct.Struct("<11qd")


@functools.lru_cache(maxsize=None)
def _ln_fwd_lib():
    """The C entry point ``apex_ln_fwd(const LnCall*, stream)``."""
    fn = _build.load("layer_norm_fwd").apex_ln_fwd
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@priced("layer_norm_fwd")
def ln_fwd_kernel(x2, weight, bias, eps):
    """CUDA forward on a contiguous (N, H) CUDA tensor."""
    _check(x2, weight, bias)
    n, h = x2.shape
    y = torch.empty_like(x2)
    if y.numel() == 0:
        return y
    xp = x2.data_ptr()
    path, epl = _ln_plan(h, x2.element_size(), xp % 16 == 0)
    affine = weight is not None
    call = _LN_CALL.pack(
        xp, weight.data_ptr() if affine else 0,
        bias.data_ptr() if affine else 0, y.data_ptr(), n, h,
        _DTYPES[x2.dtype], _DTYPES[weight.dtype] if affine else 0,
        _DTYPES[bias.dtype] if affine else 0, path, epl, eps)
    _build.check(_ln_fwd_lib()(call, _build.stream_ptr(x2)),
                 "layer_norm_fwd")
    ln_fwd_kernel.launches += 1
    return y


ln_fwd_kernel.launches = 0


#: most blocks of the backward's grid
_BWD_BLOCKS = 256
#: widest x and g row, in bytes, the backward stages (``kMaxStagedBwd``)
_BWD_MAX_STAGED = _MAX_STAGED - 8192


@functools.lru_cache(maxsize=None)
def _ln_bwd_plan(n: int, h: int, itemsize: int, aligned: bool) -> tuple:
    """``(path, elements a lane, rows a block, blocks)`` of ``apex_ln_bwd``
    over (n, h) rows: the forward's paths (:func:`_ln_plan`; a staged row
    holds x and g, up to ``_BWD_MAX_STAGED`` bytes of both), at
    most ``_BWD_BLOCKS`` blocks of runs of ``rows`` rows (at least a row a
    warp on the warp paths; the last block takes the rest), one dγ/dβ
    partial each. A pure function of the shape, so the order of every sum
    is fixed."""
    path, epl = _ln_plan(h, itemsize, aligned)
    if path == _STAGED and 2 * h * itemsize > _BWD_MAX_STAGED:
        path = _STREAMED
    per_block = _WARPS if path in (_SCALAR, _VECTOR) else 1
    blocks = max(1, min(_BWD_BLOCKS, -(-n // per_block)))
    rows = -(-n // blocks)
    blocks = -(-n // rows)
    return path, epl, rows, blocks


#: ``LnBwdCall`` of ``csrc/layer_norm_bwd.cu``, field by field: every field
#: 64 bits, eps a double.
LN_BWD_CALL_FIELDS = ("g", "x", "w", "dx", "part", "counters", "out", "n",
                      "h", "x_dtype", "w_dtype", "path", "epl", "rows",
                      "blocks", "eps")
_LN_BWD_CALL = struct.Struct("<15qd")
#: the backward's (partials, counters), by raw stream handle
_bwd_buffers = {}


@functools.lru_cache(maxsize=None)
def _ln_bwd_lib():
    """The C entry point ``apex_ln_bwd(const LnBwdCall*, stream)``."""
    fn = _build.load("layer_norm_bwd").apex_ln_bwd
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@priced("layer_norm_bwd")
def ln_bwd_kernel(g2, x2, weight, eps):
    """CUDA backward: (dx, dγ, dβ) with dγ/dβ in f32 (None if no affine)."""
    _check(x2, weight)
    _build.check_operands(g2, x2, dtypes=(x2.dtype,))
    if g2.shape != x2.shape:
        raise ValueError(f"grad {tuple(g2.shape)} != input {tuple(x2.shape)}")
    n, h = x2.shape
    dx = torch.empty_like(x2)
    affine = weight is not None
    dwdb = (torch.empty((2, h), dtype=torch.float32, device=x2.device)
            if affine else None)
    if dx.numel() == 0:
        return (dx, None, None) if not affine else (dx, *dwdb.zero_())
    gp, xp = g2.data_ptr(), x2.data_ptr()
    path, epl, rows, blocks = _ln_bwd_plan(n, h, x2.element_size(),
                                           (gp | xp) % 16 == 0)
    stream = _build.stream_ptr(x2)
    part = counters = None
    if affine:
        part, counters = _build.workspace(
            _bwd_buffers, x2.device, stream, blocks * (-(-2 * h // 4) * 4),
            2)
    call = _LN_BWD_CALL.pack(
        gp, xp, weight.data_ptr() if affine else 0, dx.data_ptr(),
        part.data_ptr() if affine else 0,
        counters.data_ptr() if affine else 0,
        dwdb.data_ptr() if affine else 0, n, h, _DTYPES[x2.dtype],
        _DTYPES[weight.dtype] if affine else 0, path, epl, rows, blocks, eps)
    _build.check(_ln_bwd_lib()(call, stream), "layer_norm_bwd")
    ln_bwd_kernel.launches += 1
    if not affine:
        return dx, None, None
    return dx, dwdb[0], dwdb[1]


ln_bwd_kernel.launches = 0


# --- plain versions (the kernels' arithmetic, in PyTorch) --------------------

def _moments(x):
    mean = x.sum(dim=1, keepdim=True) / x.shape[1]
    var = torch.square(x - mean).sum(dim=1, keepdim=True) / x.shape[1]
    return mean, var


@priced("layer_norm_fwd")
def ln_fwd_plain(x2, weight, bias, eps):
    x = x2.float()
    mean, var = _moments(x)
    y = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y.to(x2.dtype)


@priced("layer_norm_bwd")
def ln_bwd_plain(g2, x2, weight, eps):
    x, g = x2.float(), g2.float()
    mean, var = _moments(x)
    rstd = torch.rsqrt(var + eps)
    xhat = (x - mean) * rstd
    gw = g * weight.float() if weight is not None else g
    h = x.shape[1]
    m1 = gw.sum(dim=1, keepdim=True) / h
    m2 = (gw * xhat).sum(dim=1, keepdim=True) / h
    dx = (rstd * (gw - m1 - xhat * m2)).to(x2.dtype)
    if weight is None:
        return dx, None, None
    return dx, (g * xhat).sum(dim=0), g.sum(dim=0)


def _ln_fwd(x2, weight, bias, eps):
    if x2.is_cuda:
        return ln_fwd_kernel(x2, weight, bias, eps)
    return ln_fwd_plain(x2, weight, bias, eps)


def _ln_bwd(g2, x2, weight, eps):
    if x2.is_cuda:
        return ln_bwd_kernel(g2, x2, weight, eps)
    return ln_bwd_plain(g2, x2, weight, eps)


# --- autograd + public API ---------------------------------------------------

class _LayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).contiguous()
        ctx.save_for_backward(x2, weight)
        ctx.eps = eps
        return _ln_fwd(x2, weight, bias, eps).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        x2, weight = ctx.saved_tensors
        g2 = g.reshape(x2.shape).contiguous()
        dx, dw, db = _ln_bwd(g2, x2, weight, ctx.eps)
        dx = dx.reshape(g.shape)
        if weight is None:
            return dx, None, None, None
        return dx, dw.to(weight.dtype), db.to(weight.dtype), None


def fused_layer_norm_affine(x, weight, bias, eps=1e-5):
    """LayerNorm over the last dim with affine params; weight/bias grads
    come back in the weight's dtype."""
    return _LayerNormFn.apply(x, weight, bias, eps)


def fused_layer_norm(x, eps=1e-5):
    """Non-affine LayerNorm."""
    return _LayerNormFn.apply(x, None, None, eps)


def layer_norm_reference(x, weight=None, bias=None, eps=1e-5):
    """Plain-PyTorch oracle (mean/var over the last dim in fp32)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y.to(x.dtype)


class FusedLayerNorm(nn.Module):
    """Module mirror of ``apex.normalization.FusedLayerNorm``; params are
    named ``scale`` and ``bias`` as in the JAX package.

    As the JAX package's module, it normalises over the last axis only,
    whatever ``normalized_shape`` is, and holds (prod(normalized_shape),)
    params; with ``elementwise_affine`` those must be as wide as the last
    axis, so an affine module over more than one non-trivial axis raises
    (the JAX module fails in a reshape there)."""

    def __init__(self, normalized_shape, eps=1e-5, elementwise_affine=True,
                 device="cuda"):
        super().__init__()
        if isinstance(normalized_shape, numbers.Integral):
            normalized_shape = (normalized_shape,)
        h = 1
        for d in normalized_shape:
            h *= int(d)
        if elementwise_affine and h != int(normalized_shape[-1]):
            raise ValueError(
                f"FusedLayerNorm{tuple(normalized_shape)} with affine params: "
                f"the JAX package normalises over the last axis only and its "
                f"({h},) scale cannot broadcast against it")
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            self.scale = nn.Parameter(torch.ones(h, device=device))
            self.bias = nn.Parameter(torch.zeros(h, device=device))

    def forward(self, x):
        if self.elementwise_affine:
            return fused_layer_norm_affine(x, self.scale, self.bias, self.eps)
        return fused_layer_norm(x, self.eps)
