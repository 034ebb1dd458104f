"""Optimizer updates over the flat arena: LAMB's two stages, SGD, Adam,
Adagrad and NovoGrad, in Triton.

Port of ``apex_tpu/ops/optim_kernels.py``'s kernels. Kernels replaced:

- ``lamb_stage1_kernel`` ← ``_lamb_stage1_kernel``: the clipped grad's new
  moments m, v and the update direction u = m̂/(√v̂ + eps) (+ wd·p), f32.
- ``lamb_stage2_kernel`` ← ``_lamb_stage2_kernel``: p −= lr·r·u with the
  trust ratio r given per position, and an optional low-precision copy
  of the new p written in the same pass.
- ``sgd_kernel`` ← ``_sgd_kernel``: SGD with momentum, dampening,
  nesterov, weight decay before or after the momentum, the first step's
  momentum buffer set to the gradient by a runtime flag, and the optional
  low-precision copy of the new p.
- ``adam_kernel`` ← ``_adam_kernel``: Adam, or AdamW with the weight decay
  decoupled, the bias corrections and a grad scale as runtime scalars,
  and the optional low-precision copy of the new p.
- ``adagrad_kernel`` ← ``_adagrad_kernel``: Adagrad, h += g², p −=
  lr·g/(√h + eps), the weight decay folded into g or (W mode) decoupled,
  with a grad scale.
- ``novograd_kernel`` ← ``_novograd_kernel``: NovoGrad's elementwise
  stage, the denominator v/bc2 + eps from the per-tensor norm EMA v given
  per position; the reference's default moment mode (raw-grad momentum,
  decoupled decay) or ``reg_inside_moment`` (normalised grad and decay
  inside the momentum).

What bounds them on an H100: bytes. Each is one streaming pass with a
few flops per element and no reuse: stage 1 reads p, g, m, v and writes
u, m, v (28N bytes for an f32 partition of N elements), stage 2 reads p,
u, r and writes p (16N), SGD reads p, g, m and writes p, m (20N), Adam
reads p, g, m, v and writes p, m, v (28N), Adagrad reads p, g, h and
writes p, h (20N), NovoGrad reads p, g, m, v and writes p, m (24N).
Design: one program per 1024-element block of the buffer (whose length
is a multiple of 65536, so no block needs a mask), offsets in int64, all
math in f32 whatever p's dtype, and the runtime scalars (betas, eps, wd,
bias corrections, clip factor, β3, lr; SGD's lr, momentum, dampening,
wd, grad scale and first-step flag; Adam's lr, betas, eps, wd, bias
corrections and grad scale; Adagrad's lr, eps, wd and grad scale;
NovoGrad's lr, β1, β3, eps, wd and bias corrections) loaded from one f32
device tensor, so that a step count, a global norm or a scheduled lr
never leaves the device. The algorithm flags (AdamW mode, nesterov, wd
after momentum, the copy-out, Adagrad's W mode, NovoGrad's moment mode)
are ``tl.constexpr``: each combination compiles its own kernel, as the
JAX package specialises its Pallas kernels. Divisions and roots round as
IEEE (``div_rn``, ``sqrt_rn``), as the plain versions do; the Adam,
Adagrad and NovoGrad kernels also compile without FMA contraction, so
they round each product and sum where their plain versions do. A copy-out
in ``torch.float8_e5m2`` (ZeRO's compressed all-gather) is written as
bytes: PTX's f32 -> e5m2 convert saturates at the largest finite value,
57344, and the kernels set |p| >= 61440 to ±inf, as PyTorch's and JAX's
casts round it.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import _arena, _build
from apex_tpu_torch.ops._priced import priced

tl = None  # triton.language, bound by _build.triton_jit at the first launch

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)
_BLOCK = 1024


def _lamb_stage1_triton(P, G, M, V, S, U, MO, VO, ADAM_W: "tl.constexpr",
                        BLOCK: "tl.constexpr"):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    b1 = tl.load(S)
    b2 = tl.load(S + 1)
    eps = tl.load(S + 2)
    wd = tl.load(S + 3)
    bc1 = tl.load(S + 4)
    bc2 = tl.load(S + 5)
    clip = tl.load(S + 6)
    b3 = tl.load(S + 7)
    p = tl.load(P + offs).to(tl.float32)
    g = tl.load(G + offs).to(tl.float32) * clip
    m = tl.load(M + offs).to(tl.float32)
    v = tl.load(V + offs).to(tl.float32)
    if ADAM_W:
        gw = g
    else:
        gw = g + wd * p
    m = b1 * m + b3 * gw
    v = b2 * v + (1.0 - b2) * gw * gw
    u = tl.div_rn(tl.div_rn(m, bc1), tl.sqrt_rn(tl.div_rn(v, bc2)) + eps)
    if ADAM_W:
        u = u + wd * p
    tl.store(U + offs, u)
    tl.store(MO + offs, m.to(MO.dtype.element_ty))
    tl.store(VO + offs, v.to(VO.dtype.element_ty))


def _lamb_stage2_triton(P, U, R, S, PO, CP, HAS_COPY: "tl.constexpr",
                        COPY_E5M2: "tl.constexpr", BLOCK: "tl.constexpr"):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    lr = tl.load(S)
    p = tl.load(P + offs).to(tl.float32)
    u = tl.load(U + offs)
    r = tl.load(R + offs)
    p = p - lr * r * u
    tl.store(PO + offs, p.to(PO.dtype.element_ty))
    if HAS_COPY:
        if COPY_E5M2:
            # CP is the e5m2 copy's bytes: PTX's f32 -> e5m2 convert
            # saturates at 57344, where PyTorch and JAX round |p| >= 61440
            # (half way to 2**16) to inf
            bits = p.to(tl.float8e5, fp_downcast_rounding="rtne").to(
                tl.uint8, bitcast=True)
            inf = tl.where(p > 0, 0x7C, 0xFC).to(tl.uint8)
            tl.store(CP + offs, tl.where(tl.abs(p) >= 61440.0, inf, bits))
        else:
            tl.store(CP + offs, p.to(CP.dtype.element_ty))


def _sgd_triton(P, G, M, S, PO, MO, CP, NESTEROV: "tl.constexpr",
                WD_AFTER_MOMENTUM: "tl.constexpr", HAS_COPY: "tl.constexpr",
                COPY_E5M2: "tl.constexpr", BLOCK: "tl.constexpr"):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    lr = tl.load(S)
    momentum = tl.load(S + 1)
    dampening = tl.load(S + 2)
    wd = tl.load(S + 3)
    gscale = tl.load(S + 4)
    first = tl.load(S + 5)
    p = tl.load(P + offs).to(tl.float32)
    g = tl.load(G + offs).to(tl.float32) * gscale
    m = tl.load(M + offs).to(tl.float32)
    if not WD_AFTER_MOMENTUM:
        g = g + wd * p
    m = tl.where(first > 0.5, g, momentum * m + (1.0 - dampening) * g)
    if NESTEROV:
        upd = g + momentum * m
    else:
        upd = m
    if WD_AFTER_MOMENTUM:
        upd = upd + wd * p
    p = p - lr * upd
    tl.store(PO + offs, p.to(PO.dtype.element_ty))
    tl.store(MO + offs, m.to(MO.dtype.element_ty))
    if HAS_COPY:
        if COPY_E5M2:
            # CP is the e5m2 copy's bytes: PTX's f32 -> e5m2 convert
            # saturates at 57344, where PyTorch and JAX round |p| >= 61440
            # (half way to 2**16) to inf
            bits = p.to(tl.float8e5, fp_downcast_rounding="rtne").to(
                tl.uint8, bitcast=True)
            inf = tl.where(p > 0, 0x7C, 0xFC).to(tl.uint8)
            tl.store(CP + offs, tl.where(tl.abs(p) >= 61440.0, inf, bits))
        else:
            tl.store(CP + offs, p.to(CP.dtype.element_ty))


def _adam_triton(P, G, M, V, S, PO, MO, VO, CP, ADAM_W: "tl.constexpr",
                 HAS_COPY: "tl.constexpr", COPY_E5M2: "tl.constexpr",
                 BLOCK: "tl.constexpr"):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    lr = tl.load(S)
    b1 = tl.load(S + 1)
    b2 = tl.load(S + 2)
    eps = tl.load(S + 3)
    wd = tl.load(S + 4)
    bc1 = tl.load(S + 5)
    bc2 = tl.load(S + 6)
    gscale = tl.load(S + 7)
    p = tl.load(P + offs).to(tl.float32)
    g = tl.load(G + offs).to(tl.float32) * gscale
    m = tl.load(M + offs).to(tl.float32)
    v = tl.load(V + offs).to(tl.float32)
    if not ADAM_W:
        g = g + wd * p
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    upd = tl.div_rn(tl.div_rn(m, bc1), tl.sqrt_rn(tl.div_rn(v, bc2)) + eps)
    if ADAM_W:
        upd = upd + wd * p
    p = p - lr * upd
    tl.store(PO + offs, p.to(PO.dtype.element_ty))
    tl.store(MO + offs, m.to(MO.dtype.element_ty))
    tl.store(VO + offs, v.to(VO.dtype.element_ty))
    if HAS_COPY:
        if COPY_E5M2:
            # CP is the e5m2 copy's bytes: PTX's f32 -> e5m2 convert
            # saturates at 57344, where PyTorch and JAX round |p| >= 61440
            # (half way to 2**16) to inf
            bits = p.to(tl.float8e5, fp_downcast_rounding="rtne").to(
                tl.uint8, bitcast=True)
            inf = tl.where(p > 0, 0x7C, 0xFC).to(tl.uint8)
            tl.store(CP + offs, tl.where(tl.abs(p) >= 61440.0, inf, bits))
        else:
            tl.store(CP + offs, p.to(CP.dtype.element_ty))


def _adagrad_triton(P, G, H, S, PO, HO, ADAGRAD_W: "tl.constexpr",
                    BLOCK: "tl.constexpr"):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    lr = tl.load(S)
    eps = tl.load(S + 1)
    wd = tl.load(S + 2)
    gscale = tl.load(S + 3)
    p = tl.load(P + offs).to(tl.float32)
    g = tl.load(G + offs).to(tl.float32) * gscale
    h = tl.load(H + offs).to(tl.float32)
    if not ADAGRAD_W:
        g = g + wd * p
    h = h + g * g
    upd = tl.div_rn(g, tl.sqrt_rn(h) + eps)
    if ADAGRAD_W:
        upd = upd + wd * p
    p = p - lr * upd
    tl.store(PO + offs, p.to(PO.dtype.element_ty))
    tl.store(HO + offs, h.to(HO.dtype.element_ty))


def _novograd_triton(P, G, M, V, S, PO, MO, REG_INSIDE_MOMENT: "tl.constexpr",
                     BLOCK: "tl.constexpr"):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    lr = tl.load(S)
    b1 = tl.load(S + 1)
    b3 = tl.load(S + 2)
    eps = tl.load(S + 3)
    wd = tl.load(S + 4)
    bc1 = tl.load(S + 5)
    bc2 = tl.load(S + 6)
    p = tl.load(P + offs).to(tl.float32)
    g = tl.load(G + offs).to(tl.float32)
    m = tl.load(M + offs).to(tl.float32)
    denom = tl.div_rn(tl.load(V + offs), bc2) + eps
    if REG_INSIDE_MOMENT:
        g = tl.div_rn(g, denom) + wd * p
        m = b1 * m + b3 * g
        p = p - lr * tl.div_rn(m, bc1)
    else:
        m = b1 * m + b3 * g
        p = p - lr * (tl.div_rn(tl.div_rn(m, bc1), denom) + wd * p)
    tl.store(PO + offs, p.to(PO.dtype.element_ty))
    tl.store(MO + offs, m.to(MO.dtype.element_ty))


def _is_e5m2(cp) -> bool:
    return cp is not None and cp.dtype == torch.float8_e5m2


def _copy_operand(cp, p2):
    """The copy-out operand: ``p2`` (unused) without a copy, the bytes of an
    e5m2 copy (the kernel writes them), else the copy itself."""
    if cp is None:
        return p2
    return cp.view(torch.uint8) if _is_e5m2(cp) else cp


@priced("lamb_stage1")
def lamb_stage1_kernel(p, g, m, v, scalars, adam_w):
    """Triton stage 1 on flat CUDA buffers; ``scalars`` is the f32 device
    vector (beta1, beta2, eps, wd, bc1, bc2, clip, b3). Returns
    (u f32, m', v')."""
    n = _arena.check_buffers(p, g, m, v, dtypes=_FLOATS)
    _build.check_operands(p, scalars)
    if (g.dtype != torch.float32 or scalars.shape != (8,)
            or scalars.dtype != torch.float32):
        raise ValueError("stage 1 takes f32 grads and 8 f32 scalars")
    u = torch.empty(n, dtype=torch.float32, device=p.device)
    m2, v2 = torch.empty_like(m), torch.empty_like(v)
    _build.triton_jit(_lamb_stage1_triton)[(n // _BLOCK,)](
        p, g, m, v, scalars, u, m2, v2, ADAM_W=bool(adam_w), BLOCK=_BLOCK,
        num_warps=4)
    lamb_stage1_kernel.launches += 1
    return u, m2, v2


lamb_stage1_kernel.launches = 0


@priced("lamb_stage2")
def lamb_stage2_kernel(p, u, ratio, scalars, copy_dtype=None):
    """Triton stage 2 on flat CUDA buffers; ``scalars`` is the f32 device
    vector (lr,). Returns p' (and p' in ``copy_dtype`` if given)."""
    n = _arena.check_buffers(p, u, ratio, dtypes=_FLOATS)
    _build.check_operands(p, scalars)
    if (u.dtype != torch.float32 or ratio.dtype != torch.float32
            or scalars.shape != (1,) or scalars.dtype != torch.float32):
        raise ValueError("stage 2 takes f32 u, ratio and one f32 scalar")
    p2 = torch.empty_like(p)
    cp = None if copy_dtype is None else torch.empty(n, dtype=copy_dtype,
                                                     device=p.device)
    _build.triton_jit(_lamb_stage2_triton)[(n // _BLOCK,)](
        p, u, ratio, scalars, p2, _copy_operand(cp, p2),
        HAS_COPY=cp is not None, COPY_E5M2=_is_e5m2(cp), BLOCK=_BLOCK,
        num_warps=4)
    lamb_stage2_kernel.launches += 1
    return p2 if cp is None else (p2, cp)


lamb_stage2_kernel.launches = 0


@priced("sgd")
def sgd_kernel(p, g, m, scalars, nesterov, wd_after_momentum,
               copy_dtype=None):
    """Triton SGD on flat CUDA buffers; ``scalars`` is the f32 device
    vector (lr, momentum, dampening, wd, grad_scale, first). Returns
    (p', m') or (p', m', p' in ``copy_dtype``)."""
    n = _arena.check_buffers(p, g, m, dtypes=_FLOATS)
    _build.check_operands(p, scalars)
    if scalars.shape != (6,) or scalars.dtype != torch.float32:
        raise ValueError("SGD takes 6 f32 scalars")
    p2, m2 = torch.empty_like(p), torch.empty_like(m)
    cp = None if copy_dtype is None else torch.empty(n, dtype=copy_dtype,
                                                     device=p.device)
    _build.triton_jit(_sgd_triton)[(n // _BLOCK,)](
        p, g, m, scalars, p2, m2, _copy_operand(cp, p2),
        NESTEROV=bool(nesterov), WD_AFTER_MOMENTUM=bool(wd_after_momentum),
        HAS_COPY=cp is not None, COPY_E5M2=_is_e5m2(cp), BLOCK=_BLOCK,
        num_warps=4)
    sgd_kernel.launches += 1
    return (p2, m2) if cp is None else (p2, m2, cp)


sgd_kernel.launches = 0


@priced("adam")
def adam_kernel(p, g, m, v, scalars, adam_w, copy_dtype=None):
    """Triton Adam on flat CUDA buffers; ``scalars`` is the f32 device
    vector (lr, beta1, beta2, eps, wd, bc1, bc2, grad_scale). Returns
    (p', m', v') or (p', m', v', p' in ``copy_dtype``)."""
    n = _arena.check_buffers(p, g, m, v, dtypes=_FLOATS)
    _build.check_operands(p, scalars)
    if scalars.shape != (8,) or scalars.dtype != torch.float32:
        raise ValueError("Adam takes 8 f32 scalars")
    p2, m2, v2 = torch.empty_like(p), torch.empty_like(m), torch.empty_like(v)
    cp = None if copy_dtype is None else torch.empty(n, dtype=copy_dtype,
                                                     device=p.device)
    _build.triton_jit(_adam_triton)[(n // _BLOCK,)](
        p, g, m, v, scalars, p2, m2, v2, _copy_operand(cp, p2),
        ADAM_W=bool(adam_w), HAS_COPY=cp is not None,
        COPY_E5M2=_is_e5m2(cp), BLOCK=_BLOCK,
        num_warps=4, enable_fp_fusion=False)
    adam_kernel.launches += 1
    return (p2, m2, v2) if cp is None else (p2, m2, v2, cp)


adam_kernel.launches = 0


@priced("adagrad")
def adagrad_kernel(p, g, h, scalars, adagrad_w):
    """Triton Adagrad on flat CUDA buffers; ``scalars`` is the f32 device
    vector (lr, eps, wd, grad_scale). Returns (p', h')."""
    n = _arena.check_buffers(p, g, h, dtypes=_FLOATS)
    _build.check_operands(p, scalars)
    if scalars.shape != (4,) or scalars.dtype != torch.float32:
        raise ValueError("Adagrad takes 4 f32 scalars")
    p2, h2 = torch.empty_like(p), torch.empty_like(h)
    _build.triton_jit(_adagrad_triton)[(n // _BLOCK,)](
        p, g, h, scalars, p2, h2, ADAGRAD_W=bool(adagrad_w), BLOCK=_BLOCK,
        num_warps=4, enable_fp_fusion=False)
    adagrad_kernel.launches += 1
    return p2, h2


adagrad_kernel.launches = 0


@priced("novograd")
def novograd_kernel(p, g, m, vpos, scalars, reg_inside_moment):
    """Triton NovoGrad stage on flat CUDA buffers; ``vpos`` is the f32 norm
    EMA per position, ``scalars`` the f32 device vector (lr, beta1, b3,
    eps, wd, bc1, bc2). Returns (p', m')."""
    n = _arena.check_buffers(p, g, m, vpos, dtypes=_FLOATS)
    _build.check_operands(p, scalars)
    if (vpos.dtype != torch.float32 or scalars.shape != (7,)
            or scalars.dtype != torch.float32):
        raise ValueError("NovoGrad takes an f32 norm buffer and 7 f32 "
                         "scalars")
    p2, m2 = torch.empty_like(p), torch.empty_like(m)
    _build.triton_jit(_novograd_triton)[(n // _BLOCK,)](
        p, g, m, vpos, scalars, p2, m2,
        REG_INSIDE_MOMENT=bool(reg_inside_moment), BLOCK=_BLOCK,
        num_warps=4, enable_fp_fusion=False)
    novograd_kernel.launches += 1
    return p2, m2


novograd_kernel.launches = 0


# --- plain versions (the kernels' arithmetic, in PyTorch) --------------------

@priced("lamb_stage1")
def lamb_stage1_plain(p, g, m, v, scalars, adam_w):
    b1, b2, eps, wd, bc1, bc2, clip, b3 = scalars.unbind(0)
    p = p.float()
    g = g.float() * clip
    if not adam_w:
        g = g + wd * p
    m2 = b1 * m.float() + b3 * g
    v2 = b2 * v.float() + (1.0 - b2) * g * g
    u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
    if adam_w:
        u = u + wd * p
    return u, m2.to(m.dtype), v2.to(v.dtype)


@priced("lamb_stage2")
def lamb_stage2_plain(p, u, ratio, scalars, copy_dtype=None):
    p32 = p.float() - scalars[0] * ratio * u
    if copy_dtype is None:
        return p32.to(p.dtype)
    return p32.to(p.dtype), p32.to(copy_dtype)


@priced("sgd")
def sgd_plain(p, g, m, scalars, nesterov, wd_after_momentum,
              copy_dtype=None):
    lr, momentum, dampening, wd, gscale, first = scalars.unbind(0)
    p32 = p.float()
    g = g.float() * gscale
    if not wd_after_momentum:
        g = g + wd * p32
    m2 = torch.where(first > 0.5, g,
                     momentum * m.float() + (1.0 - dampening) * g)
    upd = g + momentum * m2 if nesterov else m2
    if wd_after_momentum:
        upd = upd + wd * p32
    p32 = p32 - lr * upd
    out = (p32.to(p.dtype), m2.to(m.dtype))
    return out if copy_dtype is None else out + (p32.to(copy_dtype),)


@priced("adam")
def adam_plain(p, g, m, v, scalars, adam_w, copy_dtype=None):
    lr, b1, b2, eps, wd, bc1, bc2, gscale = scalars.unbind(0)
    p32 = p.float()
    g = g.float() * gscale
    if not adam_w:
        g = g + wd * p32
    m2 = b1 * m.float() + (1.0 - b1) * g
    v2 = b2 * v.float() + (1.0 - b2) * g * g
    upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
    if adam_w:
        upd = upd + wd * p32
    p32 = p32 - lr * upd
    out = (p32.to(p.dtype), m2.to(m.dtype), v2.to(v.dtype))
    return out if copy_dtype is None else out + (p32.to(copy_dtype),)


@priced("adagrad")
def adagrad_plain(p, g, h, scalars, adagrad_w):
    lr, eps, wd, gscale = scalars.unbind(0)
    p32 = p.float()
    g = g.float() * gscale
    if not adagrad_w:
        g = g + wd * p32
    h2 = h.float() + g * g
    upd = g / (torch.sqrt(h2) + eps)
    if adagrad_w:
        upd = upd + wd * p32
    return (p32 - lr * upd).to(p.dtype), h2.to(h.dtype)


@priced("novograd")
def novograd_plain(p, g, m, vpos, scalars, reg_inside_moment):
    lr, b1, b3, eps, wd, bc1, bc2 = scalars.unbind(0)
    p32 = p.float()
    g = g.float()
    denom = vpos / bc2 + eps
    if reg_inside_moment:
        g = g / denom + wd * p32
        m2 = b1 * m.float() + b3 * g
        p32 = p32 - lr * (m2 / bc1)
    else:
        m2 = b1 * m.float() + b3 * g
        p32 = p32 - lr * ((m2 / bc1) / denom + wd * p32)
    return p32.to(p.dtype), m2.to(m.dtype)


# --- public functions, with the JAX package's signatures -----------------------

def bias_corrections(beta1, beta2, step, enabled, device, sqrt2=False):
    """Adam's bias corrections 1 − β^step, computed on the device from the
    step count (a Python int or a device tensor, never read back); with
    ``sqrt2`` the second is √(1 − β2^step), NovoGrad's correction of a
    norm."""
    if not enabled:
        return 1.0, 1.0
    step = torch.as_tensor(step, device=device).float()
    bc1, bc2 = (1.0 - torch.pow(torch.full((), b, dtype=torch.float32,
                                           device=device), step)
                for b in (beta1, beta2))
    return bc1, (torch.sqrt(bc2) if sqrt2 else bc2)


def lamb_stage1(p, g, m, v, *, beta1, beta2, eps, weight_decay, step,
                bias_correction=True, adam_w_mode=True, clip_scale=1.0,
                grad_averaging=True):
    """Stage 1: the update direction ``u`` (f32) and new m, v.

    ``clip_scale`` pre-scales the grads (``max_grad_norm / global norm``
    when clipping is on); ``grad_averaging=False`` accumulates raw grads
    into the first moment (``m = β1·m + g``). ``step``, ``clip_scale`` may
    be device tensors; they are not read back to the host.
    """
    _arena.check_length(p, g, m, v)
    dev = p.device
    bc1, bc2 = bias_corrections(beta1, beta2, step, bias_correction, dev)
    b3 = (1.0 - beta1) if grad_averaging else 1.0
    scalars = _arena.device_scalars(
        (beta1, beta2, eps, weight_decay, bc1, bc2, clip_scale, b3), dev)
    stage1 = lamb_stage1_kernel if p.is_cuda else lamb_stage1_plain
    return stage1(p, g, m, v, scalars, adam_w_mode)


def lamb_stage2(p, u, ratio_per_pos, *, lr, param_copy_dtype=None):
    """Stage 2: ``p -= lr * ratio * u`` with the trust ratio given per
    arena position; with ``param_copy_dtype`` also returns the new p in
    that dtype, written in the same pass."""
    _arena.check_length(p, u, ratio_per_pos)
    scalars = _arena.device_scalars((lr,), p.device)
    stage2 = lamb_stage2_kernel if p.is_cuda else lamb_stage2_plain
    return stage2(p, u, ratio_per_pos, scalars, param_copy_dtype)


def sgd_update(p, g, m, *, lr, momentum=0.0, dampening=0.0, weight_decay=0.0,
               nesterov=False, first_run=False, wd_after_momentum=False,
               grad_scale=1.0, param_copy_dtype=None):
    """Fused SGD with momentum over one flat partition. ``first_run``
    (a bool or a device flag) sets the momentum buffer to the gradient,
    as PyTorch's SGD does on its first step; ``lr`` and ``first_run`` may
    be device tensors, which are not read back to the host. Returns
    (p, m), or (p, m, p_copy) with ``param_copy_dtype``."""
    _arena.check_length(p, g, m)
    scalars = _arena.device_scalars(
        (lr, momentum, dampening, weight_decay, grad_scale, first_run),
        p.device)
    sgd = sgd_kernel if p.is_cuda else sgd_plain
    return sgd(p, g, m, scalars, nesterov, wd_after_momentum,
               param_copy_dtype)


def adam_update(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay, step,
                adam_w_mode=True, bias_correction=True, grad_scale=1.0,
                param_copy_dtype=None):
    """One fused Adam/AdamW step over a flat partition. ``step`` is the
    1-based count after the increment; it, ``lr`` and ``grad_scale`` may
    be device tensors, which are not read back to the host. Returns
    (p, m, v), or (p, m, v, p_copy) with ``param_copy_dtype``."""
    _arena.check_length(p, g, m, v)
    dev = p.device
    bc1, bc2 = bias_corrections(beta1, beta2, step, bias_correction, dev)
    scalars = _arena.device_scalars(
        (lr, beta1, beta2, eps, weight_decay, bc1, bc2, grad_scale), dev)
    adam = adam_kernel if p.is_cuda else adam_plain
    return adam(p, g, m, v, scalars, adam_w_mode, param_copy_dtype)


def adagrad_update(p, g, h, *, lr, eps=1e-10, weight_decay=0.0,
                   adagrad_w_mode=False, grad_scale=1.0):
    """One fused Adagrad step over a flat partition: h += g², p −= lr·g/(√h
    + eps), the weight decay folded into g (or decoupled, W mode); ``lr``
    and ``grad_scale`` may be device tensors. Returns (p, h)."""
    _arena.check_length(p, g, h)
    scalars = _arena.device_scalars((lr, eps, weight_decay, grad_scale),
                                    p.device)
    adagrad = adagrad_kernel if p.is_cuda else adagrad_plain
    return adagrad(p, g, h, scalars, adagrad_w_mode)


def novograd_update(p, g, m, vnorm_per_pos, *, lr, beta1, beta2, eps,
                    weight_decay, step, grad_averaging=True,
                    bias_correction=True, reg_inside_moment=False):
    """NovoGrad's elementwise stage over a flat partition. The per-tensor
    norm EMAs are kept outside and come in per position
    (``vnorm_per_pos``, f32); bc2 = √(1 − β2^step) corrects a norm.
    ``step`` (after the increment) and ``lr`` may be device tensors,
    never read back. Returns (p, m)."""
    _arena.check_length(p, g, m, vnorm_per_pos)
    dev = p.device
    bc1, bc2 = bias_corrections(beta1, beta2, step, bias_correction, dev,
                                sqrt2=True)
    b3 = (1.0 - beta1) if grad_averaging else 1.0
    scalars = _arena.device_scalars(
        (lr, beta1, b3, eps, weight_decay, bc1, bc2), dev)
    novograd = novograd_kernel if p.is_cuda else novograd_plain
    return novograd(p, g, m, vnorm_per_pos, scalars, reg_inside_moment)
