"""The LAMB update over the flat arena: two Triton kernels.

Port of ``apex_tpu/ops/optim_kernels.py``'s LAMB pair. Kernels replaced:

- ``lamb_stage1_kernel`` ← ``_lamb_stage1_kernel``: the clipped grad's new
  moments m, v and the update direction u = m̂/(√v̂ + eps) (+ wd·p), f32.
- ``lamb_stage2_kernel`` ← ``_lamb_stage2_kernel``: p −= lr·r·u with the
  trust ratio r given per position, and an optional low-precision copy
  of the new p written in the same pass.

What bounds them on an H100: bytes. Each is one streaming pass with a
few flops per element and no reuse: stage 1 reads p, g, m, v and writes
u, m, v (28N bytes for an f32 partition of N elements), stage 2 reads p,
u, r and writes p (16N). Design: one program per 1024-element block of
the buffer (whose length is a multiple of 65536, so no block needs a
mask), offsets in int64, all math in f32 whatever p's dtype, and the
runtime scalars (betas, eps, wd, bias corrections, clip factor, β3, lr)
loaded from one f32 device tensor, so that a step count, a global norm or
a scheduled lr never leaves the device. The algorithm flags (AdamW mode,
the copy-out) are ``tl.constexpr``: each combination compiles its own
kernel, as the JAX package specialises its Pallas kernels. Divisions and
roots round as IEEE (``div_rn``, ``sqrt_rn``), as the plain versions do.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import _arena, _build

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
                        BLOCK: "tl.constexpr"):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    lr = tl.load(S)
    p = tl.load(P + offs).to(tl.float32)
    u = tl.load(U + offs)
    r = tl.load(R + offs)
    p = p - lr * r * u
    tl.store(PO + offs, p.to(PO.dtype.element_ty))
    if HAS_COPY:
        tl.store(CP + offs, p.to(CP.dtype.element_ty))


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
        p, u, ratio, scalars, p2, p2 if cp is None else cp,
        HAS_COPY=cp is not None, BLOCK=_BLOCK, num_warps=4)
    lamb_stage2_kernel.launches += 1
    return p2 if cp is None else (p2, cp)


lamb_stage2_kernel.launches = 0


# --- plain versions (the kernels' arithmetic, in PyTorch) --------------------

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


def lamb_stage2_plain(p, u, ratio, scalars, copy_dtype=None):
    p32 = p.float() - scalars[0] * ratio * u
    if copy_dtype is None:
        return p32.to(p.dtype)
    return p32.to(p.dtype), p32.to(copy_dtype)


# --- public functions, with the JAX package's signatures -----------------------

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
    if bias_correction:
        step = torch.as_tensor(step, device=dev).float()
        bc1 = 1.0 - torch.pow(torch.full((), beta1, dtype=torch.float32,
                                         device=dev), step)
        bc2 = 1.0 - torch.pow(torch.full((), beta2, dtype=torch.float32,
                                         device=dev), step)
    else:
        bc1 = bc2 = 1.0
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
