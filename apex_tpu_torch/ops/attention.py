"""Flash attention: CUDA C++ forward and backward with a custom autograd.

Port of ``apex_tpu/ops/attention.py`` at its public (B, S, H, D) layout.
Kernels replaced (sources under ``apex_tpu_torch/csrc/``):

- ``flash_fwd_kernel`` (``flash_attn_fwd.cu``) ← ``_fwd_kernel_nl``
  (``_flash_fwd_nl``'s pallas_call): online-softmax attention giving o and
  lse (f32, (B·H, S)), with P cast to v's dtype before PV.
- ``flash_bwd_kernel`` (``flash_attn_bwd.cu``) ← ``_bwd_fused_kernel_nl``
  and the split ``_bwd_dq_kernel_nl``/``_bwd_dkv_kernel_nl``: a dk/dv kernel
  per k tile looping over q tiles and a dq kernel per q tile looping over
  k tiles, both recomputing P from lse; no atomics, so the result is
  deterministic. ``delta = Σ do·o`` is plain PyTorch, as the JAX package
  computes it in jnp.

This slice's kernels do non-causal attention with no bias and no dropout,
which is all the BERT path calls; ``bias``, ``causal`` and ``dropout_rate
> 0`` raise on a CUDA tensor. The plain version supports bias and causal.
"""

from __future__ import annotations

import ctypes
import math

import torch

from apex_tpu_torch.ops import _build

NEG_INF = -1e30

_UNPORTED = ("flash_attention {} is not ported to the CUDA kernels yet "
             "(ROADMAP.md queue B: attention bias/causal/dropout)")

_DTYPES = {torch.bfloat16: 0, torch.float16: 1}
_HEAD_DIMS = (64,)


def _check_kernel_operands(q, k, v):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernels take bf16/fp16 q, k, v; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError("flash kernels take self-attention shapes "
                         f"(q {tuple(q.shape)}, k {tuple(k.shape)})")
    b, s, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernels take head dims {_HEAD_DIMS}, got {d}")
    if b * h >= 65536:
        raise ValueError("flash kernels take B·H < 65536")
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("q, k, v must share one CUDA device")
        # rows of each head are D contiguous elements, 16-byte aligned
        if (t.stride(3) != 1 or t.stride(2) != d or t.stride(1) % 8
                or t.stride(0) % 8 or t.data_ptr() % 16):
            raise ValueError("flash kernels take (B, S, H, D) tensors whose "
                             "head rows are contiguous and 16-byte aligned")


def _lib(name, n_ptrs, n_stride_pairs):
    """The C entry point ``apex_<name>``: (dtype, D, pointers..., B, S, H,
    (batch stride, row stride) per tensor..., scale, stream) -> error."""
    fn = getattr(_build.load(name), f"apex_{name}")
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([I, I] + [P] * n_ptrs + [I, I, I]
                       + [L, L] * n_stride_pairs + [ctypes.c_float, P])
        fn.restype = I
    return fn


def flash_fwd_kernel(q, k, v, scale):
    """CUDA forward: (o (B, S, H, D) in q's dtype, lse f32 (B·H, S))."""
    _check_kernel_operands(q, k, v)
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    err = _lib("flash_attn_fwd", 5, 4)(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, s, h,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), o.stride(0), o.stride(1),
        float(scale), _build.stream_ptr(q))
    _build.check(err, "flash_attn_fwd")
    flash_fwd_kernel.launches += 1
    return o, lse


flash_fwd_kernel.launches = 0


def flash_bwd_kernel(q, k, v, do, lse, delta, scale):
    """CUDA backward (dk/dv kernel, then dq kernel): (dq, dk, dv)."""
    _check_kernel_operands(q, k, v)
    b, s, h, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError("do must be a contiguous tensor like q")
    for t in (lse, delta):
        if (t.dtype != torch.float32 or t.shape != (b * h, s)
                or not t.is_contiguous()):
            raise ValueError("lse/delta must be contiguous f32 (B·H, S)")
    dq, dk, dv = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    err = _lib("flash_attn_bwd", 9, 5)(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, s, h,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), do.stride(0), do.stride(1),
        dq.stride(0), dq.stride(1), float(scale), _build.stream_ptr(q))
    _build.check(err, "flash_attn_bwd")
    flash_bwd_kernel.launches += 1
    return dq, dk, dv


flash_bwd_kernel.launches = 0


# --- plain versions (the kernels' arithmetic, in PyTorch) --------------------

def flash_fwd_plain(q, k, v, scale):
    b, s, h, d = q.shape
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l)).reshape(b * h, s)
    return o.transpose(1, 2).to(q.dtype), lse


def flash_bwd_plain(q, k, v, do, lse, delta, scale):
    b, s, h, d = q.shape
    q32, k32 = q.float(), k.float()
    sc = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    p = torch.exp(sc - lse.reshape(b, h, s, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta.reshape(b, h, s, 1))).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.is_cuda:
            o, lse = flash_fwd_kernel(q, k, v, scale)
        else:
            o, lse = flash_fwd_plain(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        b, s, h, _ = q.shape
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)          # (B, S, H)
        delta = delta.transpose(1, 2).reshape(b * h, s).contiguous()
        if q.is_cuda:
            dq, dk, dv = flash_bwd_kernel(q, k, v, do, lse, delta, ctx.scale)
        else:
            dq, dk, dv = flash_bwd_plain(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, bias=None, scale=None, causal=False,
                    dropout_rate=0.0, dropout_seed=None):
    """Blockwise softmax attention on (B, S, H, D) q/k/v; returns
    (B, S, H, D) in q's dtype.

    ``bias`` (additive, broadcasting against (B, H, Sq, Sk)) and ``causal``
    run only on the plain path (CPU tensors) in this slice.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if dropout_rate > 0.0:
        raise NotImplementedError(_UNPORTED.format("dropout"))
    if bias is not None or causal:
        if q.is_cuda:
            raise NotImplementedError(
                _UNPORTED.format("bias" if bias is not None else "causal"))
        return _attention_reference(q, k, v, bias, scale, causal)
    return _FlashFn.apply(q, k, v, scale)


def attention_reference(q, k, v, bias=None, scale=None, causal=False):
    """Plain-PyTorch oracle in fp32 (the reference's ``impl='default'``)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _attention_reference(q, k, v, bias, scale, causal)


def _attention_reference(q, k, v, bias, scale, causal):
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        sq, sk = s.shape[-2:]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=s.device).tril(diagonal=sk - sq)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)
