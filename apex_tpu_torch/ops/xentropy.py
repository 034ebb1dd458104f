"""Fused label-smoothing softmax cross-entropy: Triton forward and backward.

Port of ``apex_tpu/ops/xentropy.py``. Kernels replaced:

- ``xentropy_fwd_kernel`` ← ``_fwd_kernel`` (``_fwd_call``'s pallas_call):
  loss_i = lse_i − (1−ε)·x_i[y_i] − (ε/V)·Σ_j x_ij, saving only lse (f32).
- ``xentropy_bwd_kernel`` ← ``_bwd_kernel`` (``_bwd_call``):
  dx_ij = g_i·(exp(x_ij − lse_i) − (1−ε)·1[j=y_i] − ε/V), in the logits
  dtype.

Rows whose label is negative give zero loss and zero gradient. Only a
label in [0, V) names a column: a label >= V matches none, as in the JAX
package (its one-hot compares the label with every column), so such a row's
loss is lse − (ε/V)·Σ_j x_ij and its gradient g·(softmax − ε/V).

What bounds them on an H100: bytes. At the BERT shape the logits are
(8192, 30522) bf16, 500 MB: the forward reads them once, the backward
reads them once and writes their gradient once, with a handful of flops
per element. Design: one program per row walks the 30522-wide vocab in
power-of-two chunks with a per-lane online max and sum, so each logit is
read once per pass and the ragged tail is a masked load; the logits are
never padded, upcast or copied.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import _build, autotune
from apex_tpu_torch.ops._priced import priced

tl = None  # triton.language, bound by _build.triton_jit at the first launch

#: the vocab chunk a program's loop takes (``BLOCK``) and the warps of a
#: program, unless the tuning DB has the shape (``autotune``, family
#: ``xentropy``)
_CHUNK = autotune.DEFAULTS["xentropy"]["BLOCK"]
_WARPS = autotune.DEFAULTS["xentropy"]["num_warps"]


def _knobs(x2):
    k = autotune.launch_knobs("xentropy", tuple(x2.shape), x2.dtype)
    return k.get("BLOCK", _CHUNK), k.get("num_warps", _WARPS)


def _ce_fwd_triton(X, LAB, LOSS, LSE, V, stride, smoothing,
                   SMOOTH: "tl.constexpr", BLOCK: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    base = X + row * stride
    cols = tl.arange(0, BLOCK)
    m_vec = tl.full([BLOCK], float("-inf"), tl.float32)
    s_vec = tl.zeros([BLOCK], dtype=tl.float32)
    sx_vec = tl.zeros([BLOCK], dtype=tl.float32)
    for start in range(0, V, BLOCK):
        mask = start + cols < V
        x = tl.load(base + start + cols, mask=mask,
                    other=float("-inf")).to(tl.float32)
        m_new = tl.maximum(m_vec, x)
        live = m_new > float("-inf")
        alpha = tl.where(live, tl.exp(m_vec - m_new), 0.0)
        p = tl.where(live, tl.exp(x - m_new), 0.0)
        s_vec = s_vec * alpha + p
        m_vec = m_new
        if SMOOTH:
            sx_vec += tl.where(mask, x, 0.0)
    m = tl.max(m_vec, axis=0)
    s = tl.sum(tl.where(m_vec > float("-inf"), s_vec * tl.exp(m_vec - m), 0.0),
               axis=0)
    lse = m + tl.log(s)
    label = tl.load(LAB + row)
    valid = label >= 0
    hit = valid & (label < V)
    x_label = tl.load(base + tl.where(hit, label, 0), mask=hit,
                      other=0.0).to(tl.float32)
    loss = lse - (1.0 - smoothing) * x_label
    if SMOOTH:
        loss = loss - (smoothing / V) * tl.sum(sx_vec, axis=0)
    tl.store(LOSS + row, tl.where(valid, loss, 0.0))
    tl.store(LSE + row, lse)


def _ce_bwd_triton(X, LAB, LSE, G, DX, V, stride, smoothing,
                   SMOOTH: "tl.constexpr", BLOCK: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    label = tl.load(LAB + row)
    lse = tl.load(LSE + row)
    g = tl.where(label >= 0, tl.load(G + row), 0.0)
    for start in range(0, V, BLOCK):
        c = start + cols
        mask = c < V
        x = tl.load(X + row * stride + c, mask=mask, other=0.0).to(tl.float32)
        target = tl.where(c == label, 1.0 - smoothing, 0.0)
        if SMOOTH:
            target += smoothing / V
        dx = g * (tl.exp(x - lse) - target)
        tl.store(DX + row * stride + c, dx.to(DX.dtype.element_ty), mask=mask)


def _check(x2, labels, *f32):
    """(N, V) float logits, (N,) int labels, and f32 (N,) row vectors."""
    _build.check_operands(x2, labels, *f32)
    if (x2.dim() != 2 or labels.shape != (x2.shape[0],)
            or any(t.shape != labels.shape for t in f32)):
        raise ValueError(f"expected (N, V) logits and (N,) labels/rows, got "
                         f"{tuple(x2.shape)} and {tuple(labels.shape)}")
    if (x2.dtype not in (torch.float32, torch.bfloat16, torch.float16)
            or labels.dtype not in (torch.int32, torch.int64)
            or any(t.dtype != torch.float32 for t in f32)):
        raise ValueError(f"unsupported dtypes: logits {x2.dtype}, labels "
                         f"{labels.dtype}")


@priced("xentropy_fwd")
def xentropy_fwd_kernel(x2, labels, smoothing):
    """Triton forward on contiguous (N, V) logits and (N,) int labels:
    returns (loss f32 (N,), lse f32 (N,))."""
    _check(x2, labels)
    n, v = x2.shape
    loss = torch.empty(n, dtype=torch.float32, device=x2.device)
    lse = torch.empty(n, dtype=torch.float32, device=x2.device)
    block, warps = _knobs(x2)
    _build.triton_jit(_ce_fwd_triton)[(n,)](
        x2, labels, loss, lse, v, v, float(smoothing),
        SMOOTH=bool(smoothing), BLOCK=block, num_warps=warps)
    xentropy_fwd_kernel.launches += 1
    return loss, lse


xentropy_fwd_kernel.launches = 0


@priced("xentropy_bwd")
def xentropy_bwd_kernel(x2, labels, lse, g, smoothing):
    """Triton backward: dx in the logits dtype."""
    _check(x2, labels, lse, g)
    n, v = x2.shape
    dx = torch.empty_like(x2)
    block, warps = _knobs(x2)
    _build.triton_jit(_ce_bwd_triton)[(n,)](
        x2, labels, lse, g, dx, v, v, float(smoothing),
        SMOOTH=bool(smoothing), BLOCK=block, num_warps=warps)
    xentropy_bwd_kernel.launches += 1
    return dx


xentropy_bwd_kernel.launches = 0


# --- plain versions -----------------------------------------------------------

def _hit(labels, v):
    """Rows whose label names a column: 0 <= label < v."""
    return (labels >= 0) & (labels < v)


@priced("xentropy_fwd")
def xentropy_fwd_plain(x2, labels, smoothing):
    x = x2.float()
    v = x.shape[1]
    lse = torch.logsumexp(x, dim=1)
    valid = labels >= 0
    hit = _hit(labels, v)
    x_label = torch.where(
        hit, x.gather(1, torch.where(hit, labels, 0)[:, None])[:, 0], 0.0)
    loss = lse - (1.0 - smoothing) * x_label
    if smoothing:
        loss = loss - (smoothing / v) * x.sum(dim=1)
    return torch.where(valid, loss, 0.0), lse


@priced("xentropy_bwd")
def xentropy_bwd_plain(x2, labels, lse, g, smoothing):
    x = x2.float()
    v = x.shape[1]
    target = torch.zeros_like(x)
    valid = labels >= 0
    hit = _hit(labels, v)
    target.scatter_(1, torch.where(hit, labels, 0)[:, None],
                    torch.where(hit, 1.0 - smoothing, 0.0)[:, None])
    if smoothing:
        target = target + smoothing / v
    g = torch.where(valid, g.float(), 0.0)
    dx = g[:, None] * (torch.exp(x - lse[:, None]) - target)
    return dx.to(x2.dtype)


class _SoftmaxXentFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, smoothing):
        x2 = logits.reshape(-1, logits.shape[-1]).contiguous()
        lab = labels.reshape(-1).contiguous()
        if x2.is_cuda:
            loss, lse = xentropy_fwd_kernel(x2, lab, smoothing)
        else:
            loss, lse = xentropy_fwd_plain(x2, lab, smoothing)
        ctx.save_for_backward(x2, lab, lse)
        ctx.smoothing = smoothing
        ctx.shape = logits.shape
        return loss.reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        x2, lab, lse = ctx.saved_tensors
        g = g.reshape(-1).float().contiguous()
        if x2.is_cuda:
            dx = xentropy_bwd_kernel(x2, lab, lse, g, ctx.smoothing)
        else:
            dx = xentropy_bwd_plain(x2, lab, lse, g, ctx.smoothing)
        return dx.reshape(ctx.shape), None, None


def softmax_cross_entropy_loss(logits, labels, smoothing=0.0):
    """Per-example losses (f32), fused. ``logits`` (..., V), int
    ``labels`` (...); rows with negative labels give zero loss/grad, and a
    label >= V matches no column."""
    return _SoftmaxXentFn.apply(logits, labels, smoothing)


def softmax_cross_entropy_reference(logits, labels, smoothing=0.0):
    """Plain-PyTorch oracle."""
    x = logits.float()
    v = x.shape[-1]
    lse = torch.logsumexp(x, dim=-1)
    hit = _hit(labels, v)
    x_label = torch.where(hit, torch.gather(
        x, -1, torch.where(hit, labels, 0)[..., None])[..., 0], 0.0)
    loss = lse - (1 - smoothing) * x_label - smoothing / v * x.sum(dim=-1)
    return torch.where(labels >= 0, loss, 0.0)
