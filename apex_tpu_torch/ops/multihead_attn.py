"""SelfMultiheadAttn / EncdecMultiheadAttn: packed or separate QKV / KV
attention.

Port of ``apex_tpu/ops/multihead_attn.py``'s modules: packed projections
(or ``separate_qkv_params``: ``q_proj``, ``k_proj``, ``v_proj``), attention
through :func:`apex_tpu_torch.ops.attention.flash_attention` at
``impl="fast"`` (additive bias, causal masking, softmax dropout inside the
kernels) or through plain PyTorch einsums at ``impl="default"``, and an
output projection. ``include_norm_add`` puts a LayerNorm (ε 1e-5, its
``ln_scale``/``ln_bias`` f32 params on the module itself, through
:func:`fused_layer_norm_affine`) before the projections and adds the
un-normed input back after the output projection, with output dropout
before the add. Inputs and outputs are (B, S, hidden), batch first.

The fast path's dropout seed is one int32 per call, drawn on the tensors'
device from an explicit ``torch.Generator`` (the JAX package draws it from
the module's ``'dropout'`` rng stream), so a step needs no host sync for
it. The default path's softmax dropout and the norm-add output dropout
draw their keep masks from the same generator (:func:`attention.dropout`):
the JAX package draws those bits from flax's rng, which the port cannot
reproduce.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from apex_tpu_torch.ops import attention as A
from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine

IMPLS = ("fast", "default")


def _softmax_dropout(rate, deterministic, generator, device):
    """(rate, seed) for the fused kernels: 0-rate when not training, else a
    fresh int32 seed, a (1,) tensor on ``device`` drawn from
    ``generator``."""
    if rate <= 0 or deterministic:
        return 0.0, None
    if generator is None:
        raise ValueError("attention dropout needs a torch.Generator when "
                         "deterministic=False")
    seed = torch.randint(-2 ** 31, 2 ** 31, (1,), generator=generator,
                         device=device, dtype=torch.int32)
    return rate, seed


def _dropout_attention(q, k, v, bias, causal, rate, deterministic,
                       generator):
    """``impl="default"`` attention with softmax-probability dropout, the
    JAX package's ``_dropout_attention`` op for op. Unlike
    :func:`attention.attention_reference` it is not run with the O1
    functional patch suspended, as in the JAX package: under O1 the two
    ``torch.einsum`` calls round their operands to the half dtype and the
    softmax runs in f32."""
    d = q.shape[-1]
    # JAX divides by a numpy scalar, which promotes a half s to f32
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()).float() \
        / math.sqrt(d)
    if bias is not None:
        s = s + bias.float()
    if causal:
        sq, sk = s.shape[-2:]
        cmask = torch.ones((sq, sk), dtype=torch.bool,
                           device=s.device).tril(diagonal=sk - sq)
        s = torch.where(cmask, s, A.NEG_INF)
    p = torch.softmax(s, dim=-1)
    if rate > 0 and not deterministic:
        p = A.dropout(p, rate, generator)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _norm_params(module, hidden, device):
    module.ln_scale = nn.Parameter(torch.ones(hidden, device=device))
    module.ln_bias = nn.Parameter(torch.zeros(hidden, device=device))


def _check_impl(impl):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


class _Attn(nn.Module):
    """What the two modules share: the norm, the attention of either impl,
    the output projection and the norm-add's dropout and residual."""

    def _attend(self, q, k, v, attn_bias, causal, deterministic, generator):
        if self.impl == "fast":
            rate, seed = _softmax_dropout(self.dropout, deterministic,
                                          generator, q.device)
            return A.flash_attention(q, k, v, bias=attn_bias, causal=causal,
                                     dropout_rate=rate, dropout_seed=seed)
        return _dropout_attention(q, k, v, attn_bias, causal, self.dropout,
                                  deterministic, generator)

    def _norm(self, x):
        if not self.include_norm_add:
            return x
        return fused_layer_norm_affine(x, self.ln_scale, self.ln_bias, 1e-5)

    def _finish(self, ctx, residual, deterministic, generator):
        b, s = ctx.shape[:2]
        out = self.out_proj(ctx.reshape(b, s, self.hidden))
        if self.include_norm_add:
            # output dropout before the residual add, as the reference's
            # norm-add variant (jit_dropout_add)
            if self.dropout > 0 and not deterministic:
                out = A.dropout(out, self.dropout, generator)
            out = out + residual
        return out


class SelfMultiheadAttn(_Attn):
    def __init__(self, hidden: int, heads: int, dropout: float = 0.0,
                 bias: bool = True, include_norm_add: bool = False,
                 separate_qkv_params: bool = False, impl: str = "fast",
                 device="cuda"):
        super().__init__()
        _check_impl(impl)
        from apex_tpu_torch.models.transformer import Dense

        self.hidden, self.heads = hidden, heads
        self.dropout = dropout
        self.include_norm_add = include_norm_add
        self.separate_qkv_params = separate_qkv_params
        self.impl = impl
        if include_norm_add:
            _norm_params(self, hidden, device)
        if separate_qkv_params:
            self.q_proj, self.k_proj, self.v_proj = (
                Dense(hidden, hidden, bias=bias, device=device)
                for _ in range(3))
        else:
            self.qkv_proj = Dense(hidden, 3 * hidden, bias=bias,
                                  device=device)
        self.out_proj = Dense(hidden, hidden, bias=bias, device=device)

    def forward(self, x, attn_bias=None, causal: bool = False,
                deterministic: bool = True, generator=None):
        b, s, h = x.shape
        nh = self.heads
        residual = x
        x = self._norm(x)
        if self.separate_qkv_params:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        else:
            q, k, v = self.qkv_proj(x).split(h, dim=-1)
        q, k, v = (t.reshape(b, s, nh, h // nh) for t in (q, k, v))
        ctx = self._attend(q, k, v, attn_bias, causal, deterministic,
                           generator)
        return self._finish(ctx, residual, deterministic, generator)


class EncdecMultiheadAttn(_Attn):
    """Encoder-decoder attention: q projected from the decoder stream, k and
    v together (``kv_proj``) from the encoder memory; Sq ≠ Sk. The norm-add
    variant normalizes the query stream only, and its residual is the
    un-normed query."""

    def __init__(self, hidden: int, heads: int, dropout: float = 0.0,
                 bias: bool = True, include_norm_add: bool = False,
                 impl: str = "fast", device="cuda"):
        super().__init__()
        _check_impl(impl)
        from apex_tpu_torch.models.transformer import Dense

        self.hidden, self.heads = hidden, heads
        self.dropout = dropout
        self.include_norm_add = include_norm_add
        self.impl = impl
        if include_norm_add:
            _norm_params(self, hidden, device)
        self.q_proj = Dense(hidden, hidden, bias=bias, device=device)
        self.kv_proj = Dense(hidden, 2 * hidden, bias=bias, device=device)
        self.out_proj = Dense(hidden, hidden, bias=bias, device=device)

    def forward(self, query, key, attn_bias=None, deterministic: bool = True,
                generator=None):
        b, sq, h = query.shape
        sk = key.shape[1]
        nh = self.heads
        q = self.q_proj(self._norm(query)).reshape(b, sq, nh, h // nh)
        k, v = self.kv_proj(key).split(h, dim=-1)
        k, v = (t.reshape(b, sk, nh, h // nh) for t in (k, v))
        ctx = self._attend(q, k, v, attn_bias, False, deterministic,
                           generator)
        return self._finish(ctx, query, deterministic, generator)
