"""SelfMultiheadAttn / EncdecMultiheadAttn: packed QKV / KV attention.

Port of ``apex_tpu/ops/multihead_attn.py``'s modules at ``impl="fast"``:
packed projections, attention through
:func:`apex_tpu_torch.ops.attention.flash_attention` (additive bias, causal
masking, softmax dropout inside the kernels), and an output projection.
Inputs and outputs are (B, S, hidden), batch first.

The dropout seed is one int32 per call, drawn on the tensors' device from
an explicit ``torch.Generator`` (the JAX package draws it from the
module's ``'dropout'`` rng stream), so a step needs no host sync for it.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from apex_tpu_torch.ops import attention as A

_UNPORTED = ("{}({}) is not ported yet (ROADMAP.md queue A item 3)")


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


def _refuse(cls, include_norm_add=False, separate_qkv_params=False,
            impl="fast"):
    for flag, name in ((include_norm_add, "include_norm_add=True"),
                       (separate_qkv_params, "separate_qkv_params=True"),
                       (impl != "fast", f"impl={impl!r}")):
        if flag:
            raise NotImplementedError(_UNPORTED.format(cls, name))


class SelfMultiheadAttn(nn.Module):
    def __init__(self, hidden: int, heads: int, dropout: float = 0.0,
                 bias: bool = True, include_norm_add: bool = False,
                 separate_qkv_params: bool = False, impl: str = "fast",
                 device="cuda"):
        super().__init__()
        _refuse("SelfMultiheadAttn", include_norm_add, separate_qkv_params,
                impl)
        from apex_tpu_torch.models.transformer import Dense

        self.hidden, self.heads = hidden, heads
        self.dropout = dropout
        self.qkv_proj = Dense(hidden, 3 * hidden, bias=bias, device=device)
        self.out_proj = Dense(hidden, hidden, bias=bias, device=device)

    def forward(self, x, attn_bias=None, causal: bool = False,
                deterministic: bool = True, generator=None):
        b, s, h = x.shape
        nh = self.heads
        q, k, v = self.qkv_proj(x).split(h, dim=-1)
        q, k, v = (t.reshape(b, s, nh, h // nh) for t in (q, k, v))
        rate, seed = _softmax_dropout(self.dropout, deterministic, generator,
                                      x.device)
        ctx = A.flash_attention(q, k, v, bias=attn_bias, causal=causal,
                                dropout_rate=rate, dropout_seed=seed)
        return self.out_proj(ctx.reshape(b, s, h))


class EncdecMultiheadAttn(nn.Module):
    """Encoder-decoder attention: q projected from the decoder stream, k and
    v together (``kv_proj``) from the encoder memory; Sq ≠ Sk."""

    def __init__(self, hidden: int, heads: int, dropout: float = 0.0,
                 bias: bool = True, include_norm_add: bool = False,
                 impl: str = "fast", device="cuda"):
        super().__init__()
        _refuse("EncdecMultiheadAttn", include_norm_add, impl=impl)
        from apex_tpu_torch.models.transformer import Dense

        self.hidden, self.heads = hidden, heads
        self.dropout = dropout
        self.q_proj = Dense(hidden, hidden, bias=bias, device=device)
        self.kv_proj = Dense(hidden, 2 * hidden, bias=bias, device=device)
        self.out_proj = Dense(hidden, hidden, bias=bias, device=device)

    def forward(self, query, key, attn_bias=None, deterministic: bool = True,
                generator=None):
        b, sq, h = query.shape
        sk = key.shape[1]
        nh = self.heads
        q = self.q_proj(query).reshape(b, sq, nh, h // nh)
        k, v = self.kv_proj(key).split(h, dim=-1)
        k, v = (t.reshape(b, sk, nh, h // nh) for t in (k, v))
        rate, seed = _softmax_dropout(self.dropout, deterministic, generator,
                                      query.device)
        ctx = A.flash_attention(q, k, v, bias=attn_bias, dropout_rate=rate,
                                dropout_seed=seed)
        return self.out_proj(ctx.reshape(b, sq, h))
