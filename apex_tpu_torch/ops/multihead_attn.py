"""SelfMultiheadAttn: packed-QKV self attention.

Port of ``apex_tpu/ops/multihead_attn.py``'s ``SelfMultiheadAttn``:
one packed QKV projection, attention through
:func:`apex_tpu_torch.ops.attention.flash_attention` (``impl="fast"``), and
an output projection. Inputs and outputs are (B, S, hidden), batch first.
"""

from __future__ import annotations

import torch.nn as nn

from apex_tpu_torch.ops import attention as A

_UNPORTED = ("SelfMultiheadAttn({}) is not ported yet (ROADMAP.md queue A "
             "item 3)")


class SelfMultiheadAttn(nn.Module):
    def __init__(self, hidden: int, heads: int, dropout: float = 0.0,
                 bias: bool = True, include_norm_add: bool = False,
                 separate_qkv_params: bool = False, impl: str = "fast",
                 device="cuda"):
        super().__init__()
        for flag, name in ((include_norm_add, "include_norm_add=True"),
                           (separate_qkv_params, "separate_qkv_params=True"),
                           (impl != "fast", f"impl={impl!r}")):
            if flag:
                raise NotImplementedError(_UNPORTED.format(name))
        from apex_tpu_torch.models.transformer import Dense

        self.hidden, self.heads = hidden, heads
        self.dropout = dropout
        self.qkv_proj = Dense(hidden, 3 * hidden, bias=bias, device=device)
        self.out_proj = Dense(hidden, hidden, bias=bias, device=device)

    def forward(self, x, attn_bias=None, causal: bool = False,
                deterministic: bool = True):
        b, s, h = x.shape
        nh = self.heads
        q, k, v = self.qkv_proj(x).split(h, dim=-1)
        q, k, v = (t.reshape(b, s, nh, h // nh) for t in (q, k, v))
        ctx = A.flash_attention(q, k, v, bias=attn_bias, causal=causal,
                                dropout_rate=0.0 if deterministic
                                else self.dropout)
        return self.out_proj(ctx.reshape(b, s, h))
