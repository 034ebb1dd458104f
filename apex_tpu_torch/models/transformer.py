"""BERT-style transformer encoder built on the port's fused ops.

Port of ``apex_tpu/models/transformer.py``: post-LN (or pre-LN) blocks over
:func:`apex_tpu_torch.ops.fused_layer_norm_affine`, attention through
:class:`apex_tpu_torch.ops.SelfMultiheadAttn` and an MLM head over
:func:`apex_tpu_torch.ops.softmax_cross_entropy_loss` with the decoder tied
to the token embedding.

Submodule and parameter names follow the flax auto-naming of the JAX
package (``TransformerLayer_0.MultiheadAttention_0.SelfMultiheadAttn_0.
qkv_proj.weight``, ...), so :func:`apex_tpu_torch.convert.
params_from_jax` maps one tree onto the other name for name. Weights
are drawn from an explicit ``torch.Generator`` by :meth:`BertEncoder.
reset_parameters`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from apex_tpu_torch import ops
from apex_tpu_torch.amp.interceptor import module_cast_dtype
from apex_tpu_torch.models.layers import cast_input


class Dense(nn.Linear):
    """``nn.Linear`` with flax ``nn.Dense``'s compute ``dtype``. Under an
    enabled ``auto_cast`` its input is first cast to the policy's half
    dtype (a HALF module, like flax's ``nn.Dense`` under the interceptor);
    it then computes in ``dtype`` if given, else in that half dtype, else
    in the promoted dtype of its input and weight. Params are f32.

    ``casts``, a dict that the caller keeps across calls (a recurrent
    cell's time loop keeps one for a forward), holds the weight and bias
    cast to each compute dtype: they are cast once, and autograd saves one
    copy for the backward, not one a call. Each call's gradient still
    reaches the f32 param in f32, as when each call casts."""

    def __init__(self, in_features, out_features, bias=True, device="cuda",
                 dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.dtype = dtype

    def forward(self, x, casts: Optional[dict] = None):
        x = cast_input(self, x)
        dt = self.dtype or module_cast_dtype(self) or torch.promote_types(
            x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), _cast(self.weight, dt, casts, "weight"),
                        _cast(self.bias, dt, casts, "bias"))


class _SharedCast(torch.autograd.Function):
    """``half``, the cast of ``param`` made once for many calls, as one
    call's operand: the forward is a view of ``half`` (no copy); the
    backward hands the call's gradient to ``param`` in its dtype, so the
    calls' gradients add up there as the per-call casts' do."""

    @staticmethod
    def forward(ctx, param, half):
        ctx.dtype = param.dtype
        return half.view_as(half)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def _cast(t, dt, casts, key):
    """``t`` in ``dt``; with ``casts``, through the one cast kept there."""
    if t is None or t.dtype == dt or casts is None:
        return None if t is None else t.to(dt)
    if (key, dt) not in casts:
        casts[key, dt] = t.detach().to(dt)
    return _SharedCast.apply(t, casts[key, dt])


class Embed(nn.Embedding):
    """Token embedding; under ``auto_cast`` the looked-up rows come out in
    the half dtype (flax's ``nn.Embed`` casts its table, which gives the
    same values)."""

    def forward(self, tokens):
        out = F.embedding(tokens, self.weight)
        dt = module_cast_dtype(self)
        return out if dt is None else out.to(dt)


class FusedLayerNormModule(nn.Module):
    def __init__(self, features: int, epsilon: float = 1e-5, device="cuda"):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        return ops.fused_layer_norm_affine(x, self.scale, self.bias,
                                           self.epsilon)


class MultiheadAttention(nn.Module):
    """Wrapper over :class:`SelfMultiheadAttn` taking a boolean mask
    (True = attend) instead of an additive bias."""

    def __init__(self, hidden: int, heads: int, dropout: float = 0.0,
                 device="cuda"):
        super().__init__()
        self.SelfMultiheadAttn_0 = ops.SelfMultiheadAttn(
            hidden, heads, dropout=dropout, device=device)

    def forward(self, x, mask=None, deterministic: bool = True,
                generator=None):
        bias = None
        if mask is not None:
            bias = torch.where(mask, 0.0, -1e9).float()
        return self.SelfMultiheadAttn_0(x, attn_bias=bias,
                                        deterministic=deterministic,
                                        generator=generator)


class TransformerLayer(nn.Module):
    """A post-LN block (``pre_ln=False``, all BERT uses) or a pre-LN one.
    Both create their submodules in the same order, so they carry the same
    names, as flax's construction-order names are in the JAX package."""

    def __init__(self, hidden: int, heads: int, ffn_hidden: int,
                 dropout: float = 0.0, pre_ln: bool = False, device="cuda"):
        super().__init__()
        self.pre_ln = pre_ln
        self.MultiheadAttention_0 = MultiheadAttention(hidden, heads, dropout,
                                                       device=device)
        self.FusedLayerNormModule_0 = FusedLayerNormModule(hidden,
                                                           device=device)
        self.FusedLayerNormModule_1 = FusedLayerNormModule(hidden,
                                                           device=device)
        self.Dense_0 = Dense(hidden, ffn_hidden, device=device)
        self.Dense_1 = Dense(ffn_hidden, hidden, device=device)

    def forward(self, x, mask=None, deterministic: bool = True,
                generator=None):
        """Dropout acts on the attention probabilities only, as in the JAX
        package's layer."""
        attn, ln1, ln2 = (self.MultiheadAttention_0,
                          self.FusedLayerNormModule_0,
                          self.FusedLayerNormModule_1)
        if self.pre_ln:
            x = x + attn(ln1(x), mask, deterministic, generator)
            return x + self._ffn(ln2(x))
        x = ln1(x + attn(x, mask, deterministic, generator))
        return ln2(x + self._ffn(x))

    def _ffn(self, x):
        # jax.nn.gelu defaults to the tanh approximation
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))


class BertEncoder(nn.Module):
    """BERT-style encoder: embeddings + N post-LN layers."""

    def __init__(self, vocab_size: int, hidden: int = 768, layers: int = 12,
                 heads: int = 12, ffn_hidden: Optional[int] = None,
                 max_len: int = 512, dropout: float = 0.0, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.vocab_size, self.hidden, self.layers = vocab_size, hidden, layers
        self.dropout = dropout
        ffn = ffn_hidden or 4 * hidden
        self.tok_emb = Embed(vocab_size, hidden, device=device)
        self.pos_emb = nn.Parameter(torch.empty(max_len, hidden,
                                                device=device))
        self.FusedLayerNormModule_0 = FusedLayerNormModule(
            hidden, epsilon=1e-12, device=device)
        for i in range(layers):
            self.add_module(f"TransformerLayer_{i}", TransformerLayer(
                hidden, heads, ffn, dropout, device=device))
        self.reset_parameters(torch.Generator(device).manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every weight from ``generator``: flax's default
        initializers' scales (lecun-normal Dense kernels, fan-in normal
        embedding, N(0, 0.02) positions, zero biases, unit LN scales)."""
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            elif name == "pos_emb":
                p.normal_(0.0, 0.02, generator=generator)
            else:   # Linear weights (out, in) and the (vocab, hidden) table
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]),
                          generator=generator)

    def forward(self, tokens, attn_mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """``attn_mask`` (B, S), True where a token is real, becomes the
        additive (B, 1, 1, S) bias; ``deterministic=False`` applies the
        layers' attention dropout with seeds drawn from ``generator``."""
        emb = self.tok_emb(tokens)
        x = emb + self.pos_emb[None, :tokens.shape[1]].to(emb.dtype)
        x = self.FusedLayerNormModule_0(x)
        mask = None
        if attn_mask is not None:
            mask = attn_mask[:, None, None, :].bool()
        for i in range(self.layers):
            x = getattr(self, f"TransformerLayer_{i}")(x, mask, deterministic,
                                                       generator)
        return x


def BertLarge(vocab_size: int = 30522, **kw) -> BertEncoder:
    return BertEncoder(vocab_size, hidden=1024, layers=24, heads=16, **kw)


def mlm_loss(encoder: BertEncoder, params, tokens, labels, smoothing=0.0):
    """Masked-LM loss over the fused softmax-CE (labels < 0 = unmasked).

    ``params`` is a ``{name: tensor}`` dict over the encoder's parameters
    (e.g. ``Amp.model_params(state)``), or None for the module's own.
    """
    if params is None:
        params = dict(encoder.named_parameters())
    hidden = functional_call(encoder, params, (tokens,))
    return _mlm_head(hidden, params["tok_emb.weight"], labels, smoothing)


def _mlm_head(hidden, emb, labels, smoothing=0.0):
    """The MLM loss on encoder output: logits from the tied token table,
    fused CE, mean over the labels >= 0."""
    logits = hidden @ emb.t().to(hidden.dtype)
    losses = ops.softmax_cross_entropy_loss(logits, labels, smoothing)
    n = torch.clamp((labels >= 0).sum(), min=1)
    return losses.sum() / n
