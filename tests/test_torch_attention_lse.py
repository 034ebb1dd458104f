"""flash_attention_lse and the MHA modules against the JAX package.

- ``flash_attention_lse`` with an lse cotangent (folded into delta): with a
  learned head bias (its gradient takes the shifted delta too), with a
  causal offset, and with dropout and dropout block offsets at S = 512
  (one 512 block, offsets in its units).
- ``SelfMultiheadAttn`` (dropout, causal, an additive bias, a head dim of
  32 that the JAX package runs on its (B·H, S, D) kernels) and
  ``EncdecMultiheadAttn`` (packed ``kv_proj``, Sq != Sk, a padding bias,
  dropout), with weights carried over by ``params_from_jax``. Both
  packages' ``_softmax_dropout`` are replaced inside the test to hand out
  the same int32 seed.

Inputs from numpy seeds; the JAX side runs its Pallas kernels in
interpret mode; atol 2e-5 in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.ops.multihead_attn as JMHA
import apex_tpu_torch.ops.multihead_attn as TMHA
from apex_tpu.ops import attention as JA
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.ops import attention as TA

ATOL = 2e-5


@pytest.mark.parametrize("case", [
    dict(s=48, bias=True),
    dict(s=48, causal=True, causal_offset=3),
    dict(s=512, dropout_rate=0.1, dropout_seed=-99, dropout_block_offset=(1, 2)),
], ids=["head_bias", "causal_offset", "dropout_block_offset"])
def test_lse_with_cotangent_matches_jax(case):
    case = dict(case)
    s, with_bias = case.pop("s"), case.pop("bias", False)
    rng = np.random.RandomState(5)
    q, k, v, do = (rng.randn(1, s, 2, 64).astype(np.float32)
                   for _ in range(4))
    dlse = rng.randn(1, 2, s).astype(np.float32)
    bias = rng.randn(1, 2, s, s).astype(np.float32) if with_bias else None
    n = 4 if with_bias else 3

    def jloss(*a):
        o, lse = JA.flash_attention_lse(*a[:3], a[3] if with_bias else None,
                                        **case)
        return jnp.sum(o * do) + jnp.sum(lse * dlse)

    jargs = [jnp.asarray(t) for t in (q, k, v)] + ([jnp.asarray(bias)]
                                                   if with_bias else [])
    jo, jlse = JA.flash_attention_lse(*jargs[:3], jargs[3] if with_bias
                                      else None, **case)
    jgrads = jax.grad(jloss, argnums=tuple(range(n)))(*jargs)

    targs = [torch.tensor(t).requires_grad_(True) for t in (q, k, v)]
    if with_bias:
        targs.append(torch.tensor(bias).requires_grad_(True))
    to, tlse = TA.flash_attention_lse(*targs[:3], targs[3] if with_bias
                                      else None, **case)
    ((to * torch.tensor(do)).sum()
     + (tlse * torch.tensor(dlse)).sum()).backward()
    for name, got, want in zip(("o", "lse", "dq", "dk", "dv", "dbias"),
                               [to, tlse] + [t.grad for t in targs],
                               [jo, jlse, *jgrads]):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0, err_msg=name)


def _same_seed(monkeypatch, seed):
    def jax_seed(mod, rate, deterministic):
        return (0.0, None) if rate <= 0 or deterministic else (
            rate, jnp.int32(seed))

    def torch_seed(rate, deterministic, generator, device):
        return (0.0, None) if rate <= 0 or deterministic else (
            rate, torch.tensor([seed], dtype=torch.int32, device=device))

    monkeypatch.setattr(JMHA, "_softmax_dropout", jax_seed)
    monkeypatch.setattr(TMHA, "_softmax_dropout", torch_seed)


def _check_module(jm, tm, args, kwargs, tkwargs):
    """Output and input gradients of the flax and the port module on the
    same numpy inputs, the port with the flax params."""
    jargs = [jnp.asarray(a) for a in args]
    params = jm.init(jax.random.PRNGKey(0), *jargs)["params"]
    tm.load_state_dict(params_from_jax(params, device="cpu"))
    assert set(params_from_jax(params, device="cpu")) == set(tm.state_dict())
    dy = np.random.RandomState(9).randn(
        *jm.apply({"params": params}, *jargs, **kwargs).shape).astype(
            np.float32)

    def jloss(*a):
        return jnp.sum(jm.apply({"params": params}, *a, **kwargs) * dy)

    jy = jm.apply({"params": params}, *jargs, **kwargs)
    jgrads = jax.grad(jloss, argnums=tuple(range(len(args))))(*jargs)
    targs = [torch.tensor(a).requires_grad_(True) for a in args]
    ty = tm(*targs, **tkwargs)
    (ty * torch.tensor(dy)).sum().backward()
    for got, want in [(ty, jy)] + [(t.grad, g)
                                   for t, g in zip(targs, jgrads)]:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("hidden,heads,causal,dropout,bias", [
    (128, 2, False, 0.1, False),
    (128, 2, True, 0.1, False),
    (128, 2, True, 0.0, True),
    (96, 3, True, 0.1, True),
], ids=["dropout", "causal_dropout", "causal_bias", "d32_h3_all"])
def test_self_multihead_attn_dropout_causal_match_jax(
        monkeypatch, hidden, heads, causal, dropout, bias):
    from apex_tpu.ops.multihead_attn import SelfMultiheadAttn as JM

    _same_seed(monkeypatch, -424242)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 32, hidden).astype(np.float32)
    kw = dict(causal=causal, deterministic=False)
    tkw = dict(kw)
    if bias:
        b = rng.randn(1, heads, 32, 32).astype(np.float32)
        kw["attn_bias"], tkw["attn_bias"] = jnp.asarray(b), torch.tensor(b)
    _check_module(JM(hidden, heads, dropout=dropout),
                  TMHA.SelfMultiheadAttn(hidden, heads, dropout=dropout,
                                         device="cpu"), [x], kw, tkw)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_encdec_multihead_attn_matches_jax(monkeypatch, dropout):
    from apex_tpu.ops.multihead_attn import EncdecMultiheadAttn as JE

    _same_seed(monkeypatch, 31337)
    rng = np.random.RandomState(4)
    query = rng.randn(2, 24, 128).astype(np.float32)
    key = rng.randn(2, 40, 128).astype(np.float32)
    pad = np.zeros((2, 1, 1, 40), np.float32)
    pad[1, ..., 30:] = -1e9
    kw = dict(attn_bias=jnp.asarray(pad), deterministic=False)
    tkw = dict(attn_bias=torch.tensor(pad), deterministic=False)
    _check_module(JE(128, 2, dropout=dropout),
                  TMHA.EncdecMultiheadAttn(128, 2, dropout=dropout,
                                           device="cpu"),
                  [query, key], kw, tkw)


def test_softmax_dropout_draws_int32_seeds_from_the_generator():
    g = torch.Generator("cpu").manual_seed(0)
    rate, seed = TMHA._softmax_dropout(0.1, False, g, torch.device("cpu"))
    assert rate == 0.1 and seed.dtype == torch.int32 and seed.shape == (1,)
    g2 = torch.Generator("cpu").manual_seed(0)
    assert torch.equal(TMHA._softmax_dropout(0.1, False, g2, "cpu")[1], seed)
    assert TMHA._softmax_dropout(0.1, True, g, "cpu") == (0.0, None)
    assert TMHA._softmax_dropout(0.0, False, g, "cpu") == (0.0, None)
    with pytest.raises(ValueError, match="Generator"):
        TMHA._softmax_dropout(0.1, False, None, "cpu")
