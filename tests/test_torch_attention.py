"""Parity of apex_tpu_torch.ops.attention with apex_tpu.ops.attention.

The same numpy q/k/v and output cotangent go through the JAX op (Pallas
kernels in interpret mode on the CPU) and the port on the CPU (its plain
versions). With D=64 and H=2 the JAX side takes the same native-layout
kernels as BERT-Large. o, dq, dk and dv agree at atol 2e-5 in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as JA
from apex_tpu_torch.ops import attention as TA
from apex_tpu_torch.ops import multihead_attn as TM


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("shape", [(2, 64, 2, 64), (2, 200, 2, 64)])
def test_flash_attention_fwd_bwd_match_jax(shape):
    assert JA._native_g0(shape[2], shape[3]) is not None
    q, k, v, do = _inputs(shape)
    jdo = jnp.asarray(do)

    def jloss(q_, k_, v_):
        return jnp.sum(JA.flash_attention(q_, k_, v_) * jdo)

    jargs = tuple(jnp.asarray(t) for t in (q, k, v))
    jo = JA.flash_attention(*jargs)
    jdq, jdk, jdv = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)

    tq, tk, tv = (torch.tensor(t).requires_grad_(True) for t in (q, k, v))
    to = TA.flash_attention(tq, tk, tv)
    to.backward(torch.tensor(do))

    for got, want in ((to, jo), (tq.grad, jdq), (tk.grad, jdk),
                      (tv.grad, jdv)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=2e-5, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_and_plain_bias_causal_match_jax(causal):
    """The plain path covers bias and causal on CPU tensors."""
    q, k, v, _ = _inputs((2, 40, 2, 64), seed=1)
    bias = np.random.RandomState(2).randn(2, 1, 40, 40).astype(np.float32)
    jref = JA.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(bias),
                                  causal=causal)
    tq, tk, tv = (torch.tensor(t) for t in (q, k, v))
    tref = TA.attention_reference(tq, tk, tv, torch.tensor(bias),
                                  causal=causal)
    tfa = TA.flash_attention(tq, tk, tv, bias=torch.tensor(bias),
                             causal=causal)
    np.testing.assert_allclose(tref.numpy(), np.asarray(jref), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(tfa.numpy(), tref.numpy(), atol=2e-5, rtol=0)


def test_dropout_without_seed_raises_jax_error():
    q = np.zeros((1, 8, 2, 64), np.float32)
    with pytest.raises(ValueError) as jerr:
        JA.flash_attention(*(jnp.asarray(q),) * 3, dropout_rate=0.1)
    with pytest.raises(ValueError) as terr:
        TA.flash_attention(*(torch.tensor(q),) * 3, dropout_rate=0.1)
    assert str(terr.value) == str(jerr.value) == \
        "dropout_rate > 0 requires dropout_seed"


def test_self_multihead_attn_matches_jax():
    """Packed-QKV module with weights carried over from flax."""
    from apex_tpu.ops.multihead_attn import SelfMultiheadAttn as JM
    from apex_tpu_torch.convert import params_from_jax

    x = np.random.RandomState(3).randn(2, 32, 128).astype(np.float32)
    jm = JM(128, 2)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    jy = jm.apply({"params": params}, jnp.asarray(x))
    tm = TM.SelfMultiheadAttn(128, 2, device="cpu")
    tm.load_state_dict(params_from_jax(params, device="cpu"))
    ty = tm(torch.tensor(x))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=2e-5, rtol=0)
