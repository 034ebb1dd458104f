"""flash_attention against the JAX package where it takes its native-layout
kernels (rows 5-8): H = 2 with D = 64 (BERT's geometry) and D = 128.

Every bias mode (shared, batch, head, full; the bias's gradient too), causal
at the default frontier and at a causal offset, Sq != Sk, dropout, and bias
with dropout; cases in ``_torch_attention_cases.py``. Then a causal Sq > Sk
call whose first rows see no key, in one JAX block: o = 0, lse = -1e30 and
zero gradients there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_attention_cases import OPTIONS, check_case
from apex_tpu.ops import attention as JA
from apex_tpu_torch.ops import attention as TA


@pytest.mark.parametrize("option", list(OPTIONS))
def test_native_d64_matches_jax(option):
    assert JA._native_g0(2, 64) is not None
    check_case(2, 2, 64, option)


@pytest.mark.parametrize("option", ["full_bias", "causal_offset", "dropout",
                                    "bias_dropout"])
def test_native_d128_matches_jax(option):
    assert JA._native_g0(2, 128) is not None
    check_case(1, 2, 128, option)


def test_rows_without_keys_match_jax_single_block():
    rng = np.random.RandomState(4)
    q, do = (rng.randn(1, 72, 2, 64).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, 40, 2, 64).astype(np.float32) for _ in range(2))
    jo, jlse = JA.flash_attention_lse(*(jnp.asarray(t) for t in (q, k, v)),
                                      causal=True)
    jgrads = jax.grad(lambda *a: jnp.sum(JA.flash_attention(
        *a, causal=True) * jnp.asarray(do)), argnums=(0, 1, 2))(
            *(jnp.asarray(t) for t in (q, k, v)))
    tq, tk, tv = (torch.tensor(t).requires_grad_(True) for t in (q, k, v))
    to, tlse = TA.flash_attention_lse(tq, tk, tv, causal=True)
    to.backward(torch.tensor(do))
    assert (to[:, :32] == 0).all() and (tlse[..., :32] == TA.NEG_INF).all()
    np.testing.assert_array_equal(tlse.detach().numpy()[..., :32],
                                  np.asarray(jlse)[..., :32])
    np.testing.assert_allclose(tlse.detach().numpy()[..., 32:],
                               np.asarray(jlse)[..., 32:], atol=2e-5, rtol=0)
    for got, want in ((to, jo), (tq.grad, jgrads[0]), (tk.grad, jgrads[1]),
                      (tv.grad, jgrads[2])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=2e-5, rtol=0)
