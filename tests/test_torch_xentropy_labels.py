"""Cross-entropy rows whose label is V or more, against the JAX package.

The JAX op's one-hot compares the label with every column, so a label >= V
matches none: the row's loss is lse − (ε/V)·Σx and its gradient
g·(softmax − ε/V); only a negative label zeroes loss and gradient. The same
numpy logits go through the JAX op (Pallas kernels in interpret mode on
the CPU) and its oracle, and through the port's op on the CPU (its plain
versions) and its reference. Labels [1, V, V+2, −1, ...] with the last
row at V, smoothing 0 and 0.1. Tolerances: f32 loss, lse and dx within
atol 1e-5 (sums in another order); bf16 logits: loss and lse within 1e-5
(both upcast before any sum), dx within one bf16 ulp of its magnitude
(atol 2e-3 at |dx| < 0.25, the rounding of the f32 result).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import xentropy as JX
from apex_tpu_torch.ops import xentropy as TX

N, V = 6, 10


def _inputs(dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, V).astype(np.float32)
    labels = np.array([1, V, V + 2, -1, 3, V], np.int64)
    g = rng.rand(N).astype(np.float32)
    jx = jnp.asarray(x, {torch.float32: jnp.float32,
                         torch.bfloat16: jnp.bfloat16}[dtype])
    return jx, torch.tensor(x).to(dtype), labels, g


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32)) \
        if not isinstance(t, torch.Tensor) else t.detach().float().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_labels_past_the_vocab_match_jax(dtype, smoothing):
    jx, tx, labels, g = _inputs(dtype)
    jlab = jnp.asarray(labels, jnp.int32)
    jg = jnp.asarray(g)
    jloss, jlse = JX._fwd_call(jx, jlab, smoothing)
    jdx = jax.grad(lambda x_: jnp.sum(
        JX.softmax_cross_entropy_loss(x_, jlab, smoothing).astype(
            jnp.float32) * jg))(jx)

    tlab = torch.tensor(labels)
    tloss, tlse = TX.xentropy_fwd_plain(tx, tlab, smoothing)
    txg = tx.clone().requires_grad_(True)
    out = TX.softmax_cross_entropy_loss(txg, tlab, smoothing)
    (out * torch.tensor(g)).sum().backward()

    np.testing.assert_allclose(_np(tloss), _np(jloss), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(tlse), _np(jlse), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(out), _np(jloss), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        _np(txg.grad), _np(jdx), rtol=0,
        atol=1e-5 if dtype == torch.float32 else 2e-3)
    assert txg.grad.dtype == dtype
    # the rows past the vocab: loss lse − (ε/V)·Σx, no column at 1 − ε
    x32 = tx.float()
    past = labels >= V
    want = tlse - smoothing / V * x32.sum(dim=1)
    np.testing.assert_allclose(_np(tloss)[past], _np(want)[past], atol=1e-5,
                               rtol=0)
    assert _np(tloss)[3] == 0.0 and np.all(_np(txg.grad)[3] == 0.0)
    assert np.all(_np(txg.grad)[past] != 0.0)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_reference_matches_the_jax_oracle(smoothing):
    jx, tx, labels, _ = _inputs(torch.float32, seed=1)
    jref = JX.softmax_cross_entropy_reference(
        jx, jnp.asarray(labels, jnp.int32), smoothing)
    tref = TX.softmax_cross_entropy_reference(tx, torch.tensor(labels),
                                              smoothing)
    np.testing.assert_allclose(_np(tref), _np(jref), atol=1e-5, rtol=0)


def test_backward_matches_no_column_for_labels_up_to_int32_max():
    """The backward's target is g·(1 − ε) only where the column equals
    the label: labels far past V (up to 2³¹ − 1) match none."""
    _, tx, _, g = _inputs(torch.float32, seed=2)
    labels = torch.tensor([V, 2 ** 20, 2 ** 31 - 1, V + 1, 0, -1])
    _, lse = TX.xentropy_fwd_plain(tx, labels, 0.0)
    dx = TX.xentropy_bwd_plain(tx, labels, lse, torch.tensor(g), 0.0)
    soft = torch.softmax(tx, dim=1) * torch.tensor(g)[:, None]
    torch.testing.assert_close(dx[:4], soft[:4], atol=1e-6, rtol=0)
    assert dx[4, 0] < 0 and torch.all(dx[5] == 0)
