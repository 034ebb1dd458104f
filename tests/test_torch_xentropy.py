"""Parity of apex_tpu_torch.ops.xentropy with apex_tpu.ops.xentropy.

The same numpy logits and labels (some at −1) go through the JAX op
(Pallas kernels in interpret mode on the CPU) and the port on the CPU (its
plain versions). Per-row loss and dx agree at atol 1e-5 in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import xentropy as JX
from apex_tpu_torch.ops import xentropy as TX


def _inputs(n, v, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, v).astype(np.float32)
    labels = rng.randint(0, v, (n,)).astype(np.int64)
    labels[::3] = -1
    g = rng.rand(n).astype(np.float32)
    return x, labels, g


@pytest.mark.parametrize("v", [1000, 30522])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_loss_and_dx_match_jax(v, smoothing):
    x, labels, g = _inputs(6, v)
    jlab = jnp.asarray(labels, jnp.int32)
    jg = jnp.asarray(g)
    jloss = JX.softmax_cross_entropy_loss(jnp.asarray(x), jlab, smoothing)
    jdx = jax.grad(lambda x_: jnp.sum(
        JX.softmax_cross_entropy_loss(x_, jlab, smoothing) * jg))(
            jnp.asarray(x))

    tx = torch.tensor(x).requires_grad_(True)
    tloss = TX.softmax_cross_entropy_loss(tx, torch.tensor(labels), smoothing)
    (tloss * torch.tensor(g)).sum().backward()

    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(tloss.detach().numpy(), np.asarray(jloss),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               atol=1e-5, rtol=0)
    ignored = labels < 0
    assert np.all(tloss.detach().numpy()[ignored] == 0.0)
    assert np.all(tx.grad.numpy()[ignored] == 0.0)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_batched_shape_and_reference(smoothing):
    """(B, S, V) logits keep their leading shape; the port's reference
    matches the JAX reference."""
    x, labels, _ = _inputs(8, 257, seed=1)
    x3, lab3 = x.reshape(2, 4, 257), labels.reshape(2, 4)
    tloss = TX.softmax_cross_entropy_loss(torch.tensor(x3),
                                          torch.tensor(lab3), smoothing)
    tref = TX.softmax_cross_entropy_reference(torch.tensor(x3),
                                              torch.tensor(lab3), smoothing)
    jref = JX.softmax_cross_entropy_reference(
        jnp.asarray(x3), jnp.asarray(lab3, jnp.int32), smoothing)
    assert tloss.shape == (2, 4)
    np.testing.assert_allclose(tloss.numpy(), tref.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tref.numpy(), np.asarray(jref), atol=1e-5,
                               rtol=0)
