"""``FusedLayerNorm`` with a normalized_shape of more than one axis,
against the JAX package.

The JAX module holds (prod(normalized_shape),) params but normalises over
the last axis only (``reshape(-1, shape[-1])``); its affine variant then
fails in a reshape. The port mirrors that, not the reference Apex (which
normalises over every axis of the shape): non-affine equals JAX within
atol 1e-5 in f32, affine raises a ValueError. x (3, 4, 8) = 2·randn + 1
from ``RandomState(0)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.layer_norm import FusedLayerNorm as JLN
from apex_tpu_torch.ops.layer_norm import FusedLayerNorm as TLN


def _x():
    return (2 * np.random.RandomState(0).randn(3, 4, 8) + 1).astype(
        np.float32)


def test_non_affine_normalises_over_the_last_axis_as_jax():
    x = _x()
    jm = JLN((4, 8), elementwise_affine=False)
    want = jm.apply(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                    jnp.asarray(x))
    tx = torch.tensor(x).requires_grad_(True)
    got = TLN((4, 8), elementwise_affine=False, device="cpu")(tx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.detach().numpy().std(axis=-1), 1.0,
                               atol=1e-3)
    g = np.random.RandomState(1).randn(3, 4, 8).astype(np.float32)
    jdx = jax.grad(lambda x_: jnp.sum(jm.apply({}, x_) * g))(jnp.asarray(x))
    (got * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-5,
                               rtol=0)


def test_affine_over_two_axes_raises_as_jax_fails():
    x = jnp.asarray(_x())
    jm = JLN((4, 8))
    with pytest.raises(TypeError):
        jm.init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="last axis only"):
        TLN((4, 8), device="cpu")


def test_affine_with_leading_unit_axes_matches_jax():
    """(1, 8): the params are as wide as the last axis, which JAX takes."""
    x = _x()
    jm = JLN((1, 8))
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jm.apply(variables, jnp.asarray(x))
    got = TLN((1, 8), device="cpu")(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
