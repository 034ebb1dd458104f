"""Parity of apex_tpu_torch.ops.layer_norm with apex_tpu.ops.layer_norm.

The same numpy inputs go through the JAX op (Pallas kernels in interpret
mode on the CPU) and the port on the CPU (its plain versions). Forward
output, dx, dγ and dβ agree at atol 1e-5 in fp32 and 2e-2 in bf16 (one
bf16 ulp at the outputs' magnitude, from rounding the f32 result).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import layer_norm as JL
from apex_tpu_torch.ops import layer_norm as TL

_DT = {"float32": (jnp.float32, torch.float32, 1e-5),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    h = shape[-1]
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.2 * rng.randn(h)).astype(np.float32)
    b = (0.2 * rng.randn(h)).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x, w, b, g


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("shape", [(2, 8, 64), (5, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_affine_fwd_bwd_match_jax(shape, dtype):
    jdt, tdt, atol = _DT[dtype]
    x, w, b, g = _inputs(shape)
    jx = jnp.asarray(x, jdt)
    jg = jnp.asarray(g)

    def jloss(x_, w_, b_):
        y = JL.fused_layer_norm_affine(x_, w_, b_, 1e-5)
        return jnp.sum(y.astype(jnp.float32) * jg)

    jy = JL.fused_layer_norm_affine(jx, jnp.asarray(w), jnp.asarray(b), 1e-5)
    jdx, jdw, jdb = jax.grad(jloss, argnums=(0, 1, 2))(
        jx, jnp.asarray(w), jnp.asarray(b))

    tx = torch.tensor(x).to(tdt).requires_grad_(True)
    tw = torch.tensor(w).requires_grad_(True)
    tb = torch.tensor(b).requires_grad_(True)
    ty = TL.fused_layer_norm_affine(tx, tw, tb, 1e-5)
    (ty.float() * torch.tensor(g)).sum().backward()

    assert ty.dtype == tdt and ty.shape == tx.shape
    assert tw.grad.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), atol=atol, rtol=0)
    np.testing.assert_allclose(_np(tx.grad), _np(jdx), atol=atol, rtol=0)
    np.testing.assert_allclose(_np(tw.grad), _np(jdw), atol=atol, rtol=0)
    np.testing.assert_allclose(_np(tb.grad), _np(jdb), atol=atol, rtol=0)


@pytest.mark.parametrize("shape", [(2, 8, 64), (5, 100)])
def test_non_affine_matches_jax(shape):
    x, _, _, g = _inputs(shape, seed=1)
    jg = jnp.asarray(g)
    jy = JL.fused_layer_norm(jnp.asarray(x), 1e-5)
    jdx = jax.grad(lambda x_: jnp.sum(JL.fused_layer_norm(x_, 1e-5) * jg))(
        jnp.asarray(x))
    tx = torch.tensor(x).requires_grad_(True)
    ty = TL.fused_layer_norm(tx, 1e-5)
    (ty * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(tx.grad), _np(jdx), atol=1e-5, rtol=0)


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_reference_matches_jax_reference(eps):
    x, w, b, _ = _inputs((4, 96), seed=2)
    jy = JL.layer_norm_reference(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), eps)
    ty = TL.layer_norm_reference(torch.tensor(x), torch.tensor(w),
                                 torch.tensor(b), eps)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5, rtol=0)


def test_module_and_cpu_dispatch():
    """A CPU tensor takes the plain version: no kernel launch is counted."""
    x, _, _, _ = _inputs((3, 7, 32), seed=3)
    before = (TL.ln_fwd_kernel.launches, TL.ln_bwd_kernel.launches)
    mod = TL.FusedLayerNorm(32, device="cpu")
    tx = torch.tensor(x).requires_grad_(True)
    y = mod(tx)
    y.sum().backward()
    ref = TL.layer_norm_reference(tx.detach(), mod.scale.detach(),
                                  mod.bias.detach(), 1e-5)
    np.testing.assert_allclose(_np(y), _np(ref), atol=1e-5, rtol=0)
    assert (TL.ln_fwd_kernel.launches, TL.ln_bwd_kernel.launches) == before
    assert sorted(n for n, _ in mod.named_parameters()) == ["bias", "scale"]
