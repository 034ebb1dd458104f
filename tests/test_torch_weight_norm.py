"""The port's weight normalization (``reparam``) against the JAX package's.

- ``apply_weight_norm`` on a Dense and on a Conv: output, input gradient
  and the gradients of v (``layer.weight``), the bias and g (``scale``)
  against the JAX package's ``apply_weight_norm`` (flax's ``nn.WeightNorm``)
  with the flax params carried by ``weight_norm_params_from_jax`` (f32,
  atol 1e-5).
- ``remove_weight_norm`` against the JAX package's (atol 1e-6), and the
  wrapped layer with the folded weight gives the normalized forward (atol
  1e-5; it folds without the ε, as the JAX package does).
- The fp16 hazard: with v near 1e-4 in fp16 (its squares underflow fp16)
  the port's normalized weight equals the float64 computation within 1e-6
  relative before its rounding to fp16, and is that value rounded to fp16
  bit for bit. The JAX package normalizes in the weight's dtype, so its
  fp16 result is far from it (by more than 1% of the weight's magnitude,
  twenty fp16 roundings, or NaN where a row's squares all underflow):
  the port keeps the f32 norm the reference Apex's fp16-safe hooks give.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from apex_tpu import reparam as JW
from apex_tpu_torch import reparam as TW
from apex_tpu_torch.convert import weight_norm_params_from_jax
from apex_tpu_torch.models.layers import Conv
from apex_tpu_torch.models.transformer import Dense
from apex_tpu_torch.reparam import weight_norm as TWN


def _check(jlayer, tlayer, x):
    jm = JW.apply_weight_norm(jlayer)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    # a scale other than its ones init, so g enters the comparison
    params = jax.tree_util.tree_map(lambda a: a, params)
    wn = params["WeightNorm_0"]
    for k in wn:
        wn[k] = jnp.asarray(np.linspace(0.5, 1.5, wn[k].size,
                                        dtype=np.float32))
    tm = TW.apply_weight_norm(tlayer)
    mapped = weight_norm_params_from_jax(params, device="cpu")
    assert set(mapped) == {n for n, _ in tm.named_parameters()}
    tm.load_state_dict(mapped)
    jy = jm.apply({"params": params}, jnp.asarray(x))
    dy = np.random.RandomState(1).randn(*jy.shape).astype(np.float32)
    jgp, jgx = jax.grad(lambda p, xx: jnp.sum(
        jm.apply({"params": p}, xx) * dy), argnums=(0, 1))(
            params, jnp.asarray(x))
    tx = torch.tensor(x).requires_grad_(True)
    ty = tm(tx)
    (ty * torch.tensor(dy)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5,
                               rtol=0)
    want = weight_norm_params_from_jax(jgp, device="cpu")
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(),
                                   atol=1e-5, rtol=0, err_msg=n)
    return params, tm, x


def test_dense_matches_jax():
    x = np.random.RandomState(0).randn(4, 16).astype(np.float32)
    _check(fnn.Dense(8), Dense(16, 8, device="cpu"), x)


def test_conv_matches_jax():
    x = np.random.RandomState(2).randn(2, 6, 6, 3).astype(np.float32)
    _check(fnn.Conv(4, (3, 3), use_bias=False),
           Conv(3, 4, (3, 3), device="cpu"), x)


def test_remove_matches_jax():
    x = np.random.RandomState(0).randn(4, 16).astype(np.float32)
    params, tm, _ = _check(fnn.Dense(8), Dense(16, 8, device="cpu"), x)
    want = weight_norm_params_from_jax(JW.remove_weight_norm(params),
                                       device="cpu")
    got = TW.remove_weight_norm(dict(tm.named_parameters()))
    assert set(got) == set(want) == {"layer.weight", "layer.bias"}
    for n in want:
        np.testing.assert_allclose(got[n].detach().numpy(),
                                   want[n].numpy(), atol=1e-6, rtol=0)
    xt = torch.tensor(x)
    with torch.no_grad():
        before = tm(xt)
        tm.layer.load_state_dict({k[len("layer."):]: v
                                  for k, v in got.items()})
        np.testing.assert_allclose(tm.layer(xt).numpy(), before.numpy(),
                                   atol=1e-5, rtol=0)


def test_remove_keeps_other_scales():
    params = {"BatchNorm_0.scale": torch.ones(3),
              "wn.layer.weight": torch.full((2, 3), 2.0),
              "wn.scale": torch.tensor([1.0, 3.0])}
    out = TW.remove_weight_norm(params)
    assert set(out) == {"BatchNorm_0.scale", "wn.layer.weight"}
    np.testing.assert_allclose(out["wn.layer.weight"].numpy(),
                               np.array([[1, 1, 1], [3, 3, 3]]) / np.sqrt(3),
                               rtol=1e-6)


def test_fp16_underflow_hazard():
    rng = np.random.RandomState(4)
    v = (rng.randn(32, 64) * 1e-4).astype(np.float32)      # port (out, in)
    g = (1 + 0.1 * rng.randn(32)).astype(np.float32)
    v16, g16 = torch.tensor(v).half(), torch.tensor(g).half()
    assert float((v16 * v16).sum(dim=1).min()) < 0.5 * float(
        (v16.double() ** 2).sum(dim=1).min())       # the squares underflow
    v64, g64 = v16.double(), g16.double()
    ref = g64[:, None] * v64 / v64.norm(dim=1, keepdim=True)
    w32 = TWN.normalized_weight(v16, g16, torch.float32)
    rel = (w32.double() - ref).abs().max() / ref.abs().max()
    assert rel < 1e-6, rel
    w16 = TWN.normalized_weight(v16, g16)
    assert w16.dtype == torch.float16
    assert torch.equal(w16, w32.half())
    # the JAX package's WeightNorm in fp16 normalizes in fp16
    jm = JW.apply_weight_norm(fnn.Dense(32))
    x = np.eye(64, dtype=np.float32)
    params = {"layer": {"kernel": jnp.asarray(v.T, jnp.float16),
                        "bias": jnp.zeros(32, jnp.float16)},
              "WeightNorm_0": {"layer/kernel/scale": jnp.asarray(
                  g, jnp.float16)}}
    jw = np.asarray(jm.apply({"params": params},
                             jnp.asarray(x, jnp.float16)), np.float64).T
    err = np.nan_to_num(np.abs(jw - ref.numpy()), nan=np.inf)
    assert err.max() > 1e-2 * np.abs(ref.numpy()).max()
