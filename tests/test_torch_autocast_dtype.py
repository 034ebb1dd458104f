"""``auto_cast`` and an explicit module ``dtype``: the port against flax
under the JAX package's interceptor.

Under an enabled policy the interceptor casts a HALF module's inputs
(Dense, Conv, ConvTranspose) to the half dtype and a FLOAT module's
(BatchNorm) to f32 first; only then does the module promote them to its
own ``dtype``, if one is set (``apex_tpu/amp/interceptor.py``). The same
weights (carried by ``params_from_jax``) and the same inputs from
``np.random.RandomState`` go to both sides, with ``dtype`` None, f32 and
bf16, under O0 and O1 bf16 (both policies are enabled, and the casts
apply whenever a policy is enabled, whatever its opt level) and under O1
with the policy disabled (no cast).

Tolerance: f32 outputs within rtol 1e-5 and 1e-6 of the output's largest
magnitude (the same f32 products, summed in another order); bf16 outputs
within one bf16 ulp (2**-8 relative, and 2**-8 of the largest magnitude
near zero: the f32 sum before the last rounding differs in order). An
explicit f32 ``dtype`` under O1 once skipped the bf16 input cast and was
0.014–0.042 off; the Dense case checks that this skipped cast lies
outside the tolerance.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from apex_tpu import amp as jamp
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import models as tmodels
from apex_tpu_torch.convert import params_from_jax

_DTYPES = {"none": (None, None), "f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}
_LEVELS = ["O0", "O1", "off"]

# (flax module, port module, input shape, JAX param tree name)
_MODULES = {
    "dense": (lambda dt: nn.Dense(3, dtype=dt),
              lambda dt: tmodels.Dense(8, 3, device="cpu", dtype=dt),
              (4, 8), "Dense_0"),
    "conv": (lambda dt: nn.Conv(5, (3, 3), (2, 2), use_bias=False, dtype=dt),
             lambda dt: tmodels.Conv(4, 5, (3, 3), (2, 2), dtype=dt,
                                     device="cpu"),
             (2, 9, 9, 4), "Conv_0"),
    "conv_transpose": (
        lambda dt: nn.ConvTranspose(5, (4, 4), (2, 2), use_bias=False,
                                    dtype=dt),
        lambda dt: tmodels.ConvTranspose(4, 5, (4, 4), (2, 2), dtype=dt,
                                         device="cpu"),
        (2, 5, 5, 4), "ConvTranspose_0"),
}


def _close(got, want):
    bf16 = got.dtype == torch.bfloat16
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = np.abs(want).max()
    tol = (dict(rtol=2.0 ** -8, atol=2.0 ** -8 * scale) if bf16
           else dict(rtol=1e-5, atol=1e-6 * scale))
    np.testing.assert_allclose(got, want, **tol)


def _policies(level):
    kw = dict(enabled=False) if level == "off" else {}
    level = "O1" if level == "off" else level
    return (jamp.Policy.from_opt_level(level, half_dtype=jnp.bfloat16, **kw),
            tamp.Policy.from_opt_level(level, half_dtype=torch.bfloat16,
                                       **kw))


@pytest.mark.parametrize("level", _LEVELS)
@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("kind", list(_MODULES))
def test_half_module_matches_flax(kind, dtype, level):
    make_j, make_t, shape, name = _MODULES[kind]
    jdt, tdt = _DTYPES[dtype]
    jpol, tpol = _policies(level)
    x = (np.random.RandomState(0).randn(*shape) * 3).astype(np.float32)
    jmod = make_j(jdt)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    with jamp.auto_cast(jpol):
        want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = make_t(tdt)
    carried = params_from_jax({name: params}, device="cpu")
    tmod.load_state_dict({k.split(".", 1)[1]: v for k, v in carried.items()})
    with tamp.auto_cast(tpol):
        got = tmod(torch.tensor(x))
    assert str(got.dtype).removeprefix("torch.") == jnp.dtype(want.dtype).name
    _close(got, want)


@pytest.mark.parametrize("level", _LEVELS)
@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_batch_norm_matches_flax(dtype, level):
    """A FLOAT module: its input is cast to f32 under O1, never to its own
    ``dtype``; statistics in f32, the output in the compute dtype."""
    jdt, tdt = _DTYPES[dtype]
    jpol, tpol = _policies(level)
    rng = np.random.RandomState(2)
    x = (rng.randn(4, 3, 3, 6) * 3 + 1).astype(np.float32)
    jmod = nn.BatchNorm(use_running_average=False, dtype=jdt)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"scale": jnp.asarray(rng.rand(6).astype(np.float32) + 0.5),
              "bias": jnp.asarray(rng.randn(6).astype(np.float32))}
    with jamp.auto_cast(jpol):
        want, new = jmod.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               jnp.asarray(x), mutable=["batch_stats"])
    tmod = tmodels.BatchNorm(6, dtype=tdt, device="cpu")
    with torch.no_grad():
        tmod.scale.copy_(torch.tensor(np.asarray(params["scale"])))
        tmod.bias.copy_(torch.tensor(np.asarray(params["bias"])))
    stats = {}
    with tamp.auto_cast(tpol):
        got = tmod(torch.tensor(x), True, stats)
    assert str(got.dtype).removeprefix("torch.") == jnp.dtype(want.dtype).name
    _close(got, want)
    for t, key in zip(stats[tmod], ("mean", "var")):
        _close(t, new["batch_stats"][key])


def test_dense_f32_under_o1_needs_the_half_input_cast():
    """The fault this file pins: computing straight from the f32 input
    (no bf16 cast first) is outside the tolerance the repaired path
    meets."""
    jpol, _ = _policies("O1")
    x = (np.random.RandomState(0).randn(4, 8) * 3).astype(np.float32)
    jmod = nn.Dense(3, dtype=jnp.float32)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    with jamp.auto_cast(jpol):
        want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    w = torch.tensor(np.asarray(params["kernel"]).T)
    b = torch.tensor(np.asarray(params["bias"]))
    skipped = F.linear(torch.tensor(x), w, b).numpy()
    assert np.abs(skipped - want).max() > 1e-6 * np.abs(want).max() + \
        1e-5 * np.abs(want).max()
