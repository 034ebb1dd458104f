"""``TransformerLayer(pre_ln=True)`` against the JAX package's.

A pre-LN layer (hidden 64, 2 heads, ffn 128) with the flax params carried
by ``params_from_jax`` (both variants build their submodules in the same
order, so they share the post-LN layer's names): the output, the input
gradient and every param gradient, at O0 in f32 (atol 1e-4, as the BERT
test's O0 grads) and under ``auto_cast`` of O1 in bf16 (within 2e-2 of
each tensor's max magnitude, a few bf16 roundings apart), with a padding
mask, at ``deterministic=True``. The pre-LN and post-LN layers differ.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.models import transformer as JT
from apex_tpu_torch import amp as tamp
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import transformer as TT

JO1 = jamp.Policy.from_opt_level("O1")
TO1 = tamp.Policy.from_opt_level("O1")
HIDDEN, HEADS, FFN, B, S = 64, 2, 128, 2, 24


def _inputs():
    rng = np.random.RandomState(0)
    x = rng.randn(B, S, HIDDEN).astype(np.float32)
    mask = np.ones((B, 1, 1, S), bool)
    mask[1, ..., 17:] = False
    dy = rng.randn(B, S, HIDDEN).astype(np.float32)
    return x, mask, dy


def _run(pre_ln, level):
    x, mask, dy = _inputs()
    jm = JT.TransformerLayer(HIDDEN, HEADS, FFN, pre_ln=pre_ln)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                     jnp.asarray(mask))["params"]
    tm = TT.TransformerLayer(HIDDEN, HEADS, FFN, pre_ln=pre_ln, device="cpu")
    mapped = params_from_jax(params, device="cpu")
    assert set(mapped) == set(tm.state_dict())
    tm.load_state_dict(mapped)
    jscope = tscope = contextlib.nullcontext
    if level == "O1":
        jscope = functools.partial(jamp.auto_cast, JO1)
        tscope = functools.partial(tamp.auto_cast, TO1)

    def jloss(p, xx):
        with jscope():
            y = jm.apply({"params": p}, xx, jnp.asarray(mask))
        return jnp.sum(y.astype(jnp.float32) * dy), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(params,
                                                           jnp.asarray(x))
    tx = torch.tensor(x).requires_grad_(True)
    with tscope():
        ty = tm(tx, torch.tensor(mask))
    (ty.float() * torch.tensor(dy)).sum().backward()
    got = {"y": ty.detach().float(), "dx": tx.grad,
           **{n: p.grad for n, p in tm.named_parameters()}}
    want = {"y": np.asarray(jy, np.float32), "dx": np.asarray(jgx),
            **{n: t.numpy()
               for n, t in params_from_jax(jgp, device="cpu").items()}}
    return got, want


@pytest.mark.parametrize("level", ["O0", "O1"])
def test_pre_ln_layer_matches_jax(level):
    got, want = _run(True, level)
    for name, w in want.items():
        g = got[name].numpy()
        if level == "O0":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=2e-2 * np.abs(w).max(),
                                       rtol=0, err_msg=name)


def test_pre_ln_differs_from_post_ln():
    pre, _ = _run(True, "O0")
    post, _ = _run(False, "O0")
    assert not np.allclose(pre["y"].numpy(), post["y"].numpy(), atol=1e-3)
