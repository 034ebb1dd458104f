"""``train.build_resnet_step(optimizer=FusedAdam(...))`` against the JAX
package: configuration 2's FusedAdam variant.

The two-stage bottleneck ResNet of ``test_torch_resnet.py`` (width 8, 10
classes, B4, 32 px), its weights redrawn by flax and carried over by
``convert``, trains two O2 bf16 steps with ``FusedAdam(lr=1e-3)`` on the
arena and on the tree update in each package, from the inputs
``np.random.RandomState(0)`` gives both. The losses track JAX's within
1e-2 relative (bf16 activations, as the FusedSGD test); the port's arena
and tree runs agree within 1e-5 relative in loss and within 1e-5 of each
tensor's max in the master params and m, 2e-5 in v (the same f32 Adam
arithmetic, but (1 − β2) taken in f32 by the arena kernels: 1.3e-5 apart
at β2 = 0.999, as chip_smoke.py's ``TOL_UPDATE`` states).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import ops as jops
from apex_tpu.optim import FusedAdam as JAdam
from apex_tpu_torch import arena, train
from apex_tpu_torch.convert import resnet_variables_from_jax
from apex_tpu_torch.optim import FusedAdam as TAdam

from test_torch_resnet import B, CLASSES, S, _models, _variables


def _jax_losses(jm, params, bstats, strategy, steps=2):
    policy = jamp.Policy.from_opt_level("O2")
    amp_opt = jamp.Amp(policy, JAdam(lr=1e-3, strategy=strategy))
    state = amp_opt.init(params)
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.rand(B, S, S, 3).astype(np.float32), jnp.bfloat16)
    y = jnp.asarray(rng.randint(0, CLASSES, B), jnp.int32)

    @jax.jit
    def step(state, bs):
        def loss_fn(mp):
            logits, mut = jm.apply({"params": mp, "batch_stats": bs}, x,
                                   train=True, mutable=["batch_stats"])
            return jnp.mean(jops.softmax_cross_entropy_loss(logits, y)), \
                mut["batch_stats"]

        (loss, new_bs), grads, state, finite = amp_opt.backward(
            state, loss_fn, has_aux=True)
        return amp_opt.apply_gradients(state, grads, finite), new_bs, loss

    losses, bs = [], bstats
    for _ in range(steps):
        state, bs, loss = step(state, bs)
        losses.append(float(loss))
    return losses


def _port_run(params, bstats, strategy, steps=2):
    _, tm = _models("bottleneck", torch.bfloat16)
    tp, tbs = resnet_variables_from_jax(params, bstats, device="cpu")
    tm.load_state_dict({**tp, **tbs})
    step, (state, bs), (x, y), policy, _ = train.build_resnet_step(
        B, S, model=tm, device="cpu",
        optimizer=TAdam(lr=1e-3, strategy=strategy))
    assert x.dtype == torch.bfloat16 and policy.loss_scale is None
    losses = []
    for _ in range(steps):
        state, bs, loss = step(state, bs, x, y)
        losses.append(loss.item())
    assert int(state.step) == steps
    return losses, state


@pytest.fixture(scope="module")
def weights():
    jm, _ = _models("bottleneck", torch.bfloat16)
    return jm, _variables(jm, seed=11)


@pytest.mark.parametrize("strategy", ["arena", "tree"])
def test_two_o2_adam_steps_track_jax(weights, strategy):
    jm, (params, bstats) = weights
    want = _jax_losses(jm, params, bstats, strategy)
    got, _ = _port_run(params, bstats, strategy)
    np.testing.assert_allclose(got, want, rtol=1e-2)
    assert got[1] != got[0]


def test_arena_and_tree_adam_agree(weights):
    _, (params, bstats) = weights
    (la, sa), (lt, st) = (_port_run(params, bstats, s)
                          for s in ("arena", "tree"))
    np.testing.assert_allclose(la, lt, rtol=1e-5)
    spec = arena.plan(st.params)
    slots = {k: arena.unflatten(v, spec)
             for k, v in sa.opt_state.slots.items()}
    for name, p in st.params.items():
        for got, want, tol in (
                (sa.params[name], p, 1e-5),
                (slots["m"][name], st.opt_state.slots["m"][name], 1e-5),
                (slots["v"][name], st.opt_state.slots["v"][name], 2e-5)):
            err = (got - want).abs().max() / want.abs().max().clamp(min=1e-30)
            assert err.item() <= tol, name


def test_optimizer_and_strategy_together_raise():
    with pytest.raises(ValueError, match="strategy"):
        train.build_resnet_step(B, S, device="cpu", strategy="arena",
                                optimizer=TAdam(lr=1e-3))
