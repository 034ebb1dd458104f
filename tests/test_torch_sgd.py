"""Parity of apex_tpu_torch.optim.FusedSGD with apex_tpu.optim.FusedSGD.

Three steps of each strategy on random params and grads agree with the
JAX package's at rtol 1e-6 and an atol of 1e-6 times the tensor's largest
magnitude (the same f32 formulas; a product may round in another order).
The arena's momentum buffers are compared per tensor after ``unflatten``
(the packages order leaves differently). Momentum state carried from JAX
by ``convert.fused_state_from_jax`` continues a run on a small ResNet,
whose 4-D conv kernels map (kh, kw, I, O) -> (O, I, kh, kw).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import arena as JA
from apex_tpu import models as jmodels
from apex_tpu.optim import FusedSGD as JSGD
from apex_tpu_torch import arena as TA
from apex_tpu_torch import models as tmodels
from apex_tpu_torch.convert import (
    fused_state_from_jax, params_from_jax, resnet_variables_from_jax,
)
from apex_tpu_torch.optim import FusedSGD as TSGD

_SHAPES = {"w1": (16, 8), "b1": (8,), "k": (3, 3, 4, 6), "scale": (5,)}
_KWARGS = [
    dict(lr=0.1, momentum=0.9),
    dict(lr=0.05, momentum=0.9, nesterov=True, weight_decay=1e-3),
    dict(lr=0.05, momentum=0.8, dampening=0.3, weight_decay=1e-3,
         wd_after_momentum=True),
    dict(lr=0.1, momentum=0.0, weight_decay=1e-2),
]


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def _three_steps(strategy, kw, seed=0):
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in _SHAPES.items()}
    jopt, topt = JSGD(strategy=strategy, **kw), TSGD(strategy=strategy, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        grads = {k: rng.randn(*s).astype(np.float32)
                 for k, s in _SHAPES.items()}
        jp, js = jopt.step({k: jnp.asarray(v) for k, v in grads.items()},
                           js, jp)
        tp, ts = topt.step({k: torch.tensor(v) for k, v in grads.items()},
                           ts, tp)
    if strategy == "arena":
        tm = TA.unflatten(ts.slots["m"], TA.plan(tp))
        jm = JA.unflatten(js.slots["m"], JA.plan(jp))
    else:
        tm, jm = ts.slots["m"], js.slots["m"]
    return (tp, ts, tm), (jp, js, jm)


@pytest.mark.parametrize("strategy", ["tree", "arena"])
@pytest.mark.parametrize("kw", _KWARGS)
def test_three_steps_match_jax(kw, strategy):
    (tp, ts, tm), (jp, js, jm) = _three_steps(strategy, kw)
    assert int(ts.count) == int(js.count) == 3
    if strategy == "arena":
        assert set(ts.slots["m"]) == {"float32"}
    for k in _SHAPES:
        _close(tp[k].numpy(), jp[k])
        _close(tm[k].numpy(), jm[k])


@pytest.mark.parametrize("kw", _KWARGS)
def test_arena_matches_tree_in_the_port(kw):
    (ap, _, am), _ = _three_steps("arena", kw)
    (tp, _, tm), _ = _three_steps("tree", kw)
    for k in _SHAPES:
        _close(ap[k].numpy(), tp[k].numpy())
        _close(am[k].numpy(), tm[k].numpy())


def test_auto_takes_the_tree_at_resnet50_size():
    """``"auto"`` keeps the JAX package's 8M rule: ResNet-50's 25,557,032
    params take the per-tensor update (counted on the meta device)."""
    params = dict(tmodels.ResNet50(device="meta").named_parameters())
    assert sum(p.numel() for p in params.values()) == 25_557_032
    assert TSGD(lr=0.1, momentum=0.9)._use_tree(params)
    assert not TSGD(lr=0.1, momentum=0.9, strategy="arena")._use_tree(params)
    with pytest.raises(ValueError, match="Nesterov"):
        TSGD(momentum=0.9, dampening=0.1, nesterov=True)


def _small_resnet():
    jm = jmodels.ResNet(stage_sizes=[1], num_classes=5, width=4)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                        train=True)
    tm = tmodels.ResNet(stage_sizes=[1], num_classes=5, width=4,
                        device="cpu")
    return variables["params"], tm


@pytest.mark.parametrize("strategy", ["arena", "tree"])
def test_state_carried_from_jax_continues_the_run(strategy):
    """Two JAX steps on a small ResNet, carry params and momentum to the
    port, then one more step on each side: the results agree."""
    params, tm = _small_resnet()
    rng = np.random.RandomState(7)
    leaves, treedef = jax.tree_util.tree_flatten(params)

    def grads():
        return jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(rng.randn(*l.shape).astype(np.float32) * 0.1)
            for l in leaves])

    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, strategy=strategy)
    jopt = JSGD(**kw)
    jp, js = params, jopt.init(params)
    for _ in range(2):
        jp, js = jopt.step(grads(), js, jp)
    carried, _ = resnet_variables_from_jax(jax.device_get(jp), {},
                                           device="cpu")
    order = [n for n, _ in tm.named_parameters()]
    assert set(order) == set(carried)
    assert carried["stem_conv.weight"].shape == (4, 3, 7, 7)
    tp = {n: carried[n] for n in order}
    ts = fused_state_from_jax(jax.device_get(js), jax.device_get(jp), tp,
                              device="cpu")
    assert int(ts.count) == 2
    g = grads()
    jp, js = jopt.step(g, js, jp)
    tp, ts = TSGD(**kw).step(params_from_jax(jax.device_get(g), "cpu"),
                             ts, tp)
    want_p = params_from_jax(jax.device_get(jp), device="cpu")
    want = fused_state_from_jax(jax.device_get(js), jax.device_get(jp), tp,
                                device="cpu")
    assert int(ts.count) == int(want.count) == 3
    for k in tp:
        _close(tp[k].numpy(), want_p[k].numpy())
    for dt, buf in want.slots["m"].items():
        _close(ts.slots["m"][dt].numpy(), buf.numpy())
