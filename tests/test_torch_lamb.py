"""Parity of apex_tpu_torch.optim.FusedLAMB with apex_tpu.optim.FusedLAMB.

Three steps of each strategy on random params and grads, on both sides,
agree at rtol 1e-6, with an atol of 1e-6 times the tensor's largest
magnitude: the global grad norm sums in another order, and its last-bit
difference in the clip factor grows relative to an element where
β1·m + (1−β1)·g cancels. The strategy is set on both sides: under "auto"
each package takes the arena below 8M params and the tree above. The
arena's slot buffers are compared per tensor after ``unflatten`` (the
packages order leaves differently, so their offsets may differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import arena as JA
from apex_tpu import models as jmodels
from apex_tpu.optim import FusedLAMB as JLAMB
from apex_tpu_torch import arena as TA
from apex_tpu_torch.convert import bert_params_from_jax, fused_state_from_jax
from apex_tpu_torch.optim import FusedLAMB as TLAMB

_SHAPES = {"w1": (16, 8), "b1": (8,), "w2": (8, 5), "scale": (5,),
           "zero": (4,)}
_KWARGS = [
    dict(),
    dict(weight_decay=0.0),
    dict(weight_decay=0.0, use_nvlamb=True),
    dict(adam_w_mode=False, max_grad_norm=0.0),
    dict(bias_correction=False, lr=5e-3, betas=(0.8, 0.99)),
]


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def _three_steps(strategy, kw, seed=0):
    """Three steps on both sides; returns the port's and JAX's
    (params, state, per-tensor slots)."""
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in _SHAPES.items()}
    params["zero"][:] = 0.0          # exercises the zero-norm trust ratio
    jopt = JLAMB(strategy=strategy, **kw)
    topt = TLAMB(strategy=strategy, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        grads = {k: (rng.randn(*s) * 3.0).astype(np.float32)
                 for k, s in _SHAPES.items()}
        jp, js = jopt.step({k: jnp.asarray(v) for k, v in grads.items()},
                           js, jp)
        tp, ts = topt.step({k: torch.tensor(v) for k, v in grads.items()},
                           ts, tp)
    if strategy == "arena":
        tspec, jspec = TA.plan(tp), JA.plan(jp)
        tslots = {s: TA.unflatten(ts.slots[s], tspec) for s in ("m", "v")}
        jslots = {s: JA.unflatten(js.slots[s], jspec) for s in ("m", "v")}
    else:
        tslots, jslots = ts.slots, js.slots
    return (tp, ts, tslots), (jp, js, jslots)


@pytest.mark.parametrize("kw", _KWARGS)
def test_three_tree_steps_match_jax(kw):
    (tp, ts, tslots), (jp, js, jslots) = _three_steps("tree", kw)
    assert int(ts.count) == int(js.count) == 3
    pairs = [(tp[k], jp[k]) for k in _SHAPES] + [
        (tslots[s][k], jslots[s][k]) for s in ("m", "v") for k in _SHAPES]
    for got, want in pairs:
        _close(got.numpy(), want)


@pytest.mark.parametrize("kw", _KWARGS)
def test_three_arena_steps_match_jax(kw):
    (tp, ts, tslots), (jp, js, jslots) = _three_steps("arena", kw)
    assert int(ts.count) == int(js.count) == 3
    assert set(ts.slots["m"]) == set(js.slots["m"]) == {"float32"}
    pairs = [(tp[k], jp[k]) for k in _SHAPES] + [
        (tslots[s][k], jslots[s][k]) for s in ("m", "v") for k in _SHAPES]
    for got, want in pairs:
        _close(got.numpy(), want)


@pytest.mark.parametrize("kw", _KWARGS)
def test_arena_matches_tree_in_the_port(kw):
    """m at the LAMB tolerance; v and p at rtol 2e-5, because the arena
    kernels take (1 − β2) in f32 from the f32 β2 (as the JAX package's
    kernels do) and the tree update from the Python float (as the JAX
    tree update does): 1.3e-5 apart at β2 = 0.999, so u differs by half
    that. The trust ratio cancels this uniform factor of u; p shows it
    only where the ratio is 1 (a zero tensor, or wd = 0 without NVLAMB)."""
    (ap, _, aslots), _ = _three_steps("arena", kw)
    (tp, _, tslots), _ = _three_steps("tree", kw)
    for k in _SHAPES:
        _close(aslots["m"][k].numpy(), tslots["m"][k].numpy())
        for got, want in ((ap[k], tp[k]), (aslots["v"][k], tslots["v"][k])):
            want = want.numpy()
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                                       atol=1e-6 * np.abs(want).max())


def test_arena_with_a_bf16_partition_matches_jax():
    """Two partitions: f32 and bf16 params, f32 moments keyed by the
    params' dtype names; bf16 params match to one bf16 ulp."""
    rng = np.random.RandomState(3)
    shapes = {"a": ((40, 30), jnp.float32, torch.float32),
              "b": ((1100,), jnp.bfloat16, torch.bfloat16),
              "c": ((7,), jnp.float32, torch.float32)}
    vals = {k: rng.randn(*s).astype(np.float32) for k, (s, _, _) in
            shapes.items()}
    jp = {k: jnp.asarray(vals[k], jd) for k, (_, jd, _) in shapes.items()}
    tp = {k: torch.tensor(vals[k]).to(td) for k, (_, _, td) in shapes.items()}
    jopt, topt = JLAMB(strategy="arena"), TLAMB(strategy="arena")
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(2):
        g = {k: rng.randn(*s).astype(np.float32) for k, (s, _, _) in
             shapes.items()}
        jp, js = jopt.step({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = topt.step({k: torch.tensor(v) for k, v in g.items()}, ts, tp)
    assert set(ts.slots["v"]) == {"bfloat16", "float32"}
    assert tp["b"].dtype == torch.bfloat16
    for k in ("a", "c"):
        _close(tp[k].numpy(), jp[k])
    want = np.asarray(jnp.asarray(jp["b"], jnp.float32))
    diff = np.abs(tp["b"].float().numpy() - want)
    assert np.all(diff <= np.abs(want) * 2.0 ** -7)
    tm = TA.unflatten(ts.slots["m"], TA.plan(tp))
    jm = JA.unflatten(js.slots["m"], JA.plan(jp))
    for k in shapes:
        _close(tm[k].numpy(), jm[k])


def test_auto_runs_tree_and_arena_is_not_ported():
    """Pins "auto" to the JAX package's rule: the arena below
    TREE_THRESHOLD (8M) params, the tree from there up; inputs stay
    untouched; an unknown strategy raises."""
    topt = TLAMB()
    assert topt.strategy == "auto" and TLAMB.TREE_THRESHOLD == 8_000_000
    p = {"w": torch.ones(3)}
    st0 = topt.init(p)
    assert set(st0.slots["m"]) == {"float32"}                  # arena
    assert st0.slots["m"]["float32"].numel() == TA.BUFFER_MULTIPLE
    new_p, st = topt.step({"w": torch.full((3,), 0.5)}, st0, p)
    assert int(st.count) == 1 and torch.all(new_p["w"] < 1.0)
    assert torch.equal(p["w"], torch.ones(3))      # inputs untouched
    assert not st0.slots["m"]["float32"].any()
    big = {"w": torch.zeros(TLAMB.TREE_THRESHOLD - 8), "b": torch.zeros(8)}
    assert set(topt.init(big).slots["m"]) == {"w", "b"}        # tree
    assert not topt._use_tree({"w": torch.zeros(TLAMB.TREE_THRESHOLD - 1)})
    with pytest.raises(ValueError):
        TLAMB(strategy="flat")


def _small_bert_params():
    enc = jmodels.BertEncoder(100, hidden=32, layers=2, heads=2, max_len=16)
    return enc.init(jax.random.PRNGKey(0),
                    jnp.zeros((1, 16), jnp.int32))["params"]


def _port_order(carried):
    """The port's parameter order (the encoder's), for the carried dict."""
    from apex_tpu_torch import models as tmodels
    tenc = tmodels.BertEncoder(100, hidden=32, layers=2, heads=2, max_len=16,
                               device="cpu")
    return {n: carried[n] for n, _ in tenc.named_parameters()}


@pytest.mark.parametrize("strategy", ["arena", "tree"])
def test_state_carried_from_jax_continues_the_run(strategy):
    """Two JAX steps, carry params and optimizer state to the port, then
    one more step on each side: the results agree at the LAMB tolerance."""
    params = _small_bert_params()
    rng = np.random.RandomState(4)
    leaves, treedef = jax.tree_util.tree_flatten(params)

    def grads():
        return jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(rng.randn(*l.shape).astype(np.float32) * 0.1)
            for l in leaves])

    jopt = JLAMB(lr=1e-2, strategy=strategy)
    jp, js = params, jopt.init(params)
    for _ in range(2):
        jp, js = jopt.step(grads(), js, jp)
    tp = _port_order(bert_params_from_jax(jax.device_get(jp), device="cpu"))
    ts = fused_state_from_jax(jax.device_get(js), jax.device_get(jp), tp,
                              device="cpu")
    assert int(ts.count) == 2
    g = grads()
    jp, js = jopt.step(g, js, jp)
    tg = bert_params_from_jax(jax.device_get(g), device="cpu")
    tp, ts = TLAMB(lr=1e-2, strategy=strategy).step(tg, ts, tp)
    want_p = bert_params_from_jax(jax.device_get(jp), device="cpu")
    want = fused_state_from_jax(jax.device_get(js), jax.device_get(jp), tp,
                                device="cpu")
    assert int(ts.count) == int(want.count) == 3
    for k in tp:
        _close(tp[k].numpy(), want_p[k].numpy())
    for s in ("m", "v"):
        for dt, buf in want.slots[s].items():
            _close(ts.slots[s][dt].numpy(), buf.numpy())
