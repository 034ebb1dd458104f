"""The port's fp16_utils against the JAX package's.

The cases of ``tests/test_fp16_utils.py`` on the port: ``network_to_half``
and ``convert_network`` keep norm params f32 by the same names;
``prep_param_lists`` (per tensor and one flat f32 arena buffer, mixed
dtypes refused), the grad and param copies, ``clip_grad_norm`` (L2 and
Linf, ``utils.global_norm(ord=)``), ``FP16Model``; ``FP16_Optimizer``
trains, skips and backs off on an overflow, never grows past its initial
scale, clips, and round-trips through its ``state_dict`` and through
``convert.fp16_state_from_jax``; the legacy loss scalers. Decisions compare
bitwise with the JAX package's; floats at the tolerance each test states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as nn

from apex_tpu import fp16_utils as jfp
from apex_tpu import utils as jutils
from apex_tpu.optim import FusedLAMB as JLAMB
from apex_tpu.optim import FusedSGD as JSGD
from apex_tpu_torch import convert
from apex_tpu_torch import fp16_utils as tfp
from apex_tpu_torch import models as tmodels
from apex_tpu_torch import utils as tutils
from apex_tpu_torch.optim import FusedLAMB as TLAMB
from apex_tpu_torch.optim import FusedSGD as TSGD


class Net(nn.Module):
    @nn.compact
    def __call__(self, x):
        x = nn.Dense(32)(x)
        x = nn.BatchNorm(use_running_average=True)(x)
        x = nn.relu(x)
        return nn.Dense(4)(x)


@pytest.fixture(scope="module")
def params():
    v = Net().init(jax.random.PRNGKey(0), jnp.ones((8, 16)))
    return v["params"], convert.params_from_jax(v["params"], device="cpu")


def _name(k):
    return str(k).replace("torch.", "")


def _jdtypes(tree):
    return {jax.tree_util.keystr(p, simple=True, separator=".")
            .replace(".kernel", ".weight"): jnp.dtype(l.dtype).name
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("fn,dt", [("network_to_half", None),
                                   ("convert_network", "bfloat16"),
                                   ("convert_network", "float16"),
                                   ("tofp16", None)])
def test_half_casts_match_jax(params, fn, dt):
    jp, tp = params
    jargs = () if dt is None else (jnp.dtype(dt),)
    targs = () if dt is None else (getattr(torch, dt),)
    want = _jdtypes(getattr(jfp, fn)(jp, *jargs))
    got = {k: _name(v.dtype) for k, v in getattr(tfp, fn)(tp, *targs)
           .items()}
    assert got == want
    if fn != "tofp16":
        assert got["BatchNorm_0.scale"] == "float32"
        assert got["Dense_0.weight"] != "float32"


def test_prep_param_lists_roundtrip(params):
    _, tp = params
    model_p = tfp.tofp16(tp)
    model_p, masters = tfp.prep_param_lists(model_p)
    tree = masters.to_tree()
    for k, p in model_p.items():
        assert tree[k].dtype == torch.float32
        assert torch.equal(tree[k], p.float())
    back = tfp.master_params_to_model_params(masters, model_p)
    assert all(back[k].dtype == p.dtype and torch.equal(back[k], p)
               for k, p in model_p.items())


def test_prep_param_lists_flat_master(params):
    _, tp = params
    model_p, masters = tfp.prep_param_lists(tp, flat_master=True)
    assert masters.tree is None
    bufs, spec = masters.flat
    (buf,) = bufs.values()
    assert buf.dim() == 1 and buf.dtype == torch.float32
    rt = masters.to_tree()
    assert all(torch.equal(rt[k], v) for k, v in tp.items())
    half = tfp.tofp16(tp)
    _, hm = tfp.prep_param_lists(half, flat_master=True)
    (hb,) = hm.flat[0].values()
    assert hb.dtype == torch.float32
    grads = {k: torch.ones_like(v) for k, v in half.items()}
    flat = tfp.model_grads_to_master_grads(grads, hm)
    (g,) = flat.values()
    assert g.dtype == torch.float32 and g.numel() == hb.numel()
    mixed = dict(tp, **{"Dense_0.bias": tp["Dense_0.bias"].half()})
    with pytest.raises(NotImplementedError):
        tfp.prep_param_lists(mixed, flat_master=True)
    jmixed = {"a": jnp.ones(3), "b": jnp.ones(3, jnp.float16)}
    with pytest.raises(NotImplementedError):
        jfp.prep_param_lists(jmixed, flat_master=True)


def test_model_grads_to_master_grads(params):
    _, tp = params
    model_p = tfp.tofp16(tp)
    _, masters = tfp.prep_param_lists(model_p)
    mg = tfp.model_grads_to_master_grads(
        {k: torch.ones_like(v) for k, v in model_p.items()}, masters)
    assert all(g.dtype == torch.float32 for g in mg.values())


@pytest.mark.parametrize("ord_", [2, float("inf"), "inf"])
def test_global_norm_and_clip_grad_norm_match_jax(ord_):
    rng = np.random.RandomState(0)
    g = {"a": rng.randn(7).astype(np.float32),
         "b": (rng.randn(3, 5) * 4).astype(np.float32)}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = {k: torch.tensor(v) for k, v in g.items()}
    jord = jnp.inf if ord_ != 2 else 2
    jn = jutils.global_norm(jg, ord=jord)
    tn = tutils.global_norm(tg, ord=ord_)
    # Linf picks an element: bitwise; L2 sums in another order: 1e-6
    tol = 1e-6 if ord_ == 2 else 0.0
    np.testing.assert_allclose(float(tn), float(jn), rtol=tol)
    jc, jt = jfp.clip_grad_norm(jg, 1.0, norm_type=jord)
    tc, tt = tfp.clip_grad_norm(tg, 1.0, norm_type=ord_)
    np.testing.assert_allclose(float(tt), float(jt), rtol=tol)
    for k in g:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        tutils.global_norm(tg, ord=1)


def test_clip_grad_norm_l2_values():
    grads = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, norm = tfp.clip_grad_norm(grads, max_norm=1.0)
    np.testing.assert_allclose(float(norm), 10.0, rtol=1e-6)
    np.testing.assert_allclose(float(tutils.global_norm(clipped)), 1.0,
                               rtol=1e-4)
    h = {"a": torch.full((4,), 3.0, dtype=torch.float16)}
    hc, _ = tfp.clip_grad_norm(h, 1.0)
    assert hc["a"].dtype == torch.float16


def test_fp16model_casts_inputs_and_keeps_norms_f32():
    net = torch.nn.Module()
    net.dense = tmodels.Dense(16, 4, device="cpu")
    net.layer_norm = torch.nn.LayerNorm(4)
    seen = {}

    def forward(x):
        seen["x"] = x.dtype
        seen["w"] = net.dense.weight.dtype
        seen["ln"] = net.layer_norm.weight.dtype
        return net.dense(x)

    net.forward = forward
    wrapped = tfp.FP16Model(net)
    out = wrapped(torch.ones(8, 16))
    assert out.dtype == torch.float16
    assert seen == {"x": torch.float16, "w": torch.float16,
                    "ln": torch.float32}
    assert net.dense.weight.dtype == torch.float32      # storage f32
    jw = jfp.FP16Model(network=nn.Dense(4))
    jv = jw.init(jax.random.PRNGKey(0), jnp.ones((8, 16)))
    assert jw.apply(jv, jnp.ones((8, 16))).dtype == jnp.float16


def test_fp16model_matches_flax():
    jw = jfp.FP16Model(network=nn.Dense(4))
    x = np.random.RandomState(3).randn(8, 16).astype(np.float32)
    jv = jw.init(jax.random.PRNGKey(1), jnp.asarray(x))
    leaves = {jax.tree_util.keystr(p): np.asarray(l) for p, l in
              jax.tree_util.tree_leaves_with_path(jv["params"])}
    kernel = next(v for k, v in leaves.items() if "kernel" in k)
    bias = next(v for k, v in leaves.items() if "bias" in k)
    dense = tmodels.Dense(16, 4, device="cpu")
    dense.load_state_dict({"weight": torch.tensor(kernel.T.copy()),
                           "bias": torch.tensor(bias)})
    got = tfp.FP16Model(dense)(torch.tensor(x))
    want = np.asarray(jw.apply(jv, jnp.asarray(x)), np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=2e-3,
                               atol=2e-3)


# --- FP16_Optimizer -----------------------------------------------------------

def _quadratic(target, side):
    if side == "jax":
        t = jnp.asarray(target)
        return lambda mp: jnp.mean(jnp.square(mp["w"].astype(jnp.float32)
                                              - t))
    t = torch.tensor(target)
    return lambda mp: torch.mean(torch.square(mp["w"].float() - t))


def test_fp16_optimizer_trains_like_jax():
    """60 steps, static scale 128, FusedSGD(0.5, 0.9): losses within 1e-3
    relative of the JAX trajectory (the same fp16 forward and f32
    update), 1e-3 of the first at the end, 60 steps counted."""
    target = np.linspace(-1, 1, 256).astype(np.float32)
    jopt = jfp.FP16_Optimizer(JSGD(lr=0.5, momentum=0.9),
                              static_loss_scale=128.0)
    topt = tfp.FP16_Optimizer(TSGD(lr=0.5, momentum=0.9),
                              static_loss_scale=128.0)
    js = jopt.init({"w": jnp.zeros((256,), jnp.float16)})
    ts = topt.init({"w": torch.zeros(256, dtype=torch.float16)})
    jl_fn, tl_fn = _quadratic(target, "jax"), _quadratic(target, "torch")

    @jax.jit
    def jone(s):
        loss, g, fin, s = jopt.backward(s, jl_fn)
        return jopt.step(s, g, fin), loss

    jl, tl = [], []
    for _ in range(60):
        js, a = jone(js)
        loss, g, fin, ts = topt.backward(ts, tl_fn)
        ts = topt.step(ts, g, fin)
        jl.append(float(a))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-7)
    assert tl[-1] < 1e-3 * tl[0]
    assert int(ts.step) == int(js.step) == 60
    mp = topt.model_params(ts, like={"w": torch.zeros(1, dtype=torch.half)})
    assert mp["w"].dtype == torch.float16
    assert topt.model_params(ts)["w"].dtype == torch.float16


def _poisoned(side):
    if side == "jax":
        return lambda mp, poison: jnp.mean(jnp.square(
            mp["w"].astype(jnp.float32))) * jnp.where(poison, jnp.inf, 1.0)
    return lambda mp, poison: torch.mean(torch.square(mp["w"].float())) * \
        (float("inf") if poison else 1.0)


def test_fp16_optimizer_overflow_skips_and_backs_off_as_jax():
    args = {"init_scale": 2.0 ** 8}
    jopt = jfp.FP16_Optimizer(JSGD(lr=0.1), dynamic_loss_scale=True,
                              dynamic_loss_args=args)
    topt = tfp.FP16_Optimizer(TSGD(lr=0.1), dynamic_loss_scale=True,
                              dynamic_loss_args=args)
    js = jopt.init({"w": jnp.ones((128,), jnp.float16)})
    ts = topt.init({"w": torch.ones(128, dtype=torch.float16)})
    for poison in (False, True, False):
        before = ts.masters["w"].clone()
        _, g, jf, js = jopt.backward(js, _poisoned("jax"),
                                     jnp.bool_(poison))
        js = jopt.step(js, g, jf)
        _, g, tf, ts = topt.backward(ts, _poisoned("torch"), poison)
        ts = topt.step(ts, g, tf)
        assert bool(tf) == bool(jf) == (not poison)
        assert float(topt.loss_scale(ts)) == float(jopt.loss_scale(js))
        assert int(ts.step) == int(js.step)
        if poison:
            assert torch.equal(ts.masters["w"], before)
    assert float(topt.loss_scale(ts)) == 2.0 ** 7
    assert int(ts.step) == 2


def test_legacy_schedule_never_grows_past_its_start():
    topt = tfp.FP16_Optimizer(TSGD(lr=0.1), dynamic_loss_scale=True,
                              dynamic_loss_args={"scale_window": 2})
    assert topt.cfg.init_scale == topt.cfg.max_loss_scale == 2.0 ** 32
    ts = topt.init({"w": torch.full((8,), 1e-3, dtype=torch.float16)})
    scales = []
    for _ in range(6):
        _, g, fin, ts = topt.backward(ts, lambda mp: torch.sum(
            mp["w"].float()) * 1e-6)
        ts = topt.step(ts, g, fin)
        scales.append(float(topt.loss_scale(ts)))
    assert max(scales) <= 2.0 ** 32
    # monitor= is ported: the state carries the Metrics tuple
    assert tfp.FP16_Optimizer(TSGD(lr=0.1), monitor=True).init(
        {"w": torch.ones(3)}).metrics is not None


def test_clip_master_grads_matches_jax():
    rng = np.random.RandomState(4)
    g = {"a": (rng.randn(9) * 3).astype(np.float32),
         "b": rng.randn(4, 4).astype(np.float32)}
    jopt = jfp.FP16_Optimizer(JSGD(lr=0.1))
    topt = tfp.FP16_Optimizer(TSGD(lr=0.1))
    for ord_, jord in ((2, 2), (float("inf"), jnp.inf)):
        jc, jn = jopt.clip_master_grads({k: jnp.asarray(v) for k, v in
                                         g.items()}, 1.0, jord)
        tc, tn = topt.clip_master_grads({k: torch.tensor(v) for k, v in
                                         g.items()}, 1.0, ord_)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-6, atol=1e-7)


def test_fp16_optimizer_checkpoint_roundtrip_bitwise():
    target = np.linspace(0, 1, 64).astype(np.float32)
    topt = tfp.FP16_Optimizer(TSGD(lr=0.3, momentum=0.9),
                              dynamic_loss_scale=True)
    params = {"w": torch.zeros(64, dtype=torch.float16)}
    state = topt.init(params)
    loss_fn = _quadratic(target, "torch")

    def one(s):
        loss, g, fin, s = topt.backward(s, loss_fn)
        return topt.step(s, g, fin), loss

    for _ in range(5):
        state, _ = one(state)
    sd = topt.state_dict(state)
    assert set(sd) == {"loss_scaler", "first_closure_call_this_step",
                       "optimizer_state_dict", "fp32_from_fp16", "step"}
    restored = topt.load_state_dict(topt.init(params), sd)
    a, b = state, restored
    for _ in range(3):
        a, la = one(a)
        b, lb = one(b)
        assert torch.equal(la, lb)
    assert torch.equal(a.masters["w"], b.masters["w"])
    assert int(a.step) == int(b.step)
    assert float(topt.loss_scale(a)) == float(topt.loss_scale(b))


def test_fp16_state_from_jax_continues_the_jax_run():
    """A JAX FP16_Optimizer (FusedLAMB arena) after 3 steps, carried across
    by ``convert.fp16_state_from_jax``; 3 more steps on each side keep
    losses within 1e-5 relative, masters within 1e-5 of their max, and the
    scale and step equal."""
    rng = np.random.RandomState(5)
    w0 = (rng.randn(4, 8) * 0.1).astype(np.float32)
    target = rng.randn(4, 8).astype(np.float32)
    jp = {"dense": {"kernel": jnp.asarray(w0, jnp.float16)}}
    tp = {"dense.weight": torch.tensor(w0.T.copy()).half()}
    jopt = jfp.FP16_Optimizer(JLAMB(lr=1e-2, strategy="arena"),
                              dynamic_loss_scale=True,
                              dynamic_loss_args={"init_scale": 2.0 ** 10})
    topt = tfp.FP16_Optimizer(TLAMB(lr=1e-2, strategy="arena"),
                              dynamic_loss_scale=True,
                              dynamic_loss_args={"init_scale": 2.0 ** 10})
    jt, tt = jnp.asarray(target), torch.tensor(target.T.copy())

    def jloss(mp):
        return jnp.mean(jnp.square(mp["dense"]["kernel"].astype(
            jnp.float32) - jt))

    def tloss(mp):
        return torch.mean(torch.square(mp["dense.weight"].float() - tt))

    def jone(s):
        loss, g, fin, s = jopt.backward(s, jloss)
        return jopt.step(s, g, fin), loss

    js = jopt.init(jp)
    for _ in range(3):
        js, _ = jone(js)
    ts = convert.fp16_state_from_jax(js, tp, device="cpu")
    assert int(ts.step) == 3
    assert float(ts.scaler.loss_scale) == float(js.scaler.loss_scale)
    for _ in range(3):
        js, jl = jone(js)
        loss, g, fin, ts = topt.backward(ts, tloss)
        ts = topt.step(ts, g, fin)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = np.asarray(js.masters["dense"]["kernel"]).T
    np.testing.assert_allclose(ts.masters["dense.weight"].numpy(), want,
                               rtol=0, atol=1e-5 * np.abs(want).max())
    assert int(ts.step) == int(js.step) == 6


# --- the legacy loss scalers --------------------------------------------------

def test_legacy_loss_scalers_match_jax():
    js, ts = jfp.LossScaler(8.0), tfp.LossScaler(8.0, device="cpu")
    assert ts.loss_scale == js.loss_scale == 8.0
    g = {"w": np.full(3, 16.0, np.float32)}
    np.testing.assert_array_equal(
        ts.scale_gradient({"w": torch.tensor(g["w"])})["w"].numpy(),
        np.asarray(js.scale_gradient({"w": jnp.asarray(g["w"])})["w"]))
    assert float(ts.backward(torch.tensor(2.0))) == \
        float(js.backward(jnp.float32(2.0))) == 16.0
    bad = {"w": torch.tensor([1.0, float("nan")])}
    assert ts.has_overflow(bad) and not ts.has_overflow(
        {"w": torch.ones(2)})
    ts.update_scale(True)
    assert ts.loss_scale == 8.0
    jd = jfp.DynamicLossScaler(init_scale=2.0 ** 4, scale_window=2)
    td = tfp.DynamicLossScaler(init_scale=2.0 ** 4, scale_window=2,
                               device="cpu")
    assert tfp.DynamicLossScaler(device="cpu").loss_scale == 2.0 ** 32
    for overflow in (False, True, False, False, False, True, False):
        jd.update_scale(overflow)
        td.update_scale(overflow)
        assert td.loss_scale == jd.loss_scale
        assert td.loss_scale <= 2.0 ** 4
