"""The rest of the port's amp against the JAX package's.

``amp.initialize``, the optax-style ``update`` branch of
``apply_gradients``, ``state_dict``/``load_state_dict`` (also from the JAX
package's dict), checkpoint and resume, the decorators, the module
registration that ``auto_cast`` consults, gradient accumulation
(``backward_accumulate``), the legacy ``OptimWrapper``, ``Policy.replace``
and the ``cast_*`` helpers, and ``memory_footprint`` held equal to the JAX
package's dict. Inputs come from numpy on both sides; decisions (finite
flags, scales, step counts) compare bitwise, floats at the tolerance each
test states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu.optim import FusedSGD as JSGD
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import models as tmodels
from apex_tpu_torch.optim import FusedSGD as TSGD

_W = np.random.RandomState(0).randn(4, 4).astype(np.float32)
_JH = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _jparams():
    return {"dense": {"kernel": jnp.asarray(_W),
                      "bias": jnp.zeros((4,), jnp.float32)}}


def _tparams():
    return {"dense.kernel": torch.tensor(_W), "dense.bias": torch.zeros(4)}


def _jloss(mp, x):
    y = x @ mp["dense"]["kernel"] + mp["dense"]["bias"]
    return jnp.mean(jnp.square(y))


def _tloss(mp, x):
    # f32 x against half params: JAX promotes to f32
    y = x @ mp["dense.kernel"].float() + mp["dense.bias"].float()
    return torch.mean(torch.square(y))


class SGDTx:
    """An optax-style transform (``init``/``update``, no ``step``): the
    ``update`` branch of ``apply_gradients``, as ``optax.sgd``."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return ()

    def update(self, grads, state, params):
        return {k: -self.lr * g for k, g in grads.items()}, state


# --- initialize ---------------------------------------------------------------

@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
@pytest.mark.parametrize("half", [torch.bfloat16, torch.float16])
def test_initialize_matches_jax(level, half):
    jopt, js = jamp.initialize(_jparams(), optax.sgd(0.1), level,
                               half_dtype=_JH[half], verbosity=0)
    topt, ts = tamp.initialize(_tparams(), SGDTx(0.1), level,
                               half_dtype=half, verbosity=0)
    for f in ("opt_level", "enabled", "patch_ops", "keep_batchnorm_fp32",
              "master_weights", "loss_scale"):
        assert getattr(topt.policy, f) == getattr(jopt.policy, f), f
    assert str(ts.params["dense.kernel"].dtype).replace("torch.", "") == \
        jnp.dtype(js.params["dense"]["kernel"].dtype).name
    assert int(ts.step) == int(js.step) == 0
    assert len(ts.scalers) == len(js.scalers) == 1
    if js.scalers[0] is None:
        assert ts.scalers[0] is None
    else:
        assert float(ts.scalers[0].loss_scale) == \
            float(js.scalers[0].loss_scale)


def test_initialize_prints_on_rank0_and_overrides_win(capsys):
    amp_opt, _ = tamp.initialize(_tparams(), SGDTx(0.1), "O2",
                                 loss_scale=128.0)
    out = capsys.readouterr().out
    assert "selected optimization level O2" in out
    assert "half_dtype              : bfloat16" in out
    assert "loss_scale              : 128.0" in out
    assert amp_opt.policy.loss_scale == 128.0
    tamp.initialize(_tparams(), SGDTx(0.1), "O1", verbosity=0)
    assert capsys.readouterr().out == ""
    # monitor= is ported: the state carries the Metrics tuple
    _, state = tamp.initialize(_tparams(), SGDTx(0.1), "O1", verbosity=0,
                               monitor=True)
    assert state.metrics is not None


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_update_branch_trajectory_matches_jax(level):
    """10 steps through ``apply_gradients``' optax branch (a ``tx`` with
    ``update`` and no ``step``): losses within 1e-5 relative at O0 and
    2e-2 under a half policy, every step finite, the loss falling."""
    jopt, js = jamp.initialize(_jparams(), optax.sgd(0.1), level,
                               verbosity=0)
    topt, ts = tamp.initialize(_tparams(), SGDTx(0.1), level, verbosity=0)
    x = np.ones((8, 4), np.float32)
    jstep = jax.jit(lambda s: jopt.step(s, _jloss, jnp.asarray(x)))
    jl, tl = [], []
    for _ in range(10):
        js, lj, fj = jstep(js)
        ts, lt, ft = topt.step(ts, _tloss, torch.tensor(x))
        assert bool(fj) and bool(ft)
        jl.append(float(lj))
        tl.append(float(lt))
    tol = 1e-5 if level == "O0" else 2e-2
    np.testing.assert_allclose(tl, jl, rtol=tol)
    assert tl[-1] < tl[0]
    assert int(ts.step) == int(js.step) == 10


def test_fp16_overflow_skips_step_and_multi_loss_scalers():
    amp_opt, state = tamp.initialize(_tparams(), SGDTx(0.1), "O2",
                                     half_dtype=torch.float16, num_losses=2,
                                     verbosity=0)

    def bad(mp, x):
        return torch.sum(mp["dense.kernel"]) * float("inf")

    before = state.params["dense.kernel"].clone()
    _, grads, state, finite = amp_opt.backward(state, bad, None, loss_id=1)
    state = amp_opt.apply_gradients(state, grads, finite)
    assert not bool(finite)
    assert torch.equal(state.params["dense.kernel"], before)
    assert float(state.scalers[1].loss_scale) == 2.0 ** 15
    assert float(state.scalers[0].loss_scale) == 2.0 ** 16
    assert int(state.step) == 0


# --- checkpoints --------------------------------------------------------------

def test_state_dict_roundtrip_and_jax_dict():
    jopt, js = jamp.initialize(_jparams(), optax.sgd(0.1), "O2",
                               half_dtype=jnp.float16, verbosity=0)
    topt, ts = tamp.initialize(_tparams(), SGDTx(0.1), "O2",
                               half_dtype=torch.float16, verbosity=0)
    x = np.full((2, 4), 0.01, np.float32)
    _, _, js, jf = jopt.backward(js, _jloss, jnp.asarray(x))
    _, _, ts, tf = topt.backward(ts, _tloss, torch.tensor(x))
    assert bool(tf) and bool(jf)
    sd = topt.state_dict(ts)
    assert set(sd) == set(jopt.state_dict(js)) == {"loss_scaler0"}
    fresh = topt.load_state_dict(topt.init(_tparams()), sd)
    assert float(fresh.scalers[0].loss_scale) == \
        float(ts.scalers[0].loss_scale)
    assert int(fresh.scalers[0].growth_tracker) == \
        int(ts.scalers[0].growth_tracker) == 1
    # the JAX package's dict, as numpy arrays
    jsd = jax.tree_util.tree_map(np.asarray, jopt.state_dict(js))
    from_jax = topt.load_state_dict(topt.init(_tparams()), jsd)
    s = from_jax.scalers[0]
    assert s.loss_scale.dtype == torch.float32
    assert s.growth_tracker.dtype == torch.int32
    assert float(s.loss_scale) == float(js.scalers[0].loss_scale)
    assert int(s.growth_tracker) == int(js.scalers[0].growth_tracker)


def test_checkpoint_resume_continues_bitwise():
    """3 steps, the whole state through numpy and back, 3 more: losses and
    params bitwise as the uninterrupted run's."""
    from apex_tpu_torch.optim import FusedAdam
    amp_opt, state = tamp.initialize(_tparams(), FusedAdam(lr=1e-2), "O2",
                                     verbosity=0)
    x = torch.ones(8, 4)
    for _ in range(3):
        state, _, _ = amp_opt.step(state, _tloss, x)
    from apex_tpu_torch.utils import tree_map
    restored = tree_map(lambda t: torch.from_numpy(t.numpy().copy())
                        if t.dtype != torch.bfloat16 else t.clone(), state)
    a, b = state, restored
    for _ in range(3):
        a, la, _ = amp_opt.step(a, _tloss, x)
        b, lb, _ = amp_opt.step(b, _tloss, x)
        assert torch.equal(la, lb)
    assert torch.equal(a.params["dense.kernel"], b.params["dense.kernel"])
    assert int(a.step) == int(b.step) == 6


# --- decorators and module registration ---------------------------------------

def test_half_float_promote_match_jax():
    jpol, tpol = jamp.Policy.from_opt_level("O1"), \
        tamp.Policy.from_opt_level("O1")
    jh = jamp.half_function(lambda x: x.dtype)
    jf = jamp.float_function(lambda x: x.dtype)
    jp = jamp.promote_function(lambda x, y: (x.dtype, y.dtype))
    th = tamp.half_function(lambda x: x.dtype)
    tf = tamp.float_function(lambda x: x.dtype)
    tp = tamp.promote_function(lambda x, y: (x.dtype, y.dtype))
    j32, j16 = jnp.ones(2, jnp.float32), jnp.ones(2, jnp.bfloat16)
    t32, t16 = torch.ones(2), torch.ones(2, dtype=torch.bfloat16)
    with jamp.policy_scope(jpol), tamp.policy_scope(tpol):
        assert jh(j32) == jnp.bfloat16 and th(t32) == torch.bfloat16
        assert jf(j16) == jnp.float32 and tf(t16) == torch.float32
        assert jp(j16, j32) == (jnp.float32, jnp.float32)
        assert tp(t16, t32) == (torch.float32, torch.float32)
    assert jh(j32) == jnp.float32 and th(t32) == torch.float32
    o2 = tamp.Policy.from_opt_level("O2")
    with tamp.policy_scope(o2):
        assert th(t32) == torch.bfloat16        # a cast model casts too
    with tamp.policy_scope(tamp.Policy.from_opt_level("O0")):
        assert th(t32) == torch.float32         # O0 casts nothing


def test_user_module_registration_wins_over_builtin():
    """A BatchNorm subclass registered half computes in half under O1 (the
    built-in table has BatchNorm as float); re-registering float moves it
    back, and the built-in classes keep their treatment."""
    class HalfNorm(tmodels.layers.BatchNorm):
        pass

    policy = tamp.Policy.from_opt_level("O1")
    x = torch.randn(2, 3, 3, 4)
    tamp.register_half_module(HalfNorm)
    try:
        m = HalfNorm(4, device="cpu")
        with tamp.auto_cast(policy):
            assert m(x).dtype == torch.bfloat16
            assert tmodels.layers.BatchNorm(4, device="cpu")(x).dtype == \
                torch.float32
        tamp.register_float_module(HalfNorm)
        with tamp.auto_cast(policy):
            assert m(x.to(torch.bfloat16)).dtype == torch.float32
    finally:
        from apex_tpu_torch.amp import lists
        for lst in (lists._EXTRA_HALF_MODULES, lists._EXTRA_FLOAT_MODULES):
            if HalfNorm in lst:
                lst.remove(HalfNorm)


def test_module_dtypes_under_auto_cast():
    """Embed's rows come out half; a Dense with an explicit f32 dtype stays
    f32; a Dense reused outside auto_cast computes f32 again."""
    policy = tamp.Policy.from_opt_level("O1")
    emb = tmodels.Embed(16, 8, device="cpu")
    dense = tmodels.Dense(8, 4, device="cpu")
    dense32 = tmodels.Dense(8, 4, device="cpu", dtype=torch.float32)
    x = torch.ones(2, 8)
    with tamp.auto_cast(policy):
        assert emb(torch.arange(4)).dtype == torch.bfloat16
        assert dense(x).dtype == torch.bfloat16
        assert dense32(x).dtype == torch.float32
    assert dense(x).dtype == torch.float32
    assert emb.weight.dtype == torch.float32


@pytest.mark.parametrize("kind", ["half", "float", "promote"])
def test_op_registration_matches_jax(kind):
    name = f"user_op_{kind}"
    jreg = {"half": jamp.register_half_op, "float": jamp.register_float_op,
            "promote": jamp.register_promote_op}[kind]
    treg = {"half": tamp.register_half_op, "float": tamp.register_float_op,
            "promote": tamp.register_promote_op}[kind]
    jreg(name)
    treg(name)
    try:
        from apex_tpu.amp import lists as jl
        from apex_tpu_torch.amp import lists as tl
        assert jl.classify(name) == tl.classify(name) == kind
    finally:
        jamp.unregister_op(name)
        tamp.unregister_op(name)
    assert jl.classify(name) == tl.classify(name) == "neutral"


# --- gradient accumulation ----------------------------------------------------

def _acc_setup(side, level, **over):
    params = np.arange(8.0, dtype=np.float32) / 8.0
    if side == "jax":
        policy = jamp.Policy.from_opt_level(level, **over)
        amp_opt = jamp.Amp(policy, JSGD(lr=0.1))
        return amp_opt, amp_opt.init({"w": jnp.asarray(params)})
    over = {k: ({jnp.float16: torch.float16}.get(v, v)) for k, v in
            over.items()}
    policy = tamp.Policy.from_opt_level(level, **over)
    amp_opt = tamp.Amp(policy, TSGD(lr=0.1))
    return amp_opt, amp_opt.init({"w": torch.tensor(params)})


def _jacc_loss(mp, xb):
    return jnp.sum(jnp.square(xb * mp["w"].astype(jnp.float32)))


def _tacc_loss(mp, xb):
    return torch.sum(torch.square(xb * mp["w"].float()))


_X = np.arange(32.0, dtype=np.float32).reshape(4, 8) / 32.0


@pytest.mark.parametrize("level,rtol", [("O0", 1e-6), ("O2", 1e-2)])
def test_accumulated_equals_full_batch_and_jax(level, rtol):
    """4 microbatches accumulated give the update of one backward of their
    summed loss (O0 exactly, O2 to bf16 grad precision), and the JAX
    package's accumulated update within 1e-6."""
    out = {}
    for side, loss, arr in (("jax", _jacc_loss, jnp.asarray),
                            ("torch", _tacc_loss, torch.tensor)):
        amp_opt, state = _acc_setup(side, level)
        x = arr(_X)
        acc, fin, st = None, True, state
        for i in range(4):
            _, acc, st, fin = amp_opt.backward_accumulate(
                st, loss, x[i], stashed=acc, finite=fin)
        st_acc = amp_opt.apply_gradients(st, acc, fin)
        _, g, st2, f2 = amp_opt.backward(
            state, lambda mp: sum(loss(mp, x[i]) for i in range(4)))
        st_full = amp_opt.apply_gradients(st2, g, f2)
        out[side] = np.asarray(st_acc.params["w"])
        np.testing.assert_allclose(np.asarray(st_acc.params["w"]),
                                   np.asarray(st_full.params["w"]),
                                   rtol=rtol, atol=rtol)
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=1e-6,
                               atol=1e-7)


def test_no_scaler_finite_stays_a_python_bool():
    amp_opt, state = _acc_setup("torch", "O2")
    assert amp_opt.scale_cfg is None
    _, acc, state, fin = amp_opt.backward_accumulate(
        state, _tacc_loss, torch.tensor(_X[0]), stashed=None, finite=True)
    assert fin is True
    _, acc2, state, fin = amp_opt.backward_accumulate(
        state, _tacc_loss, torch.tensor(_X[1]), stashed=acc, finite=fin)
    assert fin is True
    assert acc2["w"].dtype == torch.float32


def test_overflow_in_one_microbatch_skips_step():
    amp_opt, state = _acc_setup("torch", "O2", half_dtype=torch.float16)
    x = torch.ones(2, 8)
    acc, fin, st = None, True, state
    _, acc, st, fin = amp_opt.backward_accumulate(
        st, _tacc_loss, x[0], stashed=acc, finite=fin)
    assert isinstance(fin, torch.Tensor)
    _, acc, st, fin = amp_opt.backward_accumulate(
        st, _tacc_loss, torch.full((8,), float("inf")), stashed=acc,
        finite=fin)
    assert not bool(fin)
    stepped = amp_opt.apply_gradients(st, acc, fin)
    assert torch.equal(stepped.params["w"], state.params["w"])
    assert int(stepped.step) == 0
    # a Python False given stays false through a clean microbatch
    _, _, _, f2 = amp_opt.backward_accumulate(
        state, _tacc_loss, x[0], stashed=None, finite=False)
    assert isinstance(f2, torch.Tensor) and not bool(f2)


def test_scale_advances_between_microbatches_as_jax():
    """Growth every backward, so the two microbatches unscale at 16 and
    32; the accumulated grads are the plain gradient of the summed loss
    (1e-5), and scales and grads match the JAX package's."""
    x = np.arange(16.0, dtype=np.float32).reshape(2, 8) / 16.0
    res = {}
    for side, loss, arr, cfgmod in (
            ("jax", _jacc_loss, jnp.asarray, jamp),
            ("torch", _tacc_loss, torch.tensor, tamp)):
        amp_opt, _ = _acc_setup(side, "O2", half_dtype=jnp.float16)
        amp_opt.scale_cfg = cfgmod.LossScaleConfig(
            dynamic=True, init_scale=2.0 ** 4, growth_interval=1)
        w = np.arange(8.0, dtype=np.float32) / 8.0
        state = amp_opt.init({"w": arr(w)})
        xs = arr(x)
        acc, fin, st = None, True, state
        scales = []
        for i in range(2):
            _, acc, st, fin = amp_opt.backward_accumulate(
                st, loss, xs[i], stashed=acc, finite=fin)
            scales.append(float(st.scalers[0].loss_scale))
        res[side] = (scales, np.asarray(acc["w"]))
    assert res["torch"][0] == res["jax"][0] == [32.0, 64.0]
    w = torch.tensor(np.arange(8.0, dtype=np.float32) / 8.0,
                     requires_grad=True)
    xs = torch.tensor(x)
    ref = torch.autograd.grad(_tacc_loss({"w": w}, xs[0])
                              + _tacc_loss({"w": w}, xs[1]), w)[0]
    np.testing.assert_allclose(res["torch"][1], ref.numpy(), rtol=1e-5)
    np.testing.assert_allclose(res["torch"][1], res["jax"][1], rtol=1e-5)


def test_accumulate_loop_from_a_zero_stash():
    """The loop a ``lax.scan`` runs in JAX: a zero f32 stash and a device
    flag from the start; one applied step."""
    amp_opt, state = _acc_setup("torch", "O2")
    acc = {k: torch.zeros_like(p, dtype=torch.float32)
           for k, p in state.params.items()}
    fin, st = torch.tensor(True), state
    for xb in torch.tensor(_X):
        _, acc, st, fin = amp_opt.backward_accumulate(
            st, _tacc_loss, xb, stashed=acc, finite=fin)
    stepped = amp_opt.apply_gradients(st, acc, fin)
    assert int(stepped.step) == 1


# --- OptimWrapper -------------------------------------------------------------

def test_optim_wrapper_two_losses_matches_jax():
    # w away from 0, where the two frameworks' |w| subgradients differ
    x = np.arange(8.0, dtype=np.float32)
    w = np.arange(1.0, 9.0, dtype=np.float32) / 8.0
    jw = jamp.OptimWrapper(JSGD(lr=0.1), num_loss=2)
    jp = {"w": jnp.asarray(w)}
    jws = jw.init(jp)
    _, acc, jws = jw.backward(jws, jp, lambda p: jnp.sum(
        jnp.square(p["w"] * x)), 0, None)
    _, acc, jws = jw.backward(jws, jp, lambda p: jnp.sum(jnp.abs(p["w"])),
                              1, acc)
    jnew, jws = jw.step(jws, acc, jp)

    tw = tamp.OptimWrapper(TSGD(lr=0.1), num_loss=2)
    tp = {"w": torch.tensor(w)}
    tws = tw.init(tp)
    xt = torch.tensor(x)
    _, acc, tws = tw.backward(tws, tp, lambda p: torch.sum(
        torch.square(p["w"] * xt)), 0, None)
    _, acc, tws = tw.backward(tws, tp, lambda p: torch.sum(
        torch.abs(p["w"])), 1, acc)
    tnew, tws = tw.step(tws, acc, tp)
    np.testing.assert_allclose(tnew["w"].numpy(), np.asarray(jnew["w"]),
                               rtol=1e-6, atol=1e-7)
    ref = w - 0.1 * (2 * w * x * x + np.sign(w))
    np.testing.assert_allclose(tnew["w"].numpy(), ref, rtol=1e-5,
                               atol=1e-7)
    assert tw.loss_scale(tws) == jw.loss_scale(jws) == [2.0 ** 16] * 2


def test_optim_wrapper_overflow_skips_and_resets():
    tw = tamp.OptimWrapper(TSGD(lr=0.1), num_loss=2)
    tp = {"w": torch.ones(4)}
    tws = tw.init(tp)
    _, acc, tws = tw.backward(tws, tp, lambda p: torch.sum(p["w"]), 0, None)
    s1 = float(tws["scalers"][1].loss_scale)
    _, acc, tws = tw.backward(tws, tp, lambda p: torch.sum(p["w"])
                              * float("inf"), 1, acc)
    new_p, tws = tw.step(tws, acc, tp)
    assert torch.equal(new_p["w"], tp["w"])
    assert float(tws["scalers"][1].loss_scale) == s1 / 2
    assert float(tws["scalers"][0].loss_scale) == 2.0 ** 16
    assert bool(tws["finite"])


def test_optim_wrapper_policy_runs_under_auto_cast():
    tw = tamp.OptimWrapper(TSGD(lr=0.1), policy=tamp.Policy.from_opt_level(
        "O1"))
    tp = {"w": torch.ones(4, 4)}
    seen = {}

    def loss(p):
        seen["dt"] = torch.matmul(p["w"], p["w"]).dtype
        return torch.sum(p["w"])

    tw.backward(tw.init(tp), tp, loss, 0, None)
    assert seen["dt"] == torch.bfloat16


# --- Policy.replace, cast helpers, scaler options -----------------------------

def test_policy_replace_matches_jax():
    jp = jamp.Policy.from_opt_level("O2").replace(keep_batchnorm_fp32=False)
    tp = tamp.Policy.from_opt_level("O2").replace(keep_batchnorm_fp32=False)
    assert tp.keep_batchnorm_fp32 is jp.keep_batchnorm_fp32 is False
    assert tp.opt_level == "O2"
    with pytest.raises(ValueError):
        tamp.Policy.from_opt_level("O1").replace(half_dtype=torch.float16,
                                                 loss_scale=None)
    with pytest.raises(ValueError):
        jamp.Policy.from_opt_level("O1").replace(half_dtype=jnp.float16,
                                                 loss_scale=None)


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_cast_helpers_match_jax(level):
    jp = jamp.Policy.from_opt_level(level)
    tp = tamp.Policy.from_opt_level(level)
    jt = {"x": jnp.ones(2, jnp.float32), "h": jnp.ones(2, jnp.bfloat16),
          "i": jnp.ones(2, jnp.int32)}
    tt = {"x": torch.ones(2), "h": torch.ones(2, dtype=torch.bfloat16),
          "i": torch.ones(2, dtype=torch.int32)}
    for f in ("cast_inputs", "cast_outputs", "cast_to_compute"):
        jo, to = getattr(jp, f)(jt), getattr(tp, f)(tt)
        for k in jt:
            assert str(to[k].dtype).replace("torch.", "") == \
                jnp.dtype(jo[k].dtype).name, (f, k)


def test_unscale_keeps_dtype_without_upcast_and_stash_skips_ints():
    st = tamp.loss_scale_init(tamp.LossScaleConfig(init_scale=4.0), "cpu")
    g = {"w": torch.ones(2, dtype=torch.bfloat16) * 4}
    out, fin = tamp.unscale_grads(g, st, upcast_to=None)
    assert out["w"].dtype == torch.bfloat16 and bool(fin)
    assert torch.equal(out["w"], torch.ones(2, dtype=torch.bfloat16))
    st2 = tamp.loss_scale_init(tamp.LossScaleConfig(init_scale=2.0), "cpu")
    g = {"w": torch.ones(2) * 2, "count": torch.tensor(5, dtype=torch.int32)}
    s = {"w": torch.ones(2), "count": torch.tensor(7, dtype=torch.int32)}
    out, _ = tamp.unscale_grads_with_stashed(g, s, st2)
    assert out["count"].dtype == torch.int32
    assert torch.equal(out["w"], torch.full((2,), 2.0))


def test_value_and_scaled_grad_and_select_if_finite_match_jax():
    cfg_j, cfg_t = jamp.LossScaleConfig(), tamp.LossScaleConfig()
    jf = jamp.value_and_scaled_grad(lambda p: jnp.sum(p["w"] ** 2), cfg_j)
    tf = tamp.value_and_scaled_grad(lambda p: torch.sum(p["w"] ** 2), cfg_t)
    w = np.linspace(-1, 1, 5).astype(np.float32)
    jo, jg, js, jfin = jf({"w": jnp.asarray(w)}, jamp.loss_scale_init(cfg_j))
    to, tg, ts, tfin = tf({"w": torch.tensor(w)},
                          tamp.loss_scale_init(cfg_t, "cpu"))
    assert float(to) == float(jo) and bool(tfin) == bool(jfin)
    np.testing.assert_array_equal(tg["w"].numpy(), np.asarray(jg["w"]))
    assert int(ts.growth_tracker) == int(js.growth_tracker) == 1
    new, old = {"a": torch.ones(2)}, {"a": torch.zeros(2)}
    assert torch.equal(tamp.select_if_finite(torch.tensor(False), new,
                                             old)["a"], old["a"])
    assert tamp.select_if_finite(True, new, old) is new


# --- memory_footprint ---------------------------------------------------------

def _bert_params():
    jenc = jmodels.BertEncoder(1000, hidden=128, layers=2, heads=2,
                               max_len=64)
    jp = jax.eval_shape(lambda: jenc.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64), jnp.int32)))["params"]
    tp = dict(tmodels.BertEncoder(1000, hidden=128, layers=2, heads=2,
                                  max_len=64, device="cpu")
              .named_parameters())
    return jp, tp


def _resnet_params():
    jm = jmodels.ResNet50(num_classes=1000)
    jp = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        train=True))["params"]
    tp = dict(tmodels.ResNet50(device="meta").named_parameters())
    return jp, tp


@pytest.mark.parametrize("model", ["bert", "resnet50"])
@pytest.mark.parametrize("level,half", [("O0", torch.bfloat16),
                                        ("O1", torch.bfloat16),
                                        ("O2", torch.bfloat16),
                                        ("O2", torch.float16),
                                        ("O3", torch.bfloat16)])
def test_memory_footprint_equals_jax(model, level, half):
    jp, tp = {"bert": _bert_params, "resnet50": _resnet_params}[model]()
    kw = {"loss_scale": "dynamic"} if level == "O3" and \
        half == torch.float16 else {}
    jamp_opt = jamp.Amp(jamp.Policy.from_opt_level(
        level, half_dtype=_JH[half], **kw), optax.sgd(0.1), num_losses=2)
    tamp_opt = tamp.Amp(tamp.Policy.from_opt_level(
        level, half_dtype=half, **kw), SGDTx(0.1), num_losses=2)
    want = jamp_opt.memory_footprint(jp)
    got = tamp_opt.memory_footprint(tp)
    assert got == want
    assert got["n_params"] == sum(p.numel() for p in tp.values())
