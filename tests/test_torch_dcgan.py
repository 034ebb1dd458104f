"""The port's DCGAN and its multi-model, multi-loss amp step against the
JAX package's.

Small models (nz 16, ngf = ndf = 8, batch 4, 64x64 images) are built by
flax; their weights, redrawn so that no kernel is symmetric (an unflipped
ConvTranspose kernel would show) and no BatchNorm is the identity, are
carried to the port by ``convert.dcgan_variables_from_jax``. The JAX step is
``bench._bench_dcgan``'s ``step`` (``bench.py:289-331``), rebuilt here from
JAX functions; its FusedAdam runs the Pallas arena kernel in interpret
mode, the port's its plain version.

- f32, outside ``auto_cast``: outputs, every parameter gradient and the
  new batch statistics within 1e-5 of each tensor's largest magnitude
  (the generator's output and gradients 1e-4: see ``F32_TOL``); dropping
  the ConvTranspose flip fails that check by orders of magnitude.
- The step, three times, from the same weights and inputs: under a
  disabled policy (all f32), at O1 bf16 and at O2 bf16 (whose
  ``keep_batchnorm_fp32`` keeps the BatchNorm γ/β f32 in both packages).
- O1 fp16 with one scaler forced to overflow: all three scalers' scales
  and growth trackers match bitwise, and the skipped update holds D's
  params and count bitwise.
- G's and D's Adam state carried from JAX by ``fused_state_from_jax``
  continues the run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu.optim import FusedAdam as JAdam
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import models as tmodels
from apex_tpu_torch import train
from apex_tpu_torch.amp.scaler import LossScaleState
from apex_tpu_torch.convert import (
    dcgan_variables_from_jax, fused_state_from_jax, params_from_jax,
)

NZ, NGF, NDF, B = 16, 8, 8, 4
# The generator ends in tanh, and torch.tanh on the CPU was measured, in
# one process of six with the same input, off by 3.9e-5 at one element
# (the other elements, and every other layer, bit for bit the same): its
# output and gradients are held at 1e-4 of their max, the rest at 1e-5.
F32_TOL = {"generator": 1e-4, "discriminator": 1e-5}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _rel_err(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _models(which):
    if which == "generator":
        return (jmodels.Generator(nz=NZ, ngf=NGF),
                tmodels.Generator(nz=NZ, ngf=NGF, device="cpu"),
                jnp.zeros((1, 1, 1, NZ)))
    return (jmodels.Discriminator(ndf=NDF),
            tmodels.Discriminator(ndf=NDF, device="cpu"),
            jnp.zeros((1, 64, 64, 3)))


def _variables(jm, x0, seed):
    """flax params and batch_stats, every leaf redrawn: kernels at their
    init scale with no symmetry, BN scales around 1, biases and running
    statistics nonzero."""
    v = jm.init(jax.random.PRNGKey(0), x0, train=True)
    rng = np.random.RandomState(seed)

    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "kernel" in name:
            out = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif "scale" in name:
            out = 1.0 + 0.3 * rng.randn(*shape)
        elif "var" in name:
            out = 0.5 + rng.rand(*shape)
        else:                                  # bias, mean
            out = 0.2 * rng.randn(*shape)
        return jnp.asarray(out.astype(np.float32))

    return (jax.tree_util.tree_map_with_path(redraw, v["params"]),
            jax.tree_util.tree_map_with_path(redraw, v["batch_stats"]))


def _input(which, seed):
    rng = np.random.RandomState(seed)
    if which == "generator":
        return rng.randn(B, 1, 1, NZ).astype(np.float32)
    return rng.rand(B, 64, 64, 3).astype(np.float32)


# --- the models, f32, outside auto_cast ---------------------------------------

@pytest.mark.parametrize("which", ["generator", "discriminator"])
def test_f32_outputs_grads_and_stats_match_flax(which):
    jm, tm, x0 = _models(which)
    params, bstats = _variables(jm, x0, seed=1)
    x = _input(which, 2)
    out_shape = (B, 64, 64, 3) if which == "generator" else (B,)
    cot = np.random.RandomState(3).randn(*out_shape).astype(np.float32)

    def jloss(p):
        out, mut = jm.apply({"params": p, "batch_stats": bstats},
                            jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut["batch_stats"])

    (_, (jout, jbs)), jg = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    tp, tbs = dcgan_variables_from_jax(params, bstats, device="cpu")
    assert set(tp) == {n for n, _ in tm.named_parameters()}
    assert set(tbs) == {n for n, _ in tm.named_buffers()}
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tout, tnew = functional_call(tm, {**tp, **tbs}, (torch.tensor(x),),
                                 {"train": True})
    tg = dict(zip(tp, torch.autograd.grad((tout * torch.tensor(cot)).sum(),
                                          list(tp.values()))))
    assert tout.shape == out_shape and tout.dtype == torch.float32
    assert _rel_err(tout, jout) <= F32_TOL[which]
    for name, g in params_from_jax(jg, device="cpu").items():
        assert _rel_err(tg[name], g) <= F32_TOL[which], name
    _, want_bs = dcgan_variables_from_jax(params, jbs, device="cpu")
    assert set(tnew) == set(want_bs)
    for name, v in want_bs.items():
        assert _rel_err(tnew[name], v) <= 1e-5, name


@pytest.mark.parametrize("which", ["generator", "discriminator"])
def test_eval_forward_matches_flax(which):
    jm, tm, x0 = _models(which)
    params, bstats = _variables(jm, x0, seed=4)
    x = _input(which, 5)
    want = jm.apply({"params": params, "batch_stats": bstats},
                    jnp.asarray(x), train=False)
    tp, tbs = dcgan_variables_from_jax(params, bstats, device="cpu")
    got = functional_call(tm, {**tp, **tbs}, (torch.tensor(x),),
                          {"train": False})
    assert _rel_err(got, want) <= F32_TOL[which]


def test_generator_without_the_kernel_flip_fails():
    """The same check with the ConvTranspose kernels mapped by a plain
    transpose (no spatial flip) misses by orders of magnitude."""
    jm, tm, x0 = _models("generator")
    params, bstats = _variables(jm, x0, seed=6)
    x = torch.tensor(_input("generator", 7))
    want = jm.apply({"params": params, "batch_stats": bstats},
                    jnp.asarray(x.numpy()), train=False)
    tp, tbs = dcgan_variables_from_jax(params, bstats, device="cpu")
    unflipped = dict(tp)
    for name in tp:
        if name.startswith("ConvTranspose"):
            k = np.asarray(params[name.split(".")[0]]["kernel"])
            unflipped[name] = torch.tensor(k.transpose(2, 3, 0, 1).copy())
    err = _rel_err(functional_call(tm, {**unflipped, **tbs}, (x,),
                                   {"train": False}), want)
    assert err > 1e-2
    assert _rel_err(functional_call(tm, {**tp, **tbs}, (x,),
                                    {"train": False}), want) <= \
        F32_TOL["generator"]


@pytest.mark.parametrize("k,s,padding,hw", [
    (4, 2, "SAME", (4, 4)), (4, 1, "VALID", (1, 1)), (4, 2, "SAME", (5, 3)),
    (3, 1, "SAME", (6, 6)), (5, 2, "VALID", (3, 4)), (2, 2, "SAME", (3, 3)),
])
def test_conv_transpose_matches_flax(k, s, padding, hw):
    import flax.linen as nn

    rng = np.random.RandomState(8)
    x = rng.randn(2, *hw, 5).astype(np.float32)
    jm = nn.ConvTranspose(3, (k, k), (s, s), padding=padding, use_bias=False)
    kernel = rng.randn(k, k, 5, 3).astype(np.float32)
    want = jm.apply({"params": {"kernel": jnp.asarray(kernel)}},
                    jnp.asarray(x))
    tm = tmodels.ConvTranspose(5, 3, (k, k), (s, s), padding=padding,
                               device="cpu")
    w = params_from_jax({"ConvTranspose_0": {"kernel": kernel}},
                        device="cpu")["ConvTranspose_0.weight"]
    got = functional_call(tm, {"weight": w}, (torch.tensor(x),))
    assert got.shape == want.shape
    assert _rel_err(got, want) <= 1e-5


def test_conv_transpose_refuses_a_padding_it_cannot_express():
    with pytest.raises(ValueError, match="conv_transpose2d"):
        tmodels.ConvTranspose(4, 4, (3, 3), (2, 2), device="cpu")
    with pytest.raises(ValueError, match="SAME"):
        tmodels.ConvTranspose(4, 4, (3, 3), padding="FULL", device="cpu")


@pytest.mark.parametrize("which", ["generator", "discriminator"])
def test_o2_keeps_batchnorm_params_f32_in_both_packages(which):
    """``keep_batchnorm_fp32`` exempts the ``BatchNorm_i`` params in both
    packages (the flax name matches the norm pattern), unlike the fused BN
    unit of the ResNet; every conv kernel is cast to bf16."""
    jm, tm, x0 = _models(which)
    params = jm.init(jax.random.PRNGKey(0), x0, train=True)["params"]
    jcast = jamp.Policy.from_opt_level("O2").cast_params(params)
    jbf16 = {jax.tree_util.keystr(p, simple=True, separator=".")
             .replace(".kernel", ".weight")
             for p, l in jax.tree_util.tree_leaves_with_path(jcast)
             if l.dtype == jnp.bfloat16}
    tcast = tamp.Policy.from_opt_level("O2").cast_params(
        dict(tm.named_parameters()))
    tbf16 = {k for k, v in tcast.items() if v.dtype == torch.bfloat16}
    assert tbf16 == jbf16 == {k for k in tcast if k.endswith(".weight")}
    assert all(tcast[k].dtype == torch.float32 for k in tcast
               if k.startswith("BatchNorm"))


# --- the training step ----------------------------------------------------------

def _bce(logit, target):
    return jnp.mean(jnp.maximum(logit, 0) - logit * target
                    + jnp.log1p(jnp.exp(-jnp.abs(logit))))


def _jax_dcgan(policy, gparams, dparams, strategy="auto"):
    """``bench._bench_dcgan``'s two bundles and its step, jitted; the step
    also returns the three losses."""
    G, D = jmodels.Generator(nz=NZ, ngf=NGF), jmodels.Discriminator(ndf=NDF)
    ampG = jamp.Amp(policy, JAdam(lr=2e-4, betas=(0.5, 0.999),
                                  strategy=strategy))
    ampD = jamp.Amp(policy, JAdam(lr=2e-4, betas=(0.5, 0.999),
                                  strategy=strategy), num_losses=2)

    @jax.jit
    def step(gstate, dstate, g_bs, d_bs, z, real):
        with jamp.auto_cast(policy):
            fake, g_mut = G.apply({"params": ampG.model_params(gstate),
                                   "batch_stats": g_bs}, z, train=True,
                                  mutable=["batch_stats"])
        g_bs = g_mut["batch_stats"]

        def d_real(mp):
            with jamp.auto_cast(policy):
                out, mut = D.apply({"params": mp, "batch_stats": d_bs},
                                   real, train=True, mutable=["batch_stats"])
            return _bce(out, 1.0), mut["batch_stats"]

        (lr_, d_bs2), gr, dstate, f1 = ampD.backward(
            dstate, d_real, loss_id=0, has_aux=True)
        dstate = ampD.apply_gradients(dstate, gr, f1)

        def d_fake(mp):
            with jamp.auto_cast(policy):
                out, mut = D.apply({"params": mp, "batch_stats": d_bs2},
                                   jax.lax.stop_gradient(fake), train=True,
                                   mutable=["batch_stats"])
            return _bce(out, 0.0), mut["batch_stats"]

        (lf, d_bs3), gf, dstate, f2 = ampD.backward(
            dstate, d_fake, loss_id=1, has_aux=True)
        dstate = ampD.apply_gradients(dstate, gf, f2)

        def g_loss(mp):
            with jamp.auto_cast(policy):
                fake2, mut = G.apply({"params": mp, "batch_stats": g_bs},
                                     z, train=True, mutable=["batch_stats"])
                out = D.apply({"params": ampD.model_params(dstate),
                               "batch_stats": d_bs3}, fake2, train=True,
                              mutable=["batch_stats"])[0]
            return _bce(out.astype(jnp.float32), 1.0), mut["batch_stats"]

        (lg, g_bs4), gg, gstate, f3 = ampG.backward(
            gstate, g_loss, has_aux=True)
        gstate = ampG.apply_gradients(gstate, gg, f3)
        return gstate, dstate, g_bs4, d_bs3, (lr_, lf, lg)

    return ampG.init(gparams), ampD.init(dparams), step


def _setup(opt_level, half=torch.bfloat16, strategy="auto", **overrides):
    """Both packages' step, states and inputs from the same redrawn
    weights; the inputs are ``bench.py``'s draws from RandomState(0)."""
    jhalf = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[half]
    jG, _, gx = _models("generator")
    jD, _, dx = _models("discriminator")
    gp, gbs = _variables(jG, gx, seed=10)
    dp, dbs = _variables(jD, dx, seed=11)
    jpol = jamp.Policy.from_opt_level(opt_level, half_dtype=jhalf,
                                      **overrides)
    jgs, jds, jstep = _jax_dcgan(jpol, gp, dp, strategy)
    rng = np.random.RandomState(0)
    z = jnp.asarray(rng.randn(B, 1, 1, NZ).astype(np.float32))
    real = jnp.asarray(rng.rand(B, 64, 64, 3).astype(np.float32))

    step, (tgs, tds, tgbs, tdbs), (tz, treal), tpol, _ = \
        train.build_dcgan_step(B, opt_level, half_dtype=half, device="cpu",
                               nz=NZ, ngf=NGF, ndf=NDF, strategy=strategy,
                               **overrides)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(z))
    np.testing.assert_array_equal(treal.numpy(), np.asarray(real))
    states, stats = [], []
    for state, bs, (p, s) in ((tgs, tgbs, (gp, gbs)), (tds, tdbs, (dp, dbs))):
        tp, tbs = dcgan_variables_from_jax(p, s, device="cpu")
        assert set(tp) == set(state.params) and set(tbs) == set(bs)
        states.append(state._replace(params={k: tp[k] for k in state.params}))
        stats.append(tbs)
    return ((jgs, jds, gbs, dbs, z, real), jstep,
            (*states, *stats, tz, treal), step, tpol)


def _run(jargs, jstep, targs, tstep, steps=3, before_step=None):
    jgs, jds, jgbs, jdbs, z, real = jargs
    tgs, tds, tgbs, tdbs, tz, treal = targs
    losses = []
    for i in range(steps):
        if before_step is not None:
            (jgs, jds), (tgs, tds) = before_step(i, (jgs, jds), (tgs, tds))
        jgs, jds, jgbs, jdbs, jl = jstep(jgs, jds, jgbs, jdbs, z, real)
        tgs, tds, tgbs, tdbs, tl = tstep(tgs, tds, tgbs, tdbs, tz, treal)
        losses.append(([float(x) for x in jl], [x.item() for x in tl]))
    return (jgs, jds, jgbs, jdbs), (tgs, tds, tgbs, tdbs), losses


LR = 2e-4


def _check_states(jout, tout, p0=None, stats_tol=1e-5):
    """Steps, Adam counts, f32 masters and batch statistics of both
    packages' G and D. Without ``p0``: every param within 1e-5 of its
    tensor's max plus lr/10 (Adam divides each gradient element by its
    own RMS, so an element whose gradient is a near-cancelling sum, known
    to a few digits in f32 in either package, moves a few hundredths of lr
    apart). With the params before the steps, ``p0`` (mixed precision):
    per tensor, the two packages' params within 0.6 of the norm of the
    JAX update, ‖p − p_jax‖ ≤ 0.6·‖p_jax − p0‖; at these sizes the JAX
    package's own bf16 run lies 0.50 of it from its f32 run, and a
    missing, reversed or unscaled update lies 1 or more away."""
    (jgs, jds, jgbs, jdbs), (tgs, tds, tgbs, tdbs) = jout, tout
    for i, (js, ts) in enumerate(((jgs, tgs), (jds, tds))):
        assert int(ts.step) == int(js.step)
        assert int(ts.opt_state.count) == int(js.opt_state.count)
        want = params_from_jax(jax.device_get(js.params), device="cpu")
        assert set(want) == set(ts.params)
        for k, v in want.items():
            got = ts.params[k]
            assert got.dtype == torch.float32
            if p0 is None:
                bound = 1e-5 * v.abs().max() + 0.1 * LR
                assert (got - v).abs().max() <= bound, k
            else:
                assert (got - v).norm() <= 0.6 * (v - p0[i][k]).norm(), k
    for jbs, tbs in ((jgbs, tgbs), (jdbs, tdbs)):
        _, want = dcgan_variables_from_jax({}, jax.device_get(jbs), "cpu")
        assert set(want) == set(tbs)
        for k, v in want.items():
            assert _rel_err(tbs[k], v) <= stats_tol, k


def test_step_under_a_disabled_policy_matches_jax():
    """All f32: three steps' losses at rtol 1e-5; params (f32 masters, see
    ``_check_states``), step and Adam counts, and the batch statistics G
    and D carry (G's updated twice a step, D's real-then-fake) within 1e-5
    of each tensor's max."""
    jargs, jstep, targs, tstep, pol = _setup("O1", enabled=False)
    assert not pol.enabled
    jout, tout, losses = _run(jargs, jstep, targs, tstep)
    for jl, tl in losses:
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert int(tout[0].step) == 3 and int(tout[1].opt_state.count) == 6
    _check_states(jout, tout)


# Mixed precision: both packages round every conv output and the D-side
# BCE to bf16 (8 significant bits, 2**-8 = 3.9e-3 relative) but sum in
# another order, so a value may round one ulp apart and the next layer and
# step see that: losses within 2e-2 relative (a bf16 loss one or two ulps
# apart), batch statistics within 2e-3 of each tensor's max, params as
# ``_check_states`` states.
_MIXED_LOSS_RTOL, _MIXED_STATS_TOL = 2e-2, 2e-3


@pytest.mark.parametrize("opt_level", ["O1", "O2"])
def test_bf16_step_tracks_jax(opt_level):
    """O1: f32 params, convs in bf16, BatchNorm in f32, the D losses on
    bf16 logits (in bf16, as in the JAX step), G's on f32. O2: the convs'
    params cast to bf16 in both packages, the BatchNorm γ/β kept f32, f32
    masters."""
    jargs, jstep, targs, tstep, pol = _setup(opt_level)
    assert pol.loss_scale is None and pol.half_dtype == torch.bfloat16
    if opt_level == "O2":
        mp = {**pol.cast_params(targs[0].params),
              **pol.cast_params(targs[1].params)}
        assert {k for k, v in mp.items() if v.dtype == torch.float32} == \
            {k for k in mp if k.startswith("BatchNorm")}
    p0 = [dict(s.params) for s in targs[:2]]
    jout, tout, losses = _run(jargs, jstep, targs, tstep)
    for i, (jl, tl) in enumerate(losses):
        np.testing.assert_allclose(tl, jl, rtol=_MIXED_LOSS_RTOL,
                                   err_msg=f"step {i}")
    _check_states(jout, tout, p0, _MIXED_STATS_TOL)


def test_d_losses_are_computed_in_bf16_under_o1():
    """The D losses come out of the BCE in bf16 (its exp/log1p are not on
    O1's patch list), G's in f32: the same dtypes as the JAX step's."""
    jargs, jstep, targs, tstep, _ = _setup("O1")
    tl = tstep(*targs)[-1]
    jl = jstep(*jargs)[-1]
    assert [t.dtype for t in tl] == [torch.bfloat16] * 2 + [torch.float32]
    assert [l.dtype for l in jl] == [jnp.bfloat16] * 2 + [jnp.float32]


def test_o1_fp16_scalers_and_skipped_update_bitwise(monkeypatch):
    """O1 fp16, three scalers. The first step's D losses overflow in both
    packages (the f32 2**16 scale meets the fp16 loss's cast); before the
    third step D's ``scalers[1]`` is set to 2**24, which overflows again.
    Each step: every scaler's scale and growth tracker bitwise equal to
    the JAX step's, the steps and Adam counts equal, and each skipped D
    update leaves D's params and count bitwise as they were."""
    jargs, jstep, targs, tstep, pol = _setup("O1", half=torch.float16)
    assert pol.loss_scale == "dynamic"
    applies = []
    original = tamp.Amp.apply_gradients

    def recording(self, state, grads, finite):
        new = original(self, state, grads, finite)
        applies.append((state, new, bool(finite)))
        return new

    monkeypatch.setattr(tamp.Amp, "apply_gradients", recording)

    def overflow_d_fake(i, jstates, tstates):
        if i != 2:
            return jstates, tstates
        (jgs, jds), (tgs, tds) = jstates, tstates
        big = 2.0 ** 24
        jds = jds._replace(scalers=(jds.scalers[0], jds.scalers[1]._replace(
            loss_scale=jnp.float32(big))))
        tds = tds._replace(scalers=(tds.scalers[0], LossScaleState(
            torch.tensor(big), tds.scalers[1].growth_tracker)))
        return (jgs, jds), (tgs, tds)

    jgs, jds, jgbs, jdbs, z, real = jargs
    tgs, tds, tgbs, tdbs, tz, treal = targs
    for i in range(3):
        (jgs, jds), (tgs, tds) = overflow_d_fake(i, (jgs, jds), (tgs, tds))
        jgs, jds, jgbs, jdbs, _ = jstep(jgs, jds, jgbs, jdbs, z, real)
        tgs, tds, tgbs, tdbs, _ = tstep(tgs, tds, tgbs, tdbs, tz, treal)
        for js, ts in ((jgs, tgs), (jds, tds)):
            assert len(ts.scalers) == len(js.scalers)
            for jsc, tsc in zip(js.scalers, ts.scalers):
                assert np.float32(tsc.loss_scale.item()).tobytes() == \
                    np.asarray(jsc.loss_scale, np.float32).tobytes(), i
                assert int(tsc.growth_tracker) == int(jsc.growth_tracker), i
            assert int(ts.step) == int(js.step), i
            assert int(ts.opt_state.count) == int(js.opt_state.count), i
    finite = [f for _, _, f in applies]
    # per step: D real, D fake, G
    assert finite == [False, False, True, True, True, True,
                      True, False, True]
    scales = [s.loss_scale.item() for s in tds.scalers]
    assert scales == [2.0 ** 15, 2.0 ** 23]
    assert [int(s.growth_tracker) for s in tds.scalers] == [2, 0]
    assert tgs.scalers[0].loss_scale.item() == 2.0 ** 16
    assert int(tgs.scalers[0].growth_tracker) == 3
    for before, after, ok in applies:
        if ok:
            continue
        assert int(after.step) == int(before.step)
        assert int(after.opt_state.count) == int(before.opt_state.count)
        assert all(torch.equal(after.params[k], before.params[k])
                   for k in before.params)


@pytest.mark.parametrize("strategy", ["arena", "tree"])
def test_adam_state_carried_from_jax_continues_the_run(strategy):
    """Two JAX steps under a disabled policy, then G's and D's params,
    Adam state (flat arena buffers, or per-tensor slots), step counts and
    batch statistics are carried to the port; one more step on each side
    agrees at the f32 tolerance. G's ConvTranspose slots take the flipped
    map, so a slot mapped like a conv kernel would not match."""
    jargs, jstep, targs, tstep, _ = _setup("O1", strategy=strategy,
                                           enabled=False)
    jgs, jds, jgbs, jdbs, z, real = jargs
    for _ in range(2):
        jgs, jds, jgbs, jdbs, _ = jstep(jgs, jds, jgbs, jdbs, z, real)
    tgs, tds, _, _, tz, treal = targs
    carried = []
    for js, ts in ((jgs, tgs), (jds, tds)):
        js = jax.device_get(js)
        tp = params_from_jax(js.params, device="cpu")
        tp = {k: tp[k] for k in ts.params}
        opt = fused_state_from_jax(js.opt_state, js.params, tp, device="cpu")
        if strategy == "arena":
            assert set(opt.slots["m"]) == {"float32"}
        carried.append(ts._replace(step=torch.tensor(int(js.step)),
                                   params=tp, opt_state=opt))
    tgbs = dcgan_variables_from_jax({}, jax.device_get(jgbs), "cpu")[1]
    tdbs = dcgan_variables_from_jax({}, jax.device_get(jdbs), "cpu")[1]
    assert int(carried[0].opt_state.count) == 2
    jout, tout, losses = _run((jgs, jds, jgbs, jdbs, z, real), jstep,
                              (*carried, tgbs, tdbs, tz, treal), tstep,
                              steps=1)
    np.testing.assert_allclose(losses[0][1], losses[0][0], rtol=1e-5)
    _check_states(jout, tout)
    for js, ts in zip(jout[:2], tout[:2]):
        want = fused_state_from_jax(jax.device_get(js.opt_state),
                                    jax.device_get(js.params), ts.params,
                                    device="cpu")
        for s in ("m", "v"):
            for k, buf in want.slots[s].items():
                assert _rel_err(ts.opt_state.slots[s][k], buf) <= 1e-5, k
