"""The port's ResNet and its O2 training step against the JAX package's.

Small models (a two-stage bottleneck ResNet of width 8, and ResNet-18 of
width 8, 10 classes, 32 px, batch 4) are built by flax; their weights,
randomised so that no kernel is symmetric (a kh/kw swap would show) and
no BN is the identity, are carried to the port by
``convert.resnet_variables_from_jax``. Inputs come from numpy with a seed.
The JAX side runs its Pallas cross-entropy in interpret mode; the port
runs its plain versions.

- O0 f32: logits, loss (rtol 1e-5), every parameter gradient (atol 5e-3,
  rtol 1e-2, the JAX suite's allowance for ReLU-threshold ties) and the
  new batch statistics; the eval forward.
- O2 bf16: the params the policy casts are the JAX package's (all 161 of
  ResNet-50, BN scale and bias included); two steps of
  ``train.build_resnet_step`` track the JAX step's losses within 1e-2.
- O2 fp16 with dynamic scaling: scaler decisions match bitwise through
  one forced overflow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu import ops as jops
from apex_tpu.optim import FusedSGD as JSGD
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import models as tmodels
from apex_tpu_torch import ops as tops
from apex_tpu_torch import train
from apex_tpu_torch.convert import params_from_jax, resnet_variables_from_jax
from apex_tpu_torch.optim import FusedSGD as TSGD

B, S, CLASSES, WIDTH = 4, 32, 10, 8


def _models(kind, dtype=None):
    jd = {None: None, torch.bfloat16: jnp.bfloat16,
          torch.float16: jnp.float16}[dtype]
    if kind == "bottleneck":
        jm = jmodels.ResNet(stage_sizes=[1, 1], num_classes=CLASSES,
                            width=WIDTH, dtype=jd)
        tm = tmodels.ResNet(stage_sizes=[1, 1], num_classes=CLASSES,
                            width=WIDTH, dtype=dtype, device="cpu")
    else:
        jm = jmodels.ResNet18(num_classes=CLASSES, width=WIDTH, dtype=jd)
        tm = tmodels.ResNet18(num_classes=CLASSES, width=WIDTH, dtype=dtype,
                              device="cpu")
    return jm, tm


def _variables(jm, seed=0):
    """flax params and batch_stats, every leaf redrawn: kernels at their
    init scale with no symmetry, BN scales around 1, biases and running
    statistics nonzero."""
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), train=True)
    rng = np.random.RandomState(seed)

    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "kernel" in name:
            fan_in = int(np.prod(shape[:-1]))
            out = rng.randn(*shape) / np.sqrt(fan_in)
        elif "scale" in name:
            out = 1.0 + 0.3 * rng.randn(*shape)
        elif "var" in name:
            out = 0.5 + rng.rand(*shape)
        else:                                # bias, mean
            out = 0.2 * rng.randn(*shape)
        return jnp.asarray(out.astype(np.float32))

    return (jax.tree_util.tree_map_with_path(redraw, v["params"]),
            jax.tree_util.tree_map_with_path(redraw, v["batch_stats"]))


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, S, 3).astype(np.float32),
            rng.randint(0, CLASSES, B))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("kind", ["bottleneck", "resnet18"])
def test_o0_logits_loss_grads_and_stats_match_jax(kind):
    jm, tm = _models(kind)
    params, bstats = _variables(jm)
    x, y = _batch()

    def jloss(p):
        logits, mut = jm.apply({"params": p, "batch_stats": bstats},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        loss = jnp.mean(jops.softmax_cross_entropy_loss(
            logits, jnp.asarray(y, jnp.int32)))
        return loss, (logits, mut["batch_stats"])

    (jl, (jlogits, jbs)), jg = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    tp, tbs = resnet_variables_from_jax(params, bstats, device="cpu")
    assert set(tp) == {n for n, _ in tm.named_parameters()}
    assert set(tbs) == {n for n, _ in tm.named_buffers()}
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tlogits, tnew = functional_call(tm, {**tp, **tbs}, (torch.tensor(x),),
                                    {"train": True})
    tl = torch.mean(tops.softmax_cross_entropy_loss(tlogits,
                                                    torch.tensor(y)))
    tg = dict(zip(tp, torch.autograd.grad(tl, list(tp.values()))))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), rtol=1e-4,
                               atol=1e-4)
    want = params_from_jax(jg, device="cpu")
    for name, g in want.items():
        np.testing.assert_allclose(_np(tg[name]), g.numpy(), atol=5e-3,
                                   rtol=1e-2, err_msg=name)
    _, want_bs = resnet_variables_from_jax(params, jbs, device="cpu")
    assert set(tnew) == set(want_bs)
    for name, v in want_bs.items():
        np.testing.assert_allclose(_np(tnew[name]), v.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_eval_forward_matches_jax():
    jm, tm = _models("bottleneck")
    params, bstats = _variables(jm, seed=2)
    x, _ = _batch(3)
    want = jm.apply({"params": params, "batch_stats": bstats},
                    jnp.asarray(x), train=False)
    tp, tbs = resnet_variables_from_jax(params, bstats, device="cpu")
    got = functional_call(tm, {**tp, **tbs}, (torch.tensor(x),),
                          {"train": False})
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_resnet50_param_count_and_o2_cast_set_match_jax():
    """ResNet-50's 161 leaves (25,557,032 params) are all cast to bf16 by
    O2 in both packages: the fused BN's path components (``_BN_0``,
    ``FusedBNAct_0``) are not norm names to ``keep_batchnorm_fp32``."""
    jm = jmodels.ResNet50(num_classes=1000)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                        train=True))["params"]
    jcast = jax.eval_shape(
        jamp.Policy.from_opt_level("O2").cast_params, shapes)
    jleaves = jax.tree_util.tree_leaves_with_path(jcast)
    jbf16 = {jax.tree_util.keystr(p, simple=True, separator=".")
             .replace(".kernel", ".weight")
             for p, l in jleaves if l.dtype == jnp.bfloat16}
    tparams = dict(tmodels.ResNet50(device="meta").named_parameters())
    tcast = tamp.Policy.from_opt_level("O2").cast_params(tparams)
    tbf16 = {k for k, v in tcast.items() if v.dtype == torch.bfloat16}
    assert len(jleaves) == len(tparams) == 161
    assert sum(int(np.prod(l.shape)) for _, l in jleaves) == \
        sum(p.numel() for p in tparams.values()) == 25_557_032
    assert tbf16 == jbf16 == set(tparams)


def _jax_o2_step(jm, params, bstats, x, y, policy):
    amp_opt = jamp.Amp(policy, JSGD(lr=0.1, momentum=0.9))
    state = amp_opt.init(params)

    @jax.jit
    def step(state, bs, inject):
        def loss_fn(mp):
            logits, mut = jm.apply({"params": mp, "batch_stats": bs}, x,
                                   train=True, mutable=["batch_stats"])
            loss = jnp.mean(jops.softmax_cross_entropy_loss(logits, y))
            return loss * jnp.where(inject, jnp.inf, 1.0), \
                mut["batch_stats"]

        (loss, new_bs), grads, state, finite = amp_opt.backward(
            state, loss_fn, has_aux=True)
        return amp_opt.apply_gradients(state, grads, finite), new_bs, \
            loss, finite

    return state, step


def test_o2_bf16_two_steps_track_jax():
    """``train.build_resnet_step`` against the JAX package's
    ``bench._resnet_step_builder`` step at a small size: the same inputs
    from ``np.random.RandomState(0)``, the same weights, two steps."""
    jm, tm = _models("bottleneck", torch.bfloat16)
    params, bstats = _variables(jm, seed=4)
    tp, tbs = resnet_variables_from_jax(params, bstats, device="cpu")
    tm.load_state_dict({**tp, **tbs})
    step, (tstate, tbs), (tx, ty), policy, _ = train.build_resnet_step(
        B, S, model=tm, device="cpu")
    assert tx.dtype == torch.bfloat16 and policy.loss_scale is None
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.rand(B, S, S, 3).astype(np.float32), jnp.bfloat16)
    y = jnp.asarray(rng.randint(0, CLASSES, B), jnp.int32)
    np.testing.assert_array_equal(_np(tx), _np(x))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(y))
    jstate, jstep = _jax_o2_step(jm, params, bstats, x, y,
                                 jamp.Policy.from_opt_level("O2"))
    jbs, jl, tl = bstats, [], []
    for _ in range(2):
        jstate, jbs, jloss, _ = jstep(jstate, jbs, False)
        tstate, tbs, tloss = step(tstate, tbs, tx, ty)
        jl.append(float(jloss))
        tl.append(tloss.item())
    assert int(tstate.step) == int(jstate.step) == 2
    np.testing.assert_allclose(tl, jl, rtol=1e-2)


def test_o2_fp16_overflow_decisions_bitwise():
    jm, tm = _models("bottleneck", torch.float16)
    params, bstats = _variables(jm, seed=5)
    x, y = _batch(6)
    jpol = jamp.Policy.from_opt_level("O2", half_dtype=jnp.float16)
    tpol = tamp.Policy.from_opt_level("O2", half_dtype=torch.float16)
    jstate, jstep = _jax_o2_step(jm, params, bstats,
                                 jnp.asarray(x, jnp.float16),
                                 jnp.asarray(y, jnp.int32), jpol)
    tp, tbs = resnet_variables_from_jax(params, bstats, device="cpu")
    tapp = tamp.Amp(tpol, TSGD(lr=0.1, momentum=0.9))
    tstate = tapp.init(tp)
    tx, ty = torch.tensor(x).half(), torch.tensor(y)
    jbs = bstats
    for i, inject in enumerate([False, True, False]):
        def loss_fn(mp):
            logits, new = functional_call(tm, {**mp, **tbs}, (tx,),
                                          {"train": True})
            loss = torch.mean(tops.softmax_cross_entropy_loss(logits, ty))
            return (loss * float("inf") if inject else loss), new

        before = {k: v.clone() for k, v in tstate.params.items()}
        jstate, jbs, jloss, jfin = jstep(jstate, jbs, inject)
        (tloss, new_bs), grads, tstate, tfin = tapp.backward(
            tstate, loss_fn, has_aux=True)
        tstate = tapp.apply_gradients(tstate, grads, tfin)
        tbs = new_bs          # as the JAX step: the statistics move anyway
        assert bool(tfin) == bool(jfin) == (not inject), i
        assert np.float32(tstate.scalers[0].loss_scale.item()).tobytes() == \
            np.asarray(jstate.scalers[0].loss_scale, np.float32).tobytes()
        assert int(tstate.scalers[0].growth_tracker) == \
            int(jstate.scalers[0].growth_tracker)
        assert int(tstate.step) == int(jstate.step)
        if inject:
            assert all(torch.equal(tstate.params[k], before[k])
                       for k in before)
        else:
            np.testing.assert_allclose(tloss.item(), float(jloss), rtol=2e-2)
    assert int(tstate.step) == 2
