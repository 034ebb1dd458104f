"""The distributed-dgrad conv+BN unit (``ops/conv_bn.py``) and
``ResNet(dx_distribute=...)`` against the JAX package.

- Both autograd Functions, ``conv_bn_act_train`` and
  ``conv_bn_add_act_train``, against the JAX package's custom-VJP units and
  against PyTorch autograd of conv → BN (+residual) (+ReLU), in f32 at
  kernel sizes 1 and 3, strides 1 and 2 (the uneven "SAME" pad), with and
  without ReLU, and γ = 0 at a join: outputs within atol 1e-5, gradients
  within rtol/atol 2e-4 (the JAX suite's tolerance for the same unit).
- The parameter and statistic names of ``ResNet(dx_distribute=None |
  "join" | "all")`` (and ``fused_bn=False``) equal the JAX trees', set for
  set, through ``convert``'s name map.
- A two-stage bottleneck ResNet (width 8, 10 classes, B4, 32 px) at O0 in
  each mode: loss (rtol 1e-5), logits (1e-4), every parameter gradient
  (atol 5e-3, rtol 1e-2, as ``test_torch_resnet.py``) and the new batch
  statistics (1e-5) against JAX.
- The ValueErrors for a bad mode and for ``BasicBlock``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from apex_tpu import models as jmodels
from apex_tpu import ops as jops
from apex_tpu.ops import conv_bn as JC
from apex_tpu_torch import models as tmodels
from apex_tpu_torch import ops as tops
from apex_tpu_torch.convert import params_from_jax, resnet_variables_from_jax
from apex_tpu_torch.ops import bn_act as TB
from apex_tpu_torch.ops import conv_bn as TC

from test_torch_resnet import CLASSES, S, WIDTH, _batch, _np, _variables


def _unit_inputs(seed, a_shape, k, cin, cout):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(a_shape).astype(np.float32)
    w = (rng.standard_normal(k + (cin, cout)) * 0.3).astype(np.float32)
    scale = (rng.standard_normal(cout) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.2).astype(np.float32)
    return a, w, scale, bias, rng


def _torch_oracle(a, w, scale, bias, r, strides, relu):
    """Autograd of conv → BN (centred variance) (+r) (+ReLU) in PyTorch."""
    x = TC._conv(a, w, TC.make_conv_cfg(strides=strides, relu=relu))
    return TB.bn_act_reference(x, scale, bias, residual=r, relu=relu)[0]


@pytest.mark.parametrize("ksize,strides", [
    ((1, 1), (1, 1)), ((3, 3), (1, 1)), ((3, 3), (2, 2)), ((1, 1), (2, 2)),
])
@pytest.mark.parametrize("relu", [True, False])
def test_conv_bn_act_matches_jax_and_autograd(ksize, strides, relu):
    a, w, scale, bias, rng = _unit_inputs(0, (4, 8, 8, 6), ksize, 6, 5)
    jcfg = JC.make_conv_cfg(strides=strides, relu=relu)
    jz, jvjp = jax.vjp(lambda *p: JC.conv_bn_act_train(*p, jcfg)[0],
                       jnp.asarray(a), jnp.asarray(w), jnp.asarray(scale),
                       jnp.asarray(bias))
    t = rng.standard_normal(jz.shape).astype(np.float32)
    jg = jvjp(jnp.asarray(t))

    args = [torch.tensor(a), torch.tensor(w.transpose(3, 2, 0, 1)),
            torch.tensor(scale), torch.tensor(bias)]
    args = [v.requires_grad_(True) for v in args]
    cfg = TC.make_conv_cfg(strides=strides, relu=relu)
    z, mean, var, count = TC.conv_bn_act_train(*args, cfg)
    assert count == float(np.prod(z.shape[:-1]))
    tg = torch.autograd.grad(z, args, torch.tensor(t))
    ref = _torch_oracle(*args, None, strides, relu)
    rg = torch.autograd.grad(ref, args, torch.tensor(t))
    np.testing.assert_allclose(_np(z), np.asarray(jz), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(z), _np(ref), atol=1e-5, rtol=1e-5)
    jg = [jg[0], np.asarray(jg[1]).transpose(3, 2, 0, 1), jg[2], jg[3]]
    for name, g, want, oracle in zip(["da", "dw", "dscale", "dbias"], tg, jg,
                                     rg):
        np.testing.assert_allclose(_np(g), np.asarray(want), rtol=2e-4,
                                   atol=2e-4, err_msg=name)
        np.testing.assert_allclose(_np(g), _np(oracle), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("zero_gamma", [False, True])
@pytest.mark.parametrize("ksize,strides", [((1, 1), (1, 1)),
                                           ((3, 3), (2, 2))])
def test_conv_bn_add_act_matches_jax_and_autograd(relu, zero_gamma, ksize,
                                                  strides):
    a, w, scale, bias, rng = _unit_inputs(1, (4, 8, 8, 4), ksize, 4, 8)
    if zero_gamma:
        scale = np.zeros_like(scale)
    jcfg = JC.make_conv_cfg(strides=strides, relu=relu)
    out_shape = JC._conv(jnp.asarray(a), jnp.asarray(w), jcfg).shape
    r = rng.standard_normal(out_shape).astype(np.float32)
    t = rng.standard_normal(out_shape).astype(np.float32)
    jz, jvjp = jax.vjp(lambda *p: JC.conv_bn_add_act_train(*p, jcfg)[0],
                       jnp.asarray(a), jnp.asarray(w), jnp.asarray(r),
                       jnp.asarray(scale), jnp.asarray(bias))
    jg = jvjp(jnp.asarray(t))

    args = [torch.tensor(a), torch.tensor(w.transpose(3, 2, 0, 1)),
            torch.tensor(r), torch.tensor(scale), torch.tensor(bias)]
    args = [v.requires_grad_(True) for v in args]
    cfg = TC.make_conv_cfg(strides=strides, relu=relu)
    z = TC.conv_bn_add_act_train(*args, cfg)[0]
    tg = torch.autograd.grad(z, args, torch.tensor(t))
    a_, w_, r_, s_, b_ = args
    ref = _torch_oracle(a_, w_, s_, b_, r_, strides, relu)
    rg = torch.autograd.grad(ref, args, torch.tensor(t))
    np.testing.assert_allclose(_np(z), np.asarray(jz), atol=1e-5, rtol=1e-5)
    jg = [jg[0], np.asarray(jg[1]).transpose(3, 2, 0, 1), *jg[2:]]
    for name, g, want, oracle in zip(["da", "dw", "dr", "dscale", "dbias"],
                                     tg, jg, rg):
        np.testing.assert_allclose(_np(g), np.asarray(want), rtol=2e-4,
                                   atol=2e-4, err_msg=name)
        np.testing.assert_allclose(_np(g), _np(oracle), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def _jax_names(tree):
    """Port names of a flax tree's leaves (``kernel`` → ``weight``)."""
    return {jax.tree_util.keystr(p, simple=True, separator=".")
            .replace(".kernel", ".weight")
            for p, _ in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("kw", [dict(), dict(dx_distribute="join"),
                                dict(dx_distribute="all"),
                                dict(fused_bn=False),
                                dict(fused_bn=False, dx_distribute="join")])
@pytest.mark.parametrize("stages", [[1, 1], [3, 4, 6, 3]])
def test_resnet_names_match_the_jax_tree(kw, stages):
    jm = jmodels.ResNet(stage_sizes=stages, num_classes=CLASSES, width=WIDTH,
                        **kw)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), train=True))
    tm = tmodels.ResNet(stage_sizes=stages, num_classes=CLASSES, width=WIDTH,
                        device="meta", **kw)
    assert {n for n, _ in tm.named_parameters()} == \
        _jax_names(shapes["params"])
    assert {n for n, _ in tm.named_buffers()} == \
        _jax_names(shapes["batch_stats"])


@pytest.mark.parametrize("mode", ["join", "all"])
def test_o0_dx_distribute_loss_grads_and_stats_match_jax(mode):
    jm = jmodels.ResNet(stage_sizes=[1, 1], num_classes=CLASSES, width=WIDTH,
                        dx_distribute=mode)
    tm = tmodels.ResNet(stage_sizes=[1, 1], num_classes=CLASSES, width=WIDTH,
                        dx_distribute=mode, device="cpu")
    params, bstats = _variables(jm, seed=7)
    x, y = _batch(8)

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
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tlogits, tnew = functional_call(tm, {**tp, **tbs}, (torch.tensor(x),),
                                    {"train": True})
    tl = torch.mean(tops.softmax_cross_entropy_loss(tlogits,
                                                    torch.tensor(y)))
    tg = dict(zip(tp, torch.autograd.grad(tl, list(tp.values()))))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), rtol=1e-4,
                               atol=1e-4)
    for name, g in params_from_jax(jg, device="cpu").items():
        np.testing.assert_allclose(_np(tg[name]), g.numpy(), atol=5e-3,
                                   rtol=1e-2, err_msg=name)
    _, want_bs = resnet_variables_from_jax(params, jbs, device="cpu")
    assert set(tnew) == set(want_bs)
    for name, v in want_bs.items():
        np.testing.assert_allclose(_np(tnew[name]), v.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_eval_forward_of_the_dist_units_matches_jax():
    jm = jmodels.ResNet(stage_sizes=[1, 1], num_classes=CLASSES, width=WIDTH,
                        dx_distribute="all")
    tm = tmodels.ResNet(stage_sizes=[1, 1], num_classes=CLASSES, width=WIDTH,
                        dx_distribute="all", device="cpu")
    params, bstats = _variables(jm, seed=9)
    x, _ = _batch(10)
    want = jm.apply({"params": params, "batch_stats": bstats},
                    jnp.asarray(x), train=False)
    tp, tbs = resnet_variables_from_jax(params, bstats, device="cpu")
    got = functional_call(tm, {**tp, **tbs}, (torch.tensor(x),),
                          {"train": False})
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_bad_modes_raise_value_errors():
    with pytest.raises(ValueError, match="dx_distribute"):
        tmodels.ResNet(stage_sizes=[1], dx_distribute="some", device="meta")
    with pytest.raises(ValueError, match="BottleneckBlock"):
        tmodels.ResNet18(dx_distribute="all", device="meta")
    with pytest.raises(ValueError, match="dx_distribute"):
        tmodels.BottleneckBlock(8, 8, dx_distribute="dgrad", device="meta")
    jm = jmodels.ResNet(stage_sizes=[1], num_classes=CLASSES, width=WIDTH,
                        dx_distribute="some")
    with pytest.raises(ValueError, match="dx_distribute"):
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), train=True)
    # statistics across ranks are ported: the unit carries its axis
    cfg = TC.ConvBNAct(4, 8, axis_name="data", device="meta").cfg
    assert cfg.bn().axis_name == "data"


def test_conv_bn_act_is_in_no_auto_cast_table():
    from apex_tpu_torch.amp import lists
    half, flt = lists.module_tables()
    assert not issubclass(TC.ConvBNAct, half + flt)
