"""The unfused BN path, ``ResNet(fused_bn=False)``, against the JAX
package's: the autodiff oracle the JAX package keeps beside its fused unit.

Each ``_BN`` casts x and the residual to ``dtype``, runs ``BatchNorm_0``
(flax's ``nn.BatchNorm`` with the unit's momentum 0.9 and ``init_scale``),
adds the residual and applies the ReLU; autograd differentiates it. The
small models of ``test_torch_resnet.py`` (two-stage bottleneck and
ResNet-18, width 8, 10 classes, B4, 32 px) with redrawn weights:

- O0 f32: loss (rtol 1e-5), logits (1e-4), every parameter gradient (atol
  5e-3, rtol 1e-2, the JAX suite's allowance for ReLU-threshold ties) and
  the new batch statistics (running mean and biased variance, 1e-5);
- the fused and unfused models give the same loss and gradients from the
  same weights (the fused unit's ``FusedBNAct_0`` leaves renamed
  ``BatchNorm_0``; atol 1e-4: one-pass moments in both, and the fused unit's
  running variance is unbiased, so only the loss and grads are compared);
- O2's cast set at ResNet-50: ``BatchNorm_0`` leaves stay f32 in both
  packages (a norm name to ``keep_batchnorm_fp32``), every other leaf bf16;
- with ``axis_name`` the unit is ``SyncBatchNorm_0`` (ported, held across
  ranks in ``tests/test_torch_resnet_dist.py``), whose axis name raises
  when no mesh binds it.
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
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import models as tmodels
from apex_tpu_torch import ops as tops
from apex_tpu_torch.convert import params_from_jax, resnet_variables_from_jax
from apex_tpu_torch.models.resnet import _BN

from test_torch_resnet import CLASSES, WIDTH, _batch, _np, _variables


def _pair(kind):
    if kind == "bottleneck":
        return (jmodels.ResNet(stage_sizes=[1, 1], num_classes=CLASSES,
                               width=WIDTH, fused_bn=False),
                tmodels.ResNet(stage_sizes=[1, 1], num_classes=CLASSES,
                               width=WIDTH, fused_bn=False, device="cpu"))
    return (jmodels.ResNet18(num_classes=CLASSES, width=WIDTH,
                             fused_bn=False),
            tmodels.ResNet18(num_classes=CLASSES, width=WIDTH,
                             fused_bn=False, device="cpu"))


def _port_loss(tm, tp, tbs, x, y):
    tlogits, tnew = functional_call(tm, {**tp, **tbs}, (torch.tensor(x),),
                                    {"train": True})
    return torch.mean(tops.softmax_cross_entropy_loss(
        tlogits, torch.tensor(y))), tlogits, tnew


@pytest.mark.parametrize("kind", ["bottleneck", "resnet18"])
def test_o0_logits_loss_grads_and_stats_match_jax(kind):
    jm, tm = _pair(kind)
    params, bstats = _variables(jm, seed=12)
    x, y = _batch(13)

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
    assert all(".BatchNorm_0." in n for n in tbs)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tl, tlogits, tnew = _port_loss(tm, tp, tbs, x, y)
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


def test_eval_forward_matches_jax():
    jm, tm = _pair("bottleneck")
    params, bstats = _variables(jm, seed=14)
    x, _ = _batch(15)
    want = jm.apply({"params": params, "batch_stats": bstats},
                    jnp.asarray(x), train=False)
    tp, tbs = resnet_variables_from_jax(params, bstats, device="cpu")
    got = functional_call(tm, {**tp, **tbs}, (torch.tensor(x),),
                          {"train": False})
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_unfused_is_the_fused_units_autodiff_oracle():
    jm, tm = _pair("bottleneck")
    fused = tmodels.ResNet(stage_sizes=[1, 1], num_classes=CLASSES,
                           width=WIDTH, device="cpu")
    params, bstats = _variables(jm, seed=16)
    x, y = _batch(17)
    tp, tbs = resnet_variables_from_jax(params, bstats, device="cpu")
    rename = {k.replace(".BatchNorm_0.", ".FusedBNAct_0."): k for k in tp}
    grads = {}
    for model, names in ((tm, {k: k for k in tp}), (fused, rename)):
        p = {n: tp[k].clone().requires_grad_(True) for n, k in names.items()}
        bs = {n.replace(".BatchNorm_0.", ".FusedBNAct_0.") if model is fused
              else n: v for n, v in tbs.items()}
        loss = _port_loss(model, p, bs, x, y)[0]
        grads[model is fused] = (loss.item(), {
            names[n]: g for n, g in zip(p, torch.autograd.grad(
                loss, list(p.values())))})
    (lu, gu), (lf, gf) = grads[False], grads[True]
    np.testing.assert_allclose(lf, lu, rtol=1e-5)
    for name, g in gu.items():
        np.testing.assert_allclose(_np(gf[name]), _np(g), atol=1e-4,
                                   rtol=1e-3, err_msg=name)


def test_o2_keeps_unfused_bn_params_f32_as_jax():
    jm = jmodels.ResNet50(num_classes=1000, fused_bn=False)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                        train=True))["params"]
    jcast = jax.eval_shape(jamp.Policy.from_opt_level("O2").cast_params,
                           shapes)
    jf32 = {jax.tree_util.keystr(p, simple=True, separator=".")
            .replace(".kernel", ".weight")
            for p, leaf in jax.tree_util.tree_leaves_with_path(jcast)
            if leaf.dtype == jnp.float32}
    tparams = dict(tmodels.ResNet50(fused_bn=False,
                                    device="meta").named_parameters())
    tcast = tamp.Policy.from_opt_level("O2").cast_params(tparams)
    tf32 = {k for k, v in tcast.items() if v.dtype == torch.float32}
    assert tf32 == jf32 and len(tf32) == 106
    assert all(".BatchNorm_0." in k for k in tf32)


def test_axis_name_raises_naming_item_9():
    """Item 9 landed: with ``axis_name`` the unfused unit is a
    ``SyncBatchNorm_0`` (momentum 1 − 0.9 in the torch sense, scale
    ``init_scale``), and its axis name raises when no mesh binds it."""
    unit = _BN(8, axis_name="data", fused=False, init_scale=0.5,
               device="cpu")
    bn = unit.SyncBatchNorm_0
    assert bn.axis_name == "data" and abs(bn.momentum - 0.1) < 1e-12
    assert torch.equal(bn.scale, torch.full((8,), 0.5))
    model = tmodels.ResNet(stage_sizes=[1], width=8, fused_bn=False,
                           bn_axis_name="data", device="meta")
    assert any(".SyncBatchNorm_0." in n for n, _ in model.named_parameters())
    with pytest.raises(NameError, match="unbound axis name"):
        unit(torch.ones(2, 3, 3, 8), train=True, stats={})
