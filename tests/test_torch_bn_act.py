"""Parity of apex_tpu_torch.ops.bn_act with apex_tpu.ops.bn_act.

The same channels-last inputs, made from numpy with a seed, go through
the JAX unit and the port's (whose backward takes its plain versions on
CPU tensors). The JAX backward is checked both ways it runs: the jnp
two-pass default, and the Pallas sums/dx pair (``APEX_TPU_BN_PALLAS_BWD=1``,
interpret mode off the TPU, which needs M % 8 == 0).

Tolerances are the JAX suite's own (``tests/test_bn_act.py``): f32
forward at atol 1e-5, grads at atol 2e-4 / rtol 1e-4; bf16 inputs within
2% of each output's largest magnitude (a few bf16 ulps: the packages
round the f32 sums and the outputs at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import bn_act as JB
from apex_tpu_torch.ops import bn_act as TB

SHAPE = (2, 4, 5, 16)          # M = 40 rows (a multiple of 8), C = 16


def _inputs(seed=0, shape=SHAPE, zero_scale=False):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    r = (rng.randn(*shape) * 0.5).astype(np.float32)
    scale = (rng.randn(c) * 0.5 + 1.0).astype(np.float32)
    if zero_scale:
        scale[:] = 0.0
    bias = (rng.randn(c) * 0.3).astype(np.float32)
    dz = rng.randn(*shape).astype(np.float32)
    return x, r, scale, bias, dz


def _jax_unit(x, r, scale, bias, dz, relu, dtype=jnp.float32):
    """(z, mean, var, count) and the grads (dx, dr or None, dγ, dβ)."""
    cfg = JB.make_cfg(relu=relu)
    args = [jnp.asarray(x, dtype)] + ([jnp.asarray(r, dtype)]
                                      if r is not None else [])
    args += [jnp.asarray(scale), jnp.asarray(bias)]
    fn = ((lambda *a: JB.bn_add_act_train(*a, cfg)) if r is not None
          else (lambda *a: JB.bn_act_train(*a, cfg)))
    out, vjp = jax.vjp(fn, *args)
    z, mean, var, count = out
    cts = (jnp.asarray(dz, dtype), jnp.zeros_like(mean), jnp.zeros_like(var),
           jnp.zeros_like(count))
    grads = vjp(cts)
    if r is None:
        grads = (grads[0], None) + tuple(grads[1:])
    return out, grads


def _torch_unit(x, r, scale, bias, dz, relu, dtype=torch.float32):
    cfg = TB.make_cfg(relu=relu)
    tx = torch.tensor(x).to(dtype).requires_grad_(True)
    tr = None if r is None else torch.tensor(r).to(dtype).requires_grad_(True)
    ts = torch.tensor(scale).requires_grad_(True)
    tb = torch.tensor(bias).requires_grad_(True)
    if tr is None:
        out = TB.bn_act_train(tx, ts, tb, cfg)
        wrt = (tx, ts, tb)
    else:
        out = TB.bn_add_act_train(tx, tr, ts, tb, cfg)
        wrt = (tx, tr, ts, tb)
    grads = torch.autograd.grad(out[0], wrt, torch.tensor(dz).to(dtype))
    if tr is None:
        grads = (grads[0], None) + tuple(grads[1:])
    return out, grads


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_forward_matches_jax(relu, residual):
    x, r, scale, bias, dz = _inputs()
    r = r if residual else None
    (jz, jm, jv, jc), _ = _jax_unit(x, r, scale, bias, dz, relu)
    (tz, tm, tv, tc), _ = _torch_unit(x, r, scale, bias, dz, relu)
    for got, want in ((tz, jz), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    assert tc == float(jc) == 40.0
    assert not tm.requires_grad and not tv.requires_grad


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_grads_match_jax(relu, residual, pallas, monkeypatch):
    if pallas:
        monkeypatch.setenv("APEX_TPU_BN_PALLAS_BWD", "1")
    x, r, scale, bias, dz = _inputs(1)
    r = r if residual else None
    _, jg = _jax_unit(x, r, scale, bias, dz, relu)
    _, tg = _torch_unit(x, r, scale, bias, dz, relu)
    for name, got, want in zip(("dx", "dr", "dscale", "dbias"), tg, jg):
        if want is None:
            assert got is None
            continue
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-4,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
def test_zero_init_scale_grads_match_jax(pallas, monkeypatch):
    """The block's join BN at init: γ = 0, so the mask comes from z > 0
    and dx is zero."""
    if pallas:
        monkeypatch.setenv("APEX_TPU_BN_PALLAS_BWD", "1")
    x, r, scale, bias, dz = _inputs(2, zero_scale=True)
    _, jg = _jax_unit(x, r, scale, bias, dz, True)
    _, tg = _torch_unit(x, r, scale, bias, dz, True)
    assert not tg[0].any()
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("residual", [False, True])
def test_bf16_inputs_match_jax(residual):
    x, r, scale, bias, dz = _inputs(3)
    r = r if residual else None
    (jz, jm, jv, _), jg = _jax_unit(x, r, scale, bias, dz, True,
                                    jnp.bfloat16)
    (tz, tm, tv, _), tg = _torch_unit(x, r, scale, bias, dz, True,
                                      torch.bfloat16)
    assert tz.dtype == torch.bfloat16 and tg[0].dtype == torch.bfloat16
    for got, want in [(tz, jz), (tm, jm), (tv, jv)] + list(zip(tg, jg)):
        if want is None:
            continue
        want = _np(want)
        np.testing.assert_allclose(_np(got), want,
                                   atol=2e-2 * np.abs(want).max())


def test_module_running_stats_and_eval_match_jax():
    """Two training calls update the running statistics (unbiased var,
    momentum 0.9) as flax's ``mutable=["batch_stats"]`` does; the eval
    forward then normalises by them."""
    x, r, scale, bias, _ = _inputs(4)
    jmod = JB.FusedBNAct(num_features=16, relu=True)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    bstats = variables["batch_stats"]
    tmod = TB.FusedBNAct(16, relu=True, device="cpu")
    with torch.no_grad():
        tmod.scale.copy_(torch.tensor(scale))
        tmod.bias.copy_(torch.tensor(bias))
    for i in range(2):
        xi = x * (i + 1) + i
        jz, mut = jmod.apply({"params": params, "batch_stats": bstats},
                             jnp.asarray(xi), jnp.asarray(r), train=True,
                             mutable=["batch_stats"])
        bstats = mut["batch_stats"]
        stats = {}
        tz = tmod(torch.tensor(xi), torch.tensor(r), train=True, stats=stats)
        tmean, tvar = stats[tmod]
        with torch.no_grad():
            tmod.mean.copy_(tmean)
            tmod.var.copy_(tvar)
        np.testing.assert_allclose(_np(tz), _np(jz), atol=1e-5)
        np.testing.assert_allclose(_np(tmean), _np(bstats["mean"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(tvar), _np(bstats["var"]),
                                   rtol=1e-6, atol=1e-6)
    jz = jmod.apply({"params": params, "batch_stats": bstats},
                    jnp.asarray(x), jnp.asarray(r), train=False)
    tz = tmod(torch.tensor(x), torch.tensor(r), train=False)
    np.testing.assert_allclose(_np(tz), _np(jz), atol=1e-5)
    with pytest.raises(ValueError, match="stats"):
        tmod(torch.tensor(x), train=True)


def test_units_refuse_a_non_contiguous_activation():
    """A BN unit views its input as (M, C) rows: an NCHW tensor seen as
    NHWC is refused, never copied."""
    x, _, scale, bias, _ = _inputs()
    xt = torch.tensor(x).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        TB.bn_act_train(xt, torch.tensor(scale), torch.tensor(bias),
                        TB.make_cfg(relu=True))


def test_a_gradient_in_another_layout_is_copied_and_counted():
    x, _, scale, bias, dz = _inputs()
    tx = torch.tensor(x).requires_grad_(True)
    z = TB.bn_act_train(tx, torch.tensor(scale), torch.tensor(bias),
                        TB.make_cfg(relu=True))[0]
    g = torch.tensor(dz).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    before = TB.layout_copies
    got = torch.autograd.grad(z, tx, g)[0]
    assert TB.layout_copies == before + 1
    want = torch.autograd.grad(
        TB.bn_act_train(tx, torch.tensor(scale), torch.tensor(bias),
                        TB.make_cfg(relu=True))[0], tx, torch.tensor(dz))[0]
    assert torch.equal(got, want)


def test_unported_options_raise():
    """Cross-device statistics are ported (``tests/test_torch_bn_act_dist
    .py``): the config carries the axis and groups, and a unit whose axis
    name no mesh binds raises, as JAX does outside ``shard_map``. fp8
    residuals are ported (``tests/test_torch_bn_fp8.py``) too."""
    cfg = TB.make_cfg(relu=True, axis_name="data")
    assert cfg.axis_name == "data" and cfg.groups is None
    assert TB.make_cfg(relu=True, axis_index_groups=[[0, 1]]).groups == \
        ((0, 1),)
    with pytest.raises(NameError, match="unbound axis name"):
        TB.bn_act_train(torch.ones(4, 8), torch.ones(8), torch.zeros(8), cfg)
    assert TB.FusedBNAct(8, fp8_residuals=True, device="cpu").cfg.fp8
