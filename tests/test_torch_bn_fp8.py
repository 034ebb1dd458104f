"""fp8 BN residuals (``make_cfg(fp8=True)``) against the JAX package.

Under ``fp8`` the forward saves x̂ = (x − μ)·invstd rounded to
``float8_e4m3fn`` in place of x, and the backward takes x̂ from it with no
centring: the ReLU mask is x̂₈·γ + β > 0 (z > 0 at a join), dx =
γ·invstd·(g − k1 − x̂₈·k2) in x's own dtype. The same numpy inputs go
through the JAX units (``_xres_of`` and the fp8 backward, jnp) and the
port's on the CPU (its plain versions, which take ``xhat=True``).

Tolerances: x̂₈ bit for bit, except elements whose f32 x̂ lies within two
f32 ulps of the midpoint between two e4m3 values (the two packages' f32
statistics may differ in the last bit), which are counted and at most 1%;
dx, dγ and dβ within atol 1e-5, rtol 1e-4 in f32 (sums in another order);
ReLU masks compared by their count per channel (ADVICE r5: the mask of
the rounded x̂ may differ from the forward's near 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import bn_act as JB
from apex_tpu_torch.ops import bn_act as TB

SHAPE, C = (4, 8, 8, 16), 16


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = (2.0 * rng.randn(*SHAPE) + 0.5).astype(np.float32)
    r = rng.randn(*SHAPE).astype(np.float32)
    scale = (1.0 + 0.3 * rng.randn(C)).astype(np.float32)
    bias = (0.3 * rng.randn(C)).astype(np.float32)
    dz = rng.randn(*SHAPE).astype(np.float32)
    return x, r, scale, bias, dz


def _f8(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _check_xhat8(got, want, xh32):
    """Bit for bit but near an e4m3 rounding midpoint; returns the count
    of elements that differ."""
    got, want = got.float().numpy(), _f8(want)
    bad = got != want
    mid = (got[bad] + want[bad]) / 2
    assert np.all(np.abs(xh32[bad] - mid)
                  <= 2 * np.spacing(np.abs(mid).astype(np.float32)))
    assert bad.sum() <= 0.01 * bad.size
    return int(bad.sum())


@pytest.mark.parametrize("relu,residual", [(True, False), (True, True),
                                           (False, False), (False, True)])
def test_fp8_forward_residual_and_backward_match_jax(relu, residual):
    x, r, scale, bias, dz = _inputs()
    jcfg = JB.make_cfg(relu=relu, fp8=True)
    jargs = [jnp.asarray(x)] + ([jnp.asarray(r)] if residual else []) \
        + [jnp.asarray(scale), jnp.asarray(bias)]
    junit = JB.bn_add_act_train if residual else JB.bn_act_train
    (jz, jmean, jvar, _), jvjp = jax.vjp(
        lambda *a: junit(*a, jcfg), *jargs)
    jgrads = jvjp((jnp.asarray(dz), jnp.zeros(C), jnp.zeros(C),
                   jnp.zeros(())))
    _, _, _, _, jinv = JB._fwd_common(jnp.asarray(x), jargs[1] if residual
                                      else None, jargs[-2], jargs[-1], jcfg)
    jx8 = JB._xres_of(jnp.asarray(x), jmean, jinv, jcfg)

    tcfg = TB.make_cfg(relu=relu, fp8=True)
    targs = [torch.tensor(a).requires_grad_(True) for a in
             [x] + ([r] if residual else []) + [scale, bias]]
    tunit = TB.bn_add_act_train if residual else TB.bn_act_train
    tz, tmean, tvar, _ = tunit(*targs, tcfg)
    saved = tz.grad_fn.saved_tensors[0]
    assert saved.dtype == torch.float8_e4m3fn and saved.shape == SHAPE
    tinv = torch.rsqrt(tvar + tcfg.eps)
    xh32 = ((torch.tensor(x) - tmean) * tinv).numpy()
    _check_xhat8(saved, jx8, xh32)
    tgrads = torch.autograd.grad(tz, targs, torch.tensor(dz))

    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz),
                               atol=1e-5, rtol=1e-5)
    for name, g, jg in zip(["dx", "dr", "dscale", "dbias"][:len(targs)]
                           if residual else ["dx", "dscale", "dbias"],
                           tgrads, jgrads):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("relu", [True, False])
def test_fp8_backward_differs_from_the_f32_backward_only_by_rounding(relu):
    """x̂₈ carries 3 mantissa bits: the fp8 dx is near, not equal to, the
    f32-residual dx (relative error of order 2⁻⁴ of its max) wherever the
    two backward masks agree (a flipped mask passes or stops all of g)."""
    x, _, scale, bias, dz = _inputs(1)
    grads, saved = {}, {}
    for fp8 in (False, True):
        tx = torch.tensor(x).requires_grad_(True)
        z, mean, var, _ = TB.bn_act_train(tx, torch.tensor(scale),
                                          torch.tensor(bias),
                                          TB.make_cfg(relu=relu, fp8=fp8))
        saved[fp8] = z.grad_fn.saved_tensors[0]
        grads[fp8] = torch.autograd.grad(z, tx, torch.tensor(dz))[0]
    xh = {True: saved[True].float(),
          False: (saved[False] - mean) * torch.rsqrt(var + 1e-5)}
    same = (TB._relu_mask(xh[True], torch.tensor(scale), torch.tensor(bias))
            == TB._relu_mask(xh[False], torch.tensor(scale),
                             torch.tensor(bias))) if relu else \
        torch.ones(SHAPE, dtype=torch.bool)
    diff = torch.where(same, grads[True] - grads[False], 0.0)
    err = (diff.abs().max() / grads[False].abs().max()).item()
    assert 0 < err < 0.1


def test_relu_masks_agree_in_count_with_jax_and_the_forward():
    """The backward's mask (x̂₈·γ + β > 0) per channel: the port's count
    equals JAX's; against the forward's mask (y > 0, of the f32 x̂) the
    counts differ at most by the elements within one e4m3 step of 0."""
    x, _, scale, bias, _ = _inputs(2)
    x = np.concatenate([x] * 4)                  # 1024 rows
    jcfg = JB.make_cfg(relu=True, fp8=True)
    _, jmean, _, _, jinv = JB._fwd_common(jnp.asarray(x), None,
                                          jnp.asarray(scale),
                                          jnp.asarray(bias), jcfg)
    jx8 = _f8(JB._xres_of(jnp.asarray(x), jmean, jinv, jcfg))
    tcfg = TB.make_cfg(relu=True, fp8=True)
    tz, tmean, tvar, _ = TB.bn_act_train(torch.tensor(x),
                                         torch.tensor(scale),
                                         torch.tensor(bias), tcfg)
    tx8 = tz.grad_fn.saved_tensors[0] if tz.grad_fn is not None else \
        TB._xres_of(torch.tensor(x), tmean,
                    torch.rsqrt(tvar + tcfg.eps), tcfg)
    rows = tx8.float().reshape(-1, C)
    tmask = TB._relu_mask(rows, torch.tensor(scale), torch.tensor(bias))
    jmask = (jx8.reshape(-1, C) * scale + bias) > 0
    np.testing.assert_array_equal(tmask.sum(dim=0).numpy(),
                                  jmask.sum(axis=0))
    fwd = (tz.reshape(-1, C) > 0).sum(dim=0)
    xh = ((torch.tensor(x).reshape(-1, C) - tmean)
          * torch.rsqrt(tvar + tcfg.eps))
    y = xh * torch.tensor(scale) + torch.tensor(bias)
    near = (y.abs() <= 2.0 ** -3 * (xh.abs() * torch.tensor(scale).abs()
                                    + 2.0 ** -9)).sum(dim=0)
    assert torch.all((tmask.sum(dim=0) - fwd).abs() <= near)


def test_plain_versions_take_an_e4m3_xhat():
    """``bn_sums_plain``/``bn_dx_plain`` with ``xhat=True`` read x̂ as it
    is: equal to the centred path fed (x̂₈ as f32, mean 0, invstd 1) in the
    sums, and in dx with the true invstd as the leading factor."""
    x, _, scale, bias, dz = _inputs(3)
    rows = torch.tensor(x).reshape(-1, C)
    g = torch.tensor(dz).reshape(-1, C)
    s, b = torch.tensor(scale), torch.tensor(bias)
    mean, inv = rows.mean(0), torch.rsqrt(rows.var(0, unbiased=False) + 1e-5)
    x8 = ((rows - mean) * inv).to(torch.float8_e4m3fn)
    zero, one = torch.zeros(C), torch.ones(C)
    for mode in ("plain", "relu"):
        got, _ = TB.bn_sums_plain(x8, g, None, s, b, mean, inv, mode,
                                  xhat=True)
        want, _ = TB.bn_sums_plain(x8.float(), g, None, s, b, zero, one, mode)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        dx = TB.bn_dx_plain(x8, g, s, b, mean, inv, got, rows.shape[0],
                            mode == "relu", torch.bfloat16, xhat=True)
        assert dx.dtype == torch.bfloat16
        xh = x8.float()
        gm = torch.where(xh * s + b > 0, g, 0.0) if mode == "relu" else g
        want_dx = (s * inv) * (gm - got[0] / rows.shape[0]
                               - xh * got[1] / rows.shape[0])
        torch.testing.assert_close(dx, want_dx.to(torch.bfloat16), rtol=0,
                                   atol=0)


def test_env_var_turns_fp8_on_when_the_module_is_called(monkeypatch):
    x, r, scale, bias, dz = _inputs(4)
    grads = {}
    for how in ("off", "arg", "env"):
        monkeypatch.setenv(TB.FP8_ENV, "1" if how == "env" else "0")
        mod = TB.FusedBNAct(C, relu=True, fp8_residuals=how == "arg",
                            device="cpu")
        with torch.no_grad():
            mod.scale.copy_(torch.tensor(scale))
            mod.bias.copy_(torch.tensor(bias))
        tx = torch.tensor(x).requires_grad_(True)
        z = mod(tx, torch.tensor(r), stats={})
        saved = z.grad_fn.saved_tensors[0]
        assert (saved.dtype == torch.float8_e4m3fn) == (how != "off"), how
        grads[how] = torch.autograd.grad(z, tx, torch.tensor(dz))[0]
    assert torch.equal(grads["env"], grads["arg"])
    assert not torch.equal(grads["env"], grads["off"])
    # the eval forward ignores the flag
    evals = []
    for flag in ("0", "1"):
        monkeypatch.setenv(TB.FP8_ENV, flag)
        evals.append(mod(torch.tensor(x), train=False))
    assert torch.equal(*evals)
