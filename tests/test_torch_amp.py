"""Parity of apex_tpu_torch.amp with apex_tpu.amp.

Policy presets agree field for field; loss-scale schedules driven by the
same finite/overflow flag sequence agree bitwise; unscaling and the tree
helpers agree in fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import utils as jutils
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import utils as tutils

_HALF = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
         "float16": (jnp.float16, torch.float16)}
_FIELDS = ("opt_level", "enabled", "patch_ops", "keep_batchnorm_fp32",
           "master_weights", "loss_scale")


def _dtype_name(dt):
    if dt is None:
        return None
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else jnp.dtype(dt).name


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
@pytest.mark.parametrize("half", ["bfloat16", "float16"])
def test_policy_presets_match(level, half):
    jh, th = _HALF[half]
    jp = jamp.Policy.from_opt_level(level, half_dtype=jh)
    tp = tamp.Policy.from_opt_level(level, half_dtype=th)
    for f in _FIELDS:
        assert getattr(tp, f) == getattr(jp, f), f
    for f in ("half_dtype", "cast_model_type", "output_dtype",
              "compute_dtype", "param_dtype"):
        assert _dtype_name(getattr(tp, f)) == _dtype_name(getattr(jp, f)), f
    assert tp.uses_loss_scaling == jp.uses_loss_scaling


def test_policy_validation_matches():
    for kw in (dict(half_dtype=torch.float32),
               dict(loss_scale="static")):
        with pytest.raises(ValueError):
            tamp.Policy.from_opt_level("O1", **kw)
    with pytest.raises(ValueError):
        tamp.Policy.from_opt_level("O4")
    with pytest.raises(ValueError, match="underflow"):
        tamp.Policy.from_opt_level("O1", half_dtype=torch.float16,
                                   loss_scale=None)
    assert tamp.Policy.from_opt_level("O1").op_dtype("linear") == \
        torch.bfloat16
    assert tamp.Policy.from_opt_level("O1").op_dtype("softmax") == \
        torch.float32
    with pytest.raises(TypeError):
        tamp.Policy.from_opt_level("O1").op_dtype("binary_cross_entropy")


def test_cast_params_keeps_norms_fp32_under_o2():
    tp = tamp.Policy.from_opt_level("O2")
    params = {"Dense_0.weight": torch.ones(2), "layer_norm.scale":
              torch.ones(2), "bn1.bias": torch.ones(2)}
    cast = tp.cast_params(params)
    assert cast["Dense_0.weight"].dtype == torch.bfloat16
    assert cast["layer_norm.scale"].dtype == torch.float32
    assert cast["bn1.bias"].dtype == torch.float32


_FLAGS = [True, True, False, True, True, True, True, False, False, True,
          True, True, True, True]


@pytest.mark.parametrize("cfg_kw", [
    dict(),
    dict(growth_interval=3),
    dict(growth_interval=2, max_loss_scale=2.0 ** 17),
    dict(init_scale=4.0, growth_interval=50, min_loss_scale=1.0),
])
def test_loss_scale_trajectory_bitwise(cfg_kw):
    jcfg = jamp.LossScaleConfig(**cfg_kw)
    tcfg = tamp.LossScaleConfig(**cfg_kw)
    js = jamp.loss_scale_init(jcfg)
    ts = tamp.loss_scale_init(tcfg, device="cpu")
    for flag in _FLAGS:
        js = jamp.loss_scale_update(js, jnp.bool_(flag), jcfg)
        ts = tamp.loss_scale_update(ts, torch.tensor(flag), tcfg)
        assert ts.loss_scale.dtype == torch.float32
        assert ts.growth_tracker.dtype == torch.int32
        assert np.float32(ts.loss_scale.item()).tobytes() == \
            np.asarray(js.loss_scale, np.float32).tobytes()
        assert int(ts.growth_tracker) == int(js.growth_tracker)


def test_static_and_absent_scalers():
    tcfg = tamp.LossScaleConfig.from_policy_field(128.0)
    ts = tamp.loss_scale_init(tcfg, device="cpu")
    assert tamp.loss_scale_update(ts, torch.tensor(False), tcfg) is ts
    assert tamp.LossScaleConfig.from_policy_field(None) is None
    assert tamp.loss_scale_init(None) is None
    loss = torch.tensor(2.0)
    assert tamp.scale_loss(loss, None).item() == 2.0
    assert tamp.scale_loss(loss, ts).item() == 256.0


@pytest.mark.parametrize("poison", [False, True])
def test_unscale_grads_matches_jax(poison):
    rng = np.random.RandomState(0)
    grads = {"a": rng.randn(3, 4).astype(np.float32),
             "b": rng.randn(5).astype(np.float32)}
    if poison:
        grads["b"][2] = np.inf
    jcfg = jamp.LossScaleConfig()
    js = jamp.loss_scale_init(jcfg)
    ts = tamp.loss_scale_init(tamp.LossScaleConfig(), device="cpu")
    jg, jfin = jamp.unscale_grads({k: jnp.asarray(v) for k, v in
                                   grads.items()}, js)
    tg, tfin = tamp.unscale_grads({k: torch.tensor(v) for k, v in
                                   grads.items()}, ts)
    assert bool(tfin) == bool(jfin) == (not poison)
    for k in grads:
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))


def test_tree_helpers_match_jax():
    rng = np.random.RandomState(1)
    tree = {"a": rng.randn(7).astype(np.float32),
            "b": rng.randn(2, 3).astype(np.float32)}
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = {k: torch.tensor(v) for k, v in tree.items()}
    np.testing.assert_allclose(tutils.global_norm(tt).item(),
                               float(jutils.global_norm(jt)), rtol=1e-6)
    assert bool(tutils.tree_all_finite(tt))
    sel = tutils.tree_select(torch.tensor(False), tt,
                             tutils.tree_map(torch.zeros_like, tt))
    assert all(float(v.abs().sum()) == 0.0 for v in sel.values())
    assert tutils.tree_select(True, tt, None) is tt
    half = tutils.tree_cast({"x": torch.ones(2), "i": torch.ones(2,
                            dtype=torch.int32)}, torch.bfloat16)
    assert half["x"].dtype == torch.bfloat16 and half["i"].dtype == \
        torch.int32


def test_auto_cast_casts_half_modules_only():
    from apex_tpu_torch import models

    dense = models.Dense(8, 4, device="cpu")
    ln = models.FusedLayerNormModule(8, device="cpu")
    x = torch.randn(2, 8)
    assert dense(x).dtype == torch.float32
    with tamp.auto_cast(tamp.Policy.from_opt_level("O1")):
        assert dense(x).dtype == torch.bfloat16
        # the fused LN module is in neither table, as in the JAX package
        assert ln(x).dtype == torch.float32
        assert tamp.current_policy().opt_level == "O1"
    assert tamp.current_policy().enabled is False


def test_dense_explicit_dtype_wins_over_auto_cast():
    from apex_tpu_torch import models

    dense = models.Dense(8, 4, device="cpu", dtype=torch.float16)
    assert dense.weight.dtype == torch.float32
    x = torch.randn(2, 8)
    assert dense(x).dtype == torch.float16
    with tamp.auto_cast(tamp.Policy.from_opt_level("O1")):
        assert dense(x).dtype == torch.float16


def test_unported_hooks_raise():
    from apex_tpu_torch.optim import FusedLAMB

    pol = tamp.Policy.from_opt_level("O1")
    # monitor= is ported: the state carries the Metrics tuple
    assert tamp.Amp(pol, FusedLAMB(), monitor=True).init(
        {"w": torch.ones(3)}).metrics is not None
    amp_opt = tamp.Amp(pol, FusedLAMB())
    state = amp_opt.init({"w": torch.ones(3)})
    # guard=, numerics= and dynamics= are ported: the return grows the
    # hooks' states, each having folded once
    from apex_tpu_torch.monitor import dynamics as dx, numerics as nx
    ncfg, dcfg = nx.NumericsConfig(), dx.DynamicsConfig()
    ns = nx.numerics_init(ncfg, sites=amp_opt.numerics_sites(state.params),
                          device="cpu")
    ds = dx.dynamics_init(dcfg, sites=amp_opt.dynamics_sites(state.params),
                          device="cpu")
    ret = amp_opt.step(state, lambda p: p["w"].sum(), numerics=(ns, ncfg),
                       dynamics=(ds, dcfg))
    assert len(ret) == 5
    assert int(ret[3].check_count) == 1 and int(ret[4].check_count) == 1
