"""The port's per-site delayed scaling against the JAX package's, bit for
bit: an amax ramp over several sites with overflow events (inf and NaN),
windows that wrap, growth limited by the interval and the factor, the
clamps, every format of the table; the events diffed from consecutive
states; the config validation; and a state carried across by
``convert.scale_history_from_jax``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.monitor.numerics import FORMAT_TABLE as JFORMATS
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import convert
from apex_tpu_torch.amp.scale_history import FORMAT_TABLE, _pow2_floor


def _ramp(steps=40, sites=5, seed=0):
    rng = np.random.RandomState(seed)
    base = np.exp(rng.randn(sites) * 3).astype(np.float32)
    amax = np.stack([base * (1.3 ** (t / 4)) * (1 + 0.5 * rng.rand(sites))
                     for t in range(steps)]).astype(np.float32)
    amax[7, 1] = np.inf
    amax[8, 1] = np.inf
    amax[13, 3] = np.nan
    amax[21, :] = np.inf
    amax[30, 0] = 0.0
    amax[31, 4] = -np.inf
    return amax


def _bits(a):
    return np.asarray(a).tobytes()


def _same(ts, js):
    for f in ("amax_history", "cursor", "scale", "growth_tracker",
              "overflow_count", "step"):
        t, j = getattr(ts, f), getattr(js, f)
        assert t.shape == tuple(np.shape(j)), f
        assert _bits(t.numpy().astype(np.asarray(j).dtype)) == _bits(j), f


def test_format_table_is_the_jax_packages():
    assert set(FORMAT_TABLE) == set(JFORMATS)
    for k, v in FORMAT_TABLE.items():
        assert tuple(v) == tuple(JFORMATS[k])


@pytest.mark.parametrize("cfg_kw", [
    dict(),
    dict(fmt="fp8_e5m2", window=4, growth_interval=3),
    dict(fmt="fp16", window=7, margin=1.0, growth_factor=4.0,
         growth_interval=2),
    dict(fmt="bf16", window=3, min_scale=2.0 ** -8, max_scale=2.0 ** 8),
    dict(fmt="fp32", window=1, backoff_factor=0.25),
], ids=["e4m3", "e5m2", "fp16", "bf16-clamped", "fp32-window1"])
def test_ramp_with_overflows_bitwise(cfg_kw):
    jcfg = jamp.ScaleHistoryConfig(**cfg_kw)
    tcfg = tamp.ScaleHistoryConfig(**cfg_kw)
    amax = _ramp()
    js = jamp.scale_history_init(jcfg, n_sites=amax.shape[1])
    ts = tamp.scale_history_init(tcfg, n_sites=amax.shape[1], device="cpu")
    sites = [f"s{i}" for i in range(amax.shape[1])]
    moved = 0
    for row in amax:
        jn = jamp.scale_history_update(js, jcfg, jnp.asarray(row))
        tn = tamp.scale_history_update(ts, tcfg, torch.tensor(row))
        _same(tn, jn)
        te = tamp.scale_update_events(ts, tn, sites, include_holds=True)
        je = jamp.scale_update_events(js, jn, sites, include_holds=True)
        assert te == je
        moved += sum(e["action"] != "hold" for e in te)
        js, ts = jn, tn
    assert moved > 0
    assert int(ts.overflow_count.sum()) == int(np.sum(~np.isfinite(amax)))


def test_pow2_floor_is_exact():
    x = torch.tensor([1.0, 1.5, 2.0, 3.999, 2.0 ** -126, 2.0 ** -130,
                      1e30, 3.4e38, 0.75], dtype=torch.float32)
    want = [1.0, 1.0, 2.0, 2.0, 2.0 ** -126, 2.0 ** -130, 2.0 ** 99,
            2.0 ** 127, 0.5]
    assert _pow2_floor(x).tolist() == want


@pytest.mark.parametrize("bad", [dict(fmt="int8"), dict(window=0),
                                 dict(backoff_factor=1.0),
                                 dict(growth_factor=0.5),
                                 dict(growth_factor=3.0),
                                 dict(min_scale=0.3)])
def test_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        jamp.scale_history_init(jamp.ScaleHistoryConfig(**bad), n_sites=2)
    with pytest.raises(ValueError):
        tamp.scale_history_init(tamp.ScaleHistoryConfig(**bad), n_sites=2,
                                device="cpu")


def test_shape_mismatch_raises():
    ts = tamp.scale_history_init(n_sites=3, device="cpu")
    with pytest.raises(ValueError, match="n_sites"):
        tamp.scale_history_update(ts, tamp.ScaleHistoryConfig(),
                                  torch.ones(2))


def test_state_carried_from_jax_continues_bitwise():
    cfg_kw = dict(window=5, growth_interval=2)
    jcfg, tcfg = (jamp.ScaleHistoryConfig(**cfg_kw),
                  tamp.ScaleHistoryConfig(**cfg_kw))
    amax = _ramp(steps=34, seed=1)
    js = jamp.scale_history_init(jcfg, n_sites=amax.shape[1])
    for row in amax[:9]:
        js = jamp.scale_history_update(js, jcfg, jnp.asarray(row))
    ts = convert.scale_history_from_jax(js, device="cpu")
    _same(ts, js)
    for row in amax[9:]:
        js = jamp.scale_history_update(js, jcfg, jnp.asarray(row))
        ts = tamp.scale_history_update(ts, tcfg, torch.tensor(row))
        _same(ts, js)
