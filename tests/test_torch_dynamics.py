"""The port's training-dynamics monitor (``apex_tpu_torch.monitor.dynamics``,
``.convergence`` and ``parallel.distributed.dynamics_probe``) against the
JAX package's (``tests/test_dynamics.py``'s module).

Tolerances: the GNS algebra, the report, its events and the convergence
verdicts equal the JAX package's (host float64 on the same inputs); the
fold's counters, probe EMAs and sentinels bit for bit, its norm ratios
(effective LR, update-to-weight) and the cosine/projection rows within
1e-6 relative (norms summed in other orders); the probe on two gloo ranks
within 1e-5 relative of the JAX package's ``shard_map`` probe on two CPU
devices (f32 sums of 520 squares in other orders). ``Amp.step(dynamics=)``:
losses and params bit for bit with the hook on and off at O0–O3. On two
ranks with injected noise, ``B_simple`` within 25% of the analytic
``d·σ²/|μ|²`` (``scripts/dynamics_audit.py``'s claim (a)).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_parallel_cases as C
from apex_tpu import parallel as jpar
from apex_tpu.monitor import convergence as jcv
from apex_tpu.monitor import dynamics as jdx
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import convert
from apex_tpu_torch import parallel as tpar
from apex_tpu_torch.monitor import convergence as tcv
from apex_tpu_torch.monitor import dynamics as tdx
from apex_tpu_torch.optim import FusedLAMB as TLAMB

RTOL = 1e-6
PROBE_RTOL = 1e-5
CLOSE_FIELDS = ("eff_lr", "eff_lr_ema", "uw_ratio", "cos", "proj",
                "cos_min_ema", "cos_mean_ema")


def _assert_state(ts, js, where=""):
    for f in js._fields:
        got, want = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert got.dtype == want.dtype and got.shape == want.shape, (where, f)
        if f in CLOSE_FIELDS:
            np.testing.assert_allclose(got, want, rtol=RTOL,
                                       err_msg=f"{where} {f}")
        else:
            assert got.tobytes() == want.tobytes(), (where, f, got, want)


@pytest.mark.parametrize("local_sq,pooled_sq,world,b", [
    (10.0, 4.0, 8, 4), (10.0, 4.0, 2, 1), (4.0, 4.0, 8, 4),
    (3.0, 5.0, 4, 2), (10.0, 4.0, 1, 4), (10.0, 4.0, None, 4),
    (1e-3, 9e-4, 16, 32)])
def test_gns_algebra_equals_jax(local_sq, pooled_sq, world, b):
    assert tdx._gns_estimate(local_sq, pooled_sq, world, b) == \
        jdx._gns_estimate(local_sq, pooled_sq, world, b)


def _probe_inputs(world, seed):
    rng = np.random.RandomState(seed)
    lsqs = (rng.rand(world) * 5 + 1).astype(np.float32)
    dots = (rng.randn(world) * 2).astype(np.float32)
    return (np.float32(lsqs.mean()), np.float32(rng.rand() * 3 + 0.5),
            lsqs, dots)


def _probes(world, seed):
    lsm, psq, lsqs, dots = _probe_inputs(world, seed)
    jp = jdx.DynamicsProbe(jnp.float32(lsm), jnp.float32(psq),
                           jnp.asarray(lsqs), jnp.asarray(dots),
                           jnp.float32(world))
    tp = tdx.DynamicsProbe(torch.tensor(lsm), torch.tensor(psq),
                           torch.tensor(lsqs), torch.tensor(dots),
                           torch.tensor(float(world)))
    return jp, tp


def _trees(rng_seed, scale):
    rng = np.random.RandomState(rng_seed)
    u = {"w": rng.randn(32, 8).astype(np.float32) * scale,
         "b": rng.randn(8).astype(np.float32) * scale}
    g = {"w": rng.randn(32, 8).astype(np.float32),
         "b": rng.randn(8).astype(np.float32)}
    w = {"w": rng.randn(32, 8).astype(np.float32) * 3}
    j = ({"upd": {k: jnp.asarray(v) for k, v in u.items()},
          "other": jnp.asarray(u["b"])},
         {"upd": {k: jnp.asarray(v) for k, v in g.items()}},
         {"other": jnp.asarray(w["w"][0])})
    t = ({"upd": {k: torch.tensor(v) for k, v in u.items()},
          "other": torch.tensor(u["b"])},
         {"upd": {k: torch.tensor(v) for k, v in g.items()}},
         {"other": torch.tensor(w["w"][0])})
    return j, t


@pytest.mark.parametrize("check_every", [1, 2])
def test_observe_matches_jax(check_every):
    world = 4
    jcfg = jdx.DynamicsConfig(check_every=check_every, ema=0.8,
                              local_batch=2)
    tcfg = tdx.DynamicsConfig(check_every=check_every, ema=0.8,
                              local_batch=2)
    (jt, _, _), (tt, _, _) = _trees(0, 1.0)
    sites = tdx.site_names(tt)
    assert sites == jdx.site_names(jt)
    js = jdx.dynamics_init(jcfg, sites=sites, world=world)
    ts = tdx.dynamics_init(tcfg, sites=sites, world=world, device="cpu")
    _assert_state(ts, js, "init")

    @jax.jit
    def jobs(s, trees, grads, weights, probe):
        return jdx.dynamics_observe(s, jcfg, trees, probe=probe,
                                    grads=grads, weights=weights)

    for i in range(6):
        (jt, jg, jw), (tt, tg, tw) = _trees(i, 0.1 * (i + 1))
        jp, tp = _probes(world, i)
        if i < 2:                 # the first folds run without a probe
            js = jax.jit(lambda s, a, b, c: jdx.dynamics_observe(
                s, jcfg, a, grads=b, weights=c))(js, jt, jg, jw)
            ts = tdx.dynamics_observe(ts, tcfg, tt, grads=tg, weights=tw)
        else:
            js = jobs(js, jt, jg, jw, jp)
            ts = tdx.dynamics_observe(ts, tcfg, tt, grads=tg, weights=tw,
                                      probe=lambda: tp)
        _assert_state(ts, js, f"step {i}")
    sites = list(sites)
    eff = ts.eff_lr_ema.numpy()
    assert eff[sites.index("other")] == -1.0
    assert ts.uw_ratio.numpy()[sites.index("upd/['w']")] == -1.0


def test_observe_refusals():
    cfg = tdx.DynamicsConfig()
    ts = tdx.dynamics_init(cfg, sites=("a",), world=2, device="cpu")
    with pytest.raises(ValueError, match="world=3"):
        _, tp = _probes(3, 0)
        tdx.dynamics_observe(ts, cfg, {"a": torch.ones(3)}, probe=tp)
    with pytest.raises(ValueError, match="no matching tree"):
        tdx.dynamics_observe(ts, cfg, {"a": torch.ones(3)},
                             grads={"b": torch.ones(3)})
    for bad in (tdx.DynamicsConfig(check_every=0),
                tdx.DynamicsConfig(local_batch=0)):
        with pytest.raises(ValueError):
            tdx.dynamics_init(bad, sites=("a",), device="cpu")


def _jax_state_after(steps, world=4, check_every=1):
    cfg = jdx.DynamicsConfig(check_every=check_every, local_batch=2)
    (jt, _, _), _ = _trees(0, 1.0)
    sites = jdx.site_names(jt)
    js = jdx.dynamics_init(cfg, sites=sites, world=world)
    for i in range(steps):
        (jt, jg, jw), _ = _trees(i, 0.1 * (i + 1))
        jp, _ = _probes(world, i)
        js = jdx.dynamics_observe(js, cfg, jt, probe=jp, grads=jg,
                                  weights=jw)
    return js, sites


def test_state_carried_from_jax_then_one_more_step():
    js, sites = _jax_state_after(3, check_every=2)
    ts = convert.dynamics_state_from_jax(jax.device_get(js), device="cpu")
    _assert_state(ts, js, "carried")
    cfg_j = jdx.DynamicsConfig(check_every=2, local_batch=2)
    cfg_t = tdx.DynamicsConfig(check_every=2, local_batch=2)
    for i in (3, 4):
        (jt, jg, jw), (tt, tg, tw) = _trees(i, 0.5)
        jp, tp = _probes(4, i)
        js = jdx.dynamics_observe(js, cfg_j, jt, probe=jp, grads=jg,
                                  weights=jw)
        ts = tdx.dynamics_observe(ts, cfg_t, tt, probe=tp, grads=tg,
                                  weights=tw)
        _assert_state(ts, js, f"step {i}")


@pytest.mark.parametrize("outlier_z", [3.5, 0.5])
def test_report_and_events_match_jax(outlier_z):
    from scripts.check_metrics_schema import check_dynamics_lines
    js, sites = _jax_state_after(4)
    ts = convert.dynamics_state_from_jax(jax.device_get(js), device="cpu")
    stats = tdx.stats_from_json(jdx.stats_to_json(js, sites,
                                                  local_batch=2))
    for src in (ts, stats):
        rep = tdx.dynamics_report(src, None if src is stats else sites,
                                  local_batch=2, outlier_z=outlier_z)
        want = jdx.dynamics_report(js, sites, local_batch=2,
                                   outlier_z=outlier_z)
        for f in ("step", "check_count", "world", "gns", "b_crit", "g2_est",
                  "s_est", "cos_min", "cos_mean", "sites",
                  "eff_lr_outliers"):
            a, b = getattr(rep, f), getattr(want, f)
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=RTOL), f
            else:
                assert a == b, f
        assert rep.fingerprint == want.fingerprint == "dynamics|gns|global"
        assert rep.to_events()[0].keys() == want.to_events()[0].keys()
    assert tdx.stats_to_json(ts, sites, local_batch=2) == \
        jdx.stats_to_json(js, sites, local_batch=2)
    ev = tdx.check_events(ts, sites, local_batch=2)
    jev = jdx.check_events(js, sites, local_batch=2)
    assert [e["kind"] for e in ev] == [e["kind"] for e in jev]
    assert [e["site"] for e in ev[:-1]] == [e["site"] for e in jev[:-1]]
    assert check_dynamics_lines([json.dumps(e) for e in ev]) == []


# --- the convergence comparator ----------------------------------------------------

def _trajectories():
    rng = np.random.RandomState(5)
    base = 3.0 * np.exp(-np.arange(60) / 20.0)
    runs = [list(base + 0.01 * rng.randn(60)) for _ in range(3)]
    twin = list(base + 0.01 * rng.randn(60))
    jolt = list(base + 0.01 * rng.randn(60))
    for t in range(37, 60):
        jolt[t] += 0.05 * (t - 36)
    return runs, twin, jolt


@pytest.mark.parametrize("z,grace", [(8.0, 10), (6.0, 0), (3.0, 5)])
def test_convergence_matches_jax(z, grace):
    from scripts.check_metrics_schema import check_dynamics_lines
    runs, twin, jolt = _trajectories()
    band_t = tcv.calibrate_band(runs, z=z)
    band_j = jcv.calibrate_band(runs, z=z)
    assert band_t.to_json() == band_j.to_json()
    assert tcv.Band.from_json(band_t.to_json()) == band_t
    for other in (twin, jolt, jolt[:30] + [float("nan")] + jolt[31:]):
        got = tcv.convergence_report(runs[0], other, band=band_t,
                                     grace=grace)
        want = jcv.convergence_report(runs[0], other, band=band_j,
                                      grace=grace)
        assert (got.verdict, got.first_flag_step, got.n_flagged) == \
            (want.verdict, want.first_flag_step, want.n_flagged)
        assert got.to_event() == want.to_event()
        assert got.summary() == want.summary()
        assert check_dynamics_lines([json.dumps(got.to_event())]) == []
    got = tcv.convergence_report(runs[0], jolt, calibration=runs, z=z)
    assert got.first_flag_step == jcv.convergence_report(
        runs[0], jolt, calibration=runs, z=z).first_flag_step
    with pytest.raises(ValueError):
        tcv.calibrate_band(runs[:1])


# --- Amp.step(dynamics=) ----------------------------------------------------------

def _amp_run(opt_level, observe, steps=6):
    rng = np.random.RandomState(0)
    params = {"w": torch.tensor(rng.randn(16, 4).astype(np.float32) * 0.1),
              "b": torch.zeros(4)}
    x = torch.tensor(rng.randn(8, 16).astype(np.float32))
    y = torch.tensor(rng.randn(8, 4).astype(np.float32))
    app, state = tamp.initialize(params, TLAMB(lr=1e-2, strategy="arena"),
                                 opt_level, verbosity=0)
    cfg = tdx.DynamicsConfig(check_every=2)
    ds = tdx.dynamics_init(cfg, sites=app.dynamics_sites(state.params),
                           device="cpu")

    def loss_fn(mp):
        out = x.to(mp["w"].dtype) @ mp["w"] + mp["b"]
        return torch.mean(torch.square(out.float() - y))

    losses = []
    for _ in range(steps):
        if observe:
            state, loss, _fin, ds = app.step(state, loss_fn,
                                             dynamics=(ds, cfg))
        else:
            state, loss, _fin = app.step(state, loss_fn)
        losses.append(loss.detach().numpy().tobytes())
    return losses, {k: v.float().numpy() for k, v in state.params.items()}, \
        ds, app


@pytest.mark.parametrize("opt_level", ["O0", "O1", "O2", "O3"])
def test_amp_dynamics_hook_is_read_only(opt_level):
    l_on, p_on, ds, app = _amp_run(opt_level, True)
    l_off, p_off, _, _ = _amp_run(opt_level, False)
    assert l_on == l_off
    for k in p_off:
        assert p_on[k].tobytes() == p_off[k].tobytes(), (opt_level, k)
    assert int(ds.check_count) == 3 and int(ds.step) == 6
    rep = tdx.dynamics_report(ds, app.dynamics_sites(p_on))
    assert rep.world is None and rep.gns is None
    assert all(v is not None and v >= 0 for v in rep.eff_lr + rep.uw_ratio)


def test_amp_sites_and_return_order():
    from apex_tpu import amp as jamp
    from apex_tpu_torch import guard as tguard
    from apex_tpu_torch.monitor import numerics as tnx
    import optax
    jparams = {"w": jnp.ones((4, 2)), "b": jnp.zeros((2,))}
    tparams = {"w": torch.ones(4, 2), "b": torch.zeros(2)}
    japp, _ = jamp.initialize(jparams, optax.sgd(0.1), "O1", verbosity=0)
    app, state = tamp.initialize(tparams, TLAMB(lr=0.1), "O1", verbosity=0)
    assert app.dynamics_sites(tparams) == japp.dynamics_sites(jparams)
    assert app.numerics_sites(tparams) == japp.numerics_sites(jparams)
    ncfg, dcfg = tnx.NumericsConfig(), tdx.DynamicsConfig()
    ns = tnx.numerics_init(ncfg, sites=app.numerics_sites(tparams),
                           device="cpu")
    ds = tdx.dynamics_init(dcfg, sites=app.dynamics_sites(tparams),
                           device="cpu")
    gcfg = tguard.GuardConfig(window=8, min_history=2)
    gs = tguard.guard_init(gcfg, device="cpu")

    def lf(mp):
        return torch.mean(torch.square(mp["w"]))

    ret = app.step(state, lf, guard=(gs, gcfg), numerics=(ns, ncfg),
                   dynamics=(ds, dcfg))
    assert len(ret) == 6
    assert isinstance(ret[3], tguard.GuardState)
    assert isinstance(ret[4], tnx.NumericsState)
    assert isinstance(ret[5], tdx.DynamicsState)
    ret = app.step(state, lf, dynamics=(ds, dcfg))
    assert len(ret) == 4 and isinstance(ret[3], tdx.DynamicsState)


def test_registry_rows_and_probe_scopes():
    import inspect
    from apex_tpu_torch.parallel import distributed
    for scope in ("ddp/dynamics_gns", "ddp/dynamics_geom"):
        assert tpar.scope_axis(scope) == tpar.DATA_AXIS
        assert tpar.scope_entry(scope).subsystem == "ddp"
        assert tpar.scope_entry(scope).axis == \
            jpar.scope_entry(scope).axis
    src = inspect.getsource(distributed.dynamics_probe)
    assert '"ddp/dynamics_gns"' in src and '"ddp/dynamics_geom"' in src


# --- the probe on two gloo ranks ------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return C.run(2, ["dynamics_probe_case", "dynamics_gns_case"],
                 tmp_path_factory.mktemp("dynamics"))


def _jax_probe(world):
    grads = C.probe_grads(world)
    stacked = {k: jnp.asarray(np.stack([g[k] for g in grads]))
               for k in grads[0]}
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))

    def body(x):
        local = {k: v[0] for k, v in x.items()}
        synced = jax.tree_util.tree_map(
            lambda a: jax.lax.pmean(a, "data"), local)
        return jpar.distributed.dynamics_probe(local, synced, "data")

    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("data"),
                                 out_specs=P(), check_vma=False))(stacked)


def test_probe_against_jax_shard_map(ranks):
    world = 2
    per = C.ranks(ranks, "dynamics_probe_case")
    want = _jax_probe(world)
    grad_bytes = sum(v.size * 4 for v in C.probe_grads(world)[0].values())
    for r, res in enumerate(per):
        for f in jdx.DynamicsProbe._fields:
            np.testing.assert_allclose(res["probe"][f],
                                       np.asarray(getattr(want, f)),
                                       rtol=PROBE_RTOL, err_msg=f"{r} {f}")
        assert res["counts"] == {"ddp/dynamics_gns": 1,
                                 "ddp/dynamics_geom": 1}
        assert res["bytes"] == {"all-reduce": grad_bytes + 4,
                                "all-gather": 8 * world,
                                "total": grad_bytes + 4 + 8 * world}
        st = res["state"]
        assert float(st["world"]) == world and int(st["check_count"]) == 2
        rep = res["replicated"]
        np.testing.assert_allclose(rep["dots"] / rep["local_sqs"], 1.0,
                                   rtol=1e-5)
        np.testing.assert_allclose(
            rep["dots"] / np.sqrt(rep["local_sqs"] * rep["pooled_sq"]), 1.0,
            rtol=1e-5)
    for f in ("local_sq_mean", "local_sqs", "dots"):
        assert per[0]["probe"][f].tobytes() == per[1]["probe"][f].tobytes()


def test_gns_recovered_on_two_ranks(ranks):
    for res in C.ranks(ranks, "dynamics_gns_case"):
        assert res["world"] == 2.0
        rel = abs(res["gns"] - res["true_gns"]) / res["true_gns"]
        assert rel <= 0.25, (res["gns"], res["true_gns"])
        assert all(v is not None and v > 0 for v in res["eff_lr"])
