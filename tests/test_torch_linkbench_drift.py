"""The port's link calibration and comm drift (``monitor.linkbench``,
``monitor.comm_drift``) against the JAX package's.

Both packages' fits and plan predictions are float64 host arithmetic, so
every comparison is exact: ``fit_alpha_beta`` on injected samples,
``calibrate`` with the sweep's timings injected (the same MeshModel JSON),
``measure_hops`` with an injected collective and clock (the same seconds
a hop), ``compare`` (the same rows and events, wall time aside) and
``wire_from_pod`` on the synthetic pods of ``tests/test_podview.py``. Then
the real pipeline on two gloo ranks: sweep → fit → MeshModel →
``plan_comm`` → ``measure_hops`` → ``compare``, gated on its shape and
finiteness (the times are gloo's on this host).
"""

import dataclasses
import json
import math
import time
import types

import jax
import numpy as np
import pytest

import _torch_parallel_cases as C
from apex_tpu.lint import mesh_model as jmm
from apex_tpu.monitor import comm_drift as jcd
from apex_tpu.monitor import linkbench as jlb
from apex_tpu.parallel import hierarchy as jhier
from apex_tpu.trace import podview as jpod
from apex_tpu_torch.lint import mesh_model as tmm
from apex_tpu_torch.monitor import comm_drift as tcd
from apex_tpu_torch.monitor import linkbench as tlb
from apex_tpu_torch.parallel import hierarchy as thier
from apex_tpu_torch.trace import podview as tpod

LINKS = C.HIER_LINKS


def _samples(mod, axis="data_intra", alpha=5e-6, bps=2e10, noise=0.0,
             seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for op in mod.OPS:
        for size in mod.DEFAULT_SIZES:
            wire = (2.0 * 3 / 4 if op == "all_reduce" else 3 / 4) * size
            t = alpha + wire / bps
            out.append(mod.LinkSample(op, axis, size, wire,
                                      t * (1 + noise * rng.randn())))
    return out


@pytest.mark.parametrize("noise,alpha", [(0.0, 5e-6), (0.05, 5e-6),
                                         (0.0, 0.0), (0.3, 1e-3)])
def test_fit_alpha_beta_equals_jax(noise, alpha):
    t = tlb.fit_alpha_beta(_samples(tlb, noise=noise, alpha=alpha))
    j = jlb.fit_alpha_beta(_samples(jlb, noise=noise, alpha=alpha))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.to_json() == j.to_json()


def test_fit_falls_back_on_a_negative_slope():
    def flipped(mod):
        s = _samples(mod)
        return [dataclasses.replace(x, seconds=1e-3 - x.wire_bytes * 1e-12)
                for x in s]
    t, j = tlb.fit_alpha_beta(flipped(tlb)), jlb.fit_alpha_beta(flipped(jlb))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.alpha_s == 0.0 and t.bytes_per_s > 0
    assert tlb.fit_table({"a": t}, flipped(tlb)) == \
        jlb.fit_table({"a": j}, flipped(jlb))
    with pytest.raises(ValueError):
        tlb.fit_alpha_beta([])


def _fake_sweep(mod, rates):
    def sweep(mesh, axis, *, sizes, ops, iters):
        return _samples(mod, axis=axis, bps=rates[axis],
                        alpha=1e-5 if axis == "data_inter" else 2e-6,
                        noise=0.02, seed=len(axis))
    return sweep


def test_calibrate_with_injected_timings_equals_jax(monkeypatch):
    rates = {"data_intra": 3e10, "data_inter": 4e9}
    monkeypatch.setattr(tlb, "sweep_axis", _fake_sweep(tlb, rates))
    monkeypatch.setattr(jlb, "sweep_axis", _fake_sweep(jlb, rates))
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                              ("data_inter", "data_intra"))
    tmesh = types.SimpleNamespace(mesh_dim_names=("data_inter",
                                                  "data_intra"),
                                  shape=(2, 2), device_type="cpu")
    jt = jmm.parse_mesh_spec("dp2x2")
    tt = tmm.parse_mesh_spec("dp2x2", link_bytes_per_s=LINKS)
    jmodel, jfits, jsamples = jlb.calibrate(jmesh, jt)
    tmodel, tfits, tsamples = tlb.calibrate(tmesh, tt)
    jj, tj = jmodel.to_json(), tmodel.to_json()
    for key in ("name", "axes", "link_bytes_per_s", "calibration"):
        assert tj[key] == jj[key], key
    assert {k: dataclasses.asdict(v) for k, v in tfits.items()} == \
        {k: dataclasses.asdict(v) for k, v in jfits.items()}
    assert tlb.fit_table(tfits, tsamples) == jlb.fit_table(jfits, jsamples)
    strip = lambda evs: [{k: v for k, v in e.items() if k != "wall_time"}
                         for e in evs]  # noqa: E731
    assert strip(tlb.linkfit_events(tmodel, rank=0)) == \
        strip(jlb.linkfit_events(jmodel, rank=0))
    # the measured model plans as the JAX package's measured model does
    tplan = thier.plan_comm(tmodel, 1 << 22)
    jplan = jhier.plan_comm(jmodel, 1 << 22)
    assert tplan.to_json() == jplan.to_json()
    assert tplan.source == "measured"
    with pytest.raises(ValueError, match="template size"):
        tlb.calibrate(types.SimpleNamespace(
            mesh_dim_names=("data_inter", "data_intra"), shape=(2, 4),
            device_type="cpu"), tt)


def test_linkfit_events_validate():
    from scripts.check_metrics_schema import check_goodput_lines
    fit = tlb.fit_alpha_beta(_samples(tlb))
    model = tmm.MeshModel([tmm.MeshAxis("data", 2, "ici")],
                          link_bytes_per_s={"ici": fit.bytes_per_s},
                          calibration={"ici": fit.to_json()})
    ev = tlb.linkfit_events(model, rank=0)
    assert check_goodput_lines([json.dumps(e) for e in ev]) == []


def _plans(dtype=None):
    kw = dict(alpha_us=1.0, bytes_per_s=1e9, calibrated=False)
    out = []
    for mod in (thier, jhier):
        hops = (mod.Hop("reduce_scatter", "data_intra", 4, "ici", dtype,
                        **kw),
                mod.Hop("all_reduce", "data_inter", 2, "dcn", dtype,
                        alpha_us=10.0, bytes_per_s=1e8, calibrated=False),
                mod.Hop("all_gather", "data_intra", 4, "ici", dtype, **kw))
        out.append(mod.CommPlan(hops=hops, compress_block=256,
                                source="defaults", mesh_name="testmesh",
                                grad_bytes=1 << 20))
    return out


def _strip(events):
    return [{k: v for k, v in e.items() if k != "wall_time"}
            for e in events]


@pytest.mark.parametrize("scale,tol", [((1, 1, 1), 4.0),
                                       ((1, 100, 1), 4.0),
                                       ((0.01, 1, 1), 4.0),
                                       ((3, 0.5, 2), 2.0)])
def test_compare_equals_jax(scale, tol):
    from scripts.check_metrics_schema import check_podview_lines
    tplan, jplan = _plans()
    measured = [s * k for s, k in zip(jplan.hop_seconds(), scale)]
    t = tcd.compare(tplan, measured, tolerance=tol)
    j = jcd.compare(jplan, measured, tolerance=tol)
    assert [dataclasses.asdict(h) for h in t.hops] == \
        [dataclasses.asdict(h) for h in j.hops]
    assert (t.stale, t.drift_ratio, t.plan_source) == \
        (j.stale, j.drift_ratio, j.plan_source)
    assert [h.fingerprint for h in t.stale_hops()] == \
        [h.fingerprint for h in j.stale_hops()]
    assert _strip(t.to_events()) == _strip(j.to_events())
    assert check_podview_lines([json.dumps(e) for e in t.to_events()]) == []
    assert t.table().splitlines()[:-1] == j.table().splitlines()[:-1]
    with pytest.raises(ValueError):
        tcd.compare(tplan, measured[:2])


@pytest.mark.parametrize("dtype", [None, "bf16", "int8"])
def test_measure_hops_with_injected_clock_equals_jax(monkeypatch, dtype):
    """A collective that advances a fake clock by α + bytes/β: both
    packages time the same payloads the same number of times."""
    clock = [0.0]

    def fake_collective(op, mesh, axis):
        def fn(x):
            clock[0] += 1e-5 + np.asarray(x).size * 4 / 1e9
            return x
        return fn

    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    monkeypatch.setattr(tlb, "_collective", fake_collective)
    monkeypatch.setattr(tlb, "_agree", lambda seconds, mesh, axis: seconds)
    monkeypatch.setattr(jlb, "_collective", fake_collective)
    tplan, jplan = _plans(dtype)
    mesh = types.SimpleNamespace(device_type="cpu")
    got = tcd.measure_hops(tplan, mesh, iters=2)
    want = jcd.measure_hops(jplan, None, iters=2)
    assert got == pytest.approx(want, rel=1e-12)
    assert len(got) == 3 and all(v > 0 for v in got)


def _pod_events():
    events = []
    for rank in (0, 1):
        t = 0.0
        for name, d in (("ici", 10.0), ("dcn", 20.0), ("ici", 5.0)):
            events.append({"kind": "span", "name": name,
                           "span_kind": "collective", "step": 0,
                           "rank": rank, "t_ms": t, "dur_ms": d,
                           "depth": 0})
            t += d
    return events


@pytest.mark.parametrize("case", ["full", "missing_hop", "two_steps"])
def test_wire_from_pod_equals_jax(case):
    events = _pod_events()
    if case == "missing_hop":
        events = [e for e in events if e["name"] == "ici"][:2]
    if case == "two_steps":
        events = events + [dict(e, step=1, dur_ms=e["dur_ms"] * 2)
                           for e in events]
    tplan, jplan = _plans()
    got = tcd.wire_from_pod(tpod.PodTimeline.merge(events), tplan)
    want = jcd.wire_from_pod(jpod.PodTimeline.merge(events), jplan)
    assert got == want
    if case == "full":
        assert got == pytest.approx([10e-3, 20e-3, 5e-3], abs=1e-9)


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    return C.ranks(C.run(2, ["linkbench_pipeline"],
                         tmp_path_factory.mktemp("linkbench")),
                   "linkbench_pipeline")


def test_pipeline_on_two_gloo_ranks(pipeline):
    for res in pipeline:
        model = tmm.MeshModel.from_json(res["model"])
        assert model.measured and model.axis_names == ("data",)
        cal = model.calibration["ici"]
        assert cal["n_samples"] == 9 and cal["axis"] == "data"
        assert math.isfinite(cal["bytes_per_s"]) and cal["bytes_per_s"] > 0
        assert cal["alpha_us"] >= 0 and math.isfinite(cal["residual"])
        assert len(res["measured"]) == 1 and res["measured"][0] > 0
        assert len(res["rows"]) == 1 and res["rows"][0]["op"] == "all_reduce"
        assert res["plan"]["source"] == "measured"
