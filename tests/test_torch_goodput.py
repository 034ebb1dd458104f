"""apex_tpu_torch.monitor.goodput and collectives' scope joins against
the JAX package's.

The same span timelines (``StepTrace``s of ``SpanEvent``s with fixed
begin times and durations, the same joins) fold through both packages'
``GoodputLedger``s: every bucket within 1e-9 ms, the same per-axis
``comm_axes_ms``, closure, rolling goodput, totals, table and events
(apart from ``wall_time``). ``classify_span``, ``scope_axis_row`` and
``scope_hop`` answer the same for the registry's scopes, and the ledger
joins axes through the one ``scope_axis_row``.
"""

import json
import os
import subprocess
import sys

import pytest

from apex_tpu.monitor import collectives as jcoll
from apex_tpu.monitor import goodput as jgood
from apex_tpu.trace import spans as jspans

from apex_tpu_torch.monitor import collectives as tcoll
from apex_tpu_torch.monitor import goodput as tgood
from apex_tpu_torch.trace import spans as tspans

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

#: (name, kind, t_start_s, dur_ms, depth) spans of one step; walls in ms
CASES = {
    "nested": [(10.0, [("dispatch", "span", 0.0, 8.0, 0),
                       ("amp/fwd", "span", 0.001, 3.0, 1),
                       ("fetch", "span", 0.008, 1.5, 0)])],
    "overlap_backdated": [(20.0, [("dispatch", "span", 0.0, 12.0, 0),
                                  ("compile/step", "compile", 0.004, 9.0, 0),
                                  ("data/load", "span", 0.013, 4.0, 0)])],
    "collectives_by_axis": [(30.0, [
        ("dispatch", "span", 0.0, 25.0, 0),
        ("ddp/sync_gradients", "collective", 0.002, 6.0, 1),
        ("zero/grad_scatter", "collective", 0.009, 3.0, 1),
        ("bucket00/ici", "collective", 0.013, 2.0, 1),
        ("bucket00/dcn", "collective", 0.0152, 1.25, 1),
        ("mystery/allreduce", "collective", 0.018, 2.5, 1),
        ("host/sync", "span", 0.026, 2.0, 0)])],
    "uncovered": [(50.0, [("dispatch", "span", 0.01, 5.0, 0)])],
    "multi_step": [(12.0, [("dispatch", "span", 0.0, 9.0, 0),
                           ("fetch", "span", 0.009, 2.0, 0)]),
                   (11.0, [("data/load", "span", 0.0, 3.0, 0),
                           ("dispatch", "span", 0.003, 7.0, 0),
                           ("ckpt/capture", "span", 0.010, 0.5, 0)]),
                   (0.0, []),
                   (15.0, [("guard/rewind", "span", 0.0, 4.0, 0),
                           ("dispatch", "span", 0.004, 9.0, 0)])],
}

#: joins noted before a step folds: (method, event or (ms, step), step)
JOINS = {
    "ckpt": [("note_ckpt", {"kind": "ckpt_save", "step": 0,
                            "stall_ms": 3.5}),
             ("note_ckpt", {"kind": "ckpt_restore", "step": 0,
                            "stall_ms": 9.0}),
             ("note_guard", {"kind": "guard_action", "step": 0,
                             "dur_ms": 1.25}),
             ("note_guard", {"kind": "guard_anomaly", "step": 0,
                             "dur_ms": 99.0})],
    "late": [("note_ckpt", {"kind": "ckpt_save", "step": None,
                            "stall_ms": 30.0})],
    "pod_skew": [("note_pod_skew", (4.0, 0))],
    "pod_skew_clamped": [("note_pod_skew", (400.0, 0))],
}


def _steps(mod, case):
    out = []
    for i, (wall, spans) in enumerate(case):
        st = mod.StepTrace(i, 0.0)
        st.dur_ms = wall
        st.spans = [mod.SpanEvent(n, k, t0, d, depth)
                    for n, k, t0, d, depth in spans]
        out.append(st)
    return out


def _fold(gmod, smod, case, joins=()):
    ledger = gmod.GoodputLedger(rank=0)
    got = []
    ledger.subscribe(got.append)
    for method, arg in joins:
        fn = getattr(ledger, method)
        fn(*arg) if isinstance(arg, tuple) else fn(dict(arg))
    for st in _steps(smod, case):
        ledger.on_step(st)
    return ledger, got


def _strip(events):
    return [{k: v for k, v in ev.items() if k != "wall_time"}
            for ev in events]


def _same(jl, tl, jev, tev):
    assert len(jl.steps) == len(tl.steps)
    for a, b in zip(jl.steps, tl.steps):
        assert a.step == b.step and a.wall_ms == b.wall_ms
        assert set(a.buckets) == set(b.buckets) == set(tgood.BUCKETS)
        for k in a.buckets:
            assert abs(a.buckets[k] - b.buckets[k]) <= 1e-9, k
        assert a.comm_axes_ms.keys() == b.comm_axes_ms.keys()
        for ax in a.comm_axes_ms:
            for part, v in a.comm_axes_ms[ax].items():
                assert abs(v - b.comm_axes_ms[ax][part]) <= 1e-9
        assert a.closure_error() == pytest.approx(b.closure_error(),
                                                  abs=1e-12)
    assert jl.check_closure() == tl.check_closure()
    assert jl.rolling_goodput() == pytest.approx(tl.rolling_goodput(),
                                                 abs=1e-12) \
        if jl.rolling_goodput() is not None else tl.rolling_goodput() is None
    assert jl.table() == tl.table()
    assert _strip(jl.to_events()) == _strip(tl.to_events())
    assert _strip(jev) == _strip(tev)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ledger_matches_jax(name):
    jl, jev = _fold(jgood, jspans, CASES[name])
    tl, tev = _fold(tgood, tspans, CASES[name])
    _same(jl, tl, jev, tev)
    assert tl.totals() == pytest.approx(jl.totals(), abs=1e-9)
    assert tl.comm_axes_totals().keys() == jl.comm_axes_totals().keys()


@pytest.mark.parametrize("join", sorted(JOINS))
def test_joins_match_jax(join):
    case = CASES["multi_step"]
    jl, jev = _fold(jgood, jspans, case, JOINS[join])
    tl, tev = _fold(tgood, tspans, case, JOINS[join])
    _same(jl, tl, jev, tev)


def test_pod_skew_moves_wire_per_axis_like_jax():
    case = CASES["collectives_by_axis"]
    joins = [("note_pod_skew", (3.0, 0))]
    jl, jev = _fold(jgood, jspans, case, joins)
    tl, tev = _fold(tgood, tspans, case, joins)
    _same(jl, tl, jev, tev)
    axes = tl.steps[0].comm_axes_ms
    assert {"data", "data_intra", "data_inter", "unknown"} <= set(axes)
    wire = sum(p["wire"] for p in axes.values())
    skew = sum(p["skew"] for p in axes.values())
    assert abs(wire - tl.steps[0].buckets["comm_wire"]) < 1e-9
    assert abs(skew - tl.steps[0].buckets["comm_skew"]) < 1e-9


def test_tracer_subscription_and_schema(tmp_path):
    """A live port Tracer feeds the ledger; its goodput events pass
    ``check_metrics_schema.py --kind goodput``, through the logger's
    goodput channel."""
    from apex_tpu_torch import monitor, trace
    path = tmp_path / "goodput.jsonl"
    logger = monitor.MetricsLogger(sinks=[],
                                   goodput_sink=monitor.JSONLSink(str(path)))
    tracer = trace.Tracer()
    ledger = monitor.GoodputLedger(tracer)
    ledger.subscribe(logger.record_goodput)
    with tracer:
        for i in range(3):
            with trace.step(i):
                with trace.span("data/load"):
                    pass
                with trace.span("dispatch"):
                    sum(range(2000))
                with trace.span("fetch"):
                    pass
    logger.close()
    assert len(ledger.steps) == 3 and ledger.check_closure()[0]
    assert all(r.buckets["input_wait"] > 0 for r in ledger.steps)
    r = subprocess.run([sys.executable, os.path.join(
        _ROOT, "scripts", "check_metrics_schema.py"), "--kind", "goodput",
        str(path)], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    assert len(path.read_text().splitlines()) == 3


NAMES = [("anything", "collective"), ("compile/train_step", "compile"),
         ("data/load", "span"), ("input/decode", "span"),
         ("loader", "span"), ("fetch", "span"), ("fetch_metrics", "span"),
         ("host/sync", "span"), ("callback/x", "span"),
         ("ckpt/capture", "span"), ("guard/rewind", "span"),
         ("dispatch", "span"), ("fwd", "span"), ("amp/fwd", "span")]


@pytest.mark.parametrize("name,kind", NAMES)
def test_classify_span_matches_jax(name, kind):
    assert tgood.classify_span(name, kind) == jgood.classify_span(name, kind)


SCOPES = ["ddp/sync_gradients", "ddp/sync_gradients/bucket03/ici",
          "ddp/sync_gradients/bucket03/dcn", "bucket00/ici", "bucket01/dcn",
          "bucket07", "zero/grad_scatter", "zero/param_gather",
          "zero/grad_norm", "sync_batchnorm", "ddp/loss_pmean",
          "guard/integrity_check", "guard/integrity_repair",
          "ddp/dynamics_gns", "ring_attention", "nonsense", "", "ici",
          "x/dcn/y"]


@pytest.mark.parametrize("scope", SCOPES)
def test_scope_joins_match_jax(scope):
    assert tcoll.scope_hop(scope) == jcoll.scope_hop(scope)
    if scope == "zero/grad_norm":          # the port's own registry row
        assert tcoll.scope_axis_row(scope) == "data"
        return
    assert tcoll.scope_axis_row(scope) == jcoll.scope_axis_row(scope)


def test_ledger_joins_axes_through_the_one_scope_axis_row(monkeypatch):
    seen = []

    def row(scope):
        seen.append(scope)
        return "probe"

    monkeypatch.setattr(tcoll, "scope_axis_row", row)
    tl, _ = _fold(tgood, tspans, CASES["collectives_by_axis"])
    assert set(tl.steps[0].comm_axes_ms) == {"probe"}
    assert "zero/grad_scatter" in seen
    src = open(tgood.__file__).read()
    assert "scope_axis(" not in src and "apex_tpu_torch.parallel" not in src


def test_event_json_round_trips():
    tl, tev = _fold(tgood, tspans, CASES["multi_step"], JOINS["ckpt"])
    for ev in tev:
        assert json.loads(json.dumps(ev)) == ev
