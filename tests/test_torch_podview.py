"""apex_tpu_torch.trace.podview against the JAX package's.

The same span events (a synthetic pod of ranks with clock offsets,
drift, a laggard, a rank without collectives, out-of-order arrival, a
torn JSONL tail, and spans from two live port Tracers) merge through both
packages' ``PodTimeline``: the same clock offsets, drift and residuals,
the same collective skews with the same (rank, span) blame, the same
per-(rank, step) skew, critical path, Chrome trace and podview events
(apart from ``wall_time`` and the producer's name), and the skew joins
back into both goodput ledgers alike.
"""

import json
import os
import random
import subprocess
import sys

import pytest

from apex_tpu.monitor import goodput as jgood
from apex_tpu.trace import podview as jpod
from apex_tpu.trace import spans as jspans

from apex_tpu_torch import trace
from apex_tpu_torch.monitor import goodput as tgood
from apex_tpu_torch.trace import podview as tpod
from apex_tpu_torch.trace import spans as tspans

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _span(name, kind, step, rank, t_ms, dur_ms, depth=0):
    return {"kind": "span", "name": name, "span_kind": kind,
            "step": step, "rank": rank, "t_ms": t_ms, "dur_ms": dur_ms,
            "depth": depth}


def _pod_events(offsets, n_steps=2, *, slow_rank=None, slow_ms=40.0,
                drift=None, no_coll=()):
    """Each step runs ``data/load`` then a ``grad/allreduce`` collective;
    ``offsets[r]`` shifts rank r's clock, ``drift[r]`` its rate,
    ``slow_rank`` loads ``slow_ms``, ranks in ``no_coll`` share nothing."""
    events = []
    for rank, off in offsets.items():
        def local(t_true):
            t = t_true - off
            if drift and rank in drift:
                t = t * (1.0 + drift[rank])
            return t
        for step in range(n_steps):
            base = 1000.0 * step
            load = slow_ms if rank == slow_rank else 5.0
            events.append(_span("data/load", "span", step, rank,
                                local(base), load, depth=1))
            if rank in no_coll:
                continue
            entry = base + load
            exit_true = base + max(slow_ms if slow_rank is not None
                                   else 5.0, 5.0) + 10.0
            events.append(_span("grad/allreduce", "collective", step,
                                rank, local(entry),
                                local(exit_true) - local(entry)))
    return events


SCENARIOS = {
    "offsets": dict(offsets={0: 0.0, 1: 12.5, 2: -7.25, 3: 3.0},
                    n_steps=3),
    "laggard": dict(offsets={0: 0.0, 1: 2.0, 2: -1.0}, slow_rank=2,
                    slow_ms=40.0, n_steps=4),
    "no_collectives": dict(offsets={0: 0.0, 1: 4.0, 2: 9.0},
                           no_coll=(2,)),
    "single_rank": dict(offsets={0: 5.0}),
    "drift": dict(offsets={0: 0.0, 1: 3.0, 2: -2.0},
                  drift={1: 2e-5, 2: -3e-5}, n_steps=6),
}


def _wt(events):
    return [{k: v for k, v in e.items() if k != "wall_time"}
            for e in events]


def _merge_both(events, **kw):
    return (jpod.PodTimeline.merge(list(events), **kw),
            tpod.PodTimeline.merge(list(events), **kw))


def _assert_same(jp, tp):
    assert jp.ranks == tp.ranks
    assert jp.alignment.reference == tp.alignment.reference
    for r in jp.ranks:
        a, b = jp.alignment.clocks[r], tp.alignment.clocks[r]
        assert (a.offset_ms, a.drift, a.residual_ms, a.n_shared,
                a.aligned) == (b.offset_ms, b.drift, b.residual_ms,
                               b.n_shared, b.aligned)
    js, ts = jp.collective_skew(), tp.collective_skew()
    assert [(c.step, c.name, c.occurrence, c.n_ranks, c.entries, c.exit_ms,
             c.skew_ms, c.wire_ms, c.blamed_rank, c.blamed_span)
            for c in js] == [
        (c.step, c.name, c.occurrence, c.n_ranks, c.entries, c.exit_ms,
         c.skew_ms, c.wire_ms, c.blamed_rank, c.blamed_span) for c in ts]
    assert jp.rank_step_skew() == tp.rank_step_skew()
    assert jp.critical_path() == tp.critical_path()
    assert _wt(jp.to_events()) == _wt(tp.to_events())
    jc, tc = jp.chrome_trace(), tp.chrome_trace()
    assert jc["traceEvents"] == tc["traceEvents"]
    jm, tm = dict(jc["metadata"]), dict(tc["metadata"])
    assert (jm.pop("producer"), tm.pop("producer")) == (
        "apex_tpu.trace.podview", "apex_tpu_torch.trace.podview")
    assert jm == tm


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("fit_drift", [False, True])
def test_merge_matches_jax(name, fit_drift):
    events = _pod_events(**SCENARIOS[name])
    jp, tp = _merge_both(events, fit_drift=fit_drift)
    _assert_same(jp, tp)
    if name == "offsets" and not fit_drift:
        for r, off in SCENARIOS[name]["offsets"].items():
            assert abs(tp.alignment.clocks[r].offset_ms - off) < 1e-6
    if name == "laggard":
        for c in tp.collective_skew():
            assert (c.blamed_rank, c.blamed_span) == (2, "data/load")
            assert abs(c.skew_ms - 35.0) < 1e-6


def test_out_of_order_and_torn_lines_match_jax():
    events = _pod_events({0: 0.0, 1: 6.0, 2: -3.0}, n_steps=3,
                         slow_rank=1)
    random.Random(3).shuffle(events)
    lines = [json.dumps(e) for e in events] + ['{"kind": "span", "na']
    jp, tp = _merge_both(lines)
    _assert_same(jp, tp)
    jr, tr = jpod.load_span_events(lines), tpod.load_span_events(lines)
    assert sorted(jr) == sorted(tr)


def test_reference_rank_gauge_matches_jax():
    events = _pod_events({0: 0.0, 1: 8.0, 2: 1.5}, n_steps=2)
    jp, tp = _merge_both(events, reference=2)
    _assert_same(jp, tp)
    assert tp.alignment.clocks[2].offset_ms == 0.0


def test_goodput_join_round_trip_matches_jax():
    """The pod skew per (rank, step) joins into both ledgers alike, and
    the closure holds."""
    events = _pod_events({0: 0.0, 1: 4.0}, n_steps=3, slow_rank=1)
    jp, tp = _merge_both(events)
    skew = tp.rank_step_skew()
    ledgers = {}
    for gmod, smod, name in ((jgood, jspans, "jax"),
                             (tgood, tspans, "port")):
        ledger = gmod.GoodputLedger(rank=0)
        for (r, step), ms in sorted(skew.items()):
            if r == 0:
                ledger.note_pod_skew(ms, step=step)
        for step in range(3):
            st = smod.StepTrace(step, 0.0)
            st.dur_ms = 60.0
            st.spans = [smod.SpanEvent(s["name"], s["span_kind"],
                                       (s["t_ms"] - 1000.0 * step) * 1e-3,
                                       s["dur_ms"], s["depth"])
                        for s in events
                        if s["rank"] == 0 and s["step"] == step]
            ledger.on_step(st)
        ledgers[name] = ledger
    assert ledgers["jax"].table() == ledgers["port"].table()
    assert ledgers["port"].check_closure()[0]
    assert ledgers["port"].totals()["comm_skew"] > 0


def test_live_tracers_merge_and_events_validate(tmp_path):
    """Two port Tracers' span events (one rank a step behind in
    ``data/load``) merge like the JAX package merges them, and the pod
    events pass ``check_metrics_schema.py --kind podview``."""
    import time
    streams = []
    for rank, delay in ((0, 0.0), (1, 0.004)):
        tracer = trace.Tracer()
        with tracer:
            for i in range(3):
                with trace.step(i):
                    with trace.span("data/load"):
                        time.sleep(delay)
                    with trace.span("ddp/sync_gradients", kind="collective"):
                        time.sleep(0.006 - delay)
        streams.append(tracer.span_events(rank))
    events = streams[0] + streams[1]
    jp, tp = _merge_both(events)
    _assert_same(jp, tp)
    path = tmp_path / "pod.jsonl"
    path.write_text("".join(json.dumps(e) + "\n" for e in tp.to_events()))
    r = subprocess.run([sys.executable, os.path.join(
        _ROOT, "scripts", "check_metrics_schema.py"), "--kind", "podview",
        str(path)], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    out = tp.write_chrome_trace(str(tmp_path / "pod_trace.json"))
    assert json.load(open(out))["metadata"]["ranks"] == [0, 1]
