"""apex_tpu_torch.trace.straggler (HeartbeatWriter → StragglerDetector →
StragglerWatch) against the JAX package's, and the port's
``parallel.enable_crash_dumps`` and ``cluster.CollectiveDeadline`` over
its tracer.

Both packages' writers put the same lines in the same files (apart from
``wall_time``), each reads the other's, and their detectors give the
same reports, hysteresis included, on the same heartbeat directories: a
persistent laggard named with its slowest span class, a one-step blip,
a clock skew, a healthy pod, one rank, generations, and two ranks (whose
robust z cannot pass 1/1.4826 whatever the lag). The watch feeds the
watchdog's early warning and never its stall hook.
"""

import json
import os

import pytest

from apex_tpu.trace import straggler as jstr
from apex_tpu.trace import spans as jspans

from apex_tpu_torch import parallel, trace
from apex_tpu_torch.cluster import CollectiveDeadline
from apex_tpu_torch.trace import straggler as tstr
from apex_tpu_torch.trace import spans as tspans


def _beats(path, per_rank, *, writer="port", generation=None, t0=1000.0):
    """``per_rank[r]`` is a list of (dur_ms, {span: ms}) per step."""
    mod = tstr if writer == "port" else jstr
    for r, steps in per_rank.items():
        w = mod.HeartbeatWriter(str(path), rank=r, generation=generation)
        for i, (dur, spans) in enumerate(steps):
            w.beat(i, dur_ms=dur, spans=spans, wall_time=t0 + i)


def _healthy(n, steps=8, dur=100.0):
    return {r: [(dur + 0.1 * ((r + i) % 3), {"dispatch": dur - 5.0,
                                              "data/load": 4.0})
                for i in range(steps)] for r in range(n)}


def _laggard(n, rank, start, lag=60.0, steps=8):
    beats = _healthy(n, steps)
    for i in range(start, steps):
        dur, spans = beats[rank][i]
        beats[rank][i] = (dur + lag, dict(spans, **{"data/load": 4.0 + lag}))
    return beats


SCENARIOS = {
    "laggard": dict(per_rank=_laggard(4, 2, 3)),
    "late_laggard": dict(per_rank=_laggard(4, 1, 6)),
    "blip": dict(per_rank=_laggard(4, 3, 7)),
    "healthy": dict(per_rank=_healthy(4)),
    "single_rank": dict(per_rank=_healthy(1)),
    "two_ranks": dict(per_rank=_laggard(2, 1, 2, lag=1000.0)),
    "three_ranks": dict(per_rank=_laggard(3, 0, 4)),
}


def _reports(reports):
    return [{k: v for k, v in r.to_event().items() if k != "wall_time"}
            for r in reports]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_detector_reports_match_jax(tmp_path, name, writer):
    _beats(tmp_path, SCENARIOS[name]["per_rank"], writer=writer)
    for steps in (None, 4, 5, 6):        # hysteresis as the beats arrive
        kw = {} if steps is None else {"window": steps}
        got = tstr.StragglerDetector(str(tmp_path), **kw).check()
        want = jstr.StragglerDetector(str(tmp_path), **kw).check()
        assert _reports(got) == _reports(want)
    got = _reports(tstr.StragglerDetector(str(tmp_path)).check())
    if name == "laggard":
        assert [r["rank"] for r in got] == [2]
    if name in ("blip", "healthy", "single_rank", "two_ranks"):
        assert got == []


def test_hysteresis_flags_only_after_three_lagging_steps(tmp_path):
    per_rank = _laggard(4, 2, 4, lag=200.0, steps=10)
    for upto in range(1, 11):
        d = tmp_path / f"upto{upto}"
        _beats(d, {r: s[:upto] for r, s in per_rank.items()})
        got = tstr.StragglerDetector(str(d)).check()
        assert _reports(got) == _reports(
            jstr.StragglerDetector(str(d)).check())
        lagging = max(0, upto - 4)
        assert [r.rank for r in got] == ([2] if lagging >= 3 else [])
        if got:
            assert got[0].consecutive == lagging
            assert (got[0].slowest_span, got[0].span_class) == (
                "data/load", "input_wait")


def test_two_ranks_cannot_pass_the_default_threshold(tmp_path):
    """With two ranks the median is their mean and the MAD their half
    difference, so z = lag / (1.4826·lag + floor) < 1/1.4826."""
    _beats(tmp_path, _laggard(2, 1, 0, lag=10_000.0))
    det = tstr.StragglerDetector(str(tmp_path))
    assert det.check() == []
    low = tstr.StragglerDetector(str(tmp_path), z_threshold=0.5).check()
    assert [r.rank for r in low] == [1] and low[0].z < 1 / 1.4826
    assert _reports(low) == _reports(jstr.StragglerDetector(
        str(tmp_path), z_threshold=0.5).check())


def test_writers_agree_and_read_each_other(tmp_path):
    lines = {}
    for name, smod, wmod in (("port", tspans, tstr), ("jax", jspans, jstr)):
        st = smod.StepTrace(3, 0.0)
        st.dur_ms = 12.345678
        st.spans = [smod.SpanEvent("data/load", "span", 0.0, 2.5, 0),
                    smod.SpanEvent("dispatch", "span", 0.003, 9.0, 0),
                    smod.SpanEvent("data/load", "span", 0.012, 0.25, 0)]
        w = wmod.HeartbeatWriter(str(tmp_path / name), rank=5, generation=2)
        w.on_step(st)
        assert (w.n_written, w.n_dropped) == (1, 0)
        rec = json.loads(open(w.path).read())
        rec.pop("wall_time")
        lines[name] = rec
    assert lines["port"] == lines["jax"]
    assert lines["port"]["spans"] == {"data/load": 2.75, "dispatch": 9.0}
    for d in ("port", "jax"):
        assert tstr.read_heartbeats(str(tmp_path / d)) == \
            jstr.read_heartbeats(str(tmp_path / d))
        assert tstr.read_heartbeats(str(tmp_path / d), generation=1) == {}


def test_generation_scoped_detector_matches_jax(tmp_path):
    _beats(tmp_path, _laggard(4, 2, 0), generation=0)
    _beats(tmp_path, _healthy(4), generation=1, t0=2000.0)
    for gen in (None, 0, 1):
        got = tstr.StragglerDetector(str(tmp_path), generation=gen).check()
        assert _reports(got) == _reports(jstr.StragglerDetector(
            str(tmp_path), generation=gen).check())


def test_writer_drops_a_beat_it_cannot_write(tmp_path):
    """An append that keeps failing (here the rank's file is a
    directory) is retried, then dropped; the loop goes on."""
    for mod in (tstr, jstr):
        d = tmp_path / mod.__name__
        w = mod.HeartbeatWriter(str(d), rank=0, attempts=2)
        os.makedirs(w.path)
        assert w.beat(0, dur_ms=1.0) is False
        assert (w.n_written, w.n_dropped) == (0, 1)


def test_watch_feeds_early_warning_never_the_stall_hook(tmp_path):
    _beats(tmp_path, _laggard(4, 1, 2))
    fired, stalled, events = [], [], []
    wd = trace.HangWatchdog(60.0, on_fire=fired.append,
                            on_stall=stalled.append)
    rec = trace.FlightRecorder(str(tmp_path / "c.jsonl"))
    watch = trace.StragglerWatch(trace.StragglerDetector(str(tmp_path)),
                                 watchdog=wd, event_sink=events.append,
                                 recorder=rec, renotify_s=60.0)
    for _ in range(2):
        reports = watch.poll_once()
    assert [r.rank for r in reports] == [1]
    assert watch.flag_count == 1 and len(events) == 1     # renotify window
    assert events[0]["kind"] == "straggler"
    assert wd.warning_count == 1 and fired[0]["reason"] == "early-warning"
    assert stalled == [] and wd.fire_count == 0
    hdr = json.loads(open(rec.dump(reason="manual")).readline())
    assert [r["rank"] for r in hdr["straggler_reports"]] == [1, 1]
    with watch:                                           # the thread
        assert watch._thread.is_alive()
    assert watch._thread is None


def test_tracer_subscription_writes_beats(tmp_path):
    tracer = trace.Tracer()
    hb = trace.HeartbeatWriter(str(tmp_path), rank=3)
    tracer.subscribe(hb.on_step)
    with tracer:
        for i in range(3):
            with trace.step(i):
                with trace.span("data/load"):
                    pass
    beats = trace.read_heartbeats(str(tmp_path))
    assert sorted(beats[3]) == [0, 1, 2]
    assert set(beats[3][2]["spans"]) == {"data/load"}


# --- enable_crash_dumps and the collective deadline -----------------------------

class _Escalation:
    def __init__(self):
        self.recorder = None
        self.trips = []
        self.stalls = []

    def trip(self, reason):
        self.trips.append(reason)

    def __call__(self, event=None):
        self.stalls.append(event)

    def on_preempt(self):
        return None


def test_enable_crash_dumps_shape_and_wiring(tmp_path):
    esc = _Escalation()
    tracer, rec, wd, cd = parallel.enable_crash_dumps(
        str(tmp_path / "crash.jsonl"), capacity=5, hang_deadline_s=30.0,
        escalation=esc, collective_deadline_s=20.0)
    try:
        assert isinstance(tracer, trace.Tracer)
        assert isinstance(rec, trace.FlightRecorder)
        assert isinstance(wd, trace.HangWatchdog)
        assert isinstance(cd, CollectiveDeadline)
        assert rec.capacity == 5 and rec.tracer is tracer
        assert rec.escalation is esc and esc.recorder is rec
        assert wd.on_stall is esc and wd.recorder is rec
        assert wd._thread.is_alive() and cd._thread.is_alive()
        assert cd.tracer is tracer and cd.escalation is esc
        with tracer:
            with trace.step(0):
                with trace.span("dispatch"):
                    pass
        assert wd._last_step == 0 and rec._ring[-1].step == 0
        assert rec.path == str(tmp_path / "crash.jsonl")
    finally:
        wd.stop()
        cd.stop()
        rec.uninstall()
    other = _Escalation()
    other.recorder = "theirs"
    t2, r2, w2, c2 = parallel.enable_crash_dumps(
        str(tmp_path / "b.jsonl"), escalation=other)
    r2.uninstall()
    assert (w2, c2, other.recorder) == (None, None, "theirs")


def test_collective_deadline_trips_on_an_open_collective_span():
    esc, events = _Escalation(), []
    tracer = trace.Tracer()
    cd = CollectiveDeadline(tracer, deadline_s=0.0, escalation=esc,
                            event_sink=events.append)
    with tracer:
        with trace.step(0):
            assert cd.poll_once() is None                 # nothing open
            with trace.span("dispatch"):
                with trace.span("ddp/sync_gradients", kind="collective"):
                    ev = cd.poll_once()
                    assert cd.poll_once() is None         # once a span
                with trace.span("ddp/sync_gradients", kind="collective"):
                    assert cd.poll_once() is not None     # a new instance
    assert ev["collective"] == "ddp/sync_gradients"
    assert ev["kind"] == "cluster_coord" and ev["action"] == \
        "collective_hang"
    assert esc.trips == ["collective:ddp/sync_gradients"] * 2
    assert len(events) == 2 and cd.fired == 2
    slow = CollectiveDeadline(tracer, deadline_s=60.0, escalation=esc)
    with tracer, trace.step(1), trace.span("zero/grad_scatter",
                                           kind="collective"):
        assert slow.poll_once() is None                   # slow, not hung
