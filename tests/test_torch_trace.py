"""apex_tpu_torch.trace — spans, flight recorder, watchdog, NaN
provenance — against the JAX package's ``tests/test_trace.py`` cases.

Spans nest, stay passive without a Tracer (no op dispatched), record
through the decorator, track open and in-flight (collective) spans and
recover after a caught exception as the JAX package's do; the exporters
(Chrome trace, ``StepTimeline`` table, step and span events) give the
JAX package's output field for field from the same span records; the
events, recorder dumps and watchdog dumps pass
``scripts/check_metrics_schema.py --kind trace``; a mid-step exception
and a SIGTERM in subprocesses dump (the SIGTERM after the escalation's
``on_preempt``); the watchdog fires once a stall, re-arms, and skips
the metrics read; two processes dump per rank; ``debug_nans`` names the
same first span as JAX, and its off path dispatches nothing.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu import amp as jamp
from apex_tpu import trace as jtrace
from apex_tpu.optim import FusedSGD as JSGD
from apex_tpu.trace import spans as jspans

from apex_tpu_torch import amp as tamp
from apex_tpu_torch import monitor, trace
from apex_tpu_torch.optim import FusedSGD as TSGD
from apex_tpu_torch.trace import spans as tspans

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_SCHEMA = os.path.join(_ROOT, "scripts", "check_metrics_schema.py")


def _validate(path, kind="trace"):
    return subprocess.run([sys.executable, _SCHEMA, "--kind", kind,
                           str(path)], capture_output=True, text=True,
                          cwd=_ROOT)


class _OpCount(TorchDispatchMode):
    """Counts every aten op dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _nested(mod):
    tracer = mod.Tracer()
    with tracer:
        for i in range(3):
            with mod.step(i):
                with mod.span("fwd"):
                    time.sleep(0.002)
                    with mod.span("inner"):
                        pass
                with mod.span("bwd"):
                    pass
    return tracer


# --- spans ---------------------------------------------------------------------

def test_span_timeline_nesting_matches_jax():
    tt, jt = _nested(trace), _nested(jtrace)
    for t in (tt, jt):
        assert len(t.steps) == 3 and t.last_completed_span == "bwd"
    shape = [[(s.name, s.kind, s.depth) for s in st.spans] for st in tt.steps]
    assert shape == [[(s.name, s.kind, s.depth) for s in st.spans]
                     for st in jt.steps]
    fwd = next(s for s in tt.steps[0].spans if s.name == "fwd")
    assert fwd.dur_ms >= 2.0 and tt.steps[0].dur_ms >= fwd.dur_ms
    table = tt.timeline().table().splitlines()
    assert table[0] == jt.timeline().table().splitlines()[0]
    assert len(table) == 4


def test_span_passive_without_tracer_dispatches_nothing():
    assert trace.current_tracer() is None
    x = torch.ones(3)
    with _OpCount() as probe:
        with trace.span("orphan"):
            pass
        with trace.span("coll", kind="collective"):
            pass
    assert probe.n == 0
    with _OpCount() as probe:
        y = x * 2
    assert probe.n == 1 and float(y[0]) == 2.0


def test_span_opens_a_profiler_range_only_under_a_profiler():
    from torch.profiler import profile
    with trace.span("outside"):
        pass
    with profile() as prof:
        with trace.span("named_range"):
            torch.ones(4) * 3
    names = {e.name for e in prof.events()}
    assert "named_range" in names and "outside" not in names


def test_span_decorator_feeds_timeline_like_jax():
    @trace.span("work")
    def twork(x):
        return x + 1

    @jtrace.span("work")
    def jwork(x):
        return x + 1

    out = {}
    for name, mod, fn, arg in (("port", trace, twork, torch.ones(2)),
                               ("jax", jtrace, jwork, jnp.ones(2))):
        tracer = mod.Tracer()
        with tracer:
            with mod.step():
                r = fn(arg)
        out[name] = ([s.name for s in tracer.steps[0].spans], float(r[0]))
    assert out["port"] == out["jax"] == (["work"], 2.0)


@pytest.mark.parametrize("mod", [trace, jtrace], ids=["port", "jax"])
def test_in_flight_collective_and_open_spans(mod):
    tracer = mod.Tracer()
    with tracer:
        with mod.step():
            with mod.span("outer"):
                with mod.span("allreduce", kind="collective"):
                    assert tracer.open_spans == ["outer", "allreduce"]
                    assert tracer.in_flight_collective == "allreduce"
                    name, age, start = tracer.in_flight_collective_age()
                    assert name == "allreduce" and age >= 0.0
            assert tracer.in_flight_collective is None
            assert tracer.in_flight_collective_age() is None


@pytest.mark.parametrize("mod", [trace, jtrace], ids=["port", "jax"])
def test_recovered_exception_clears_in_flight(mod):
    tracer = mod.Tracer()
    with tracer:
        with mod.step(0):
            try:
                with mod.span("load", kind="collective"):
                    raise IOError("transient")
            except IOError:
                pass
            assert tracer.in_flight_collective == "load"
            assert tracer.in_flight_collective_age() is None
            with mod.span("work"):
                pass
        assert tracer.open_spans == []
        assert tracer.in_flight_collective is None
        assert tracer.last_completed_span == "work"


def _synthetic(mod):
    """A tracer holding fixed span records: two steps built by hand and a
    back-dated event added at a fixed clock, the same in both packages."""
    tracer = mod.Tracer()
    tracer._t0 = 100.0
    for i, (t0, dur, spans) in enumerate([
            (0.5, 12.0, [("dispatch", "span", 0.501, 9.5, 0),
                         ("amp/fwd", "span", 0.502, 3.25, 1),
                         ("fetch", "span", 0.511, 1.0, 0)]),
            (0.52, 10.0, [("data/load", "span", 0.52, 2.0, 0),
                          ("ddp/sync_gradients", "collective", 0.523, 4.0,
                           0)])]):
        st = mod.StepTrace(i, t0)
        st.dur_ms = dur
        st.spans = [mod.SpanEvent(*s) for s in spans]
        if i == 1:
            st.spans[-1].aborted = True
            st.aborted = True
        tracer.steps.append(st)
    tracer.add_span_event("compile/step", "compile", 7.5, t_end=100.53)
    return tracer


@pytest.mark.parametrize("rank", [0, 3])
def test_exporters_match_jax_field_for_field(rank, tmp_path):
    tt, jt = _synthetic(tspans), _synthetic(jspans)
    tc, jc = tt.chrome_trace(rank=rank), jt.chrome_trace(rank=rank)
    assert tc["traceEvents"] == jc["traceEvents"]
    assert tc["displayTimeUnit"] == jc["displayTimeUnit"]
    assert tc["metadata"] == {"producer": "apex_tpu_torch.trace",
                              "rank": rank}
    assert tt.step_events(rank) == jt.step_events(rank)
    assert tt.span_events(rank) == jt.span_events(rank)
    assert tt.timeline().table() == jt.timeline().table()
    assert tt.timeline().columns() == jt.timeline().columns()
    path = tmp_path / "events.jsonl"
    path.write_text("".join(json.dumps(e) + "\n" for e in
                            tt.step_events(rank) + tt.span_events(rank)))
    r = _validate(path)
    assert r.returncode == 0, r.stdout + r.stderr
    out = tt.write_chrome_trace(str(tmp_path / "sub" / "trace.json"),
                                rank=rank)
    assert json.load(open(out))["traceEvents"] == jc["traceEvents"]


def test_live_events_pass_trace_schema_and_logger_channel(tmp_path):
    events = tmp_path / "events.jsonl"
    logger = monitor.MetricsLogger(
        sinks=[], trace_sink=monitor.JSONLSink(str(events)))
    tracer = trace.Tracer()
    tracer.subscribe(lambda st: logger.record_event(st.to_event(0)))
    with tracer:
        for i in range(2):
            with trace.step(i + 7):
                with trace.span("x"):
                    pass
    logger.close()
    recs = [json.loads(line) for line in events.read_text().splitlines()]
    assert [r["step"] for r in recs] == [7, 8]
    assert recs[0]["spans"][0]["name"] == "x"
    assert _validate(events).returncode == 0
    path = tmp_path / "spans.jsonl"
    path.write_text("".join(json.dumps(e) + "\n"
                            for e in tracer.span_events(rank=0)))
    assert _validate(path).returncode == 0


def test_span_in_a_custom_backward_lands_in_the_callers_tracer_on_cpu():
    """The thread-local stack's trouble spot: on the CPU autograd runs a
    custom ``Function.backward`` on the calling thread, so its span lands
    in the caller's tracer (on the card the engine's device thread sees
    no tracer, and the span is passive)."""
    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            seen.append(threading.current_thread() is threading.main_thread())
            with trace.span("custom/backward", kind="collective"):
                return g * 2

    x = torch.ones(3, requires_grad=True)
    tracer = trace.Tracer()
    with tracer:
        with trace.step(0):
            Probe.apply(x).sum().backward()
    names = [(s.name, s.kind) for s in tracer.steps[0].spans]
    assert seen == [True]
    assert names == [("custom/backward", "collective")]
    assert x.grad.tolist() == [2.0, 2.0, 2.0]


# --- flight recorder -----------------------------------------------------------

def test_recorder_ring_and_rank_path_match_jax(tmp_path):
    rec = trace.FlightRecorder(str(tmp_path / "c.jsonl"), capacity=3)
    for i in range(10):
        rec.record(step=i, dur_ms=1.0, spans=[("s", 0.5)])
    lines = [json.loads(line) for line in open(rec.dump(reason="manual"))]
    assert lines[0]["kind"] == "crash"
    assert [r["step"] for r in lines[1:]] == [7, 8, 9]
    for path, rank in (("a/b.jsonl", 3), ("x.jsonl", 0), ("y", 1),
                       ("d/e.json", 12)):
        assert trace.rank_path(path, rank=rank) == \
            jtrace.rank_path(path, rank=rank)
    assert trace.rank_path(str(tmp_path / "x.jsonl")) == \
        str(tmp_path / "x.jsonl")


def test_rank_path_follows_the_launcher_env(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert trace.rank_path("d/crash.jsonl") == "d/crash.rank2.jsonl"


def test_recorder_dump_schema_and_metrics(tmp_path):
    tracer = trace.Tracer()
    rec = trace.FlightRecorder(str(tmp_path / "c.jsonl"), tracer=tracer,
                               collective_bytes=4096)
    m = monitor.metrics_init().count_step(torch.tensor(True))
    rec.note_guard({"kind": "guard_action", "step": 0, "action": "skip"})
    rec.note_straggler({"kind": "straggler", "rank": 1, "step": 0})
    rec.attach_memory_report({"peak_bytes": 123})
    with tracer:
        with trace.step(0):
            with trace.span("fwd"):
                pass
            rec.record_metrics(m)
    p = rec.dump(reason="manual")
    r = _validate(p)
    assert r.returncode == 0, r.stdout + r.stderr
    hdr, step_rec = [json.loads(line) for line in open(p)]
    assert hdr["last_completed_span"] == "fwd"
    assert hdr["guard_events"][0]["action"] == "skip"
    assert hdr["straggler_reports"][0]["rank"] == 1
    assert hdr["memory_report"] == {"peak_bytes": 123}
    assert step_rec["metrics"]["step"] == 1
    assert step_rec["loss_scale"] == 1.0
    assert step_rec["collective_bytes"] == 4096


def test_recorder_installs_only_from_the_main_thread(tmp_path):
    rec = trace.FlightRecorder(str(tmp_path / "c.jsonl"))
    box = {}

    def worker():
        try:
            rec.install()
        except RuntimeError as e:
            box["err"] = str(e)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert "main thread" in box["err"]
    assert not rec._installed
    rec.install()
    try:
        assert sys.excepthook == rec._excepthook
    finally:
        rec.uninstall()
    assert sys.excepthook != rec._excepthook


_CRASH_CHILD = textwrap.dedent("""
    import sys, time
    import torch
    from apex_tpu_torch import amp, trace
    from apex_tpu_torch.optim import FusedSGD

    mode = sys.argv[2]

    class Escalation:
        recorder = None

        def on_preempt(self):
            open(sys.argv[1] + ".preempt", "w").write(str(time.time()))

    tracer = trace.Tracer()
    rec = trace.FlightRecorder(sys.argv[1], capacity=8, tracer=tracer,
                               escalation=Escalation())
    rec.install()
    amp_opt, state = amp.initialize({"w": torch.full((4, 2), 0.5)},
                                    FusedSGD(lr=0.1), "O1", verbosity=0,
                                    monitor=True)
    x = torch.ones(4, 4)
    with tracer:
        for i in range(3):
            with trace.step(i):
                with trace.span("dispatch"):
                    state, loss, _ = amp_opt.step(
                        state, lambda p: torch.mean(x @ p["w"]))
                with trace.span("fetch"):
                    float(loss)
                rec.record_metrics(state.metrics)
        with trace.step(3):
            with trace.span("fwd"):
                pass
            with trace.span("bwd"):
                if mode == "sigterm":
                    print("MIDSTEP", flush=True)
                    while True:
                        time.sleep(0.01)
                raise RuntimeError("boom mid-step")
""")


def _steps_ok(lines):
    steps = [r for r in lines[1:] if r["kind"] == "step"]
    assert len(steps) == 4
    assert [s["metrics"]["step"] for s in steps[:3]] == [1, 2, 3]
    assert all(s["metrics"]["loss_scale"] is not None for s in steps[:3])
    assert steps[3]["aborted"] is True and steps[3].get("metrics") is None


def test_forced_midstep_exception_dumps_crash_report(tmp_path):
    dump = tmp_path / "crash.jsonl"
    r = subprocess.run([sys.executable, "-c", _CRASH_CHILD, str(dump),
                        "exception"], cwd=_ROOT, capture_output=True,
                       text=True, timeout=240)
    assert r.returncode != 0 and "boom mid-step" in r.stderr
    lines = [json.loads(line) for line in dump.read_text().splitlines()]
    hdr = lines[0]
    assert hdr["kind"] == "crash" and hdr["reason"] == "exception"
    assert hdr["last_completed_span"] == "fwd"
    assert "bwd" in hdr["in_flight_spans"]
    assert "RuntimeError" in hdr["exception"] and hdr["traceback"]
    _steps_ok(lines)
    assert _validate(dump).returncode == 0
    assert not os.path.exists(str(dump) + ".preempt")


def test_sigterm_runs_on_preempt_then_dumps(tmp_path):
    dump = tmp_path / "crash.jsonl"
    p = subprocess.Popen([sys.executable, "-c", _CRASH_CHILD, str(dump),
                          "sigterm"], cwd=_ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    try:
        assert p.stdout.readline().strip() == "MIDSTEP"
        p.send_signal(signal.SIGTERM)
        p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == -signal.SIGTERM
    lines = [json.loads(line) for line in dump.read_text().splitlines()]
    assert lines[0]["reason"] == "signal:SIGTERM"
    assert lines[0]["in_flight_spans"] == ["bwd"]
    assert float(open(str(dump) + ".preempt").read()) <= lines[0][
        "wall_time"]
    steps = [r for r in lines[1:] if r["kind"] == "step"]
    assert [s["metrics"]["step"] for s in steps] == [1, 2, 3]
    assert _validate(dump).returncode == 0


# --- hang watchdog -------------------------------------------------------------

def test_watchdog_fires_on_stalled_step_and_dump_validates(tmp_path):
    tracer = trace.Tracer()
    rec = trace.FlightRecorder(str(tmp_path / "c.jsonl"), tracer=tracer)
    fired, stalled = [], []
    wd = trace.HangWatchdog(0.15, recorder=rec, tracer=tracer,
                            path=str(tmp_path / "hang.jsonl"),
                            on_fire=fired.append, on_stall=stalled.append,
                            poll_s=0.02)
    with tracer:
        with wd:
            for i in range(2):
                with trace.step(i):
                    with trace.span("work"):
                        pass
            assert wd.fire_count == 0
            with trace.step(2):
                with trace.span("fetch"):
                    time.sleep(0.5)
    assert wd.fire_count == 1 and len(stalled) == 1
    ev = fired[0]
    assert ev["kind"] == "watchdog" and ev["last_step"] == 1
    assert ev["seconds_since_last_step"] >= 0.15
    assert ev["silent_ranks"] == [ev["rank"]]
    assert ev["last_completed_span"] == "work"
    assert ev["in_flight_spans"] == ["fetch"]
    stacks = "\n".join("\n".join(v) for v in ev["stacks"].values())
    assert "test_watchdog_fires_on_stalled_step" in stacks
    assert any(k.startswith("MainThread") for k in ev["stacks"])
    assert _validate(tmp_path / "hang.jsonl").returncode == 0


def test_watchdog_path_not_double_ranked_and_skips_metrics_read(tmp_path):
    ranked = str(tmp_path / "crash.rank0.jsonl")
    rec = trace.FlightRecorder(ranked)
    rec.record(step=0, metrics=monitor.metrics_init())
    wd = trace.HangWatchdog(30.0, recorder=rec)
    assert wd.path == str(tmp_path / "crash.rank0.hang.jsonl")
    jwd = jtrace.HangWatchdog(30.0, recorder=jtrace.FlightRecorder(ranked))
    assert os.path.basename(wd.path) == os.path.basename(jwd.path)
    wd.fire(idle_s=31.0)
    lines = [json.loads(line) for line in open(wd.path)]
    step_rec = [r for r in lines if r["kind"] == "step"][0]
    assert step_rec["metrics"] is None and step_rec["metrics_error"]
    assert _validate(wd.path).returncode == 0


def test_watchdog_rearms_and_tiers(tmp_path):
    fired, stalled = [], []
    wd = trace.HangWatchdog(0.1, path=str(tmp_path / "h.jsonl"),
                            poll_s=0.02, on_fire=fired.append,
                            on_stall=stalled.append)
    wd.start()
    time.sleep(0.3)
    assert wd.fire_count == 1
    wd.notify_step(5)
    time.sleep(0.3)
    wd.stop()
    assert wd.fire_count == 2 and len(stalled) == 2
    assert json.loads(open(tmp_path / "h.jsonl").readline())["last_step"] == 5
    wd.early_warning({"kind": "straggler", "rank": 1})
    wd.lease_expired({"kind": "cluster_lease", "expired_rank": 2})
    assert wd.warning_count == 2 and len(stalled) == 2
    assert [e["reason"] for e in fired[2:]] == ["early-warning"] * 2
    assert fired[-1]["tier"] == "lease-expiry"


_RANK_CHILD = textwrap.dedent("""
    import sys
    from apex_tpu_torch import parallel, trace
    rank = int(sys.argv[2])
    parallel.distributed_init(init_method="file://" + sys.argv[3],
                              num_processes=2, process_id=rank,
                              device="cpu", timeout_s=60)
    tracer, rec, wd, cd = parallel.enable_crash_dumps(sys.argv[1],
                                                      capacity=8)
    assert wd is None and cd is None
    with tracer:
        for i in range(2):
            with trace.step(i):
                with trace.span("dispatch"):
                    pass
        with trace.step(2):
            with trace.span("dispatch"):
                raise RuntimeError(f"forced mid-step crash on rank {rank}")
""")


def test_two_process_crash_produces_per_rank_dumps(tmp_path):
    base = tmp_path / "crash.jsonl"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_CHILD, str(base), str(r),
         str(tmp_path / "store")], cwd=_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank in range(2):
        assert f"forced mid-step crash on rank {rank}" in outs[rank]
        dump = tmp_path / f"crash.rank{rank}.jsonl"
        lines = [json.loads(line) for line in dump.read_text().splitlines()]
        hdr = lines[0]
        assert hdr["rank"] == rank and hdr["process_count"] == 2
        assert hdr["last_completed_span"] == "dispatch"
        steps = [r for r in lines[1:] if r["kind"] == "step"]
        assert [s["step"] for s in steps] == [0, 1, 2]
        assert steps[-1]["aborted"] is True
        assert _validate(dump).returncode == 0


# --- NaN provenance ------------------------------------------------------------

def test_debug_nans_names_first_bad_span_like_jax():
    jtrace.reset_nan_state()
    with jtrace.debug_nans():
        @jax.jit
        def f(x):
            a = jtrace.nan_probe("scale", x * 2)
            b = jtrace.nan_probe("log", jnp.log(-a))
            return jtrace.nan_probe("sum", jnp.sum(b))

        jax.block_until_ready(f(jnp.ones(4)))
    want = jtrace.first_nan()["span"]
    jtrace.reset_nan_state()

    trace.reset_nan_state()
    with trace.debug_nans():
        a = trace.nan_probe("scale", torch.ones(4) * 2)
        b = trace.nan_probe("log", torch.log(-a))
        trace.nan_probe("sum", torch.sum(b))
    hit = trace.first_nan()
    assert want == hit["span"] == "log"
    trace.reset_nan_state()
    assert trace.first_nan() is None


def test_debug_nans_program_order_decides_first():
    trace.reset_nan_state()
    with trace.debug_nans():
        trace.nan_probe("clean", {"a": torch.ones(2), "i": torch.arange(3)})
        trace.nan_probe("first_bad", [torch.tensor([float("inf")])])
        trace.nan_probe("second_bad", torch.tensor([float("nan")]))
        trace.nan_probe("no_floats", torch.arange(3))
    hit = trace.first_nan()
    assert hit["span"] == "first_bad"
    assert trace.first_nan()["order"] == hit["order"]
    trace.reset_nan_state()


def test_debug_nans_off_is_identity_and_dispatches_nothing():
    tree = {"a": torch.tensor([float("nan")]), "b": torch.ones(3)}
    assert not trace.debug_nans_enabled()
    with _OpCount() as probe:
        out = trace.nan_probe("fwd", tree)
    assert out is tree and probe.n == 0
    with trace.debug_nans():
        assert trace.debug_nans_enabled()
        with _OpCount() as probe:
            assert trace.nan_probe("fwd", tree) is tree
        assert probe.n > 0
    assert trace.first_nan()["span"] == "fwd"
    trace.reset_nan_state()


def _jax_amp_first(loss_of):
    jtrace.reset_nan_state()
    params = {"w": jnp.full((4, 2), 0.5, jnp.float32)}
    amp_opt, state = jamp.initialize(params, JSGD(lr=0.1), "O2",
                                     half_dtype=jnp.float16, verbosity=0)
    x = jnp.ones((4, 4), jnp.float32)
    with jtrace.debug_nans():
        @jax.jit
        def step(state):
            state, loss, _ = amp_opt.step(state, lambda p: loss_of(
                x.astype(p["w"].dtype), p["w"], jnp))
            return loss

        jax.block_until_ready(step(state))
    hit = jtrace.first_nan()
    jtrace.reset_nan_state()
    return hit and hit["span"]


def _port_amp_first(loss_of):
    trace.reset_nan_state()
    amp_opt, state = tamp.initialize({"w": torch.full((4, 2), 0.5)},
                                     TSGD(lr=0.1), "O2",
                                     half_dtype=torch.float16, verbosity=0)
    x = torch.ones(4, 4)
    with trace.debug_nans():
        amp_opt.step(state, lambda p: loss_of(x.to(p["w"].dtype), p["w"],
                                              torch))
    hit = trace.first_nan()
    trace.reset_nan_state()
    return hit and hit["span"]


LOSSES = {
    "fwd": lambda x, w, m: m.log(-m.abs(m.mean((x @ w) * 1.0))),
    "bwd": lambda x, w, m: m.mean(m.sqrt(w - w)) + m.mean(x @ w) * 0,
}


@pytest.mark.parametrize("where", sorted(LOSSES))
def test_amp_builtin_probes_name_the_span_like_jax(where):
    assert _port_amp_first(LOSSES[where]) == \
        _jax_amp_first(LOSSES[where]) == f"amp/{where}"


def test_fp16_optimizer_probes_name_fp16_spans():
    from apex_tpu_torch import fp16_utils
    opt = fp16_utils.FP16_Optimizer(TSGD(lr=0.1), dynamic_loss_scale=True)
    state = opt.init({"w": torch.full((4, 2), 0.5, dtype=torch.float16)})
    x = torch.ones(4, 4, dtype=torch.float16)
    trace.reset_nan_state()
    tracer = trace.Tracer()
    with tracer, trace.step(0), trace.debug_nans():
        out, g, fin, state = opt.backward(
            state, lambda p: torch.log(-torch.abs(torch.mean(
                (x @ p["w"]).float()))))
        opt.step(state, g, fin)
    assert trace.first_nan()["span"] == "fp16/fwd"
    assert [s.name for s in tracer.steps[0].spans] == [
        "fp16/fwd", "fp16/unscale", "fp16/update"]
    trace.reset_nan_state()


def test_recorder_header_names_the_first_nan(tmp_path):
    trace.reset_nan_state()
    with trace.debug_nans():
        trace.nan_probe("amp/bwd", torch.tensor([float("nan")]))
    rec = trace.FlightRecorder(str(tmp_path / "c.jsonl"))
    hdr = json.loads(open(rec.dump(reason="manual")).readline())
    assert hdr["first_nan_span"] == "amp/bwd"
    trace.reset_nan_state()
