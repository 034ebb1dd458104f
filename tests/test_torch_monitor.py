"""apex_tpu_torch.monitor — Metrics, the amp and FP16_Optimizer hooks,
sinks and the logger — against the JAX package's ``tests/test_monitor.py``.

The same toy models, inputs and forced overflows run through both
packages: the loss-scale events, an fp16 ``Amp(monitor=True)`` run and an
``FP16_Optimizer(monitor=True)`` run hold ``step``, ``overflow_count``,
``skip_count``, ``growth_count``, ``backoff_count`` and ``loss_scale``
bit for bit and ``loss``, ``grad_norm``, ``param_norm`` within 1e-5
relative (f32); the two loggers' flushed JSONL agree apart from the
timing fields; the sinks render the same records to the same text;
``convert.metrics_from_jax`` and the checkpoint path carry a state's
``metrics`` (with and without); the step builders' ``monitor=`` track
the JAX steps'.
"""

import functools
import io
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import fp16_utils as jfp
from apex_tpu import monitor as jmon
from apex_tpu.optim import FusedSGD as JSGD

from apex_tpu_torch import amp as tamp
from apex_tpu_torch import convert
from apex_tpu_torch import fp16_utils as tfp
from apex_tpu_torch import monitor as tmon
from apex_tpu_torch.optim import FusedSGD as TSGD

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
COUNTERS = ("step", "overflow_count", "skip_count", "growth_count",
            "backoff_count", "loss_scale")
GAUGES = ("loss", "grad_norm", "param_norm")


def _jdict(m):
    return jmon.metrics_to_dict(jax.device_get(m))


def _tdict(m):
    return tmon.metrics_to_dict(m)


def _same_metrics(tm, jm, rtol=1e-5):
    t, j = _tdict(tm), _jdict(jm)
    assert {k: t[k] for k in COUNTERS} == {k: j[k] for k in COUNTERS}
    for k in GAUGES:
        assert t[k] == pytest.approx(j[k], rel=rtol, abs=1e-30), k
    assert tm.step.dtype == torch.int32 and tm.loss.dtype == torch.float32


def test_metrics_fields_and_init_match_jax():
    assert tmon.METRIC_FIELDS == jmon.METRIC_FIELDS
    assert _tdict(tmon.metrics_init(device="cpu")) == _jdict(
        jmon.metrics_init())
    m = tmon.metrics_init(device="cpu").count_step(
        torch.tensor(False)).record_loss(
        torch.tensor(3.5)).record_norms(grad_norm=2.0, param_norm=1.5)
    jm = jmon.metrics_init().count_step(jnp.bool_(False)).record_loss(
        3.5).record_norms(grad_norm=2.0, param_norm=1.5)
    assert _tdict(m) == _jdict(jm)
    assert _tdict(m.count_step(True)) == _jdict(jm.count_step(True))
    snap = tmon.metrics_snapshot(m)
    assert all(a is not b and torch.equal(a, b) for a, b in zip(snap, m))


@pytest.mark.parametrize("case", ["growth", "backoff", "static"])
def test_scaler_events_match_jax(case):
    kw = {"growth": dict(init_scale=4.0, growth_interval=3),
          "backoff": dict(init_scale=2.0 ** 16),
          "static": dict(init_scale=128.0, dynamic=False)}[case]
    seq = {"growth": [True] * 6, "backoff": [False, True, False],
           "static": [False, True]}[case]
    jc, tc = jamp.LossScaleConfig(**kw), tamp.LossScaleConfig(**kw)
    js, ts = jamp.loss_scale_init(jc), tamp.loss_scale_init(tc, "cpu")
    jm, tm = jmon.metrics_init(), tmon.metrics_init(device="cpu")
    for fin in seq:
        js, jm = jamp.loss_scale_update(js, jnp.bool_(fin), jc, metrics=jm)
        ts, tm = tamp.loss_scale_update(ts, torch.tensor(fin), tc,
                                        metrics=tm)
        assert _tdict(tm) == _jdict(jm)
    assert float(ts.loss_scale) == float(js.loss_scale)


def _toy(pkg):
    rng = np.random.RandomState(0)
    w = rng.randn(4, 2).astype(np.float32) * 0.5
    b = rng.randn(2).astype(np.float32) * 0.1
    x = rng.randn(4, 4).astype(np.float32)
    if pkg == "jax":
        return {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x)
    return {"w": torch.tensor(w), "b": torch.tensor(b)}, torch.tensor(x)


#: loss multipliers a step: two forced overflows among finite steps
SCALES = [1.0, 1.0, float("inf"), 1.0, float("inf"), 1.0]


def _amp_runs(opt_level, half, monitor=True):
    jp, jx = _toy("jax")
    tp, tx = _toy("port")
    jopt, js = jamp.initialize(jp, JSGD(lr=0.1), opt_level,
                               half_dtype=half[0], verbosity=0,
                               monitor=monitor)
    topt, ts = tamp.initialize(tp, TSGD(lr=0.1), opt_level,
                               half_dtype=half[1], verbosity=0,
                               monitor=monitor)

    @jax.jit
    def jstep(state, scale):
        def loss_fn(p):
            return jnp.mean(jnp.square(jx @ p["w"] + p["b"])) * scale
        state, loss, _ = jopt.step(state, loss_fn)
        return state, loss

    out = []
    for scale in SCALES:
        js, _ = jstep(js, jnp.float32(scale))

        def tloss(p):
            y = tx @ p["w"].float() + p["b"].float()
            return torch.mean(torch.square(y)) * scale
        ts, _, _ = topt.step(ts, tloss)
        out.append((js, ts))
    return out


def test_amp_fp16_overflow_run_matches_jax():
    for i, (js, ts) in enumerate(_amp_runs("O2", (jnp.float16,
                                                  torch.float16))):
        _same_metrics(ts.metrics, js.metrics)
        assert int(ts.step) == int(js.step)
    m = _tdict(ts.metrics)
    skips = m["skip_count"]
    assert m["step"] == 6 and skips >= 2            # the two forced ones
    assert m["overflow_count"] == m["backoff_count"] == skips
    assert m["loss_scale"] == 2.0 ** (16 - skips)
    assert np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0


def test_amp_bf16_unscaled_run_matches_jax():
    for js, ts in _amp_runs("O2", (jnp.bfloat16, torch.bfloat16))[:2]:
        t, j = _tdict(ts.metrics), _jdict(js.metrics)
        assert {k: t[k] for k in COUNTERS} == {k: j[k] for k in COUNTERS}
        for k in GAUGES:
            assert t[k] == pytest.approx(j[k], rel=1e-2)
    assert t["loss_scale"] == 1.0 and t["overflow_count"] == 0


def test_amp_monitor_off_keeps_metrics_none_and_footprint():
    js, ts = _amp_runs("O2", (jnp.float16, torch.float16),
                       monitor=False)[-1]
    assert ts.metrics is None and js.metrics is None
    jp, _ = _toy("jax")
    tp, _ = _toy("port")
    for mon in (False, True):
        ja = jamp.Amp(jamp.Policy.from_opt_level("O2"), JSGD(lr=0.1),
                      monitor=mon)
        ta = tamp.Amp(tamp.Policy.from_opt_level("O2"), TSGD(lr=0.1),
                      monitor=mon)
        assert ta.memory_footprint(tp) == ja.memory_footprint(jp)


def test_guarded_step_gauges_the_true_grad_norm():
    """Under ``Amp.step(guard=)`` the grad-norm gauge is the unscaled
    gradients' true norm (``metrics_grad_norm``), as in the JAX package."""
    from apex_tpu_torch import guard
    tp, tx = _toy("port")
    topt, ts = tamp.initialize(tp, TSGD(lr=0.1), "O0", verbosity=0,
                               monitor=True)
    gcfg = guard.GuardConfig()
    gs = guard.guard_init(gcfg, device="cpu")

    def loss(p):
        return torch.mean(torch.square(tx @ p["w"] + p["b"]))

    _, grads, _, _ = topt.backward(ts, loss)
    want = float(tmon.metrics.tree_norm(grads))
    ts, _, committed, gs = topt.step(ts, loss, guard=(gs, gcfg))
    assert bool(committed)
    assert float(ts.metrics.grad_norm) == pytest.approx(want, rel=1e-6)


def _fp16_runs():
    jp, jx = _toy("jax")
    tp, tx = _toy("port")
    jopt = jfp.FP16_Optimizer(JSGD(lr=0.1), dynamic_loss_scale=True,
                              dynamic_loss_args={"init_scale": 2.0 ** 10,
                                                 "scale_window": 2},
                              monitor=True)
    topt = tfp.FP16_Optimizer(TSGD(lr=0.1), dynamic_loss_scale=True,
                              dynamic_loss_args={"init_scale": 2.0 ** 10,
                                                 "scale_window": 2},
                              monitor=True)
    js = jopt.init({k: v.astype(jnp.float16) for k, v in jp.items()})
    ts = topt.init({k: v.half() for k, v in tp.items()})

    @jax.jit
    def jstep(state, scale):
        def loss_fn(mp):
            y = jx @ mp["w"].astype(jnp.float32) + mp["b"].astype(
                jnp.float32)
            return jnp.mean(jnp.square(y)) * scale
        _, grads, finite, state = jopt.backward(state, loss_fn)
        return jopt.step(state, grads, finite)

    out = []
    for scale in SCALES:
        js = jstep(js, jnp.float32(scale))

        def tloss(mp):
            y = tx @ mp["w"].float() + mp["b"].float()
            return torch.mean(torch.square(y)) * scale
        _, g, fin, ts = topt.backward(ts, tloss)
        ts = topt.step(ts, g, fin)
        out.append((js, ts))
    return out, topt


def test_fp16_optimizer_overflow_run_matches_jax():
    runs, topt = _fp16_runs()
    for js, ts in runs:
        _same_metrics(ts.metrics, js.metrics)
    m = _tdict(ts.metrics)
    assert (m["step"], m["skip_count"]) == (6, 2)
    assert m["loss_scale"] == float(topt.loss_scale(ts))
    # the legacy state_dict round-trip keeps the metrics
    restored = topt.load_state_dict(ts, topt.state_dict(ts))
    assert _tdict(restored.metrics) == m


def _log(mod, metrics_seq, path):
    logger = mod.MetricsLogger(sinks=[mod.JSONLSink(str(path))],
                               flush_every=4)
    for m in metrics_seq:
        logger.record(m, images_per_step=8)
    logger.close()
    return [json.loads(line) for line in path.read_text().splitlines()]


TIMING = ("step_time_ms", "throughput_steps_per_s", "wall_time")


def test_logger_jsonl_matches_jax_apart_from_timing(tmp_path):
    runs = _amp_runs("O2", (jnp.float16, torch.float16))
    jrec = _log(jmon, [js.metrics for js, _ in runs], tmp_path / "j.jsonl")
    trec = _log(tmon, [ts.metrics for _, ts in runs], tmp_path / "t.jsonl")
    assert len(trec) == len(jrec) == len(SCALES)
    for t, j in zip(trec, jrec):
        assert set(t) == set(j)
        for k in t:
            if k in TIMING:
                continue
            if k in GAUGES and t[k] is not None:
                assert t[k] == pytest.approx(j[k], rel=1e-5)
            else:
                assert t[k] == j[k], k
    assert trec[0]["step_time_ms"] is None and trec[0]["mfu"] is None
    r = subprocess.run([sys.executable, os.path.join(
        _ROOT, "scripts", "check_metrics_schema.py"),
        str(tmp_path / "t.jsonl")], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("donation_safe", [False, True])
def test_logger_fetches_once_a_flush(monkeypatch, donation_safe):
    """One device-to-host copy a flush, of every buffered field; with
    ``donation_safe`` each record is a clone, unchanged by later in-place
    writes to the tensors it came from."""
    calls, got = [], []
    real = torch.Tensor.cpu

    def spy(self, *a, **k):
        calls.append(tuple(self.shape))
        return real(self, *a, **k)

    class Sink(tmon.Sink):
        def emit(self, record):
            got.append(record["step"])

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    logger = tmon.MetricsLogger(sinks=[Sink()], flush_every=5,
                                donation_safe=donation_safe)
    m = tmon.metrics_init(device="cpu")
    for _ in range(5):
        m = m.count_step(torch.tensor(True))
        logger.record(m)
        m.step.add_(100)      # in place (the fifth record flushed first)
    assert calls == [(45,)]
    assert got == ([1, 102, 203, 304, 405] if donation_safe
                   else [101, 202, 303, 404, 405])
    logger.close()


def test_sinks_render_like_jax():
    rec = {"step": 3, "loss": 1.25, "loss_scale": 65536.0, "grad_norm":
           0.000123, "skip_count": 1, "step_time_ms": 12.5,
           "throughput_steps_per_s": 80.0, "mfu": None,
           "wire_by_dtype": {"bf16": 50 * 2 ** 20, "f32": 3 * 2 ** 10},
           "wire_to_logical": 0.5, "extra": "x"}
    recs = [rec, dict(rec, step=4, wire_by_dtype={}, mfu=0.4321),
            dict(rec, step=5, wire_by_dtype=None, loss=None)]
    for name in ("StdoutSink", "JSONLSink", "CSVSink"):
        outs = []
        for mod in (jmon, tmon):
            buf = io.StringIO()
            sink = getattr(mod, name)(buf)
            for r in recs:
                sink.emit(dict(r))
            sink.close()
            outs.append(buf.getvalue())
        assert outs[0] == outs[1], name


def test_channel_registry_matches_jax(tmp_path):
    assert [tuple(c)[:5] for c in tmon.CHANNELS] == [
        tuple(c)[:5] for c in jmon.CHANNELS]
    sinks = {f"{c.name}_sink": tmon.JSONLSink(str(tmp_path / c.name))
             for c in tmon.CHANNELS}
    logger = tmon.MetricsLogger(sinks=[], **sinks)
    for c in tmon.CHANNELS:
        getattr(logger, c.method)({"kind": c.kinds[0], "z": float("nan"),
                                   "buckets_ms": {"a": float("inf")}})
    logger.close()
    for c in tmon.CHANNELS:
        ev = json.loads((tmp_path / c.name).read_text())
        assert ev["z"] is None if c.null_nonfinite else ev["z"] != ev["z"]
    with pytest.raises(TypeError, match="unknown channel"):
        tmon.MetricsLogger(sinks=[], bogus_sink=None)


def test_logger_waits_for_prof_and_nulls_nonfinite(tmp_path):
    # prof/ is ported: the MFU statics are taken, attach runs the step
    # once, and only the lint report still waits (queue A, item 12)
    assert tmon.MetricsLogger(sinks=[], peak_flops=1e12).peak_flops == 1e12
    assert tmon.MetricsLogger(
        sinks=[], flops_per_step=1e9).flops_per_step == 1e9
    logger = tmon.MetricsLogger(sinks=[tmon.JSONLSink(str(
        tmp_path / "m.jsonl"))], flush_every=10)
    a, b = torch.ones(4, 3), torch.ones(3, 2)
    assert logger.attach(torch.mm, a, b).flops_per_step == 2 * 4 * 3 * 2
    assert logger.collective_bytes_per_step == 0
    assert logger.sample_memory(0) is None          # no memory sink
    for call in (lambda: logger.attach_memory_report(None),
                 lambda: logger.attach_shard_report(None),
                 lambda: logger.attach_roofline_report(None)):
        assert call() is logger
    with pytest.raises(NotImplementedError, match="item 12"):
        logger.attach_lint_report(None)
    logger.record(tmon.metrics_init(device="cpu").record_loss(float("inf")))
    logger.close()
    rec = json.loads((tmp_path / "m.jsonl").read_text())
    assert rec["loss"] is None and rec["mfu"] is None


def test_logger_flushes_buffered_tail_on_exception(tmp_path):
    jsonl = tmp_path / "m.jsonl"
    with pytest.raises(RuntimeError):
        with tmon.MetricsLogger(sinks=[tmon.JSONLSink(str(jsonl))],
                                flush_every=100) as logger:
            logger.record(tmon.metrics_init(device="cpu").count_step(True))
            raise RuntimeError("mid-run crash")
    assert json.loads(jsonl.read_text())["step"] == 1


def test_logger_atexit_flush_in_subprocess(tmp_path):
    jsonl = tmp_path / "m.jsonl"
    child = textwrap.dedent(f"""
        from apex_tpu_torch import monitor
        logger = monitor.MetricsLogger(
            sinks=[monitor.JSONLSink({str(jsonl)!r})], flush_every=100)
        logger.record(monitor.metrics_init(device="cpu").count_step(True))
    """)
    r = subprocess.run([sys.executable, "-c", child], cwd=_ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(jsonl.read_text().splitlines()) == 1


def test_metrics_from_jax_bit_for_bit():
    jm = jmon.metrics_init().count_step(jnp.bool_(False)).record_loss(
        np.float32(1.0) / 3).record_norms(grad_norm=np.float32(2.5e-7),
                                          param_norm=np.float32(123.456))
    tm = convert.metrics_from_jax(jm, device="cpu")
    for name in tmon.METRIC_FIELDS:
        a, b = getattr(tm, name), np.asarray(getattr(jm, name))
        assert a.numpy().tobytes() == b.tobytes(), name
    assert convert.metrics_from_jax(None) is None


@pytest.mark.parametrize("monitor", [False, True])
def test_checkpoint_round_trip_with_and_without_metrics(tmp_path, monitor):
    from apex_tpu_torch import ckpt
    _, ts = _amp_runs("O2", (jnp.float16, torch.float16),
                      monitor=monitor)[3]
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(4, {"amp": ts}, block=True)
    mgr.wait()
    tp, _ = _toy("port")
    _, fresh = tamp.initialize(tp, TSGD(lr=0.1), "O2",
                               half_dtype=torch.float16, verbosity=0,
                               monitor=monitor)
    tree, _ = mgr.restore({"amp": fresh})
    got = tree["amp"]
    if not monitor:
        assert got.metrics is None
        return
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(got.metrics, ts.metrics))


def test_jax_checkpoint_carries_metrics(tmp_path):
    from apex_tpu import ckpt as jckpt
    js, _ = _amp_runs("O2", (jnp.float16, torch.float16))[4]
    mgr = jckpt.CheckpointManager(str(tmp_path / "jck"))
    mgr.save(5, {"amp": js}, block=True)
    mgr.wait()
    tp, _ = _toy("port")
    state, manifest = convert.amp_state_from_jax_checkpoint(
        jckpt.latest_checkpoint(str(tmp_path / "jck")), tp, device="cpu",
        prefix="['amp']")
    assert manifest["step"] == 5
    assert _tdict(state.metrics) == _jdict(js.metrics)
    assert int(state.step) == int(js.step)


# --- the step builders' monitor= -----------------------------------------------

def test_build_resnet_step_monitor_tracks_jax():
    """``build_resnet_step(monitor=True)`` at O0 (f32) against the JAX
    package's ``_resnet_step_builder`` step under ``Amp(monitor=True)``,
    on the same small model, weights and inputs: two steps."""
    from test_torch_resnet import _jax_o2_step, _models, _variables, B, S
    from apex_tpu_torch import train
    from apex_tpu_torch.convert import resnet_variables_from_jax
    jm, tm = _models("bottleneck")
    params, bstats = _variables(jm, seed=4)
    tp, tbs = resnet_variables_from_jax(params, bstats, device="cpu")
    tm.load_state_dict({**tp, **tbs})
    step, (ts, tbs), (tx, ty), _, _ = train.build_resnet_step(
        B, S, opt_level="O0", model=tm, device="cpu", monitor=True)
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.rand(B, S, S, 3).astype(np.float32))
    y = jnp.asarray(rng.randint(0, 10, B), jnp.int32)
    real = jamp.Amp
    jamp.Amp = functools.partial(real, monitor=True)
    try:
        js, jstep = _jax_o2_step(jm, params, bstats, x, y,
                                 jamp.Policy.from_opt_level("O0"))
    finally:
        jamp.Amp = real
    jbs = bstats
    for _ in range(2):
        js, jbs, _, _ = jstep(js, jbs, False)
        ts, tbs, loss = step(ts, tbs, tx, ty)
        _same_metrics(ts.metrics, js.metrics, rtol=1e-4)
    assert _tdict(ts.metrics)["loss"] == loss.item()
    assert _tdict(ts.metrics)["step"] == 2


def test_build_bert_step_monitor_tracks_jax(monkeypatch):
    import bench
    from test_torch_bert import BATCH, SEQ, VOCAB, _encoders
    from apex_tpu_torch import train
    from apex_tpu_torch.convert import params_from_jax
    monkeypatch.setattr(jamp, "Amp", functools.partial(jamp.Amp,
                                                       monitor=True))
    jenc, _, tenc = _encoders()
    jstep, js, (jtoks, jlab), _, _, jvars = bench._bert_step_builder(
        BATCH, SEQ, encoder=jenc, vocab=VOCAB)
    tenc.load_state_dict(params_from_jax(jvars["params"], device="cpu"))
    tstep, ts, (ttoks, tlab), _, _ = train.build_bert_step(
        BATCH, SEQ, encoder=tenc, device="cpu", vocab=VOCAB, monitor=True)
    jstep = jax.jit(jstep)
    for _ in range(2):
        js, _ = jstep(js, jtoks, jlab)
        ts, tloss = tstep(ts, ttoks, tlab)
    t, j = _tdict(ts.metrics), _jdict(js.metrics)
    assert {k: t[k] for k in COUNTERS} == {k: j[k] for k in COUNTERS}
    for k in GAUGES:
        assert t[k] == pytest.approx(j[k], rel=2e-2), k
    assert t["loss"] == tloss.item()


def test_metrics_init_defaults_to_the_card():
    """Like the port's other entry points, ``metrics_init`` lands on the
    card unless the caller asks for the CPU (read from the signature: no
    tensor is made)."""
    import inspect
    default = inspect.signature(tmon.metrics_init).parameters["device"]
    assert default.default == "cuda"
