"""The port's prof/ analytics held against apex_tpu.prof on the same numbers.

Pure-function oracles, no compiled steps: the perf sentinel over the
committed bench trajectory (BENCH_r01-r05) and over the same with a
seeded 45% MFU drop; roofline rows (efficiency, gap, bound class,
fingerprint), ``what_if`` and ``worst_gaps`` for the same (flops, bytes,
measured us); a synthetic Chrome trace parsed into the aggregates the JAX
``TraceProfile`` gives over the same records; the family classifier; and
the roofline event stream under ``check_metrics_schema.py``. Exact
equality throughout (the same float formulas on the same inputs).
"""

import copy
import json
import os

from apex_tpu.prof import roofline as jroof
from apex_tpu.prof import sentinel as jsent
from apex_tpu.prof import xplane as jxp
from apex_tpu_torch import monitor as tmon
from apex_tpu_torch.prof import roofline as troof
from apex_tpu_torch.prof import sentinel as tsent
from apex_tpu_torch.prof import xplane as txp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = [os.path.join(ROOT, f"BENCH_r0{i}.json") for i in range(1, 6)]


def _schema():
    from importlib import util
    spec = util.spec_from_file_location(
        "check_metrics_schema",
        os.path.join(ROOT, "scripts", "check_metrics_schema.py"))
    mod = util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sentinel_verdicts_equal_on_bench_trajectory_and_seeded_drop():
    rows_t, rows_j = tsent.load_rows(BENCH), jsent.load_rows(BENCH)
    assert rows_t == rows_j
    # the trajectory as committed, then its last measured row again with
    # the MFU cut by 45% (a regression the gate must flag)
    drop = copy.deepcopy(rows_t[3])
    drop["path"] = "seeded_drop"
    drop["metrics"]["mfu"] *= 0.55
    for rows in (rows_t, rows_t + [drop]):
        rt = tsent.check_trajectory(rows)
        rj = jsent.check_trajectory(copy.deepcopy(rows))
        assert rt.to_events() == rj.to_events()
        assert rt.table() == rj.table() and rt.ok == rj.ok
        assert [v.fingerprint for v in rt.regressions] == \
            [v.fingerprint for v in rj.regressions]
    assert [v.metric for v in rt.regressions] == ["mfu"]
    assert tsent.check_trajectory(rows_t).ok
    assert _schema().check_roofline_lines(
        [json.dumps(e) for e in rt.to_events()]) == []


# (name, opcode, family, scope, flops, bytes, occurrences, measured_us,
#  compute_us, memory_us, bound, dtype, shape)
_ROWS = [
    ("mm.1", "dot", "gemm", "amp/fwd/dense", 1.2e12, 3.1e7, 48, 1650.0,
     1213.3, 9.25, "compute", "bf16", "bf16[8192,4096]"),
    ("ln.2", "custom-call", "layer_norm", "amp/fwd/layer_norm", 0.0, 3.4e7,
     49, 14.2, 0.0, 10.1, "memory", "bf16", "bf16[8192,1024]"),
    ("attn.3", "custom-call", "attention", "amp/fwd/attention", 1.1e11,
     4.2e7, 24, 160.0, 111.2, 12.5, "compute", "bf16",
     "bf16[16,512,16,64]"),
    ("ce.4", "custom-call", "xentropy", "amp/loss/xentropy", 0.0, 5.0e8, 1,
     180.0, 0.0, 149.3, "memory", "bf16", "bf16[8192,30522]"),
    ("upd.5", "fusion", "optimizer", "amp/update/lamb", 5.0e9, 9.4e9, 1,
     2950.0, 74.6, 2805.9, "memory", "f32", "f32[335544320]"),
    ("fast.6", "fusion", "other", "amp/fwd/gelu", 0.0, 6.7e7, 24, 15.0,
     0.0, 20.0, "memory", "bf16", "bf16[8192,4096]"),
    ("aot.7", "fusion", "other", "", 0.0, 1.0e6, 0, None, 0.0, 0.3,
     "memory", "f32", "f32[1000]"),
]


def _reports():
    out = []
    for mod in (jroof, troof):
        rows = [mod.RooflineRow(*r) for r in _ROWS]
        out.append(mod.RooflineReport(
            rows=rows, device_kind="x", peak_flops=989e12, hbm_bw=3.35e12,
            profile_total_us=1.0, module_total_us=sum(
                (r.measured_us or 0) * max(r.occurrences, 1) for r in rows),
            module_runs=1))
    return out


def test_roofline_rows_what_if_and_worst_gaps_equal_jax():
    rj, rt = _reports()
    for a, b in zip(rj.rows, rt.rows):
        assert (a.efficiency, a.gap_us, a.bound, a.attainable_us,
                a.fingerprint) == (b.efficiency, b.gap_us, b.bound,
                                   b.attainable_us, b.fingerprint)
        assert a.to_event(rank=1, step=3) == b.to_event(rank=1, step=3)
    assert rt.rows[5].raw_efficiency > 1.0 == rt.rows[5].efficiency
    assert rj.worst_gaps(4) == rt.worst_gaps(4)
    assert rj.by_family() == rt.by_family()
    assert rj.by_scope(2) == rt.by_scope(2)
    assert rj.check_closure() == rt.check_closure()
    assert rj.summary() == rt.summary()
    for plan in ({"layer_norm": "fp8_e4m3", "dense": "fp8_e5m2"},
                 {"lamb": "bf16", "attention": "fp16"}):
        assert rj.what_if(plan) == rt.what_if(plan)
    evs = rt.to_events(rank=0, step=7)
    assert evs == rj.to_events(rank=0, step=7)
    assert _schema().check_roofline_lines([json.dumps(e) for e in evs]) == []


def test_family_classifier_and_kernel_categories():
    for scope, opcode, cat, fam in (
            ("amp/fwd", "apex_tpu_torch::flash_attn_fwd", "flash_attn",
             "attention"),
            ("", "apex_tpu_torch::layer_norm_bwd", "layer_norm",
             "layer_norm"),
            ("", "apex_tpu_torch::lamb_stage1", "arena_lamb", "optimizer"),
            ("amp/fwd", "aten::mm", "gemm", "gemm"),
            ("ddp/sync_gradients", "c10d::allreduce_", "collective",
             "collective"),
            ("", "aten::copy_", "cast", "copy"),
            ("", "aten::gelu", "elementwise", "other")):
        assert troof.classify_family(scope, opcode, cat) == fam
    # the scope conventions both packages share classify alike
    for scope in ("amp/fwd/layer_norm", "x/attention/q", "amp/update/lamb",
                  "bert/mlp", "loss/xentropy"):
        assert troof.classify_family(scope) == jroof.classify_family(scope)
    assert txp.category("ncclDevKernel_AllReduce_Sum_f32") == "collective"
    assert txp.category("void ln_fwd_warp<__nv_bfloat16, 8>(...)") == \
        "layer_norm"
    assert txp.category("sm90_xmma_gemm_bf16bf16_bf16f32") == "gemm"


def _synthetic_trace(path):
    """Two profiled steps: kernels launched from aten ops (record_shapes
    dims), from a hand kernel's range, and one NCCL kernel; the spins of
    the session's lead fall outside the window."""
    ev, corr = [], [0]

    def op(cat, name, ts, dur, tid=1, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 7,
                   "tid": tid, "ts": ts, "dur": dur, "args": args})

    def launch(name, ts, kdur, tid=1):
        corr[0] += 1
        op("cuda_runtime", "cudaLaunchKernel", ts, 1.0, tid=tid,
           correlation=corr[0])
        ev.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                   "tid": 7, "ts": ts + 50, "dur": kdur,
                   "args": {"correlation": corr[0], "device": 0}})

    launch("spin_kernel(long)", 1, 5.0)
    op("user_annotation", "apex_tpu_torch::profile_step", 100, 900)
    for s in (0, 400):
        op("user_annotation", "amp/fwd", 110 + s, 300)
        op("cpu_op", "aten::mm", 120 + s, 20, **{"Input Dims": [[64, 32],
                                                                [32, 16]]})
        launch("sm90_xmma_gemm_bf16", 125 + s, 12.5)
        op("user_annotation", "apex_tpu_torch::layer_norm_fwd", 150 + s, 30)
        op("cpu_op", "aten::empty", 152 + s, 2)
        launch("void ln_fwd_warp<bf16>", 160 + s, 4.25)
        op("cpu_op", "aten::gelu", 200 + s, 10, **{"Input Dims": [[64, 16]]})
        launch("vectorized_elementwise_kernel<gelu>", 202 + s, 1.5)
        op("cpu_op", "c10d::allreduce_", 300 + s, 30, tid=2)
        launch("ncclDevKernel_AllReduce_Sum_f32", 305 + s, 20.0, tid=2)
    ev.append({"ph": "X", "cat": "gpu_user_annotation", "name": "amp/fwd",
               "pid": 0, "tid": 7, "ts": 160, "dur": 300, "args": {}})
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_chrome_trace_parses_into_jax_trace_profile_aggregates(tmp_path):
    path = tmp_path / "t.pt.trace.json"
    _synthetic_trace(path)
    tp = txp.parse_trace(str(tmp_path), window="apex_tpu_torch::profile_step")
    assert tp.module_runs == 1 and tp.device == "cuda:0"
    assert [(k.name, k.kernel, k.scope) for k in tp.kernels[:2]] == [
        ("sm90_xmma_gemm_bf16", "", "amp/fwd"),
        ("void ln_fwd_warp<bf16>", "layer_norm_fwd", "amp/fwd")]
    assert tp.kernels[0].ops[0][:2] == ("aten::mm", [[64, 32], [32, 16]])
    # the JAX TraceProfile over the same per-kernel records
    recs = [jxp.OpRecord(name=r.name, opcode=r.opcode, category=r.category,
                         occurrences=r.occurrences, total_us=r.total_us,
                         hlo=f'x = f32[] custom-call(), metadata={{op_name='
                             f'"jit(step)/{r.scope}"}}')
            for r in tp.ops]
    jtp = jxp.TraceProfile(path=str(path), device="", ops=recs,
                           module_runs=1,
                           module_total_us=tp.module_total_us)
    assert tp.by_category() == jtp.by_category() == {
        "collective": 40.0, "gemm": 25.0, "layer_norm": 8.5,
        "elementwise": 3.0}
    assert tp.by_scope() == jtp.by_scope()
    assert tp.table() .splitlines()[1:] == jtp.table().splitlines()[1:]
    assert tp.module_total_us == 76.5       # the spin left out
    assert txp.parse_trace(str(path)).module_total_us == 81.5


def test_roofline_join_over_the_synthetic_trace(tmp_path):
    """The aten op's cost comes from a counted run of the same shapes,
    the hand kernel's from its logged call; closure is exact."""
    import torch
    from apex_tpu_torch.prof import cost
    path = tmp_path / "t.pt.trace.json"
    _synthetic_trace(path)
    tp = txp.parse_trace(str(path), window="apex_tpu_torch::profile_step")
    with cost.CostCounter() as c:
        torch.mm(torch.ones(64, 32, dtype=torch.bfloat16),
                 torch.ones(32, 16, dtype=torch.bfloat16))
    calls = [("layer_norm_fwd", cost.Cost(0.0, 1.0e6, sig="64x1024:bf16"))
             ] * 2
    rep = troof.roofline_report(profile=tp, counter=c, kernel_calls=calls,
                                peak_flops=1e12, hbm_bw=1e12,
                                f32_flops=1e11, device_kind_="test")
    assert rep.check_closure(1e-12) == (True, 0.0)
    by = {r.opcode: r for r in rep.rows}
    mm = by["aten::mm"]
    assert (mm.flops, mm.occurrences, mm.measured_us) == (
        2 * 64 * 32 * 16, 2, 12.5)
    assert mm.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 2
    ln = by["apex_tpu_torch::layer_norm_fwd"]
    assert (ln.bytes, ln.occurrences, ln.family, ln.memory_us) == (
        1.0e6, 2, "layer_norm", 1.0)
    assert by["c10d::allreduce_"].family == "collective"
    path_ev = tmp_path / "r.jsonl"
    logger = tmon.MetricsLogger(
        sinks=[], roofline_sink=tmon.JSONLSink(str(path_ev)))
    logger.attach_roofline_report(rep)
    logger.close()
    assert _schema().check_roofline_lines(
        path_ev.read_text().splitlines()) == []
