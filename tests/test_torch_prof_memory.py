"""The port's memory and shard reports on the CPU, against apex_tpu.prof.

``classify_arg_path``/``classify_scope`` and ``forecast``/``max_batch``
give the JAX side's answers on the same inputs; a small MLP step's
peak-live estimate is exactly the sum of the tensors live at its peak;
``DistributedDataParallel.memory_report`` infers the per-rank batch (a
one-rank gloo group in this process); a ZeRO-shaped state's shard report
puts the optimizer slots sharded by ``data`` and the params replicated
over it, closes over the memory report, and its stream, the memory
channel's and the sample's pass ``check_metrics_schema.py``.
"""

import json
import os
import types

import torch

from apex_tpu.prof import memory as jmem
from apex_tpu_torch import monitor as tmon
from apex_tpu_torch import prof as tprof
from apex_tpu_torch.amp.api import AmpState
from apex_tpu_torch.lint.mesh_model import MeshAxis, MeshModel
from apex_tpu_torch.optim.distributed import ShardedOptState
from apex_tpu_torch.prof import memory as tmem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _schema():
    from importlib import util
    spec = util.spec_from_file_location(
        "check_metrics_schema",
        os.path.join(ROOT, "scripts", "check_metrics_schema.py"))
    mod = util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_classifiers_and_forecast_equal_jax():
    for path in (".params['w']", "[0][0].opt_state.slots['m']['float32']",
                 "state.master", "[0].scalers[0].loss_scale",
                 "[0].metrics.step", "batch_stats['bn']", "[1]",
                 "residual['g']", "OPTIMIZER.v"):
        assert tmem.classify_arg_path(path) == jmem.classify_arg_path(path)
    for scope, op in (("amp/fwd", "aten::mm"), ("ddp/sync_gradients", "x"),
                      ("zero/bucket03/ici", "fusion"), ("", "all-reduce"),
                      ("a/bucket1x", "add")):
        assert tmem.classify_scope(scope, op) == jmem.classify_scope(scope,
                                                                     op)
    assert tmem.classify_scope("", "c10d::allreduce_") == "comm"
    kw = dict(stats={"total": 10}, classes={}, buffers=[],
              peak_live_bytes=9_000_000, batch_size=16,
              batch_bytes=6_000_000, device_kind="x")
    for limit in (None, 20_000_000, 2_000_000):
        a = jmem.MemoryReport(hbm_limit=limit, **kw)
        b = tmem.MemoryReport(hbm_limit=limit, **kw)
        assert a.max_batch() == b.max_batch()
        for batch in (1, 16, 32, 48):
            assert a.forecast(batch) == b.forecast(batch)


def test_mlp_step_peak_live_is_its_known_tensors():
    n, d, h, o = 64, 32, 128, 16
    x, w1, w2 = torch.randn(n, d), torch.randn(d, h), torch.randn(h, o)

    def step(x, w1, w2):
        hid = x @ w1
        act = torch.relu(hid)          # hid and act live together: the peak
        del hid
        return act @ w2

    rep = tprof.memory_report(step, x, w1, w2, batch_size=n)
    args, temp = (n * d + d * h + h * o) * 4, 2 * n * h * 4
    # at the peak: the arguments, hid and act (the output comes later)
    assert rep.stats == {"argument": args, "output": 0, "temp": temp,
                         "total": args + temp,
                         "allocated": temp + n * o * 4}
    assert rep.peak_live_bytes == args + temp == rep.attributed_total()
    assert rep.classes["inputs"] == args and rep.classes["activations"] \
        == temp and rep.classes["outputs"] == 0
    assert rep.batch_bytes == temp + n * d * 4       # act, hid and x
    assert rep.forecast(2 * n)["peak_bytes"] == args + temp + temp + n * d * 4
    # the forecast walks the run: a peak that moves with the batch is
    # found where the one live at this batch's peak would miss it
    def moving(x, w1, w2):
        act = torch.relu(x @ w1)                  # (n, h): scales
        del act
        big = w1.new_zeros(4 * h, h)              # fixed, larger here
        return big.sum()

    rep = tprof.memory_report(moving, x, w1, w2, batch_size=n)
    assert rep.peak_live_bytes == args + 4 * h * h * 4 + 4   # big, its sum
    assert rep.forecast(16 * n)["peak_bytes"] == (
        args + 15 * n * d * 4 + 16 * 2 * n * h * 4)
    assert rep.hbm_limit is None and rep.max_batch() is None
    assert "activations" in rep.table()


def test_ddp_memory_report_infers_the_per_rank_batch(tmp_path):
    import torch.distributed as dist
    from apex_tpu_torch import parallel
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        ddp = parallel.DistributedDataParallel(
            parallel.data_parallel_mesh("cpu"))
        state = {"params": {"w": torch.ones(32, 8)}}
        x = torch.ones(64, 32)
        rep = ddp.memory_report(lambda s, x: x @ s["params"]["w"], state, x)
        assert rep.batch_size == 64 and rep.classes["params"] == 32 * 8 * 4
        # two batch-side leading dims: ambiguous, no forecast
        rep = ddp.memory_report(lambda s, x, y: x, state, x,
                                torch.ones(10, 2))
        assert rep.batch_size is None
    finally:
        dist.destroy_process_group()


def test_shard_report_of_a_zero_state_and_the_streams(tmp_path):
    slots = {"master": {"float32": torch.zeros(1024)},
             "m": {"float32": torch.zeros(1024)},
             "v": {"float32": torch.zeros(1024)}}
    state = AmpState(step=torch.zeros((), dtype=torch.int32),
                     params={"w": torch.ones(32, 64)},
                     opt_state=ShardedOptState(
                         torch.zeros((), dtype=torch.int32), slots),
                     scalers=())
    mem = tprof.memory_report(lambda s: s.params["w"] * 2, state)
    mm = MeshModel([MeshAxis("data", 2)], {"ici": 1.0}, name="dp2")
    sr = tprof.shard_report(state, mm, report=mem,
                            optimizer=types.SimpleNamespace(
                                axis_name="data"))
    by = {r.path: r for r in sr.records}
    assert by[".params['w']"].axes == {"data": "replicated"}
    assert by[".opt_state.slots['m']['float32']"].sharded_by("data")
    assert by[".opt_state.slots['m']['float32']"].shard_factor == 2
    assert {r.source for r in sr.records} == {"layout"}
    assert sr.class_shard_ratio("optimizer_state") == (
        (3 * 4096 + 4) / (2 * 3 * 4096 + 4))
    assert sr.closure() == (True, 0.0)
    fc = sr.forecast_axes({"tp": 2})
    assert fc["per_class"]["params"]["forecast"] == 32 * 64 * 4 // 2
    # without a plan nothing is sharded
    plain = tprof.shard_report(state, mm, report=mem)
    assert plain.class_shard_ratio("optimizer_state") == 1.0
    assert {r.source for r in plain.records} == {"none"}

    mod = _schema()
    paths = {k: tmp_path / f"{k}.jsonl" for k in ("memory", "sharding")}
    logger = tmon.MetricsLogger(
        sinks=[], memory_sink=tmon.JSONLSink(str(paths["memory"])),
        sharding_sink=tmon.JSONLSink(str(paths["sharding"])))
    sample = logger.sample_memory(step=3)
    assert sample["kind"] == "memory" and sample["bytes_in_use"] is None
    logger.attach_memory_report(mem)
    logger.attach_shard_report(sr, step=3)
    logger.close()
    mem_lines = paths["memory"].read_text().splitlines()
    assert [json.loads(line)["kind"] for line in mem_lines] == [
        "memory", "memory_report"]
    assert mod.check_memory_lines(mem_lines) == []
    assert mod.check_sharding_lines(
        paths["sharding"].read_text().splitlines()) == []
