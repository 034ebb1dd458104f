"""The port's data parallelism (``apex_tpu_torch.parallel``) across two
gloo ranks, against the JAX package under ``shard_map`` over two CPU
devices, and its pure parts (LARC, the registry, the launch helpers)
against the JAX package directly.

Ports ``tests/test_parallel.py`` case by case (the mesh, ``sync_gradients``'
knobs, ``Reducer``, DDP training equal to one device, ``no_sync``,
``flat_all_reduce``, ``delay_allreduce``, replication, LARC); the XLA
combiner-threshold cases have no counterpart (eager collectives). The two
ranks run once for the file. Tolerances: exact sums of small integers and
halves are compared exactly; the DDP step at rtol 1e-5 (the JAX suite's);
LARC at rtol 1e-5.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_parallel_cases as C
from apex_tpu import parallel as jpar
from apex_tpu.optim import FusedSGD as JSGD
from apex_tpu_torch import parallel as tpar
from apex_tpu_torch.optim import FusedSGD as TSGD

WORLD = 2
NAMES = [n for n in C.CASES if n.startswith("dp_")]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return C.run(WORLD, NAMES, tmp_path_factory.mktemp("dp"))


def _smap(fn, *args, in_specs=P("data"), out_specs=P()):
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)(*args)


def test_sync_gradients_knobs_match_jax(results):
    per = C.ranks(results, "dp_sync_knobs")
    want_avg = _smap(lambda x: jpar.sync_gradients(
        {"w": x * jnp.ones((4, 128))}, "data")["w"], jnp.arange(1.0, 3.0))
    want_pre = _smap(lambda x: jpar.sync_gradients(
        {"w": x}, "data", gradient_predivide_factor=2.0)["w"],
        jnp.arange(1.0, 3.0))
    want_sum = _smap(lambda x: jpar.sync_gradients(
        {"w": x}, "data", gradient_average=False)["w"], jnp.ones(2))
    vals = jnp.float32([1.0, 1 + 1 / 256])
    want_fp32 = _smap(lambda x: jpar.sync_gradients(
        {"w": x.astype(jnp.bfloat16)}, "data",
        allreduce_always_fp32=True)["w"].astype(jnp.float32), vals)
    for res in per:
        np.testing.assert_array_equal(res["average"], np.asarray(want_avg))
        np.testing.assert_array_equal(res["average"], 1.5)
        np.testing.assert_array_equal(res["predivide"], np.asarray(want_pre))
        np.testing.assert_array_equal(res["sum"], np.asarray(want_sum))
        assert res["fp32_dtype"] == "torch.bfloat16"
        np.testing.assert_array_equal(res["fp32"], np.asarray(want_fp32))
        assert int(res["int_leaf"]) == 3
        np.testing.assert_array_equal(res["reducer"], 0.5)
    for r, res in enumerate(per):     # the caller's gradient is not summed
        np.testing.assert_array_equal(res["caller_grad"], r + 1.0)


def test_ddp_training_matches_one_device(results):
    per = C.ranks(results, "dp_wrap")
    w0, x = (jnp.asarray(a) for a in C.dp_regression())

    def loss_fn(w, xb):
        return jnp.mean(jnp.square(xb @ w))

    loss_ref, g_ref = jax.value_and_grad(loss_fn)(w0, x)
    w_ref = np.asarray(w0 - 0.1 * g_ref)
    ddp = jpar.DistributedDataParallel(
        Mesh(np.array(jax.devices()[:WORLD]), ("data",)))

    def step(w, xb):
        loss, g = jax.value_and_grad(loss_fn)(w, xb)
        return w - 0.1 * ddp.sync({"w": g})["w"], jax.lax.pmean(loss,
                                                                "data")

    w_jax, loss_jax = ddp.wrap(step, donate_state=False)(w0, x)
    for res in per:
        np.testing.assert_allclose(res["w"], w_ref, rtol=1e-5)
        np.testing.assert_allclose(res["w"], np.asarray(w_jax), rtol=1e-6)
        np.testing.assert_allclose(float(res["loss"]), float(loss_ref),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(res["loss"]), float(loss_jax),
                                   rtol=1e-6)
        np.testing.assert_allclose(res["w_grad_fn"], res["w"], rtol=1e-6)


def test_no_sync_skips_the_all_reduce(results):
    for r, res in enumerate(C.ranks(results, "dp_no_sync")):
        np.testing.assert_array_equal(res["raw"], [float(r)])
        np.testing.assert_array_equal(res["synced"], [0.5])
        assert res["no_sync_collectives"] == 0


def test_flat_all_reduce_and_delay_allreduce(results):
    per = C.ranks(results, "dp_flat_and_delay")
    want_flat = _smap(lambda b: jpar.flat_all_reduce(b, "data"),
                      jnp.ones((WORLD * 65536,)))
    for res in per:
        np.testing.assert_array_equal(res["flat"], np.asarray(want_flat))
        for key in ("a", "b", "c", "n"):
            np.testing.assert_array_equal(res["delay"][key],
                                          res["each"][key], err_msg=key)
        np.testing.assert_array_equal(res["delay"]["a"],
                                      np.arange(24.0).reshape(3, 8) * 1.5)
        # one all-reduce per dtype (f32, bf16) against one a float tensor
        assert res["delay"]["collectives"] == 2
        assert res["each"]["collectives"] == 3


def test_replicate_and_replica_broadcast(results):
    per = C.ranks(results, "dp_replicate")
    for res in per:
        np.testing.assert_array_equal(res["replicate"]["w"], 0.0)
        assert res["replicate"]["i"] == [0]
        np.testing.assert_array_equal(res["broadcast"]["w"], 1.0)
        np.testing.assert_array_equal(res["broadcast"]["f"], [0.0, 2.5])
        assert res["signbit"].tolist() == [True, False]   # -0.0 kept
        assert res["broadcast"]["i"].tolist() == [1]
        assert res["broadcast"]["b"].tolist() == [True]
        np.testing.assert_array_equal(res["pmean"], 1.5)


def test_mesh_helpers(results):
    for r, res in enumerate(C.ranks(results, "dp_mesh")):
        assert (res["size"], res["index"], res["local_batch"]) == (2, r, 4)
        assert res["odd_batch"] == res["bad_size"] == "ValueError"
        assert res["two_free"] == "ValueError"
        assert res["unbound"] == res["outside"] == "NameError"
        assert res["hier"] == [2, 1]
        assert res["hier_names"] == ["data_inter", "data_intra"]
        assert res["groups_cached"] and res["group_size"] == 1


def _fake_mesh():
    return types.SimpleNamespace(mesh_dim_names=("data",))


def test_ddp_mode_validation_and_unported_parts():
    with pytest.raises(ValueError):
        tpar.DistributedDataParallel(_fake_mesh(), "model")
    for kw in (dict(compress="fp4"),
               dict(compress="bf16", allreduce_always_fp32=True),
               dict(bucket_allreduce=True, delay_allreduce=True)):
        with pytest.raises(ValueError):
            tpar.DistributedDataParallel(_fake_mesh(), **kw)
    # comm_plan is ported: a hierarchical plan needs a mesh with its axes
    from apex_tpu_torch.lint.mesh_model import parse_mesh_spec
    plan = tpar.plan_comm(parse_mesh_spec(
        "dp2x2", link_bytes_per_s={"ici": 1e11, "dcn": 1e10}), 1 << 20)
    with pytest.raises(ValueError, match="hierarchical"):
        tpar.DistributedDataParallel(_fake_mesh(), comm_plan=plan)
    ddp = tpar.DistributedDataParallel(_fake_mesh())
    # memory_report runs the step once under prof's tracker (the mesh
    # bound needs a process group for the world size, so the per-rank
    # batch is given here; tests/test_torch_prof_memory.py infers it)
    rep = ddp.memory_report(lambda s: s * 2, torch.ones(8, 4),
                            batch_size=8)
    assert rep.classes["inputs"] == 8 * 4 * 4
    assert rep.classes["outputs"] == 8 * 4 * 4
    # collective_bytes runs the step once and reads the collective ledger:
    # a step that calls no collective moves no bytes
    assert ddp.collective_bytes(lambda s: s, 1) == {"total": 0}
    from apex_tpu_torch.parallel import distributed
    # the probe's two collectives run on every rank, world 1 included, so
    # it needs the data axis bound (tests/test_torch_dynamics.py runs it)
    with pytest.raises(NameError, match="unbound axis name"):
        distributed.dynamics_probe({"g": torch.ones(2)},
                                   {"g": torch.ones(2)})
    # the JAX package's patterns, in order, and the port's own row
    from apex_tpu_torch.parallel.registry import PORT_ONLY_PATTERNS
    assert tuple(p for p in distributed.KNOWN_COLLECTIVE_SCOPES
                 if p not in PORT_ONLY_PATTERNS) == \
        jpar.distributed.KNOWN_COLLECTIVE_SCOPES


# --- LARC ---------------------------------------------------------------

def test_larc_rewrite_matches_the_reference_formula_and_jax():
    p = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    g = (np.random.RandomState(1).randn(16, 8) * 0.01).astype(np.float32)
    lr, trust, wd, eps = 0.1, 0.02, 1e-4, 1e-8
    got = tpar.larc_rewrite_grads(
        {"w": torch.tensor(g)}, {"w": torch.tensor(p)}, lr=lr,
        trust_coefficient=trust, weight_decay=wd, eps=eps)["w"].numpy()
    want = jpar.larc_rewrite_grads(
        {"w": jnp.asarray(g)}, {"w": jnp.asarray(p)}, lr=lr,
        trust_coefficient=trust, weight_decay=wd, eps=eps)["w"]
    pn, gn = np.linalg.norm(p), np.linalg.norm(g)
    adaptive = min(trust * pn / (gn + pn * wd + eps) / lr, 1.0)
    np.testing.assert_allclose(got, (g + wd * p) * adaptive, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)


def test_larc_scale_mode():
    got = tpar.larc_rewrite_grads(
        {"w": torch.ones(4)}, {"w": torch.full((4,), 2.0)}, lr=None,
        clip=False, trust_coefficient=0.01)["w"]
    np.testing.assert_allclose(got.numpy(), 0.02, rtol=1e-5)
    with pytest.raises(ValueError):
        tpar.larc_rewrite_grads({"w": torch.ones(1)}, {"w": torch.ones(1)},
                                lr=None, clip=True)


def test_larc_zero_grad_passes_through_untouched():
    got = tpar.larc_rewrite_grads({"w": torch.zeros(4)}, {"w": torch.ones(4)},
                                  lr=0.1, weight_decay=0.01)["w"]
    np.testing.assert_array_equal(got.numpy(), 0.0)


@pytest.mark.parametrize("strategy", ["tree", "arena"])
def test_larc_around_fused_sgd_matches_jax(strategy):
    rng = np.random.RandomState(2)
    params = {"w": rng.randn(256).astype(np.float32),
              "b": rng.randn(8).astype(np.float32)}
    grads = {k: (rng.randn(*v.shape) * 0.5).astype(np.float32)
             for k, v in params.items()}
    tl = tpar.LARC(TSGD(lr=0.1, momentum=0.9, strategy=strategy),
                   trust_coefficient=0.02)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    new_t, _ = tl.step({k: torch.tensor(v) for k, v in grads.items()},
                       tl.init(tp), tp)
    jl = jpar.LARC(JSGD(lr=0.1, momentum=0.9), trust_coefficient=0.02)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    new_j, _ = jl.step({k: jnp.asarray(v) for k, v in grads.items()},
                       jl.init(jp), jp)
    for k in params:
        assert not np.allclose(new_t[k].numpy(), params[k])
        np.testing.assert_allclose(new_t[k].numpy(), np.asarray(new_j[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # the optax-style update path gives the same params
    upd, _ = tl.update({k: torch.tensor(v) for k, v in grads.items()},
                       tl.init(tp), tp)
    for k in params:
        np.testing.assert_allclose((tp[k] + upd[k]).numpy(),
                                   new_t[k].numpy(), rtol=1e-6, atol=1e-7)


# --- the registry and the launch helpers --------------------------------

SCOPES = ["ddp/sync_gradients", "ddp/sync_gradients/bucket03", "bucket12",
          "ddp/sync_gradients/bucket00/ici", "x/bucket01/dcn",
          "ddp/loss_pmean", "sync_batchnorm", "SyncBatchNorm_0",
          "zero/grad_scatter", "guard/integrity_repair", "ring_attention",
          "ddp/dynamics_gns", "an/unplanned/reshard"]


@pytest.mark.parametrize("scope", SCOPES)
def test_registry_rows_match_jax(scope):
    from apex_tpu.parallel import registry as jr
    got, want = tpar.scope_entry(scope), jr.scope_entry(scope)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.pattern, got.axis, got.subsystem) == \
            (want.pattern, want.axis, want.subsystem)
    assert tpar.scope_axis(scope) == jr.scope_axis(scope)
    from apex_tpu_torch.parallel.registry import PORT_ONLY_PATTERNS
    assert tuple(p for p in tpar.known_patterns()
                 if p not in PORT_ONLY_PATTERNS) == jr.known_patterns()


def test_every_scope_the_port_issues_is_registered():
    for scope in ("ddp/sync_gradients", "bucket00", "ddp/loss_pmean",
                  "sync_batchnorm", "guard/integrity_repair",
                  "zero/grad_scatter", "zero/param_gather", "zero/grad_norm",
                  "bucket00/ici", "bucket03/dcn", "ring_ppermute",
                  "ring_all_to_all"):
        assert tpar.scope_entry(scope) is not None, scope


def test_the_port_only_registry_row():
    """``zero/grad_norm`` names the ZeRO norm sums, which the JAX package
    issues outside any span: the port's one row the JAX table lacks, on
    the data axis of the zero subsystem."""
    from apex_tpu.parallel import registry as jr
    from apex_tpu_torch.parallel.registry import PORT_ONLY_PATTERNS
    assert PORT_ONLY_PATTERNS == ("zero/grad_norm",)
    entry = tpar.scope_entry("zero/grad_norm")
    assert (entry.pattern, entry.axis, entry.subsystem) == (
        "zero/grad_norm", "data", "zero")
    assert "unscoped in the JAX package" in entry.description
    assert jr.scope_entry("zero/grad_norm") is None


@pytest.mark.parametrize("world, kw", [(8, {}), (6, {}), (16, {"factor": 4}),
                                       (8, {"min_world": 2}), (1, {})])
def test_shrink_schedule_matches_jax(world, kw):
    assert tpar.shrink_schedule(world, **kw) == \
        jpar.shrink_schedule(world, **kw)


def test_launch_helpers_without_a_process_group(monkeypatch, capsys,
                                                 tmp_path):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    tpar.distributed_init()                      # single process: no-op
    assert not torch.distributed.is_initialized()
    assert (tpar.is_distributed(), tpar.process_index(),
            tpar.process_count()) == (False, 0, 1)
    tpar.maybe_print("hello", rank0=True)
    assert capsys.readouterr().out == "hello\n"
    with pytest.raises(ValueError):
        tpar.shrink_schedule(8, factor=1)
    # enable_crash_dumps is ported: the fixed four-slot shape
    tracer, rec, wd, cd = tpar.enable_crash_dumps(
        str(tmp_path / "crash.jsonl"))
    rec.uninstall()
    assert (type(tracer).__name__, type(rec).__name__, wd, cd) == (
        "Tracer", "FlightRecorder", None, None)
    # elastic_run is ported: a run that completes returns its result
    assert tpar.elastic_run(lambda world, attempt: (world, attempt),
                            world_sizes=[4, 2]) == (4, 0)
