"""The hierarchical gradient sync (``parallel.hierarchy``) and its planner
against the JAX package's.

Plans: ``plan_comm`` over ``parse_mesh_spec("dp2x4")``, ``"ici8"`` and a
measured (calibrated) model, both packages given the same explicit link
rates (the port keeps no TPU rate table): plans equal as JSON,
``comm.wire_bytes`` and ``predicted_seconds`` equal.

Syncs: four gloo ranks on a 2x2 (``data_inter``, ``data_intra``) mesh
(spawned once) against JAX on the same mesh over four virtual CPU devices,
each hop's wire dtype forced to None, bf16 and int8, with and without a
residual. The synced values equal JAX's to 1e-6 relative (the same f32
sums of two values and the same codecs); where XLA on the CPU computes
otherwise the bound is derived in the test (a bf16 scatter's sum kept in
f32, the int8 codec's x − q·s contracted into an FMA, a 4-rank bf16
all-reduce added in f32 where gloo adds in bf16). Against the exact mean
the bounds are ``tests/test_comm_compress.py``'s: bf16 3e-2, int8 5e-2,
and the int8 error-feedback trajectory within 2% of the optimum. DDP with
a hierarchical and with a flat plan.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_parallel_cases as C
from apex_tpu.lint.mesh_model import parse_mesh_spec as jparse
from apex_tpu.parallel import comm as jcomm
from apex_tpu.parallel import hierarchy as jhier
from apex_tpu_torch.lint.mesh_model import (MeshAxis, MeshModel,
                                            parse_mesh_spec)
from apex_tpu_torch.parallel import comm as tcomm
from apex_tpu_torch.parallel import hierarchy as thier

AXES = [("data_inter", 2), ("data_intra", 2)]
AX2 = ("data_inter", "data_intra")
NAMES = [n for n in C.CASES if n.startswith("hier_")]
CAL = {"dcn": {"alpha_us": 2000.0, "bytes_per_s": 2.5e10, "residual": 0.0,
               "n_samples": 8, "axis": "data_inter"}}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return C.run(4, NAMES, tmp_path_factory.mktemp("hier"), axes=AXES)


def _jmodel(spec, calibration=None):
    mm = jparse(spec)
    mm.link_bytes_per_s.update(C.HIER_LINKS)
    if calibration:
        mm.calibration.update(calibration)
    return mm


def _tmodel(spec, calibration=None):
    mm = parse_mesh_spec(spec, link_bytes_per_s=C.HIER_LINKS)
    mm.calibration.update(calibration or {})
    return mm


def _jplan(dtype, spec="dp2x2", grad_bytes=1 << 20, **kw):
    return jhier.plan_comm(_jmodel(spec), grad_bytes, dtypes=(dtype,), **kw)


# --- planning ---------------------------------------------------------------

@pytest.mark.parametrize("spec, cal, nbytes", [
    ("dp2x4", None, 100 * 2 ** 20), ("dp2x4", None, 1 << 20),
    ("dp2x4", CAL, 100 * 2 ** 20), ("ici8", None, 1 << 20),
    ("dp2x2", None, 1 << 22)])
def test_plan_comm_matches_jax(spec, cal, nbytes):
    tp = thier.plan_comm(_tmodel(spec, cal), nbytes)
    jp = jhier.plan_comm(_jmodel(spec, cal), nbytes)
    assert tp.to_json() == jp.to_json()
    assert (tp.is_hierarchical, tp.axis_names, tp.world, tp.describe()) == \
        (jp.is_hierarchical, jp.axis_names, jp.world, jp.describe())
    assert tp.predicted_seconds() == jp.predicted_seconds()
    assert tp.hop_seconds(12345678) == jp.hop_seconds(12345678)
    assert tp.dtype_by_link() == jp.dtype_by_link()
    assert tp.flat_ring_factor() == jp.flat_ring_factor()
    shapes = [(1 << 20,), (3000, 7), (513,)]
    tb = tcomm.bucket_plan([torch.zeros(s) for s in shapes], 600000)
    jb = jcomm.bucket_plan([jax.ShapeDtypeStruct(s, jnp.float32)
                            for s in shapes], 600000)
    assert tcomm.wire_bytes(tb, tp) == jcomm.wire_bytes(jb, jp)
    assert tcomm.bucket_table(tb, tp) == jcomm.bucket_table(jb, jp)


def test_measured_model_keeps_the_dcn_hop_at_bf16():
    """The JAX suite's planner unit: a latency-bound measured link keeps
    bf16 where the defaults-sourced plan takes int8."""
    nbytes = 100 * 2 ** 20
    measured = thier.plan_comm(_tmodel("dp2x4", CAL), nbytes)
    default = thier.plan_comm(_tmodel("dp2x4"), nbytes)
    assert (measured.source, default.source) == ("measured", "defaults")
    assert (measured.inter.dtype, default.inter.dtype) == ("bf16", "int8")
    assert measured.inter.calibrated and measured.inter.alpha_us == 2000.0


def test_mesh_model_needs_link_rates_and_round_trips():
    with pytest.raises(ValueError, match="link_bytes_per_s"):
        parse_mesh_spec("dp2x4")
    mm = _tmodel("dp2x4", CAL)
    again = parse_mesh_spec(json.dumps(mm.to_json()))
    assert again.to_json() == mm.to_json() and again.measured
    assert (mm.n_devices, mm.axis_names) == (8, ("data_inter", "data_intra"))
    assert mm.axis("data_intra").link == "ici"
    jm = _jmodel("dp2x4", CAL)
    assert [vars(a) for a in mm.axes] == [vars(a) for a in jm.axes]
    assert parse_mesh_spec("2slice", 8, link_bytes_per_s=C.HIER_LINKS
                           ).axis_names == jparse("2slice", 8).axis_names
    for bad in ("dp2", "ici4x"):
        with pytest.raises(ValueError):
            parse_mesh_spec(bad, link_bytes_per_s=C.HIER_LINKS)
    with pytest.raises(NotImplementedError):       # no ici axis
        thier.plan_comm(MeshModel([MeshAxis("a", 2, "dcn")], C.HIER_LINKS),
                        1 << 20)


# --- the sync on four ranks ---------------------------------------------------

def _smap(fn, *args, out_specs=P()):
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), AX2)
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P(AX2),),
                                 out_specs=out_specs, check_vma=False))(*args)


def _jax_tree(s):
    tree = C.grad_tree()
    return {"a": jnp.asarray(tree["a"]) * (s + 1.0),
            "b": jnp.asarray(tree["b"]), "n": jnp.asarray(tree["n"])}


def _linear(x):
    del x
    return (jax.lax.axis_index("data_inter") * 2
            + jax.lax.axis_index("data_intra")).astype(jnp.float32)


@pytest.mark.parametrize("dtype", [None, "bf16", "int8"])
def test_sync_matches_jax_and_the_exact_mean(results, dtype):
    plan = _jplan(dtype)

    def step(x):
        s = _linear(x)
        synced = jhier.hierarchical_sync(_jax_tree(s), plan,
                                         message_size=600)
        g = {"a": _jax_tree(s)["a"]}
        r = {"a": jnp.full_like(g["a"], 0.01) * (s + 1)}
        ef, r2 = jhier.hierarchical_sync(g, plan, residual=r)
        return synced, ef["a"], r2["a"][None]

    synced, ef, resid = _smap(step, jnp.zeros(4),
                              out_specs=(P(), P(), P(AX2)))
    tree = C.grad_tree()
    bound = {None: 1e-6, "bf16": 3e-2, "int8": 5e-2}[dtype]
    for r, res in enumerate(C.ranks(results, "hier_sync")):
        got = res[str(dtype)]
        for k in ("a", "b", "n"):
            np.testing.assert_allclose(got["synced"][k],
                                       np.asarray(synced[k], np.float32),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["synced"]["a"], tree["a"] * 2.5,
                                   rtol=bound, atol=bound)
        np.testing.assert_array_equal(got["synced"]["n"], tree["n"])
        np.testing.assert_allclose(got["ef"], np.asarray(ef), rtol=1e-6,
                                   atol=1e-6)
        x = tree["a"] * (r + 1.0) + np.float32(0.01 * (r + 1))
        if dtype == "bf16":
            # every bf16 hop after the first carries bf16 values, so the
            # residual is the first hop's cast error alone, bit for bit;
            # XLA on the CPU keeps the bf16 scatter's sum in f32 (ROADMAP
            # queue C, traps), adding that sum's rounding, at most half a
            # bf16 ulp of a sum of two ranks' values, 2**-8 of the largest
            cast = np.asarray(jnp.asarray(x).astype(jnp.bfloat16),
                              np.float32)
            np.testing.assert_array_equal(got["residual"], x - cast)
            xs = np.stack([tree["a"] * (q + 1.0) + np.float32(0.01 * (q + 1))
                           for q in range(4)])
            assert np.all(np.abs(got["residual"] - np.asarray(resid[r]))
                          <= 2.0 ** -8 * np.abs(xs).max(0) + 1e-7)
        elif dtype == "int8":
            # XLA on the CPU contracts the codec's x - q·s into one fused
            # multiply-add where the port rounds twice: a few f32 ulps of
            # the largest sum the hops quantize
            xs = np.stack([tree["a"] * (q + 1.0) + np.float32(0.01 * (q + 1))
                           for q in range(4)])
            np.testing.assert_allclose(
                got["residual"], np.asarray(resid[r]), rtol=1e-6,
                atol=2.0 ** -20 * np.abs(xs).sum(0).max())
        else:
            np.testing.assert_allclose(got["residual"], np.asarray(resid[r]),
                                       rtol=1e-6, atol=1e-6)
        if dtype is None:
            assert not got["residual"].any()
        per_hop = {None: 1, "bf16": 1, "int8": 2}[dtype]
        n_buckets = len(tcomm.bucket_plan(
            [torch.zeros(tree[k].shape) for k in ("a", "b")], 600))
        assert got["counts"] == {
            f"bucket{b:02d}/{hop}": n
            for b in range(n_buckets)
            for hop, n in (("ici", 2 * per_hop),
                           ("dcn", 2 * per_hop if dtype == "int8"
                            else per_hop))}


def test_int8_error_feedback_trajectory_lands_at_the_optimum(results):
    t_mean = C.int8_targets(4).mean(axis=0)
    scale = float(np.linalg.norm(t_mean))
    for res in C.ranks(results, "hier_trajectory"):
        assert np.linalg.norm(res["exact"] - t_mean) < 1e-3 * scale
        assert np.linalg.norm(res["ef"] - t_mean) < 0.02 * scale


def test_ddp_with_a_comm_plan_and_the_hierarchical_pmean(results):
    plan = _jplan("int8")
    vals = jnp.linspace(0.1, 1.7, 640, dtype=jnp.float32)

    def step(x):
        out, r2 = jhier.hierarchical_sync({"w": vals}, plan,
                                          residual={"w": jnp.zeros(640)})
        return out["w"], r2["w"][None], jhier.hierarchical_pmean(
            _linear(x) + 1.0, plan)

    synced, resid, pm = _smap(step, jnp.zeros(4),
                              out_specs=(P(), P(AX2), P()))
    flat_plan = jhier.plan_comm(_jmodel("ici4"), 1 << 20, dtypes=("bf16",))
    mesh4 = Mesh(np.array(jax.devices()[:4]), ("data",))
    flat = jax.jit(jax.shard_map(
        lambda x: jcomm.bucketed_all_reduce(
            _jax_tree(jax.lax.axis_index("data").astype(jnp.float32)),
            "data", compress=flat_plan.hops[0].dtype,
            compress_block=flat_plan.compress_block),
        mesh=mesh4, in_specs=(P("data"),), out_specs=P(),
        check_vma=False))(jnp.zeros(4))
    for r, res in enumerate(C.ranks(results, "hier_ddp_and_pmean")):
        assert res["world"] == 4
        assert res["axis"] == ["data_intra", "data_inter"]
        np.testing.assert_allclose(res["synced"], np.asarray(synced),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(res["synced"], np.asarray(vals),
                                   rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(res["residual"], np.asarray(resid[r]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(res["pmean"]), float(pm),
                                   rtol=1e-6)
        assert float(res["pmean"]) == 2.5
        assert res["pmean_counts"] == {"ddp/loss_pmean": 2}
        assert res["flat_axis"] == "data"
        # a bf16 all-reduce of four ranks: gloo rounds after each of its
        # three bf16 additions, XLA on the CPU adds in f32 and rounds once;
        # each rounding is at most half a bf16 ulp (2**-8 relative) of a
        # partial sum, at most sum_r |x_r|: the sums part by at most two
        # ulps, the means by 2**-6 of sum_r |x_r| / 4
        tree = C.grad_tree()
        for k in ("a", "b"):
            xs = np.stack([tree[k] * (q + 1.0 if k == "a" else 1.0)
                           for q in range(4)])
            bound = 2.0 ** -6 * np.abs(xs).sum(0) / 4 + 1e-7
            assert np.all(np.abs(res["flat"][k] - np.asarray(
                flat[k], np.float32)) <= bound), k
        np.testing.assert_array_equal(res["flat"]["n"], tree["n"])


def test_ddp_comm_plan_validation():
    import types
    from apex_tpu_torch import parallel
    plan = C.hier_plan("int8")
    mesh = types.SimpleNamespace(mesh_dim_names=("data",))
    with pytest.raises(ValueError, match="hierarchical_data_mesh"):
        parallel.DistributedDataParallel(mesh, comm_plan=plan)
    for kw in (dict(compress="bf16"), dict(delay_allreduce=True),
               dict(allreduce_always_fp32=True), dict(compress_block=64)):
        with pytest.raises(ValueError, match="comm_plan"):
            parallel.DistributedDataParallel(mesh, comm_plan=plan, **kw)
    with pytest.raises(ValueError, match="flat CommPlan"):
        thier.hierarchical_sync({}, C.hier_plan(None, spec="ici4"))
