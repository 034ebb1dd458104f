"""Bucketed and compressed gradient all-reduce (``parallel.comm``) across
two gloo ranks against the JAX package's under ``shard_map`` over two CPU
devices; the bucket plan, wire bytes and the int8 codec against the JAX
package directly.

Ports ``tests/test_comm_compress.py`` case by case, but the hierarchical
sync's (not ported yet): the exact bucketed sync equals the per-tensor
sync bit for bit; bf16 and int8 stay close to the exact mean (the JAX
suite's rtol 3e-2 and 5e-2) and their error-feedback residuals remove the
bias (a constant bf16 rounds away; an int8 GD trajectory lands at the
exact optimum); DDP's wiring of the modes. The codec and the two-rank sums
are elementwise f32 with one addition each, so the port's outputs equal
the JAX package's to 1e-6 relative.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_parallel_cases as C
from apex_tpu.parallel import comm as jcomm
from apex_tpu_torch.parallel import comm as tcomm

WORLD = 2
NAMES = [n for n in C.CASES if n.startswith("comm_")]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return C.run(WORLD, NAMES, tmp_path_factory.mktemp("comm"))


def _smap(fn, *args, in_specs=P("data"), out_specs=P()):
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)(*args)


def _jax_scaled(shard):
    tree = C.grad_tree()
    k = shard.astype(jnp.float32) + 1
    return {"a": jnp.asarray(tree["a"]) * k, "b": jnp.asarray(tree["b"]) * k,
            "c": jnp.asarray(tree["c"]).astype(jnp.bfloat16)
            * k.astype(jnp.bfloat16),
            "n": jnp.asarray(tree["n"])}


def test_exact_bucketed_equals_the_plain_sync_bitwise(results):
    want = _smap(lambda x: jcomm.bucketed_all_reduce(
        _jax_scaled(jax.lax.axis_index("data")), "data", message_size=600),
        jnp.zeros(WORLD))
    for res in C.ranks(results, "comm_exact"):
        for k in ("a", "b", "c", "n"):
            np.testing.assert_array_equal(res["bucketed"][k],
                                          res["plain"][k], err_msg=k)
            np.testing.assert_allclose(res["bucketed"][k],
                                       np.asarray(want[k], np.float32),
                                       rtol=1e-6, err_msg=k)


def test_exact_bucketed_knobs_and_residual_passthrough(results):
    for res in C.ranks(results, "comm_exact"):
        np.testing.assert_allclose(res["predivide"], 1.5, rtol=1e-6)
        np.testing.assert_allclose(res["sum"], 2.0)
        np.testing.assert_allclose(res["residual_out"], 1.5, rtol=1e-6)
        np.testing.assert_array_equal(res["residual"], 0.0)


def test_bf16_compress_close_to_the_exact_mean_and_to_jax(results):
    tree = C.grad_tree()
    want = _smap(lambda x: jcomm.bucketed_all_reduce(
        {"a": jnp.asarray(tree["a"]) * (jax.lax.axis_index("data") + 1.0),
         "b": jnp.asarray(tree["b"])}, "data", message_size=600,
        compress="bf16"), jnp.zeros(WORLD))
    for res in C.ranks(results, "comm_bf16"):
        np.testing.assert_allclose(res["close"]["a"], tree["a"] * 1.5,
                                   rtol=3e-2, atol=3e-2)
        for k in ("a", "b"):
            np.testing.assert_allclose(res["close"][k], np.asarray(want[k]),
                                       rtol=1e-6, err_msg=k)


def test_bf16_residual_is_the_local_cast_error(results):
    a = C.grad_tree()["a"]
    cast = np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float32)
    for res in C.ranks(results, "comm_bf16"):
        np.testing.assert_allclose(res["residual"], a - cast, atol=1e-7)


def test_bf16_error_feedback_removes_the_rounding_bias(results):
    for res in C.ranks(results, "comm_bf16"):
        assert res["err_plain"] > 1e-3, "the value was bf16-representable"
        assert res["err_ef"] < res["err_plain"] / 4, res


def test_int8_all_reduce_close_to_exact_and_to_jax(results):
    a = C.grad_tree()["a"]
    want = _smap(lambda x: jcomm.bucketed_all_reduce(
        {"a": jnp.asarray(a) * (jax.lax.axis_index("data") + 1.0)}, "data",
        compress="int8")["a"], jnp.zeros(WORLD))
    for res in C.ranks(results, "comm_int8"):
        np.testing.assert_allclose(res["close"], a * 1.5, rtol=5e-2,
                                   atol=5e-2)
        np.testing.assert_allclose(res["close"], np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_int8_error_feedback_trajectory_lands_at_the_optimum(results):
    t_mean = C.int8_targets(WORLD).mean(axis=0)
    scale = float(np.linalg.norm(t_mean))
    for res in C.ranks(results, "comm_int8"):
        assert np.linalg.norm(res["exact"] - t_mean) < 1e-3 * scale
        assert np.linalg.norm(res["ef"] - t_mean) < 0.02 * scale


def test_ddp_wiring_of_the_comm_modes(results):
    for r, res in enumerate(C.ranks(results, "comm_ddp")):
        for k in ("a", "b", "c", "n"):
            np.testing.assert_allclose(res["bucketed"][k], res["default"][k],
                                       rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(res["roundtrip"],
                                   np.linspace(0.1, 1.7, 128), rtol=1e-2,
                                   atol=1e-2)
        assert res["roundtrip_residual"].shape == (128,)
        np.testing.assert_array_equal(res["no_sync"], float(r))
        np.testing.assert_array_equal(res["no_sync_residual"], 0.0)
        assert res["exact_residual_is_passed"]


def test_bucketed_mode_validation():
    with pytest.raises(ValueError):
        tcomm.bucketed_all_reduce({"w": torch.ones(4)}, "data",
                                  compress="fp4")
    with pytest.raises(ValueError):
        tcomm.bucketed_all_reduce({"w": torch.ones(4)}, "data",
                                  compress="bf16",
                                  allreduce_always_fp32=True)
    with pytest.raises(NotImplementedError):
        tcomm.bucketed_all_reduce({"w": torch.ones(4)}, ("a", "b"),
                                  compress="int8")


# --- pure parts -----------------------------------------------------------

def _spec(shape, dtype):
    return types.SimpleNamespace(shape=shape, dtype=dtype)


def _leaves():
    """The comm cases' tree as (port, JAX) leaf specs, in leaf order."""
    tree = C.grad_tree()
    tdt = {"a": torch.float32, "b": torch.float32, "c": torch.bfloat16,
           "n": torch.int64}
    jdt = {"a": jnp.float32, "b": jnp.float32, "c": jnp.bfloat16,
           "n": jnp.int32}
    return ([_spec(v.shape, tdt[k]) for k, v in tree.items()],
            [jax.ShapeDtypeStruct(v.shape, jdt[k]) for k, v in tree.items()])


def test_bucket_plan_walks_leaves_in_reverse():
    plan = tcomm.bucket_plan([_spec((100,), torch.float32)] * 3, 150)
    assert [b.leaf_idx for b in plan] == [(2,), (1,), (0,)]


@pytest.mark.parametrize("message_size", [None, 600, 2000, 10_000_000])
def test_bucket_plan_and_table_match_jax(message_size):
    tl, jl = _leaves()
    got = tcomm.bucket_plan(tl, message_size)
    want = jcomm.bucket_plan(jl, message_size)
    assert [tuple(b) for b in got] == [tuple(b) for b in want]
    assert {b.dtype for b in got} == {"float32", "bfloat16"}
    assert sorted(i for b in got for i in b.leaf_idx) == [0, 1, 2]
    for b in got:
        if len(b.leaf_idx) > 1 and message_size:
            assert b.elems <= message_size
    assert [b.bytes() for b in got] == [b.bytes() for b in want]
    for mode in tcomm.COMPRESS_MODES:
        assert tcomm.wire_bytes(got, mode) == jcomm.wire_bytes(want, mode)
        assert tcomm.bucket_table(got, mode) == jcomm.bucket_table(want,
                                                                   mode)


def test_wire_bytes_modes():
    plan = tcomm.bucket_plan([_spec((1024,), torch.float32)], None)
    assert tcomm.wire_bytes(plan) == 4096
    assert tcomm.wire_bytes(plan, "bf16") == 2048
    assert tcomm.wire_bytes(plan, "int8") == 1024 + 4 * 4
    with pytest.raises(ValueError):
        tcomm.dtype_wire_bytes(8, "fp4")


@pytest.mark.parametrize("n, block", [(4096, 256), (1000, 256), (512, 256),
                                      (77, 32)])
def test_int8_codec_matches_jax_bit_for_bit(n, block):
    x = (np.random.RandomState(n).randn(n) * 5.0).astype(np.float32)
    q, s = tcomm._quantize_int8(torch.tensor(x), block)
    jq, js = jcomm._quantize_int8(jnp.asarray(x), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    padded = -(-n // block) * block
    assert q.shape[0] == padded and s.shape[0] == padded // block
    back = tcomm._dequantize_int8(q, s, block, n=n)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcomm._dequantize_int8(jq, js, block, n=n)))
    assert back.shape[0] == n
    np.testing.assert_array_equal(
        tcomm._dequantize_int8(q, s, block)[n:].numpy(), 0.0)
    bound = np.repeat(s.numpy(), block)[:n] / 2 + 1e-7
    assert np.all(np.abs(back.numpy() - x) <= bound)


def test_init_residual_shapes():
    g = {"w": torch.ones(3, 2, dtype=torch.bfloat16),
         "n": torch.arange(4)}
    r = tcomm.init_residual(g)
    assert r["w"].shape == (3, 2) and r["w"].dtype == torch.float32
    assert r["n"].shape == (0,)
