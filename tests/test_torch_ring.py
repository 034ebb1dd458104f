"""Ring and Ulysses attention (``parallel.ring``) in gloo ranks against the
JAX package's under ``shard_map`` on the virtual CPU devices.

Four ranks are spawned once on one ``seq`` axis; the world-2 runs pair them
on a (``pair``, ``seq``) mesh. Each rank holds its sequence shard of q, k,
v (f32, the port's plain versions), runs ``ring_attention`` or
``ulysses_attention`` and differentiates sum(sin(o)). Bounds are the JAX
suite's (``tests/test_ring_attention.py``): o within 5e-5 and grads within
1e-4 of JAX's ring (and of single-device attention); under dropout (local
S = 512 and 1024, so each shard is one or two 512-blocks) o within 2e-5
and grads within 2e-4 of the JAX package's single-device flash attention
with the same seed, which a single flipped keep bit would break, and the
keep mask of each hop, bit for bit, the slice of the single-device mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_parallel_cases as C
from apex_tpu import parallel as jpar
from apex_tpu.ops import attention as JA
from apex_tpu_torch import parallel as tpar
from apex_tpu_torch.ops import attention as TA

NAMES = [n for n in C.CASES if n.startswith("ring_")]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return C.run(4, NAMES, tmp_path_factory.mktemp("ring"),
                 axes=[("seq", 4)])


def _jax_seq(fn, run, world):
    """JAX's (o, dq, dk, dv) over ``world`` devices, gathered."""
    seed, b, s, h, d, options = run
    q, k, v = (jnp.asarray(a) for a in C.ring_qkv(seed, b, s * world, h, d))

    def grads(q, k, v):
        def loss(q, k, v):
            return jnp.sum(jnp.sin(fn(q, k, v, "seq", **options)))
        o = fn(q, k, v, "seq", **options)
        return (o,) + jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    mesh = Mesh(np.array(jax.devices()[:world]), ("seq",))
    return jax.jit(jax.shard_map(
        grads, mesh=mesh, in_specs=P(None, "seq"),
        out_specs=P(None, "seq"), check_vma=False))(q, k, v)


def _local(a, r, world):
    a = np.asarray(a)
    n = a.shape[1] // world
    return a[:, r * n:(r + 1) * n]


def _check(results, key, want, world, otol, gtol):
    for r, res in enumerate(C.ranks(results, "ring_runs")):
        got = res[key]
        for name, w, tol in zip(("o", "dq", "dk", "dv"), want,
                                (otol, gtol, gtol, gtol)):
            np.testing.assert_allclose(got[name],
                                       _local(w, r % world, world),
                                       atol=tol, err_msg=f"{key} {name}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["plain", "causal"])
def test_ring_matches_jax(results, name, world):
    run = C.RING_RUNS[name]
    _check(results, f"{name}/{world}", _jax_seq(jpar.ring_attention, run,
                                                world), world, 5e-5, 1e-4)
    # and single-device attention on the gathered sequence
    seed, b, s, h, d, options = run
    q, k, v = (jnp.asarray(a) for a in C.ring_qkv(seed, b, s * world, h, d))
    ref = JA.attention_reference(q, k, v, causal=options.get("causal",
                                                             False))
    for r, res in enumerate(C.ranks(results, "ring_runs")):
        np.testing.assert_allclose(res[f"{name}/{world}"]["o"],
                                   _local(ref, r % world, world), atol=5e-5)
        assert res[f"{name}/{world}"]["collectives"] == {
            "ring_ppermute": 4 * (world - 1)}


@pytest.mark.parametrize("name", ["dropout", "dropout_causal",
                                  "dropout_multiblock"])
def test_ring_dropout_matches_the_single_device_kernel(results, name):
    """World 2: the ring under dropout equals JAX's single-device flash
    attention with the same seed (o 2e-5, grads 2e-4)."""
    seed, b, s, h, d, options = C.RING_RUNS[name]
    q, k, v = (jnp.asarray(a) for a in C.ring_qkv(seed, b, s * 2, h, d))

    def loss(q, k, v):
        return jnp.sum(jnp.sin(JA.flash_attention(q, k, v, **options)))

    o = JA.flash_attention(q, k, v, **options)
    want = (o,) + jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    _check(results, f"{name}/2", want, 2, 2e-5, 2e-4)


@pytest.mark.parametrize("s_local", [512, 1024])
def test_ring_hop_masks_are_slices_of_the_single_device_mask(s_local):
    """Each hop's keep mask (the port's hash at the hop's block offsets
    [my·nqb, src·nkb]) is, bit for bit, the (my, src) block of JAX's
    single-device mask of the gathered sequence."""
    world, b, h, rate = 2, 1, 2, 0.3
    seed = jnp.asarray([1234], jnp.int32)
    s = s_local * world
    full = np.asarray(JA._keep_mask_dense(seed, b, h, s, s, 512, 512,
                                          rate)).reshape(b * h, s, s)
    nb = s_local // 512
    for my in range(world):
        for src in range(world):
            dbo = torch.tensor([my * nb, src * nb], dtype=torch.int32)
            got = TA._keep_mask_dense(torch.tensor([1234], dtype=torch.int32),
                                      b, h, s_local, s_local, 512, 512, rate,
                                      dbo)
            np.testing.assert_array_equal(
                got.numpy(), full[:, my * s_local:(my + 1) * s_local,
                                  src * s_local:(src + 1) * s_local])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["plain", "causal"])
def test_ulysses_matches_jax(results, name, world):
    _check(results, f"ulysses_{name}/{world}",
           _jax_seq(jpar.ulysses_attention, C.ULYSSES_RUNS[name], world),
           world, 5e-5, 1e-4)
    for res in C.ranks(results, "ring_runs"):
        # 3 forward all-to-alls and 1 back; their transposes in backward
        assert res[f"ulysses_{name}/{world}"]["collectives"] == {
            "ring_all_to_all": 8}


def test_ring_dtypes_and_the_512_tile_refusal(results):
    for res in C.ranks(results, "ring_dtypes_and_refusals"):
        assert res["dtype/1"] == "torch.bfloat16"
        assert res["dtype/2"] == "torch.float32"
        for w in (1, 2):
            assert "512 dropout tile" in res[f"unaligned/{w}"]


def test_ulysses_dropout_raises_as_in_jax():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(NotImplementedError) as ei:
        tpar.ulysses_attention(q, q, q, "data", dropout_rate=0.1,
                               dropout_seed=0)
    msg = str(ei.value)
    assert "ring_attention(q, k, v, 'data', dropout_rate=0.1" in msg
    assert "docs/parallel.md#ulysses-dropout" in msg
    assert "batch-head mask coordinate" in msg
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    qj = jnp.zeros((1, 8, 2, 64))
    with pytest.raises(NotImplementedError) as ej:
        jax.shard_map(lambda a: jpar.ulysses_attention(
            a, a, a, "data", dropout_rate=0.1, dropout_seed=0), mesh=mesh,
            in_specs=P(None, "data"), out_specs=P(None, "data"),
            check_vma=False)(qj)
    assert str(ej.value) == msg
