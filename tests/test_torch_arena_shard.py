"""The arena helpers ZeRO and the buckets call, against the JAX package.

``arena.segment_ids_device``, ``bucket_ids`` and ``shard_pad`` bit for bit;
``multi_tensor.per_tensor_sq_shard`` (rtol 1e-6: both sum each element's
square once in f32, in other orders) and ``spread_per_tensor_shard`` (bit
for bit) for every rank of worlds 1, 2, 3 and 8, on arenas whose shards
begin and end inside tensors, tensors that miss a shard, and tensors
smaller than a row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import arena as JA
from apex_tpu.ops import multi_tensor as JM
from apex_tpu.optim.distributed import _padded_len
from apex_tpu_torch import arena as TA
from apex_tpu_torch.ops import multi_tensor as TM

SHAPES = {"a": (1000,), "b": (50, 100), "c": (70000,), "d": (1,),
          "e": (300, 1000), "f": (65536,), "g": (7,)}


def _tree(seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(dtype) for k, s in SHAPES.items()}


def _specs(tree, **kw):
    return (JA.plan({k: jnp.asarray(v) for k, v in tree.items()}, **kw),
            TA.plan({k: torch.tensor(v) for k, v in tree.items()}, **kw))


@pytest.mark.parametrize("alignment", [1024, 128])
def test_segment_ids_device_bitwise(alignment):
    tree = _tree()
    tree["h"] = np.zeros((3, 5), np.float16)
    jspec, tspec = _specs(tree, alignment=alignment)
    for dt in ("float32", "float16"):
        want = np.asarray(JA.segment_ids_device(jspec, dt))
        got = TA.segment_ids_device(tspec, dt, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), TA.segment_ids(tspec, dt))


@pytest.mark.parametrize("bucket_elems", [1, 5000, 100_000, 10 ** 9])
def test_bucket_ids_bitwise(bucket_elems):
    jspec, tspec = _specs(_tree())
    np.testing.assert_array_equal(
        TA.bucket_ids(tspec, "float32", bucket_elems),
        JA.bucket_ids(jspec, "float32", bucket_elems))


@pytest.mark.parametrize("world", [1, 2, 3, 8])
def test_shard_pad_bitwise(world):
    tree = _tree()
    jspec, tspec = _specs(tree)
    jb = JA.shard_pad(JA.flatten({k: jnp.asarray(v) for k, v in tree.items()},
                                 jspec), world)
    tb = TA.shard_pad(TA.flatten({k: torch.tensor(v)
                                  for k, v in tree.items()}, tspec), world)
    for dt in jb:
        np.testing.assert_array_equal(tb[dt].numpy(), np.asarray(jb[dt]))
        assert tb[dt].numel() % world == 0


def _shards(world, seed):
    """(offsets, sizes, the padded whole buffer, per) of an f32 arena padded
    for ``world`` ZeRO shards (65536-aligned, so shards cut tensors)."""
    tree = _tree(seed)
    _, tspec = _specs(tree)
    part = tspec.partition("float32")
    buf = TA.flatten({k: torch.tensor(v) for k, v in tree.items()},
                     tspec)["float32"].numpy()
    total = _padded_len(part.buffer_len, world)
    return (part.offsets, part.sizes, np.pad(buf, (0, total - buf.size)),
            total // world)


@pytest.mark.parametrize("world", [1, 2, 3, 8])
def test_per_tensor_sq_shard_every_rank(world):
    offsets, sizes, full, per = _shards(world, 1)
    total = np.zeros(len(sizes))
    for r in range(world):
        shard = full[r * per:(r + 1) * per]
        want = np.asarray(JM.per_tensor_sq_shard(jnp.asarray(shard), offsets,
                                                 sizes, r * per))
        got = TM.per_tensor_sq_shard(torch.tensor(shard), offsets, sizes,
                                     r * per)
        assert got.dtype == torch.float32 and got.shape == (len(sizes),)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        total += got.numpy()
    exact = np.array([np.sum(full[o:o + s].astype(np.float64) ** 2)
                      for o, s in zip(offsets, sizes)])
    np.testing.assert_allclose(total, exact, rtol=1e-5)


def test_per_tensor_sq_shard_whole_buffer_is_the_arena_norm_squared():
    """One shard over the whole buffer: the arena LAMB's per-tensor norms
    squared, bit for bit (the same rows and sums), so a ZeRO step at
    world 1 is the arena step."""
    offsets, sizes, full, _ = _shards(1, 2)
    buf = torch.tensor(full)
    sq = TM.per_tensor_sq_shard(buf, offsets, sizes, 0)
    norms = TM.per_tensor_l2norm_ranges(buf, offsets, sizes)
    assert torch.equal(torch.sqrt(sq), norms)


@pytest.mark.parametrize("world", [1, 2, 3, 8])
@pytest.mark.parametrize("fill", [0.0, 1.0])
def test_spread_per_tensor_shard_bitwise(world, fill):
    offsets, sizes, _, per = _shards(world, 3)
    values = np.random.RandomState(4).rand(len(sizes)).astype(np.float32)
    for r in range(world):
        want = np.asarray(JM.spread_per_tensor_shard(
            jnp.asarray(values), offsets, sizes, r * per, per, fill=fill))
        got = TM.spread_per_tensor_shard(torch.tensor(values), offsets,
                                         sizes, r * per, per, fill=fill)
        np.testing.assert_array_equal(got.numpy(), want)


def test_shard_helpers_on_odd_shard_lengths():
    """A shard whose length is not a multiple of the row width: the
    helpers narrow their rows and still match JAX. The padding is zero,
    as the arena lays it out."""
    offsets, sizes = (0, 1024, 3072), (1000, 2000, 5)
    full = np.zeros(4100, np.float32)
    rng = np.random.RandomState(5)
    for o, n in zip(offsets, sizes):
        full[o:o + n] = rng.randn(n)
    for start, per in ((0, 1500), (1500, 1500), (3000, 1100)):
        shard = full[start:start + per]
        np.testing.assert_allclose(
            TM.per_tensor_sq_shard(torch.tensor(shard), offsets, sizes,
                                   start).numpy(),
            np.asarray(JM.per_tensor_sq_shard(jnp.asarray(shard), offsets,
                                              sizes, start)), rtol=1e-6)
        vals = np.array([2.0, 3.0, 4.0], np.float32)
        np.testing.assert_array_equal(
            TM.spread_per_tensor_shard(torch.tensor(vals), offsets, sizes,
                                       start, per).numpy(),
            np.asarray(JM.spread_per_tensor_shard(jnp.asarray(vals),
                                                  offsets, sizes, start,
                                                  per)))
