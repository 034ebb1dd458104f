"""Parity of apex_tpu_torch.arena and ops.multi_tensor with the JAX package.

The layout (offsets, padded slots, totals, buffer lengths, partition
order) equals ``apex_tpu.arena.plan`` for the same ordered sizes and
dtypes, exactly; flatten/unflatten round-trip exactly with zero padding;
the reductions agree with the JAX ops (Pallas kernels in interpret mode)
at rtol 1e-6 (f32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import arena as JA
from apex_tpu.arena import native as JN
from apex_tpu.ops import multi_tensor as JMT
from apex_tpu_torch import arena as TA
from apex_tpu_torch.arena import native as TN
from apex_tpu_torch.ops import multi_tensor as TMT
from apex_tpu_torch.utils import tree_select

# ordered leaves of two dtypes, with ragged sizes and a scalar
_LEAVES = [("a", (3, 5), "float32"), ("b", (2048,), "float32"),
           ("c", (7,), "bfloat16"), ("d", (), "float32"),
           ("e", (33, 40), "bfloat16"), ("f", (1025,), "float32")]
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return [(n, np.asarray(rng.randn(*s) * 2.0, np.float32), dt)
            for n, s, dt in _LEAVES]


def _torch_tree(arrays):
    return {n: torch.tensor(a).to(_TDT[dt]) for n, a, dt in arrays}


def _jax_list(arrays):
    return [jnp.asarray(a, jnp.dtype(dt)) for _, a, dt in arrays]


@pytest.mark.parametrize("alignment", [1024, 128, 1])
def test_plan_matches_jax(alignment):
    arrays = _arrays()
    tspec = TA.plan(_torch_tree(arrays), alignment=alignment)
    jspec = JA.plan(_jax_list(arrays), alignment=alignment)
    assert tspec.dtypes == jspec.dtypes == ("bfloat16", "float32")
    for tp, jp in zip(tspec.partitions, jspec.partitions):
        assert (tp.dtype, tp.sizes, tp.offsets, tp.padded, tp.total,
                tp.buffer_len) == (jp.dtype, jp.sizes, jp.offsets,
                                   jp.padded, jp.total, jp.buffer_len)
    assert tspec.leaf_partition == jspec.leaf_partition
    assert tspec.total_elements == jspec.total_elements
    assert TA.plan(_torch_tree(arrays), alignment=alignment) is tspec


def test_native_planners_match_jax_fallback():
    sizes = np.array([5, 1024, 1, 3000, 0, 70000], np.int64)
    for got, want in zip(TN.plan_layout(sizes, 1024),
                         JN.plan_layout(sizes, 1024)):
        np.testing.assert_array_equal(got, want)
    padded = TN.plan_layout(sizes, 1024)[1]
    for cap in (1, 2048, 5000, 10 ** 6):
        ids, nb = TN.plan_buckets(padded, cap)
        jids, jnb = JN.plan_buckets(padded, cap)
        np.testing.assert_array_equal(ids, jids)
        assert nb == jnb
    for world in (1, 3, 8):
        starts, per = TN.plan_shards(123457, world, 1024)
        jstarts, jper = JN.plan_shards(123457, world, 1024)
        np.testing.assert_array_equal(starts, jstarts)
        assert per == jper


def test_flatten_round_trip_zero_padding_and_segment_ids():
    arrays = _arrays()
    tree = _torch_tree(arrays)
    spec = TA.plan(tree)
    jspec = JA.plan(_jax_list(arrays))
    flat = TA.flatten(tree, spec)
    jflat = JA.flatten(_jax_list(arrays), jspec)
    for dt in spec.dtypes:
        assert flat[dt].dtype == _TDT[dt]
        assert flat[dt].shape == (spec.partition(dt).buffer_len,)
        # same leaf order on both sides here, so the buffers are equal
        np.testing.assert_array_equal(flat[dt].float().numpy(),
                                      np.asarray(jflat[dt], np.float32))
        ids = TA.segment_ids(spec, dt)
        np.testing.assert_array_equal(ids, JA.segment_ids(jspec, dt))
        pad = flat[dt][torch.from_numpy(ids < 0)]
        assert pad.numel() > 0 and torch.all(pad == 0)
        np.testing.assert_array_equal(TA.valid_mask(spec, _TDT[dt]),
                                      JA.valid_mask(jspec, dt))
    back = TA.unflatten(flat, spec)
    assert list(back) == list(tree)
    for k, v in tree.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        assert torch.equal(back[k], v)


def test_flatten_cast_keys_by_param_partition_and_zeros():
    tree = _torch_tree(_arrays())
    spec = TA.plan(tree)
    grads = {k: v.float() * 0.5 for k, v in tree.items()}
    g = TA.flatten(grads, spec, cast=torch.float32)
    assert set(g) == {"bfloat16", "float32"}
    assert all(b.dtype == torch.float32 for b in g.values())
    back = TA.unflatten(g, spec)
    for k in tree:
        assert torch.equal(back[k], grads[k])
    z = TA.zeros(spec)
    assert {k: v.dtype for k, v in z.items()} == {
        "bfloat16": torch.bfloat16, "float32": torch.float32}
    z32 = TA.zeros(spec, dtype=torch.float32)
    assert all(v.dtype == torch.float32 and not v.any() for v in z32.values())


def test_flatten_refuses_other_names():
    tree = _torch_tree(_arrays())
    spec = TA.plan(tree)
    with pytest.raises(ValueError):
        TA.flatten({**tree, "extra": torch.ones(2)}, spec)


def test_unflatten_returns_views_and_tree_select_keeps_values():
    tree = _torch_tree(_arrays())
    spec = TA.plan(tree)
    flat = TA.flatten(tree, spec)
    views = TA.unflatten(flat, spec)
    for k, v in views.items():
        buf = flat[spec.leaf_partition[spec.names.index(k)][0]]
        assert v.untyped_storage().data_ptr() == \
            buf.untyped_storage().data_ptr()
    other = {k: v + 1 for k, v in tree.items()}
    for pred, want in ((torch.tensor(True), tree),
                       (torch.tensor(False), other)):
        sel = tree_select(pred, views, other)
        for k in tree:
            assert torch.equal(sel[k], want[k])


def _partition(seed=0):
    """One f32 partition's buffer and spec, from ragged leaves."""
    rng = np.random.RandomState(seed)
    leaves = [rng.randn(*s).astype(np.float32) * sc for s, sc in
              (((3, 5), 1.0), ((2048,), 0.1), ((1,), 3.0), ((1500,), 2.0),
               ((4,), 0.0), ((700, 3), 0.5))]
    tspec = TA.plan({f"x{i}": torch.tensor(a) for i, a in enumerate(leaves)})
    jspec = JA.plan([jnp.asarray(a) for a in leaves])
    tbuf = TA.flatten({f"x{i}": torch.tensor(a)
                       for i, a in enumerate(leaves)}, tspec)["float32"]
    jbuf = JA.flatten([jnp.asarray(a) for a in leaves], jspec)["float32"]
    return tspec.partition("float32"), tbuf, jspec.partition("float32"), jbuf


def test_multi_tensor_l2norm_matches_jax():
    part, tbuf, _, jbuf = _partition()
    got = TMT.multi_tensor_l2norm(tbuf)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(JMT.multi_tensor_l2norm(jbuf)),
                               rtol=1e-6)
    bf = tbuf.to(torch.bfloat16)
    np.testing.assert_allclose(
        TMT.multi_tensor_l2norm(bf).item(),
        float(JMT.multi_tensor_l2norm(jnp.asarray(bf.float().numpy(),
                                                  jnp.bfloat16))), rtol=1e-6)
    with pytest.raises(ValueError, match="BUFFER_MULTIPLE"):
        TMT.multi_tensor_l2norm(tbuf[:1000])


def test_per_tensor_norms_match_jax():
    part, tbuf, jpart, jbuf = _partition()
    assert part.offsets == jpart.offsets
    got = TMT.per_tensor_l2norm_ranges(tbuf, part.offsets, part.sizes)
    want = JMT.per_tensor_l2norm_ranges(jbuf, jpart.offsets, jpart.sizes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert got[4].item() == 0.0
    got = TMT.per_tensor_maxnorm_ranges(tbuf, part.offsets, part.sizes)
    want = JMT.per_tensor_maxnorm_ranges(jbuf, jpart.offsets, jpart.sizes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ids = JA.segment_ids(JA.plan([jnp.zeros(s) for s in part.sizes]),
                         "float32")
    got = TMT.per_tensor_l2norm(tbuf, ids, len(part.sizes))
    want = JMT.per_tensor_l2norm(jbuf, jnp.asarray(ids), len(part.sizes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("fill", [0.0, -2.5])
def test_spread_per_tensor_matches_jax(fill):
    part, tbuf, jpart, _ = _partition()
    vals = np.arange(1, len(part.sizes) + 1, dtype=np.float32) * 0.5
    got = TMT.spread_per_tensor(torch.tensor(vals), part.offsets, part.padded,
                                tbuf.numel(), fill=fill)
    want = JMT.spread_per_tensor(jnp.asarray(vals), jpart.offsets,
                                 jpart.padded, tbuf.numel(), fill=fill)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_per_tensor_ranges_with_gaps_and_unaligned_offsets():
    """Ranges need not tile the buffer: gaps, a 128-aligned layout and
    sizes that end inside a row all agree with the JAX ranges."""
    rng = np.random.RandomState(1)
    n = 65536
    buf = np.zeros(n, np.float32)
    offsets, sizes = (128, 2048, 5120), (100, 1500, 3)
    for off, sz in zip(offsets, sizes):
        buf[off:off + sz] = rng.randn(sz)
    got = TMT.per_tensor_l2norm_ranges(torch.tensor(buf), offsets, sizes)
    want = JMT.per_tensor_l2norm_ranges(jnp.asarray(buf), offsets, sizes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    vals = np.array([1.0, 2.0, 3.0], np.float32)
    padded = (128, 2048, 128)
    got = TMT.spread_per_tensor(torch.tensor(vals), offsets, padded, n,
                                fill=9.0)
    want = JMT.spread_per_tensor(jnp.asarray(vals), offsets, padded, n,
                                 fill=9.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
