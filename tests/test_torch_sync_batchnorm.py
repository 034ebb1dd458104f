"""The port's SyncBatchNorm across four gloo ranks against the JAX
package's under ``shard_map`` over four of the eight virtual CPU devices.

Ports ``tests/test_sync_batchnorm.py`` case by case: the combined-batch
forward, unequal batches through ``valid_count``, stats groups (two groups
of two), the fused add + ReLU, gradients, the module in training and eval,
``convert_sync_batchnorm`` over flax's BatchNorm, and groupbn's
``BatchNorm2d_NHWC``. The four ranks run once for the whole file
(``_torch_parallel_cases.run``); each test reads its case. Tolerances are
the JAX suite's: statistics at atol 1e-5, outputs at 1e-4 (f32 sums in
another order), gradients at 1e-4 against JAX on the same per-rank loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import _torch_parallel_cases as C
from apex_tpu import parallel as jpar
from apex_tpu.ops import group_bn as jgbn
from apex_tpu_torch import parallel as tpar
from apex_tpu_torch.ops import group_bn as tgbn

WORLD = 4
NAMES = [n for n in C.CASES if n.startswith("syncbn_")]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return C.run(WORLD, NAMES, tmp_path_factory.mktemp("syncbn"))


def _smap(fn, *args, in_specs, out_specs):
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)(*args)


def _cat(per, key):
    return np.concatenate([r[key] for r in per])


def _stack(per, key):
    return np.stack([r[key] for r in per])


def np_batchnorm(x, scale, bias, eps=1e-5):
    axes = tuple(range(x.ndim - 1))
    mean, var = x.mean(axis=axes), x.var(axis=axes)
    return (x - mean) / np.sqrt(var + eps) * scale + bias, mean, var


def test_forward_matches_combined_batch_and_jax(results):
    per = C.ranks(results, "syncbn_fwd")
    x, scale, bias = C.syncbn_inputs("fwd")

    def fwd(xs):
        y, mean, var, count = jpar.sync_batch_norm(
            xs, jnp.asarray(scale), jnp.asarray(bias), axis_name="data")
        return y, mean[None], var[None], count[None]

    y, mean, var, count = _smap(fwd, jnp.asarray(x), in_specs=P("data"),
                                out_specs=(P("data"),) * 4)
    y_ref, mean_ref, var_ref = np_batchnorm(x, scale, bias)
    np.testing.assert_allclose(_cat(per, "y"), np.asarray(y), atol=1e-4)
    np.testing.assert_allclose(_cat(per, "y"), y_ref, atol=1e-4)
    np.testing.assert_allclose(_stack(per, "mean"), np.asarray(mean),
                               atol=1e-5)
    np.testing.assert_allclose(_stack(per, "var"), np.asarray(var),
                               atol=1e-5)
    for r in per:
        np.testing.assert_allclose(r["mean"], mean_ref, atol=1e-5)
        np.testing.assert_allclose(r["var"], var_ref, atol=1e-5)
        assert float(r["count"]) == x.size // x.shape[-1]
    np.testing.assert_array_equal(_stack(per, "count"), np.asarray(count))


def test_unequal_batch_sizes_combine_by_valid_count(results):
    per = C.ranks(results, "syncbn_unequal")
    x, counts = C.syncbn_inputs("unequal")
    valid = np.concatenate([C.shard(x, r, WORLD)[:n]
                            for r, n in enumerate(counts)])

    def fwd(xs, n):
        mean, var, count = jpar.sync_moments(
            xs, axis_name="data", reduce_axes=(0,), valid_count=n[0])
        return mean[None], var[None], count[None]

    mean, var, count = _smap(fwd, jnp.asarray(x),
                             jnp.asarray(counts, jnp.float32),
                             in_specs=(P("data"), P("data")),
                             out_specs=(P("data"),) * 3)
    for i, r in enumerate(per):
        assert float(r["count"]) == counts.sum() == float(count[i])
        np.testing.assert_allclose(r["mean"], valid.mean(axis=0), atol=1e-5)
        np.testing.assert_allclose(r["var"], valid.var(axis=0), atol=1e-5)
        np.testing.assert_allclose(r["mean"], np.asarray(mean[i]), atol=1e-6)
        np.testing.assert_allclose(r["var"], np.asarray(var[i]), atol=1e-6)


def test_stats_groups_normalise_within_their_group(results):
    per = C.ranks(results, "syncbn_groups")
    (x,) = C.syncbn_inputs("groups")
    groups = jpar.syncbn_stats_groups(WORLD, 2)
    assert groups == tpar.syncbn_stats_groups(WORLD, 2) == [[0, 1], [2, 3]]

    def fwd(xs):
        mean, var, _ = jpar.sync_moments(xs, axis_name="data",
                                         reduce_axes=(0,),
                                         axis_index_groups=groups)
        return mean[None], var[None]

    mean, var = _smap(fwd, jnp.asarray(x), in_specs=P("data"),
                      out_specs=(P("data"), P("data")))
    for r, res in enumerate(per):
        rows = x[:8] if r < 2 else x[8:]
        np.testing.assert_allclose(res["mean"], rows.mean(axis=0), atol=1e-5)
        np.testing.assert_allclose(res["var"], rows.var(axis=0), atol=1e-5)
        np.testing.assert_allclose(res["mean"], np.asarray(mean[r]),
                                   atol=1e-6)
        np.testing.assert_allclose(res["var"], np.asarray(var[r]), atol=1e-6)
        assert float(res["count"]) == 8


def test_fused_add_relu(results):
    per = C.ranks(results, "syncbn_add_relu")
    x, z = C.syncbn_inputs("add_relu")

    def fwd(xs, zs):
        return jpar.sync_batch_norm(xs, None, None, axis_name="data", z=zs,
                                    relu=True)[0]

    y = _smap(fwd, jnp.asarray(x), jnp.asarray(z),
              in_specs=(P("data"), P("data")), out_specs=P("data"))
    expect = np.maximum((x - x.mean(0)) / np.sqrt(x.var(0) + 1e-5) + z, 0.0)
    np.testing.assert_allclose(_cat(per, "y"), expect, atol=1e-4)
    np.testing.assert_allclose(_cat(per, "y"), np.asarray(y), atol=1e-5)


def test_grads_match_jax_and_the_full_batch(results):
    """dx of each rank's loss Σ y³ is the full-batch BN's; dγ and dβ are
    each rank's own (autodiff of the forward), in both packages, and sum
    over the ranks to the full batch's."""
    per = C.ranks(results, "syncbn_grads")
    x, scale, bias = C.syncbn_inputs("grads")

    def grads(xs):
        def loss(xx, s, b):
            y, *_ = jpar.sync_batch_norm(xx, s, b, axis_name="data")
            return jnp.sum(y ** 3)
        dx, ds, db = jax.grad(loss, argnums=(0, 1, 2))(
            xs, jnp.asarray(scale), jnp.asarray(bias))
        return dx, ds[None], db[None]

    dx, ds, db = _smap(grads, jnp.asarray(x), in_specs=P("data"),
                       out_specs=(P("data"),) * 3)

    def full(xx, s, b):
        mean = jnp.mean(xx, axis=0)
        var = jnp.mean(jnp.square(xx - mean), axis=0)
        return jnp.sum(((xx - mean) / jnp.sqrt(var + 1e-5) * s + b) ** 3)

    fdx, fds, fdb = jax.grad(full, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    np.testing.assert_allclose(_cat(per, "dx"), np.asarray(dx), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(_cat(per, "dx"), np.asarray(fdx), atol=1e-3)
    np.testing.assert_allclose(_stack(per, "dscale"), np.asarray(ds),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_stack(per, "dbias"), np.asarray(db),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_stack(per, "dscale").sum(0), np.asarray(fds),
                               rtol=1e-3)
    np.testing.assert_allclose(_stack(per, "dbias").sum(0), np.asarray(fdb),
                               rtol=1e-3)


def test_module_train_and_eval(results):
    per = C.ranks(results, "syncbn_module")
    (x,) = C.syncbn_inputs("module")
    bn = jpar.SyncBatchNorm(num_features=3, axis_name="data", momentum=0.5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x[:2]))

    def train(xs):
        y, mut = bn.apply(variables, xs, mutable=["batch_stats"])
        return y, mut["batch_stats"]["mean"][None], \
            mut["batch_stats"]["var"][None]

    y, mean, var = _smap(train, jnp.asarray(x), in_specs=P("data"),
                         out_specs=(P("data"),) * 3)
    n = x.size // 3
    np.testing.assert_allclose(_cat(per, "y"), np.asarray(y), atol=1e-5)
    for r, res in enumerate(per):
        np.testing.assert_allclose(res["mean"],
                                   0.5 * x.mean(axis=(0, 1, 2)), atol=1e-5)
        np.testing.assert_allclose(
            res["var"], 0.5 + 0.5 * x.var(axis=(0, 1, 2)) * n / (n - 1),
            atol=1e-4)
        np.testing.assert_allclose(res["mean"], np.asarray(mean[r]),
                                   atol=1e-6)
        np.testing.assert_allclose(res["var"], np.asarray(var[r]), atol=1e-6)
        y_eval = bn.apply({"params": variables["params"], "batch_stats": {
            "mean": jnp.asarray(res["mean"]), "var": jnp.asarray(res["var"])}},
            jnp.asarray(x), use_running_average=True)
        np.testing.assert_allclose(res["y_eval"], np.asarray(y_eval),
                                   atol=1e-5)


def test_convert_sync_batchnorm_syncs_flax_batchnorm(results):
    import flax.linen as nn
    per = C.ranks(results, "syncbn_convert")
    x, g = C.syncbn_inputs("convert")
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x[:2]))

    def fwd(xs, gs):
        def loss(xx):
            with jpar.convert_sync_batchnorm("data"):
                y, mut = bn.apply(variables, xx, mutable=["batch_stats"])
            return jnp.sum(y * gs), (y, mut["batch_stats"])
        (_, (y, st)), dx = jax.value_and_grad(loss, has_aux=True)(xs)
        return y, st["mean"][None], st["var"][None], dx

    y, mean, var, dx = _smap(fwd, jnp.asarray(x), jnp.asarray(g),
                             in_specs=(P("data"), P("data")),
                             out_specs=(P("data"),) * 4)
    y_ref, _, _ = np_batchnorm(x, np.ones(4, np.float32),
                               np.zeros(4, np.float32))
    np.testing.assert_allclose(_cat(per, "y"), y_ref, atol=1e-4)
    np.testing.assert_allclose(_cat(per, "y"), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(_cat(per, "dx"), np.asarray(dx), atol=1e-4)
    np.testing.assert_allclose(_stack(per, "mean"), np.asarray(mean),
                               atol=1e-6)
    np.testing.assert_allclose(_stack(per, "var"), np.asarray(var),
                               atol=1e-6)


def test_group_bn_exchanges_statistics_within_bn_group(results):
    per = C.ranks(results, "syncbn_group_bn")
    x, z = C.syncbn_inputs("group_bn")
    bn = jgbn.BatchNorm2d_NHWC(4, fuse_relu=True, bn_group=2,
                               world_size=WORLD, axis_name="data")
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x[:2]))

    def fwd(xs, zs):
        y, mut = bn.apply(variables, xs, zs, mutable=["batch_stats"])
        return (y, mut["batch_stats"]["mean"][None],
                mut["batch_stats"]["var"][None])

    y, mean, var = _smap(fwd, jnp.asarray(x), jnp.asarray(z),
                         in_specs=(P("data"), P("data")),
                         out_specs=(P("data"),) * 3)
    np.testing.assert_allclose(_cat(per, "y"), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(_stack(per, "mean"), np.asarray(mean),
                               atol=1e-6)
    np.testing.assert_allclose(_stack(per, "var"), np.asarray(var),
                               atol=1e-6)
    # ranks 0, 1 share statistics; ranks 2, 3 theirs, which differ
    np.testing.assert_allclose(per[0]["mean"], per[1]["mean"], atol=1e-7)
    assert not np.allclose(per[1]["mean"], per[2]["mean"])


@pytest.mark.parametrize("world, size, want", [
    (8, 4, [[0, 1, 2, 3], [4, 5, 6, 7]]),
    (8, 1, [[i] for i in range(8)]),
    (8, 0, None), (8, 8, None), (4, 16, None),
    (6, 3, [[0, 1, 2], [3, 4, 5]])])
def test_stats_groups_and_bn_group_spec_match_jax(world, size, want):
    assert tpar.syncbn_stats_groups(world, size) == want
    assert jpar.syncbn_stats_groups(world, size) == want
    assert tgbn.bn_group_spec(world, size) == jgbn.bn_group_spec(world, size)


def test_stats_groups_reject_uneven_split():
    with pytest.raises(ValueError):
        tpar.syncbn_stats_groups(8, 3)


def test_welford_combine_matches_jax():
    """The count-weighted combine of (mean, var, count) triples, unequal
    counts, against the JAX package's at f32 (atol 1e-6)."""
    import torch
    from apex_tpu.parallel.sync_batchnorm import _welford_combine as jwc
    from apex_tpu_torch.parallel.sync_batchnorm import _welford_combine as twc
    rng = np.random.RandomState(9)
    means = rng.randn(3, 5).astype(np.float32) * 3
    variances = rng.rand(3, 5).astype(np.float32) + 0.1
    counts = np.array([2.0, 7.0, 11.0], np.float32)
    want = jwc(jnp.asarray(means), jnp.asarray(variances),
               jnp.asarray(counts))
    got = twc(torch.tensor(means), torch.tensor(variances),
              torch.tensor(counts))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)
