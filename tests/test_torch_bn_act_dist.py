"""The fused BN unit and ConvBNAct with statistics across two gloo ranks,
against the JAX package's units under ``shard_map`` over two CPU devices.

Every mode (plain, relu, a residual join with and without ReLU, fp8
residuals): z, the group's statistics and count, and the gradients of
each rank's loss Σ z·g, the loss of the JAX suite's
``test_sync_grads_match_single_device``. As there, dx is the full batch's
and dγ, dβ on every rank are the full batch's (the all-reduced channel
sums); the unfused ``SyncBatchNorm`` differentiates its forward and gives
each rank its own dγ, dβ (ROADMAP.md, reference caveats), which a test
pins. ConvBNAct with ``axis_name`` is held the same way. The two ranks run
once for the file; tolerances are the JAX suite's (forward atol 1e-5,
gradients atol 2e-4 / rtol 1e-4 against JAX, 2e-3 for dγ, dβ against the
single-device full batch, whose sums run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_parallel_cases as C
from apex_tpu.ops import bn_act as JB
from apex_tpu.ops import conv_bn as JCB
from apex_tpu_torch.ops import bn_act as TB
from apex_tpu_torch.ops import conv_bn as TCB

WORLD = 2
NAMES = [n for n in C.CASES if n.startswith(("bnact_", "conv_"))]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return C.run(WORLD, NAMES, tmp_path_factory.mktemp("bnact"))


def _smap(fn, *args, in_specs, out_specs):
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)(*args)


def _jax_unit(mode, x, r, g, axis_name):
    relu, res, fp8 = C.bn_mode(mode)
    _, _, scale, bias, _ = C.bn_inputs()
    cfg = JB.make_cfg(relu=relu, axis_name=axis_name, fp8=fp8)
    args = [x] + ([r] if res else []) + [jnp.asarray(scale),
                                         jnp.asarray(bias)]
    unit = JB.bn_add_act_train if res else JB.bn_act_train

    def loss(*a):
        z, mean, var, count = unit(*a, cfg)
        return jnp.sum(z * g), (z, mean, var, count)

    grads, (z, mean, var, count) = jax.grad(
        loss, argnums=tuple(range(len(args))), has_aux=True)(*args)
    out = {"z": z, "mean": mean[None], "var": var[None],
           "count": count[None], "dx": grads[0],
           "dscale": grads[-2][None], "dbias": grads[-1][None]}
    if res:
        out["dr"] = grads[1]
    return out


def _jax_sharded(mode):
    x, r, _, _, g = (jnp.asarray(a) for a in C.bn_inputs())
    return _smap(lambda *a: _jax_unit(mode, *a, "data"), x, r, g,
                 in_specs=(P("data"),) * 3, out_specs=P("data"))


def _rows(per, key):
    return np.concatenate([np.reshape(r[key], (-1,) + r[key].shape[1:])
                           if r[key].ndim else r[key][None] for r in per])


@pytest.mark.parametrize("mode", C.BN_MODES)
def test_fused_unit_across_ranks_matches_jax(results, mode):
    per = C.ranks(results, f"bnact_{mode}")
    want = _jax_sharded(mode)
    for key, w in want.items():
        got = (_rows(per, key) if key in ("z", "dx", "dr")
               else np.stack([np.reshape(r[key], np.shape(w)[1:])
                              for r in per]))
        tol = (dict(atol=1e-5, rtol=1e-5)
               if key in ("z", "mean", "var", "count")
               else dict(atol=2e-4, rtol=1e-4))
        np.testing.assert_allclose(got, np.asarray(w), err_msg=key, **tol)


@pytest.mark.parametrize("mode", [m for m in C.BN_MODES if m != "fp8"])
def test_fused_unit_across_ranks_is_the_full_batch_unit(results, mode):
    """dx is the single-device full batch's, and every rank holds the full
    batch's dγ and dβ (the JAX unit's all-reduced sums)."""
    per = C.ranks(results, f"bnact_{mode}")
    x, r, _, _, g = (jnp.asarray(a) for a in C.bn_inputs())
    full = _jax_unit(mode, x, r, g, None)
    np.testing.assert_allclose(_rows(per, "z"), np.asarray(full["z"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_rows(per, "dx"), np.asarray(full["dx"]),
                               atol=2e-4, rtol=1e-4)
    for res in per:
        assert float(res["count"]) == x.size // x.shape[-1]
        np.testing.assert_allclose(res["mean"], np.asarray(full["mean"][0]),
                                   atol=1e-5)
        for key in ("dscale", "dbias"):
            np.testing.assert_allclose(res[key], np.asarray(full[key][0]),
                                       atol=2e-3, rtol=1e-4, err_msg=key)


def test_groups_of_one_rank_are_each_ranks_own_unit(results):
    for res in C.ranks(results, "bnact_rank_groups"):
        for key, v in res["alone"].items():
            np.testing.assert_allclose(res["grouped"][key], v, atol=2e-6,
                                       rtol=1e-5, err_msg=key)


def test_unfused_syncbn_grads_are_local_and_fused_ones_the_groups(results):
    """Reference caveat, pinned: after an average over W ranks the fused
    unit's dγ, dβ are W times the convolutions' scale of gradient."""
    fused = C.ranks(results, "bnact_relu")
    unfused = C.ranks(results, "bnact_unfused_local_grads")
    from apex_tpu import parallel as jpar
    x, _, scale, bias, g = (jnp.asarray(a) for a in C.bn_inputs())

    def local(xs, gs):
        def loss(xx, s, b):
            y, *_ = jpar.sync_batch_norm(xx, s, b, axis_name="data",
                                         relu=True)
            return jnp.sum(y * gs)
        dx, ds, db = jax.grad(loss, argnums=(0, 1, 2))(xs, scale, bias)
        return dx, ds[None], db[None]

    dx, ds, db = _smap(local, x, g, in_specs=(P("data"),) * 2,
                       out_specs=(P("data"),) * 3)
    np.testing.assert_allclose(_rows(unfused, "dx"), np.asarray(dx),
                               atol=2e-4, rtol=1e-4)
    for key, w in (("dscale", ds), ("dbias", db)):
        got = np.stack([res[key] for res in unfused])
        np.testing.assert_allclose(got, np.asarray(w), atol=2e-4, rtol=1e-4)
        # the group's dγ is the sum of the ranks' own; no rank's own is it
        for res in fused:
            np.testing.assert_allclose(res[key], got.sum(0), atol=2e-4,
                                       rtol=1e-4)
            assert not np.allclose(res[key], got[0], atol=1e-2)
    np.testing.assert_allclose(_rows(unfused, "dx"), _rows(fused, "dx"),
                               atol=2e-4, rtol=1e-4)


def test_fused_module_running_statistics_match_jax(results):
    per = C.ranks(results, "bnact_module")
    x, r, *_ = (jnp.asarray(a) for a in C.bn_inputs())
    mod = JB.FusedBNAct(num_features=8, relu=True, momentum=0.9,
                        axis_name="data")
    variables = mod.init(jax.random.PRNGKey(0), x[:2], r[:2])

    def fwd(xs, rs):
        z, mut = mod.apply(variables, xs, rs, train=True,
                           mutable=["batch_stats"])
        st = mut["batch_stats"]
        return z, st["mean"][None], st["var"][None]

    z, mean, var = _smap(fwd, x, r, in_specs=(P("data"),) * 2,
                         out_specs=(P("data"),) * 3)
    np.testing.assert_allclose(_rows(per, "z"), np.asarray(z), atol=1e-5)
    np.testing.assert_allclose(np.stack([res["mean"] for res in per]),
                               np.asarray(mean), atol=1e-6)
    np.testing.assert_allclose(np.stack([res["var"] for res in per]),
                               np.asarray(var), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("join", [False, True])
def test_conv_bn_act_across_ranks_matches_jax(results, join):
    per = C.ranks(results, "conv_addrelu" if join else "conv_relu")
    a, w, r, scale, bias, g = (jnp.asarray(v) for v in C.conv_inputs())
    w_hwio = jnp.transpose(w, (2, 3, 1, 0))

    def sharded(a_s, r_s, g_s):
        cfg = JCB.make_conv_cfg(relu=True, axis_name="data")
        args = [a_s, w_hwio] + ([r_s] if join else []) + [scale, bias]
        unit = JCB.conv_bn_add_act_train if join else JCB.conv_bn_act_train

        def loss(*args_):
            z, mean, var, count = unit(*args_, cfg)
            return jnp.sum(z * g_s), (z, mean, var, count)

        grads, (z, mean, var, count) = jax.grad(
            loss, argnums=tuple(range(len(args))), has_aux=True)(*args)
        names = ["da", "dw"] + (["dr"] if join else []) + ["dscale", "dbias"]
        out = {"z": z, "mean": mean[None], "var": var[None],
               "count": count[None]}
        for name, gr in zip(names, grads):
            out[name] = gr if name in ("da", "dr") else gr[None]
        return out

    want = _smap(sharded, a, r, g, in_specs=(P("data"),) * 3,
                 out_specs=P("data"))
    for key, wv in want.items():
        wv = np.asarray(wv)
        if key == "dw":
            wv = wv.transpose(0, 4, 3, 1, 2)     # HWIO -> (O, I, kh, kw)
        got = (_rows(per, key) if key in ("z", "da", "dr")
               else np.stack([np.reshape(res[key], wv.shape[1:])
                              for res in per]))
        tol = (dict(atol=1e-5, rtol=1e-5)
               if key in ("z", "mean", "var", "count")
               else dict(atol=2e-4, rtol=1e-4))
        np.testing.assert_allclose(got, wv, err_msg=key, **tol)


def test_cfgs_carry_axis_name_and_groups():
    cfg = TB.make_cfg(relu=True, axis_name="data",
                      axis_index_groups=[[0, 1], [2, 3]])
    assert cfg.axis_name == "data" and cfg.groups == ((0, 1), (2, 3))
    ccfg = TCB.make_conv_cfg(relu=False, axis_name="data",
                             axis_index_groups=[[0], [1]])
    assert ccfg.bn().axis_name == "data" and ccfg.bn().groups == ((0,), (1,))
    assert TB.make_cfg(relu=False).axis_name is None


def test_unit_with_an_unbound_axis_name_raises():
    """As JAX raises for an axis name outside shard_map: no mesh bound."""
    x, _, scale, bias, _ = C.bn_inputs()
    cfg = TB.make_cfg(relu=True, axis_name="data")
    with pytest.raises(NameError, match="unbound axis name"):
        TB.bn_act_train(torch.tensor(x), torch.tensor(scale),
                        torch.tensor(bias), cfg)
