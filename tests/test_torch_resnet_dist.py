"""BASELINE configuration 3 at a structural size across two gloo ranks:
``train.build_resnet_step(bn_axis_name="data")`` (BN statistics across the
ranks, gradients all-reduced by ``parallel.sync_gradients``) against the
JAX package's ``bench._bench_resnet(sync_bn=True)`` step under
``shard_map`` over two CPU devices.

A two-stage bottleneck ResNet of width 8 (10 classes, 32 px, global batch
8, four rows a rank), fused BN units and the unfused ``SyncBatchNorm_0``
oracle. Its flax weights, redrawn from a seed so that no BN is the
identity, reach the port through ``convert.resnet_variables_from_jax``
(``SyncBatchNorm_0``'s params and statistics included). At O0 (f32) the
first step's loss (rtol 1e-5), synced gradients (atol 5e-3, rtol 1e-2:
the JAX suite's allowance for ReLU-threshold ties) and new statistics
(1e-5) and two steps' losses (1e-4); at O2 bf16 the first step's loss
within 1e-2, and two steps against the port's undistributed step within
1e-2 (XLA keeps f32 between bf16 ops on the CPU; PyTorch rounds after
each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import _torch_parallel_cases as C
from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu import ops as jops
from apex_tpu import parallel as jpar
from apex_tpu.optim import FusedSGD as JSGD
from apex_tpu_torch.convert import params_from_jax, resnet_variables_from_jax

WORLD = 2
NAMES = [n for n in C.CASES if n.startswith("resnet_")]


def _jax_model(fused, opt_level):
    return jmodels.ResNet(
        stage_sizes=[1, 1], num_classes=C.RESNET_CLASSES, width=8,
        bn_axis_name="data", fused_bn=fused,
        dtype=jamp.Policy.from_opt_level(opt_level).compute_dtype)


def _variables(fused):
    """flax params and batch_stats, every leaf redrawn from a seed."""
    v = _jax_model(fused, "O0").init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, C.RESNET_SIZE, C.RESNET_SIZE, 3)), train=True)
    rng = np.random.RandomState(5)

    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            out = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif "scale" in name:
            out = 1.0 + 0.3 * rng.randn(*leaf.shape)
        elif "var" in name:
            out = 0.5 + rng.rand(*leaf.shape)
        else:
            out = 0.2 * rng.randn(*leaf.shape)
        return jnp.asarray(out.astype(np.float32))

    return (jax.tree_util.tree_map_with_path(redraw, v["params"]),
            jax.tree_util.tree_map_with_path(redraw, v["batch_stats"]))


@pytest.fixture(scope="module")
def jax_variables():
    return {fused: _variables(fused) for fused in (True, False)}


@pytest.fixture(scope="module")
def results(tmp_path_factory, jax_variables):
    inputs = {("fused" if f else "unfused"): resnet_variables_from_jax(
        *jax_variables[f], device="cpu") for f in (True, False)}
    return C.run(WORLD, NAMES, tmp_path_factory.mktemp("resnet"), inputs)


def _jax_steps(fused, opt_level, params, bstats):
    """Two configuration-3 steps: (losses (2, W), step-0 synced grads,
    step-0 new batch statistics)."""
    policy = jamp.Policy.from_opt_level(opt_level)
    model = _jax_model(fused, opt_level)
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.rand(C.RESNET_BATCH, C.RESNET_SIZE, C.RESNET_SIZE,
                             3).astype(np.float32))
    y = jnp.asarray(rng.randint(0, C.RESNET_CLASSES, C.RESNET_BATCH),
                    jnp.int32)
    amp_opt = jamp.Amp(policy, JSGD(lr=0.1, momentum=0.9))

    def step(state, bs, xb, yb):
        def loss_fn(mp):
            logits, mut = model.apply({"params": mp, "batch_stats": bs}, xb,
                                      train=True, mutable=["batch_stats"])
            return jnp.mean(jops.softmax_cross_entropy_loss(logits, yb)), \
                mut["batch_stats"]
        (loss, nbs), grads, state, finite = amp_opt.backward(
            state, loss_fn, has_aux=True)
        grads = jpar.sync_gradients(grads, "data")
        return (amp_opt.apply_gradients(state, grads, finite), nbs,
                loss[None], grads)

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    mapped = jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=(P(), P(), P("data"), P("data")),
        out_specs=(P(), P(), P("data"), P()), check_vma=False))
    state = amp_opt.init(params)
    s1, bs1, l1, g1 = mapped(state, bstats, x, y)
    _, _, l2, _ = mapped(s1, bs1, x, y)
    return np.stack([np.asarray(l1), np.asarray(l2)]), g1, bs1


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_o0_first_step_matches_the_jax_configuration_3_step(
        results, jax_variables, fused):
    per = C.ranks(results, f"resnet_{'fused' if fused else 'unfused'}_O0")
    params, bstats = jax_variables[fused]
    losses, grads, new_bs = _jax_steps(fused, "O0", params, bstats)
    want_g = params_from_jax(grads, device="cpu")
    _, want_bs = resnet_variables_from_jax(params, new_bs, device="cpu")
    for r, res in enumerate(per):
        np.testing.assert_allclose(float(res["loss"]), losses[0, r],
                                   rtol=1e-5)
        np.testing.assert_allclose(res["losses"], losses[:, r], rtol=1e-4)
        assert set(res["grads"]) == set(want_g)
        for name, g in want_g.items():
            np.testing.assert_allclose(res["grads"][name], g.numpy(),
                                       atol=5e-3, rtol=1e-2, err_msg=name)
        assert set(res["bstats"]) == set(want_bs)
        for name, v in want_bs.items():
            np.testing.assert_allclose(res["bstats"][name], v.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
    # the synced gradients are every rank's
    for name in want_g:
        np.testing.assert_array_equal(per[0]["grads"][name],
                                      per[1]["grads"][name])


def _port_single_losses(fused, opt_level, params, bstats):
    """Two steps of the port's own undistributed step on the whole batch
    (one process, no process group; the unfused model's BN is then flax's
    ``BatchNorm_0``, one-pass moments, where ``SyncBatchNorm_0`` takes
    two passes)."""
    import torch
    from apex_tpu_torch import models, train
    tp, tbs = resnet_variables_from_jax(params, bstats, device="cpu")
    model = models.ResNet(stage_sizes=[1, 1], num_classes=C.RESNET_CLASSES,
                          width=8, fused_bn=fused, device="cpu",
                          dtype=None if opt_level == "O0" else torch.bfloat16)
    model.load_state_dict({k.replace(".SyncBatchNorm_0.", ".BatchNorm_0."): v
                           for k, v in {**tp, **tbs}.items()})
    step, (state, bs), (x, y), _, _ = train.build_resnet_step(
        C.RESNET_BATCH, C.RESNET_SIZE, opt_level=opt_level, device="cpu",
        model=model)
    losses = []
    for _ in range(2):
        state, bs, loss = step(state, bs, x, y)
        losses.append(loss.item())
    return np.array(losses)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_o2_losses_track_jax_and_the_undistributed_step(results,
                                                        jax_variables, fused):
    """At O2 bf16 the first step's loss is within 1e-2 of the JAX
    configuration-3 step's. Two steps are held against the port's own
    undistributed step on the whole batch (the mean of the ranks' losses,
    within 1e-2). Measured on this model: the port and XLA on the CPU
    round bf16 at other places, so their undistributed steps part by 1.1%
    at the second step with no process group at all (ROADMAP.md, reference
    caveats), and each package's distributed step parts from its own
    undistributed one by 0.7-0.8% there (JAX 1.7877 against 1.8014; the
    combined statistics round otherwise in bf16), so the second step is
    not held against JAX."""
    per = C.ranks(results, f"resnet_{'fused' if fused else 'unfused'}_O2")
    losses, _, _ = _jax_steps(fused, "O2", *jax_variables[fused])
    for r, res in enumerate(per):
        assert res["x"].shape == (C.RESNET_BATCH // WORLD, C.RESNET_SIZE,
                                  C.RESNET_SIZE, 3)
        np.testing.assert_allclose(float(res["loss"]), losses[0, r],
                                   rtol=1e-2)
    single = _port_single_losses(fused, "O2", *jax_variables[fused])
    np.testing.assert_allclose(np.mean([res["losses"] for res in per],
                                       axis=0), single, rtol=1e-2)


def test_unfused_model_names_its_sync_batchnorm_as_flax_does(jax_variables):
    """The unfused model's ``SyncBatchNorm_0`` leaves map one to one onto
    the flax tree's."""
    params, bstats = jax_variables[False]
    tp, tbs = resnet_variables_from_jax(params, bstats, device="cpu")
    model = C._resnet(False, "O0")
    assert set(tp) == {n for n, _ in model.named_parameters()}
    assert set(tbs) == {n for n, _ in model.named_buffers()}
    assert any(".SyncBatchNorm_0." in n for n in tp)
