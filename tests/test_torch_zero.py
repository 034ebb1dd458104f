"""ZeRO (``optim.DistributedFusedAdam`` / ``DistributedFusedLAMB``) in gloo
ranks against the JAX package's under ``shard_map`` on the virtual CPU
devices.

Four ranks are spawned once, on a 2x2 (``data_inter``, ``data_intra``)
mesh (``tests/_torch_parallel_cases.py``): the world-2 runs go over
``data_intra`` (two independent pairs), the world-4 runs over a flat
``data`` mesh of the four, the axis-tuple run over both axes. The inputs
are the JAX suite's (``tests/test_distributed_optimizers.py``: ~720k
elements in three tensors, keys sorted so both packages lay out the arena
alike, so the master shards compare element for element).

Tolerances are the JAX suite's: Adam 1e-6, LAMB 1e-5, the axis tuple 1e-4
(absolute, params of unit scale), but for the few elements whose mean
gradient cancels inside the rounding of its sum (``_order_band``), where
the two packages' summation orders may flip its sign and Adam's first
steps move such an element by up to 2·lr a step; 2e-2 where a compressed wire (bf16)
carries the params or grads against the uncompressed JAX run. Against the
JAX run with the same compression the port agrees at the uncompressed
tolerance, but for params gathered in bf16, which may be one bf16 ulp
apart where the two f32 masters straddle a rounding boundary. Step counts match exactly. The structural BERT step (O0 f32,
the loss outside ``auto_cast``) holds the JAX package's at 1e-4 on the
loss and 1e-5 on the params, after one LAMB step of lr 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_parallel_cases as C
from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu import optim as joptim
from apex_tpu.optim import distributed as JD
from apex_tpu_torch import arena as TA
from apex_tpu_torch.convert import params_from_jax, zero_state_from_jax
from apex_tpu_torch.optim import distributed as TD

AXES = [("data_inter", 2), ("data_intra", 2)]
NAMES = [n for n in C.CASES if n.startswith("zero_")]
TOL = {"adam": 1e-6, "lamb": 1e-5}


def _bert_params():
    enc = jmodels.BertEncoder(C.ZB_VOCAB, hidden=C.ZB_HIDDEN,
                              layers=C.ZB_LAYERS, heads=C.ZB_HEADS,
                              max_len=C.ZB_SEQ)
    params = enc.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, C.ZB_SEQ), jnp.int32))["params"]
    return enc, params


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    _, params = _bert_params()
    bert = params_from_jax(params, device="cpu")
    return C.run(4, NAMES, tmp_path_factory.mktemp("zero"),
                 inputs={"bert": bert}, axes=AXES)


def _jdtype(name):
    return getattr(jnp, name)


def _jax_run(name, world, exact=False):
    """The JAX package's run of ``ZERO_RUNS[name]`` on ``world`` virtual
    devices (``exact``: without its compressed wire): (params, count,
    slots of every shard stacked)."""
    kind, seed, steps, options = C.ZERO_RUNS[name]
    if exact:
        options = {k: v for k, v in options.items()
                   if not k.endswith("_dtype")}
    params, grads = C.zero_inputs(seed, world)
    kw = {k: (_jdtype(v) if k.endswith("_dtype") else v)
          for k, v in options.items()}
    cls = (JD.DistributedFusedAdam if kind == "adam"
           else JD.DistributedFusedLAMB)
    opt = cls(axis_name="data", **kw)
    gstack = {k: jnp.stack([jnp.asarray(g[k]) for g in grads])
              for k in params}

    def prog(p, g):
        g = jax.tree_util.tree_map(lambda x: x[0], g)
        state = opt.init(p)
        for _ in range(steps):
            p, state = opt.step(g, state, p)
        return p, state.count, {s: state.slots[s]["float32"][None]
                                for s in state.slots}

    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    return jax.jit(jax.shard_map(
        prog, mesh=mesh, in_specs=(P(), P("data")),
        out_specs=(P(), P(), P("data")), check_vma=False))(
        {k: jnp.asarray(v) for k, v in params.items()}, gstack)


def _order_band(seed, world):
    """Per param, the elements whose mean gradient nearly cancels: |mean|
    <= 1e-4 of the largest rank's |g| (in f64). The two packages sum the
    ranks' f32 grads in different orders (gloo's reduce-scatter, XLA's
    psum_scatter), so their means differ by about one ulp of the largest
    term, δ; Adam's direction u = m/(sqrt(v) + eps) moves by about
    eps·δ/mean² for it, which stays far below the tolerance outside the
    band and inside can reach a flipped sign, 2·lr a step."""
    _, grads = C.zero_inputs(seed, world)
    out = {}
    for k in grads[0]:
        g = np.stack([x[k] for x in grads]).astype(np.float64)
        out[k] = np.abs(g.mean(0)) <= 1e-4 * np.abs(g).max(0)
    return out


def _check_run(res, name, want, rank_in_group, world):
    kind, seed, steps, options = C.ZERO_RUNS[name]
    jp, jcount, jslots = want
    tol = TOL[kind]
    band = _order_band(seed, world)
    # a param gathered in bf16 rounds its f32 master: where the two
    # masters (equal to ``tol``) straddle a rounding boundary, the params
    # are one bf16 ulp apart (at most 2**-7 of the value)
    rtol = 2.0 ** -7 if "param_gather_dtype" in options else 0.0
    assert int(res["count"]) == int(jcount) == steps
    lr = options["lr"]
    for k in jp:
        got, exp = res["params"][k], np.asarray(jp[k])
        np.testing.assert_allclose(got[~band[k]], exp[~band[k]], atol=tol,
                                   rtol=rtol, err_msg=f"{name} {k}")
        np.testing.assert_allclose(got[band[k]], exp[band[k]],
                                   atol=2 * lr * steps, err_msg=f"{name} {k}")
    # the slots of this rank's shard, the band's moments left out
    spec = TA.plan({k: torch.zeros(b.shape) for k, b in band.items()})
    flat = TA.flatten({k: torch.tensor(b) for k, b in band.items()}, spec,
                      cast=torch.float32)["float32"].numpy() > 0
    per = TD._padded_len(flat.size, world) // world
    keep = ~np.pad(flat, (0, per * world - flat.size))[
        rank_in_group * per:(rank_in_group + 1) * per]
    for s, buf in res["slots"].items():
        np.testing.assert_allclose(
            buf[keep], np.asarray(jslots[s][rank_in_group])[keep], atol=tol,
            rtol=tol, err_msg=f"{name} {s}")


@pytest.mark.parametrize("name", list(C.ZERO_RUNS))
def test_world2_matches_jax(results, name):
    want = _jax_run(name, 2)
    for r, res in enumerate(C.ranks(results, "zero_world2")):
        _check_run(res[name], name, want, r % 2, 2)


@pytest.mark.parametrize("name", C.ZERO_RUNS_W4)
def test_world4_matches_jax(results, name):
    want = _jax_run(name, 4)
    for r, res in enumerate(C.ranks(results, "zero_world4")):
        _check_run(res[name], name, want, r, 4)


@pytest.mark.parametrize("name", [n for n in C.ZERO_RUNS
                                  if "bf16" in n])
def test_compressed_wire_stays_near_the_exact_run(results, name):
    """The JAX suite's bound for a compressed gather (2e-2 abs, 1e-2 rel)
    against the JAX run without compression; the params keep their f32
    dtype."""
    jp, _, _ = _jax_run(name, 2, exact=True)
    for res in C.ranks(results, "zero_world2"):
        for k in jp:
            got = res[name]["params"][k]
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, np.asarray(jp[k]), atol=2e-2,
                                       rtol=1e-2, err_msg=k)


def test_collectives_of_a_step_by_scope(results):
    """Adam without clip: one scatter and one gather a step; LAMB with the
    clip: one scatter, three norm sums (the clip's and the two per-tensor
    ones) and one gather."""
    for res in C.ranks(results, "zero_world2"):
        assert res["adam"]["collectives"] == {
            "zero/grad_scatter": 3, "zero/param_gather": 3}
        assert res["lamb"]["collectives"] == {
            "zero/grad_scatter": 3, "zero/grad_norm": 9,
            "zero/param_gather": 3}


def test_axis_tuple_rank_owns_its_tile_and_matches_jax(results):
    """Over ("data_inter", "data_intra") global rank g is linear rank g
    (``init_device_mesh`` is row-major) and owns tile g of the padded
    arena; one step equals JAX's on a 2x2 mesh (1e-4: the two-stage
    reduction reorders the sum)."""
    params, grads = C.zero_inputs(3, 4)
    spec = TA.plan({k: torch.tensor(v) for k, v in params.items()})
    full = TA.flatten({k: torch.tensor(v) for k, v in params.items()},
                      spec)["float32"].numpy()
    per = TD._padded_len(full.shape[0], 4) // 4
    full = np.pad(full, (0, 4 * per - full.shape[0]))
    axes = ("data_inter", "data_intra")
    opt = JD.DistributedFusedAdam(lr=1e-2, axis_name=axes)
    gstack = {k: jnp.stack([jnp.asarray(g[k]) for g in grads]).reshape(
        2, 2, *params[k].shape) for k in params}

    def prog(p, g):
        g = jax.tree_util.tree_map(lambda x: x[0, 0], g)
        return opt.step(g, opt.init(p), p)[0]

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), axes)
    want = jax.jit(jax.shard_map(
        prog, mesh=mesh, in_specs=(P(), P(*axes)), out_specs=P(),
        check_vma=False))({k: jnp.asarray(v) for k, v in params.items()},
                          gstack)
    for g, res in enumerate(C.ranks(results, "zero_axis_tuple")):
        assert (res["global_rank"], res["linear_rank"], res["world"]) == \
            (g, g, 4)
        np.testing.assert_array_equal(res["shard0"],
                                      full[g * per:(g + 1) * per])
        for k in want:
            np.testing.assert_allclose(res["params"][k],
                                       np.asarray(want[k]), atol=1e-4,
                                       err_msg=k)


def test_skip_decision_state_bytes_and_layout(results):
    params, _ = C.zero_inputs(5, 2)
    jopt = JD.DistributedFusedLAMB(lr=1e-2)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for res in C.ranks(results, "zero_skip_and_layout"):
        assert res["skip_same"]
        assert (int(res["skip_step"]), int(res["skip_count"])) == (0, 0)
        assert (int(res["step_step"]), int(res["step_count"])) == (1, 1)
        for w, got in res["state_bytes"].items():
            assert got == jopt.state_bytes(jparams, world=w), w
        assert res["layout"] == jopt.checkpoint_layout(jparams)


def test_bert_o0_step_matches_jax(results):
    enc, params = _bert_params()
    toks, labels = C.zero_bert_batch(2)
    japp = jamp.Amp(jamp.Policy.from_opt_level("O0"),
                    JD.DistributedFusedLAMB(lr=1e-3))

    def prog(p, tk, lb):
        state = japp.init(p)
        loss, grads, state, finite = japp.backward(
            state, lambda mp: jmodels.mlm_loss(enc, {"params": mp}, tk, lb))
        state = japp.apply_gradients(state, grads, finite)
        return state.params, loss[None], state.opt_state.count

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    jp, jloss, jcount = jax.jit(jax.shard_map(
        prog, mesh=mesh, in_specs=(P(), P("data"), P("data")),
        out_specs=(P(), P("data"), P()), check_vma=False))(
        params, jnp.asarray(toks, jnp.int32), jnp.asarray(labels, jnp.int32))
    want = params_from_jax(jax.device_get(jp), device="cpu")
    for r, res in enumerate(C.ranks(results, "zero_bert_o0")):
        assert int(res["count"]) == int(jcount) == 1
        np.testing.assert_allclose(float(res["loss"]),
                                   float(np.asarray(jloss)[r % 2]),
                                   rtol=1e-4)
        for k, w in want.items():
            np.testing.assert_allclose(res["params"][k], w.numpy(),
                                       atol=1e-5, err_msg=k)


def test_bert_main_path_equals_the_arena_step(results):
    """``build_bert_step(optimizer=DistributedFusedLAMB(lr=1e-3))`` on two
    ranks with the same batch: the mean of equal grads is the grads, so
    the losses and params equal the arena ``FusedLAMB``'s (1e-5; the
    reduce-scatter divides by 2 after summing two equal values, exact in
    f32), with 5 collectives a step (scatter, clip sum, two per-tensor
    sums, gather)."""
    for res in C.ranks(results, "zero_bert_main_path"):
        z, a = res["zero"], res["arena"]
        assert int(z["step"]) == int(a["step"]) == 2
        np.testing.assert_allclose(z["losses"], a["losses"], rtol=1e-5)
        for k in a["params"]:
            np.testing.assert_allclose(z["params"][k], a["params"][k],
                                       atol=1e-5, err_msg=k)
        assert z["collectives"] == {"zero/grad_scatter": 1,
                                    "zero/grad_norm": 3,
                                    "zero/param_gather": 1}
        assert a["collectives"] == {}


def test_zero_state_from_jax_round_trips():
    """A JAX ZeRO state after one step, carried to the port per rank,
    equals the port's own state after the same step (the arena layouts
    match for sorted keys; for the BERT tree the port's order differs and
    the shards are re-laid out)."""
    params, grads = C.zero_inputs(8, 2)
    opt = JD.DistributedFusedAdam(lr=1e-2)
    gstack = {k: jnp.stack([jnp.asarray(g[k]) for g in grads])
              for k in params}

    def prog(p, g):
        g = jax.tree_util.tree_map(lambda x: x[0], g)
        st = opt.init(p)
        return jax.tree_util.tree_map(lambda x: x[None],
                                      opt.step(g, st, p)[1])

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    jstate = jax.jit(jax.shard_map(
        prog, mesh=mesh, in_specs=(P(), P("data")), out_specs=P("data"),
        check_vma=False))({k: jnp.asarray(v) for k, v in params.items()},
                          gstack)
    jstate = jax.device_get(jstate)
    per_rank = [JD.ShardedOptState(
        count=jstate.count[r],
        slots={s: {dt: b[r] for dt, b in d.items()}
               for s, d in jstate.slots.items()}) for r in range(2)]
    tp = {k: torch.tensor(v) for k, v in params.items()}
    for r in range(2):
        ts = zero_state_from_jax(per_rank, params, tp, r, device="cpu")
        assert int(ts.count) == 1
        for s in ("master", "m", "v"):
            np.testing.assert_array_equal(
                ts.slots[s]["float32"].numpy(),
                np.asarray(per_rank[r].slots[s]["float32"]))


def test_zero_state_from_jax_relays_a_bert_tree():
    """BERT's leaves come in another order in the port: the carried shards
    hold, per tensor, the JAX state's values (and the master equals the
    carried params)."""
    _, params = _bert_params()
    order = list(params_from_jax(params, device="cpu"))
    from apex_tpu_torch import models as tmodels
    tenc = tmodels.BertEncoder(C.ZB_VOCAB, hidden=C.ZB_HIDDEN,
                               layers=C.ZB_LAYERS, heads=C.ZB_HEADS,
                               max_len=C.ZB_SEQ, device="cpu")
    carried = params_from_jax(params, device="cpu")
    tp = {n: carried[n] for n, _ in tenc.named_parameters()}
    assert set(tp) == set(order)
    opt = JD.DistributedFusedAdam(lr=1e-2)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    jstate = jax.device_get(jax.jit(jax.shard_map(
        lambda p: jax.tree_util.tree_map(lambda x: x[None], opt.init(p)),
        mesh=mesh, in_specs=P(), out_specs=P("data"),
        check_vma=False))(params))
    per_rank = [JD.ShardedOptState(
        count=jstate.count[r],
        slots={s: {dt: b[r] for dt, b in d.items()}
               for s, d in jstate.slots.items()}) for r in range(2)]
    spec = TA.plan(tp)
    buf = TA.flatten(tp, spec, cast=torch.float32)["float32"]
    per = TD._padded_len(buf.numel(), 2) // 2
    buf = torch.nn.functional.pad(buf, (0, 2 * per - buf.numel()))
    for r in range(2):
        ts = zero_state_from_jax(per_rank, params, tp, r, device="cpu")
        assert torch.equal(ts.slots["master"]["float32"],
                           buf[r * per:(r + 1) * per])
        assert not ts.slots["m"]["float32"].any()


def test_padded_len_and_shard_align_equal_jax():
    assert TD._SHARD_ALIGN == JD._SHARD_ALIGN == 65536
    for n in (1, 65536, 65537, 720_000, 335_000_000):
        for w in (1, 2, 3, 8):
            assert TD._padded_len(n, w) == JD._padded_len(n, w)


def test_chip_smoke_zero_rows_and_gates():
    """``chip_smoke.py``'s rows for the ZeRO and ring paths name the TPU
    kernel their kernel replaces and take their launches from their phase;
    its per-step collective gate of ``bert_large_zero`` is what the CPU
    main-path test counts."""
    import chip_smoke
    assert set(chip_smoke.EXTRA_ZERO_ROWS) == {
        "lamb_shard_stage1", "lamb_shard_stage2", "adam_e5m2_copy",
        "flash_ring_hop_fwd", "flash_ring_hop_bwd"}
    for name, (kernel, where, _) in chip_smoke.EXTRA_ZERO_ROWS.items():
        assert where == chip_smoke.REPLACES[kernel], name
        assert kernel in chip_smoke.SOURCES, name
    rows = {n: {"launches": 0} for n in chip_smoke.EXTRA_ZERO_ROWS}
    rows.update(lamb_stage1={"launches": 5}, lamb_stage2={"launches": 5})
    chip_smoke.take_phase_launches("bert_large_zero", rows)
    assert rows["lamb_shard_stage1"]["launches"] == 5
    assert rows["lamb_shard_stage2"]["launches"] == 5
    assert rows["adam_e5m2_copy"]["launches"] == 0
    assert chip_smoke.ZERO_COLLECTIVES == {
        "zero/grad_scatter": 1, "zero/grad_norm": 3, "zero/param_gather": 1}
    assert chip_smoke.ZERO_PER_STEP == {"multi_tensor_l2norm": 1,
                                        "lamb_stage1": 1, "lamb_stage2": 1}


def test_e5m2_copy_past_the_largest_finite_value_matches_jax():
    """ZeRO's e5m2 gather starts from the copy-out of ``adam`` and
    ``lamb_stage2``: above e5m2's largest finite value (57344) the port's
    plain versions round as the JAX package's kernels (interpret mode)
    do, |p| >= 61440 to ±inf, bit for bit (the CUDA-side kernels write the
    same bytes; ``chip_smoke.py`` row ``adam_e5m2_copy`` holds them)."""
    from apex_tpu.ops import optim_kernels as JK
    from apex_tpu_torch.ops import optim_kernels as TK
    n = 65536
    p = np.random.RandomState(9).randn(n).astype(np.float32)
    p[:9] = [57344.0, 59000.0, 61439.0, 61440.0, 61441.0, 1e6, -61440.0,
             -1e6, 3.0]
    z = np.zeros(n, np.float32)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0,
              step=1)
    want = JK.adam_update(jnp.asarray(p), jnp.asarray(z), jnp.asarray(z),
                          jnp.asarray(z), param_copy_dtype=jnp.float8_e5m2,
                          **kw)[3]
    got = TK.adam_update(torch.tensor(p), torch.tensor(z), torch.tensor(z),
                         torch.tensor(z),
                         param_copy_dtype=torch.float8_e5m2, **kw)[3]
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  np.asarray(want).view(np.uint8))
    assert got.view(torch.uint8)[:8].tolist() == [123, 123, 123, 124, 124,
                                                  124, 252, 252]
    ones = np.ones(n, np.float32)
    want = JK.lamb_stage2(jnp.asarray(p), jnp.asarray(z), jnp.asarray(ones),
                          lr=1e-3, param_copy_dtype=jnp.float8_e5m2)[1]
    got = TK.lamb_stage2(torch.tensor(p), torch.tensor(z),
                         torch.tensor(ones), lr=1e-3,
                         param_copy_dtype=torch.float8_e5m2)[1]
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  np.asarray(want).view(np.uint8))
