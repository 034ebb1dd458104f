"""Collective bytes of the data-parallel sync (``monitor.collectives`` over
the port's collective ledger) against the JAX package's, read off its
compiled HLO, on four ranks: four gloo processes for the port, four of the
CPU mesh's devices for the JAX package.

Both count result bytes per rank. Totals by opcode and dtype are equal
where XLA keeps the collective as written: the int8 wire (all-to-all and
all-gather of int8 payloads and f32 scales) and the hierarchical plan's
f32 and int8 hops. XLA on the CPU carries every bf16 all-reduce in f32
(float normalisation), so where a bf16 leaf or a bf16 wire is synced the
JAX package reports twice the bytes; there the test holds the port to the
tree's own byte count and to JAX's f32 count less the doubling. Hop and
axis rows equal the JAX package's. ``module_count_and_host_ops`` on the
CPU: no host sync in a monitored step, one in a step that calls
``.item()``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_parallel_cases as C
from apex_tpu import monitor as jmon
from apex_tpu import parallel as jpar
from apex_tpu.lint.mesh_model import parse_mesh_spec as jparse
from apex_tpu.parallel import hierarchy as jhier
from apex_tpu_torch import monitor as tmon

WORLD = 4
TREE = C.grad_tree()
F32_BYTES = (TREE["a"].size + TREE["b"].size) * 4
BF16_BYTES = TREE["c"].size * 2


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    return C.ranks(C.run(WORLD, ["bytes_ddp"],
                         tmp_path_factory.mktemp("bytes_flat")), "bytes_ddp")


@pytest.fixture(scope="module")
def hier(tmp_path_factory):
    return C.ranks(C.run(WORLD, ["bytes_hier"],
                         tmp_path_factory.mktemp("bytes_hier"),
                         axes=[("data_inter", 2), ("data_intra", 2)]),
                   "bytes_hier")


def _jax_flat(mode):
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    ddp = jpar.DistributedDataParallel(mesh, **C.BYTES_MODES[mode])

    def body(x):
        k = x[0] + 1
        return ddp.sync({
            "a": jnp.asarray(TREE["a"]) * k, "b": jnp.asarray(TREE["b"]) * k,
            "c": jnp.asarray(TREE["c"]).astype(jnp.bfloat16)
            * k.astype(jnp.bfloat16),
            "n": jnp.asarray(TREE["n"])})

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("data"),
                               out_specs=P(), check_vma=False))
    return jmon.wire_report(fn, jnp.arange(float(WORLD)))


def _jax_hier(dtype):
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2),
                ("data_inter", "data_intra"))
    mm = jparse("dp2x2")
    mm.link_bytes_per_s.update(C.HIER_LINKS)
    plan = jhier.plan_comm(mm, 1 << 20, dtypes=(dtype,))
    ddp = jpar.DistributedDataParallel(mesh, comm_plan=plan)

    def body(x):
        s = x[0, 0]
        return ddp.sync({"a": jnp.asarray(TREE["a"]) * (s + 1),
                         "b": jnp.asarray(TREE["b"]),
                         "n": jnp.asarray(TREE["n"])})

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=P("data_inter", "data_intra"),
        out_specs=P(), check_vma=False))
    return jmon.wire_report(fn, jnp.arange(4.0).reshape(2, 2))


def _same_on_every_rank(per, key):
    for r in per[1:]:
        assert r[key] == per[0][key]
    return per[0][key]


@pytest.mark.parametrize("mode", ["flat", "delay", "bucketed"])
def test_exact_modes_against_jax(flat, mode):
    got = _same_on_every_rank(flat, mode)
    rep = got["report"]
    assert rep["by_opcode"] == {"all-reduce": {"f32": F32_BYTES,
                                               "bf16": BF16_BYTES}}
    assert got["bytes"] == got["ddp"] == {
        "all-reduce": F32_BYTES + BF16_BYTES,
        "total": F32_BYTES + BF16_BYTES}
    want = _jax_flat(mode)
    # XLA carries the bf16 leaf's all-reduce in f32
    assert want["by_opcode"] == {"all-reduce": {
        "f32": F32_BYTES + 2 * BF16_BYTES}}
    assert set(rep["by_hop"]) == set(want["by_hop"]) == {"unattributed"}
    assert set(rep["by_axis"]) == set(want["by_axis"]) == {"data"}
    assert rep["wire_bytes"] == sum(sum(v.values())
                                    for v in rep["by_axis"].values())


def test_bf16_wire_against_jax(flat):
    got = _same_on_every_rank(flat, "bf16")
    tree_bytes = (TREE["a"].size + TREE["b"].size + TREE["c"].size) * 2
    assert got["report"]["by_opcode"] == {"all-reduce": {"bf16": tree_bytes}}
    want = _jax_flat("bf16")
    assert want["by_opcode"] == {"all-reduce": {"f32": 2 * tree_bytes}}
    assert got["ddp"]["total"] == tree_bytes


def test_int8_wire_equals_jax(flat):
    got = _same_on_every_rank(flat, "int8")
    want = _jax_flat("int8")
    assert got["report"]["by_opcode"] == want["by_opcode"]
    totals = {op: sum(v.values()) for op, v in want["by_opcode"].items()}
    assert got["bytes"] == dict(totals, total=sum(totals.values()))
    assert got["report"]["by_axis"] == want["by_axis"]


@pytest.mark.parametrize("dtype", ["None", "int8"])
def test_hierarchical_plan_equals_jax(hier, dtype):
    got = _same_on_every_rank(hier, dtype)["report"]
    want = _jax_hier(None if dtype == "None" else dtype)
    for key in ("by_opcode", "by_hop", "by_axis", "wire_bytes"):
        assert got[key] == want[key], key


def test_hierarchical_bf16_plan(hier):
    got = _same_on_every_rank(hier, "bf16")["report"]
    f32 = _same_on_every_rank(hier, "None")["report"]
    want = _jax_hier("bf16")
    # XLA carries the bf16 hops in f32: JAX's rows are the f32 plan's
    assert want["by_opcode"] == f32["by_opcode"]
    for key in ("by_opcode", "by_hop", "by_axis"):
        assert got[key] == {k: {"bf16": sum(v.values()) // 2}
                            for k, v in f32[key].items()}, key


def test_ledger_helpers_on_one_process():
    """No process group needed: a step that issues nothing counts
    nothing; the ledger's keys are the HLO spellings."""
    from apex_tpu_torch.parallel import collectives
    assert tmon.collective_bytes(lambda: None) == {"total": 0}
    assert collectives.OPCODES["send_recv"] == "collective-permute"
    assert set(collectives.OPCODES.values()) <= set(tmon.COLLECTIVE_OPCODES)
    assert set(tmon.COLLECTIVE_OPCODES) <= set(jmon.COLLECTIVE_OPCODES)
    assert collectives.hlo_dtype(torch.int8) == "s8"
    assert tmon.scope_hop("ddp/sync_gradients/bucket03/dcn") == "dcn"
    assert tmon.scope_axis_row("linkbench/all_reduce") == "unknown"
    counts = {("all-reduce", "f32", "ddp/sync_gradients"): 40,
              ("all-gather", "bf16", "bucket00/ici"): 8}
    rep = tmon.wire_report(counts=counts, logical_bytes=96)
    assert rep["wire_to_logical"] == 0.5
    assert rep["by_axis"] == {"data": {"f32": 40},
                              "data_intra": {"bf16": 8}}


def _monitored_step():
    from apex_tpu_torch import amp
    from apex_tpu_torch.monitor import numerics as nx
    from apex_tpu_torch.optim import FusedLAMB
    rng = np.random.RandomState(0)
    params = {"w": torch.tensor(rng.randn(16, 4).astype(np.float32)),
              "b": torch.zeros(4)}
    x = torch.tensor(rng.randn(8, 16).astype(np.float32))
    app, state = amp.initialize(params, FusedLAMB(lr=1e-2,
                                                  strategy="arena"),
                                "O1", verbosity=0, monitor=True)
    cfg = nx.NumericsConfig(check_every=2)
    ns = nx.numerics_init(cfg, sites=app.numerics_sites(state.params),
                          device="cpu")

    def loss_fn(mp):
        return torch.mean(torch.square(x @ mp["w"] + mp["b"]))

    return app, state, ns, cfg, loss_fn


def test_module_count_and_host_ops_on_the_cpu():
    app, state, ns, cfg, loss_fn = _monitored_step()
    for _ in range(3):        # a fold step, an off-step, a fold step
        kernels, host = tmon.module_count_and_host_ops(
            lambda: app.step(state, loss_fn, numerics=(ns, cfg)))
        assert kernels == 0 and host == []
        state, _loss, _fin, ns = app.step(state, loss_fn,
                                          numerics=(ns, cfg))
    _, host = tmon.module_count_and_host_ops(
        lambda: app.step(state, loss_fn)[1].item())
    assert host == ["aten._local_scalar_dense.default"]
    _, host = tmon.module_count_and_host_ops(
        lambda: bool(state.params["w"].sum() > 0))
    assert len(host) == 1
