"""A ZeRO checkpoint the JAX package committed, restored into the port.

The JAX package trains ``DistributedFusedAdam`` and ``DistributedFusedLAMB``
one step under ``shard_map`` on the 8 virtual CPU devices (``mesh8``) over
a small BERT encoder's params (whose leaves the port orders otherwise, so
the buffers are relaid out), and its ``ckpt.CheckpointManager`` commits
``{"params": ..., "opt": state}`` with ``params=`` (the manifest's
``zero`` lengths). ``convert.zero_state_from_jax_checkpoint`` restores
every rank of worlds 1, 2 and 8; the shards, joined and cut to the port
layout's length, equal bit for bit those that ``convert.
zero_state_from_jax`` makes of the in-memory per-device states (rank for
rank at the saved world 8). An ``amp.AmpState`` holding the sharded state
comes across through ``amp_state_from_jax_checkpoint(rank=, world=)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_parallel_cases as C
from apex_tpu import amp as jamp
from apex_tpu import ckpt as jckpt
from apex_tpu import models as jmodels
from apex_tpu.optim import distributed as JD
from apex_tpu_torch import arena as TA
from apex_tpu_torch import convert
from apex_tpu_torch import models as tmodels
from apex_tpu_torch.optim import distributed as TD

OPTS = {"adam": lambda: JD.DistributedFusedAdam(lr=1e-2, weight_decay=0.01),
        "lamb": lambda: JD.DistributedFusedLAMB(lr=1e-3)}


@pytest.fixture(scope="module")
def bert():
    enc = jmodels.BertEncoder(C.ZB_VOCAB, hidden=C.ZB_HIDDEN,
                              layers=C.ZB_LAYERS, heads=C.ZB_HEADS,
                              max_len=C.ZB_SEQ)
    params = enc.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, C.ZB_SEQ), jnp.int32))["params"]
    carried = convert.params_from_jax(params, device="cpu")
    tenc = tmodels.BertEncoder(C.ZB_VOCAB, hidden=C.ZB_HIDDEN,
                               layers=C.ZB_LAYERS, heads=C.ZB_HEADS,
                               max_len=C.ZB_SEQ, device="cpu")
    tp = {n: carried[n] for n, _ in tenc.named_parameters()}
    return params, tp


@pytest.fixture(scope="module", params=sorted(OPTS))
def saved(request, bert, mesh8, tmp_path_factory):
    """(optimizer kind, JAX params, per-device states, checkpoint dir)."""
    params, _ = bert
    opt = OPTS[request.param]()
    rng = np.random.RandomState(1)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.randn(8, *p.shape).astype(np.float32)
                              * 1e-2), params)
    sspec = JD.ShardedOptState(count=P(), slots={
        n: {"float32": P("data")} for n in opt.slot_names})

    def body(p, g):
        g = jax.tree_util.tree_map(lambda x: x[0], g)
        return opt.step(g, opt.init(p), p)

    p1, state = jax.jit(jax.shard_map(
        body, mesh=mesh8, in_specs=(P(), P("data")), out_specs=(P(), sspec),
        check_vma=False))(params, grads)
    root = str(tmp_path_factory.mktemp(f"zero_{request.param}"))
    mgr = jckpt.CheckpointManager(root)
    mgr.save(1, {"params": p1, "opt": state}, params=params, block=True)
    amp_state = jamp.AmpState(step=jnp.asarray(1, jnp.int32), params=p1,
                              opt_state=state, scalers=(None,))
    amp_root = str(tmp_path_factory.mktemp(f"zero_amp_{request.param}"))
    amp_mgr = jckpt.CheckpointManager(amp_root)
    amp_mgr.save(1, amp_state, params=params, block=True)
    host = jax.device_get(state)
    per = host.slots["master"]["float32"].shape[0] // 8
    per_rank = [JD.ShardedOptState(
        count=host.count,
        slots={s: {dt: b[r * per:(r + 1) * per] for dt, b in d.items()}
               for s, d in host.slots.items()}) for r in range(8)]
    return (request.param, params, per_rank, jckpt.latest_checkpoint(root),
            jckpt.latest_checkpoint(amp_root))


def _joined(shards, length):
    return torch.cat(shards)[:length]


@pytest.mark.parametrize("world", [1, 2, 8])
def test_zero_checkpoint_restores_every_rank_bitwise(saved, bert, world):
    kind, params, per_rank, ck, _ = saved
    _, tp = bert
    length = TA.plan(tp).partition("float32").buffer_len
    want = [convert.zero_state_from_jax(per_rank, params, tp, r,
                                        device="cpu") for r in range(8)]
    got = []
    for r in range(world):
        st, manifest = convert.zero_state_from_jax_checkpoint(
            ck, params, tp, r, world, device="cpu", prefix="['opt']")
        got.append(st)
        assert int(st.count) == 1
        per = TD._padded_len(length, world) // world
        assert all(b["float32"].shape == (per,) for b in st.slots.values())
    assert manifest["zero"]
    assert set(got[0].slots) == set(want[0].slots) == set(
        OPTS[kind]().slot_names)
    for slot in want[0].slots:
        w = _joined([s.slots[slot]["float32"] for s in want], length)
        g = _joined([s.slots[slot]["float32"] for s in got], length)
        assert torch.equal(g, w), slot
        if world == 8:
            for r in range(8):
                assert torch.equal(got[r].slots[slot]["float32"],
                                   want[r].slots[slot]["float32"])


@pytest.mark.parametrize("world", [2])
def test_amp_state_with_zero_optimizer_restores(saved, bert, world):
    kind, params, per_rank, _, amp_ck = saved
    _, tp = bert
    length = TA.plan(tp).partition("float32").buffer_len
    with pytest.raises(ValueError, match="world="):
        convert.amp_state_from_jax_checkpoint(amp_ck, tp, device="cpu")
    want = [convert.zero_state_from_jax(per_rank, params, tp, r,
                                        device="cpu") for r in range(8)]
    shards = []
    for r in range(world):
        st, _ = convert.amp_state_from_jax_checkpoint(
            amp_ck, tp, device="cpu", rank=r, world=world)
        assert int(st.step) == 1 and list(st.params) == list(tp)
        assert isinstance(st.opt_state, TD.ShardedOptState)
        shards.append(st.opt_state)
    for slot in want[0].slots:
        assert torch.equal(
            _joined([s.slots[slot]["float32"] for s in shards], length),
            _joined([s.slots[slot]["float32"] for s in want], length))
