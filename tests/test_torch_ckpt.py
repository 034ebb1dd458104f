"""The port's checkpoints (``apex_tpu_torch.ckpt``) against the JAX package's.

- Round trip through ``CheckpointManager``: f32, bf16, fp16, fp8 (e4m3,
  e5m2), int32, int64 and bool leaves, 0-d and empty leaves, a
  ``torch.Generator``, bit for bit; mismatched like-trees refused.
- Both directions across the packages: a checkpoint the JAX package's
  ``CheckpointManager`` wrote from a tiny BERT ``AmpState`` with arena
  ``FusedLAMB`` state, restored through
  ``convert.amp_state_from_jax_checkpoint``, equals
  ``convert.amp_state_from_jax`` of the in-memory state bit for bit; a
  checkpoint the port wrote reads back through the JAX package's
  ``read_manifest``/``assemble_arrays`` (and its ``restore``) to the same
  arrays, bf16 and fp8 included.
- Crash points: a subprocess killed before the data rename and before the
  manifest leaves the previous checkpoint the latest and loadable.
- Retention: ``keep`` and the in-use markers.
- ZeRO: ``repartition_flat`` and ``zero_layout`` against the JAX
  package's, and a world-2 save restored at world 1.
- Escalation: ``mode="raise"`` raises ``PreemptionError`` with a loadable
  checkpoint; ``mode="exit"`` (in a subprocess) exits 75 with one.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import ckpt as jckpt
from apex_tpu import models as jmodels
from apex_tpu.ckpt import elastic as jelastic
from apex_tpu.ckpt import format as jformat
from apex_tpu.optim import FusedLAMB as JLAMB
from apex_tpu.optim.distributed import ShardedOptState as JShardedOptState
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import arena as tarena
from apex_tpu_torch import ckpt as tckpt
from apex_tpu_torch import convert
from apex_tpu_torch import models as tmodels
from apex_tpu_torch.ckpt import elastic as telastic
from apex_tpu_torch.ckpt import format as tformat
from apex_tpu_torch.optim import FusedLAMB as TLAMB
from apex_tpu_torch.optim.distributed import ShardedOptState, _padded_len

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mixed_tree(seed=0):
    rng = np.random.RandomState(seed)
    f = rng.randn(5, 3).astype(np.float32)
    return {
        "f32": torch.tensor(f),
        "bf16": torch.tensor(rng.randn(7)).to(torch.bfloat16),
        "f16": torch.tensor(rng.randn(2, 2)).to(torch.float16),
        "e4m3": torch.tensor(rng.randn(6)).to(torch.float8_e4m3fn),
        "e5m2": torch.tensor(rng.randn(6)).to(torch.float8_e5m2),
        "i32": torch.tensor(rng.randint(-9, 9, (4,)), dtype=torch.int32),
        "i64": torch.tensor([2 ** 40, -3], dtype=torch.int64),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(3, dtype=torch.int32),
        "empty": torch.zeros((0, 3)),
        "nested": ({"x": torch.tensor(f[0])}, None),
    }


def _like(tree):
    return {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor)
                else ({"x": torch.zeros_like(v[0]["x"])}, None))
            for k, v in tree.items()}


def _bits(t):
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(view[t.dtype.itemsize]).numpy()


def _assert_bitwise(got, want):
    for (pg, g), (pw, w) in zip(tckpt.tree_paths(got),
                                tckpt.tree_paths(want)):
        assert pg == pw
        assert g.dtype == w.dtype and g.shape == w.shape, pg
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=pg)


def test_roundtrip_mixed_dtypes_and_generator(tmp_path):
    tree = _mixed_tree()
    gen = torch.Generator().manual_seed(11)
    torch.rand(3, generator=gen)
    tree["gen"] = gen
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    stall = mgr.save(3, tree, extra={"cursor": {"epoch": 1, "batch": 2}})
    mgr.wait()
    assert stall >= 0.0
    like = _like({k: v for k, v in tree.items() if k != "gen"})
    like["gen"] = torch.Generator().manual_seed(99)
    got, manifest = mgr.restore(like)
    assert got["gen"] is like["gen"]
    assert torch.equal(torch.rand(4, generator=got["gen"]),
                       torch.rand(4, generator=gen))
    _assert_bitwise({k: v for k, v in got.items() if k != "gen"},
                    {k: v for k, v in tree.items() if k != "gen"})
    assert manifest["step"] == 3 and manifest["format"] == 1
    assert manifest["extra"] == {"cursor": {"epoch": 1, "batch": 2}}
    assert manifest["prng_impls"] == {"['gen']": "torch.Generator"}
    dtypes = {a["path"]: a["dtype"] for a in manifest["files"][0]["arrays"]}
    assert dtypes["['bf16']"] == "bfloat16"
    assert dtypes["['e4m3']"] == "float8_e4m3fn"
    assert dtypes["['e5m2']"] == "float8_e5m2"


def test_restore_refuses_mismatches(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(3)}, block=True)
    with pytest.raises(tckpt.CheckpointError, match="shape mismatch"):
        mgr.restore({"w": torch.ones(4)})
    with pytest.raises(tckpt.CheckpointError, match="dtype mismatch"):
        mgr.restore({"w": torch.ones(3, dtype=torch.float16)})
    with pytest.raises(tckpt.CheckpointError, match="missing"):
        mgr.restore({"v": torch.ones(3)})
    with pytest.raises(tckpt.CheckpointError, match="Generator"):
        mgr.restore({"w": torch.Generator()})
    empty = tckpt.CheckpointManager(str(tmp_path / "none"))
    with pytest.raises(tckpt.CheckpointError, match="nothing"):
        empty.restore({"w": torch.ones(3)})


def test_hash_mismatch_is_refused(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(64)}, block=True)
    path = os.path.join(tmp_path, "step_00000001", "proc00000.npz")
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 2)
    with pytest.raises(tckpt.CheckpointError, match="hash"):
        mgr.restore({"w": torch.ones(64)})


# --- across the packages ------------------------------------------------------

VOCAB, HIDDEN, LAYERS, HEADS, SEQ = 1000, 64, 2, 2, 32


def _jax_amp_state():
    """A tiny BERT's JAX AmpState (O1 bf16, arena FusedLAMB) after one
    update with seeded gradients, and the port's params in its order."""
    jenc = jmodels.BertEncoder(VOCAB, hidden=HIDDEN, layers=LAYERS,
                               heads=HEADS, max_len=SEQ)
    params = jenc.init(jax.random.PRNGKey(0),
                       jnp.zeros((1, SEQ), jnp.int32))["params"]
    japp = jamp.Amp(jamp.Policy.from_opt_level("O1"),
                    JLAMB(lr=1e-3, strategy="arena"))
    jstate = japp.init(params)
    rng = np.random.RandomState(5)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)),
        params)
    jstate = japp.apply_gradients(jstate, grads, jnp.bool_(True))
    tenc = tmodels.BertEncoder(VOCAB, hidden=HIDDEN, layers=LAYERS,
                               heads=HEADS, max_len=SEQ, device="cpu")
    return jstate, dict(tenc.named_parameters())


def test_jax_written_checkpoint_restores_through_convert(tmp_path):
    jstate, port_params = _jax_amp_state()
    jmgr = jckpt.CheckpointManager(str(tmp_path), keep=1)
    jmgr.save(1, {"amp": jstate}, extra={"cursor": {"epoch": 0,
                                                    "batch": 1}},
              block=True)
    got, manifest = convert.amp_state_from_jax_checkpoint(
        jmgr.latest(), port_params, device="cpu", prefix="['amp']")
    want = convert.amp_state_from_jax(jax.device_get(jstate), port_params,
                                      device="cpu")
    assert manifest["extra"]["cursor"] == {"epoch": 0, "batch": 1}
    assert int(got.step) == int(want.step) == 1
    assert got.scalers == want.scalers == (None,)
    assert list(got.params) == list(port_params)
    for k in port_params:
        assert torch.equal(got.params[k], want.params[k]), k
    assert int(got.opt_state.count) == int(want.opt_state.count) == 1
    for slot, bufs in want.opt_state.slots.items():
        for dt, buf in bufs.items():
            assert torch.equal(got.opt_state.slots[slot][dt], buf), slot
    # and it trains on in the port
    tapp = tamp.Amp(tamp.Policy.from_opt_level("O1"),
                    TLAMB(lr=1e-3, strategy="arena"))
    g = {k: torch.full_like(v, 1e-3) for k, v in got.params.items()}
    nxt = tapp.apply_gradients(got, g, True)
    assert int(nxt.step) == 2


def test_port_written_checkpoint_reads_in_jax(tmp_path):
    tree = _mixed_tree(seed=1)
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(7, tree, block=True)
    d = mgr.latest()
    manifest = jformat.read_manifest(d)
    arrays = jformat.assemble_arrays(d, manifest)
    assert manifest["format"] == jformat.FORMAT_VERSION
    for path, t in tckpt.tree_paths(tree):
        a = arrays[path]
        assert tuple(a.shape) == tuple(t.shape), path
        if t.dtype == torch.bfloat16:
            assert a.dtype == ml_dtypes.bfloat16
        if t.dtype == torch.float8_e4m3fn:
            assert a.dtype == ml_dtypes.float8_e4m3fn
        if t.dtype == torch.float8_e5m2:
            assert a.dtype == ml_dtypes.float8_e5m2
        np.testing.assert_array_equal(
            np.ascontiguousarray(a).view(_bits(t).dtype).reshape(
                _bits(t).shape), _bits(t), err_msg=path)
    # the JAX package's restore takes it into a JAX tree of the same paths
    jlike = {"f32": jnp.zeros((5, 3)), "bf16": jnp.zeros(7, jnp.bfloat16)}
    part = {k: tree[k] for k in jlike}
    pmgr = tckpt.CheckpointManager(str(tmp_path / "part"))
    pmgr.save(1, part, block=True)
    jgot, _ = jckpt.CheckpointManager(str(tmp_path / "part")).restore(jlike)
    np.testing.assert_array_equal(np.asarray(jgot["f32"]),
                                  part["f32"].numpy())
    np.testing.assert_array_equal(
        np.asarray(jgot["bf16"]).view(np.int16), _bits(part["bf16"]))


# --- crash points -------------------------------------------------------------

_CRASH_SCRIPT = textwrap.dedent("""
    import sys, torch
    sys.path.insert(0, {root!r})
    from apex_tpu_torch import ckpt
    mgr = ckpt.CheckpointManager({d!r}, keep=3)
    mgr.save({step}, {{"w": torch.full((256,), float({step}))}}, block=True)
    mgr.wait()
""")


def _save_in_subprocess(d, step, crash=None):
    env = dict(os.environ)
    env.pop(tformat._CRASH_ENV, None)
    if crash:
        env[tformat._CRASH_ENV] = crash
    return subprocess.run(
        [sys.executable, "-c", _CRASH_SCRIPT.format(root=ROOT, d=d,
                                                    step=step)],
        env=env, capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("point", ["before_data_rename", "before_manifest"])
def test_crash_point_leaves_previous_checkpoint_loadable(tmp_path, point):
    d = str(tmp_path)
    assert _save_in_subprocess(d, 1).returncode == 0
    res = _save_in_subprocess(d, 2, crash=point)
    assert res.returncode == -9, res.stderr          # SIGKILL, no cleanup
    assert os.path.isdir(os.path.join(d, "step_00000002"))
    assert tformat.committed_steps(d) == [1]
    mgr = tckpt.CheckpointManager(d)
    got, manifest = mgr.restore({"w": torch.zeros(256)})
    assert manifest["step"] == 1 and torch.all(got["w"] == 1.0)


# --- retention ----------------------------------------------------------------

def test_keep_and_inuse_markers(tmp_path):
    d = str(tmp_path)
    mgr = tckpt.CheckpointManager(d, keep=2)
    for s in range(1, 5):
        mgr.save(s, {"w": torch.full((4,), float(s))}, block=True)
    assert mgr.all_steps() == [3, 4]
    pinned = tformat.step_dir(d, 3)
    with tformat.checkpoint_in_use(pinned, rank=0, refresh_s=0):
        assert tformat.checkpoint_is_in_use(pinned)
        mgr.save(5, {"w": torch.full((4,), 5.0)}, block=True)
        assert mgr.all_steps() == [3, 4, 5]          # 3 pinned, kept
    assert not tformat.checkpoint_is_in_use(pinned)
    assert tformat.gc_checkpoints(d, keep=2) == [pinned]
    assert mgr.all_steps() == [4, 5]
    # the JAX package's retention reads the port's tree the same way
    assert jformat.committed_steps(d) == [4, 5]


# --- ZeRO ---------------------------------------------------------------------

def test_repartition_flat_matches_jax():
    rng = np.random.RandomState(2)
    buf = rng.randn(300).astype(np.float32)
    buf[250:] = 0.0
    for logical, total in ((250, 250), (250, 300), (250, 512)):
        want = jelastic.repartition_flat(buf, logical, total)
        got = telastic.repartition_flat(torch.tensor(buf), logical, total)
        np.testing.assert_array_equal(got.numpy(), want)
    for bad in ((400, 512), (250, 100)):
        with pytest.raises(ValueError):
            telastic.repartition_flat(torch.tensor(buf), *bad)
        with pytest.raises(ValueError):
            jelastic.repartition_flat(buf, *bad)


def _zero_state(params, world, rank, seed=0):
    spec = tarena.plan(params)
    rng = np.random.RandomState(seed)
    slots = {s: {} for s in ("master", "m", "v")}
    full = {}
    for part in spec.partitions:
        total = _padded_len(part.buffer_len, world)
        per = total // world
        for s in slots:
            buf = np.zeros(total, np.float32)
            buf[:part.buffer_len] = rng.randn(part.buffer_len)
            full[(s, part.dtype)] = buf
            slots[s][part.dtype] = torch.tensor(
                buf[rank * per:(rank + 1) * per])
    return ShardedOptState(count=torch.tensor(3, dtype=torch.int32),
                           slots=slots), full, spec


def test_zero_layout_matches_jax():
    params = {"a": torch.zeros(300, 7), "b": torch.zeros(11)}
    sos, _, spec = _zero_state(params, 2, 0)
    state = tamp.AmpState(step=torch.tensor(0), params=params,
                          opt_state=sos, scalers=(None,))
    got = telastic.zero_layout(state, params=params)
    jp = {k: jnp.zeros(tuple(v.shape)) for k, v in params.items()}
    jsos = JShardedOptState(count=jnp.int32(3), slots={
        s: {dt: jnp.asarray(b.numpy()) for dt, b in d.items()}
        for s, d in sos.slots.items()})
    jstate = jamp.AmpState(step=jnp.int32(0), params=jp, opt_state=jsos,
                           scalers=(None,))
    want = jelastic.zero_layout(jstate, params=jp)
    assert got == want
    assert telastic.partition_lengths(spec) == jelastic.partition_lengths(
        __import__("apex_tpu").arena.plan(jp))
    assert telastic.zero_layout({"x": torch.ones(2)}) == {}
    with pytest.raises(ValueError, match="params="):
        telastic.zero_layout(state)


def test_zero_world2_save_restores_at_world1(tmp_path):
    """Two ranks each write their shards (rank 1 first; rank 0 commits the
    manifest); one process restores at world 1: every slot equals the
    logical buffer, zero-padded to the world-1 length."""
    params = {"a": torch.zeros(300, 7), "b": torch.zeros(11)}
    d = str(tmp_path)
    full = None
    for rank in (1, 0):
        sos, full, spec = _zero_state(params, 2, rank)
        mgr = tckpt.CheckpointManager(d, rank=rank, process_count=2)
        mgr.save(4, {"opt": sos}, params=params, block=True)
    manifest = tformat.read_manifest(tformat.latest_checkpoint(d))
    assert manifest["zero"] and manifest["process_count"] == 2
    like, _, _ = _zero_state(params, 1, 0)
    got, _ = tckpt.CheckpointManager(d, rank=0, process_count=1).restore(
        {"opt": like})
    for (s, dt), buf in full.items():
        n = spec.partition(dt).buffer_len
        out = got["opt"].slots[s][dt].numpy()
        assert out.shape == (_padded_len(n, 1),)
        np.testing.assert_array_equal(out[:n], buf[:n])
        assert not out[n:].any()
    # the JAX package gathers the same global buffers from the port's files
    jarr = jformat.assemble_arrays(tformat.latest_checkpoint(d), manifest)
    for (s, dt), buf in full.items():
        np.testing.assert_array_equal(jarr[f"['opt'].slots['{s}']['{dt}']"],
                                      buf)


def test_zero_layout_cache_keeps_no_params_alive(tmp_path):
    """The manager caches the ZeRO layout by the params' names, shapes and
    dtypes: a params tree the step has replaced is freed (on the card it
    held BERT-Large's 1.34 GB of params for the manager's lifetime), the
    layout is reused for a like tree, and planned again for a new shape."""
    import gc
    import weakref
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=1)
    params = {"a": torch.zeros(300, 7), "b": torch.zeros(11)}
    sos, _, _ = _zero_state(params, 1, 0)
    mgr.save(1, {"opt": sos}, params=params, block=True)
    first = mgr._zero_cache[1]
    gone = weakref.ref(params["a"])
    params = {"a": torch.ones(300, 7), "b": torch.ones(11)}
    gc.collect()
    assert gone() is None
    mgr.save(2, {"opt": sos}, params=params, block=True)
    assert mgr._zero_cache[1] is first
    wider = {"a": torch.zeros(300, 300), "b": torch.zeros(11)}
    wsos, _, _ = _zero_state(wider, 1, 0)
    mgr.save(3, {"opt": wsos}, params=wider, block=True)
    assert mgr._zero_cache[1] == telastic.zero_layout({"opt": wsos},
                                                      params=wider)
    assert mgr._zero_cache[1] != first
    manifest = tformat.read_manifest(tformat.latest_checkpoint(
        str(tmp_path)))
    assert manifest["zero"] == mgr._zero_cache[1]


# --- escalation ---------------------------------------------------------------

def test_escalation_raise_mode_commits_last_snapshot(tmp_path):
    events = []
    mgr = tckpt.CheckpointManager(str(tmp_path), event_sink=events.append)
    pol = tckpt.EscalationPolicy(mgr, mode="raise")
    mgr.snapshot(5, {"w": torch.full((8,), 5.0)})      # capture only
    mgr.wait()
    assert mgr.all_steps() == []
    with pytest.raises(tckpt.PreemptionError) as info:
        pol.trip("test")
    assert info.value.ckpt_path == tformat.step_dir(str(tmp_path), 5)
    got, manifest = mgr.restore({"w": torch.zeros(8)})
    assert manifest["step"] == 5 and manifest["meta"]["reason"] == "test"
    assert pol.tripped == "test"
    kinds = [e["kind"] for e in events]
    assert kinds == ["ckpt_save", "ckpt_escalation", "ckpt_restore"]
    assert pol.on_preempt() == tformat.step_dir(str(tmp_path), 5)
    with pytest.raises(ValueError):
        tckpt.EscalationPolicy(mgr, mode="hang")


def test_escalation_exit_mode_exits_75_with_a_checkpoint(tmp_path):
    script = textwrap.dedent(f"""
        import sys, torch
        sys.path.insert(0, {ROOT!r})
        from apex_tpu_torch import ckpt
        mgr = ckpt.CheckpointManager({str(tmp_path)!r})
        mgr.snapshot(9, {{"w": torch.full((8,), 9.0)}})
        mgr.wait()
        ckpt.EscalationPolicy(mgr).trip("stall")
        print("not reached")
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == tckpt.ESCALATION_EXIT_CODE == 75, res.stderr
    assert "not reached" not in res.stdout
    got, manifest = tckpt.CheckpointManager(str(tmp_path)).restore(
        {"w": torch.zeros(8)})
    assert manifest["step"] == 9 and torch.all(got["w"] == 9.0)
    with open(os.path.join(tformat.step_dir(str(tmp_path), 9),
                           "manifest.json")) as f:
        assert json.load(f)["meta"]["reason"] == "stall"
