"""The port's FLOP counter, profile_step, module annotation and CLI on the CPU.

Held against apex_tpu.prof: a matmul's FLOPs equal XLA's cost analysis
(2·M·N·K); ``annotate_modules`` on a depth-2 BERT records the calls flax's
interceptor records (module paths, one call each, argument shapes). A
depth-2 BERT training step's FLOPs equal the analytic count exactly, with
flash attention counted by the kernel cost registry and its plain
version's matmuls hidden. ``profile_step`` on the CPU reports no MFU and
removes its temp dir; the CLI on an empty directory exits 1.
"""

import collections
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

from apex_tpu import models as jmodels
from apex_tpu import prof as jprof
from apex_tpu_torch import models as tmodels
from apex_tpu_torch import prof as tprof
from apex_tpu_torch import train
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.prof import cost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, HIDDEN, LAYERS, HEADS, SEQ, BATCH = 1000, 128, 2, 2, 64, 2


def test_matmul_flops_equal_xla_cost_analysis():
    rng = np.random.RandomState(0)
    a, b = rng.randn(64, 32).astype(np.float32), \
        rng.randn(32, 48).astype(np.float32)
    want = jprof.cost_analysis(jnp.dot, jnp.asarray(a), jnp.asarray(b))
    got = tprof.cost_analysis(torch.mm, torch.as_tensor(a),
                              torch.as_tensor(b))
    assert got["flops"] == want["flops"] == 2 * 64 * 32 * 48
    assert got["bytes_accessed"] == (64 * 32 + 32 * 48 + 64 * 48) * 4
    assert got["optimal_seconds"] == 0.0          # no card: peaks unknown
    est = tprof.op_estimates(torch.mm, torch.as_tensor(a),
                             torch.as_tensor(b))
    assert [(e.opcode, e.flops, e.count) for e in est] == [
        ("aten::mm", 2 * 64 * 32 * 48, 1)]


def _tiny_step():
    enc = tmodels.BertEncoder(VOCAB, hidden=HIDDEN, layers=LAYERS,
                              heads=HEADS, max_len=SEQ, device="cpu")
    return enc, train.build_bert_step(BATCH, SEQ, encoder=enc, device="cpu",
                                      strategy="arena")


def test_depth2_bert_step_flops_equal_the_analytic_count():
    enc, (step, state, (toks, labels), _p, _e) = _tiny_step()
    c = cost.count(step, state, toks, labels)
    # GEMMs: 6 x tokens x matmul weights (the token embedding once, as the
    # tied decoder); attention 4·B·H·S²·D forward, 10 backward, a layer;
    # the arena's l2norm + LAMB stages 2 + 15 + 3 flops an element
    weights = sum(p.numel() for n, p in enc.named_parameters()
                  if p.dim() == 2 and "emb" not in n)
    weights += enc.tok_emb.weight.numel()
    d = HIDDEN // HEADS
    attn = 14 * LAYERS * BATCH * HEADS * SEQ * SEQ * d
    n = state.opt_state.slots["m"]["float32"].numel()
    assert c.flops == 6 * BATCH * SEQ * weights + attn + 20 * n
    by = collections.Counter()
    for e in c.ops.values():
        by[e.opcode] += e.flops * e.count
    assert by["apex_tpu_torch::flash_attn_fwd"] == 4 / 14 * attn
    assert by["apex_tpu_torch::flash_attn_bwd"] == 10 / 14 * attn
    # the plain attention's matmuls (bmm/einsum) are the kernel's: hidden
    assert not any(k in by for k in ("aten::bmm", "aten::baddbmm"))
    assert c.ops and all(e.count >= 1 for e in c.ops.values())


def test_annotate_modules_records_the_calls_flax_records():
    jenc = jmodels.BertEncoder(VOCAB, hidden=HIDDEN, layers=LAYERS,
                               heads=HEADS, max_len=SEQ)
    toks = jnp.zeros((BATCH, SEQ), jnp.int32)
    params = jenc.init(jax.random.PRNGKey(0), toks)["params"]
    with jprof.annotate_modules() as jrec:
        jenc.apply({"params": params}, toks)
    tenc = tmodels.BertEncoder(VOCAB, hidden=HIDDEN, layers=LAYERS,
                               heads=HEADS, max_len=SEQ, device="cpu")
    tenc.load_state_dict(params_from_jax(params, device="cpu"))
    with tprof.annotate_modules(root=tenc) as trec:
        tenc(torch.zeros(BATCH, SEQ, dtype=torch.int64))
    jcalls = [r for r in jrec if r.method == "__call__"]
    assert collections.Counter(r.path.replace("/", ".") for r in jcalls) \
        == collections.Counter(r.path for r in trec)
    assert len(trec) == 21 and {r.method for r in trec} == {"forward"}
    shapes = lambda rs: {r.path.replace("/", "."): r.args[0][0]  # noqa
                         for r in rs if r.args and isinstance(r.args[0],
                                                              tuple)}
    assert shapes(jcalls) == shapes(trec)
    # the hooks are gone after the context
    n = len(trec)
    tenc(torch.zeros(BATCH, SEQ, dtype=torch.int64))
    assert len(trec) == n


def test_profile_step_on_the_cpu_and_the_cli(monkeypatch, tmp_path):
    made = []
    real = tempfile.mkdtemp

    def mkdtemp(*a, **k):
        made.append(real(*a, **k))
        return made[-1]
    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    rep = tprof.profile_step(torch.mm, a, b, iters=2, warmup=1,
                             device="cpu")
    assert rep.mfu() is None and rep.mfu(on="wall") is None
    assert rep.device == "cpu" and rep.profile.ops == []
    assert rep.device_us == rep.wall_us > 0
    assert rep.cost["flops"] == 2 * 64 * 32 * 16 and rep.logdir == ""
    assert made and not os.path.exists(made[0])
    assert "mfu=n/a" in rep.table()
    # an explicit logdir keeps the trace; the CLI finds no device kernel
    rep = tprof.profile_step(torch.mm, a, b, iters=1, device="cpu",
                             logdir=str(tmp_path / "kept"))
    assert os.path.exists(os.path.join(rep.logdir, "trace.pt.trace.json"))
    env = dict(os.environ, PYTHONPATH=ROOT)
    for d, msg in ((tmp_path / "kept", "no device kernels"),
                   (tmp_path, "no device kernels"),
                   (tmp_path / "empty", "no trace")):
        os.makedirs(d, exist_ok=True)
        r = subprocess.run([sys.executable, "-m", "apex_tpu_torch.prof",
                            str(d)], capture_output=True, text=True,
                           cwd=ROOT, env=env)
        assert r.returncode == 1 and msg in r.stderr, r.stderr
    r = subprocess.run([sys.executable, "-m", "apex_tpu_torch.prof",
                        str(tmp_path / "empty2")], capture_output=True,
                       text=True, cwd=ROOT, env=env)
    assert r.returncode == 1 and "no trace" in r.stderr


def test_cost_hook_is_passive_off_the_profiler():
    """Off a profiler and a counter the priced wrappers add nothing: the
    launch counts are the kernel's own, no range opens, nothing is
    logged."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import _priced
    x = torch.randn(8, 16)
    w, b = torch.ones(16), torch.zeros(16)
    before = ops.launch_counts()
    y = ops.fused_layer_norm_affine(x, w, b)
    assert ops.launch_counts() == before
    assert not _priced.COUNTERS and not _priced.PROFILED_CALLS
    assert ops.layer_norm.ln_fwd_plain.__wrapped__ is not None
    with cost.CostCounter() as c:
        y2 = ops.fused_layer_norm_affine(x, w, b)
    assert torch.equal(y, y2)
    assert [k for k in c.ops if not k.startswith("aten::view")] == [
        "apex_tpu_torch::layer_norm_fwd[8x16:float32,16:float32]"]
    assert c.ops["apex_tpu_torch::layer_norm_fwd"
                 "[8x16:float32,16:float32]"].bytes == (2 * 8 * 16 + 32) * 4
