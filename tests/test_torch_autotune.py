"""The port's kernel autotuner against the JAX package's.

- the port's ``family|dims|dtype|chip`` fingerprints are the JAX
  package's for the same shape (a torch dtype keys by its numpy name), and
  the JAX package's committed DB loads in the port stale-free;
- the DB's contract as ``tests/test_autotune.py`` pins it: exact-key hits,
  nearest misses, stale and malformed entries refused at load, ``off``
  skipping the consult, an off-grid value warning with its fingerprint
  and launching the defaults;
- ``tuned_qk`` gives the JAX package's ``_tuned_qk`` pair under the same
  seeded DB, with and without dropout, and the plain attention's output
  stays the JAX package's;
- a miss (and ``off``) leaves every seam's launch arguments as they were
  and a hit changes them, seen through recorded launches (the Triton
  launcher and the CUDA C entry points patched; nothing runs);
- ``tune_report`` joins ``worst_gaps`` rows by family and dims, and the
  tuning script's CPU audit passes on the committed DB.
"""

import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as jax_attention
from apex_tpu.ops import autotune as jax_autotune
from apex_tpu_torch.arena import BUFFER_MULTIPLE
from apex_tpu_torch.ops import _arena, _build, attention, autotune
from apex_tpu_torch.ops import compile_check, layer_norm as L
from apex_tpu_torch.ops import mlp as P, multi_tensor as M
from apex_tpu_torch.ops import optim_kernels as K, xentropy as X

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("APEX_TPU_AUTOTUNE", raising=False)
    autotune.reset_counters()
    jax_autotune.reset_counters()
    yield
    autotune.set_db(None)
    autotune.reset_counters()
    jax_autotune.set_db(None)
    jax_autotune.reset_counters()


def _entry(family, dims, block, dtype="float32", chip=None):
    return autotune.TuningEntry(family, tuple(dims), dtype,
                                chip or autotune.chip_kind(), dict(block))


def _db(*entries):
    return autotune.TuningDB({e.fingerprint: e for e in entries})


# --- fingerprints ----------------------------------------------------------------

@pytest.mark.parametrize("family,dims", [
    ("attention", (2, 256, 256, 4, 64)), ("mlp", (2048, 13, 512, 256, 128)),
    ("layer_norm", (8192, 1024)), ("xentropy", (8192, 30522)),
    ("optimizer", (335609856,))])
@pytest.mark.parametrize("tdt,jdt", [
    (torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
    (torch.float16, jnp.float16)])
def test_fingerprint_is_the_jax_packages(family, dims, tdt, jdt):
    for chip in ("cpu", "nvidia_h100_80gb_hbm3"):
        assert autotune.fingerprint(family, dims, tdt, chip) == \
            jax_autotune.fingerprint(family, dims, jdt, chip)
    assert autotune.fingerprint(family, dims, "bfloat16", "cpu") == \
        autotune.fingerprint(family, dims, torch.bfloat16, "cpu")


def test_chip_key_and_refusals():
    assert autotune.chip_kind() == "cpu"
    assert autotune.fingerprint("layer_norm", (8, 16),
                                torch.float32).endswith("|cpu")
    with pytest.raises(ValueError, match="unknown kernel family"):
        autotune.fingerprint("conv", (1,), torch.float32)
    assert set(autotune.FAMILIES) == set(jax_autotune.FAMILIES)
    assert autotune.MODES == jax_autotune.MODES


def test_jax_committed_db_loads_stale_free():
    path = os.path.join(ROOT, "scripts", "kernel_tuning_db.json")
    db = autotune.TuningDB.load(path)
    jdb = jax_autotune.TuningDB.load(path)
    assert len(db) and sorted(db.entries) == sorted(jdb.entries)
    for fp, e in db.entries.items():
        assert e.fingerprint == fp == jdb.entries[fp].fingerprint
    assert autotune.tuned_lint_shapes(db) == jax_autotune.tuned_lint_shapes(
        jdb)


# --- the DB's contract -----------------------------------------------------------

def test_round_trip_exact_hit_and_nearest_misses(tmp_path):
    e = _entry("layer_norm", (256, 192), {"epl": 8, "bwd_blocks": 16})
    path = _db(e).save(str(tmp_path / "db.json"))
    db = autotune.TuningDB.load(path)
    assert db.lookup(e.fingerprint) == e
    with autotune.use_db(path):
        assert autotune.launch_knobs("layer_norm", (256, 192),
                                     torch.float32) == e.block
        for dims, dt in (((255, 192), torch.float32),
                         ((256, 192), torch.bfloat16),
                         ((256, 193), torch.float32)):
            assert autotune.lookup_blocks("layer_norm", dims, dt) is None
        assert autotune.counters() == {"hits": 1, "misses": 3}
        assert autotune.recent_consults()[0] == (e.fingerprint, True)
    other = e.fingerprint.replace("|cpu", "|nvidia_h100_pcie")
    assert db.lookup(other) is None
    st = autotune.db_stats()
    assert {"entries", "tuned_families", "hits", "misses"} <= set(st)


def test_stale_malformed_and_missing(tmp_path):
    e = _entry("xentropy", (64, 1000), {"BLOCK": 2048})
    path = _db(e).save(str(tmp_path / "db.json"))
    body = json.loads(open(path).read())
    body["entries"][e.fingerprint]["dims"] = [64, 999]
    (tmp_path / "stale.json").write_text(json.dumps(body))
    with pytest.raises(autotune.StaleTuningEntry, match=e.fingerprint):
        autotune.TuningDB.load(str(tmp_path / "stale.json"))
    del body["entries"][e.fingerprint]["family"]
    (tmp_path / "bad.json").write_text(json.dumps(body))
    with pytest.raises(autotune.StaleTuningEntry, match="malformed"):
        autotune.TuningDB.load(str(tmp_path / "bad.json"))
    assert len(autotune.TuningDB.load(str(tmp_path / "none.json"))) == 0
    (tmp_path / "notdb.json").write_text("[]")
    with pytest.raises(ValueError, match="not a tuning DB"):
        autotune.TuningDB.load(str(tmp_path / "notdb.json"))


def test_off_mode_skips_the_consult(monkeypatch):
    e = _entry("layer_norm", (256, 192), {"epl": 16})
    monkeypatch.setenv("APEX_TPU_AUTOTUNE", "off")
    with autotune.use_db(_db(e)):
        assert autotune.launch_knobs("layer_norm", (256, 192),
                                     torch.float32) == {}
        assert autotune.lookup_blocks("layer_norm", (256, 192),
                                      torch.float32) is None
    assert autotune.counters() == {"hits": 0, "misses": 0}
    monkeypatch.setenv("APEX_TPU_AUTOTUNE", "fast")
    with pytest.raises(ValueError, match="refusing to guess"):
        autotune.mode()


@pytest.mark.parametrize("family,dims,block", [
    ("layer_norm", (256, 192), {"epl": 24}),        # no instance
    ("layer_norm", (256, 4096), {"epl": 64}),       # 64 a lane < 4096
    ("layer_norm", (256, 192), {"bwd_blocks": 300}),  # > the finishers
    ("optimizer", (BUFFER_MULTIPLE,), {"BLOCK": 3000}),
    ("optimizer", (2 * BUFFER_MULTIPLE,), {"BLOCK": 32768}),  # !| 65536
    ("xentropy", (64, 1000), {"num_warps": 3}),
    ("mlp", (16, 8, 4), {"block_rows": 32}),        # mlp has no knob
])
def test_illegal_value_warns_with_fingerprint_and_defaults(family, dims,
                                                           block):
    e = _entry(family, dims, block)
    with autotune.use_db(_db(e)):
        with pytest.warns(RuntimeWarning, match=e.fingerprint.replace(
                "|", r"\|")):
            assert autotune.launch_knobs(family, dims, torch.float32) == {}
        with warnings.catch_warnings():           # the refusal is cached
            warnings.simplefilter("error")
            assert autotune.launch_knobs(family, dims, torch.float32) == {}
    assert autotune.counters()["hits"] == 2


def test_consult_is_cached_per_key():
    e = _entry("optimizer", (BUFFER_MULTIPLE,), {"BLOCK": 2048})
    db = _db(e)
    looked = []
    real = db.lookup
    db.lookup = lambda fp: (looked.append(fp), real(fp))[1]
    with autotune.use_db(db):
        for _ in range(5):
            assert autotune.launch_knobs("optimizer", (BUFFER_MULTIPLE,),
                                         torch.float32) == {"BLOCK": 2048}
    assert looked == [e.fingerprint]
    assert autotune.counters() == {"hits": 5, "misses": 0}


def test_candidate_grids_lead_with_defaults_and_stay_legal():
    for family, dims, dt in (("layer_norm", (8192, 1024), torch.bfloat16),
                             ("xentropy", (8192, 30522), torch.bfloat16),
                             ("optimizer", (335609856,), torch.float32),
                             ("mlp", (2048, 13, 512), torch.bfloat16),
                             ("attention", (16, 512, 512, 16, 64),
                              torch.bfloat16)):
        grid = autotune.candidate_grid(family, dims, dt)
        assert grid[0] == autotune._defaults(family, dims, dt)
        legal = autotune.legal_values(family, dims, dt)
        for cand in grid:
            assert all(v in legal[k] for k, v in cand.items())
        assert len(grid) == (1 if family in ("mlp", "attention") else
                             len({json.dumps(c, sort_keys=True)
                                  for c in grid}))
    assert autotune.candidate_grid("layer_norm", (8192, 1024),
                                   torch.bfloat16)[0] == {
        "epl": 32, "bwd_blocks": 256}
    with pytest.raises(RuntimeError, match="no"):
        autotune.sweep_entry("xentropy", (8, 16), torch.float32, lambda: 0)


# --- attention: tuned_qk is the JAX package's _tuned_qk -----------------------------

def test_tuned_qk_is_the_jax_packages():
    rng = np.random.RandomState(9)
    qn = rng.randn(1, 128, 2, 64).astype(np.float32)
    dims, blk = (1, 128, 128, 2, 64), {"block_q": 64, "block_k": 128}
    e = _entry("attention", dims, blk)
    je = jax_autotune.TuningEntry("attention", dims, "float32", "cpu",
                                  dict(blk))
    q, jq = torch.from_numpy(qn), jnp.asarray(qn)
    D = attention.DEFAULT_BLOCK_Q, attention.DEFAULT_BLOCK_K
    with autotune.use_db(_db(e)), jax_autotune.use_db(
            jax_autotune.TuningDB({je.fingerprint: je})):
        for rate in (0.0, 0.1):
            for given in (D, (256, 256)):
                assert autotune.tuned_qk(q, q, *given, rate, *D) == \
                    jax_attention._tuned_qk(jq, jq, *given, rate)
        want = np.asarray(jax_attention.flash_attention(jq, jq, jq))
        got = attention.flash_attention(q, q, q).numpy()
    # one consult at the defaults without dropout, one in flash_attention
    assert autotune.counters() == {"hits": 2, "misses": 0}
    assert jax_autotune.counters()["hits"] >= 2
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


# --- the seams: recorded launches --------------------------------------------------

@pytest.fixture
def cpu_launchers(monkeypatch):
    """Every kernel wrapper runs its host side on CPU tensors: the operand
    checks pass, the stream is 0, workspaces are fresh, the MLP's C entry
    point does nothing; ``compile_check.recorded_launches(False)`` records
    the Triton and LayerNorm launches without running them."""
    monkeypatch.setattr(_build, "check_operands", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "workspace", lambda cache, dev, st, n, c: (
        torch.zeros(n), torch.zeros(c, dtype=torch.int32)))
    monkeypatch.setattr(P, "_lib", lambda: (lambda call, stream: 0))


def _every_seam():
    """One launch through each wrapper with a launch knob or a consult,
    at shapes no DB holds."""
    rs = np.random.RandomState(0)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)

    n = BUFFER_MULTIPLE
    x, g, w = t(96, 72), t(96, 72), t(72)
    p, gg, m, v, r = (t(n) for _ in range(5))
    logits, labels = t(64, 1000, dtype=torch.bfloat16), torch.zeros(
        64, dtype=torch.int64)
    lse, gl = t(64), t(64)
    sc = {k: _arena.device_scalars(vals, "cpu") for k, vals in {
        1: (0.5,), 2: (1.0, 0.5), 4: (0.1, 1e-10, 0.0, 1.0),
        6: (0.1, 0.9, 0.0, 0.0, 1.0, 0.0),
        7: (1e-3, 0.9, 0.1, 1e-8, 0.0, 0.1, 0.1),
        8: (0.9, 0.999, 1e-6, 0.0, 0.1, 0.01, 1.0, 0.1)}.items()}
    L.ln_fwd_kernel(x, w, w, 1e-5)
    L.ln_bwd_kernel(g, x, w, 1e-5)
    X.xentropy_fwd_kernel(logits, labels, 0.1)
    X.xentropy_bwd_kernel(logits, labels, lse, gl, 0.1)
    M.l2norm_kernel(p)
    M.maxnorm_kernel(p)
    M.scale_kernel(p, sc[1], torch.float32)
    M.axpby_kernel(p, gg, sc[2], torch.float32)
    K.lamb_stage1_kernel(p, gg, m, v, sc[8], True)
    K.lamb_stage2_kernel(p, r, r, sc[1])
    K.sgd_kernel(p, gg, m, sc[6], False, False)
    K.adam_kernel(p, gg, m, v, sc[8], True)
    K.adagrad_kernel(p, gg, m, sc[4], False)
    K.novograd_kernel(p, gg, m, v, sc[7], False)
    P.mlp_fwd_kernel(t(16, 8), [t(8, 4)], None, "relu")


def _recorded(mode=None, db=None):
    if mode is not None:
        os.environ["APEX_TPU_AUTOTUNE"] = mode
    try:
        with autotune.use_db(db or autotune.TuningDB()):
            with compile_check.recorded_launches(forward=False) as calls:
                _every_seam()
    finally:
        os.environ.pop("APEX_TPU_AUTOTUNE", None)
    return calls


def test_a_miss_launches_exactly_what_off_does(cpu_launchers):
    off = _recorded("off")
    assert autotune.counters() == {"hits": 0, "misses": 0}
    miss = _recorded("db")
    assert miss == off
    # every seam consulted: 2 LayerNorm, 2 cross-entropy, 10 arena, 1 MLP
    assert autotune.counters() == {"hits": 0, "misses": 15}
    kernels = {c[0] for c in off}
    assert {"layer_norm_fwd", "layer_norm_bwd", "_ce_fwd_triton",
            "_ce_bwd_triton", "_l2norm_partials_triton",
            "_maxnorm_partials_triton", "_axpby_triton",
            "_lamb_stage1_triton", "_lamb_stage2_triton", "_sgd_triton",
            "_adam_triton", "_adagrad_triton", "_novograd_triton"} <= kernels
    # today's constants: the defaults the tuner's grids lead with
    triton = {c[0]: dict(c[2]) for c in off if c[0].endswith("_triton")}
    assert triton["_ce_fwd_triton"]["BLOCK"] == X._CHUNK == 4096
    assert triton["_adam_triton"]["BLOCK"] == K._BLOCK == 1024
    assert triton["_l2norm_partials_triton"]["BLOCK"] == M._BLOCK == 4096


def test_a_hit_changes_the_launch(cpu_launchers):
    off = _recorded("off")
    n = BUFFER_MULTIPLE
    db = _db(_entry("layer_norm", (96, 72), {"epl": 16, "bwd_blocks": 4}),
             _entry("xentropy", (64, 1000), {"BLOCK": 1024, "num_warps": 4},
                    dtype="bfloat16"),
             _entry("optimizer", (n,), {"BLOCK": 2048, "num_warps": 8,
                                        "NORM_BLOCK": 8192,
                                        "norm_warps": 4}))
    hit = _recorded("db", db)
    assert autotune.counters() == {"hits": 14, "misses": 1}    # the MLP
    by = {}
    for c in hit:
        by.setdefault(c[0], []).append(c)
    fwd = dict(by["layer_norm_fwd"][0][1])
    bwd = dict(by["layer_norm_bwd"][0][1])
    assert fwd["epl"] == 16 and bwd["epl"] == 16
    assert (bwd["blocks"], bwd["rows"]) == (4, 24)
    ce = dict(by["_ce_fwd_triton"][0][2])
    assert (ce["BLOCK"], ce["num_warps"]) == (1024, 4)
    adam = by["_adam_triton"][0]
    assert adam[1] == (n // 2048,) and dict(adam[2])["num_warps"] == 8
    l2 = dict(by["_l2norm_partials_triton"][0][2])
    assert (l2["BLOCK"], l2["num_warps"]) == (8192, 4)
    assert not set(hit) & {c for c in off if c[0] in (
        "layer_norm_fwd", "layer_norm_bwd", "_ce_fwd_triton",
        "_adam_triton", "_l2norm_partials_triton")}


def test_bwd_plan_with_tuned_blocks_stays_a_partition():
    for n, cap in ((8192, 256), (8192, 132), (8192, 128), (300, 7),
                   (5, 64)):
        path, epl, rows, blocks = L._ln_bwd_plan(n, 1024, 2, True, cap)
        assert blocks <= cap and (blocks - 1) * rows < n <= blocks * rows
    assert L._ln_bwd_plan(8192, 1024, 2, True) == \
        L._ln_bwd_plan(8192, 1024, 2, True, L._BWD_BLOCKS)
    # the epl a tuned hit may set: only where the plan's path takes it
    assert L._tuned_epl({"epl": 64}, L._VECTOR, 32, 2) == 64
    assert L._tuned_epl({"epl": 32}, L._SCALAR, 16, 4) == 16
    assert L._tuned_epl({"epl": 64}, L._STAGED, 0, 2) == 0
    assert L._tuned_epl({}, L._VECTOR, 32, 2) == 32


# --- reports and the tuning script ---------------------------------------------------

def test_tune_report_joins_by_family_and_dims():
    db = _db(autotune.TuningEntry("layer_norm", (8192, 1024), "bfloat16",
                                  "cpu", {"epl": 64},
                                  sweep={"default_us": 10.0,
                                         "best_us": 8.5}),
             _entry("optimizer", (BUFFER_MULTIPLE,), {"BLOCK": 2048}))
    gaps = [{"fingerprint": "layer_norm|k|s|bfloat16[8192,1024]",
             "family": "layer_norm", "shape": "bfloat16[8192,1024]",
             "gap_us": 3.0},
            {"fingerprint": "layer_norm|k|s|bfloat16[16,1024]",
             "family": "layer_norm", "shape": "bfloat16[16,1024]"},
            {"fingerprint": "optimizer|k|s|float32[65536]",
             "family": "optimizer", "shape": "float32[65536]"},
            {"fingerprint": "attention|k|s|bfloat16[2,64]",
             "family": "attention", "shape": "bfloat16[2,64]"}]
    rep = autotune.tune_report(db, gaps)
    cov = [c["covered"] for c in rep["candidates"]]
    assert cov == [True, False, True, False]
    assert rep["candidates"][0]["predicted_closure_us"] == 1.5
    assert rep["uncovered_families"] == ["attention", "layer_norm"]
    ev = autotune.tune_event("hit", "fp", "layer_norm", rank=1)
    assert ev == {"kind": "tune", "rank": 1, "action": "hit",
                  "fingerprint": "fp", "family": "layer_norm"}


def test_tuning_script_cpu_audit():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_tune", os.path.join(ROOT, "scripts",
                                          "torch_kernel_tune.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.cpu_audit() == 0
    db = autotune.TuningDB.load(mod.DB_PATH)
    for e in db.entries.values():
        assert e.sweep["mode"] == "cuda"
        assert e.block == autotune.candidate_grid(
            e.family, e.dims, e.dtype)[0] or e.sweep["won"]
        # a kept knob passed the paired rule; a default means none did
        kept = [c for c in e.sweep["candidates"] if c["block"] == e.block]
        passed = [c for c in e.sweep["candidates"] if c["passed"]]
        assert all(c["wins"] >= autotune.SWEEP_MIN_WINS for c in passed)
        if e.sweep["won"]:
            assert kept and kept[0]["passed"] and kept[0]["us"] == min(
                c["us"] for c in passed)
        else:
            assert not kept and not passed


def _tune_script():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_tune", os.path.join(ROOT, "scripts",
                                          "torch_kernel_tune.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- the sweep's rule and the tuning script's launchers ----------------------

@pytest.mark.parametrize("default,cand,wins,passed", [
    # a clear winner: every pair by far more than the default's IQR
    ([10.0, 10.2, 10.1, 10.3, 10.0, 10.1, 10.2, 10.0, 10.1, 10.2],
     [9.0] * 10, 10, True),
    # ahead in every pair, but by less than the default's IQR (0.2)
    ([10.0, 10.2, 10.1, 10.3, 10.0, 10.1, 10.2, 10.0, 10.1, 10.2],
     [x - 0.1 for x in (10.0, 10.2, 10.1, 10.3, 10.0, 10.1, 10.2, 10.0,
                        10.1, 10.2)], 0, False),
    # far ahead in 8 pairs of 10: one short of the rule
    ([10.0] * 10, [9.0] * 8 + [10.5] * 2, 8, False),
    ([10.0] * 10, [9.0] * 9 + [10.5], 9, True),
])
def test_pair_verdict_keeps_only_a_steady_winner(default, cand, wins,
                                                 passed):
    v = autotune.pair_verdict(default, cand)
    assert (v["wins"], v["passed"]) == (wins, passed)
    assert v["default_us"] == round(float(np.median(default)), 3)
    q1, q3 = np.percentile(default, [25, 75])
    assert v["iqr_us"] == round(float(q3 - q1), 3)
    with pytest.raises(ValueError):
        autotune.pair_verdict(default, cand[:-1])


def test_kernel_modules_take_their_defaults_from_the_tuner():
    d = autotune.DEFAULTS
    assert (K._BLOCK, K._WARPS) == (d["optimizer"]["BLOCK"],
                                    d["optimizer"]["num_warps"])
    assert (M._BLOCK, M._WARPS) == (d["optimizer"]["NORM_BLOCK"],
                                    d["optimizer"]["norm_warps"])
    assert (X._CHUNK, X._WARPS) == (d["xentropy"]["BLOCK"],
                                    d["xentropy"]["num_warps"])
    assert L._BWD_BLOCKS == d["layer_norm"]["bwd_blocks"]
    # the legal grid reads the arena's multiple itself
    n = BUFFER_MULTIPLE
    assert max(autotune.legal_values("optimizer", (n,), "float32")[
        "BLOCK"]) == min(16384, n)


def test_tune_script_records_the_kernels_of_each_consult(cpu_launchers):
    tune = _tune_script()
    os.environ["APEX_TPU_AUTOTUNE"] = "db"
    try:
        with autotune.use_db(autotune.TuningDB()), \
                compile_check.recorded_launches(forward=False), \
                tune.consulting_kernels() as seen:
            _every_seam()
    finally:
        os.environ.pop("APEX_TPU_AUTOTUNE", None)
    assert seen == {
        ("layer_norm", (96, 72), "float32"): {"ln_fwd_kernel",
                                              "ln_bwd_kernel"},
        ("xentropy", (64, 1000), "bfloat16"): {"xentropy_fwd_kernel",
                                               "xentropy_bwd_kernel"},
        ("optimizer", (BUFFER_MULTIPLE,), "float32"): {
            "l2norm_kernel", "maxnorm_kernel", "scale_kernel",
            "axpby_kernel", "lamb_stage1_kernel", "lamb_stage2_kernel",
            "sgd_kernel", "adam_kernel", "adagrad_kernel",
            "novograd_kernel"},
        ("mlp", (16, 8, 4), "float32"): {"mlp_fwd_kernel"}}
    assert autotune.launch_knobs.__name__ == "launch_knobs"   # restored


@pytest.mark.parametrize("family,dims,dtype", [
    ("layer_norm", (24, 64), "bfloat16"), ("xentropy", (16, 1003),
                                           "bfloat16"),
    ("optimizer", (BUFFER_MULTIPLE,), "float32")])
def test_tune_launcher_runs_exactly_the_named_kernels(family, dims, dtype,
                                                      monkeypatch):
    tune = _tune_script()
    monkeypatch.setattr(compile_check, "DEVICE", "cpu")
    names = tune.KERNELS[family]
    for pick in [names[:1], names]:
        _, plain = tune.launcher(family, dims, dtype, pick)
        one = {k: len(tune.launcher(family, dims, dtype, [k])[1]())
               for k in pick}
        outs = plain()
        assert len(outs) == sum(one.values())
        assert all(torch.isfinite(o.float()).all() for o in outs)
    with pytest.raises(ValueError, match="no launcher"):
        tune.launcher(family, dims, dtype, ["sgd_kernel"])
    with pytest.raises(ValueError, match="no launcher"):
        tune.launcher(family, dims, dtype, [])
