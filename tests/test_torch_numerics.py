"""The port's numerics monitor (``apex_tpu_torch.monitor.numerics``) against
the JAX package's (``tests/test_numerics.py``'s module).

Tolerances: histograms, amax, amin, zero and nonfinite fractions, step
counters and every EMA bit for bit (the port fuses the EMA's first
product into its add, as XLA on the CPU contracts the JAX package's);
update-to-weight norm ratios within 1e-6 relative (the two packages sum
the squares in other orders). Subnormals are held against a numpy oracle
of the documented contract (bucket 0, nonzero), not against JAX: XLA on
the CPU flushes them to zero in its comparisons, and differently eager
and under ``jit``. The verdict list of the committed BERT fixture hashes
to the JAX test's ``FIXTURE_VERDICT_DIGEST``. ``Amp.step(numerics=)`` on
a 2-layer BERT at O0–O3: losses and params bit for bit with the hook on
and off; the hook's first fold bit for bit the port's fold of the step's
own tensors; both packages' folds of the JAX step's own tensors at the
tolerances above, with the update sites' norm ratios held against the
exact (f64) ratio of the same tensors within 1e-6 (the JAX package's f32
sums land up to 1.2e-6 from it at O3); and the two steps from the same
weights: the cast copies and cast sites bit for bit, the grad and update
sites' amax within 1e-3 relative and their histograms within 0.1 in L1 (a
twentieth of a leaf's elements changing bucket) at O0 and O1, within 2e-2
and 0.25 at O2 and O3, whose bf16 backward passes round differently.
"""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu.monitor import numerics as jnx
from apex_tpu.optim import FusedLAMB as JLAMB
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import convert
from apex_tpu_torch import models as tmodels
from apex_tpu_torch.monitor import numerics as tnx
from apex_tpu_torch.optim import FusedLAMB as TLAMB

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "bert_numerics_stats.json")
#: tests/test_numerics.py's pin of the committed fixture's verdict list
FIXTURE_VERDICT_DIGEST = \
    "6af8d2d31a7c418c10d12ee11a755d7bd042cc7ff20d0acfc8d1e6d8f0e71dbe"
UW_RTOL = 1e-6
#: (amax rtol, histogram L1) of the grad and update sites of two steps from
#: the same weights: f32 models (O0, O1) and bf16 models (O2, O3, about
#: five bf16 ulps and an eighth of a leaf's elements changing bucket)
F32_E2E, HALF_E2E = (1e-3, 0.1), (2e-2, 0.25)
EXACT_FIELDS = ("step", "check_count", "amax", "amax_ema", "amin",
                "amin_ema", "exp_hist", "zero_frac", "nonfinite_frac",
                "last_check_step")


def _special(rng, n=2048, lo=-100, hi=20):
    """Signed log-uniform f32 values with zeros, ±inf and NaN, far enough
    above f32's normal range that no EMA product is subnormal (XLA on the
    CPU flushes those)."""
    a = (2.0 ** rng.uniform(lo, hi, n) * np.where(rng.rand(n) < 0.5, -1, 1)
         ).astype(np.float32)
    a[:6] = [0.0, np.inf, -np.inf, np.nan, -0.0, 0.0]
    return a


def _assert_state(ts, js, where=""):
    for f in js._fields:
        got, want = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert got.dtype == want.dtype and got.shape == want.shape, (where, f)
        if f in EXACT_FIELDS:
            assert got.tobytes() == want.tobytes(), (where, f, got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=UW_RTOL,
                                       err_msg=f"{where} {f}")


def _trees(arrays, scale=1.0):
    j = {"acts": {"h": jnp.asarray(arrays[0]) * scale,
                  "z": jnp.asarray(arrays[1])},
         "grads/x": jnp.asarray(arrays[2]) * scale}
    t = {"acts": {"h": torch.tensor(arrays[0]) * scale,
                  "z": torch.tensor(arrays[1])},
         "grads/x": torch.tensor(arrays[2]) * scale}
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_leaf_stats_bitwise(dtype, seed):
    rng = np.random.RandomState(seed)
    lo = -100 if dtype != "float16" else -24
    hi = 20 if dtype != "float16" else 15
    a = _special(rng, lo=lo, hi=hi).reshape(32, 64)
    got = tnx._leaf_stats(torch.tensor(a).to(getattr(torch, dtype)))
    want = jax.jit(jnx._leaf_stats)(jnp.asarray(a).astype(dtype))
    for name, x, y in zip(("amax", "amin", "hist", "zero", "nonfinite"),
                          got, want):
        assert x.numpy().tobytes() == np.asarray(y).tobytes(), (name, x, y)


def test_subnormals_follow_the_documented_contract():
    """Nonzero subnormals land in bucket 0 and count as nonzero."""
    a = np.array([1e-45, 3e-39, -1e-40, 1.0, 0.0, -2.5], np.float32)
    amax, amin, hist, zf, nf = tnx._leaf_stats(torch.tensor(a))
    assert float(amax) == 2.5 and amin.numpy() == np.float32(1e-45)
    want = np.zeros(256, np.float32)
    want[0], want[127], want[128] = 3 / 5, 1 / 5, 1 / 5
    np.testing.assert_array_equal(hist.numpy(), want)
    assert zf.numpy() == np.float32(1 / 6) * 1 and float(nf) == 0.0


def test_site_names_match_jax():
    a = np.zeros((2, 3), np.float32)
    jt = {"b/x": {"w": a, "v": [a, a]}, "a": {"k": {"z": a, "y": a}},
          "c": a}
    tt = {"b/x": {"w": torch.zeros(2, 3), "v": [torch.zeros(2, 3)] * 2},
          "a": {"k.z": torch.zeros(2, 3), "k.y": torch.zeros(2, 3)},
          "c": torch.zeros(2, 3)}
    assert tnx.site_names(tt) == jnx.site_names(jt)
    # a port parameter's weight is its JAX kernel / embedding
    sites = tnx.site_names({"g": {"enc.q.weight": torch.zeros(1),
                                  "tok_emb.weight": torch.zeros(1)}})
    assert sites == ("g/['enc']['q']['kernel']",
                     "g/['tok_emb']['embedding']")
    with pytest.raises(ValueError, match="duplicate"):
        tnx.site_names({"a": {"x.weight": torch.zeros(1),
                              "x.kernel": torch.zeros(1)}})


def test_format_table_and_dtypes_match_jax():
    assert tnx.FORMAT_LADDER == jnx.FORMAT_LADDER
    assert {k: tuple(v) for k, v in tnx.FORMAT_TABLE.items()} == \
        {k: tuple(v) for k, v in jnx.FORMAT_TABLE.items()}
    for td, jd in ((torch.float32, jnp.float32), (torch.bfloat16,
                                                  jnp.bfloat16),
                   (torch.float16, jnp.float16),
                   (torch.float8_e4m3fn, jnp.float8_e4m3fn),
                   (torch.float8_e5m2, jnp.float8_e5m2),
                   (torch.int32, jnp.int32)):
        assert tnx.format_of_dtype(td) == jnx.format_of_dtype(jd)
    for name in ("f32", "bf16", "fp8_e4m3", "float16", "int8"):
        assert tnx.format_of_dtype(name) == jnx.format_of_dtype(name)


@pytest.mark.parametrize("check_every", [1, 3])
def test_observe_matches_jax_over_steps(check_every):
    """Every field after every step, with a weight companion on one
    prefix (the other sites keep the -1 sentinel)."""
    rng = np.random.RandomState(2)
    arrays = [_special(rng).reshape(64, 32), rng.randn(5, 7).astype(
        np.float32), _special(rng, 300)]
    jcfg = jnx.NumericsConfig(check_every=check_every, ema=0.8)
    tcfg = tnx.NumericsConfig(check_every=check_every, ema=0.8)
    j0, t0 = _trees(arrays)
    sites = tnx.site_names(t0)
    assert sites == jnx.site_names(j0)
    js = jnx.numerics_init(jcfg, sites=sites)
    ts = tnx.numerics_init(tcfg, sites=sites, device="cpu")
    _assert_state(ts, js, "init")
    jw = {"acts": {"h": j0["acts"]["h"] * 3, "z": j0["acts"]["z"] + 1}}
    tw = {"acts": {"h": t0["acts"]["h"] * 3, "z": t0["acts"]["z"] + 1}}
    jobserve = jax.jit(lambda s, t: jnx.numerics_observe(
        s, jcfg, t, weights=jw))
    for i in range(7):
        jt, tt = _trees(arrays, scale=0.5 ** i)
        js = jobserve(js, jt)
        ts = tnx.numerics_observe(ts, tcfg, tt, weights=tw)
        _assert_state(ts, js, f"step {i}")
    assert int(ts.check_count) == len(range(0, 7, check_every))
    uw = ts.uw_ratio.numpy()
    assert uw[sites.index("grads/x")] == -1.0
    # the companion sites folded (inf/inf is NaN at the poisoned one)
    assert (uw[[sites.index("acts/['h']"), sites.index("acts/['z']")]] !=
            -1.0).all()
    # the host-side helpers read the same state the same way
    assert tnx.nonfinite_sites(ts, sites) == jnx.nonfinite_sites(js, sites)
    np.testing.assert_array_equal(tnx.scale_amax(ts, [0, 2]).numpy(),
                                  np.asarray(jnx.scale_amax(js, [0, 2])))
    assert bool(tnx.finite_ok(ts)) == bool(jnx.finite_ok(js))


def test_off_step_is_one_add_and_thunk_untouched():
    cfg = tnx.NumericsConfig(check_every=4)
    ts = tnx.numerics_init(cfg, sites=("t",), device="cpu")
    calls = []

    def trees():
        calls.append(1)
        return {"t": torch.ones(3)}

    for _ in range(6):
        ts = tnx.numerics_observe(ts, cfg, trees)
    assert len(calls) == 2 and int(ts.check_count) == 2
    assert int(ts.step) == 6 and int(ts.last_check_step) == 4
    # a state of unknown origin is read once, then mirrored
    ts2 = ts._replace(step=torch.tensor(7, dtype=torch.int32))
    ts2 = tnx.numerics_observe(ts2, cfg, trees)      # step 7: off
    assert len(calls) == 2 and tnx._HOST_STEP.get(ts2.step) == 8
    ts2 = tnx.numerics_observe(ts2, cfg, trees)      # step 8: folds
    assert len(calls) == 3 and int(ts2.last_check_step) == 8


def test_mismatched_trees_and_config_refused():
    cfg = tnx.NumericsConfig()
    ts = tnx.numerics_init(cfg, sites=("a", "b"), device="cpu")
    with pytest.raises(ValueError, match="saw 1 sites"):
        tnx.numerics_observe(ts, cfg, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="no matching tree"):
        tnx.numerics_observe(ts, cfg, {"a": torch.ones(2),
                                       "b": torch.ones(2)},
                             weights={"c": torch.ones(2)})
    for bad in (tnx.NumericsConfig(check_every=0),
                tnx.NumericsConfig(ema=1.0)):
        with pytest.raises(ValueError):
            tnx.numerics_init(bad, sites=("a",), device="cpu")


def test_state_carried_from_jax_then_one_more_step():
    rng = np.random.RandomState(3)
    arrays = [_special(rng).reshape(16, 128), rng.randn(9).astype(
        np.float32), _special(rng, 100)]
    cfg = jnx.NumericsConfig(check_every=2)
    j0, _ = _trees(arrays)
    sites = jnx.site_names(j0)
    js = jnx.numerics_init(cfg, sites=sites)
    for i in range(3):
        js = jnx.numerics_observe(js, cfg, _trees(arrays, 2.0 ** i)[0])
    ts = convert.numerics_state_from_jax(jax.device_get(js), device="cpu")
    _assert_state(ts, js, "carried")
    assert tnx.stats_to_json(ts, sites) == jnx.stats_to_json(js, sites)
    for i in (3, 4):             # step 3 is off, step 4 folds
        jt, tt = _trees(arrays, 2.0 ** i)
        js = jnx.numerics_observe(js, cfg, jt)
        ts = tnx.numerics_observe(ts, tnx.NumericsConfig(check_every=2), tt)
        _assert_state(ts, js, f"step {i}")


def test_histogram_counts_past_two_to_the_24():
    """The deliberate departure: one bucket of 2^24 + 1000 elements. The
    JAX package's f32 count stops at 2^24 (its histogram sums to
    0.99994); the port's int32 count is exact and sums to 1."""
    n = (1 << 24) + 1000
    x = np.full(n, 1.5, np.float32)
    jh = np.asarray(jax.jit(jnx._leaf_stats)(jnp.asarray(x))[2])
    th = tnx._leaf_stats(torch.from_numpy(x))[2].numpy()
    assert th[127] == 1.0 and th.sum() == 1.0
    assert jh[127] < 1.0 and jh.sum() < 0.99995
    # below 2^24 in every bucket the two agree bit for bit
    y = np.concatenate([np.full(1 << 20, 1.5, np.float32),
                        np.full(1 << 20, -3e-3, np.float32)])
    assert tnx._leaf_stats(torch.from_numpy(y))[2].numpy().tobytes() == \
        np.asarray(jax.jit(jnx._leaf_stats)(jnp.asarray(y))[2]).tobytes()


# --- the host half ---------------------------------------------------------------

def _fixture_stats(mod):
    with open(FIXTURE) as f:
        return mod.stats_from_json(f.read())


def test_precision_report_reproduces_the_fixture_digest():
    rep = tnx.precision_report(_fixture_stats(tnx))
    canon = json.dumps([(r.fingerprint, r.required_dtype,
                         r.recommended_scale) for r in rep.rows])
    assert hashlib.sha256(canon.encode()).hexdigest() == \
        FIXTURE_VERDICT_DIGEST
    jrep = jnx.precision_report(_fixture_stats(jnx))
    assert [r.to_event() for r in rep.rows] == \
        [r.to_event() for r in jrep.rows]
    assert rep.table() == jrep.table()
    assert rep.fp8_candidates(5) == jrep.fp8_candidates(5)


@pytest.mark.parametrize("current", [None, "bf16", "float16", "fp8_e4m3",
                                     "by_site"])
def test_precision_report_verdicts_match_jax(current):
    stats_t, stats_j = _fixture_stats(tnx), _fixture_stats(jnx)
    if current == "by_site":
        current = {s: ("bf16" if s.startswith("amp/cast/") else "fp32")
                   for s in stats_t["sites"]}
    rep = tnx.precision_report(stats_t, current_dtypes=current)
    jrep = jnx.precision_report(stats_j, current_dtypes=current)
    assert [r.to_event(step=3) for r in rep] == \
        [r.to_event(step=3) for r in jrep]
    assert rep.worst_gaps(7) == jrep.worst_gaps(7)
    assert [r.fingerprint for r in rep.surprises()] == \
        [r.fingerprint for r in jrep.surprises()]


class _StubRoofline:
    """A ``what_if`` that prices a halved element width at half the time
    of a made-up op per site."""

    def __init__(self, us):
        self.us = us

    def what_if(self, plan):
        rows = []
        for site, dt in sorted(plan.items()):
            base = self.us.get(site)
            if base is None:
                continue
            rows.append({"site": site, "dtype_to": dt,
                         "attainable_us": base,
                         "whatif_attainable_us": base / 2,
                         "whatif_gain_us": base / 2})
        return rows


@pytest.mark.parametrize("current", [None, "float16"])
def test_placement_advisor_matches_jax(current):
    rng = np.random.RandomState(6)
    arrs = {"mlp/dense": (2.0 ** rng.uniform(-3, 3, 4096)).astype(
                np.float32),
            "attn/qk": (2.0 ** rng.uniform(-18, 18, 4096)).astype(
                np.float32),
            "attn/v": (2.0 ** rng.uniform(-6, 2, 4096)).astype(np.float32)}
    jt = {k: jnp.asarray(v) for k, v in arrs.items()}
    tt = {k: torch.tensor(v) for k, v in arrs.items()}
    sites = tnx.site_names(tt)
    cfg = tnx.NumericsConfig()
    ts = tnx.numerics_observe(tnx.numerics_init(cfg, sites=sites,
                                                device="cpu"), cfg, tt)
    js = jnx.numerics_observe(jnx.numerics_init(
        jnx.NumericsConfig(), sites=sites), jnx.NumericsConfig(), jt)
    stub = _StubRoofline({"mlp/dense": 900.0, "attn/qk": 40.0,
                          "attn/v": 300.0})
    got = tnx.placement_advisor(stub, tnx.precision_report(
        ts, sites, current_dtypes=current), k=3)
    want = jnx.placement_advisor(stub, jnx.precision_report(
        js, sites, current_dtypes=current), k=3)
    assert got == want and got


def test_check_events_match_jax_and_validate():
    from scripts.check_metrics_schema import check_numerics_lines
    rng = np.random.RandomState(8)
    arrays = [_special(rng).reshape(8, 256), rng.randn(3).astype(
        np.float32), _special(rng, 64)]
    jt, tt = _trees(arrays)
    sites = tnx.site_names(tt)
    cfg = tnx.NumericsConfig()
    ts = tnx.numerics_observe(tnx.numerics_init(cfg, sites=sites,
                                                device="cpu"), cfg, tt)
    js = jnx.numerics_observe(jnx.numerics_init(
        jnx.NumericsConfig(), sites=sites), jnx.NumericsConfig(), jt)
    for cur in (None, "float16", torch.bfloat16):
        got = tnx.check_events(ts, sites, current_dtype=cur)
        want = jnx.check_events(js, sites, current_dtype=(
            "bfloat16" if cur is torch.bfloat16 else cur))
        assert got == want
        ev = got + tnx.precision_report(ts, sites).to_events(step=1)
        assert check_numerics_lines([json.dumps(e) for e in ev]) == []
    with pytest.raises(ValueError, match="not a known"):
        tnx.check_events(ts, sites, current_dtype="int8")


# --- Amp.step(numerics=) on a 2-layer BERT -----------------------------------------

VOCAB, HIDDEN, LAYERS, HEADS, SEQ, BATCH = 1000, 64, 2, 2, 64, 2


def _bert():
    jenc = jmodels.BertEncoder(VOCAB, hidden=HIDDEN, layers=LAYERS,
                               heads=HEADS, max_len=SEQ)
    params = jenc.init(jax.random.PRNGKey(0),
                       jnp.zeros((1, SEQ), jnp.int32))["params"]
    tenc = tmodels.BertEncoder(VOCAB, hidden=HIDDEN, layers=LAYERS,
                               heads=HEADS, max_len=SEQ, device="cpu")
    tenc.load_state_dict(convert.params_from_jax(params, device="cpu"))
    rng = np.random.RandomState(0)
    toks = rng.randint(0, VOCAB, (BATCH, SEQ))
    labels = rng.randint(0, VOCAB, (BATCH, SEQ))
    return jenc, params, tenc, toks, labels


def _port_run(tenc, toks, labels, opt_level, hook, steps=3,
              check_every=2):
    """(losses, params, hook states) of ``steps`` port steps; ``hook``
    is None, "numerics", "dynamics" or "both"."""
    from apex_tpu_torch.monitor import dynamics as tdx
    app = tamp.Amp(tamp.Policy.from_opt_level(opt_level),
                   TLAMB(lr=1e-3, strategy="arena"))
    state = app.init(dict(tenc.named_parameters()))
    tt, tl = torch.as_tensor(toks), torch.as_tensor(labels)
    ncfg = tnx.NumericsConfig(check_every=check_every)
    dcfg = tdx.DynamicsConfig(check_every=check_every, local_batch=BATCH)
    ns = tnx.numerics_init(ncfg, sites=app.numerics_sites(state.params),
                           device="cpu")
    ds = tdx.dynamics_init(dcfg, sites=app.dynamics_sites(state.params),
                           device="cpu")

    def loss_fn(mp):
        return tmodels.mlm_loss(tenc, mp, tt, tl)

    losses = []
    for _ in range(steps):
        kw = {}
        if hook in ("numerics", "both"):
            kw["numerics"] = (ns, ncfg)
        if hook in ("dynamics", "both"):
            kw["dynamics"] = (ds, dcfg)
        state, loss, _fin, *hooks = app.step(state, loss_fn, **kw)
        if hook in ("numerics", "both"):
            ns = hooks.pop(0)
        if hook in ("dynamics", "both"):
            ds = hooks.pop(0)
        losses.append(loss.detach().numpy().tobytes())
    return losses, {k: v.detach().float().numpy()
                    for k, v in state.params.items()}, (ns, ds, app, state)


@pytest.fixture(scope="module")
def bert():
    return _bert()


@pytest.mark.parametrize("opt_level", ["O0", "O1", "O2", "O3"])
def test_amp_numerics_hook_is_read_only(bert, opt_level):
    _jenc, _params, tenc, toks, labels = bert
    l_on, p_on, (ns, _, app, state) = _port_run(tenc, toks, labels,
                                                opt_level, "numerics")
    l_off, p_off, _ = _port_run(tenc, toks, labels, opt_level, None)
    assert l_on == l_off
    for k in p_off:
        assert p_on[k].tobytes() == p_off[k].tobytes(), (opt_level, k)
    sites = app.numerics_sites(state.params)
    assert int(ns.check_count) == 2 and int(ns.step) == 3
    assert tnx.nonfinite_sites(ns, sites) == []
    uw = ns.uw_ratio.numpy()
    assert all((uw[i] >= 0) == s.startswith("amp/update/")
               for i, s in enumerate(sites))


#: the JAX package's first fold of ``Amp.step``'s three trees, fed in f32:
#: the fold reads every leaf as f32 first, so a bf16 leaf's exact f32 copy
#: folds bit for bit as the leaf does, and one compile serves O0–O3
_JAX_FOLD = jax.jit(lambda s, t, w: jnx.numerics_observe(
    s, jnx.NumericsConfig(), t, weights={"amp/update": w}))


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), tree)


@pytest.mark.parametrize("opt_level", ["O0", "O1", "O2", "O3"])
def test_amp_numerics_first_fold_against_jax(bert, opt_level):
    """The first fold of ``Amp.step(numerics=)`` at each opt level: (a) the
    port's hook against the port's fold of the step's own cast copy,
    unscaled grads and ``new - old`` (old weights as companions), every
    field bit for bit; (b) the port's fold of the JAX step's own tensors
    against the JAX package's fold of them (the state the JAX hook
    returns), at the module's tolerances; (c) the two steps from the same
    weights: the cast copies and the cast sites bit for bit, the grad and
    update sites loosely (two backward passes that round differently)."""
    jenc, params, tenc, toks, labels = bert
    japp = jamp.Amp(jamp.Policy.from_opt_level(opt_level),
                    JLAMB(lr=1e-3, strategy="arena"))
    jstate = japp.init(params)
    sites = japp.numerics_sites(jstate.params)
    jt, jl = jnp.asarray(toks, jnp.int32), jnp.asarray(labels, jnp.int32)

    @jax.jit
    def jparts(state):
        _out, grads, mid, finite = japp.backward(
            state, lambda mp: jmodels.mlm_loss(jenc, {"params": mp}, jt, jl))
        return mid.params, grads, japp.apply_gradients(mid, grads,
                                                       finite).params

    _, _, (tns, _, app, tstate) = _port_run(tenc, toks, labels, opt_level,
                                            "numerics", steps=1,
                                            check_every=1)
    assert app.numerics_sites(tstate.params) == sites
    tcfg = tnx.NumericsConfig()

    def tfold(trees, old):
        return tnx.numerics_observe(
            tnx.numerics_init(tcfg, sites=sites, device="cpu"), tcfg, trees,
            weights={"amp/update": old})

    # (a) the hook feeds the fold the step's own tensors
    state = app.init(dict(tenc.named_parameters()))
    tt, tl = torch.as_tensor(toks), torch.as_tensor(labels)
    _out, grads, mid, finite = app.backward(
        state, lambda mp: tmodels.mlm_loss(tenc, mp, tt, tl))
    new = app.apply_gradients(mid, grads, finite).params
    old = mid.params
    tcast = app.policy.cast_params(old)
    want = tfold({"amp/cast": tcast, "amp/grads": grads,
                  "amp/update": {k: new[k].float() - old[k].float()
                                 for k in old}}, old)
    for f in tns._fields:
        assert getattr(tns, f).numpy().tobytes() == \
            getattr(want, f).numpy().tobytes(), (opt_level, f)

    # (b) the JAX step's tensors through both folds
    jold, jgrads, jnew = jparts(jstate)
    jcast = japp.policy.cast_params(jold)
    jtrees = {"amp/cast": jcast, "amp/grads": jgrads,
              "amp/update": jax.tree_util.tree_map(
                  lambda n, o: n.astype(jnp.float32) - o.astype(jnp.float32),
                  jnew, jold)}
    jns = _JAX_FOLD(jnx.numerics_init(jnx.NumericsConfig(), sites=sites),
                    _f32(jtrees), _f32(jold))

    def port(tree):
        return convert.params_from_jax(jax.device_get(tree), device="cpu")

    tns_fed = tfold({k: port(v) for k, v in jtrees.items()}, port(jold))
    for f in EXACT_FIELDS:
        assert getattr(tns_fed, f).numpy().tobytes() == np.asarray(
            getattr(jns, f)).tobytes(), (opt_level, f)
    # the update sites' ratios against the exact (f64) ratio of the same
    # tensors, and no farther from JAX's than its f32 sums are from it
    k = 2 * len(sites) // 3
    exact = np.asarray([
        np.sqrt(np.sum(np.asarray(u, np.float64) ** 2)) / max(np.sqrt(np.sum(
            np.asarray(w, np.float32).astype(np.float64) ** 2)), 1e-30)
        for u, w in zip(jax.tree_util.tree_leaves(jtrees["amp/update"]),
                        jax.tree_util.tree_leaves(jold))])
    got, want = tns_fed.uw_ratio.numpy(), np.asarray(jns.uw_ratio)
    assert (got[:k] == -1).all() and (want[:k] == -1).all()
    np.testing.assert_allclose(got[k:], exact, rtol=UW_RTOL)
    assert (np.abs(got[k:] - want[k:]) <= np.abs(want[k:] - exact)
            + UW_RTOL * exact).all(), opt_level

    # (c) the two steps from the same weights
    for k, v in port(jcast).items():
        assert tcast[k].dtype == getattr(
            torch, str(jax.tree_util.tree_leaves(jcast)[0].dtype)), k
        assert tcast[k].float().numpy().tobytes() == v.numpy().tobytes(), k
    rtol, l1 = HALF_E2E if opt_level in ("O2", "O3") else F32_E2E
    got = tnx._fetch_stats(tns, sites)
    want = jnx._fetch_stats(jns, sites)
    for i, s in enumerate(sites):
        if s.startswith("amp/cast/"):
            for f in ("amax", "amin", "exp_hist", "zero_frac",
                      "nonfinite_frac", "uw_ratio"):
                assert got[f][i].tobytes() == want[f][i].tobytes(), (s, f)
        else:
            np.testing.assert_allclose(got["amax"][i], want["amax"][i],
                                       rtol=rtol, err_msg=s)
            if "['qkv_proj']['bias']" in s:
                # a third of it is the key bias, whose gradient is rounding
                # noise alone (the softmax is shift-invariant)
                continue
            assert np.abs(got["exp_hist"][i] - want["exp_hist"][i]
                          ).sum() <= l1, s
    assert int(tns.check_count) == int(jns.check_count) == 1
