"""The port's guard (``apex_tpu_torch.guard``) against the JAX package's.

- ``guard_observe`` over scripted loss and grad-norm streams (NaN and inf
  losses and norms, spikes, explosions, nonfinite params, replica
  divergence, even- and odd-count windows, the LR backoff and its
  recovery): every ``GuardState`` field bit for bit after every step; the
  median is the JAX package's midpoint rule (``torch.nanmedian`` takes the
  lower middle value).
- ``GuardPolicy``: the action and event sequences (minus ``wall_time``
  and the checkpoint root) of a run with skips, a skip-budget rewind, a
  nonfinite-param rewind past a truncated checkpoint with a ``StubSource``
  cursor fast-forward, and an escalation, equal the JAX package's.
- ``Amp.step(guard=)`` on a tiny BERT at O0 (f32: at O1 the bf16 forward
  and LAMB's normalized update turn last-bit gradient differences into
  O(lr) sign flips of near-zero params) with the arena LAMB, a spiked
  loss at one step: ``committed`` and the guard's counters bit for bit
  against the JAX package's step, params within 1e-4 of each tensor's
  largest magnitude plus 1% of the lr; the skipped step leaves params, optimizer state and
  ``step`` bit for bit; a NaN gradient is skipped without a loss scaler
  (the card runs the O1 bf16 path: ``chip_smoke.py`` bert_large_guard).
- chaos: ``FaultPlan.random`` equals the JAX package's plan, JSON for
  JSON; ``inject_grads``/``inject_activation`` and the batch faults match.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import ckpt as jckpt
from apex_tpu import guard as jguard
from apex_tpu import models as jmodels
from apex_tpu.optim import FusedLAMB as JLAMB
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import ckpt as tckpt
from apex_tpu_torch import guard as tguard
from apex_tpu_torch import models as tmodels
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.optim import FusedLAMB as TLAMB

CFG = dict(window=8, min_history=4, z_threshold=6.0, grad_factor=10.0,
           lr_growth_interval=3)
NAN, INF = float("nan"), float("inf")


def _assert_state_equal(ts, js, where=""):
    for name in js._fields:
        got = getattr(ts, name).numpy()
        want = np.asarray(getattr(js, name))
        assert got.shape == want.shape, (where, name)
        assert got.dtype == want.dtype, (where, name, got.dtype, want.dtype)
        assert got.tobytes() == want.tobytes(), (where, name, got, want)


#: (loss, grad norm, params finite, replica ok) per step
STREAMS = {
    "clean_even": [(1.0 - 0.01 * i + 0.003 * (i % 3), 1.0 + 0.02 * i,
                    True, True) for i in range(20)],
    "spikes_and_nonfinite": (
        [(2.0 - 0.02 * i, 1.5 + 0.01 * (i % 2), True, True)
         for i in range(7)]
        + [(90.0, 1.5, True, True), (NAN, 1.5, True, True),
           (1.8, NAN, True, True), (1.79, INF, True, True),
           (1.78, 400.0, True, True), (INF, 1.5, True, True),
           (1.77, 1.5, False, True), (1.76, 1.5, True, False)]
        + [(1.75 - 0.01 * i, 1.5, True, True) for i in range(9)]
        + [(60.0, 1.5, True, True)] * 3),
    "odd_history": [(3.0, 2.0, True, True), (2.5, 2.1, True, True),
                    (2.7, 1.9, True, True), (2.6, 2.2, True, True),
                    (2.65, 2.0, True, True), (40.0, 2.0, True, True),
                    (2.55, 60.0, True, True), (2.5, 2.0, True, True)],
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("window", [8, 5])
def test_guard_observe_matches_jax_bitwise(stream, window):
    cfg = dict(CFG, window=window)
    tcfg, jcfg = tguard.GuardConfig(**cfg), jguard.GuardConfig(**cfg)
    ts, js = tguard.guard_init(tcfg, device="cpu"), jguard.guard_init(jcfg)
    _assert_state_equal(ts, js, "init")
    tp_ok, jp_ok = {"w": torch.ones(3)}, {"w": jnp.ones(3)}
    tp_bad = {"w": torch.tensor([1.0, NAN, 1.0])}
    jp_bad = {"w": jnp.asarray([1.0, NAN, 1.0])}
    for i, (loss, gnorm, p_ok, r_ok) in enumerate(STREAMS[stream]):
        ts = tguard.guard_observe(
            ts, tcfg, loss=torch.tensor(loss), grad_norm=torch.tensor(gnorm),
            params=tp_ok if p_ok else tp_bad,
            replica_ok=None if r_ok else torch.tensor(False))
        js = jguard.guard_observe(
            js, jcfg, loss=jnp.float32(loss), grad_norm=jnp.float32(gnorm),
            params=jp_ok if p_ok else jp_bad,
            replica_ok=None if r_ok else jnp.bool_(False))
        _assert_state_equal(ts, js, f"{stream} step {i}")
        assert bool(tguard.guard_ok(ts, tcfg)) == bool(
            jguard.guard_ok(js, jcfg))
        assert tguard.anomaly_classes(int(ts.anomaly)) == \
            jguard.anomaly_classes(int(js.anomaly))


def test_guard_observe_from_grads_trees_matches_jax():
    """The tree inputs: grads (finiteness and norm taken from the tree),
    ``grads_finite``, ``skip_on_spike=False``, ``check_params=False``."""
    cfg = dict(CFG, skip_on_spike=False, check_params=False)
    tcfg, jcfg = tguard.GuardConfig(**cfg), jguard.GuardConfig(**cfg)
    ts, js = tguard.guard_init(tcfg, device="cpu"), jguard.guard_init(jcfg)
    for i in range(10):
        g = np.full(4, 1.0 + 0.1 * i, np.float32)
        if i == 7:
            g[2] = NAN
        loss = 1.0 - 0.05 * i if i != 8 else 50.0
        ts = tguard.guard_observe(ts, tcfg, loss=loss,
                                  grads={"g": torch.tensor(g)},
                                  params={"w": torch.tensor([NAN])})
        js = jguard.guard_observe(js, jcfg, loss=loss,
                                  grads={"g": jnp.asarray(g)},
                                  params={"w": jnp.asarray([NAN])})
        _assert_state_equal(ts, js, f"step {i}")
    fin = tguard.guard_observe(ts, tcfg, loss=1.0, grads_finite=False)
    jfin = jguard.guard_observe(js, jcfg, loss=1.0, grads_finite=False)
    _assert_state_equal(fin, jfin, "grads_finite")
    with pytest.raises(ValueError):
        tguard.guard_init(tguard.GuardConfig(window=3), device="cpu")


#: (dtype, values) leaves of the finite probe's trees; None = clean
_FINITE_CASES = {
    "clean": None,
    "nan_last_f32": ("float32", -1, NAN),
    "neg_inf_f16": ("float16", 5, -INF),
    "f16_at_its_max": ("float16", 0, 65504.0),
    "nan_bf16": ("bfloat16", 17, NAN),
    "huge_f32": ("float32", 3, 3e38),
}


@pytest.mark.parametrize("case", list(_FINITE_CASES))
def test_finite_probe_matches_jax(case):
    """The guard's copy-free finite probe (one foreach inf-norm a dtype)
    against the JAX package's ``tree_all_finite`` on the same tree: f32,
    fp16 and bf16 leaves, an empty leaf and an int leaf, a NaN or an inf
    at one element, and finite values at and near each dtype's largest."""
    from apex_tpu.utils import tree_all_finite as j_all_finite
    from apex_tpu_torch.guard.detect import _all_finite
    rng = np.random.RandomState(3)
    base = {"a": ("float32", rng.randn(7, 5)),
            "b": ("float16", rng.randn(9)),
            "c": ("bfloat16", rng.randn(4, 6)),
            "d": ("float32", rng.randn(11)),
            "e": ("float32", np.zeros((0, 3))), "f": ("int32", np.arange(4))}
    spec = _FINITE_CASES[case]
    if spec is not None:
        dt, i, v = spec
        key = next(k for k, (d, _) in base.items() if d == dt)
        arr = base[key][1].astype(np.float64)
        arr.reshape(-1)[i] = v
        base[key] = (dt, arr)
    ttree = {k: torch.tensor(a.astype(np.float32 if d == "bfloat16" else d))
             .to(getattr(torch, d)) for k, (d, a) in base.items()}
    jtree = {k: jnp.asarray(a.astype(np.float32 if d == "bfloat16" else d))
             .astype(getattr(jnp, d)) for k, (d, a) in base.items()}
    got = _all_finite(ttree)
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) == bool(j_all_finite(jtree)) == (
        case in ("clean", "f16_at_its_max", "huge_f32")), case


def test_nanmedian_is_the_midpoint_rule():
    from apex_tpu_torch.guard.detect import nanmedian
    a = torch.tensor([1.0, 2.0, 3.0, 4.0, NAN])
    assert float(nanmedian(a)) == float(jnp.nanmedian(jnp.asarray(
        a.numpy()))) == 2.5
    assert float(torch.nanmedian(a)) == 2.0          # why the port has one
    assert torch.isnan(nanmedian(torch.full((4,), NAN)))


# --- the policy ladder --------------------------------------------------------

class StubSource:
    """Duck-typed cursor-bearing source (as ``tests/test_guard.py``)."""

    def __init__(self, per_epoch=10):
        self.per = per_epoch
        self.e = self.b = 0

    def state(self):
        return {"epoch": self.e, "batch": self.b}

    def load_state(self, c):
        self.e, self.b = int(c["epoch"]), int(c["batch"])

    def cursor_index(self):
        return self.e * self.per + self.b

    def skip_batches(self, n):
        for _ in range(int(n)):
            self.b += 1
            if self.b >= self.per:
                self.e += 1
                self.b = 0


def _policy_run(side, tmp):
    """One scripted run of the ladder on ``side`` ("jax" or "torch"):
    returns (actions, events, the cursor after each rewind, restored
    steps)."""
    G, C = (jguard, jckpt) if side == "jax" else (tguard, tckpt)
    cfg = G.GuardConfig(**CFG)
    if side == "jax":
        gs = G.guard_init(cfg)
        arr, nan_at = jnp.asarray, (lambda w: w.at[0].set(NAN))
    else:
        gs = G.guard_init(cfg, device="cpu")
        arr = torch.tensor

        def nan_at(w):
            w = w.clone()
            w[0] = NAN
            return w
    events = []
    mgr = C.CheckpointManager(str(tmp), keep=5)
    pol = G.GuardPolicy(manager=mgr, event_sink=events.append,
                        skip_budget=2, skip_window=16, cooldown_steps=4,
                        rewind_budget=2)
    src = StubSource()
    w = arr(np.arange(4.0, dtype=np.float32))
    actions, cursors, restored_steps = [], [], []
    losses = ([1.0 - 0.01 * i for i in range(6)] + [70.0, 1.0, 70.0, 71.0]
              + [0.9 - 0.01 * i for i in range(4)] + [0.8] * 4)
    for i, loss in enumerate(losses):
        src.skip_batches(1)
        params = {"w": nan_at(w) if i == 15 else w}
        gs = G.guard_observe(gs, cfg, loss=loss, grad_norm=1.0,
                             params=params)
        act = pol.update(i, gs)
        actions.append((act.kind, act.classes))
        if i in (3, 11):
            mgr.save(i, {"w": w, "gs": gs}, extra={"cursor": src.state()})
            mgr.wait()
        if i == 12:
            mgr.save(i, {"w": w, "gs": gs}, extra={"cursor": src.state()})
            mgr.wait()
            G.ChaosHarness.truncate_latest_checkpoint(mgr.root)
        if act.kind == "rewind":
            restored, mf = pol.rewind(i, {"w": params["w"], "gs": gs}, src,
                                      reason=act.reason)
            w, gs = restored["w"], restored["gs"]
            cursors.append(src.cursor_index())
            restored_steps.append(int(mf["step"]))
    pol.rewinds_done = pol.rewind_budget
    gs = G.guard_observe(gs, cfg, loss=loss, grad_norm=1.0,
                         params={"w": nan_at(w)})
    actions.append((pol.update(len(losses), gs).kind, ()))
    with pytest.raises(G.GuardEscalation):
        pol.escalate("test")
    clean = [{k: v for k, v in e.items() if k not in ("wall_time", "path")}
             for e in events]
    return actions, clean, cursors, restored_steps


def test_policy_actions_and_events_match_jax(tmp_path):
    t = _policy_run("torch", tmp_path / "t")
    j = _policy_run("jax", tmp_path / "j")
    assert t[0] == j[0]
    assert t[1] == j[1]
    assert t[2] == j[2] and t[3] == j[3]
    kinds = [k for k, _ in t[0]]
    assert "skip" in kinds and kinds.count("rewind") == 2
    assert kinds[-1] == "escalate"
    rewinds = [e for e in t[1] if e["kind"] == "guard_rewind"]
    assert [e["fallbacks"] for e in rewinds] == [0, 1]


# --- Amp.step(guard=) ---------------------------------------------------------

VOCAB, HIDDEN, LAYERS, HEADS, SEQ, BATCH = 1000, 64, 2, 2, 64, 2
SPIKE_AT = 5


def test_amp_step_guard_matches_jax_on_tiny_bert():
    jenc = jmodels.BertEncoder(VOCAB, hidden=HIDDEN, layers=LAYERS,
                               heads=HEADS, max_len=SEQ)
    params = jenc.init(jax.random.PRNGKey(0),
                       jnp.zeros((1, SEQ), jnp.int32))["params"]
    tenc = tmodels.BertEncoder(VOCAB, hidden=HIDDEN, layers=LAYERS,
                               heads=HEADS, max_len=SEQ, device="cpu")
    tenc.load_state_dict(params_from_jax(params, device="cpu"))
    rng = np.random.RandomState(0)
    toks = rng.randint(0, VOCAB, (BATCH, SEQ))
    labels = rng.randint(0, VOCAB, (BATCH, SEQ))
    gcfg = dict(window=8, min_history=4)

    jpol = jamp.Policy.from_opt_level("O0")
    japp = jamp.Amp(jpol, JLAMB(lr=1e-3, strategy="arena"))
    jcfg = jguard.GuardConfig(**gcfg)
    jt, jl = jnp.asarray(toks, jnp.int32), jnp.asarray(labels, jnp.int32)

    @jax.jit
    def jstep(state, gs, factor):
        def loss_fn(mp):
            return jmodels.mlm_loss(jenc, {"params": mp}, jt, jl) * factor
        state, loss, committed, gs = japp.step(state, loss_fn,
                                               guard=(gs, jcfg))
        return state, gs, loss, committed

    tpol = tamp.Policy.from_opt_level("O0")
    tapp = tamp.Amp(tpol, TLAMB(lr=1e-3, strategy="arena"))
    tcfg = tguard.GuardConfig(**gcfg)
    tt, tl = torch.as_tensor(toks), torch.as_tensor(labels)

    def tstep(state, gs, factor):
        def loss_fn(mp):
            return tmodels.mlm_loss(tenc, mp, tt, tl) * factor
        state, loss, committed, gs = tapp.step(state, loss_fn,
                                               guard=(gs, tcfg))
        return state, gs, loss, committed

    js, jgs = japp.init(params), jguard.guard_init(jcfg)
    ts = tapp.init(dict(tenc.named_parameters()))
    tgs = tguard.guard_init(tcfg, device="cpu")
    for i in range(SPIKE_AT + 2):
        factor = 1000.0 if i == SPIKE_AT else 1.0
        prev = ts
        js, jgs, jloss, jc = jstep(js, jgs, jnp.float32(factor))
        ts, tgs, tloss, tc = tstep(ts, tgs, factor)
        assert isinstance(tc, torch.Tensor) and tc.dtype == torch.bool
        assert bool(tc) == bool(jc) == (i != SPIKE_AT), i
        for f in ("anomaly", "count", "step", "skip_count", "spike_count",
                  "grad_explosion_count", "lr_tracker", "consecutive",
                  "pos"):
            assert int(getattr(tgs, f)) == int(getattr(jgs, f)), (i, f)
        assert float(tgs.lr_scale) == float(jgs.lr_scale), i
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=2e-2)
        assert int(ts.step) == int(js.step)
        if i == SPIKE_AT:
            for k in prev.params:
                assert torch.equal(ts.params[k], prev.params[k]), k
            for slot, bufs in prev.opt_state.slots.items():
                for dt, b in bufs.items():
                    assert torch.equal(ts.opt_state.slots[slot][dt], b)
            assert int(ts.step) == int(prev.step)
    # the attention's key bias has a gradient of rounding noise alone (the
    # softmax is shift-invariant), which LAMB's normalized update moves by
    # O(lr) either way: params agree within 1e-4 of each tensor's largest
    # magnitude plus 1% of the learning rate
    want = params_from_jax(js.params, device="cpu")
    for k, v in ts.params.items():
        w = want[k].numpy()
        np.testing.assert_allclose(v.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max() + 1e-2 * 1e-3,
                                   err_msg=k)


def test_amp_step_guard_skips_nan_grads_without_a_scaler():
    """bf16 O1 has no loss scaler, so amp's finite flag is the Python
    True: the guard takes finiteness from the true norm and skips."""
    pol = tamp.Policy.from_opt_level("O1")
    app = tamp.Amp(pol, TLAMB(lr=1e-3, strategy="arena"))
    state = app.init({"w": torch.ones(4, 3), "b": torch.zeros(3)})
    cfg = tguard.GuardConfig(window=4, min_history=2)
    gs = tguard.guard_init(cfg, device="cpu")

    def loss_fn(mp, poison):
        y = (mp["w"].float() * mp["b"].float().sum()).sum() + mp["w"].sum()
        return y + (mp["w"] * poison).sum()
    nxt, loss, committed, gs = app.step(state, loss_fn, 0.0,
                                        guard=(gs, cfg))
    assert bool(committed) and int(nxt.step) == 1
    bad, loss, committed, gs = app.step(nxt, loss_fn, float("nan"),
                                        guard=(gs, cfg))
    assert not bool(committed)
    assert tguard.anomaly_classes(int(gs.anomaly)) == ["nonfinite_grad",
                                                       "nonfinite_loss"]
    assert int(bad.step) == 1
    assert all(torch.equal(bad.params[k], nxt.params[k]) for k in nxt.params)


# --- chaos --------------------------------------------------------------------

@pytest.mark.parametrize("seed,ranks", [(0, 1), (7, 3), (123, 2)])
def test_fault_plan_random_matches_jax(seed, ranks):
    rates = {"grads:nan": 0.05, "batch:corrupt": 0.03,
             "params:bitflip_mantissa": 0.02, "ckpt:truncate": 0.01}
    t = tguard.FaultPlan.random(seed, 300, rates=rates, ranks=ranks)
    j = jguard.FaultPlan.random(seed, 300, rates=rates, ranks=ranks)
    assert t.to_json() == j.to_json()
    assert tguard.FaultPlan.from_json(j.to_json()) == t
    assert [t.fault_code(s, r) for s in range(300) for r in range(ranks)] \
        == [j.fault_code(s, r) for s in range(300) for r in range(ranks)]
    with pytest.raises(ValueError):
        tguard.FaultPlan.random(seed, 10, rates={"grads:nan": 0.1,
                                                 "grads:inf": 0.1})


def test_injections_match_jax():
    g = np.arange(6, dtype=np.float32).reshape(2, 3) + 1.0
    for code in (0, tguard.chaos.C_GRAD_NAN, tguard.chaos.C_GRAD_INF):
        got = tguard.inject_grads({"g": torch.tensor(g),
                                   "i": torch.tensor([3])}, code)
        want = jguard.inject_grads({"g": jnp.asarray(g),
                                    "i": jnp.asarray([3])}, code)
        np.testing.assert_array_equal(got["g"].numpy(), np.asarray(want["g"]))
        assert int(got["i"][0]) == 3
    got = tguard.inject_activation(torch.tensor(g), torch.tensor(
        tguard.chaos.C_ACT_NAN, dtype=torch.int32))
    want = jguard.inject_activation(jnp.asarray(g), tguard.chaos.C_ACT_NAN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plan = [tguard.Fault(2, "batch", "corrupt", 0, 50.0),
            tguard.Fault(3, "batch", "overflow", 0, 10.0),
            tguard.Fault(4, "batch", "nan")]
    th = tguard.ChaosHarness(tguard.FaultPlan(plan, seed=5))
    jh = jguard.ChaosHarness(jguard.FaultPlan(
        [jguard.Fault(*f) for f in plan], seed=5))
    x = np.ones((2, 3), np.float32)
    for step in (1, 2, 3, 4):
        np.testing.assert_array_equal(
            th.filter_batch(step, (torch.tensor(x), 0))[0].numpy(),
            jh.filter_batch(step, (x, 0))[0])
    assert th.injected == jh.injected
    with pytest.raises(ValueError, match="membership"):
        tguard.ChaosHarness(tguard.FaultPlan(
            [tguard.Fault(0, "cluster", "lease_expire")])).post_step(0, {})


@pytest.mark.parametrize("kind,arg", [("nan", 0.0), ("bitflip", 0.0),
                                      ("bitflip_mantissa", 5.0)])
def test_param_faults_match_jax(kind, arg):
    w = np.linspace(0.5, 2.0, 6, dtype=np.float32)
    plan = [tguard.Fault(1, "params", kind, 0, arg)]
    got = tguard.ChaosHarness(tguard.FaultPlan(plan)).post_step(
        1, {"a": torch.tensor(w), "b": torch.tensor(w)})
    want = jguard.ChaosHarness(jguard.FaultPlan(
        [jguard.Fault(*f) for f in plan])).post_step(
        1, {"a": jnp.asarray(w), "b": jnp.asarray(w)})
    for k in ("a", "b"):
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), k


@pytest.mark.parametrize("kind", ["nan", "bitflip", "bitflip_mantissa"])
def test_param_faults_on_a_permuted_leaf(kind):
    """A params fault on a leaf kept in a permuted (non-contiguous) layout,
    as a conv weight is: element 0 is poisoned, the rest and the layout
    are kept."""
    leaf = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) + 1
    leaf = leaf.permute(2, 0, 1)
    assert not leaf.is_contiguous()
    f = tguard.Fault(3, "params", kind, arg=5)
    out = tguard.ChaosHarness(tguard.FaultPlan([f]))._corrupt_params(
        {"w": leaf}, f)["w"]
    assert out.stride() == leaf.stride()
    assert torch.equal(out.reshape(-1)[1:], leaf.reshape(-1)[1:])
    if kind == "nan":
        assert torch.isnan(out[0, 0, 0])
    else:
        bit = 5 if kind == "bitflip" else 5 % 23
        want = leaf[0, 0, 0].view(torch.int32) ^ (1 << bit)
        assert out[0, 0, 0].view(torch.int32) == want
