"""Parity of the port's Adagrad (``ops.adagrad_update``,
``optim.FusedAdagrad``) with the JAX package's.

- ``adagrad_update``'s plain version against the JAX ``adagrad_update``
  (its Pallas kernel in interpret mode) on one BUFFER_MULTIPLE-long
  buffer, in both weight-decay modes, on f32 and bf16 params, with a grad
  scale: f32 outputs at rtol 1e-6 with an atol of 1e-6 times the output's
  largest magnitude (the same f32 formulas; XLA on the CPU may contract a
  product and a sum into one rounding), a bf16 output within one bf16
  ulp.
- ``FusedAdagrad``, arena and tree, three steps against the JAX
  ``FusedAdagrad`` on a tree with f32 and bf16 leaves, at the same
  tolerance. The arena's slot buffers are compared per tensor after
  ``unflatten``: the packages order leaves differently.
- ``"auto"``'s 8M rule and the defaults (lr 1e-2, eps 1e-10, no weight
  decay, decay folded into the grad).
- A structural BERT (vocab 1000, hidden 128, 2 layers, 2 heads, seq 64,
  batch 2, O1 bf16) trained 3 steps by ``train.build_bert_step(optimizer=
  FusedAdagrad(...))`` against a JAX step built the same way from
  ``amp.Amp`` and the JAX ``FusedAdagrad``: the step counts equal, the
  losses within 2e-2 relative (``tests/test_torch_bert.py``'s tolerance
  for this model under O1 bf16: bf16 GEMMs round in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import arena as JA
from apex_tpu import models as jmodels
from apex_tpu.ops import optim_kernels as JK
from apex_tpu.optim import FusedAdagrad as JAdagrad
from apex_tpu_torch import arena as TA
from apex_tpu_torch import models as tmodels
from apex_tpu_torch import ops, train
from apex_tpu_torch.arena import BUFFER_MULTIPLE
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.ops import optim_kernels as TK
from apex_tpu_torch.optim import FusedAdagrad as TAdagrad

N = BUFFER_MULTIPLE
_ULP_BF16 = 2.0 ** -7


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, rtol=1e-6):
    got, want = np32(got), np32(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * np.abs(want).max())


def within_bf16_ulp(got, want):
    got, want = np32(got), np32(want)
    assert np.all(np.abs(got - want) <= np.abs(want) * _ULP_BF16)


def close_param(got, want):
    """A param at its dtype's tolerance."""
    if got.dtype == torch.bfloat16:
        within_bf16_ulp(got, want)
    else:
        close(got, want)


def _buffers(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(N).astype(np.float32),
            (rng.randn(N) * 3.0).astype(np.float32),
            np.abs(rng.randn(N) * 0.1).astype(np.float32))


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("adagrad_w_mode", [False, True])
def test_adagrad_update_matches_jax(adagrad_w_mode, p_dtype):
    p, g, h = _buffers(0)
    tp = torch.tensor(p).to(getattr(torch, p_dtype))
    jp = jnp.asarray(np32(tp), p_dtype)
    kw = dict(lr=1e-2, eps=1e-10, weight_decay=0.01,
              adagrad_w_mode=adagrad_w_mode, grad_scale=0.5)
    want = JK.adagrad_update(jp, jnp.asarray(g), jnp.asarray(h), **kw)
    got = TK.adagrad_update(tp, torch.tensor(g), torch.tensor(h), **kw)
    assert [t.dtype for t in got] == [tp.dtype, torch.float32]
    close_param(got[0], want[0])
    close(got[1], want[1])


def test_adagrad_update_device_scalars():
    """lr and the grad scale as 0-d tensors, as an optimizer and amp pass
    them from the device."""
    p, g, h = _buffers(1)
    kw = dict(eps=1e-8, weight_decay=1e-4)
    want = JK.adagrad_update(*(jnp.asarray(x) for x in (p, g, h)),
                             lr=jnp.float32(3e-2),
                             grad_scale=jnp.float32(0.25), **kw)
    got = TK.adagrad_update(*(torch.tensor(x) for x in (p, g, h)),
                            lr=torch.tensor(3e-2),
                            grad_scale=torch.tensor(0.25), **kw)
    for a, b in zip(got, want):
        close(a, b)


_SHAPES = {"w1": (16, 8), "b1": (8,), "k": (4, 4, 3, 5), "scale": (5,)}
_BF16 = {"b1", "k"}
_KWARGS = [
    dict(),
    dict(lr=0.05, weight_decay=1e-3),
    dict(lr=0.05, weight_decay=1e-3, adagrad_w_mode=True),
    dict(lr=0.2, eps=1e-6),
]


def three_steps(jopt, topt, strategy, slot_names, seed=0, shapes=_SHAPES,
                bf16=_BF16):
    """Three steps of ``jopt`` and ``topt`` on the same params (``bf16``
    leaves in bf16) and grads; returns the port's and JAX's (params,
    state, per-tensor buffer slots)."""
    rng = np.random.RandomState(seed)
    vals = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32)
          for k, v in vals.items()}
    tp = {k: torch.tensor(v).to(torch.bfloat16 if k in bf16 else
                                torch.float32) for k, v in vals.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        grads = {k: (rng.randn(*s) * 3.0).astype(np.float32)
                 for k, s in shapes.items()}
        jp, js = jopt.step({k: jnp.asarray(v) for k, v in grads.items()},
                           js, jp)
        tp, ts = topt.step({k: torch.tensor(v) for k, v in grads.items()},
                           ts, tp)
    if strategy == "arena":
        tspec, jspec = TA.plan(tp), JA.plan(jp)
        tslots = {s: TA.unflatten(ts.slots[s], tspec) for s in slot_names}
        jslots = {s: JA.unflatten(js.slots[s], jspec) for s in slot_names}
    else:
        tslots = {s: ts.slots[s] for s in slot_names}
        jslots = {s: js.slots[s] for s in slot_names}
    return (tp, ts, tslots), (jp, js, jslots)


@pytest.mark.parametrize("strategy", ["tree", "arena"])
@pytest.mark.parametrize("kw", _KWARGS)
def test_three_steps_match_jax(kw, strategy):
    (tp, ts, tslots), (jp, js, jslots) = three_steps(
        JAdagrad(strategy=strategy, **kw), TAdagrad(strategy=strategy, **kw),
        strategy, ("h",))
    assert int(ts.count) == int(js.count) == 3
    if strategy == "arena":
        assert set(ts.slots["h"]) == set(js.slots["h"]) == {"bfloat16",
                                                            "float32"}
    for k in _SHAPES:
        assert tp[k].dtype == (torch.bfloat16 if k in _BF16
                               else torch.float32)
        close_param(tp[k], jp[k])
        assert tslots["h"][k].dtype == torch.float32
        close(tslots["h"][k], jslots["h"][k])


@pytest.mark.parametrize("kw", _KWARGS)
def test_arena_matches_tree_in_the_port(kw):
    """The same elementwise f32 formulas: p and h at the JAX tolerance."""
    (ap, _, aslots), _ = three_steps(
        JAdagrad(strategy="arena", **kw), TAdagrad(strategy="arena", **kw),
        "arena", ("h",))
    (tp, _, tslots), _ = three_steps(
        JAdagrad(strategy="tree", **kw), TAdagrad(strategy="tree", **kw),
        "tree", ("h",))
    for k in _SHAPES:
        close_param(ap[k], tp[k])
        close(aslots["h"][k], tslots["h"][k])


def test_defaults_and_auto_rule():
    """The JAX package's defaults, and ``"auto"``'s 8M rule: the arena
    below ``TREE_THRESHOLD`` params, the tree from there up; inputs stay
    untouched."""
    topt = TAdagrad()
    jopt = JAdagrad()
    assert (topt.lr, topt.eps, topt.weight_decay, topt.adagrad_w_mode,
            topt.strategy) == (jopt.lr, jopt.eps, jopt.weight_decay,
                               jopt.adagrad_w_mode, jopt.strategy) == (
        1e-2, 1e-10, 0.0, False, "auto")
    assert TAdagrad.TREE_THRESHOLD == JAdagrad.TREE_THRESHOLD == 8_000_000
    p = {"w": torch.ones(3)}
    st0 = topt.init(p)
    assert set(st0.slots) == {"h"}
    assert st0.slots["h"]["float32"].numel() == BUFFER_MULTIPLE   # arena
    new_p, st = topt.step({"w": torch.full((3,), 0.5)}, st0, p)
    assert int(st.count) == 1 and torch.all(new_p["w"] < 1.0)
    assert torch.equal(p["w"], torch.ones(3))
    assert not st0.slots["h"]["float32"].any()
    big = {"w": torch.zeros(TAdagrad.TREE_THRESHOLD - 8), "b": torch.zeros(8)}
    assert set(topt.init(big).slots["h"]) == {"w", "b"}           # tree
    assert not topt._use_tree({"w": torch.zeros(8_000_000 - 1)})
    with pytest.raises(ValueError):
        TAdagrad(strategy="flat")


def test_adagrad_kernel_refuses_cpu_tensors():
    before = ops.launch_counts()
    x = torch.ones(N)
    with pytest.raises(ValueError):
        TK.adagrad_kernel(x, x, x, torch.ones(4), False)
    assert ops.launch_counts() == before
    assert ops.KERNELS["adagrad"] is TK.adagrad_kernel


# --- a structural BERT trained through build_bert_step -----------------------

VOCAB, HIDDEN, LAYERS, HEADS, SEQ, BATCH = 1000, 128, 2, 2, 64, 2


def bert_runs(jtx, ttx, steps=3, half="bfloat16", inject=()):
    """``steps`` O1 steps of a structural BERT on both sides, the JAX step
    built as ``bench._bert_step_builder`` builds it with ``jtx`` in place
    of FusedLAMB, the port's by ``train.build_bert_step(optimizer=ttx)``,
    from the same flax weights and ``RandomState(0)`` batch. ``half``
    names the half dtype (fp16 brings dynamic loss scaling); ``inject``
    lists the steps whose loss is multiplied by inf. Returns per step the
    (JAX, port) states and losses, and JAX's finite flag."""
    jenc = jmodels.BertEncoder(VOCAB, hidden=HIDDEN, layers=LAYERS,
                               heads=HEADS, max_len=SEQ)
    tenc = tmodels.BertEncoder(VOCAB, hidden=HIDDEN, layers=LAYERS,
                               heads=HEADS, max_len=SEQ, device="cpu")
    jhalf, thalf = getattr(jnp, half), getattr(torch, half)
    policy = jamp.Policy.from_opt_level("O1", half_dtype=jhalf)
    rng = np.random.RandomState(0)
    toks = jnp.asarray(rng.randint(0, VOCAB, (BATCH, SEQ)), jnp.int32)
    labels = jnp.asarray(rng.randint(0, VOCAB, (BATCH, SEQ)), jnp.int32)
    variables = jenc.init(jax.random.PRNGKey(0), toks[:1])
    amp_opt = jamp.Amp(policy, jtx)
    jstate = amp_opt.init(variables["params"])

    @jax.jit
    def jstep(state, bad):
        def loss_fn(mp):
            with jamp.auto_cast(policy):
                loss = jmodels.mlm_loss(jenc, {"params": mp}, toks, labels)
            return loss * jnp.where(bad, jnp.inf, 1.0)
        loss, grads, state, finite = amp_opt.backward(state, loss_fn)
        return amp_opt.apply_gradients(state, grads, finite), loss, finite

    tenc.load_state_dict(params_from_jax(variables["params"], device="cpu"))
    tstep, tstate, (ttoks, tlab), tpol, _ = train.build_bert_step(
        BATCH, SEQ, encoder=tenc, device="cpu", vocab=VOCAB,
        half_dtype=thalf, optimizer=ttx)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(toks))
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(labels))
    out = []
    for i in range(steps):
        bad = i in inject
        jstate, jloss, jfin = jstep(jstate, jnp.bool_(bad))
        if bad:
            before = tstate
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(train, "_mlm_head", _inf_head)
                tstate, tloss = tstep(tstate, ttoks, tlab)
            assert all(torch.equal(tstate.params[k], before.params[k])
                       for k in before.params)
        else:
            tstate, tloss = tstep(tstate, ttoks, tlab)
        out.append(((jstate, float(jloss), bool(jfin)),
                    (tstate, tloss.item())))
    return out


def _inf_head(*args):
    from apex_tpu_torch.models.transformer import _mlm_head
    return _mlm_head(*args) * float("inf")


@pytest.mark.parametrize("strategy", ["arena", "tree"])
def test_bert_o1_three_steps_track_jax(strategy):
    kw = dict(lr=1e-2, weight_decay=1e-4, strategy=strategy)
    runs = bert_runs(JAdagrad(**kw), TAdagrad(**kw))
    (js, _, _), (ts, _) = runs[-1]
    assert int(ts.step) == int(js.step) == 3
    assert int(ts.opt_state.count) == int(js.opt_state.count) == 3
    assert ("float32" in ts.opt_state.slots["h"]) == (strategy == "arena")
    jl = [j[1] for j, _ in runs]
    tl = [t[1] for _, t in runs]
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]


def test_build_bert_step_takes_one_optimizer_option():
    enc = tmodels.BertEncoder(VOCAB, hidden=16, layers=1, heads=2,
                              max_len=8, device="cpu")
    with pytest.raises(ValueError, match="strategy"):
        train.build_bert_step(1, 8, encoder=enc, device="cpu",
                              strategy="arena", optimizer=TAdagrad())
    opt = TAdagrad(lr=0.1)
    step, state, (toks, labels), _, _ = train.build_bert_step(
        1, 8, encoder=enc, device="cpu", optimizer=opt)
    assert set(state.opt_state.slots) == {"h"}
    state, loss = step(state, toks, labels)
    assert int(state.step) == 1 and np.isfinite(loss.item())
