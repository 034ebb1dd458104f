"""BERT trained as published, the port against the JAX package: padding
masks and attention dropout 0.1 through ``train.build_bert_step(...,
encoder=<an encoder with dropout 0.1>, padded=True)``.

A 2-layer, 128-wide BERT (vocab 1000, 2 heads, seq 256, batch 2) is built
by flax and carried to the port by ``params_from_jax``. Tokens, labels and
lengths come from the same ``np.random.RandomState(0)`` draws on both
sides (lengths from [128, 256], labels -1 past a sequence's end). The JAX
step is built from the package's public pieces: ``BertEncoder(tokens,
attn_mask, deterministic=False)``, the tied-embedding head and fused CE of
``mlm_loss``, ``Amp`` with ``FusedLAMB(lr=1e-3)``. Both packages'
``_softmax_dropout`` are replaced inside the test to hand out the same
int32 seed to each layer, so both draw the same keep masks.

- O0: loss and grads match at 1e-4 (fp32 end to end; the loss runs outside
  ``auto_cast``, which in both packages casts Dense/Embed to half under any
  enabled policy).
- O1 bf16: 3 steps of the full step keep the loss trajectory within 2e-2
  relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.func import functional_call

import apex_tpu.ops.multihead_attn as JMHA
import apex_tpu_torch.ops.multihead_attn as TMHA
from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu import ops as jops
from apex_tpu.optim import FusedLAMB as JLAMB
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import models as tmodels
from apex_tpu_torch import train
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models.transformer import _mlm_head
from apex_tpu_torch.optim import FusedLAMB as TLAMB

VOCAB, HIDDEN, LAYERS, HEADS, SEQ, BATCH = 1000, 128, 2, 2, 256, 2
SEEDS = (-2023406815, 1234567)     # one dropout seed per layer


def _same_seeds(monkeypatch):
    """Both packages' ``_softmax_dropout`` hand out SEEDS by layer."""
    calls = {"jax": 0, "torch": 0}

    def nxt(side):
        seed = SEEDS[calls[side] % len(SEEDS)]
        calls[side] += 1
        return seed

    def jax_seeds(mod, rate, deterministic):
        if rate <= 0 or deterministic:
            return 0.0, None
        return rate, jnp.int32(nxt("jax"))

    def torch_seeds(rate, deterministic, generator, device):
        if rate <= 0 or deterministic:
            return 0.0, None
        return rate, torch.tensor([nxt("torch")], dtype=torch.int32,
                                  device=device)

    monkeypatch.setattr(JMHA, "_softmax_dropout", jax_seeds)
    monkeypatch.setattr(TMHA, "_softmax_dropout", torch_seeds)
    return calls


def _setup(opt_level):
    jenc = jmodels.BertEncoder(VOCAB, hidden=HIDDEN, layers=LAYERS,
                               heads=HEADS, max_len=SEQ, dropout=0.1)
    params = jenc.init(jax.random.PRNGKey(0),
                       jnp.zeros((1, SEQ), jnp.int32))["params"]
    tenc = tmodels.BertEncoder(VOCAB, hidden=HIDDEN, layers=LAYERS,
                               heads=HEADS, max_len=SEQ, dropout=0.1,
                               device="cpu")
    tenc.load_state_dict(params_from_jax(params, device="cpu"))
    tstep, tstate, (ttoks, tlab), policy, _ = train.build_bert_step(
        BATCH, SEQ, encoder=tenc, device="cpu", vocab=VOCAB,
        opt_level=opt_level, padded=True)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, VOCAB, (BATCH, SEQ))
    labels = rng.randint(0, VOCAB, (BATCH, SEQ))
    lengths = rng.randint(128, SEQ + 1, BATCH)
    mask = np.arange(SEQ) < lengths[:, None]
    labels = np.where(mask, labels, -1)
    np.testing.assert_array_equal(ttoks.numpy(), toks)
    np.testing.assert_array_equal(tlab.numpy(), labels)
    np.testing.assert_array_equal(tstep.attn_mask.numpy(), mask)
    assert 0 < (labels < 0).sum() < labels.size
    return (jenc, params, tenc, (tstep, tstate, policy),
            tuple(jnp.asarray(x, jnp.int32) for x in (toks, labels, mask)))


def _jax_loss(jenc, jtoks, jlab, jmask):
    def loss(mp):
        hidden = jenc.apply({"params": mp}, jtoks, jmask, deterministic=False)
        emb = mp["tok_emb"]["embedding"]
        logits = hidden @ emb.T.astype(hidden.dtype)
        losses = jops.softmax_cross_entropy_loss(logits, jlab, 0.0)
        return jnp.sum(losses) / jnp.maximum(jnp.sum(jlab >= 0), 1)
    return loss


def test_o0_loss_and_grads_match(monkeypatch):
    _same_seeds(monkeypatch)
    jenc, params, tenc, (tstep, _, _), (jtoks, jlab, jmask) = _setup("O0")
    japp = jamp.Amp(jamp.Policy.from_opt_level("O0"), JLAMB(strategy="tree"))
    jloss, jgrads, _, _ = japp.backward(japp.init(params),
                                        _jax_loss(jenc, jtoks, jlab, jmask))
    tapp = tamp.Amp(tamp.Policy.from_opt_level("O0"), TLAMB())
    ttoks, tlab = torch.tensor(np.asarray(jtoks)).long(), \
        torch.tensor(np.asarray(jlab)).long()

    def tloss_fn(mp):
        hidden = functional_call(tenc, mp, (ttoks, tstep.attn_mask),
                                 {"deterministic": False,
                                  "generator": tstep.generator})
        return _mlm_head(hidden, mp["tok_emb.weight"], tlab)

    tloss, tgrads, _, finite = tapp.backward(
        tapp.init(dict(tenc.named_parameters())), tloss_fn)
    assert finite is True
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4,
                               atol=1e-4)
    want = params_from_jax(jgrads, device="cpu")
    assert set(want) == set(tgrads)
    for name, g in want.items():
        np.testing.assert_allclose(tgrads[name].numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_o1_bf16_three_steps_track_jax(monkeypatch):
    calls = _same_seeds(monkeypatch)
    jenc, params, _, (tstep, tstate, policy), (jtoks, jlab, jmask) = \
        _setup("O1")
    assert policy.half_dtype == torch.bfloat16
    jpol = jamp.Policy.from_opt_level("O1")
    japp = jamp.Amp(jpol, JLAMB(lr=1e-3))
    loss_fn = _jax_loss(jenc, jtoks, jlab, jmask)

    @jax.jit
    def jstep(state):
        def lf(mp):
            with jamp.auto_cast(jpol):
                return loss_fn(mp)
        loss, grads, state, finite = japp.backward(state, lf)
        return japp.apply_gradients(state, grads, finite), loss

    jstate = japp.init(params)
    ttoks, tlab = torch.tensor(np.asarray(jtoks)).long(), \
        torch.tensor(np.asarray(jlab)).long()
    jl, tl = [], []
    for _ in range(3):
        jstate, jloss = jstep(jstate)
        tstate, tloss = tstep(tstate, ttoks, tlab)
        jl.append(float(jloss))
        tl.append(tloss.item())
    assert calls["torch"] == 3 * LAYERS
    assert calls["jax"] > 0 and calls["jax"] % LAYERS == 0
    assert int(tstate.step) == int(jstate.step) == 3
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert all(np.isfinite(tl))
