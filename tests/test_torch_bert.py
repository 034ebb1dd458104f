"""The port's BERT MLM training step against the JAX package's.

A structural BERT (vocab 1000, hidden 128, 2 layers, 2 heads, seq 64,
batch 2) is built by flax, and its weights are carried to the port by
``params_from_jax``; inputs come from the same
``np.random.RandomState(0)`` draws on both sides. The JAX side runs its
Pallas kernels in interpret mode; the port runs its plain versions.

- O0: loss and grads match at 1e-4 (fp32 end to end; the loss runs outside
  ``auto_cast``, which in both packages casts Dense/Embed to half under any
  enabled policy).
- O1 bf16: 3 steps of the full step (``bench._bert_step_builder`` vs
  ``train.build_bert_step``) keep the loss trajectory within 2e-2 relative.
- O1 fp16 with an injected overflow: scaler decisions (finite flag, loss
  scale) and ``step`` match bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import bench
from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu.optim import FusedLAMB as JLAMB
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import models as tmodels
from apex_tpu_torch import train
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.optim import FusedLAMB as TLAMB

VOCAB, HIDDEN, LAYERS, HEADS, SEQ, BATCH = 1000, 128, 2, 2, 64, 2


def _encoders():
    jenc = jmodels.BertEncoder(VOCAB, hidden=HIDDEN, layers=LAYERS,
                               heads=HEADS, max_len=SEQ)
    toks = jnp.zeros((1, SEQ), jnp.int32)
    params = jenc.init(jax.random.PRNGKey(0), toks)["params"]
    tenc = tmodels.BertEncoder(VOCAB, hidden=HIDDEN, layers=LAYERS,
                               heads=HEADS, max_len=SEQ, device="cpu")
    tenc.load_state_dict(params_from_jax(params, device="cpu"))
    return jenc, params, tenc


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, VOCAB, (BATCH, SEQ)),
            rng.randint(0, VOCAB, (BATCH, SEQ)))


def test_param_names_map_one_to_one():
    _, params, tenc = _encoders()
    carried = params_from_jax(params, device="cpu")
    assert set(carried) == {n for n, _ in tenc.named_parameters()}
    n_jax = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(p.numel() for p in tenc.parameters())


def test_o0_loss_and_grads_match():
    jenc, params, tenc = _encoders()
    toks, labels = _batch()
    jtoks, jlab = jnp.asarray(toks, jnp.int32), jnp.asarray(labels, jnp.int32)
    japp = jamp.Amp(jamp.Policy.from_opt_level("O0"), JLAMB(strategy="tree"))
    jstate = japp.init(params)
    jloss, jgrads, _, _ = japp.backward(
        jstate, lambda mp: jmodels.mlm_loss(jenc, {"params": mp}, jtoks,
                                            jlab))
    tapp = tamp.Amp(tamp.Policy.from_opt_level("O0"), TLAMB())
    tstate = tapp.init(dict(tenc.named_parameters()))
    ttoks, tlab = torch.as_tensor(toks), torch.as_tensor(labels)
    tloss, tgrads, _, finite = tapp.backward(
        tstate, lambda mp: tmodels.mlm_loss(tenc, mp, ttoks, tlab))
    assert finite is True
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4,
                               atol=1e-4)
    want = params_from_jax(jgrads, device="cpu")
    assert set(want) == set(tgrads)
    for name, g in want.items():
        assert tgrads[name].dtype == torch.float32
        np.testing.assert_allclose(tgrads[name].numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_o1_bf16_three_steps_track_jax():
    jenc, _, tenc = _encoders()
    jstep, jstate, (jtoks, jlab), _, _, jvars = bench._bert_step_builder(
        BATCH, SEQ, encoder=jenc, vocab=VOCAB)
    tenc.load_state_dict(params_from_jax(jvars["params"], device="cpu"))
    tstep, tstate, (ttoks, tlab), policy, _ = train.build_bert_step(
        BATCH, SEQ, encoder=tenc, device="cpu", vocab=VOCAB)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    assert policy.half_dtype == torch.bfloat16 and policy.loss_scale is None
    jstep = jax.jit(jstep)
    jl, tl = [], []
    for _ in range(3):
        jstate, jloss = jstep(jstate, jtoks, jlab)
        tstate, tloss = tstep(tstate, ttoks, tlab)
        jl.append(float(jloss))
        tl.append(tloss.item())
    assert int(tstate.step) == int(jstate.step) == 3
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert tl[-1] < tl[0]


def test_o1_fp16_overflow_decisions_bitwise():
    jenc, params, tenc = _encoders()
    toks, labels = _batch()
    jtoks, jlab = jnp.asarray(toks, jnp.int32), jnp.asarray(labels, jnp.int32)
    ttoks, tlab = torch.as_tensor(toks), torch.as_tensor(labels)
    jpol = jamp.Policy.from_opt_level("O1", half_dtype=jnp.float16)
    tpol = tamp.Policy.from_opt_level("O1", half_dtype=torch.float16)
    japp = jamp.Amp(jpol, JLAMB(strategy="tree"))
    tapp = tamp.Amp(tpol, TLAMB())
    jstate = japp.init(params)
    tstate = tapp.init(dict(tenc.named_parameters()))

    @jax.jit
    def jstep(state, inject):
        def loss_fn(mp):
            with jamp.auto_cast(jpol):
                loss = jmodels.mlm_loss(jenc, {"params": mp}, jtoks, jlab)
            return loss * jnp.where(inject, jnp.inf, 1.0)
        loss, grads, state, finite = japp.backward(state, loss_fn)
        return japp.apply_gradients(state, grads, finite), loss, finite

    for i, inject in enumerate([False, True, False, False]):
        def tloss_fn(mp):
            with tamp.auto_cast(tpol):
                loss = tmodels.mlm_loss(tenc, mp, ttoks, tlab)
            return loss * float("inf") if inject else loss

        before = {k: v.clone() for k, v in tstate.params.items()}
        jstate, jloss, jfin = jstep(jstate, jnp.bool_(inject))
        tloss, grads, tstate, tfin = tapp.backward(tstate, tloss_fn)
        tstate = tapp.apply_gradients(tstate, grads, tfin)
        assert bool(tfin) == bool(jfin) == (not inject), i
        assert np.float32(tstate.scalers[0].loss_scale.item()).tobytes() == \
            np.asarray(jstate.scalers[0].loss_scale, np.float32).tobytes()
        assert int(tstate.scalers[0].growth_tracker) == \
            int(jstate.scalers[0].growth_tracker)
        assert int(tstate.step) == int(jstate.step)
        assert int(tstate.opt_state.count) == int(jstate.opt_state.count)
        if inject:
            assert all(torch.equal(tstate.params[k], before[k])
                       for k in before)
        else:
            np.testing.assert_allclose(tloss.item(), float(jloss), rtol=2e-2)
    assert int(tstate.step) == 3
    assert tstate.scalers[0].loss_scale.item() == 2.0 ** 15
