"""The training-step builders of the attention and model-layer remainder
(``train.build_transformer_step``, ``build_rnn_step``,
``build_mha_train_step`` and ``build_mha_perf_test``) on the CPU, at small
widths.

- the pre-LN stack's first-step loss (O1 bf16, padding mask) against the
  JAX package's ``TransformerLayer(pre_ln=True)`` stack on the same
  weights, inputs, mask and target (relative 1e-3: the mean of bf16
  outputs that agree within 2e-2 of their max; measured 7e-5);
- an RNN stack's first-step loss under O1 against the JAX package's stack
  on the same weights and data (relative 1e-3; measured 2e-5 and 2e-4),
  and the steps that follow
  apply their updates;
- the MHA benchmark's stack: the fast path against ``impl="default"``
  (the reference script's ``--ref``) at ``deterministic=True`` within
  fp16 rounding (2e-2 of the output's max), the encdec stack's shape; the
  O2 training step's first loss is the MSE of the stack's forward at the
  O2-cast params (relative 1e-6), and its steps apply their updates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from apex_tpu import amp as jamp
from apex_tpu.models import rnn as JR
from apex_tpu.models import transformer as JT
from apex_tpu_torch import train
from apex_tpu_torch.convert import (jax_name, rnn_params_from_jax,
                                    to_jax_layout)
from apex_tpu_torch.models import rnn as TR

JO1 = jamp.Policy.from_opt_level("O1")
LOSS_TOL = 1e-3


def _jax_tree(named, prefix=""):
    """The JAX package's params tree of the port leaves under ``prefix``."""
    tree = {}
    for name, t in named:
        if not name.startswith(prefix):
            continue
        name = name[len(prefix):]
        node = tree
        *path, leaf = jax_name(name).split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(to_jax_layout(name, t.detach()).numpy())
    return tree


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_transformer_step_first_loss_matches_jax():
    layers, hidden, heads, ffn, batch, seq = 2, 32, 2, 64, 3, 136
    step, state, (x, mask, target), _, model = train.build_transformer_step(
        batch, seq, layers, hidden, heads, ffn, dropout=0.0, device="cpu")
    lengths = mask.sum(dim=-1).flatten()
    assert mask.shape == (batch, 1, 1, seq)
    assert bool((lengths >= 128).all() and (lengths <= seq).all())
    assert bool((lengths < seq).any())          # some padding in the batch
    named = list(model.named_parameters())
    jm = JT.TransformerLayer(hidden, heads, ffn, pre_ln=True)
    y = jnp.asarray(x.numpy())
    with jamp.auto_cast(JO1):
        for i in range(layers):
            y = jm.apply({"params": _jax_tree(named, f"layers.{i}.")}, y,
                         jnp.asarray(mask.numpy()))
    want = float(jnp.mean(jnp.square(y.astype(jnp.float32)
                                     - jnp.asarray(target.numpy()))))
    w0 = named[0][1].detach().clone()
    losses = []
    for _ in range(3):
        state, loss = step(state)
        losses.append(loss.item())
    assert _rel(losses[0], want) <= LOSS_TOL, (losses[0], want)
    assert all(np.isfinite(losses)) and int(state.step) == 3
    assert not torch.equal(state.params[named[0][0]], w0)


@pytest.mark.parametrize("kind", ["LSTM", "mLSTM"])
def test_rnn_step_first_loss_matches_jax(kind):
    d_in, hid, batch, seq = 6, 8, 3, 5
    x0 = np.zeros((batch, seq, d_in), np.float32)
    jm = getattr(JR, kind)(d_in, hid, 2, False, 0.0)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x0))["params"]
    tm = getattr(TR, kind)(d_in, hid, 2, device="cpu")
    tm.load_state_dict(rnn_params_from_jax(params, device="cpu"))
    step, state, (x, target), _, _ = train.build_rnn_step(
        tm, batch, seq, d_in, device="cpu")
    with jamp.auto_cast(JO1):
        y = jm.apply({"params": params}, jnp.asarray(x.numpy()))
    want = float(jnp.mean(jnp.square(y.astype(jnp.float32)
                                     - jnp.asarray(target.numpy()))))
    state, l0 = step(state)
    state, l1 = step(state)
    assert _rel(l0.item(), want) <= LOSS_TOL, (l0.item(), want)
    assert np.isfinite(l1.item()) and int(state.step) == 2


def test_mha_perf_test_fast_matches_default():
    shape = dict(batch=4, seq=16, layers=2, hidden=32, heads=2,
                 device="cpu")
    outs = {}
    for impl in ("fast", "default"):
        run, params, inputs = train.build_mha_perf_test(impl=impl, **shape)
        assert all(p.dtype == torch.float16 for p in params.values())
        with torch.no_grad():
            outs[impl] = run(params, deterministic=True).float()
    ref = outs["default"]
    assert ref.shape == (4, 16, 32) and torch.isfinite(ref).all()
    err = (outs["fast"] - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item(), err
    run, params, inputs = train.build_mha_perf_test(encdec=True, **shape)
    assert len(inputs) == 2
    with torch.no_grad():
        assert run(params).shape == (4, 16, 32)


def test_mha_train_step_first_loss_and_updates():
    step, state, (x, target), policy, stack = train.build_mha_train_step(
        4, 16, 2, 32, 2, dropout=0.0, device="cpu")
    assert x.dtype == torch.float16
    with torch.no_grad():
        y = functional_call(stack, policy.cast_params(
            dict(stack.named_parameters())), (x,), dict(deterministic=True))
    want = torch.mean(torch.square(y.float() - target)).item()
    name, p0 = next(iter(stack.named_parameters()))
    p0 = p0.detach().clone()
    losses = []
    for _ in range(3):
        state, loss = step(state)
        losses.append(loss.item())
    assert _rel(losses[0], want) <= 1e-6, (losses[0], want)
    assert all(np.isfinite(losses)) and int(state.step) >= 1
    assert not torch.equal(state.params[name], p0)
