"""The port's RNN stacks (``models.rnn``) against the JAX package's.

Every cell kind (LSTM, GRU, tanh, ReLU, mLSTM), 2 layers, one-way and
bidirectional, with the flax params carried by ``rnn_params_from_jax``:
the output, the input gradient and every param gradient in f32 (atol
1e-5). Under ``auto_cast(O1)`` (bf16) the LSTM, GRU and mLSTM stacks'
output agrees within 2e-2 of its max magnitude and their gradients within
5e-2 of each tensor's (they run back through T steps of bf16-rounded
gates, whose sums the two packages round in other orders); the simple
cells raise a TypeError in both packages (their carry comes out in bf16,
which flax's scan refuses). Dropout between layers
(not after the last) keeps within 5σ of the binomial and is the port's
formula on the mask its generator draws. Inputs (B, T, D) from numpy
seeds.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.models import rnn as JR
from apex_tpu_torch import amp as tamp
from apex_tpu_torch.convert import rnn_params_from_jax
from apex_tpu_torch.models import rnn as TR

JO1 = jamp.Policy.from_opt_level("O1")
TO1 = tamp.Policy.from_opt_level("O1")
D_IN, HID, B, T = 6, 8, 3, 5
KINDS = ["lstm", "gru", "tanh", "relu", "mlstm"]
FACTORY = {"lstm": "LSTM", "gru": "GRU", "tanh": "Tanh", "relu": "ReLU",
           "mlstm": "mLSTM"}


def _pair(kind, bidirectional, layers=2, dropout=0.0):
    jm = getattr(JR, FACTORY[kind])(D_IN, HID, layers, bidirectional,
                                    dropout)
    x = np.random.RandomState(0).randn(B, T, D_IN).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    tm = getattr(TR, FACTORY[kind])(D_IN, HID, layers, bidirectional,
                                    dropout, device="cpu")
    mapped = rnn_params_from_jax(params, device="cpu")
    assert set(mapped) == set(tm.state_dict())
    tm.load_state_dict(mapped)
    return jm, params, tm, x


def _both(kind, bidirectional, level="O0"):
    jm, params, tm, x = _pair(kind, bidirectional)
    width = HID * (2 if bidirectional else 1)
    dy = np.random.RandomState(1).randn(B, T, width).astype(np.float32)
    jscope = tscope = contextlib.nullcontext
    if level == "O1":
        jscope = functools.partial(jamp.auto_cast, JO1)
        tscope = functools.partial(tamp.auto_cast, TO1)

    def jloss(p, xx):
        with jscope():
            y = jm.apply({"params": p}, xx)
        return jnp.sum(y.astype(jnp.float32) * dy), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    tx = torch.tensor(x).requires_grad_(True)
    with tscope():
        ty = tm(tx)
    (ty.float() * torch.tensor(dy)).sum().backward()
    got = {"y": ty.detach().float().numpy(), "dx": tx.grad.numpy(),
           **{n: p.grad.numpy() for n, p in tm.named_parameters()}}
    want = {"y": np.asarray(jy, np.float32), "dx": np.asarray(jgx),
            **{n: t.numpy() for n, t in
               rnn_params_from_jax(jgp, device="cpu").items()}}
    return got, want


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_stack_matches_jax(kind, bidirectional):
    got, want = _both(kind, bidirectional)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=1e-5, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["lstm", "gru", "mlstm"])
def test_o1_matches_jax(kind):
    got, want = _both(kind, kind == "gru", level="O1")
    for name, w in want.items():
        tol = 2e-2 if name == "y" else 5e-2
        np.testing.assert_allclose(got[name], w,
                                   atol=tol * np.abs(w).max(), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["tanh", "relu"])
def test_o1_simple_cells_refuse_as_jax(kind):
    jm, params, tm, x = _pair(kind, False)
    with pytest.raises(TypeError):
        with jamp.auto_cast(jamp.Policy.from_opt_level("O1")):
            jm.apply({"params": params}, jnp.asarray(x))
    with pytest.raises(TypeError, match="carry"):
        with tamp.auto_cast(tamp.Policy.from_opt_level("O1")):
            tm(torch.tensor(x))


def test_inter_layer_dropout_by_formula_and_in_distribution():
    rate = 0.4
    _, _, tm, x = _pair("lstm", False, layers=3, dropout=rate)
    xt = torch.tensor(np.random.RandomState(3).randn(64, T, D_IN)
                      .astype(np.float32))
    g = torch.Generator().manual_seed(4)
    state = g.get_state()
    with torch.no_grad():
        got = tm(xt, deterministic=False, generator=g)
        g2 = torch.Generator().manual_seed(4)
        g2.set_state(state)
        h, keeps = xt, []
        for layer in range(3):
            h = TR.run_cell(getattr(tm, f"LSTMCell_{layer}"), h)
            if layer < 2:       # dropout between layers, not after the last
                keep = torch.rand(h.shape, generator=g2) < 1 - rate
                keeps.append(keep)
                h = torch.where(keep, h / (1 - rate), 0.0)
    np.testing.assert_array_equal(got.numpy(), h.numpy())
    keep = torch.cat([k.flatten() for k in keeps])
    n, kept = keep.numel(), int(keep.sum())
    assert abs(kept - n * (1 - rate)) < 5 * np.sqrt(n * rate * (1 - rate))
    with torch.no_grad():
        np.testing.assert_array_equal(tm(xt).numpy(),
                                      tm(xt, deterministic=True).numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_factories_build_the_cells(kind):
    m = getattr(TR, FACTORY[kind])(D_IN, HID, num_layers=2,
                                   bidirectional=True, device="cpu")
    cls = {"lstm": TR.LSTMCell, "gru": TR.GRUCell, "tanh": TR.SimpleCell,
           "relu": TR.SimpleCell, "mlstm": TR.mLSTMCell}[kind]
    cells = [c for c in m.children()]
    assert len(cells) == 4 and all(type(c) is cls for c in cells)
    assert cells[2].in_features == 2 * HID
    with pytest.raises(ValueError, match="unknown cell"):
        TR.StackedRNN("lstmx", D_IN, HID, device="cpu")


@pytest.mark.parametrize("kind", ["lstm", "gru", "mlstm"])
def test_o1_saves_one_cast_of_each_weight(kind):
    """Under ``auto_cast(O1)`` a layer's time loop casts each Dense weight
    to bf16 once: autograd saves one bf16 copy of every weight for the
    backward, not one a time step (T copies of the byte mLSTM's 85M
    weights would grow its memory with T). Each step's gradient still adds
    up in the f32 param, so the gradients equal, bit for bit, those of a
    loop whose every step casts."""
    _, _, tm, x = _pair(kind, False, layers=1)
    shapes = {tuple(p.shape) for n, p in tm.named_parameters()
              if n.endswith("weight")}
    saved = {}

    def pack(t):
        # a product saves the weight or its transpose
        if t.dtype == torch.bfloat16 and (tuple(t.shape) in shapes or
                                          tuple(t.shape)[::-1] in shapes):
            saved[t.data_ptr()] = tuple(t.shape)
        return t

    dy = torch.tensor(np.random.RandomState(1).randn(B, T, HID)
                      .astype(np.float32))
    grads = {}
    for mode in ("once", "each step"):
        tx = torch.tensor(x).requires_grad_(True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            with tamp.auto_cast(TO1):
                if mode == "once":
                    saved.clear()
                    y = tm(tx)
                else:
                    cell = next(iter(tm.children()))
                    carry, ys = cell.initialize_carry(tx), []
                    for t in range(T):
                        carry, out = cell(carry, tx[:, t])
                        ys.append(out)
                    y = torch.stack(ys, dim=1)
        if mode == "once":
            n_saved = len(saved)
        names, params = zip(*tm.named_parameters())
        g = torch.autograd.grad((y.float() * dy).sum(), (tx, *params))
        grads[mode] = dict(zip(("dx", *names), g))
    n_weights = sum(n.endswith("weight") for n, _ in tm.named_parameters())
    assert T > 1 and n_saved == n_weights, (n_saved, n_weights)
    for name, want in grads["each step"].items():
        assert torch.equal(grads["once"][name], want), name
