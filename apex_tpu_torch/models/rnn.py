"""RNN stacks: ``apex.RNN`` as the JAX package's ``models/rnn.py`` has it.

Port of ``apex_tpu/models/rnn.py``: the cells its ``_make_cell`` takes,
with flax's arithmetic, gate order and parameter names (flax's
``LSTMCell``, ``GRUCell`` and ``SimpleCell``, and the package's own
multiplicative ``mLSTMCell``), a Python loop over the time steps of each
layer (as the reference Apex's ``RNNBackend.py`` runs it), multi-layer and
bidirectional stacks with dropout between layers, and the factories
``LSTM``, ``GRU``, ``Tanh``, ``ReLU`` and ``mLSTM``. Inputs are (B, T, D),
batch first.

Names follow flax's construction-order naming: a stack's cells are
``<Cell>_<i>`` in the order they are built (for a bidirectional layer the
forward cell, then the backward one), and each cell's Dense layers carry
flax's names (``ii``/``hi``/... for the LSTM, ``ir``/``hr``/... for the
GRU, ``i``/``h`` for the simple cell, ``wmx``/``wmh``/``wx``/``wm`` for
the mLSTM), so :func:`apex_tpu_torch.convert.rnn_params_from_jax` maps a
flax tree onto the port's names. The Dense layers are the port's
:class:`~apex_tpu_torch.models.transformer.Dense`: HALF modules under
``auto_cast``, as flax's ``nn.Dense`` are under the JAX package's
interceptor; a layer's time loop casts each Dense's weights to the
compute dtype once, not once a step (as flax's scan hoists a cast that
does not change across steps), so the copies autograd saves do not grow
with T. The carry starts as f32 zeros and must keep its dtype from
step to step, as flax's scan demands: a simple cell under O1, whose carry
comes out in the half dtype, raises a TypeError there and here.

No cell holds a hand kernel: the JAX cells are flax Dense layers and jnp,
so the cells' products stay cuBLAS's.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from apex_tpu_torch.models.layers import lecun_normal_
from apex_tpu_torch.models.transformer import Dense
from apex_tpu_torch.ops.attention import dropout as _dropout


class _Cell(nn.Module):
    """Dense layers by flax name, flax's initializers and the f32 carry."""

    #: (name, input side ("i") or recurrent side ("h"), bias, width factor)
    DENSES: tuple = ()
    #: recurrent kernels orthogonal (flax's cells) or lecun-normal (mLSTM)
    RECURRENT_ORTHOGONAL = True

    def __init__(self, in_features: int, features: int, device="cuda"):
        super().__init__()
        self.in_features, self.features = in_features, features
        for name, side, bias, mult in self.DENSES:
            fan_in = in_features if side == "i" else features
            self.add_module(name, Dense(fan_in, mult * features, bias=bias,
                                        device=device))

    def denses(self, casts=None):
        """``dense(name, x)``: the Dense layer ``name`` on x. ``casts`` is
        the dict a time loop keeps for one forward (see :class:`Dense`)."""
        def dense(name, x):
            return self._modules[name](
                x, None if casts is None else casts.setdefault(name, {}))
        return dense

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults: lecun-normal input kernels, orthogonal
        recurrent kernels, zero biases."""
        for name, side, _, _ in self.DENSES:
            d = self._modules[name]
            if side == "h" and self.RECURRENT_ORTHOGONAL:
                nn.init.orthogonal_(d.weight, generator=generator)
            else:
                lecun_normal_(d.weight, d.in_features, generator)
            if d.bias is not None:
                d.bias.zero_()

    def initialize_carry(self, x):
        return torch.zeros(x.shape[0], self.features, dtype=torch.float32,
                           device=x.device)


class LSTMCell(_Cell):
    """flax's ``nn.LSTMCell``: gates i, f, g, o each from a bias-free
    input Dense plus a biased recurrent one; carry (c, h)."""

    DENSES = tuple((f"{s}{g}", s, s == "h", 1) for g in "ifgo"
                   for s in "ih")

    def initialize_carry(self, x):
        return (super().initialize_carry(x), super().initialize_carry(x))

    def forward(self, carry, x, casts=None):
        c, h = carry
        d = self.denses(casts)
        i = torch.sigmoid(d("ii", x) + d("hi", h))
        f = torch.sigmoid(d("if", x) + d("hf", h))
        g = torch.tanh(d("ig", x) + d("hg", h))
        o = torch.sigmoid(d("io", x) + d("ho", h))
        new_c = f * c + i * g
        new_h = o * torch.tanh(new_c)
        return (new_c, new_h), new_h


class GRUCell(_Cell):
    """flax's ``nn.GRUCell``: biased input Denses, bias-free recurrent
    ones but ``hn``; h' = (1 − z)·n + z·h."""

    DENSES = (("ir", "i", True, 1), ("hr", "h", False, 1),
              ("iz", "i", True, 1), ("hz", "h", False, 1),
              ("in", "i", True, 1), ("hn", "h", True, 1))

    def forward(self, h, x, casts=None):
        d = self.denses(casts)
        r = torch.sigmoid(d("ir", x) + d("hr", h))
        z = torch.sigmoid(d("iz", x) + d("hz", h))
        n = torch.tanh(d("in", x) + r * d("hn", h))
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h


class SimpleCell(_Cell):
    """flax's ``nn.SimpleCell``: h' = act(W_i x + b_i + W_h h), ``act``
    tanh or relu."""

    DENSES = (("i", "i", True, 1), ("h", "h", False, 1))

    def __init__(self, in_features: int, features: int, activation="tanh",
                 device="cuda"):
        super().__init__(in_features, features, device=device)
        self.activation = {"tanh": torch.tanh, "relu": torch.relu}[activation]

    def forward(self, h, x, casts=None):
        d = self.denses(casts)
        new_h = self.activation(d("i", x) + d("h", h))
        return new_h, new_h


class mLSTMCell(_Cell):  # noqa: N801 (the JAX package's name)
    """The multiplicative LSTM (the reference Apex's ``mLSTMRNNCell``): m =
    (Wmx·x) ⊙ (Wmh·h) replaces h in the gates; every Dense is flax's
    default (lecun-normal kernel)."""

    DENSES = (("wmx", "i", False, 1), ("wmh", "h", False, 1),
              ("wx", "i", True, 4), ("wm", "h", True, 4))
    RECURRENT_ORTHOGONAL = False

    def initialize_carry(self, x):
        return (super().initialize_carry(x), super().initialize_carry(x))

    def forward(self, carry, x, casts=None):
        c, h = carry
        d = self.denses(casts)
        m = d("wmx", x) * d("wmh", h)
        i, f, g, o = (d("wx", x) + d("wm", m)).chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        new_c = f * c + i * g
        new_h = o * torch.tanh(new_c)
        return (new_c, new_h), new_h


_CELLS = {"lstm": LSTMCell, "gru": GRUCell, "tanh": SimpleCell,
          "relu": SimpleCell, "mlstm": mLSTMCell}


def _make_cell(kind: str, in_features: int, hidden: int, device):
    if kind not in _CELLS:
        raise ValueError(f"unknown cell {kind!r}")
    if kind in ("tanh", "relu"):
        return SimpleCell(in_features, hidden, activation=kind,
                          device=device)
    return _CELLS[kind](in_features, hidden, device=device)


def _dtypes(carry):
    return tuple(t.dtype for t in (carry if isinstance(carry, tuple)
                                   else (carry,)))


def run_cell(cell, x, reverse: bool = False):
    """flax's ``nn.RNN(cell)`` over x (B, T, D): the carry from
    ``cell.initialize_carry``, one cell call a time step, outputs stacked
    along T; ``reverse`` walks the steps from the last, and the outputs
    keep the input's order (flax's ``keep_order=True``). Each Dense's
    weights are cast once for the whole loop."""
    carry = cell.initialize_carry(x)
    casts = {}
    want = _dtypes(carry)
    steps = range(x.shape[1])
    outs = [None] * x.shape[1]
    for t in (reversed(steps) if reverse else steps):
        carry, outs[t] = cell(carry, x[:, t], casts)
        if _dtypes(carry) != want:
            raise TypeError(f"{type(cell).__name__}: the carry came out as "
                            f"{_dtypes(carry)} from {want}; the carry must "
                            f"keep its dtype from step to step")
    return torch.stack(outs, dim=1)


class StackedRNN(nn.Module):
    """Multi-layer, optionally bidirectional RNN over (B, T, D) inputs (the
    reference's ``stackedRNN``/``bidirectionalRNN``). A bidirectional layer
    concatenates the forward and the backward cell's outputs; dropout
    ``dropout`` acts between layers, not after the last, with its keep
    masks drawn from ``generator`` when ``deterministic=False``."""

    def __init__(self, cell_type: str, input_size: int, hidden: int,
                 num_layers: int = 1, bidirectional: bool = False,
                 dropout: float = 0.0, device="cuda", seed: int = 0):
        super().__init__()
        self.cell_type, self.hidden = cell_type, hidden
        self.num_layers, self.bidirectional = num_layers, bidirectional
        self.dropout = dropout
        self.layer_cells = []
        counts = {}
        width = input_size
        for _ in range(num_layers):
            names = []
            for _ in range(2 if bidirectional else 1):
                cell = _make_cell(cell_type, width, hidden, device)
                cls = type(cell).__name__
                name = f"{cls}_{counts.get(cls, 0)}"
                counts[cls] = counts.get(cls, 0) + 1
                self.add_module(name, cell)
                names.append(name)
            self.layer_cells.append(names)
            width = hidden * len(names)
        if torch.device(device).type != "meta":
            self.reset_parameters(torch.Generator(device).manual_seed(seed))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for names in self.layer_cells:
            for name in names:
                self._modules[name].reset_parameters(generator)

    def forward(self, x, deterministic: bool = True, generator=None):
        for layer, names in enumerate(self.layer_cells):
            outs = [run_cell(self._modules[n], x, reverse=j == 1)
                    for j, n in enumerate(names)]
            x = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
            if (self.dropout > 0 and not deterministic
                    and layer < self.num_layers - 1):
                x = _dropout(x, self.dropout, generator)
        return x


def _factory(kind):
    def make(input_size: int, hidden_size: int, num_layers: int = 1,
             bidirectional: bool = False, dropout: float = 0.0,
             device="cuda", seed: int = 0) -> StackedRNN:
        return StackedRNN(kind, input_size, hidden_size, num_layers,
                          bidirectional, dropout, device=device, seed=seed)
    make.__name__ = make.__qualname__ = {
        "lstm": "LSTM", "gru": "GRU", "tanh": "Tanh", "relu": "ReLU",
        "mlstm": "mLSTM"}[kind]
    make.__doc__ = (f"``apex.RNN.{make.__name__}``: a {kind} "
                    f":class:`StackedRNN`. Unlike the JAX package's, which "
                    f"drops it (flax infers widths), ``input_size`` sets "
                    f"the first layer's width.")
    return make


LSTM = _factory("lstm")
GRU = _factory("gru")
Tanh = _factory("tanh")
ReLU = _factory("relu")
mLSTM = _factory("mlstm")
