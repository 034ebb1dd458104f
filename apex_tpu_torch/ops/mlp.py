"""Fused MLP: the whole Linear(+bias)(+activation) stack in one CUDA kernel.

Port of ``apex_tpu/ops/mlp.py``. Kernel replaced (source under
``apex_tpu_torch/csrc/``):

- ``mlp_fwd_kernel`` (``mlp_fwd.cu``) ← ``_mlp_kernel`` (the pallas_call in
  ``_fused_mlp_fwd_impl``): ``act(…act(x·W₀ + b₀)·W₁ + b₁…)`` in f32
  throughout, one cast to x's dtype at the end. A block keeps its 16
  rows' activations in shared memory through every layer, computes 4 rows
  x up to 4 columns a thread and stages the weights through shared memory
  with ``cp.async``; a width too large for that runs one launch per layer
  over an f32 workspace.

Under amp O1 the JAX package's functional patch casts both operands of the
kernel body's ``jnp.dot`` (and of ``mlp_reference``'s) to the policy's half
dtype. The port's :func:`fused_mlp` and :func:`mlp_reference` read that
dtype from :func:`apex_tpu_torch.amp.functional_patch.half_operand_dtype`
(the innermost O1 ``auto_cast`` on this thread, unless suspended) and round
each product's operands to it, summing in f32 as before: the kernel's
half-operand mode (``operand_dtype``), and the same rounding in its plain
version.

As in the JAX package, the kernel is taken only when the weights fit its
budget (``WEIGHT_BUDGET``: the weights' element count at 4 bytes each,
whatever their dtype, ``<=`` 8 MiB); over it ``fused_mlp`` computes
:func:`mlp_reference`, which rounds to x's dtype after every layer. That
choice decides the function computed, on the CPU and on the card alike, and
launches nothing. The backward is the autograd of :func:`mlp_reference`
recomputed from (x, W, b), as the JAX package's ``_mlp_bwd``: its products
are plain ``torch.matmul``, as the JAX package leaves them to XLA, with the
operands rounded as the mode stands when the backward runs (off once the
user's ``auto_cast`` block has closed, as in JAX, whose ``_mlp_bwd`` is
traced when ``jax.grad`` transposes, after the block).

The parameters keep the JAX layout: ``weight_i`` is (Dᵢ, Dᵢ₊₁), not
``nn.Linear``'s (out, in), so ``convert`` carries them across as they are.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import Sequence

import torch
import torch.nn as nn

from apex_tpu_torch.amp import functional_patch
from apex_tpu_torch.ops import _build, autotune
from apex_tpu_torch.ops._priced import priced

#: bytes of f32 weights the kernel takes (``_VMEM_WEIGHT_BUDGET``)
WEIGHT_BUDGET = 8 << 20
#: widest layer (rounded up to 4) the fused kernel keeps in shared memory:
#: two f32 buffers of its 16 rows beside its two 32 KB weight stages,
#: within the 227 KB opt-in (``kMaxLd``)
FUSED_MAX_WIDTH = 1284
#: layers one launch of the fused kernel runs (``kMaxLayers``)
MAX_LAYERS = 32

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ACT_CODES = {"none": 0, "relu": 1, "sigmoid": 2}


def _relu(x):
    # jnp.maximum(x, 0.0): its gradient at a tie is 0.5, as torch.maximum's
    # (torch.relu's is 0)
    return torch.maximum(x, x.new_zeros(()))


def _sigmoid(x):
    # jax.nn.sigmoid in a 16-bit dtype rounds after each of exp, add and
    # divide (XLA on the CPU); torch.sigmoid would round once
    if x.dtype in (torch.bfloat16, torch.float16):
        return 1.0 / (1.0 + torch.exp(-x))
    return torch.sigmoid(x)


_ACTS = {"none": lambda x: x, "relu": _relu, "sigmoid": _sigmoid}


def _check_activation(activation):
    if activation not in _ACTS:
        raise ValueError(f"unknown activation {activation!r}")


def weights_fit(weights) -> bool:
    """The JAX package's ``_weights_fit_vmem``: every weight counted at 4
    bytes an element, against ``WEIGHT_BUDGET`` with ``<=``."""
    return sum(w.numel() for w in weights) * 4 <= WEIGHT_BUDGET


def _operand(t, operand_dtype):
    """f32 ``t`` rounded to ``operand_dtype`` (round to nearest even) and
    widened back, or ``t`` as it is for None."""
    return t if operand_dtype is None else t.to(operand_dtype).float()


def mlp_reference(x, weights, biases=None, activation="relu"):
    """The plain chain (``mlp.py:68``): each layer's product in f32 rounded
    to x's dtype, the bias added in that dtype, the activation after every
    layer including the last. Under an O1 ``auto_cast`` each product's
    operands are first rounded to the policy's half dtype, as the JAX
    package's patched ``jnp.dot`` casts them."""
    _check_activation(activation)
    act = _ACTS[activation]
    od = functional_patch.half_operand_dtype()
    h = x
    with functional_patch.suspend():
        for i, w in enumerate(weights):
            h = torch.matmul(_operand(h.float(), od),
                             _operand(w.float(), od)).to(x.dtype)
            if biases is not None:
                h = h + biases[i].to(h.dtype)
            h = act(h)
    return h


@priced("mlp_fwd")
def mlp_fused_reference(x, weights, biases=None, activation="relu",
                        operand_dtype=None):
    """The kernel's plain version (``_mlp_kernel``): f32 throughout, one
    cast to x's dtype at the end.

    ``operand_dtype`` (bf16 or fp16) is the kernel's half-operand mode:
    each product's two operands rounded to that dtype first. Their products
    are then exact in f32, so summing them one k at a time in increasing k,
    as the kernel's FMA chain does, gives the kernel's sums bit for bit;
    a matrix product would sum in another order, and with every layer's
    output rounded to half for the next, a sum a bit apart can round to
    the neighbouring half value and carry a whole half ulp forward."""
    _check_activation(activation)
    act = _ACTS[activation]
    h = x.float()
    if operand_dtype is None:
        with functional_patch.suspend():
            for i, w in enumerate(weights):
                h = torch.matmul(h, w.float())
                if biases is not None:
                    h = h + biases[i].float()
                h = act(h)
        return h.to(x.dtype)
    for i, w in enumerate(weights):
        a = _operand(h, operand_dtype)
        w = _operand(w.float(), operand_dtype)
        h = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32,
                        device=a.device)
        for k in range(w.shape[0]):
            h = h + a[:, k:k + 1] * w[k:k + 1]
        if biases is not None:
            h = h + biases[i].float()
        h = act(h)
    return h.to(x.dtype)


# --- the CUDA kernel ----------------------------------------------------------

#: ``MlpCall`` of ``csrc/mlp_fwd.cu``, field by field, every field 64 bits;
#: the layers' weight and bias addresses and widths follow it.
MLP_CALL_FIELDS = ("x", "y", "ws", "n", "layers", "x_dtype", "w_dtype",
                   "b_dtype", "act", "rnd")
_MLP_CALL = struct.Struct(f"<{len(MLP_CALL_FIELDS)}q")


@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry point ``apex_mlp_fwd(const MlpCall*, stream)``."""
    fn = _build.load("mlp_fwd").apex_mlp_fwd
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launches(dims) -> int:
    """Launches of one call: one per ``MAX_LAYERS`` layers while every
    width (rounded up to 4) fits the fused kernel, else one per layer."""
    layers = len(dims) - 1
    if -(-max(dims) // 4) * 4 <= FUSED_MAX_WIDTH:
        return -(-layers // MAX_LAYERS)
    return layers


def _workspace_cols(dims) -> int:
    """f32 columns of the (n, ·) workspace the launch plan needs: two
    buffers of the widest hidden layer when the layers run in more than one
    launch (:func:`_launches`), else none."""
    if _launches(dims) == 1:
        return 0
    return 2 * max(dims[1:-1])


@priced("mlp_fwd")
def mlp_fwd_kernel(x, weights, biases=None, activation="relu",
                   operand_dtype=None):
    """CUDA forward of an (n, D₀) x through every layer: (n, D_L) in x's
    dtype. x, the weights and the biases are contiguous tensors on one
    card; x f32, bf16 or fp16; the weights one of those dtypes together,
    each (Dᵢ, Dᵢ₊₁); the biases one dtype together, each (Dᵢ₊₁,).
    ``operand_dtype`` (bf16 or fp16) is the half-operand mode: each
    product's two operands rounded to it, summed in f32."""
    _check_activation(activation)
    if operand_dtype not in (None, torch.bfloat16, torch.float16):
        raise ValueError(f"operand_dtype must be None, bfloat16 or float16, "
                         f"got {operand_dtype}")
    weights = list(weights)
    if x.dim() != 2 or not weights:
        raise ValueError(f"mlp_fwd takes a 2-D x and at least one weight; "
                         f"got x {tuple(x.shape)}, {len(weights)} weights")
    biases = None if biases is None else list(biases)
    n, d0 = x.shape
    dims = [d0]
    for i, w in enumerate(weights):
        if w.dim() != 2 or w.shape[0] != dims[-1]:
            raise ValueError(f"weight {i} is {tuple(w.shape)}; expected "
                             f"({dims[-1]}, D)")
        if w.dtype != weights[0].dtype:
            raise ValueError("mlp_fwd takes weights of one dtype")
        dims.append(w.shape[1])
    if min(dims) == 0:
        raise ValueError(f"mlp_fwd takes widths > 0, got {dims}")
    if biases is not None and (len(biases) != len(weights) or any(
            b.shape != (d,) or b.dtype != biases[0].dtype
            for b, d in zip(biases, dims[1:]))):
        raise ValueError("mlp_fwd takes one (D_i+1,) bias a layer, all of "
                         "one dtype")
    _build.check_operands(x, *weights, *(biases or []),
                          dtypes=tuple(_DTYPES))
    y = torch.empty((n, dims[-1]), dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    # consulted and counted as the JAX package's seam is; the kernel takes
    # its whole plan from the widths, so a hit has no knob to set
    autotune.launch_knobs("mlp", (n, *dims), x.dtype)
    ws_cols = _workspace_cols(dims)
    ws = (torch.empty((n, ws_cols), dtype=torch.float32, device=x.device)
          if ws_cols else None)
    L = len(weights)
    call = _MLP_CALL.pack(
        x.data_ptr(), y.data_ptr(), 0 if ws is None else ws.data_ptr(), n, L,
        _DTYPES[x.dtype], _DTYPES[weights[0].dtype],
        0 if biases is None else _DTYPES[biases[0].dtype],
        _ACT_CODES[activation],
        0 if operand_dtype is None else _DTYPES[operand_dtype]) + struct.pack(
        f"<{3 * L + 1}q", *[w.data_ptr() for w in weights],
        *([b.data_ptr() for b in biases] if biases is not None else [0] * L),
        *dims)
    _build.check(_lib()(call, _build.stream_ptr(x)), "mlp_fwd")
    mlp_fwd_kernel.launches += _launches(dims)
    return y


mlp_fwd_kernel.launches = 0


# --- the op -------------------------------------------------------------------

class _FusedMLPFn(torch.autograd.Function):
    """Forward through the kernel (or its plain version on the CPU);
    backward: the vector-Jacobian product of :func:`mlp_reference`."""

    @staticmethod
    def forward(ctx, x, activation, n_layers, has_bias, operand_dtype,
                *params):
        weights = params[:n_layers]
        biases = params[n_layers:] if has_bias else None
        ctx.activation, ctx.n_layers, ctx.has_bias = (activation, n_layers,
                                                      has_bias)
        ctx.save_for_backward(x, *params)
        if x.is_cuda:
            y = mlp_fwd_kernel(x.contiguous(),
                               [w.contiguous() for w in weights],
                               None if biases is None
                               else [b.contiguous() for b in biases],
                               activation, operand_dtype)
        else:
            y = mlp_fused_reference(x, weights, biases, activation,
                                    operand_dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        L = ctx.n_layers
        inputs = [t.detach().requires_grad_(True) for t in (x, *params)]
        with torch.enable_grad():
            y = mlp_reference(inputs[0], inputs[1:L + 1],
                              inputs[L + 1:] if ctx.has_bias else None,
                              ctx.activation)
        grads = torch.autograd.grad(y, inputs, g)
        return (grads[0], None, None, None, None, *grads[1:])


def fused_mlp(x, weights, biases=None, activation="relu"):
    """Whole-MLP forward ``x @ W0 (+b0) act @ W1 (+b1) act ...`` over x's
    last dim; ``weights`` (Dᵢ, Dᵢ₊₁) matrices, ``biases`` a matching
    sequence or None. Within ``WEIGHT_BUDGET``: the kernel on a CUDA tensor,
    its plain version on a CPU one; over it: :func:`mlp_reference`. Under
    an O1 ``auto_cast`` the kernel runs in its half-operand mode at the
    policy's half dtype."""
    _check_activation(activation)
    weights = tuple(weights)
    if not weights_fit(weights):
        return mlp_reference(x, weights, biases, activation)
    lead, d0 = x.shape[:-1], x.shape[-1]
    params = weights + (tuple(biases) if biases is not None else ())
    y = _FusedMLPFn.apply(x.reshape(-1, d0), activation, len(weights),
                          biases is not None,
                          functional_patch.half_operand_dtype(), *params)
    return y.reshape(*lead, y.shape[-1])


class MLP(nn.Module):
    """``apex.mlp.MLP`` as the JAX package's flax module: ``MLP([in, h1,
    ..., out], bias=True, activation="relu")`` with params ``weight_i``
    (Dᵢ, Dᵢ₊₁) and ``bias_i``, initialised as the reference does (weights
    N(0, √(2/(fan_in + fan_out))), biases N(0, √(1/fan_out))) from a
    ``torch.Generator`` seeded with ``seed``. The activation follows every
    layer, the last included."""

    def __init__(self, mlp_sizes: Sequence[int], bias: bool = True,
                 activation: str = "relu", device="cuda", seed: int = 0):
        super().__init__()
        sizes = list(mlp_sizes)
        if len(sizes) < 2:
            raise ValueError("need at least [in, out] sizes")
        _check_activation(activation)
        self.sizes, self.bias, self.activation = sizes, bias, activation
        for i in range(len(sizes) - 1):
            self.register_parameter(f"weight_{i}", nn.Parameter(torch.empty(
                sizes[i], sizes[i + 1], device=device)))
            if bias:
                self.register_parameter(f"bias_{i}", nn.Parameter(
                    torch.empty(sizes[i + 1], device=device)))
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        dev = next(self.parameters()).device
        if dev.type == "meta":
            return
        gen = torch.Generator(dev).manual_seed(seed)
        s = self.sizes
        for i in range(len(s) - 1):
            getattr(self, f"weight_{i}").normal_(
                0.0, math.sqrt(2.0 / (s[i] + s[i + 1])), generator=gen)
            if self.bias:
                getattr(self, f"bias_{i}").normal_(
                    0.0, math.sqrt(1.0 / s[i + 1]), generator=gen)

    def forward(self, x):
        n = len(self.sizes) - 1
        weights = [getattr(self, f"weight_{i}") for i in range(n)]
        biases = ([getattr(self, f"bias_{i}") for i in range(n)]
                  if self.bias else None)
        return fused_mlp(x, weights, biases, self.activation)
