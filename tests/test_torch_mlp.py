"""Parity of the port's fused MLP (``apex_tpu_torch.ops.mlp``) with the JAX
package's (``apex_tpu.ops.mlp``, its Pallas kernel in interpret mode).

The same numpy inputs go to both. On the CPU the port's ``fused_mlp`` runs
the kernel's plain version (``mlp_fused_reference``: f32 throughout, one
cast at the end), the JAX one its kernel in interpret mode.

- Forward, f32: within 1e-5 of the output's largest magnitude (both sides
  run f32 chains, their sums in another order). bf16 x (with f32 and with
  bf16 weights): within one bf16 ulp, since each side rounds an f32 chain
  once; ``mlp_reference`` (rounded after every layer) within one bf16 ulp
  of the JAX ``mlp_reference``, which the fused path does not equal.
- Gradients of x, W and b at rtol 1e-3, atol 1e-4 (``compile_check.py``'s
  MLP case), f32; bf16 within 2% of each tensor's largest magnitude (the
  bf16 chain rounds each product, whose f32 sums run in another order).
- The 8 MiB budget decides the function: exactly 8 MiB of weights takes
  the kernel, a column more takes ``mlp_reference``, in both packages.
- ReLU at exactly 0 has gradient 0.5, as ``jnp.maximum``'s: a zero row, no
  bias.
- ``MLP``: names, shapes (the JAX layout), order, init statistics, its
  errors; flax params carried by ``convert.params_from_jax`` untransposed
  give the JAX module's outputs; ``auto_cast`` (O2) passes the module
  through.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import ops as jops
from apex_tpu.ops import mlp as JM
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import ops
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.ops import mlp as TM

_ULP_BF16 = 2.0 ** -7


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close32(got, want, rtol=1e-5):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _within_bf16_ulp(got, want):
    got, want = _np(got), _np(want)
    assert np.all(np.abs(got - want) <= np.abs(want) * _ULP_BF16)


def _operands(seed, n, sizes, bias=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, sizes[0]).astype(np.float32)
    ws = [(rng.randn(a, b) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(sizes, sizes[1:])]
    bs = ([(rng.randn(b) * 0.1).astype(np.float32) for b in sizes[1:]]
          if bias else None)
    return x, ws, bs


def _both(x, ws, bs, jdt=jnp.float32, tdt=torch.float32,
          wjdt=jnp.float32, wtdt=torch.float32):
    j = (jnp.asarray(x, jdt), tuple(jnp.asarray(w, wjdt) for w in ws),
         None if bs is None else tuple(jnp.asarray(b, wjdt) for b in bs))
    t = (torch.tensor(x).to(tdt), [torch.tensor(w).to(wtdt) for w in ws],
         None if bs is None else [torch.tensor(b).to(wtdt) for b in bs])
    return j, t


# the cases of tests/test_fused_layers.py's TestFusedMLP and compile_check's
# odd widths
_CASES = [(10, [39, 128, 57]), (6, [16, 24]), (8, [20, 64, 12]),
          (96, [224, 200, 136, 10])]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("activation", ["relu", "sigmoid", "none"])
@pytest.mark.parametrize("n,sizes", _CASES, ids=[str(s) for _, s in _CASES])
def test_forward_f32_matches_jax(n, sizes, activation, bias):
    x, ws, bs = _operands(4, n, sizes, bias)
    (jx, jw, jb), (tx, tw, tb) = _both(x, ws, bs)
    want = JM.fused_mlp(jx, jw, jb, activation)
    launches = ops.launch_counts()
    got = TM.fused_mlp(tx, tw, tb, activation)
    assert ops.launch_counts() == launches     # the CPU takes no kernel
    assert got.dtype == torch.float32 and got.shape == (n, sizes[-1])
    _close32(got, want)
    _close32(TM.mlp_reference(tx, tw, tb, activation),
             JM.mlp_reference(jx, jw, jb, activation))


@pytest.mark.parametrize("weights", ["f32", "bf16"])
@pytest.mark.parametrize("activation", ["relu", "sigmoid", "none"])
def test_forward_bf16_within_one_ulp_of_jax(activation, weights):
    """bf16 x with f32 weights (O1) and with bf16 weights and biases (O2's
    cast). The fused path is the f32 chain cast once, so it is held to the
    JAX ``fused_mlp``; ``mlp_reference`` to the JAX ``mlp_reference``."""
    x, ws, bs = _operands(5, 32, [39, 128, 64, 20])
    wj, wt = ((jnp.float32, torch.float32) if weights == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    (jx, jw, jb), (tx, tw, tb) = _both(x, ws, bs, jnp.bfloat16,
                                       torch.bfloat16, wj, wt)
    got = TM.fused_mlp(tx, tw, tb, activation)
    assert got.dtype == torch.bfloat16
    _within_bf16_ulp(got, JM.fused_mlp(jx, jw, jb, activation))
    _within_bf16_ulp(TM.mlp_reference(tx, tw, tb, activation),
                     JM.mlp_reference(jx, jw, jb, activation))
    assert torch.equal(got, TM.mlp_fused_reference(tx, tw, tb, activation))


def test_fused_and_reference_part_in_bf16():
    """In bf16 the fused path (one rounding) and the reference
    chain (a rounding a layer) give different numbers, in both packages,
    so neither stands in for the other."""
    x, ws, bs = _operands(6, 64, [64, 256, 256, 32])
    (jx, jw, jb), (tx, tw, tb) = _both(x, ws, bs, jnp.bfloat16,
                                       torch.bfloat16)
    assert not torch.equal(TM.fused_mlp(tx, tw, tb),
                           TM.mlp_reference(tx, tw, tb))
    assert not np.array_equal(_np(JM.fused_mlp(jx, jw, jb)),
                              _np(JM.mlp_reference(jx, jw, jb)))


@pytest.mark.parametrize("widths,fits", [
    ([1024, 2048], True),          # 2,097,152 weights: exactly 8 MiB
    ([1024, 2049], False),         # 1024 more
    ([480, 1024, 1024, 512, 256, 1], False),   # the reference Apex test
    ([13, 512, 256, 128], True),   # DLRM's bottom MLP
])
def test_budget_decides_the_function(widths, fits):
    """The port's ``weights_fit`` is the JAX ``_weights_fit_vmem`` (<=, 4
    bytes an element whatever the dtype); over it ``fused_mlp`` is
    ``mlp_reference`` bit for bit, and in bf16 within one ulp of JAX's
    (which returns its ``mlp_reference`` there)."""
    x, ws, bs = _operands(7, 4, widths)
    (jx, jw, jb), (tx, tw, tb) = _both(x, ws, bs, jnp.bfloat16,
                                       torch.bfloat16, jnp.bfloat16,
                                       torch.bfloat16)
    assert TM.weights_fit(tw) == JM._weights_fit_vmem(jw) == fits
    got = TM.fused_mlp(tx, tw, tb)
    twin = TM.mlp_fused_reference if fits else TM.mlp_reference
    assert torch.equal(got, twin(tx, tw, tb))
    _within_bf16_ulp(got, JM.fused_mlp(jx, jw, jb))


def _grads_jax(x, ws, bs, g, activation):
    def f(x_, w_, b_):
        return jnp.sum(JM.fused_mlp(x_, w_, b_, activation) * g)
    if bs is None:
        return jax.grad(lambda x_, w_: f(x_, w_, None),
                        argnums=(0, 1))(x, ws)
    return jax.grad(f, argnums=(0, 1, 2))(x, ws, bs)


def _grads_torch(x, ws, bs, g, activation):
    leaves = [x, *ws, *(bs or [])]
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    n = len(ws)
    y = TM.fused_mlp(leaves[0], leaves[1:n + 1],
                     leaves[n + 1:] if bs is not None else None, activation)
    return torch.autograd.grad(y, leaves, g)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("activation", ["relu", "sigmoid", "none"])
@pytest.mark.parametrize("n,sizes", [(8, [20, 64, 12]),
                                     (96, [224, 200, 136, 10])])
def test_gradients_f32_match_jax(n, sizes, activation, bias):
    x, ws, bs = _operands(8, n, sizes, bias)
    g = np.random.RandomState(9).randn(n, sizes[-1]).astype(np.float32)
    (jx, jw, jb), (tx, tw, tb) = _both(x, ws, bs)
    want = jax.tree_util.tree_leaves(
        _grads_jax(jx, jw, jb, jnp.asarray(g), activation))
    got = _grads_torch(tx, tw, tb, torch.tensor(g), activation)
    assert len(got) == len(want) == 1 + len(ws) * (2 if bias else 1)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-3, atol=1e-4)


def test_gradients_bf16_track_jax():
    """O2's operands: bf16 x, weights and biases; each gradient in its
    input's dtype, within 2% of the JAX gradient's largest magnitude."""
    x, ws, bs = _operands(10, 16, [39, 128, 57])
    g = np.random.RandomState(11).randn(16, 57).astype(np.float32)
    (jx, jw, jb), (tx, tw, tb) = _both(x, ws, bs, jnp.bfloat16,
                                       torch.bfloat16, jnp.bfloat16,
                                       torch.bfloat16)
    want = jax.tree_util.tree_leaves(
        _grads_jax(jx, jw, jb, jnp.asarray(g, jnp.bfloat16), "relu"))
    got = _grads_torch(tx, tw, tb, torch.tensor(g).bfloat16(), "relu")
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        _close32(a, b, rtol=2e-2)


def test_relu_gradient_at_exact_zero_is_one_half():
    """A zero row with no bias: every pre-activation is exactly 0, where
    ``jnp.maximum(x, 0)`` passes half the gradient. The port matches JAX
    there; ``torch.relu`` (0) would give a zero dx row."""
    x, ws, _ = _operands(12, 4, [8, 16, 4], bias=False)
    x[1] = 0.0
    g = np.random.RandomState(13).randn(4, 4).astype(np.float32)
    (jx, jw, _), (tx, tw, _) = _both(x, ws, None)
    jdx, jdw = _grads_jax(jx, jw, None, jnp.asarray(g), "relu")
    tdx, *tdw = _grads_torch(tx, tw, None, torch.tensor(g), "relu")
    np.testing.assert_allclose(_np(tdx), _np(jdx), rtol=1e-5, atol=1e-6)
    for a, b in zip(tdw, jdw):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
    # the tie's half: dx row 1 = 0.25 · W0 diag(1) W1 g[1]
    want_row = 0.25 * ws[0] @ ws[1] @ g[1]
    np.testing.assert_allclose(tdx[1].numpy(), want_row, rtol=1e-5,
                               atol=1e-6)
    assert np.abs(want_row).max() > 0.1


def test_leading_dims_and_absent_bias_grads():
    """x of any rank is taken over its last dim; with no bias the backward
    returns gradients for x and W only."""
    x, ws, _ = _operands(14, 12, [16, 24], bias=False)
    tx = torch.tensor(x).reshape(3, 4, 16).requires_grad_(True)
    tw = [torch.tensor(w).requires_grad_(True) for w in ws]
    y = TM.fused_mlp(tx, tw, None)
    assert y.shape == (3, 4, 24)
    y.sum().backward()
    want = JM.fused_mlp(jnp.asarray(x).reshape(3, 4, 16),
                        tuple(jnp.asarray(w) for w in ws), None)
    _close32(y, want)
    assert tx.grad.shape == tx.shape and tw[0].grad.shape == (16, 24)


# --- the MLP module -----------------------------------------------------------

def test_mlp_params_layout_and_order():
    m = TM.MLP([10, 20, 5], device="cpu")
    assert [(k, tuple(v.shape)) for k, v in m.named_parameters()] == [
        ("weight_0", (10, 20)), ("bias_0", (20,)), ("weight_1", (20, 5)),
        ("bias_1", (5,))]
    jm = jops.MLP([10, 20, 5])
    jp = jm.init(jax.random.PRNGKey(0), jnp.ones((3, 10)))["params"]
    assert {k: v.shape for k, v in jp.items()} == {
        k: tuple(v.shape) for k, v in m.named_parameters()}
    nb = TM.MLP([10, 20, 5], bias=False, activation="none", device="cpu")
    assert [k for k, _ in nb.named_parameters()] == ["weight_0", "weight_1"]
    y = m(torch.ones(3, 10))
    assert y.shape == (3, 5) and bool((y >= 0).all())   # trailing relu


def test_mlp_init_statistics():
    """Weights N(0, √(2/(fan_in+fan_out))), biases N(0, √(1/fan_out)), the
    reference's init, drawn from the seed (another seed, other draws)."""
    m = TM.MLP([512, 1024, 256], device="cpu", seed=3)
    for i, (a, b) in enumerate([(512, 1024), (1024, 256)]):
        w = getattr(m, f"weight_{i}").detach()
        bias = getattr(m, f"bias_{i}").detach()
        assert abs(w.std().item() / np.sqrt(2.0 / (a + b)) - 1) < 0.02
        assert abs(w.mean().item()) < 0.1 * np.sqrt(2.0 / (a + b))
        assert abs(bias.std().item() / np.sqrt(1.0 / b) - 1) < 0.15
    again = TM.MLP([512, 1024, 256], device="cpu", seed=3)
    other = TM.MLP([512, 1024, 256], device="cpu", seed=4)
    assert torch.equal(again.weight_0, m.weight_0)
    assert not torch.equal(other.weight_0, m.weight_0)


@pytest.mark.parametrize("kw", [dict(mlp_sizes=[4]),
                                dict(mlp_sizes=[4, 4], activation="tanh")])
def test_mlp_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError):
        jops.MLP(**kw)
    with pytest.raises(ValueError):
        TM.MLP(**kw, device="cpu")


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("activation", ["relu", "sigmoid"])
def test_converted_params_give_the_flax_outputs(activation, bias):
    """flax's ``weight_i``/``bias_i`` are not ``.kernel`` leaves: they come
    across untransposed, and the port's module gives the JAX module's
    output on them."""
    sizes = [13, 64, 32, 8]
    jm = jops.MLP(sizes, bias=bias, activation=activation)
    x = np.random.RandomState(15).randn(6, 13).astype(np.float32)
    jp = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    tp = params_from_jax(jp, device="cpu")
    for k, v in tp.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jp[k]))
    m = TM.MLP(sizes, bias=bias, activation=activation, device="cpu")
    m.load_state_dict(tp)
    _close32(m(torch.tensor(x)), jm.apply({"params": jp}, jnp.asarray(x)))


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_auto_cast_passes_the_module_through(xdt):
    """The JAX package's ``_MLP`` is in neither of the interceptor's module
    tables, so under ``auto_cast`` it computes in the dtype that reaches
    it; the port keeps ``MLP`` out of ``module_tables()`` too. (O2: under
    O1 the functional patch also reaches the MLP's products, held in
    ``tests/test_torch_functional_patch.py``.)"""
    assert TM.MLP not in tamp.lists.module_tables()[0] + \
        tamp.lists.module_tables()[1]
    sizes = [8, 16, 4]
    jm = jops.MLP(sizes)
    x = np.random.RandomState(16).randn(3, 8).astype(np.float32)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[xdt]
    jp = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    m = TM.MLP(sizes, device="cpu")
    m.load_state_dict(params_from_jax(jp, device="cpu"))
    jpol = jamp.Policy.from_opt_level("O2")
    tpol = tamp.Policy.from_opt_level("O2")
    with jamp.auto_cast(jpol):
        want = jm.apply({"params": jp}, jnp.asarray(x, jdt))
    with tamp.auto_cast(tpol):
        got = m(torch.tensor(x).to(xdt))
    assert got.dtype == xdt and want.dtype == jdt
    if xdt == torch.float32:
        _close32(got, want)
    else:
        _within_bf16_ulp(got, want)


# --- the kernel's launch plan and wrapper (the kernel runs on the card) -------

@pytest.mark.parametrize("dims,cols", [
    ([13, 512, 256, 128], 0),            # one fused launch
    ([64, 32], 0),                       # one layer
    ([1284, 8, 1284], 0),                # the widest the fused kernel holds
    ([1285, 8, 4], 16),                  # past it: a launch per layer
    ([96, 4096, 48], 8192),
    ([64] * 33, 0),                      # 32 layers: one launch
    ([64] * 41, 128),                    # 40: two launches
])
def test_workspace_plan(dims, cols):
    """f32 columns of the workspace: two buffers of the widest hidden
    layer when the layers take more than one launch (the C side's plan)."""
    assert TM._workspace_cols(dims) == cols


@pytest.mark.parametrize("make,match", [
    (lambda: ([torch.ones(4, 8)], [torch.ones(8, 3), torch.ones(4, 2)]),
     "weight 1"),
    (lambda: ([torch.ones(4, 8)],
              [torch.ones(8, 3), torch.ones(3, 2, dtype=torch.bfloat16)]),
     "one dtype"),
    (lambda: ([torch.ones(4, 8)], [torch.ones(8, 0)]), "widths"),
    (lambda: ([torch.ones(2, 4, 8)], [torch.ones(8, 3)]), "2-D x"),
    (lambda: ([torch.ones(4, 8, dtype=torch.float64)],
              [torch.ones(8, 3, dtype=torch.float64)]), "CUDA device"),
])
def test_kernel_wrapper_refuses_before_launch(make, match):
    (x,), ws = make()
    before = ops.launch_counts()
    with pytest.raises(ValueError, match=match):
        TM.mlp_fwd_kernel(x, ws, None)
    with pytest.raises(ValueError, match="bias"):
        TM.mlp_fwd_kernel(torch.ones(4, 8), [torch.ones(8, 3)],
                          [torch.ones(4)])
    assert ops.launch_counts() == before
