"""The multihead-attention remainder against the JAX package: the
norm-add variant, separate QKV params and ``impl="default"``.

Mirrors ``tests/test_attention.py``'s MHA tests on the port:

- ``SelfMultiheadAttn`` at every (impl, include_norm_add,
  separate_qkv_params) and ``EncdecMultiheadAttn`` at every (impl,
  include_norm_add), with the flax params carried by ``params_from_jax``:
  output, input gradients and param gradients at ``deterministic=True``
  (f32, atol 2e-5), causal and an additive bias on the default path;
- fast against default on the port (atol 2e-4, as the JAX test);
- under ``auto_cast(O1)`` the default path changes as the JAX package's
  does (its einsums round to bf16, the fast path does not) and the two
  packages' O1 outputs agree within bf16 rounding (2e-2 of the output's
  max);
- under O2 ``ln_scale``/``ln_bias`` are cast to the half dtype, as the
  JAX package's ``Policy.cast_params`` casts them (they match no norm
  name);
- dropout: the norm-add output dropout and the default path's softmax
  dropout keep within 5σ of the binomial, and equal the port's formula on
  the mask their generator draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.ops.multihead_attn as JMHA
import apex_tpu_torch.ops.multihead_attn as TMHA
from apex_tpu import amp as jamp
from apex_tpu_torch import amp as tamp
from apex_tpu_torch.convert import params_from_jax

ATOL = 2e-5
HIDDEN, HEADS = 64, 4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(jm, tm, args):
    """(flax params, the port module loaded with them)."""
    params = jm.init(jax.random.PRNGKey(0), *map(jnp.asarray, args))[
        "params"]
    mapped = params_from_jax(params, device="cpu")
    assert set(mapped) == set(tm.state_dict())
    tm.load_state_dict(mapped)
    return params, tm


def _check(jm, tm, args, kw=None, tkw=None, atol=ATOL):
    """Output, input grads and param grads of both modules on the same
    numpy inputs, at deterministic=True."""
    kw, tkw = kw or {}, tkw or {}
    params, tm = _pair(jm, tm, args)
    jargs = [jnp.asarray(a) for a in args]
    jy = jm.apply({"params": params}, *jargs, **kw)
    dy = np.random.RandomState(9).randn(*jy.shape).astype(np.float32)

    def jloss(p, *a):
        return jnp.sum(jm.apply({"params": p}, *a, **kw) * dy)

    jgp, *jga = jax.grad(jloss, argnums=tuple(range(len(args) + 1)))(
        params, *jargs)
    targs = [torch.tensor(a).requires_grad_(True) for a in args]
    ty = tm(*targs, **tkw)
    (ty * torch.tensor(dy)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=atol, rtol=0)
    for t, g in zip(targs, jga):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=atol,
                                   rtol=0)
    want = params_from_jax(jgp, device="cpu")
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=atol, rtol=0, err_msg=name)


def _x(shape, seed=3):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("separate", [False, True])
@pytest.mark.parametrize("norm_add", [False, True])
@pytest.mark.parametrize("impl", ["fast", "default"])
def test_self_attn_matches_jax(impl, norm_add, separate):
    kw = dict(include_norm_add=norm_add, separate_qkv_params=separate,
              impl=impl)
    _check(JMHA.SelfMultiheadAttn(HIDDEN, HEADS, **kw),
           TMHA.SelfMultiheadAttn(HIDDEN, HEADS, device="cpu", **kw),
           [_x((2, 48, HIDDEN))])


def test_default_path_causal_and_bias_match_jax():
    b = _x((1, HEADS, 40, 40), seed=4)
    kw = dict(attn_bias=b, causal=True)
    _check(JMHA.SelfMultiheadAttn(HIDDEN, HEADS, impl="default"),
           TMHA.SelfMultiheadAttn(HIDDEN, HEADS, impl="default",
                                  device="cpu"),
           [_x((2, 40, HIDDEN))], dict(kw, attn_bias=jnp.asarray(b)),
           dict(kw, attn_bias=torch.tensor(b)))


@pytest.mark.parametrize("norm_add", [False, True])
@pytest.mark.parametrize("impl", ["fast", "default"])
def test_encdec_matches_jax(impl, norm_add):
    kw = dict(include_norm_add=norm_add, impl=impl)
    _check(JMHA.EncdecMultiheadAttn(HIDDEN, HEADS, **kw),
           TMHA.EncdecMultiheadAttn(HIDDEN, HEADS, device="cpu", **kw),
           [_x((2, 24, HIDDEN)), _x((2, 56, HIDDEN), seed=5)])


@pytest.mark.parametrize("norm_add", [False, True])
def test_fast_vs_default_on_the_port(norm_add):
    x = torch.tensor(_x((2, 48, HIDDEN), seed=8))
    fast = TMHA.SelfMultiheadAttn(HIDDEN, HEADS, include_norm_add=norm_add,
                                  device="cpu")
    slow = TMHA.SelfMultiheadAttn(HIDDEN, HEADS, include_norm_add=norm_add,
                                  impl="default", device="cpu")
    slow.load_state_dict(fast.state_dict())
    np.testing.assert_allclose(fast(x).detach().numpy(),
                               slow(x).detach().numpy(), atol=2e-4)
    q, mem = torch.tensor(_x((2, 24, HIDDEN))), torch.tensor(
        _x((2, 56, HIDDEN), seed=10))
    fast = TMHA.EncdecMultiheadAttn(HIDDEN, HEADS, include_norm_add=norm_add,
                                    device="cpu")
    slow = TMHA.EncdecMultiheadAttn(HIDDEN, HEADS, include_norm_add=norm_add,
                                    impl="default", device="cpu")
    slow.load_state_dict(fast.state_dict())
    np.testing.assert_allclose(fast(q, mem).detach().numpy(),
                               slow(q, mem).detach().numpy(), atol=2e-4)


def test_separate_qkv_names_match_jax():
    x = _x((1, 32, 32))
    jm = JMHA.SelfMultiheadAttn(32, 2, separate_qkv_params=True)
    names = set(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    assert {"q_proj", "k_proj", "v_proj", "out_proj"} == names
    tm = TMHA.SelfMultiheadAttn(32, 2, separate_qkv_params=True,
                                device="cpu")
    assert {n.split(".")[0] for n, _ in tm.named_parameters()} == names
    tm = TMHA.SelfMultiheadAttn(32, 2, include_norm_add=True, device="cpu")
    assert [n for n, _ in tm.named_parameters()][:2] == ["ln_scale",
                                                         "ln_bias"]


def test_unknown_impl_is_refused():
    with pytest.raises(ValueError, match="impl"):
        TMHA.SelfMultiheadAttn(32, 2, impl="slow", device="cpu")


JO1 = jamp.Policy.from_opt_level("O1")
TO1 = tamp.Policy.from_opt_level("O1")


def _differ(a, b):
    return not np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32))


@pytest.mark.parametrize("impl", ["fast", "default"])
def test_o1_changes_op_by_op_as_jax(impl):
    """Under auto_cast(O1), outside it, and under O1 without the patch:
    the default path's output changes with the patch exactly as the JAX
    package's does (its einsums are reached), the fast path's does not;
    the two packages agree within bf16 rounding."""
    kw = dict(include_norm_add=True, impl=impl)
    jm = JMHA.SelfMultiheadAttn(HIDDEN, HEADS, **kw)
    tm = TMHA.SelfMultiheadAttn(HIDDEN, HEADS, device="cpu", **kw)
    x = _x((2, 32, HIDDEN), seed=6)
    params, tm = _pair(jm, tm, [x])
    import contextlib
    outs = {}
    for name, amp_mod, pol, run in (
            ("jax", jamp, JO1, lambda: np.asarray(jm.apply(
                {"params": params}, jnp.asarray(x)), np.float32)),
            ("port", tamp, TO1, lambda: tm(torch.tensor(x)).detach()
             .float().numpy())):
        got = []
        for scope in (lambda: amp_mod.auto_cast(pol),
                      contextlib.nullcontext,
                      lambda: amp_mod.auto_cast(pol.replace(
                          patch_ops=False))):
            with scope():
                got.append(run())
        outs[name] = got
    for name in outs:
        o1, plain, nopatch = outs[name]
        assert _differ(o1, plain)
        assert _differ(o1, nopatch) == (impl == "default"), name
    ref = np.abs(outs["jax"][0]).max()
    np.testing.assert_allclose(outs["port"][0], outs["jax"][0],
                               atol=2e-2 * ref, rtol=0)


def test_o2_casts_the_norm_add_params_as_jax():
    x = _x((1, 16, 32))
    jm = JMHA.SelfMultiheadAttn(32, 2, include_norm_add=True)
    tm = TMHA.SelfMultiheadAttn(32, 2, include_norm_add=True, device="cpu")
    params, tm = _pair(jm, tm, [x])
    jcast = jamp.Policy.from_opt_level("O2").cast_params(params)
    tcast = tamp.Policy.from_opt_level("O2").cast_params(
        dict(tm.named_parameters()))
    for leaf in ("ln_scale", "ln_bias"):
        assert jcast[leaf].dtype == jnp.bfloat16
        assert tcast[leaf].dtype == torch.bfloat16
    jy = np.asarray(jm.apply({"params": jcast},
                             jnp.asarray(x).astype(jnp.bfloat16)), np.float32)
    ty = torch.func.functional_call(
        tm, tcast, (torch.tensor(x).to(torch.bfloat16),))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().detach().numpy(), jy,
                               atol=2e-2 * np.abs(jy).max(), rtol=0)


def _redraw(seed, state, shape):
    g = torch.Generator().manual_seed(seed)
    g.set_state(state)
    return torch.rand(shape, generator=g)


def test_norm_add_output_dropout_in_distribution(monkeypatch):
    """The output dropout alone (the softmax dropout's seed held at 0
    rate): the output is x plus the output projection's result through the
    port's dropout formula on the mask the generator draws."""
    rate = 0.3
    monkeypatch.setattr(TMHA, "_softmax_dropout",
                        lambda *a: (0.0, None))
    tm = TMHA.SelfMultiheadAttn(HIDDEN, HEADS, dropout=rate,
                                include_norm_add=True, device="cpu")
    proj = []
    tm.out_proj.register_forward_hook(lambda m, i, o: proj.append(o))
    x = torch.tensor(_x((4, 32, HIDDEN), seed=12))
    g = torch.Generator().manual_seed(21)
    state = g.get_state()
    with torch.no_grad():
        y = tm(x, deterministic=False, generator=g)
    keep = _redraw(21, state, x.shape) < 1 - rate
    np.testing.assert_array_equal(
        y.numpy(), (torch.where(keep, proj[0] / (1 - rate), 0.0) + x).numpy())
    n, kept = keep.numel(), int(keep.sum())
    assert abs(kept - n * (1 - rate)) < 5 * np.sqrt(n * rate * (1 - rate))


def test_default_softmax_dropout_in_distribution():
    rate = 0.2
    rng = np.random.RandomState(13)
    q, k, v = (torch.tensor(rng.randn(2, 32, HEADS, 16).astype(np.float32))
               for _ in range(3))
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    got = TMHA._dropout_attention(q, k, v, None, False, rate, False, g)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
    p = torch.softmax(s, dim=-1)
    keep = _redraw(5, state, p.shape) < 1 - rate
    want = torch.einsum("bhqk,bkhd->bqhd",
                        torch.where(keep, p / (1 - rate), 0.0), v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    n, kept = keep.numel(), int(keep.sum())
    assert abs(kept - n * (1 - rate)) < 5 * np.sqrt(n * rate * (1 - rate))
    det = TMHA._dropout_attention(q, k, v, None, False, rate, True, None)
    np.testing.assert_allclose(
        det.numpy(), torch.einsum("bhqk,bkhd->bqhd", p, v).numpy(),
        atol=1e-6, rtol=0)
