"""Parity of the port's 2:4 sparsity (``apex_tpu_torch.sparsity``) with the
JAX package's (``apex_tpu.sparsity``) on the same numpy weights.

- Masks, bit for bit, for all three patterns: random weights, small
  integers (equal magnitudes and zeros: a pruned weight's next mask is all
  ties), a pruned weight, magnitudes over many octaves (near ties, where
  the score's rounding decides), tails (last dim % 4, dense), a last dim
  under 4 (all True, not None), 1-D leaves and leading dims.
- The whitelist's decision and the mask of every leaf of small converted
  BERT, ResNet, DCGAN and MLP param trees, in the port's layout: the token
  table (``tok_emb.weight`` in the port, ``embedding`` in JAX) stays dense
  and ``pos_emb`` is pruned; Dense, conv and ConvTranspose weights are
  masked along the JAX layout's last axis and mapped back.
- Three ``ASP(FusedSGD)`` and ``ASP(FusedAdam)`` steps, arena and tree,
  against JAX: masks bit for bit, params at the optimizer tests' tolerance
  (rtol 1e-6, atol 1e-6 of each tensor's largest magnitude), zero where
  masked.
- The JAX ``ASPState`` carried by ``convert.asp_state_from_jax`` continues
  the run.
- ``train.build_mlp_step`` (DLRM's bottom MLP shape, cut to small widths)
  three steps under amp O0, O2 bf16 and O2 fp16 against the same step
  built from JAX functions: loss-scaler decisions (scale, growth tracker,
  finite flag; one forced overflow) bit for bit, losses at the dtype's
  tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu import ops as jops
from apex_tpu import sparsity as jsp
from apex_tpu.optim import FusedAdam as JAdam
from apex_tpu.optim import FusedSGD as JSGD
from apex_tpu_torch import convert
from apex_tpu_torch import ops as tops
from apex_tpu_torch import sparsity as tsp
from apex_tpu_torch import train
from apex_tpu_torch.amp.scaler import LossScaleState
from apex_tpu_torch.optim import FusedAdam as TAdam
from apex_tpu_torch.optim import FusedSGD as TSGD

PATTERNS = ["m4n2_1d", "m4n2_2d_greedy", "m4n2_2d_best"]
SHAPES = [(8, 16), (12, 32), (6, 9), (5, 3), (3, 8, 12), (2, 3, 4, 8),
          (16,), (7,)]


def _weights(kind, shape, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "randn":
        w = rng.randn(*shape)
    elif kind == "ties":                  # equal magnitudes and zeros
        w = rng.randint(-2, 3, shape)
    elif kind == "zeros":
        w = np.zeros(shape)
    elif kind == "pruned":                # the next mask of a pruned weight
        w = rng.randn(*shape)
        w = w * np.asarray(jsp.m4n2_1d(jnp.asarray(w, jnp.float32)))
    else:                                 # many octaves: near ties
        w = rng.randn(*shape) * np.exp(3.0 * rng.randn(*shape))
    return w.astype(np.float32)


def _masks(w, pattern):
    j = np.asarray(jsp.create_mask(jnp.asarray(w), pattern))
    t = tsp.create_mask(torch.tensor(w), pattern)
    assert t.dtype == torch.bool and j.dtype == np.bool_
    return t.numpy(), j


@pytest.mark.parametrize("kind", ["randn", "ties", "zeros", "pruned",
                                  "octaves"])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_masks_match_jax_bitwise(pattern, shape, kind):
    t, j = _masks(_weights(kind, shape), pattern)
    np.testing.assert_array_equal(t, j)
    assert tsp.density(torch.tensor(t)) == pytest.approx(
        jsp.density(jnp.asarray(j)), rel=1e-6)
    if shape[-1] < 4:
        assert t.all()                    # dense, and not None
    elif shape[-1] % 4:
        assert t[..., (shape[-1] // 4) * 4:].all()


@pytest.mark.parametrize("pattern", PATTERNS)
def test_near_ties_over_many_blocks(pattern):
    """256 x 256 magnitudes over many octaves: every 4x4 block's score
    rounds as the JAX package's does, so the same pattern wins."""
    t, j = _masks(_weights("octaves", (256, 256), seed=1), pattern)
    np.testing.assert_array_equal(t, j)


def test_masks_refuse_an_unknown_pattern():
    for create in (jsp.create_mask, tsp.create_mask):
        with pytest.raises(ValueError):
            create(jnp.ones((4, 4)) if create is jsp.create_mask
                   else torch.ones(4, 4), "m4n3")


# --- the whitelist and layouts on converted model trees -----------------------

@functools.lru_cache(maxsize=None)
def _trees():
    key = jax.random.PRNGKey(0)
    bert = jmodels.BertEncoder(50, hidden=16, layers=1, heads=2, max_len=8)
    resnet = jmodels.ResNet(stage_sizes=[1, 1], num_classes=4, width=4)
    gen, disc = jmodels.Generator(nz=4, ngf=4), jmodels.Discriminator(ndf=4)
    mlp = jops.MLP([10, 20, 8])
    return {
        "bert": bert.init(key, jnp.zeros((1, 8), jnp.int32))["params"],
        "resnet": resnet.init(key, jnp.zeros((1, 16, 16, 3)),
                              train=True)["params"],
        "generator": gen.init(key, jnp.zeros((1, 1, 1, 4)),
                              train=True)["params"],
        "discriminator": disc.init(key, jnp.zeros((1, 64, 64, 3)),
                                   train=True)["params"],
        "mlp": mlp.init(key, jnp.ones((2, 10)))["params"],
    }


_MODELS = ["bert", "resnet", "generator", "discriminator", "mlp"]


def _leaves(tree):
    return list(convert._flatten(tree))


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("model", _MODELS)
def test_whitelist_and_masks_on_converted_trees(model, pattern):
    jp = _trees()[model]
    jmasks = dict(_leaves(jsp.compute_sparse_masks(jp, pattern)))
    tp = convert.params_from_jax(jp, device="cpu")
    tmasks = tsp.compute_sparse_masks(tp, pattern)
    assert set(tmasks) == set(tp)
    pruned = 0
    for name, leaf in _leaves(jp):
        if jmasks[name] is None:
            pname, want = convert._port_name(name), None
        else:
            pname, want = convert._port_leaf(name, np.asarray(jmasks[name]))
        assert tsp.default_whitelist(pname, tp[pname]) == \
            jsp.default_whitelist(tuple(name.split(".")), leaf), name
        if want is None:
            assert tmasks[pname] is None, name
            continue
        pruned += 1
        got = tmasks[pname]
        assert got.shape == tp[pname].shape and got.stride() == \
            tp[pname].stride(), name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert pruned > 0
    if model == "bert":
        assert tmasks["tok_emb.weight"] is None
        assert tmasks["pos_emb"] is not None


def test_dense_masks_group_along_output_features():
    """The JAX kernel (in, out) groups its last axis, the
    output features; the port's Dense weight is (out, in), so its groups of
    4 run down the columns: every (4 rows, 1 column) slice keeps 2."""
    tp = convert.params_from_jax(
        {"Dense_0": {"kernel": _weights("randn", (12, 16))}}, device="cpu")
    m = tsp.compute_sparse_masks(tp)["Dense_0.weight"]
    assert m.shape == (16, 12)
    np.testing.assert_array_equal(m.reshape(4, 4, 12).sum(1).numpy(), 2)


# --- ASP around the fused optimizers ------------------------------------------

_TREE = {"Dense_0": {"kernel": (16, 8), "bias": (8,)},
         "Conv_0": {"kernel": (3, 3, 4, 8)},
         "ConvTranspose_0": {"kernel": (4, 4, 8, 4)},
         "tok_emb": {"embedding": (10, 8)}, "pos_emb": (6, 8),
         "LayerNorm_0": {"scale": (8,)}, "weight_0": (12, 20),
         "bias_0": (20,)}


def _draw(tree, rng, scale=1.0):
    return {k: _draw(v, rng, scale) if isinstance(v, dict)
            else (rng.randn(*v) * scale).astype(np.float32)
            for k, v in tree.items()}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def _check_params(tp, jp, tmasks):
    want = convert.params_from_jax(jax.device_get(jp), device="cpu")
    assert set(want) == set(tp)
    for k, v in want.items():
        _close(tp[k], v.numpy())
        if tmasks[k] is not None:
            assert not tp[k][~tmasks[k]].any(), k


_OPTS = {
    "sgd": (lambda s: JSGD(lr=0.1, momentum=0.9, strategy=s),
            lambda s: TSGD(lr=0.1, momentum=0.9, strategy=s)),
    "adam": (lambda s: JAdam(lr=1e-2, weight_decay=0.01, strategy=s),
             lambda s: TAdam(lr=1e-2, weight_decay=0.01, strategy=s)),
}


def _asp_steps(opt, strategy, pattern, steps, seed=0):
    rng = np.random.RandomState(seed)
    params = _draw(_TREE, rng)
    jasp = jsp.ASP(_OPTS[opt][0](strategy), pattern=pattern)
    tasp = tsp.ASP(_OPTS[opt][1](strategy), pattern=pattern)
    jp, tp = _jnp(params), convert.params_from_jax(params, device="cpu")
    js, ts = jasp.init(jp), tasp.init(tp)
    for _ in range(steps):
        g = _draw(_TREE, rng, 3.0)
        jp, js = jasp.step(_jnp(g), js, jp)
        tp, ts = tasp.step(convert.params_from_jax(g, device="cpu"), ts, tp)
    return (jasp, jp, js), (tasp, tp, ts), rng


@pytest.mark.parametrize("pattern", ["m4n2_1d", "m4n2_2d_best"])
@pytest.mark.parametrize("strategy", ["arena", "tree"])
@pytest.mark.parametrize("opt", list(_OPTS))
def test_asp_three_steps_match_jax(opt, strategy, pattern):
    (_, jp, js), (_, tp, ts), _ = _asp_steps(opt, strategy, pattern, 3)
    carried = convert.asp_state_from_jax(jax.device_get(js),
                                         jax.device_get(jp), tp, "cpu")
    assert set(ts.masks) == set(carried.masks) == set(tp)
    for k, m in ts.masks.items():
        if m is None:
            assert carried.masks[k] is None, k
        else:
            assert torch.equal(m, carried.masks[k]), k
    assert ts.masks["tok_emb.weight"] is None
    assert ts.masks["bias_0"] is None and ts.masks["weight_0"] is not None
    assert int(ts.inner.count) == int(js.inner.count) == 3
    _check_params(tp, jp, ts.masks)


@pytest.mark.parametrize("strategy", ["arena", "tree"])
def test_asp_update_protocol_matches_step(strategy):
    """``update`` (the optax protocol) returns the pruned step's deltas."""
    (_, _, _), (tasp, tp, ts), rng = _asp_steps("adam", strategy,
                                                "m4n2_1d", 1)
    g = convert.params_from_jax(_draw(_TREE, rng, 3.0), device="cpu")
    new_p, _ = tasp.step(g, ts, tp)
    upd, _ = tasp.update(g, ts, tp)
    for k, p in tp.items():
        torch.testing.assert_close(p + upd[k], new_p[k], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("strategy", ["arena", "tree"])
def test_asp_state_carried_from_jax_continues_the_run(strategy):
    """Two JAX steps of ``ASP(FusedAdam)``; params and the ASP state (masks
    in the port's layout, the Adam state through ``fused_state_from_jax``)
    carried to the port; one more step on each side agrees."""
    (jasp, jp, js), (tasp, _, _), rng = _asp_steps("adam", strategy,
                                                   "m4n2_2d_greedy", 2)
    jp, js = jax.device_get(jp), jax.device_get(js)
    tp = convert.params_from_jax(jp, device="cpu")
    ts = convert.asp_state_from_jax(js, jp, tp, device="cpu")
    if strategy == "arena":
        assert set(ts.inner.slots["m"]) == {"float32"}
    g = _draw(_TREE, rng, 3.0)
    jp, js = jasp.step(_jnp(g), js, _jnp(jp))
    tp, ts = tasp.step(convert.params_from_jax(g, device="cpu"), ts, tp)
    assert int(ts.inner.count) == int(js.inner.count) == 3
    _check_params(tp, jp, ts.masks)


def test_recompute_masks_follows_the_weights():
    (jasp, jp, js), (tasp, tp, ts), _ = _asp_steps("sgd", "tree",
                                                   "m4n2_1d", 1)
    flipped = {k: -v if k == "weight_0" else v for k, v in tp.items()}
    again = tasp.recompute_masks(ts, flipped)
    assert torch.equal(again.masks["weight_0"], ts.masks["weight_0"])
    doubled = dict(tp, weight_0=torch.tensor(
        _weights("randn", (12, 20), seed=5)))
    fresh = tasp.recompute_masks(ts, doubled)
    assert torch.equal(fresh.masks["weight_0"],
                       tsp.create_mask(doubled["weight_0"]))
    assert fresh.inner is ts.inner


# --- the MLP step under amp, with ASP around FusedAdam ------------------------

SIZES, B = (13, 32, 16, 8), 16
_HALF = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _mlp_runs(opt_level, half, steps=3, before_step=None):
    jm = jops.MLP(list(SIZES))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(3),
                                jnp.ones((1, SIZES[0])))["params"])
    model = tops.MLP(SIZES, device="cpu")
    model.load_state_dict(convert.params_from_jax(jp, device="cpu"))
    tstep, tstate, (tx, tt), tpol, _ = train.build_mlp_step(
        B, opt_level=opt_level, half_dtype=half, device="cpu", model=model,
        seed=2)

    jpol = jamp.Policy.from_opt_level(opt_level, half_dtype=_HALF[half])
    amp_opt = jamp.Amp(jpol, jsp.ASP(JAdam(lr=1e-3), pattern="m4n2_1d"))
    rng = np.random.RandomState(2)
    jx = jnp.asarray(rng.randn(B, SIZES[0]).astype(np.float32))
    if jpol.cast_model_type is not None:
        jx = jx.astype(jpol.compute_dtype)
    jt = jnp.asarray(rng.rand(B, SIZES[-1]).astype(np.float32))
    np.testing.assert_array_equal(tx.float().numpy(), np.asarray(
        jx.astype(jnp.float32)))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))

    def loss_fn(mp, x, t):
        y = jm.apply({"params": mp}, x)
        return jnp.mean(jnp.square(y.astype(jnp.float32) - t))

    jstep = jax.jit(lambda s: amp_opt.step(s, loss_fn, jx, jt))
    jstate = amp_opt.init(jp)
    out = []
    for i in range(steps):
        if before_step is not None:
            jstate, tstate = before_step(i, jstate, tstate)
        jstate, jloss, jfin = jstep(jstate)
        tstate, tloss = tstep(tstate, tx, tt)
        out.append((jstate, tstate, float(jloss), tloss.item(), bool(jfin)))
    return out, tpol


def _check_pruned(state):
    for k, m in state.opt_state.masks.items():
        if m is not None:
            assert not state.params[k][~m].any(), k
            assert (m.reshape(-1, 4).sum(-1) == 2).all(), k


@pytest.mark.parametrize("opt_level,half,rtol", [
    ("O0", torch.bfloat16, 1e-5),
    ("O2", torch.bfloat16, 2e-2),
])
def test_mlp_step_with_asp_tracks_jax(opt_level, half, rtol):
    """O0: f32 throughout, losses at rtol 1e-5 and params (f32) within
    1e-5 of each tensor's max plus lr/10 (Adam moves an element by about lr
    whatever its gradient's size). O2 bf16: the model runs in bf16 on both
    sides (the fused forward rounds once, the backward's chain each layer),
    losses within 2e-2 relative (a bf16 output an ulp apart), and the
    masters within 1e-3 of each tensor's max (an lr). Masks bit for bit
    and 2:4 after every step; no scaler under either."""
    runs, pol = _mlp_runs(opt_level, half)
    assert pol.loss_scale is None
    for i, (js, ts, jl, tl, jfin) in enumerate(runs):
        np.testing.assert_allclose(tl, jl, rtol=rtol, err_msg=f"step {i}")
        assert jfin and int(ts.step) == int(js.step) == i + 1
        _check_pruned(ts)
        tol = 1e-4 if opt_level == "O0" else 1e-3
        want = convert.params_from_jax(jax.device_get(js.params), "cpu")
        for k, v in want.items():
            got = ts.params[k]
            assert got.dtype == torch.float32
            assert (got - v).abs().max() <= 1e-5 * v.abs().max() + tol, k
        carried = convert.asp_state_from_jax(
            jax.device_get(js.opt_state), jax.device_get(js.params),
            ts.params, "cpu")
        for k, m in ts.opt_state.masks.items():
            assert (m is None and carried.masks[k] is None) or \
                torch.equal(m, carried.masks[k]), k


def test_mlp_o2_fp16_scaler_decisions_bitwise():
    """O2 fp16: dynamic loss scaling. Before the third step both scalers
    are set to 2**24, which overflows the fp16 backward (and 2**23 after
    the backoff does again); each step's scale,
    growth tracker, finite flag and step count are bitwise the JAX step's,
    and the skipped step holds params, masks and Adam count."""
    big = 2.0 ** 24

    def overflow(i, js, ts):
        if i != 2:
            return js, ts
        js = js._replace(scalers=(js.scalers[0]._replace(
            loss_scale=jnp.float32(big)),))
        ts = ts._replace(scalers=(LossScaleState(
            torch.tensor(big), ts.scalers[0].growth_tracker),))
        return js, ts

    runs, pol = _mlp_runs("O2", torch.float16, steps=4, before_step=overflow)
    assert pol.loss_scale == "dynamic"
    finite = []
    for i, (js, ts, jl, tl, jfin) in enumerate(runs):
        jsc, tsc = js.scalers[0], ts.scalers[0]
        assert np.float32(tsc.loss_scale.item()).tobytes() == \
            np.asarray(jsc.loss_scale, np.float32).tobytes(), i
        assert int(tsc.growth_tracker) == int(jsc.growth_tracker), i
        assert int(ts.step) == int(js.step), i
        assert int(ts.opt_state.inner.count) == int(js.opt_state.inner.count)
        np.testing.assert_allclose(tl, jl, rtol=5e-3, err_msg=f"step {i}")
        finite.append(jfin)
        _check_pruned(ts)
    # 2**24 and then 2**23 overflow; the JAX step decided each the same
    assert finite == [True, True, False, False]
    assert int(runs[2][1].step) == 2 and runs[2][1].scalers[0].loss_scale \
        .item() == big / 2
    for k, v in runs[1][1].params.items():
        assert torch.equal(runs[2][1].params[k], v), k
