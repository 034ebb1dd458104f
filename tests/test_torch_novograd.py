"""Parity of the port's NovoGrad (``ops.novograd_update``,
``optim.FusedNovoGrad``) with the JAX package's.

- ``novograd_update``'s plain version against the JAX ``novograd_update``
  (its Pallas kernel in interpret mode) on one BUFFER_MULTIPLE-long
  buffer, over both moment modes, grad averaging and bias correction, on
  f32 and bf16 params: f32 outputs at rtol 1e-6 with an atol of 1e-6
  times the output's largest magnitude, a bf16 output within one bf16
  ulp.
- ``FusedNovoGrad``, arena and tree, three steps against the JAX
  ``FusedNovoGrad`` on a tree with f32 and bf16 leaves, with L2 and max
  norms, ``init_zero``, ``reg_inside_moment``, ``grad_averaging=False``
  and no bias correction: the same tolerance, and the ``vnorm`` slot (a
  (num_tensors,) vector per partition under the arena, a 0-d f32 per
  tensor under the tree) per tensor. The arena's per-tensor norms sum row
  norms and then rows, the JAX package's and the tree's each tensor at
  once: equal at f32 tolerance, not bitwise.
- State carried across by ``convert.fused_state_from_jax``, ``vnorm``
  included, arena and tree: a run continued in the port matches the JAX
  run.
- A structural BERT (``tests/test_torch_adagrad.py``'s) trained 3 steps
  through ``train.build_bert_step(optimizer=FusedNovoGrad(...))`` against
  the JAX step with the JAX ``FusedNovoGrad``, at that file's tolerance;
  and at O1 fp16 with dynamic loss scaling and the first step's loss
  forced to inf: the skipped step leaves ``count`` at 0 on both sides, so
  the next step is the first that takes the norm itself; loss scales,
  growth trackers, ``step`` and ``count`` match bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import arena as JA
from apex_tpu import models as jmodels
from apex_tpu.ops import optim_kernels as JK
from apex_tpu.optim import FusedNovoGrad as JNovo
from apex_tpu_torch import arena as TA
from apex_tpu_torch import models as tmodels
from apex_tpu_torch import ops
from apex_tpu_torch.arena import BUFFER_MULTIPLE
from apex_tpu_torch.convert import (_port_name, fused_state_from_jax,
                                    params_from_jax)
from apex_tpu_torch.ops import optim_kernels as TK
from apex_tpu_torch.optim import FusedNovoGrad as TNovo
from test_torch_adagrad import (_BF16, _SHAPES, bert_runs, close,
                                close_param, np32, three_steps)

N = BUFFER_MULTIPLE


def _buffers(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(N).astype(np.float32),
            (rng.randn(N) * 3.0).astype(np.float32),
            (rng.randn(N) * 0.1).astype(np.float32),
            (np.abs(rng.randn(N)) + 0.1).astype(np.float32))


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("grad_averaging", [True, False])
@pytest.mark.parametrize("reg_inside_moment", [False, True])
def test_novograd_update_matches_jax(reg_inside_moment, grad_averaging,
                                     bias_correction, p_dtype):
    p, g, m, v = _buffers(0)
    tp = torch.tensor(p).to(getattr(torch, p_dtype))
    jp = jnp.asarray(np32(tp), p_dtype)
    kw = dict(lr=1e-3, beta1=0.95, beta2=0.98, eps=1e-8, weight_decay=1e-3,
              step=2, grad_averaging=grad_averaging,
              bias_correction=bias_correction,
              reg_inside_moment=reg_inside_moment)
    want = JK.novograd_update(jp, *(jnp.asarray(x) for x in (g, m, v)), **kw)
    got = TK.novograd_update(tp, *(torch.tensor(x) for x in (g, m, v)), **kw)
    assert [t.dtype for t in got] == [tp.dtype, torch.float32]
    close_param(got[0], want[0])
    close(got[1], want[1])


def test_novograd_update_device_step_and_lr():
    """step and lr as device tensors, as the optimizer passes them: the
    count is never read back."""
    p, g, m, v = _buffers(1)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0)
    want = JK.novograd_update(*(jnp.asarray(x) for x in (p, g, m, v)),
                              lr=jnp.float32(2e-3), step=jnp.int32(7), **kw)
    got = TK.novograd_update(*(torch.tensor(x) for x in (p, g, m, v)),
                             lr=torch.tensor(2e-3),
                             step=torch.tensor(7, dtype=torch.int32), **kw)
    for a, b in zip(got, want):
        close(a, b)


def test_bias_corrections_sqrt_form():
    bc1, bc2 = TK.bias_corrections(0.9, 0.98, torch.tensor(3), True, "cpu",
                                   sqrt2=True)
    assert abs(bc1.item() - (1 - 0.9 ** 3)) < 1e-7
    assert abs(bc2.item() - (1 - 0.98 ** 3) ** 0.5) < 1e-7
    assert TK.bias_corrections(0.9, 0.98, 3, False, "cpu", sqrt2=True) == \
        (1.0, 1.0)


_KWARGS = [
    dict(),
    dict(lr=1e-2, betas=(0.95, 0.98), weight_decay=1e-3),
    dict(lr=1e-2, weight_decay=1e-3, norm_type=0),
    dict(lr=1e-2, init_zero=True),
    dict(lr=1e-2, weight_decay=1e-2, reg_inside_moment=True),
    dict(lr=1e-2, grad_averaging=False),
    dict(lr=5e-3, bias_correction=False, weight_decay=1e-3),
]


def _vnorm_by_name(state, params):
    """The ``vnorm`` slot of a port or JAX state, tree or arena, as
    ``{port param name: value}``."""
    v = state.slots["vnorm"]
    if isinstance(state.count, torch.Tensor):
        if set(v) == set(params):                       # tree
            return dict(v)
        spec = TA.plan(params)
        names = spec.names
    else:
        if set(v) != set(JA.plan(params).dtypes):       # tree
            return params_from_jax(v, device="cpu")
        spec = JA.plan(params)
        names = [_port_name(".".join(str(k.key) for k in path)) for path, _
                 in jax.tree_util.tree_flatten_with_path(params)[0]]
    return {names[i]: torch.tensor(np.array(v[dt]))[j]
            for i, (dt, j) in enumerate(spec.leaf_partition)}


@pytest.mark.parametrize("strategy", ["tree", "arena"])
@pytest.mark.parametrize("kw", _KWARGS)
def test_three_steps_match_jax(kw, strategy):
    (tp, ts, tslots), (jp, js, jslots) = three_steps(
        JNovo(strategy=strategy, **kw), TNovo(strategy=strategy, **kw),
        strategy, ("m",))
    assert int(ts.count) == int(js.count) == 3
    if strategy == "arena":
        assert set(ts.slots["vnorm"]) == {"bfloat16", "float32"}
        assert ts.slots["vnorm"]["float32"].shape == (2,)
    tv, jv = _vnorm_by_name(ts, tp), _vnorm_by_name(js, jp)
    for k in _SHAPES:
        assert tp[k].dtype == (torch.bfloat16 if k in _BF16
                               else torch.float32)
        close_param(tp[k], jp[k])
        close(tslots["m"][k], jslots["m"][k])
        assert tv[k].dtype == torch.float32 and tv[k].dim() == 0
        close(tv[k], jv[k])


@pytest.mark.parametrize("kw", _KWARGS)
def test_arena_matches_tree_in_the_port(kw):
    (ap, ast, aslots), _ = three_steps(
        JNovo(strategy="arena", **kw), TNovo(strategy="arena", **kw),
        "arena", ("m",))
    (tp, tst, tslots), _ = three_steps(
        JNovo(strategy="tree", **kw), TNovo(strategy="tree", **kw), "tree",
        ("m",))
    av = _vnorm_by_name(ast, ap)
    for k in _SHAPES:
        close_param(ap[k], tp[k])
        close(aslots["m"][k], tslots["m"][k])
        close(av[k], tst.slots["vnorm"][k])


def test_padding_keeps_zero_params_and_first_step_takes_the_norm():
    """Gaps and the tail get v = 1 (``fill=1.0``) with g = m = 0, so p stays
    0 there; on the first step vnorm is the grad's norm itself."""
    p = {"a": torch.randn(3, 5), "b": torch.randn(7)}
    g = {"a": torch.randn(3, 5), "b": torch.randn(7)}
    opt = TNovo(lr=0.1, weight_decay=0.1, strategy="arena")
    st0 = opt.init(p)
    p1, st = opt.step(g, st0, p)
    spec = TA.plan(p)
    buf = TA.flatten(p1, spec)["float32"]
    assert not buf[~torch.from_numpy(TA.valid_mask(spec, "float32"))].any()
    want = torch.stack([torch.linalg.vector_norm(g[k]) for k in ("a", "b")])
    close(st.slots["vnorm"]["float32"], want)
    assert not st0.slots["vnorm"]["float32"].any()


def test_defaults_norm_type_and_auto_rule():
    topt, jopt = TNovo(), JNovo()
    names = ("lr", "beta1", "beta2", "eps", "weight_decay",
             "bias_correction", "reg_inside_moment", "grad_averaging",
             "norm_type", "init_zero", "strategy")
    assert [getattr(topt, n) for n in names] == \
        [getattr(jopt, n) for n in names]
    with pytest.raises(ValueError, match="l2/inf"):
        TNovo(norm_type=1)
    assert not topt._use_tree({"w": torch.zeros(8_000_000 - 1)})
    big = {"w": torch.zeros(TNovo.TREE_THRESHOLD - 8), "b": torch.zeros(8)}
    st = topt.init(big)
    assert set(st.slots) == {"m", "vnorm"}
    assert set(st.slots["vnorm"]) == {"w", "b"}                    # tree
    assert st.slots["vnorm"]["w"].shape == ()
    small = topt.init({"w": torch.ones(3)})
    assert small.slots["vnorm"]["float32"].shape == (1,)          # arena


def test_novograd_kernel_refuses_cpu_tensors():
    before = ops.launch_counts()
    x = torch.ones(N)
    with pytest.raises(ValueError):
        TK.novograd_kernel(x, x, x, x, torch.ones(7), False)
    assert ops.launch_counts() == before
    assert ops.KERNELS["novograd"] is TK.novograd_kernel


def _small_bert_params():
    enc = jmodels.BertEncoder(100, hidden=32, layers=2, heads=2, max_len=16)
    return enc.init(jax.random.PRNGKey(0),
                    jnp.zeros((1, 16), jnp.int32))["params"]


def _port_order(carried):
    tenc = tmodels.BertEncoder(100, hidden=32, layers=2, heads=2, max_len=16,
                               device="cpu")
    return {n: carried[n] for n, _ in tenc.named_parameters()}


@pytest.mark.parametrize("strategy", ["arena", "tree"])
def test_state_carried_from_jax_continues_the_run(strategy):
    """Two JAX steps, params and state carried to the port (``vnorm``: a
    vector in the JAX partition's sorted-name order, mapped by name to the
    port's order), then one more step on each side."""
    params = _small_bert_params()
    rng = np.random.RandomState(4)
    leaves, treedef = jax.tree_util.tree_flatten(params)

    def grads():
        return jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(rng.randn(*l.shape).astype(np.float32) * 0.1)
            for l in leaves])

    kw = dict(lr=1e-2, betas=(0.95, 0.98), weight_decay=1e-3,
              strategy=strategy)
    jopt = JNovo(**kw)
    jp, js = params, jopt.init(params)
    for _ in range(2):
        jp, js = jopt.step(grads(), js, jp)
    tp = _port_order(params_from_jax(jax.device_get(jp), device="cpu"))
    ts = fused_state_from_jax(jax.device_get(js), jax.device_get(jp), tp,
                              device="cpu")
    assert int(ts.count) == 2 and set(ts.slots) == {"m", "vnorm"}
    want_v, got_v = _vnorm_by_name(js, jp), _vnorm_by_name(ts, tp)
    assert set(got_v) == set(tp)
    assert len({float(x) for x in got_v.values()}) == len(tp)  # all differ
    for name, x in want_v.items():
        assert np32(got_v[name]).tobytes() == np32(x).tobytes(), name
    g = grads()
    jp, js = jopt.step(g, js, jp)
    tg = params_from_jax(jax.device_get(g), device="cpu")
    tp, ts = TNovo(**kw).step(tg, ts, tp)
    want_p = params_from_jax(jax.device_get(jp), device="cpu")
    want = fused_state_from_jax(jax.device_get(js), jax.device_get(jp), tp,
                                device="cpu")
    assert int(ts.count) == int(want.count) == 3
    for k in tp:
        close(tp[k], want_p[k])
    for s in ("m", "vnorm"):
        for key, val in want.slots[s].items():
            close(ts.slots[s][key], val)


@pytest.mark.parametrize("strategy", ["arena", "tree"])
def test_bert_o1_three_steps_track_jax(strategy):
    kw = dict(lr=1e-3, betas=(0.95, 0.98), eps=1e-8, weight_decay=1e-3,
              strategy=strategy)
    runs = bert_runs(JNovo(**kw), TNovo(**kw))
    (js, _, _), (ts, _) = runs[-1]
    assert int(ts.step) == int(js.step) == 3
    assert int(ts.opt_state.count) == int(js.opt_state.count) == 3
    jl = [j[1] for j, _ in runs]
    tl = [t[1] for _, t in runs]
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]


def test_bert_fp16_skipped_first_step_keeps_the_first_step_rule():
    kw = dict(lr=1e-3, betas=(0.95, 0.98), eps=1e-8, weight_decay=1e-3,
              strategy="arena")
    runs = bert_runs(JNovo(**kw), TNovo(**kw), steps=3, half="float16",
                     inject=(0,))
    for i, ((js, jl, jfin), (ts, tl)) in enumerate(runs):
        assert jfin == (i != 0), i
        sj, st = js.scalers[0], ts.scalers[0]
        assert np.float32(st.loss_scale.item()).tobytes() == \
            np.asarray(sj.loss_scale, np.float32).tobytes(), i
        assert int(st.growth_tracker) == int(sj.growth_tracker), i
        assert int(ts.step) == int(js.step) == i, i
        assert int(ts.opt_state.count) == int(js.opt_state.count) == i, i
        if i:
            np.testing.assert_allclose(tl, jl, rtol=2e-2)
    # count 0 after the skip: step 1 took the norms themselves on both
    # sides (within 1e-2: the packages' fp16 grads part by 1e-4 to 1e-3;
    # a missed first-step rule gives (1 - beta2) of the norm, 50x smaller)
    (js1, _, _), (ts1, _) = runs[1]
    jv = _vnorm_by_name(js1.opt_state, js1.params)
    tv = _vnorm_by_name(ts1.opt_state, ts1.params)
    for name, x in jv.items():
        close(tv[name], x, rtol=1e-2)
    assert runs[0][1][0].scalers[0].loss_scale.item() == 2.0 ** 15
