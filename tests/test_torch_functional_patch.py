"""The port's O1 functional patch against the JAX package's.

- The patch itself (the JAX tests of ``TestFunctionalPatch`` on torch's
  namespaces): raw ``torch.einsum``/``matmul``/``F.conv2d`` cast to half
  and the softmax family to f32 under ``auto_cast(O1)``; user ``(module,
  attr)`` registrations, their overlap with the built-ins and their
  removal; every attribute restored (the same function object) when the
  outermost scope exits, on an exception too; O2 installs nothing; the
  innermost of nested scopes wins; a thread that never entered
  ``auto_cast`` sees no cast; an explicit module dtype and the f32
  attention oracle are not reached.
- The reach: each public op of ``apex_tpu_torch.ops`` (and the MHA
  modules' ``impl="default"`` attention) and the BERT,
  ResNet and DCGAN forwards run inside and outside ``auto_cast(O1)``, and
  under O1 with and without the patch, beside their JAX counterparts; an
  output changes in the port exactly when it changes in the JAX package.
- The MLP under O1: the port's forward and grads against the JAX MLP's
  under the JAX package's functional patch (bf16 and fp16), at a
  tolerance that the f32 forward misses; the plain version's half-operand
  mode against the JAX kernel's body under the patch, and bit for bit
  against a one-k-at-a-time FMA model of the kernel.
"""

import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.func import functional_call

from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu import ops as jops
from apex_tpu.ops import mlp as JM
from apex_tpu.ops import multihead_attn as JMHA
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import models as tmodels
from apex_tpu_torch import ops as tops
from apex_tpu_torch.amp import functional_patch as fp
from apex_tpu_torch.convert import params_from_jax, resnet_variables_from_jax
from apex_tpu_torch.ops import mlp as TM
from apex_tpu_torch.ops import multihead_attn as TMHA

O1 = tamp.Policy.from_opt_level("O1")
JO1 = jamp.Policy.from_opt_level("O1")


# --- the patch ----------------------------------------------------------------

def test_raw_ops_run_half_and_softmax_f32_under_o1():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    with tamp.auto_cast(O1):
        assert torch.einsum("ij,jk->ik", a, b).dtype == torch.bfloat16
        assert torch.matmul(a, b).dtype == torch.bfloat16
        assert torch.mm(a, b).dtype == torch.bfloat16
        assert torch.bmm(a[None], b[None]).dtype == torch.bfloat16
        assert F.conv2d(torch.ones(1, 3, 8, 8),
                        torch.ones(4, 3, 3, 3)).dtype == torch.bfloat16
        h = torch.ones(4, 4, dtype=torch.bfloat16)
        assert torch.softmax(h, -1).dtype == torch.float32
        assert F.log_softmax(h, -1).dtype == torch.float32
        # methods and the operator stay unpatched, as JAX's array methods
        assert (a @ b).dtype == torch.float32
        assert a.matmul(b).dtype == torch.float32
    assert torch.matmul(a, b).dtype == torch.float32


def test_user_registry_live_scope_and_restore():
    ns = types.SimpleNamespace(mm=lambda a, b: torch.matmul(a, b),
                               sm=lambda a: torch.softmax(a, -1))
    a = torch.ones(4, 4)
    orig_mm, orig_sm = ns.mm, ns.sm
    try:
        tamp.register_half_op((ns, "mm"))
        tamp.register_float_op((ns, "sm"))
        with tamp.auto_cast(O1):
            assert ns.mm is not orig_mm
            assert ns.mm(a, a).dtype == torch.bfloat16
            assert ns.sm(a.to(torch.bfloat16)).dtype == torch.float32
        assert ns.mm is orig_mm and ns.sm is orig_sm
        assert ns.mm(a, a).dtype == torch.float32

        ns.late = lambda a, b: a + b
        orig_late = ns.late
        with tamp.auto_cast(O1):
            tamp.register_half_op((ns, "late"))
            assert ns.late(a, a).dtype == torch.bfloat16
            tamp.register_float_op((ns, "late"))
            h = a.to(torch.bfloat16)
            assert ns.late(h, h).dtype == torch.float32
        assert ns.late is orig_late
        with tamp.auto_cast(O1):
            with tamp.auto_cast(O1):
                assert getattr(ns.mm, "__wrapped_by_apex_tpu__", False)
            assert ns.mm is not orig_mm
        assert ns.mm is orig_mm
    finally:
        for name in ("mm", "sm", "late"):
            tamp.unregister_op((ns, name))
    assert not any(t[0] is ns for t in fp._USER_HALF_TARGETS)
    assert not any(t[0] is ns for t in fp._USER_FLOAT_TARGETS)


def test_registry_overlapping_a_builtin_never_leaks():
    a = torch.ones(4, 4)
    h = a.to(torch.bfloat16)
    orig = torch.matmul
    try:
        tamp.register_half_op((torch, "matmul"))
        with tamp.auto_cast(O1):
            assert torch.matmul(a, a).dtype == torch.bfloat16
            tamp.register_float_op((torch, "matmul"))
            assert torch.matmul(h, h).dtype == torch.float32
        assert torch.matmul is orig, "stale wrapper leaked"
        with tamp.auto_cast(O1):
            assert torch.matmul(h, h).dtype == torch.float32
        assert torch.matmul is orig
    finally:
        tamp.unregister_op((torch, "matmul"))
    ns = types.SimpleNamespace(f=lambda x: x + x)
    orig_f = ns.f
    with tamp.auto_cast(O1):
        tamp.register_half_op((ns, "f"))
        assert ns.f is not orig_f
        tamp.unregister_op((ns, "f"))
        assert ns.f is orig_f
    assert ns.f is orig_f


def test_unregister_never_strips_the_builtin_surface():
    a = torch.ones(4, 4)
    orig = torch.matmul
    with tamp.auto_cast(O1):
        tamp.register_half_op((torch, "matmul"))
        tamp.unregister_op((torch, "matmul"))
        assert torch.matmul(a, a).dtype == torch.bfloat16
        tamp.unregister_op((torch, "softmax"))       # never registered
        assert torch.softmax(a.to(torch.bfloat16), -1).dtype == \
            torch.float32
    assert torch.matmul is orig


def test_every_attribute_restored_by_identity():
    targets = fp._HALF_TARGETS + fp._FLOAT_TARGETS
    before = {(id(m), n): getattr(m, n) for m, n in targets}
    with tamp.auto_cast(O1):
        assert all(getattr(m, n) is not before[(id(m), n)]
                   for m, n in targets)
        with tamp.auto_cast(O1):
            assert getattr(torch.einsum, "__wrapped_by_apex_tpu__", False)
        assert torch.einsum is not before[(id(torch), "einsum")]
    assert all(getattr(m, n) is before[(id(m), n)] for m, n in targets)
    with pytest.raises(RuntimeError):
        with tamp.auto_cast(O1):
            raise RuntimeError("boom")
    assert all(getattr(m, n) is before[(id(m), n)] for m, n in targets)
    assert fp._patch_count == 0 and not fp._originals


@pytest.mark.parametrize("level", ["O0", "O2", "O3"])
def test_only_o1_patches(level):
    orig = torch.einsum
    with tamp.auto_cast(tamp.Policy.from_opt_level(level)):
        assert torch.einsum is orig
        assert fp.half_operand_dtype() is None
    with tamp.auto_cast(O1.replace(enabled=False)):
        assert torch.einsum is orig


def test_nested_policies_innermost_wins():
    p16 = tamp.Policy.from_opt_level("O1", half_dtype=torch.float16)
    a = torch.ones(4, 4)
    with tamp.auto_cast(O1):
        assert torch.matmul(a, a).dtype == torch.bfloat16
        with tamp.auto_cast(p16):
            assert torch.matmul(a, a).dtype == torch.float16
            assert fp.half_operand_dtype() == torch.float16
        assert torch.matmul(a, a).dtype == torch.bfloat16
        with fp.suspend():
            assert torch.matmul(a, a).dtype == torch.float32
            assert fp.half_operand_dtype() is None


def test_a_thread_outside_auto_cast_sees_no_cast():
    a = torch.ones(4, 4)
    seen, inside = {}, threading.Event()
    release = threading.Event()

    def other():
        inside.wait()
        seen["patched"] = torch.matmul is not ORIG
        seen["dtype"] = torch.matmul(a, a).dtype
        seen["mode"] = fp.half_operand_dtype()
        release.set()

    ORIG = torch.matmul
    t = threading.Thread(target=other)
    t.start()
    with tamp.auto_cast(O1):
        inside.set()
        release.wait(30)
    t.join(30)
    assert seen == {"patched": True, "dtype": torch.float32, "mode": None}
    assert torch.matmul is ORIG


def test_explicit_module_dtype_and_the_f32_oracle_are_not_reached():
    conv = tmodels.Conv(3, 4, (3, 3), dtype=torch.float32, device="cpu")
    torch.nn.init.normal_(conv.weight)
    with tamp.auto_cast(O1):
        assert conv(torch.ones(1, 8, 8, 3)).dtype == torch.float32
        q = torch.ones(1, 8, 2, 16)
        assert tops.attention_reference(q, q, q).dtype == torch.float32
    with jamp.auto_cast(JO1):
        jq = jnp.ones((1, 8, 2, 16), jnp.float32)
        assert jops.attention_reference(jq, jq, jq).dtype == jnp.float32


# --- the reach ----------------------------------------------------------------

def _rng(seed=0):
    return np.random.RandomState(seed)


def _arena(seed=0, n=65536):
    return _rng(seed).randn(n).astype(np.float32)


def _op_cases():
    """{name: (jax callable, port callable, numpy args)}; each callable
    takes the args converted to its framework."""
    r = _rng(1)
    q = r.randn(1, 64, 2, 64).astype(np.float32)
    k = r.randn(1, 64, 2, 64).astype(np.float32)
    v = r.randn(1, 64, 2, 64).astype(np.float32)
    x2 = r.randn(16, 64).astype(np.float32)
    w64, b64 = (1 + 0.1 * r.randn(64)).astype(np.float32), \
        (0.1 * r.randn(64)).astype(np.float32)
    logits = r.randn(16, 48).astype(np.float32)
    labels = r.randint(0, 48, 16).astype(np.int32)
    xbn = r.randn(4, 4, 4, 8).astype(np.float32)
    rbn = r.randn(4, 4, 4, 8).astype(np.float32)
    sbn, bbn = (1 + 0.1 * r.randn(8)).astype(np.float32), \
        (0.1 * r.randn(8)).astype(np.float32)
    dims = [13, 32, 16, 8]
    xm = r.randn(8, 13).astype(np.float32)
    ws = [(r.randn(a, b) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    bs = [(0.1 * r.randn(b)).astype(np.float32) for b in dims[1:]]
    p, g, m, vv = (_arena(i) for i in range(4))
    vv = np.abs(vv)
    ratio = np.ones(65536, np.float32)
    jcfg, tcfg = (jops.bn_act.make_cfg(relu=True),
                  tops.bn_act.make_cfg(relu=True))
    adam_kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                   weight_decay=0.01, step=1)
    lamb_kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
                   step=1)
    nov_kw = dict(lr=1e-3, beta1=0.95, beta2=0.98, eps=1e-8,
                  weight_decay=1e-3, step=1)
    return {
        "attention_reference": (jops.attention_reference,
                                tops.attention_reference, (q, k, v)),
        # impl="default" of the MHA modules: not suspended in the JAX
        # package, so its einsums are reached
        "dropout_attention": (
            lambda *a: JMHA._dropout_attention(None, *a, None, False, 0.0,
                                               True),
            lambda *a: TMHA._dropout_attention(*a, None, False, 0.0, True,
                                               None), (q, k, v)),
        "mask_softmax_dropout": (jops.mask_softmax_dropout,
                                 tops.mask_softmax_dropout, (x2,)),
        "flash_attention": (jops.flash_attention, tops.flash_attention,
                            (q, k, v)),
        "flash_attention_lse": (jops.attention.flash_attention_lse,
                                tops.flash_attention_lse, (q, k, v)),
        "fused_layer_norm": (jops.fused_layer_norm, tops.fused_layer_norm,
                             (x2,)),
        "fused_layer_norm_affine": (jops.fused_layer_norm_affine,
                                    tops.fused_layer_norm_affine,
                                    (x2, w64, b64)),
        "layer_norm_reference": (jops.layer_norm_reference,
                                 tops.layer_norm_reference, (x2, w64, b64)),
        "softmax_cross_entropy_loss": (jops.softmax_cross_entropy_loss,
                                       tops.softmax_cross_entropy_loss,
                                       (logits, labels)),
        "softmax_cross_entropy_reference": (
            jops.softmax_cross_entropy_reference,
            tops.softmax_cross_entropy_reference, (logits, labels)),
        "bn_act_train": (lambda *a: jops.bn_act.bn_act_train(*a, jcfg),
                         lambda *a: tops.bn_act_train(*a, tcfg),
                         (xbn, sbn, bbn)),
        "bn_add_act_train": (
            lambda *a: jops.bn_act.bn_add_act_train(*a, jcfg),
            lambda *a: tops.bn_add_act_train(*a, tcfg),
            (xbn, rbn, sbn, bbn)),
        "bn_act_reference": (jops.bn_act.bn_act_reference,
                             tops.bn_act_reference, (xbn, sbn, bbn)),
        "fused_mlp": (lambda x, *wb: JM.fused_mlp(x, wb[:3], wb[3:]),
                      lambda x, *wb: tops.fused_mlp(x, wb[:3], wb[3:]),
                      (xm, *ws, *bs)),
        "mlp_reference": (lambda x, *wb: JM.mlp_reference(x, wb[:3],
                                                          wb[3:]),
                          lambda x, *wb: tops.mlp_reference(x, wb[:3],
                                                            wb[3:]),
                          (xm, *ws, *bs)),
        "multi_tensor_scale": (lambda b: jops.multi_tensor_scale(b, 0.5),
                               lambda b: tops.multi_tensor_scale(b, 0.5),
                               (p,)),
        "multi_tensor_axpby": (
            lambda x, y: jops.multi_tensor_axpby(2.0, x, 0.5, y),
            lambda x, y: tops.multi_tensor_axpby(2.0, x, 0.5, y), (p, g)),
        "multi_tensor_l2norm": (jops.multi_tensor_l2norm,
                                tops.multi_tensor_l2norm, (p,)),
        "multi_tensor_maxnorm": (jops.multi_tensor_maxnorm,
                                 tops.multi_tensor_maxnorm, (p,)),
        "adam_update": (
            lambda *a: jops.optim_kernels.adam_update(*a, **adam_kw),
            lambda *a: tops.adam_update(*a, **adam_kw), (p, g, m, vv)),
        "sgd_update": (
            lambda *a: jops.optim_kernels.sgd_update(*a, lr=0.1,
                                                     momentum=0.9),
            lambda *a: tops.sgd_update(*a, lr=0.1, momentum=0.9),
            (p, g, m)),
        "adagrad_update": (
            lambda *a: jops.optim_kernels.adagrad_update(*a, lr=1e-2),
            lambda *a: tops.adagrad_update(*a, lr=1e-2), (p, g, vv)),
        "lamb_stage1": (
            lambda *a: jops.optim_kernels.lamb_stage1(*a, **lamb_kw),
            lambda *a: tops.lamb_stage1(*a, **lamb_kw), (p, g, m, vv)),
        "lamb_stage2": (
            lambda *a: jops.optim_kernels.lamb_stage2(*a, lr=1e-3),
            lambda *a: tops.lamb_stage2(*a, lr=1e-3), (p, g, ratio)),
        "novograd_update": (
            lambda *a: jops.optim_kernels.novograd_update(*a, **nov_kw),
            lambda *a: tops.novograd_update(*a, **nov_kw), (p, g, m, vv)),
    }


#: the ops whose output the JAX package's patch reaches: the MLP's kernel
#: body and its chain call the patched ``jnp.dot``, the MHA modules'
#: default path the patched ``jnp.einsum``
_REACHED = {"fused_mlp", "mlp_reference", "dropout_attention"}


def _leaves_np(out):
    if isinstance(out, torch.Tensor):
        return [out.detach().float().numpy()]
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _leaves_np(o)]
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in _leaves_np(out[k])]
    return [np.asarray(jnp.asarray(out, jnp.float32))]


def _differ(a, b):
    la, lb = _leaves_np(a), _leaves_np(b)
    return any(x.shape != y.shape or not np.array_equal(x, y)
               for x, y in zip(la, lb)) or len(la) != len(lb)


def _scopes(amp_mod, policy):
    """The outputs' scopes: inside ``auto_cast(O1)``, outside, and inside
    ``auto_cast`` of O1 without the patch."""
    import contextlib
    return (lambda: amp_mod.auto_cast(policy), contextlib.nullcontext,
            lambda: amp_mod.auto_cast(policy.replace(patch_ops=False)))


def _reach(run, amp_mod, policy):
    """(output under O1, changed by auto_cast, changed by the patch)."""
    outs = []
    for scope in _scopes(amp_mod, policy):
        with scope():
            outs.append(run())
    return outs[0], _differ(outs[0], outs[1]), _differ(outs[0], outs[2])


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_op_reach_matches_jax(name):
    """Inside vs outside ``auto_cast(O1)``, and O1 with vs without the
    patch: the port's output changes exactly when the JAX package's
    does, and only the MLP's does."""
    jfn, tfn, args = _op_cases()[name]

    def jrun():
        return jfn(*[jnp.asarray(a) for a in args])

    def trun():
        return tfn(*[torch.tensor(a) if a.dtype != np.int32 else
                     torch.tensor(a, dtype=torch.int64) for a in args])

    _, j_io, j_p = _reach(jrun, jamp, JO1)
    _, t_io, t_p = _reach(trun, tamp, O1)
    assert (t_io, t_p) == (j_io, j_p), (name, (t_io, t_p), (j_io, j_p))
    assert j_p == (name in _REACHED)


def _bert():
    jenc = jmodels.BertEncoder(512, hidden=64, layers=1, heads=1,
                               max_len=64)
    jp = jax.jit(jenc.init)(jax.random.PRNGKey(0),
                            jnp.zeros((1, 64), jnp.int32))["params"]
    tenc = tmodels.BertEncoder(512, hidden=64, layers=1, heads=1,
                               max_len=64, device="cpu")
    tenc.load_state_dict(params_from_jax(jp, device="cpu"))
    r = _rng(2)
    toks, labels = r.randint(0, 512, (1, 64)), r.randint(0, 512, (1, 64))

    def jrun():        # traced afresh in each scope
        return jax.jit(lambda: jmodels.mlm_loss(
            jenc, {"params": jp}, jnp.asarray(toks), jnp.asarray(labels)))()

    def trun():
        return tmodels.mlm_loss(tenc, None, torch.tensor(toks),
                                torch.tensor(labels))
    return jrun, trun


def _redraw(v, seed):
    rng = _rng(seed)

    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            out = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif "scale" in name:
            out = 1.0 + 0.3 * rng.randn(*leaf.shape)
        elif "var" in name:
            out = 0.5 + rng.rand(*leaf.shape)
        else:
            out = 0.2 * rng.randn(*leaf.shape)
        return jnp.asarray(out.astype(np.float32))
    return jax.tree_util.tree_map_with_path(redraw, v)


def _conv_model(jm, tm, x):
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x[:1]), train=True))
    params, stats = _redraw(v["params"], 3), _redraw(v["batch_stats"], 4)
    tp, ts = resnet_variables_from_jax(params, stats, device="cpu")

    def jrun():        # traced afresh in each scope
        return jax.jit(lambda: jm.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x),
            train=True, mutable=["batch_stats"])[0])()

    def trun():
        return functional_call(tm, {**tp, **ts}, (torch.tensor(x),),
                               {"train": True})[0]
    return jrun, trun


def _resnet():
    x = _rng(5).randn(2, 16, 16, 3).astype(np.float32)
    return _conv_model(
        jmodels.ResNet(stage_sizes=[1, 1], num_classes=10, width=8),
        tmodels.ResNet(stage_sizes=[1, 1], num_classes=10, width=8,
                       device="cpu"), x)


def _dcgan(which):
    if which == "generator":
        x = _rng(6).randn(2, 1, 1, 8).astype(np.float32)
        return _conv_model(jmodels.Generator(nz=8, ngf=4),
                           tmodels.Generator(nz=8, ngf=4, device="cpu"), x)
    x = _rng(7).rand(2, 64, 64, 3).astype(np.float32)
    return _conv_model(jmodels.Discriminator(ndf=4),
                       tmodels.Discriminator(ndf=4, device="cpu"), x)


@pytest.mark.parametrize("model", ["bert", "resnet", "generator",
                                   "discriminator"])
def test_model_forward_reach_matches_jax(model):
    """The O1 forwards: ``auto_cast`` changes both packages' outputs (the
    module casts), the patch changes neither (every reached entry point
    sits in a module whose dtype ``auto_cast`` decided, or in a kernel the
    JAX patch never reaches), and the two O1 outputs agree."""
    jrun, trun = {"bert": _bert, "resnet": _resnet,
                  "generator": lambda: _dcgan("generator"),
                  "discriminator": lambda: _dcgan("discriminator")}[model]()
    jo, j_io, j_p = _reach(jrun, jamp, JO1)
    to, t_io, t_p = _reach(trun, tamp, O1)
    assert j_io and t_io
    assert not j_p and not t_p
    jo, to = _leaves_np(jo)[0], _leaves_np(to)[0]
    np.testing.assert_allclose(to, jo, rtol=5e-2,
                               atol=5e-2 * np.abs(jo).max())


# --- the MLP under O1 ---------------------------------------------------------

_HALF = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _mlp_pair(sizes=(13, 64, 32, 8), n=16, seed=0):
    jm = jops.MLP(list(sizes))
    x = _rng(seed).randn(n, sizes[0]).astype(np.float32)
    jp = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    m = tops.MLP(list(sizes), device="cpu")
    m.load_state_dict(params_from_jax(jp, device="cpu"))
    return jm, jp, m, x


@pytest.mark.parametrize("half", [torch.bfloat16, torch.float16])
def test_mlp_o1_forward_and_grads_match_jax(half):
    """Forward within 1e-6 of the JAX O1 forward's max, where the f32
    forward (the parent's, with no half-operand mode) misses by more than
    1e-4; grads within 1e-6 of each JAX grad's max."""
    jm, jp, m, x = _mlp_pair()
    jpol = jamp.Policy.from_opt_level("O1", half_dtype=_HALF[half])
    tpol = tamp.Policy.from_opt_level("O1", half_dtype=half)

    def jloss(p):
        with jamp.auto_cast(jpol):
            y = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(y * y), y

    (_, jy), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = {k: v.detach().requires_grad_(True)
          for k, v in m.named_parameters()}
    with tamp.auto_cast(tpol):
        ty = functional_call(m, tp, (torch.tensor(x),))
    tg = dict(zip(tp, torch.autograd.grad((ty * ty).sum(),
                                          list(tp.values()))))
    jy = np.asarray(jy)
    scale = np.abs(jy).max()
    assert np.abs(ty.detach().numpy() - jy).max() <= 1e-6 * scale
    f32 = m(torch.tensor(x)).detach().numpy()
    assert np.abs(f32 - jy).max() > 1e-4 * scale, \
        "the f32 forward must miss the O1 forward"
    jgp = params_from_jax(jg, device="cpu")
    for k, g in tg.items():
        want = jgp[k].numpy()
        assert np.abs(g.numpy() - want).max() <= 1e-6 * np.abs(want).max(), k


def test_mlp_o1_backward_is_not_rounded_as_in_jax():
    """The JAX MLP's backward (``_mlp_bwd``) is traced when ``jax.grad``
    transposes, after the user's ``auto_cast`` block, so its products are
    not rounded. The port's backward runs after the block too and agrees;
    a backward run inside the block (rounded operands) misses JAX's grads
    by orders of magnitude more."""
    jm, jp, m, x = _mlp_pair(seed=1)

    def jloss(p):
        with jamp.auto_cast(JO1):
            y = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(y * y)

    jg = params_from_jax(jax.grad(jloss)(jp), device="cpu")
    errs = {}
    for inside in (False, True):
        tp = {k: v.detach().requires_grad_(True)
              for k, v in m.named_parameters()}
        with tamp.auto_cast(O1):
            y = functional_call(m, tp, (torch.tensor(x),))
            loss = (y * y).sum()
            if inside:
                grads = torch.autograd.grad(loss, list(tp.values()))
        if not inside:
            grads = torch.autograd.grad(loss, list(tp.values()))
        errs[inside] = max(
            float(np.abs(g.numpy() - jg[k].numpy()).max()
                  / np.abs(jg[k].numpy()).max())
            for k, g in zip(tp, grads))
    assert errs[False] <= 1e-6
    assert errs[True] > 100 * max(errs[False], 1e-7)


@pytest.mark.parametrize("half", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("act,bias", [("relu", True), ("sigmoid", False)])
def test_plain_half_operand_mode_matches_the_jax_kernel_under_o1(half, act,
                                                                 bias):
    """``mlp_fused_reference(..., operand_dtype=half)`` against the JAX
    kernel (Pallas, interpret mode) run under ``auto_cast(O1)``: within
    1e-6 of the max; without the mode it misses by more than 1e-4."""
    r = _rng(11)
    dims = [13, 64, 32, 8]
    x = r.randn(24, 13).astype(np.float32)
    ws = [(r.randn(a, b) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    bs = [(0.1 * r.randn(b)).astype(np.float32) for b in dims[1:]] \
        if bias else None
    with jamp.auto_cast(jamp.Policy.from_opt_level(
            "O1", half_dtype=_HALF[half])):
        want = np.asarray(JM._fused_mlp_fwd_impl(
            jnp.asarray(x), tuple(jnp.asarray(w) for w in ws),
            None if bs is None else tuple(jnp.asarray(b) for b in bs), act))
    tw = [torch.tensor(w) for w in ws]
    tb = None if bs is None else [torch.tensor(b) for b in bs]
    got = TM.mlp_fused_reference(torch.tensor(x), tw, tb, act, half).numpy()
    off = TM.mlp_fused_reference(torch.tensor(x), tw, tb, act).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-6 * scale
    assert np.abs(off - want).max() > 1e-4 * scale


def _fma_model(x, weights, biases, act, od):
    """The kernel's arithmetic: operands rounded to ``od``, each output
    summed one k at a time from 0 by f32 FMA (an exact f64 product and sum
    rounded once; the products of half operands are exact in f32)."""
    h = x.float()
    for i, w in enumerate(weights):
        a, wr = h.to(od).double(), w.float().to(od).double()
        acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32)
        for k in range(w.shape[0]):
            acc = (acc.double() + a[:, k:k + 1] * wr[k:k + 1]).float()
        if biases is not None:
            acc = acc + biases[i].float()
        h = {"relu": torch.relu, "none": lambda t: t,
             "sigmoid": lambda t: 1.0 / (1.0 + torch.exp(-t))}[act](acc)
    return h.to(x.dtype)


@pytest.mark.parametrize("od", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("xdt,wdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float16, torch.bfloat16)])
def test_plain_half_operand_mode_is_the_kernels_fma_chain(od, xdt, wdt):
    """At the DLRM bottom MLP's widths: the plain version's mode equals
    the kernel's one-k-at-a-time FMA chain bit for bit (the basis of the
    chip's bitwise kernel check)."""
    r = _rng(12)
    dims = [13, 512, 256, 128]
    x = torch.tensor(r.randn(6, 13).astype(np.float32)).to(xdt)
    ws = [torch.tensor((r.randn(a, b) * np.sqrt(2.0 / a)).astype(
        np.float32)).to(wdt) for a, b in zip(dims, dims[1:])]
    bs = [torch.tensor((0.1 * r.randn(b)).astype(np.float32)).to(wdt)
          for b in dims[1:]]
    got = TM.mlp_fused_reference(x, ws, bs, "relu", od)
    assert torch.equal(got, _fma_model(x, ws, bs, "relu", od))


def test_fused_mlp_reads_the_mode_from_the_patch(monkeypatch):
    seen = []
    real = TM.mlp_fused_reference

    def spy(x, w, b, act, operand_dtype=None):
        seen.append(operand_dtype)
        return real(x, w, b, act, operand_dtype)

    monkeypatch.setattr(TM, "mlp_fused_reference", spy)
    x = torch.ones(4, 13)
    ws = [torch.ones(13, 8) / 13]
    p16 = tamp.Policy.from_opt_level("O1", half_dtype=torch.float16)
    TM.fused_mlp(x, ws)
    with tamp.auto_cast(O1):
        TM.fused_mlp(x, ws)
        with tamp.auto_cast(p16):
            TM.fused_mlp(x, ws)
        with fp.suspend():
            TM.fused_mlp(x, ws)
    with tamp.auto_cast(tamp.Policy.from_opt_level("O2")):
        TM.fused_mlp(x, ws)
    assert seen == [None, torch.bfloat16, torch.float16, None, None]
    with pytest.raises(ValueError, match="operand_dtype"):
        TM.mlp_fwd_kernel(x, ws, None, "relu", torch.float32)
