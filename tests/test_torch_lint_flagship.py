"""The flagship steps linted by both packages, and the Pallas bodies the
port's opaque kernel nodes stand in for.

- The structural BERT step (``bench._bert_step_builder``'s: O1 bf16,
  arena LAMB; depth 2, hidden 32, the parity tests' widths) and ResNet
  step (O2 bf16, a two-stage bottleneck ResNet of width 8, arena SGD)
  give the same set of (rule id, severity)
  in both packages, with no error in either. The JAX package's
  ``scatter-add`` detector asks numpy whether the operand is floating,
  and numpy does not count ml_dtypes' bfloat16: it misses the O1
  embedding gradient's bf16 scatter-add, which the rule's contract (a
  float accumulate in an order the device does not fix) covers and the
  port reports. The oracle here is the JAX pass with that predicate asking
  JAX instead. The JAX steps are traced from abstract state
  (``jax.eval_shape`` of the init): the trace is what the lint reads, and
  an eager init in interpret mode would take most of the file's time.
- JAX walks each ``pallas_call`` body for rule hits; the port cannot see a
  CUDA body, so a kernel's node declares what the JAX pass finds inside
  its Pallas body (``precision_pass.KERNEL_FINDINGS``). Every Pallas kernel
  the port replaces is traced here at small shapes (the flagships' LN,
  cross-entropy, flash, BN, LAMB and SGD kernels, and the MLP, Adam,
  Adagrad, NovoGrad and multi-tensor ones), and the JAX pass's findings
  inside ``pallas_call`` bodies equal that table: none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import lint as jlint
from apex_tpu import models as jmodels
from apex_tpu import ops as jops
from apex_tpu import optim as joptim
from apex_tpu.lint import spmd_pass as jspmd
from apex_tpu_torch import lint as tlint
from apex_tpu_torch import models as tmodels
from apex_tpu_torch import train
from apex_tpu_torch.lint.precision_pass import KERNEL_FINDINGS

JRULES = tuple(jlint._JAXPR_RULES | jlint._PRECISION_RULES)


def _jax_floating(aval):
    dt = getattr(aval, "dtype", None)
    return dt is not None and jnp.issubdtype(dt, jnp.floating)


def _ids(findings):
    return {(f.id, f.severity) for f in findings}


def _jax_findings(jaxpr, policy):
    return (jlint.lint_jaxpr(jaxpr, policy=policy)
            + jspmd.nondeterminism_jaxpr_findings(jaxpr)
            + jlint.precision_analysis(jaxpr, policy=policy).findings)


def _in_pallas(findings):
    return sorted({(f.id, f.severity, f.op) for f in findings
                   if "pallas_call" in (f.scope or "")})


def _declared():
    return sorted({(rule, sev) for v in KERNEL_FINDINGS.values()
                   for rule, sev, _, _ in v})


@pytest.fixture
def bf16_is_float(monkeypatch):
    monkeypatch.setattr(jspmd, "_is_float_dtype", _jax_floating)


def _jax_bert():
    """``bench._bert_step_builder``'s step at depth 2, hidden 32."""
    pol = jamp.Policy.from_opt_level("O1")
    enc = jmodels.BertEncoder(512, hidden=32, layers=2, heads=2, max_len=16)
    toks = jnp.zeros((2, 16), jnp.int32)
    app = jamp.Amp(pol, joptim.FusedLAMB(lr=1e-3))
    state = jax.eval_shape(lambda: app.init(enc.init(
        jax.random.PRNGKey(0), toks[:1])["params"]))

    def step(state, toks, labels):
        def loss_fn(mp):
            with jamp.auto_cast(pol):
                return jmodels.mlm_loss(enc, {"params": mp}, toks, labels)
        loss, grads, state, finite = app.backward(state, loss_fn)
        return app.apply_gradients(state, grads, finite), loss

    return jax.make_jaxpr(step)(state, toks, toks), pol


def test_bert_flagship_same_findings_no_error(bf16_is_float):
    jaxpr, jpol = _jax_bert()
    want = _ids(jlint.lint_step(None, jaxpr=jaxpr, policy=jpol,
                                rules=JRULES))
    tenc = tmodels.BertEncoder(512, hidden=32, layers=2, heads=2,
                               max_len=16, device="cpu")
    step, state, (toks, labels), pol, _ = train.build_bert_step(
        2, 16, encoder=tenc, device="cpu", vocab=512)
    rep = tlint.lint_step(step, state, toks, labels, policy=pol)
    assert _ids(rep.findings) == want
    assert rep.errors == [] and not [s for _, s in want if s == "error"]
    assert ("APX204", "warning") in want         # the bf16 scatter-add
    assert _in_pallas(_jax_findings(jaxpr, jpol)) == _declared()


def _jax_resnet():
    pol = jamp.Policy.from_opt_level("O2")
    jm = jmodels.ResNet(stage_sizes=[1, 1], num_classes=10, width=8,
                        dtype=pol.compute_dtype)
    x = jnp.zeros((4, 32, 32, 3), pol.compute_dtype)
    y = jnp.zeros((4,), jnp.int32)
    app = jamp.Amp(pol, joptim.FusedSGD(lr=0.1, momentum=0.9))
    v, state = jax.eval_shape(lambda: (lambda v: (v, app.init(
        v["params"])))(jm.init(jax.random.PRNGKey(0), x, train=True)))

    def step(state, bs, xb, yb):
        def loss_fn(mp):
            logits, mut = jm.apply({"params": mp, "batch_stats": bs}, xb,
                                   train=True, mutable=["batch_stats"])
            return (jnp.mean(jops.softmax_cross_entropy_loss(logits, yb)),
                    mut["batch_stats"])
        (loss, nbs), g, state, fin = app.backward(state, loss_fn,
                                                  has_aux=True)
        return app.apply_gradients(state, g, fin), nbs, loss

    return jax.make_jaxpr(step)(state, v["batch_stats"], x, y), pol


def test_resnet_flagship_same_findings_no_error(bf16_is_float, monkeypatch):
    monkeypatch.setenv("APEX_TPU_BN_PALLAS_BWD", "1")   # the BN dx kernel
    jaxpr, jpol = _jax_resnet()
    want = _ids(jlint.lint_step(None, jaxpr=jaxpr, policy=jpol,
                                rules=JRULES))
    tm = tmodels.ResNet(stage_sizes=[1, 1], num_classes=10, width=8,
                        dtype=torch.bfloat16, device="cpu")
    step, (st, bs), (x, y), pol, _ = train.build_resnet_step(
        4, 32, model=tm, device="cpu")
    rep = tlint.lint_step(step, st, bs, x, y, policy=pol)
    assert _ids(rep.findings) == want
    assert rep.errors == [] and not [s for _, s in want if s == "error"]
    names = str(jaxpr)
    assert names.count("pallas_call") >= 3          # sums, dx, xentropy
    assert _in_pallas(_jax_findings(jaxpr, jpol)) == _declared()


def _arena_tree():
    rng = np.random.RandomState(0)
    return {"w": jnp.asarray(rng.randn(64, 64).astype(np.float32)),
            "b": jnp.asarray(rng.randn(64).astype(np.float32))}


@pytest.mark.parametrize("kernel", ["mlp", "adam", "adagrad", "novograd",
                                    "multi_tensor"])
def test_no_findings_inside_the_other_pallas_bodies(kernel):
    params = _arena_tree()
    if kernel == "mlp":
        x = jnp.ones((16, 13))
        ws = [jnp.ones((13, 32)) * 0.1, jnp.ones((32, 8)) * 0.1]
        bs = [jnp.zeros((32,)), jnp.zeros((8,))]
        jaxpr = jax.make_jaxpr(lambda x, w, b: jops.fused_mlp(
            x, w, b, "relu"))(x, ws, bs)
    elif kernel == "multi_tensor":
        buf = jnp.ones((65536,))

        def f(b):
            s, _ = jops.multi_tensor_scale(b, 0.5)
            a, _ = jops.multi_tensor_axpby(2.0, b, 3.0, b)
            return s, a, jops.multi_tensor_maxnorm(b)

        jaxpr = jax.make_jaxpr(f)(buf)
    else:
        tx = {"adam": joptim.FusedAdam, "adagrad": joptim.FusedAdagrad,
              "novograd": joptim.FusedNovoGrad}[kernel](lr=1e-3,
                                                        strategy="arena")
        state = tx.init(params)
        grads = jax.tree_util.tree_map(jnp.ones_like, params)
        jaxpr = jax.make_jaxpr(lambda g, s, p: tx.step(g, s, p))(
            grads, state, params)
    assert "pallas_call" in str(jaxpr)
    assert _in_pallas(_jax_findings(jaxpr, None)) == _declared()
