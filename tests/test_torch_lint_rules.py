"""The port's lint rules against the JAX package's, one seeded violation and
its negative twin per case.

Each case builds the same step twice — in JAX, linted by the JAX package's
``lint_step`` with its trace-side rules only (a ``jax.make_jaxpr`` trace,
no compile), and in PyTorch, linted by the port's ``lint_step`` (one run
on the CPU) — and asserts the same set of (rule id, severity). The cases
are those of ``tests/test_lint.py``'s seeded-violation classes for the
rules the port has (APX001–004, APX204, APX301–305), in the port's idiom:
a JAX key reused is a ``torch.Generator`` state drawn from twice, a
``jax.lax.cond`` a ``torch.where``, ``rng_bit_generator``'s dropped state
a draw on the default generator, ``pure_callback`` a host value.

Where the JAX twin cannot be an oracle the port is held to the rule's
contract instead: APX004's firing case (jax 0.9.0's debug print escapes
the JAX rule), APX002's firing case (it needs ``jax.experimental.
enable_x64``, which not every jax build has), and APX305's widened product
(``aten.mm.dtype`` has no CPU kernel here: a record built by hand; the
card runs it in ``chip_smoke.py``'s phase lint_card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import lint as jlint
from apex_tpu.optim import FusedSGD as JSGD
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import lint as tlint
from apex_tpu_torch.lint.record import Lit, Node, StepRecord, Value
from apex_tpu_torch.optim import FusedSGD as TSGD

#: the JAX lint's trace-side rules (no HLO compile)
JRULES = tuple(jlint._JAXPR_RULES | jlint._PRECISION_RULES)


def _ids(findings):
    return {(f.id, f.severity) for f in findings}


def jax_set(fn, *args, policy=None, rules=JRULES):
    return _ids(jlint.lint_step(fn, *args, policy=policy, rules=rules))


def torch_set(fn, *args, policy=None, rules=None):
    return _ids(tlint.lint_step(fn, *args, policy=policy, rules=rules))


def _rng(seed=0):
    return np.random.RandomState(seed)


def _pair(*shape, dtype=np.float32, seed=0):
    a = _rng(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(a).astype(dtype), torch.tensor(a).to(
        {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
         jnp.float16: torch.float16}[dtype])


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _pol(lv):
    return jamp.Policy.from_opt_level(lv), tamp.Policy.from_opt_level(lv)


# --- APX001 rng-key-reuse ----------------------------------------------------

def _t_reseeded(g, x):
    g.manual_seed(0)
    a = torch.randn(4, generator=g)
    g.manual_seed(0)
    return a + torch.rand(4, generator=g) + x


def _t_two_alike(g1, g2, x):
    return torch.randn(4, generator=g1) + torch.rand(4, generator=g2) + x


def _t_forked(g, g2):
    g2.set_state(g.get_state())          # the second stream is the first
    return torch.randn(2, generator=g) + torch.randn(2, generator=g2)


@pytest.mark.parametrize("case", ["raw", "typed", "split_then_use",
                                  "clean_split"])
def test_rng_key_reuse(case):
    if case == "raw":
        want = jax_set(lambda k, x: jax.random.normal(k, (4,))
                       + jax.random.uniform(k, (4,)) + x,
                       jax.random.PRNGKey(0), jnp.zeros(4))
        got = torch_set(_t_reseeded, _gen(3), torch.zeros(4))
    elif case == "typed":
        want = jax_set(lambda k, x: jax.random.normal(k, (4,))
                       + jax.random.uniform(k, (4,)) + x,
                       jax.random.key(0), jnp.zeros(4))
        got = torch_set(_t_two_alike, _gen(0), _gen(0), torch.zeros(4))
    elif case == "split_then_use":
        def f(key):
            k1, _ = jax.random.split(key)
            return jax.random.normal(key, (2,)) + jax.random.normal(k1, (2,))
        want = jax_set(f, jax.random.PRNGKey(0))
        got = torch_set(_t_forked, _gen(1), _gen(2))
    else:
        def f(key, x):
            k1, k2 = jax.random.split(key)
            return (jax.random.normal(k1, (4,))
                    + jax.random.uniform(k2, (4,)) + x)
        want = jax_set(f, jax.random.PRNGKey(0), jnp.zeros(4))
        got = torch_set(_t_two_alike, _gen(1), _gen(2), torch.zeros(4))
    assert got == want
    assert (("APX001", "error") in got) == (case != "clean_split")


def test_rng_reuse_finding_counts_the_draws():
    rep = tlint.lint_step(_t_reseeded, _gen(3), torch.zeros(4))
    hit, = rep.by_rule("rng-key-reuse")
    assert hit.count == 2 and hit.severity == "error"


# --- APX002 f64-creep --------------------------------------------------------

def test_f64_creep_fires_by_contract():
    # the JAX twin needs enable_x64, which not every jax build has: the
    # rule's contract is a float64 carried input or op output, an error
    rep = tlint.lint_step(lambda x: torch.sum(x.double()), torch.zeros(4))
    hits = rep.by_rule("f64-creep")
    assert len(hits) == 1 and hits[0].severity == "error"
    assert hits[0].count >= 1
    rep = tlint.lint_step(lambda x: x.sum(), torch.zeros(4,
                                                        dtype=torch.float64))
    assert "<argument>" in rep.by_rule("f64-creep")[0].op


def test_f64_clean_twin():
    jx, tx = _pair(4)
    assert torch_set(lambda x: torch.sum(x * 2), tx) == \
        jax_set(lambda x: jnp.sum(x * 2), jx) == set()


# --- APX003 fp32-matmul-in-amp -----------------------------------------------

@pytest.mark.parametrize("case", ["fires_o2", "bf16_clean", "no_policy"])
def test_fp32_matmul_in_amp(case):
    dt = jnp.bfloat16 if case == "bf16_clean" else np.float32
    ja, ta = _pair(8, 128, dtype=dt)
    jb, tb = _pair(128, 128, dtype=dt, seed=1)
    jp, tp = _pol("O2") if case != "no_policy" else (None, None)
    got = torch_set(lambda a, b: a @ b, ta, tb, policy=tp)
    assert got == jax_set(lambda a, b: a @ b, ja, jb, policy=jp)
    assert (("APX003", "warning") in got) == (case == "fires_o2")


# --- APX004 host-callback-in-step --------------------------------------------

def _t_printed(x):
    print(f"x={x.sum().item()}")
    return x * 2


def test_host_sync_fires_by_contract():
    # jax 0.9.0's debug print escapes the JAX rule: the port is held to
    # the contract (every HOST_SYNC_OPS op and card→host copy, an error)
    rep = tlint.lint_step(_t_printed, torch.ones(4))
    hit, = rep.by_rule("host-callback-in-step")
    assert hit.severity == "error"
    assert hit.op == "aten::_local_scalar_dense"
    assert _ids(rep.findings) == {("APX004", "error")}


def test_host_sync_clean_twin():
    jx, tx = _pair(4)
    assert torch_set(lambda x: x * 2, tx) == jax_set(lambda x: x * 2, jx) \
        == set()


# --- APX301–305: the precision pass ------------------------------------------

def _t_loss_scaled_cast(p, x, s):
    p = p.detach().requires_grad_()
    g, = torch.autograd.grad(((x @ p) ** 2).mean() * s, p)
    return g.to(torch.float8_e5m2)


def _j_loss_scaled_cast(params, x, s):
    return jax.grad(lambda p: jnp.mean((x @ p) ** 2) * s)(params).astype(
        jnp.float8_e5m2)


def _grad_args():
    jp, tp = _pair(4, 4)
    jx, tx = _pair(8, 4, seed=1)
    return (jp, jx, jnp.float32(1024.0)), (tp, tx, torch.tensor(1024.0))


@pytest.mark.parametrize("case", ["raw_fp8", "site_scaled", "loss_scaled",
                                  "fp16_no_policy", "fp16_o3", "bf16"])
def test_unscaled_narrow_cast(case):
    jx, tx = _pair(16)
    js, ts = jnp.float32(64.0), torch.tensor(64.0)
    if case == "raw_fp8":
        want = jax_set(lambda x: x.astype(jnp.float8_e4m3fn), jx)
        rep = tlint.lint_step(lambda x: x.to(torch.float8_e4m3fn), tx)
        hit, = rep.by_rule("unscaled-narrow-cast")
        assert (hit.dtype_from, hit.dtype_to, hit.scale_provenance) == \
            ("fp32", "fp8_e4m3", "unscaled")
        got = _ids(rep.findings)
    elif case == "site_scaled":
        want = jax_set(lambda x, s: (x * s).astype(jnp.float8_e4m3fn),
                       jx, js)
        got = torch_set(lambda x, s: (x * s).to(torch.float8_e4m3fn),
                        tx, ts)
    elif case == "loss_scaled":
        jargs, targs = _grad_args()
        want = jax_set(_j_loss_scaled_cast, *jargs)
        rep = tlint.lint_step(_t_loss_scaled_cast, *targs)
        hit, = rep.by_rule("unscaled-narrow-cast")
        assert hit.scale_provenance == "loss-scaled"
        got = _ids(rep.findings)
    elif case.startswith("fp16"):
        jp, tp = _pol("O3") if case == "fp16_o3" else (None, None)
        want = jax_set(lambda x: x.astype(jnp.float16), jx, policy=jp)
        got = torch_set(lambda x: x.to(torch.float16), tx, policy=tp)
    else:
        want = jax_set(lambda x: x.astype(jnp.bfloat16), jx)
        got = torch_set(lambda x: x.to(torch.bfloat16), tx)
    assert got == want
    fires = {"raw_fp8": "error", "loss_scaled": "error",
             "fp16_no_policy": "warning"}.get(case)
    assert (("APX301", fires) in got) if fires else \
        not any(i == "APX301" for i, _ in got)


@pytest.mark.parametrize("case", ["chained", "round_trip", "arith_resets"])
def test_double_rounding(case):
    if case == "chained":
        jx, tx = _pair(16)
        want = jax_set(lambda x, s: (x.astype(jnp.bfloat16)
                                     * s.astype(jnp.bfloat16)).astype(
                                         jnp.float8_e4m3fn),
                       jx, jnp.float32(8.0))
        rep = tlint.lint_step(lambda x, s: (x.to(torch.bfloat16)
                                            * s.to(torch.bfloat16)).to(
                                                torch.float8_e4m3fn),
                              tx, torch.tensor(8.0))
        hit, = rep.by_rule("double-rounding")
        assert (hit.dtype_from, hit.dtype_to) == ("bf16", "fp8_e4m3")
        got = _ids(rep.findings)
    elif case == "round_trip":
        jx, tx = _pair(16, dtype=jnp.bfloat16)
        want = jax_set(lambda x: x.astype(jnp.float32).astype(jnp.bfloat16),
                       jx)
        got = torch_set(lambda x: x.float().to(torch.bfloat16), tx)
    else:
        (jx, tx), (jy, ty) = _pair(16), _pair(16, seed=1)
        want = jax_set(lambda x, y: (x.astype(jnp.bfloat16)
                                     + y.astype(jnp.bfloat16)).astype(
                                         jnp.float32).astype(jnp.bfloat16),
                       jx, jy)
        got = torch_set(lambda x, y: (x.to(torch.bfloat16)
                                      + y.to(torch.bfloat16)).float().to(
                                          torch.bfloat16), tx, ty)
    assert got == want
    assert (("APX302", "warning") in got) == (case == "chained")


def _t_leaky(unscale):
    def step(p, x, s):
        p = p.detach().requires_grad_()
        g, = torch.autograd.grad(((x @ p) ** 2).mean() * s, p)
        if unscale:
            inv = (1.0 / s).float()
            g = g.float() * inv
        return p.detach() - 0.1 * g
    return step


def _j_leaky(unscale):
    def step(params, x, scale):
        g = jax.grad(lambda p: jnp.mean((x @ p) ** 2) * scale)(params)
        if unscale:
            inv = (1.0 / scale).astype(jnp.float32)
            g = g.astype(jnp.float32) * inv
        return params - 0.1 * g
    return step


@pytest.mark.parametrize("case", ["missing", "unscaled", "one_path",
                                  "scalar_out"])
def test_scale_leak(case):
    jargs, targs = _grad_args()
    if case in ("missing", "unscaled"):
        want = jax_set(_j_leaky(case == "unscaled"), *jargs)
        rep = tlint.lint_step(_t_leaky(case == "unscaled"), *targs)
        got = _ids(rep.findings)
        if case == "missing":
            hit, = rep.by_rule("scale-leak")
            assert hit.scale_provenance == "loss-scaled"
            assert hit.scope == "result"
    elif case == "one_path":
        jx, tx = _pair(8)

        def jf(pred, x, s):
            _ = jnp.sum(x) * s
            return jax.lax.cond(pred, lambda: x * s, lambda: x)

        def tf(pred, x, s):
            x.sum() * s                         # mints the token
            return torch.where(pred, x * s, x)

        want = jax_set(jf, jnp.asarray(True), jx, jnp.float32(128.0))
        got = torch_set(tf, torch.tensor(True), tx, torch.tensor(128.0))
    else:
        jx, tx = _pair(8)
        want = jax_set(lambda x, s: jnp.sum(x) * s, jx, jnp.float32(2.0))
        got = torch_set(lambda x, s: x.sum() * s, tx, torch.tensor(2.0))
    assert got == want
    assert (("APX303", "error") in got) == (case in ("missing", "one_path"))


@pytest.mark.parametrize("case", ["o2_error", "o3_info", "no_policy",
                                  "master_chain"])
def test_master_weight_violation(case):
    if case == "master_chain":
        (jm, tm), (jg, tg) = _pair(32, 32), _pair(32, 32, dtype=jnp.bfloat16,
                                                  seed=1)
        jp, tp = _pol("O2")

        def jf(m, g):
            new = m - 0.1 * g.astype(jnp.float32)
            return new.astype(jnp.bfloat16), new

        def tf(m, g):
            new = m - 0.1 * g.float()
            return new.to(torch.bfloat16), new

        want = jax_set(jf, jm, jg, policy=jp)
        got = torch_set(tf, tm, tg, policy=tp)
    else:
        (jw, tw), (jg, tg) = (_pair(32, 32, dtype=jnp.bfloat16),
                              _pair(32, 32, dtype=jnp.bfloat16, seed=1))
        jp, tp = {"o2_error": _pol("O2"), "o3_info": _pol("O3"),
                  "no_policy": (None, None)}[case]
        want = jax_set(lambda p, g: p - 0.1 * g, jw, jg, policy=jp)
        rep = tlint.lint_step(lambda p, g: p - 0.1 * g, tw, tg, policy=tp)
        got = _ids(rep.findings)
        if case == "o2_error":
            hit, = rep.by_rule("master-weight-violation")
            assert (hit.dtype_from, hit.dtype_to) == ("bf16", "fp32")
    assert got == want
    sev = {"o2_error": "error", "o3_info": "info"}.get(case)
    assert [s for i, s in got if i == "APX304"] == ([sev] if sev else [])


@pytest.mark.parametrize("case", ["fp16_dot", "bf16_dot", "fp16_cumsum",
                                  "bf16_cumsum", "widened_sum"])
def test_half_accumulation(case):
    dt = jnp.float16 if case.startswith("fp16") else jnp.bfloat16
    if case.endswith("dot"):
        (ja, ta), (jb, tb) = _pair(4, 4, dtype=dt), _pair(4, 4, dtype=dt,
                                                          seed=1)
        want = jax_set(lambda a, b: a @ b, ja, jb)
        got = torch_set(lambda a, b: a @ b, ta, tb)
    elif case.endswith("cumsum"):
        ja, ta = _pair(64, dtype=dt)
        want = jax_set(lambda a: jnp.cumsum(a), ja)
        rep = tlint.lint_step(lambda a: torch.cumsum(a, 0), ta)
        got = _ids(rep.findings)
        assert rep.by_rule("half-accumulation")[0].op == "aten::cumsum"
    else:
        ja, ta = _pair(64, dtype=dt)
        want = jax_set(lambda a: jnp.sum(a, dtype=jnp.float32), ja)
        got = torch_set(lambda a: torch.sum(a, dtype=torch.float32), ta)
    assert got == want
    sev = {"fp16_dot": "warning", "fp16_cumsum": "warning",
           "bf16_cumsum": "info"}.get(case)
    assert [s for i, s in got if i == "APX305"] == ([sev] if sev else [])


def _mm_record(out_dtype):
    """A hand-built record of ``aten.mm`` on two fp16 carried inputs with an
    ``out_dtype`` result (``aten.mm.dtype``, which has no CPU kernel)."""
    vals = {i: Value(i, torch.float16, (4, 4), "cuda:0", "input",
                     path=f"args[{i}]") for i in (0, 1)}
    vals[2] = Value(2, out_dtype, (4, 4), "cuda:0", "op", node=0)
    op = "aten::mm.dtype" if out_dtype != torch.float16 else \
        "aten::mm.default"
    node = Node(0, "aten", op, (0, 1, Lit(out_dtype)), (2,))
    return StepRecord([node], vals, [0, 1], [2], {2: "result"}, [], "mm")


def test_widened_product_is_clean():
    # JAX: dot_general with preferred_element_type=f32 is clean; the port's
    # counterpart is aten.mm.dtype (out_dtype=f32), run on the card by
    # chip_smoke.py's lint_card; here the pass reads a record built by hand
    (ja, _), (jb, _) = _pair(4, 4, dtype=jnp.float16), _pair(
        4, 4, dtype=jnp.float16, seed=1)
    want = jax_set(lambda a, b: jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32),
        ja, jb)
    assert want == set()
    assert _ids(tlint.lint_step(None, record=_mm_record(
        torch.float32))) == want
    assert _ids(tlint.lint_step(None, record=_mm_record(
        torch.float16))) == {("APX305", "warning")}


# --- the acceptance pins: every opt level -----------------------------------

def _t_bad_step(p, x, s):
    p = p.detach().requires_grad_()
    g, = torch.autograd.grad(((x @ p) ** 2).mean() * s, p)
    return p.detach() - 0.1 * g.to(torch.float8_e4m3fn).float()


def _j_bad_step(params, x, scale):
    g = jax.grad(lambda p: jnp.mean((x @ p) ** 2) * scale)(params)
    return params - 0.1 * g.astype(jnp.float8_e4m3fn).astype(jnp.float32)


@pytest.mark.parametrize("lv", ["O0", "O1", "O2", "O3"])
def test_mis_scaled_toy_caught_at_every_opt_level(lv):
    jargs, targs = _grad_args()
    jp, tp = _pol(lv)
    rules = ("unscaled-narrow-cast", "scale-leak")
    want = jax_set(_j_bad_step, *jargs, policy=jp, rules=rules)
    rep = tlint.lint_step(_t_bad_step, *targs, policy=tp, rules=rules)
    assert _ids(rep.findings) == want == {("APX301", "error"),
                                          ("APX303", "error")}


def _amp_steps(lv):
    jp, tp = _pol(lv)
    x, y = np.zeros((8, 64), np.float32), np.zeros((8, 64), np.float32)
    japp = jamp.Amp(jp, JSGD(lr=0.1, momentum=0.9))
    jstate = japp.init({"w": jnp.zeros((64, 64)), "b": jnp.zeros((64,))})
    tapp = tamp.Amp(tp, TSGD(lr=0.1, momentum=0.9))
    tstate = tapp.init({"w": torch.zeros(64, 64), "b": torch.zeros(64)})

    def jstep(state, x, y):
        def loss_fn(mp):
            return jnp.mean((x @ mp["w"] + mp["b"] - y) ** 2)
        loss, grads, state, fin = japp.backward(state, loss_fn)
        return japp.apply_gradients(state, grads, fin), loss

    def tstep(state, x, y):
        def loss_fn(mp):
            # JAX promotes a half weight against the f32 input to f32
            return torch.mean((x @ mp["w"].float() + mp["b"].float()
                               - y) ** 2)
        loss, grads, state, fin = tapp.backward(state, loss_fn)
        return tapp.apply_gradients(state, grads, fin), loss

    return ((jstep, jstate, jnp.asarray(x), jnp.asarray(y), jp),
            (tstep, tstate, torch.tensor(x), torch.tensor(y), tp))


@pytest.mark.parametrize("lv", ["O0", "O1", "O2", "O3"])
def test_amp_step_has_no_precision_errors(lv):
    (jstep, js, jx, jy, jp), (tstep, ts, tx, ty, tp) = _amp_steps(lv)
    prec = tuple(jlint._PRECISION_RULES)
    want = jax_set(jstep, js, jx, jy, policy=jp, rules=prec)
    got = torch_set(tstep, ts, tx, ty, policy=tp, rules=prec)
    assert not [s for _, s in got if s == "error"]
    assert got == want


# --- APX204 nondeterminism ---------------------------------------------------

def _t_host_value(x):
    return x + x.sum().item()


def _t_off_path(x):
    x.sum().item()
    return x * 2


@pytest.mark.parametrize("case", ["default_draw", "carried_draw",
                                  "commit_path_host", "off_path_host",
                                  "scatter_add", "unique_scatter"])
def test_nondeterminism(case):
    rules = ("nondeterminism",)
    jx, tx = _pair(4)
    if case == "default_draw":
        def jf(x, key):
            _, bits = jax.lax.rng_bit_generator(key, (4,), dtype=jnp.uint32)
            return x + bits.astype(jnp.float32)
        want = jax_set(jf, jx, jnp.zeros((4,), jnp.uint32), rules=rules)
        got = torch_set(lambda x: x + torch.rand(4), tx, rules=rules)
    elif case == "carried_draw":
        def jf(x, key):
            key2, bits = jax.lax.rng_bit_generator(key, (4,),
                                                   dtype=jnp.uint32)
            return x + bits.astype(jnp.float32), key2
        want = jax_set(jf, jx, jnp.zeros((4,), jnp.uint32), rules=rules)
        got = torch_set(lambda x, g: x + torch.rand(4, generator=g), tx,
                        _gen(0), rules=rules)
    elif case == "commit_path_host":
        want = jax_set(lambda x: x + jax.pure_callback(
            lambda a: np.asarray(a) * 2,
            jax.ShapeDtypeStruct(x.shape, x.dtype), x), jx, rules=rules)
        rep = tlint.lint_step(_t_host_value, tx, rules=rules)
        assert "commit" in rep.findings[0].message
        got = _ids(rep.findings)
    elif case == "off_path_host":
        def jf(x):
            jax.debug.print("v={v}", v=x.sum())
            return x * 2
        want = jax_set(jf, jx, rules=rules)
        got = torch_set(_t_off_path, tx, rules=rules)
    else:
        idx = np.array([0, 1, 0] if case == "scatter_add" else [0, 1, 2])
        jv, tv = _pair(3, seed=1)
        want = jax_set(lambda x, i, v: x.at[i].add(
            v, unique_indices=case == "unique_scatter"),
            jnp.zeros(4), jnp.asarray(idx), jv, rules=rules)
        if case == "scatter_add":
            got = torch_set(lambda x, i, v: x.index_put(
                (i,), v, accumulate=True), torch.zeros(4),
                torch.tensor(idx), tv, rules=rules)
        else:
            got = torch_set(lambda x, i, v: x.index_put((i,), x[i] + v),
                            torch.zeros(4), torch.tensor(idx), tv,
                            rules=rules)
    assert got == want
    sev = {"default_draw": "error", "commit_path_host": "error",
           "scatter_add": "warning"}.get(case)
    assert got == ({("APX204", sev)} if sev else set())


def test_generator_made_in_the_step_is_not_replayable():
    def step(x):
        g = torch.Generator().manual_seed(0)
        return x + torch.rand(4, generator=g)

    rep = tlint.lint_step(step, torch.zeros(4), rules=("nondeterminism",))
    hit, = rep.findings
    assert hit.severity == "error" and "made inside the step" in hit.message
    assert torch.Generator is tlint.record._BASE_GENERATOR


def test_int_accumulate_is_exempt():
    rep = tlint.lint_step(lambda x, i: x.index_add(0, i, torch.ones(
        3, dtype=torch.int32)), torch.zeros(4, dtype=torch.int32),
        torch.tensor([0, 1, 0]), rules=("nondeterminism",))
    assert rep.findings == []
