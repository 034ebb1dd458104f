"""The JAX package's L1 cross-product grid, on the port.

``tests/test_l1_cross_product.py`` trains a Conv + BN + Dense + LayerNorm
+ Dense net 6 steps over O0-O3 x {dynamic, static 128, none} x
keep_batchnorm_fp32 {on, off} and holds its fused path against its oracle
path. Here every cell of the port's kernel path (``_torch_l1_grid.run(...,
fused=True)``: the fused LayerNorm and cross-entropy, FusedSGD on the
arena; their plain versions on the CPU) is held against the JAX package's
oracle path (``_run(policy, fused=False)``) from the same flax init and the
same batches: skip decisions, loss scales and step counts bit for bit;
losses and params at the JAX test's tolerances, 1e-5 where the compute
dtype is f32 and 2e-2 in half. The cells validation rejects are skipped as
the JAX test skips them. Then the fp16 overflow injection (steps 2 and 4
poisoned) on both packages and the port's resume after 3 steps, bit for
bit.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_l1_grid as G
from apex_tpu import amp as jamp
from apex_tpu_torch import amp as tamp
from apex_tpu_torch.convert import resnet_variables_from_jax
from test_l1_cross_product import Net as JNet
from test_l1_cross_product import _data, _run
from test_l1_cross_product import GRID as JGRID

_JH = {torch.bfloat16: "bfloat16", torch.float16: "float16"}


def _jax_policy(ol, sv, kb, **kw):
    try:
        return jamp.Policy.from_opt_level(ol, loss_scale=sv,
                                          keep_batchnorm_fp32=kb, **kw)
    except ValueError:
        return None


def _variables(jpolicy):
    """The JAX test's init (``Net.init`` at PRNGKey(0) on the first batch),
    by port name."""
    xs, _ = _data()
    v = JNet(fused=False, dtype=jpolicy.compute_dtype).init(
        jax.random.PRNGKey(0), xs[0], train=True)
    return resnet_variables_from_jax(v["params"], v["batch_stats"],
                                     device="cpu")


def _jax_leaves(params):
    from apex_tpu_torch.convert import params_from_jax
    return params_from_jax(params, device="cpu")


def _check(label, port, jax_out, tol):
    losses, finites, scales, st, _ = port
    jl, jst, jsc, jfin = jax_out
    assert finites == jfin, f"{label}: skip decisions diverged"
    assert scales == jsc, f"{label}: loss-scale schedule diverged"
    assert int(st.step) == int(jst.step)
    np.testing.assert_allclose(losses, jl, rtol=tol, atol=tol,
                               err_msg=f"{label}: losses")
    want = _jax_leaves(jst.params)
    for k, a in st.params.items():
        b = want[k]
        if a.dim() == 4:
            b = b.contiguous()
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=tol, atol=tol,
                                   err_msg=f"{label}: {k}")


def test_grid_matches_the_jax_test_grid():
    assert [(ol, sn, kb) for ol, sn, _, kb in G.GRID] == \
        [(ol, sn, kb) for ol, sn, _, kb in JGRID]
    assert (G.BATCH, G.HW, G.CH, G.HIDDEN, G.CLASSES, G.STEPS, G.LR,
            G.MOMENTUM) == (8, 8, 8, 32, 10, 6, 0.05, 0.9)
    xs, ys = _data(poison_steps=(2,))
    txs, tys = G.data(poison_steps=(2,), device="cpu")
    assert np.array_equal(txs.numpy(), np.asarray(xs), equal_nan=True)
    assert np.array_equal(tys.numpy(), np.asarray(ys))


@pytest.mark.parametrize(
    "opt_level,scale_name,scale_val,keep_bn", G.GRID,
    ids=[f"{ol}-{sn}-bn{int(kb)}" for ol, sn, sv, kb in G.GRID])
def test_port_kernel_path_matches_the_jax_oracle(opt_level, scale_name,
                                                 scale_val, keep_bn):
    tpol = G.policy(opt_level, scale_val, keep_bn)
    jpol = _jax_policy(opt_level, scale_val, keep_bn)
    assert (tpol is None) == (jpol is None)
    if tpol is None:
        pytest.skip("combination rejected by Policy validation")
    port = G.run(tpol, True, device="cpu", variables=_variables(jpol))
    tol = 1e-5 if tpol.compute_dtype == torch.float32 else 2e-2
    _check(f"{opt_level}-{scale_name}-bn{int(keep_bn)}", port,
           _run(jpol, fused=False), tol)


def test_fp16_overflow_injection_matches_jax():
    poison = (2, 4)
    tpol = G.policy("O2", "dynamic", True, half_dtype=torch.float16)
    jpol = _jax_policy("O2", "dynamic", True, half_dtype="float16")
    port = G.run(tpol, True, poison_steps=poison, device="cpu",
                    variables=_variables(jpol))
    jout = _run(jpol, fused=False, poison_steps=poison)
    _check("fp16 overflow", port, jout, 2e-2)
    _, finites, scales, st, _ = port
    assert [i for i, f in enumerate(finites) if not f] == list(poison)
    assert int(st.step) == G.STEPS - len(poison)
    assert scales[2] == scales[1] / 2 and scales[4] == scales[3] / 2


def test_resume_after_three_steps_bitwise():
    tpol = G.policy("O2", "dynamic", True, half_dtype=torch.float16)
    whole = G.run(tpol, True, device="cpu")
    first = G.run(tpol, True, device="cpu", steps=3)
    saved = (first[3]._replace(params={k: v.clone() for k, v in
                                       first[3].params.items()}),
             {k: v.clone() for k, v in first[4].items()}, 3)
    rest = G.run(tpol, True, device="cpu", steps=G.STEPS - 3,
                    state=saved)
    assert rest[0] == whole[0][3:]
    assert rest[2] == whole[2][3:]
    for k, v in whole[3].params.items():
        assert torch.equal(rest[3].params[k], v), k


def test_plain_path_matches_the_kernel_path_as_on_the_card():
    """The chip's comparison, here on the plain versions: the port's kernel
    path (FusedSGD on the arena) against its plain path (plain references,
    RefSGD) at O2 bf16."""
    tpol = G.policy("O2", "dynamic", True)
    fused = G.run(tpol, True, device="cpu")
    ref = G.run(tpol, False, device="cpu")
    assert G.compare("O2 bf16", fused, ref, 2e-2) <= 2e-2
