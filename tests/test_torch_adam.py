"""Parity of the port's Adam (``ops.adam_update``, ``optim.FusedAdam``) with
the JAX package's.

- ``adam_update``'s plain version against the JAX ``adam_update`` (its
  Pallas kernel in interpret mode) on one BUFFER_MULTIPLE-long buffer, over
  AdamW mode × bias correction × a bf16 copy-out: f32 outputs at rtol 1e-6
  with an atol of 1e-6 times the output's largest magnitude (the same f32
  formulas; the bias corrections' powers and the divisions may round in
  the last bit); a bf16 output within one bf16 ulp.
- ``FusedAdam``, arena and tree, three steps against the JAX ``FusedAdam``
  on f32 params and on a mix of f32 and bf16 params, at the same tolerance
  (bf16 params within one bf16 ulp). The arena's slot buffers are compared
  per tensor after ``unflatten``: the packages order leaves differently.
- ``"auto"`` takes the arena for DCGAN's generator and discriminator (3.6M
  and 2.8M params, below the 8M threshold), and the kernel wrapper refuses
  CPU tensors and unpadded buffers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import arena as JA
from apex_tpu.ops import optim_kernels as JK
from apex_tpu.optim import FusedAdam as JAdam
from apex_tpu_torch import arena as TA
from apex_tpu_torch import models as tmodels
from apex_tpu_torch import ops
from apex_tpu_torch.arena import BUFFER_MULTIPLE
from apex_tpu_torch.ops import optim_kernels as TK
from apex_tpu_torch.optim import FusedAdam as TAdam

N = BUFFER_MULTIPLE
_ULP_BF16 = 2.0 ** -7


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want):
    got, want = _np32(got), _np32(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def _within_bf16_ulp(got, want):
    got, want = _np32(got), _np32(want)
    assert np.all(np.abs(got - want) <= np.abs(want) * _ULP_BF16)


def _buffers(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(N).astype(np.float32),
            (rng.randn(N) * 3.0).astype(np.float32),
            (rng.randn(N) * 0.1).astype(np.float32),
            np.abs(rng.randn(N) * 0.01).astype(np.float32))


@pytest.mark.parametrize("copy", [False, True])
@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_adam_update_matches_jax(adam_w_mode, bias_correction, copy):
    p, g, m, v = _buffers(0)
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              step=3, adam_w_mode=adam_w_mode,
              bias_correction=bias_correction, grad_scale=0.5)
    want = JK.adam_update(*(jnp.asarray(x) for x in (p, g, m, v)),
                          param_copy_dtype=jnp.bfloat16 if copy else None,
                          **kw)
    got = TK.adam_update(*(torch.tensor(x) for x in (p, g, m, v)),
                         param_copy_dtype=torch.bfloat16 if copy else None,
                         **kw)
    assert len(got) == len(want) == (4 if copy else 3)
    assert [t.dtype for t in got[:3]] == [torch.float32] * 3
    for a, b in zip(got[:3], want[:3]):
        _close(a, b)
    if copy:
        assert got[3].dtype == torch.bfloat16
        _within_bf16_ulp(got[3], want[3])


def test_adam_update_device_scalars_and_bf16_params():
    """A bf16 param buffer, and lr / step / grad scale as 0-d tensors (as
    the optimizer and amp pass them from the device)."""
    p, g, m, v = _buffers(1)
    pb = torch.tensor(p).to(torch.bfloat16)
    kw = dict(beta1=0.5, beta2=0.99, eps=1e-6, weight_decay=0.05,
              adam_w_mode=False)
    want = JK.adam_update(jnp.asarray(pb.float().numpy(), jnp.bfloat16),
                          *(jnp.asarray(x) for x in (g, m, v)),
                          lr=jnp.float32(2e-3), step=jnp.int32(2),
                          grad_scale=jnp.float32(0.25), **kw)
    got = TK.adam_update(pb, *(torch.tensor(x) for x in (g, m, v)),
                         lr=torch.tensor(2e-3),
                         step=torch.tensor(2, dtype=torch.int32),
                         grad_scale=torch.tensor(0.25), **kw)
    assert got[0].dtype == torch.bfloat16
    _within_bf16_ulp(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        _close(a, b)


_SHAPES = {"w1": (16, 8), "b1": (8,), "k": (4, 4, 3, 5), "scale": (5,)}
_KWARGS = [
    dict(lr=2e-4, betas=(0.5, 0.999)),
    dict(lr=1e-2, weight_decay=0.01),
    dict(lr=1e-2, weight_decay=0.01, adam_w_mode=False),
    dict(lr=5e-3, betas=(0.8, 0.99), eps=1e-6, bias_correction=False),
]
_MIXES = {"f32": {}, "f32+bf16": {"b1": (jnp.bfloat16, torch.bfloat16),
                                 "k": (jnp.bfloat16, torch.bfloat16)}}


def _three_steps(strategy, kw, mix="f32", seed=0):
    """Three steps on both sides; returns the port's and JAX's (params,
    state, per-tensor slots)."""
    rng = np.random.RandomState(seed)
    vals = {k: rng.randn(*s).astype(np.float32) for k, s in _SHAPES.items()}
    dts = {k: _MIXES[mix].get(k, (jnp.float32, torch.float32))
           for k in _SHAPES}
    jp = {k: jnp.asarray(v, dts[k][0]) for k, v in vals.items()}
    tp = {k: torch.tensor(v).to(dts[k][1]) for k, v in vals.items()}
    jopt = JAdam(strategy=strategy, **kw)
    topt = TAdam(strategy=strategy, **kw)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        grads = {k: (rng.randn(*s) * 3.0).astype(np.float32)
                 for k, s in _SHAPES.items()}
        jp, js = jopt.step({k: jnp.asarray(v) for k, v in grads.items()},
                           js, jp)
        tp, ts = topt.step({k: torch.tensor(v) for k, v in grads.items()},
                           ts, tp)
    if strategy == "arena":
        tspec, jspec = TA.plan(tp), JA.plan(jp)
        tslots = {s: TA.unflatten(ts.slots[s], tspec) for s in ("m", "v")}
        jslots = {s: JA.unflatten(js.slots[s], jspec) for s in ("m", "v")}
    else:
        tslots, jslots = ts.slots, js.slots
    return (tp, ts, tslots), (jp, js, jslots)


@pytest.mark.parametrize("mix", list(_MIXES))
@pytest.mark.parametrize("strategy", ["tree", "arena"])
@pytest.mark.parametrize("kw", _KWARGS)
def test_three_steps_match_jax(kw, strategy, mix):
    (tp, ts, tslots), (jp, js, jslots) = _three_steps(strategy, kw, mix)
    assert int(ts.count) == int(js.count) == 3
    if strategy == "arena":
        want_parts = {"float32"} | ({"bfloat16"} if _MIXES[mix] else set())
        assert set(ts.slots["m"]) == set(js.slots["m"]) == want_parts
    for k in _SHAPES:
        assert tp[k].dtype == _MIXES[mix].get(k, (None, torch.float32))[1]
        if tp[k].dtype == torch.bfloat16:
            _within_bf16_ulp(tp[k], jp[k])
        else:
            _close(tp[k], jp[k])
        for s in ("m", "v"):
            assert tslots[s][k].dtype == torch.float32
            _close(tslots[s][k], jslots[s][k])


@pytest.mark.parametrize("kw", _KWARGS)
def test_arena_matches_tree_in_the_port(kw):
    """m at the Adam tolerance; v and p at rtol 2e-5, because the arena
    kernel takes (1 − β2) in f32 from the f32 β2 (as the JAX package's
    kernel does) and the tree update from the Python float (as the JAX
    tree update does): 1.3e-5 apart at β2 = 0.999."""
    (ap, _, aslots), _ = _three_steps("arena", kw)
    (tp, _, tslots), _ = _three_steps("tree", kw)
    for k in _SHAPES:
        _close(aslots["m"][k], tslots["m"][k])
        for got, want in ((ap[k], tp[k]), (aslots["v"][k], tslots["v"][k])):
            want = want.numpy()
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                                       atol=1e-6 * np.abs(want).max())


def test_auto_takes_the_arena_for_dcgan():
    """``"auto"`` keeps the JAX package's 8M rule: DCGAN's generator
    (3,576,704 params in 13 tensors) and discriminator (2,765,568 in 11)
    take the arena, one f32 partition each; inputs stay untouched."""
    for model, n, leaves in (
            (tmodels.Generator(device="meta"), 3_576_704, 13),
            (tmodels.Discriminator(device="meta"), 2_765_568, 11)):
        params = dict(model.named_parameters())
        assert len(params) == leaves
        assert sum(p.numel() for p in params.values()) == n
        assert not TAdam()._use_tree(params)
        assert TAdam(strategy="tree")._use_tree(params)
    topt = TAdam(lr=2e-4, betas=(0.5, 0.999))
    assert (topt.eps, topt.weight_decay, topt.adam_w_mode,
            topt.bias_correction, topt.strategy) == (1e-8, 0.0, True, True,
                                                     "auto")
    p = {"w": torch.ones(3)}
    st0 = topt.init(p)
    assert st0.slots["v"]["float32"].numel() == BUFFER_MULTIPLE
    new_p, st = topt.step({"w": torch.full((3,), 0.5)}, st0, p)
    assert int(st.count) == 1 and torch.all(new_p["w"] < 1.0)
    assert torch.equal(p["w"], torch.ones(3))
    assert not st0.slots["m"]["float32"].any()
    with pytest.raises(ValueError):
        TAdam(strategy="flat")


def test_adam_update_refuses_unpadded_buffers():
    x = torch.ones(N + 1024)
    with pytest.raises(ValueError, match="BUFFER_MULTIPLE"):
        TK.adam_update(x, x, x, x, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                       weight_decay=0.0, step=1)


@pytest.mark.parametrize("copy", [None, torch.bfloat16])
def test_adam_kernel_refuses_cpu_tensors(copy):
    before = ops.launch_counts()
    x = torch.ones(N)
    with pytest.raises(ValueError):
        TK.adam_kernel(x, x, x, x, torch.ones(8), True, copy)
    assert ops.launch_counts() == before
    assert ops.KERNELS["adam"] is TK.adam_kernel
