"""Parity of apex_tpu_torch.ops.optim_kernels (LAMB stages) with the JAX
package's Pallas kernels, run in interpret mode, on one BUFFER_MULTIPLE
long buffer made from numpy with a seed.

Tolerance: rtol 1e-6 and an atol of 1e-6 times the output's largest
magnitude (the same f32 formulas; the bias corrections' powers and the
divisions may round differently in the last bit). A bf16 output matches
exactly, or within one bf16 ulp where the f32 result lies on a rounding
boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import optim_kernels as JK
from apex_tpu_torch import ops
from apex_tpu_torch.arena import BUFFER_MULTIPLE
from apex_tpu_torch.ops import optim_kernels as TK

N = BUFFER_MULTIPLE


def _close(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def _buffers(seed=0, p_dtype=np.float32):
    rng = np.random.RandomState(seed)
    p = rng.randn(N).astype(np.float32)
    g = (rng.randn(N) * 3.0).astype(np.float32)
    m = (rng.randn(N) * 0.1).astype(np.float32)
    v = np.abs(rng.randn(N) * 0.01).astype(np.float32)
    return p, g, m, v


@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("grad_averaging", [True, False])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_lamb_stage1_matches_jax(adam_w_mode, grad_averaging,
                                 bias_correction):
    p, g, m, v = _buffers()
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01, step=3,
              bias_correction=bias_correction, adam_w_mode=adam_w_mode,
              clip_scale=0.25, grad_averaging=grad_averaging)
    want = JK.lamb_stage1(*(jnp.asarray(x) for x in (p, g, m, v)), **kw)
    got = TK.lamb_stage1(*(torch.tensor(x) for x in (p, g, m, v)), **kw)
    assert [t.dtype for t in got] == [torch.float32] * 3
    for a, b in zip(got, want):
        _close(a, b)


def test_lamb_stage1_device_scalars_and_bf16_params():
    """A bf16 param buffer, and step / clip given as 0-d tensors (as the
    optimizer passes them from the device)."""
    p, g, m, v = _buffers(1)
    pb = torch.tensor(p).to(torch.bfloat16)
    kw = dict(beta1=0.8, beta2=0.99, eps=1e-6, weight_decay=0.05)
    want = JK.lamb_stage1(jnp.asarray(pb.float().numpy(), jnp.bfloat16),
                          *(jnp.asarray(x) for x in (g, m, v)), step=2,
                          clip_scale=jnp.float32(0.5), **kw)
    got = TK.lamb_stage1(pb, *(torch.tensor(x) for x in (g, m, v)),
                         step=torch.tensor(2, dtype=torch.int32),
                         clip_scale=torch.tensor(0.5), **kw)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("copy", [None, "bfloat16"])
def test_lamb_stage2_matches_jax(copy):
    rng = np.random.RandomState(2)
    p = rng.randn(N).astype(np.float32)
    u = rng.randn(N).astype(np.float32)
    r = np.abs(rng.randn(N)).astype(np.float32)
    tcopy = None if copy is None else torch.bfloat16
    jcopy = None if copy is None else jnp.bfloat16
    want = JK.lamb_stage2(*(jnp.asarray(x) for x in (p, u, r)), lr=1e-2,
                          param_copy_dtype=jcopy)
    got = TK.lamb_stage2(*(torch.tensor(x) for x in (p, u, r)),
                         lr=torch.tensor(1e-2), param_copy_dtype=tcopy)
    if copy is None:
        _close(got, want)
        return
    _close(got[0], want[0])
    assert got[1].dtype == torch.bfloat16
    diff = np.abs(got[1].float().numpy()
                  - np.asarray(jnp.asarray(want[1], jnp.float32)))
    ulp = np.abs(np.asarray(jnp.asarray(want[1], jnp.float32))) * 2.0 ** -7
    assert np.all(diff <= ulp)
    assert np.mean(diff == 0) > 0.999


def test_stages_refuse_unpadded_buffers():
    x = torch.ones(N + 1024)
    with pytest.raises(ValueError, match="BUFFER_MULTIPLE"):
        TK.lamb_stage1(x, x, x, x, beta1=0.9, beta2=0.999, eps=1e-6,
                       weight_decay=0.0, step=1)
    with pytest.raises(ValueError, match="BUFFER_MULTIPLE"):
        TK.lamb_stage2(x, x, x, lr=1e-3)


@pytest.mark.parametrize("call", [
    lambda x, s: TK.lamb_stage1_kernel(x, x, x, x, s(8), True),
    lambda x, s: TK.lamb_stage2_kernel(x, x, x, s(1)),
    lambda x, s: ops.l2norm_kernel(x),
], ids=["stage1", "stage2", "l2norm"])
def test_arena_kernel_wrappers_refuse_cpu_tensors(call):
    before = ops.launch_counts()
    with pytest.raises(ValueError):
        call(torch.ones(N), lambda k: torch.ones(k))
    assert ops.launch_counts() == before


def _sgd_buffers(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(N).astype(np.float32),
            (rng.randn(N) * 3.0).astype(np.float32),
            (rng.randn(N) * 0.1).astype(np.float32))


@pytest.mark.parametrize("first_run", [False, True])
@pytest.mark.parametrize("wd_after_momentum", [False, True])
@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_update_matches_jax(nesterov, wd_after_momentum, first_run):
    p, g, m = _sgd_buffers(5)
    kw = dict(lr=0.1, momentum=0.9, dampening=0.0, weight_decay=1e-4,
              nesterov=nesterov, first_run=first_run,
              wd_after_momentum=wd_after_momentum, grad_scale=0.5)
    want = JK.sgd_update(*(jnp.asarray(x) for x in (p, g, m)), **kw)
    got = TK.sgd_update(*(torch.tensor(x) for x in (p, g, m)), **kw)
    assert [t.dtype for t in got] == [torch.float32] * 2
    for a, b in zip(got, want):
        _close(a, b)


def test_sgd_update_device_flags_dampening_and_bf16_copy():
    """lr and the first-step flag as 0-d tensors (as FusedSGD passes them
    from the device), dampening, and a bf16 copy of the new params within
    one bf16 ulp."""
    p, g, m = _sgd_buffers(6)
    kw = dict(momentum=0.8, dampening=0.25, weight_decay=0.0)
    want = JK.sgd_update(*(jnp.asarray(x) for x in (p, g, m)), lr=0.05,
                         first_run=jnp.bool_(False),
                         param_copy_dtype=jnp.bfloat16, **kw)
    got = TK.sgd_update(*(torch.tensor(x) for x in (p, g, m)),
                        lr=torch.tensor(0.05), first_run=torch.tensor(False),
                        param_copy_dtype=torch.bfloat16, **kw)
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert got[2].dtype == torch.bfloat16
    want_c = np.asarray(jnp.asarray(want[2], jnp.float32))
    diff = np.abs(got[2].float().numpy() - want_c)
    assert np.all(diff <= np.abs(want_c) * 2.0 ** -7)


def test_sgd_refuses_unpadded_buffers():
    x = torch.ones(N + 1024)
    with pytest.raises(ValueError, match="BUFFER_MULTIPLE"):
        TK.sgd_update(x, x, x, lr=0.1, momentum=0.9)


def test_sgd_kernel_refuses_cpu_tensors():
    before = ops.launch_counts()
    with pytest.raises(ValueError):
        TK.sgd_kernel(torch.ones(N), torch.ones(N), torch.ones(N),
                      torch.ones(6), False, False)
    assert ops.launch_counts() == before
