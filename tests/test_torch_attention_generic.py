"""The flash kernels' two domains, and the generic kernels' function.

On a card, bf16/fp16 q, k, v at D in {32, 64, 128} launch the wgmma
kernels and every other f32/bf16/fp16 call with 1 <= D <= 256 the generic
ones (``csrc/flash_attn_generic.cu``); ``attention.kernel_route`` is that
choice, a pure function of (dtype, D). On the CPU both run as the plain
versions, which are held here against the JAX kernels in interpret mode
at the operands only the generic kernels take: f32 at D = 48, 80, 96,
256 and bf16 at D = 80, 96, each with a bias, causal, and dropout (the
keep mask is the JAX package's hash, so the two draw the same mask), for
o and for dq, dk, dv (and the bias's gradient). Tolerances: f32 within
2e-5 of the JAX result's largest magnitude (o) and 1e-4 (grads: sums
of S products in another order); bf16 within 2e-2 of it (a few bf16
ulps: P and dS round to bf16 per tile in the JAX kernels, on the whole
row in the plain version).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as JA
from apex_tpu_torch.ops import attention as TA


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 32, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "wgmma"), (torch.float16, 32, "wgmma"),
    (torch.float16, 64, "wgmma"), (torch.float16, 128, "wgmma"),
    (torch.float32, 32, "generic"), (torch.float32, 64, "generic"),
    (torch.float32, 128, "generic"), (torch.float32, 1, "generic"),
    (torch.float32, 256, "generic"), (torch.bfloat16, 1, "generic"),
    (torch.bfloat16, 48, "generic"), (torch.bfloat16, 80, "generic"),
    (torch.bfloat16, 96, "generic"), (torch.bfloat16, 160, "generic"),
    (torch.bfloat16, 256, "generic"), (torch.float16, 80, "generic"),
    (torch.float16, 255, "generic"),
])
def test_kernel_route_by_dtype_and_head_dim(dtype, d, route):
    assert TA.kernel_route(dtype, d) == route


@pytest.mark.parametrize("dtype,d", [
    (torch.float32, 0), (torch.float32, 257), (torch.bfloat16, 512),
    (torch.float64, 64), (torch.int32, 64), (torch.float8_e4m3fn, 64),
])
def test_kernel_route_refuses_outside_both_domains(dtype, d):
    with pytest.raises(ValueError, match="head dims 1..256"):
        TA.kernel_route(dtype, d)


def test_every_generic_operand_is_refused_only_for_the_cpu():
    """A CPU call in the generic domain reaches the device check; no
    kernel launches."""
    from apex_tpu_torch import ops
    before = ops.launch_counts()
    for dt, d in ((torch.float32, 64), (torch.float32, 80),
                  (torch.bfloat16, 96), (torch.float16, 256)):
        q = torch.ones(2, 16, 3, d, dtype=dt)
        lse = torch.zeros(6, 16)
        for call in (lambda: TA.flash_generic_fwd_kernel(q, q, q, 0.1),
                     lambda: TA.flash_generic_bwd_kernel(q, q, q, q, lse,
                                                         lse, 0.1),
                     lambda: TA.flash_fwd_kernel(q, q, q, 0.1)):
            with pytest.raises(ValueError, match="CUDA device"):
                call()
    q = torch.ones(2, 16, 3, 80, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        TA.flash_wgmma_fwd_kernel(q, q, q, 0.1)
    assert ops.launch_counts() == before


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


# (dtype, D, H): H = 2 at D = 48, 80 and 96 sends the JAX package through
# its (B·H, S, D) kernels (the heads fill no 128 lanes), H = 1 at D = 256
# through the native-layout ones
CASES = [("float32", 48, 2), ("float32", 80, 2), ("float32", 96, 2),
         ("float32", 256, 1), ("bfloat16", 80, 2), ("bfloat16", 96, 2)]


@pytest.mark.parametrize("opt", ["bias", "causal", "dropout"])
@pytest.mark.parametrize("dtype,d,h", CASES,
                         ids=[f"{a}-{b}" for a, b, _ in CASES])
def test_plain_path_matches_jax_kernels(dtype, d, h, opt):
    b, sq, sk = 2, 72, 96
    rng = np.random.RandomState(d + len(opt))
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k, v = (rng.randn(b, sk, h, d).astype(np.float32) for _ in range(2))
    do = rng.randn(b, sq, h, d).astype(np.float32)
    bias = (0.5 * rng.randn(b, 1, sq, sk)).astype(np.float32) \
        if opt == "bias" else None
    kw = dict(causal=opt == "causal",
              dropout_rate=0.2 if opt == "dropout" else 0.0,
              dropout_seed=1234 if opt == "dropout" else None)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    jargs = [jnp.asarray(t, jdt) for t in (q, k, v)]
    jbias = None if bias is None else jnp.asarray(bias)
    jdo = jnp.asarray(do, jdt)

    def jloss(q_, k_, v_, bias_):
        o = JA.flash_attention(q_, k_, v_, bias=bias_, **kw)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32))

    jo = JA.flash_attention(*jargs, bias=jbias, **kw)
    argnums = (0, 1, 2, 3) if bias is not None else (0, 1, 2)
    jgrads = jax.grad(jloss, argnums=argnums)(*jargs, jbias)

    leaves = [torch.tensor(t).to(tdt).requires_grad_(True)
              for t in (q, k, v)]
    if bias is not None:
        leaves.append(torch.tensor(bias).requires_grad_(True))
    to = TA.flash_attention(*leaves[:3], bias=leaves[3] if bias is not None
                            else None, **kw)
    (to.float() * torch.tensor(do).to(tdt).float()).sum().backward()

    f32 = dtype == "float32"
    for i, (got, want) in enumerate(zip(
            [to] + [t.grad for t in leaves], [jo, *jgrads])):
        want = _np(want)
        tol = (2e-5 if i == 0 else 1e-4) if f32 else 2e-2
        err = np.abs(got.detach().float().numpy() - want).max()
        assert err <= tol * max(np.abs(want).max(), 1e-6), (i, err)
