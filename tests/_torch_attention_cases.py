"""Shared cases of the flash-attention parity tests (not a test module).

One case: numpy q (B, Sq, H, D), k, v (B, Sk, H, D), an output cotangent
and, per option, a bias, causal masking, a causal offset or dropout. The
JAX op runs its Pallas kernels in interpret mode on the CPU; the port runs
its plain versions on CPU tensors. o, dq, dk, dv and, for a bias, dbias
agree at atol 2e-5 in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from apex_tpu.ops import attention as JA
from apex_tpu_torch.ops import attention as TA

SQ, SK = 40, 72
ATOL = 2e-5


def _bias(kind, b, h, rng):
    if kind == "shared":
        return rng.randn(1, 1, SQ, SK).astype(np.float32)
    if kind == "batch":   # a padding mask: the last keys of batch row 0 off
        bias = np.zeros((b, 1, 1, SK), np.float32)
        bias[0, ..., SK - 20:] = -1e9
        return bias
    if kind == "head":
        return rng.randn(1, h, SQ, SK).astype(np.float32)
    return rng.randn(b, h, SQ, SK).astype(np.float32)


#: option name -> keyword arguments of flash_attention (bias by kind)
OPTIONS = {
    "cross": {},
    "shared_bias": {"bias": "shared"},
    "batch_bias": {"bias": "batch"},
    "head_bias": {"bias": "head"},
    "full_bias": {"bias": "full"},
    "causal": {"causal": True},
    "causal_offset": {"causal": True, "causal_offset": 5},
    "dropout": {"dropout_rate": 0.1, "dropout_seed": -12345},
    "bias_dropout": {"bias": "batch", "dropout_rate": 0.1,
                     "dropout_seed": 777},
    # a learned bias's gradient under dropout
    "head_bias_dropout": {"bias": "head", "dropout_rate": 0.5,
                          "dropout_seed": 2 ** 31 - 1},
}


def check_case(b, h, d, option, sq=SQ, sk=SK, seed=0):
    kw = dict(OPTIONS[option])
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k, v = (rng.randn(b, sk, h, d).astype(np.float32) for _ in range(2))
    do = rng.randn(b, sq, h, d).astype(np.float32)
    bias = None
    if "bias" in kw:
        bias = _bias(kw.pop("bias"), b, h, rng)
    jdo = jnp.asarray(do)

    def jloss(q_, k_, v_, b_):
        return jnp.sum(JA.flash_attention(q_, k_, v_, b_, **kw) * jdo)

    jargs = [jnp.asarray(t) for t in (q, k, v)]
    jargs.append(None if bias is None else jnp.asarray(bias))
    jo = JA.flash_attention(*jargs, **kw)
    argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)
    jgrads = jax.grad(jloss, argnums=argnums)(*jargs)

    targs = [torch.tensor(t).requires_grad_(True) for t in (q, k, v)]
    if bias is not None:
        targs.append(torch.tensor(bias).requires_grad_(True))
    to = TA.flash_attention(*targs[:3], None if bias is None else targs[3],
                            **kw)
    to.backward(torch.tensor(do))
    names = ("o", "dq", "dk", "dv", "dbias")
    for name, got, want in zip(names, [to] + [t.grad for t in targs],
                               [jo, *jgrads]):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0, err_msg=name)
