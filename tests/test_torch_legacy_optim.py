"""The port's legacy optimizers against the JAX package's.

``optim.legacy.FusedAdam``, ``FusedSGD`` and ``FusedLAMB`` take still-scaled
gradients, unscale them inside the arena kernels (their plain versions on
the CPU) and may write a reduced-precision copy of the new params in the
same pass. The cases of ``tests/test_amp_api.py``'s legacy tests on the
port: each against the modern optimizer on the unscaled gradient (1e-6
relative), against the JAX legacy optimizer on the same inputs (1e-6), the
copy equal to the new params cast to its dtype, and LAMB's clip
(``max_grad_norm=0`` off, NVLAMB, 0.5) against the modern surface.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optim import FusedAdam as JAdam
from apex_tpu.optim import FusedLAMB as JLAMB
from apex_tpu.optim import FusedSGD as JSGD
from apex_tpu.optim import legacy as jlegacy
from apex_tpu_torch.optim import FusedAdam as TAdam
from apex_tpu_torch.optim import FusedLAMB as TLAMB
from apex_tpu_torch.optim import FusedSGD as TSGD
from apex_tpu_torch.optim import legacy as tlegacy

_JDT = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _close(got, want, rtol=1e-6):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=rtol * float(np.abs(np.asarray(
                                   want, np.float32)).max()))


def _tree(seed, shapes, scale=1.0):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("copy", [torch.bfloat16, torch.float16])
def test_legacy_adam_scale_and_copy(copy):
    params = {"w": np.arange(16.0, dtype=np.float32) / 16.0}
    g = {"w": np.ones(16, np.float32) * 128.0}
    lo = tlegacy.FusedAdam(lr=1e-2)
    p1, st, c = lo.step(_t(g), lo.init(_t(params)), _t(params), scale=128.0,
                        output_dtype=copy)
    assert c["w"].dtype == copy and int(st.count) == 1
    assert torch.equal(c["w"], p1["w"].to(copy))
    modern = TAdam(lr=1e-2, strategy="arena")
    p2, _ = modern.step({"w": torch.ones(16)}, modern.init(_t(params)),
                        _t(params))
    _close(p1["w"], p2["w"].numpy())
    jl = jlegacy.FusedAdam(lr=1e-2)
    jp, _, jc = jl.step(_j(g), jl.init(_j(params)), _j(params), scale=128.0,
                        output_dtype=_JDT[copy])
    _close(p1["w"], jp["w"])
    assert np.array_equal(c["w"].float().numpy(),
                          np.asarray(jc["w"], np.float32))


def test_legacy_sgd_scale_and_momentum():
    params = {"w": np.arange(8.0, dtype=np.float32)}
    g = {"w": np.full(8, 64.0, np.float32)}
    lo = tlegacy.FusedSGD(lr=0.5, momentum=0.9)
    ls = lo.init(_t(params))
    p1, ls = lo.step(_t(g), ls, _t(params), scale=64.0)
    modern = TSGD(lr=0.5, momentum=0.9, strategy="arena")
    p2, _ = modern.step({"w": torch.ones(8)}, modern.init(_t(params)),
                        _t(params))
    _close(p1["w"], p2["w"].numpy())
    # a second step runs the momentum buffer set by the first
    p3, ls2, c = lo.step(_t(g), ls, p1, scale=64.0,
                         output_dtype=torch.float16)
    jl = jlegacy.FusedSGD(lr=0.5, momentum=0.9)
    jp1, js = jl.step(_j(g), jl.init(_j(params)), _j(params), scale=64.0)
    jp3, _, jc = jl.step(_j(g), js, jp1, scale=64.0,
                         output_dtype=jnp.float16)
    _close(p3["w"], jp3["w"])
    assert torch.equal(c["w"], p3["w"].half())
    assert int(ls2.count) == 2


def test_legacy_lamb_parity_scale_and_copy():
    shapes = {"w": (32, 8), "b": (8,)}
    params, grads = _tree(0, shapes), _tree(1, shapes)
    lo = tlegacy.FusedLAMB(lr=1e-2, weight_decay=0.01)
    p1, _ = lo.step(_t(grads), lo.init(_t(params)), _t(params), scale=1.0)
    modern = TLAMB(lr=1e-2, weight_decay=0.01, strategy="arena")
    p2, _ = modern.step(_t(grads), modern.init(_t(params)), _t(params))
    for k in params:
        _close(p1[k], p2[k].numpy())
    sg = {k: v * 256.0 for k, v in grads.items()}
    lo2 = tlegacy.FusedLAMB(lr=1e-2, weight_decay=0.01)
    p3, _, copy = lo2.step(_t(sg), lo2.init(_t(params)), _t(params),
                           scale=256.0, output_dtype=torch.bfloat16)
    jl = jlegacy.FusedLAMB(lr=1e-2, weight_decay=0.01)
    jp, _, jc = jl.step(_j(sg), jl.init(_j(params)), _j(params),
                        scale=256.0, output_dtype=jnp.bfloat16)
    for k in params:
        _close(p3[k], p1[k].numpy(), rtol=1e-5)
        _close(p3[k], jp[k])
        assert copy[k].dtype == torch.bfloat16
        assert torch.equal(copy[k], p3[k].to(torch.bfloat16))


@pytest.mark.parametrize("kw", [{"max_grad_norm": 0.0, "weight_decay": 0.0},
                                {"use_nvlamb": True, "weight_decay": 0.0},
                                {"max_grad_norm": 0.5}],
                         ids=["no-clip", "nvlamb", "clip-0.5"])
def test_legacy_lamb_clip_and_nvlamb_paths(kw):
    shapes = {"w": (16, 8)}
    params, grads = _tree(2, shapes), _tree(3, shapes, scale=3.0)
    lo = tlegacy.FusedLAMB(lr=1e-2, **kw)
    p1, _ = lo.step(_t(grads), lo.init(_t(params)), _t(params), scale=1.0)
    modern = TLAMB(lr=1e-2, strategy="arena", **kw)
    p2, _ = modern.step(_t(grads), modern.init(_t(params)), _t(params))
    _close(p1["w"], p2["w"].numpy())
    jl = jlegacy.FusedLAMB(lr=1e-2, **kw)
    jp, _ = jl.step(_j(grads), jl.init(_j(params)), _j(params), scale=1.0)
    _close(p1["w"], jp["w"])


def test_legacy_lamb_clip_sees_the_unscaled_norm():
    """A gradient scaled by 1024 whose unscaled norm is under
    ``max_grad_norm`` is not clipped: the update equals the unclipped
    one's; its scaled norm alone would have clipped it."""
    shapes = {"w": (8, 8)}
    params = _tree(4, shapes)
    g = {k: v / (4 * np.linalg.norm(v)) for k, v in _tree(5, shapes).items()}
    scaled = {k: v * 1024.0 for k, v in g.items()}
    lo = tlegacy.FusedLAMB(lr=1e-2, max_grad_norm=1.0)
    p1, _ = lo.step(_t(scaled), lo.init(_t(params)), _t(params),
                    scale=1024.0)
    off = tlegacy.FusedLAMB(lr=1e-2, max_grad_norm=0.0)
    p2, _ = off.step(_t(g), off.init(_t(params)), _t(params))
    _close(p1["w"], p2["w"].numpy(), rtol=1e-5)
