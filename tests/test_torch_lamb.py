"""Parity of apex_tpu_torch.optim.FusedLAMB with apex_tpu.optim.FusedLAMB.

Three steps of the tree strategy on random params and grads, on both
sides, agree at rtol 1e-6, with an atol of 1e-6 times the tensor's largest
magnitude: the global grad norm sums in another order, and its last-bit
difference in the clip factor grows relative to an element where
β1·m + (1−β1)·g cancels. The tree strategy
is set on the JAX side too: under "auto" it takes its Pallas arena kernels
below 8M params.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optim import FusedLAMB as JLAMB
from apex_tpu_torch.optim import FusedLAMB as TLAMB

_SHAPES = {"w1": (16, 8), "b1": (8,), "w2": (8, 5), "scale": (5,),
           "zero": (4,)}


@pytest.mark.parametrize("kw", [
    dict(),
    dict(weight_decay=0.0),
    dict(weight_decay=0.0, use_nvlamb=True),
    dict(adam_w_mode=False, max_grad_norm=0.0),
    dict(bias_correction=False, lr=5e-3, betas=(0.8, 0.99)),
])
def test_three_tree_steps_match_jax(kw):
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in _SHAPES.items()}
    params["zero"][:] = 0.0          # exercises the zero-norm trust ratio
    jopt = JLAMB(strategy="tree", **kw)
    topt = TLAMB(strategy="tree", **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        grads = {k: (rng.randn(*s) * 3.0).astype(np.float32)
                 for k, s in _SHAPES.items()}
        jp, js = jopt.step({k: jnp.asarray(v) for k, v in grads.items()},
                           js, jp)
        tp, ts = topt.step({k: torch.tensor(v) for k, v in grads.items()},
                           ts, tp)
    assert int(ts.count) == int(js.count) == 3
    pairs = [(tp[k], jp[k]) for k in _SHAPES] + [
        (ts.slots[s][k], js.slots[s][k]) for s in ("m", "v") for k in _SHAPES]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def test_auto_runs_tree_and_arena_is_not_ported():
    topt = TLAMB()
    assert topt.strategy == "auto"
    p = {"w": torch.ones(3)}
    new_p, st = topt.step({"w": torch.full((3,), 0.5)}, topt.init(p), p)
    assert int(st.count) == 1 and torch.all(new_p["w"] < 1.0)
    assert torch.equal(p["w"], torch.ones(3))      # inputs untouched
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TLAMB(strategy="arena")
    with pytest.raises(ValueError):
        TLAMB(strategy="flat")
