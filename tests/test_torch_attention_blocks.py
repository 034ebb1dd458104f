"""``block_q``/``block_k`` in the port's flash attention, against the JAX
package, and ``mask_softmax_dropout``.

- The blocks come by position after ``causal``, as in the JAX package's
  ``flash_attention`` and ``flash_attention_lse``: a positional caller's
  blocks bind to the blocks (not to ``dropout_rate``/``dropout_seed``).
- Under dropout the caller's blocks set the keep mask's block coordinates:
  for S in {64, 200, 512, 600} with the default blocks and with blocks of
  128, the realized blocks, the dense mask (bit for bit) and the
  attention's output and gradients (f32, within 2e-5 / 5e-4 as
  ``tests/test_attention.py``'s oracle test) equal the JAX package's.
- ``dropout_block_offset`` is refused where the caller's blocks realize no
  512-tile, with the JAX package's message.
- ``mask_softmax_dropout`` at ``deterministic=True`` equals the JAX
  function (f32 within 1e-6, bf16 bitwise); with dropout its keep rate is
  within 5σ of the binomial and it is the port's own formula on the mask
  its generator draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as JA
from apex_tpu_torch.ops import attention as TA


def _qkv(s, seed=7, b=1, h=2, d=64):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(3)]


def test_blocks_bind_by_position_as_in_jax():
    q, k, v = _qkv(64)
    want = JA.flash_attention(*map(jnp.asarray, (q, k, v)), None, None,
                              False, 128, 128)
    got = TA.flash_attention(*map(torch.tensor, (q, k, v)), None, None,
                             False, 128, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    seed = 5
    jo, jl = JA.flash_attention_lse(*map(jnp.asarray, (q, k, v)), None,
                                    None, False, 128, 128, dropout_rate=0.2,
                                    dropout_seed=jnp.int32(seed))
    to, tl = TA.flash_attention_lse(*map(torch.tensor, (q, k, v)), None,
                                    None, False, 128, 128, dropout_rate=0.2,
                                    dropout_seed=seed)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=0)


def test_lse_takes_the_rest_by_keyword_only():
    q, k, v = map(torch.tensor, _qkv(64))
    with pytest.raises(TypeError):
        TA.flash_attention_lse(q, k, v, None, None, False, 128, 128, 0.1)


def _jax_blocks(s, bq, rate):
    pref = JA.DEFAULT_BLOCK_Q if bq is None else bq
    cq, ck = JA._block_cap(pref, pref, False, rate)
    return JA._choose_block(cq, s), JA._choose_block(ck, s, lane=True)


@pytest.mark.parametrize("bq", [None, 128])
@pytest.mark.parametrize("s", [64, 200, 512, 600])
def test_dropout_mask_follows_the_blocks_as_in_jax(s, bq):
    rate, seed = 0.3, 17
    kw = {} if bq is None else {"block_q": bq, "block_k": bq}
    blocks = TA._dropout_blocks(s, s, *(() if bq is None else (bq, bq)))
    assert blocks == _jax_blocks(s, bq, rate)
    want = np.asarray(JA._keep_mask_dense(jnp.int32(seed), 1, 2, s, s,
                                          *blocks, rate))
    got = TA._keep_mask_dense(torch.tensor([seed], dtype=torch.int32), 1, 2,
                              s, s, *blocks, rate)
    np.testing.assert_array_equal(got.numpy(), want)

    q, k, v = _qkv(s)
    do = np.random.RandomState(8).randn(*q.shape).astype(np.float32)

    def jfn(q, k, v):
        return JA.flash_attention(q, k, v, dropout_rate=rate,
                                  dropout_seed=seed, **kw)

    jo = jax.jit(jfn)(*map(jnp.asarray, (q, k, v)))
    jgrads = jax.grad(lambda *a: jnp.sum(jfn(*a) * do), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    targs = [torch.tensor(t).requires_grad_(True) for t in (q, k, v)]
    to = TA.flash_attention(*targs, dropout_rate=rate, dropout_seed=seed,
                            **kw)
    (to * torch.tensor(do)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               atol=2e-5, rtol=1e-5)
    for t, g in zip(targs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=5e-4,
                                   rtol=1e-3)


def test_blocks_change_the_mask():
    """At S = 512 the default blocks draw one 512-block and blocks of 128
    draw sixteen: a different mask for the same seed."""
    a = TA._keep_mask_dense(3, 1, 1, 512, 512, *TA._dropout_blocks(512, 512),
                            0.5)
    b = TA._keep_mask_dense(3, 1, 1, 512, 512,
                            *TA._dropout_blocks(512, 512, 128, 128), 0.5)
    assert TA._dropout_blocks(512, 512, 128, 128) == (128, 128)
    assert not torch.equal(a, b)


@pytest.mark.parametrize("s,bq,refused", [(512, None, False),
                                          (512, 128, True),
                                          (1024, 256, True),
                                          (1024, 512, False)])
def test_dropout_block_offset_needs_512_tiles_of_the_callers_blocks(
        s, bq, refused):
    q = np.zeros((1, s, 2, 64), np.float32)
    kw = dict(dropout_rate=0.1, dropout_seed=1, dropout_block_offset=(0, 1))
    if bq is not None:
        kw.update(block_q=bq, block_k=bq)
    errs = []
    for mod, conv in ((JA, jnp.asarray), (TA, torch.tensor)):
        try:
            mod.flash_attention_lse(conv(q), conv(q), conv(q), **kw)
        except ValueError as e:
            errs.append(str(e))
        else:
            errs.append(None)
    assert errs[0] == errs[1]
    assert (errs[0] is not None) == refused


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_mask_softmax_dropout_matches_jax(dtype, with_mask):
    rng = np.random.RandomState(2)
    s = (rng.randn(2, 3, 8, 16) * 3).astype(np.float32)
    mask = rng.rand(2, 1, 8, 16) > 0.3 if with_mask else None
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = JA.mask_softmax_dropout(
        jnp.asarray(s).astype(jdt),
        None if mask is None else jnp.asarray(mask), dropout_rate=0.1,
        deterministic=True)
    got = TA.mask_softmax_dropout(
        torch.tensor(s).to(tdt),
        None if mask is None else torch.tensor(mask), dropout_rate=0.1,
        deterministic=True)
    assert got.dtype == tdt
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_mask_softmax_dropout_in_distribution_and_by_formula():
    rate = 0.25
    s = torch.tensor(np.random.RandomState(3).randn(4, 4, 64, 64)
                     .astype(np.float32))
    g = torch.Generator().manual_seed(11)
    state = g.get_state()
    got = TA.mask_softmax_dropout(s, None, rate, g, deterministic=False)
    p = torch.softmax(s, dim=-1)
    keep = torch.rand(p.shape, generator=torch.Generator().manual_seed(11)
                      .set_state(state)) < 1 - rate
    np.testing.assert_array_equal(
        got.numpy(), torch.where(keep, p / (1 - rate), 0.0).numpy())
    n = keep.numel()
    kept = int(keep.sum())
    sigma = np.sqrt(n * rate * (1 - rate))
    assert abs(kept - n * (1 - rate)) < 5 * sigma
    assert torch.equal(got != 0, keep)
    with pytest.raises(ValueError, match="Generator"):
        TA.mask_softmax_dropout(s, None, rate, None, deterministic=False)
