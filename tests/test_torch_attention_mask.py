"""The port's copies of the JAX package's attention choices, against it.

The dropout keep mask (``_keep_mask_dense`` over ``_mix_keep``) is held
bit for bit against ``apex_tpu.ops.attention._keep_mask_dense`` for
negative and positive int32 seeds, rates 0.1 and 0.5 and S in {200, 512,
600} (one block, one 512 block, 128 blocks), with and without dropout block
offsets; the block choice, the head grouping that picks the JAX kernels'
layout, the bias modes, and every refusal (seed, rate, causal offset, block
offsets, the lse variant's dropout) are held against the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as JA
from apex_tpu_torch.ops import attention as TA


@pytest.mark.parametrize("s", [200, 512, 600])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed", [-1234567891, 987654321])
def test_keep_mask_bitwise(seed, rate, s):
    bq, bk = TA._dropout_blocks(s, s)
    cq, ck = JA._block_cap(JA.DEFAULT_BLOCK_Q, JA.DEFAULT_BLOCK_K, True, rate)
    assert (bq, bk) == (JA._choose_block(cq, s),
                        JA._choose_block(ck, s, lane=True))
    want = np.asarray(JA._keep_mask_dense(jnp.int32(seed), 2, 3, s, s, bq, bk,
                                          rate))
    got = TA._keep_mask_dense(torch.tensor([seed], dtype=torch.int32), 2, 3,
                              s, s, bq, bk, rate)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert abs(want.mean() - (1 - rate)) < 0.01


@pytest.mark.parametrize("dbo", [(1, 2), (-3, 7)])
def test_keep_mask_block_offsets_bitwise(dbo):
    """Offsets add to the block coordinates, as ``_dbo_shift`` does."""
    s, bq = 96, 32
    iota = lambda ax: np.broadcast_to(
        np.arange((4, s, s)[ax]).reshape([-1 if i == ax else 1
                                          for i in range(3)]), (4, s, s))
    gb, r, c = (iota(a).astype(np.int64) for a in range(3))
    u32 = lambda x: jnp.asarray(x.astype(np.uint32))   # wraps mod 2**32
    want = np.asarray(JA._mix_keep(
        jnp.int32(77), u32(gb), u32(r // bq + dbo[0]), u32(c // bq + dbo[1]),
        u32(r % bq), u32(c % bq), 0.3))
    got = TA._keep_mask_dense(torch.tensor([77], dtype=torch.int32), 2, 2,
                              s, s, bq, bq, 0.3,
                              dbo=torch.tensor(dbo, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("s", [1, 16, 40, 72, 128, 200, 300, 504, 512, 513,
                               520, 600, 700, 1024, 1100, 2048])
def test_block_choice_matches_jax(s):
    for pref in (1024, 512, 384):
        assert TA._choose_block(pref, s) == JA._choose_block(pref, s)
        assert TA._choose_block(pref, s, lane=True) == \
            JA._choose_block(pref, s, lane=True)
    assert TA._block_cap(1024, 1024, False, 0.0) == \
        JA._block_cap(1024, 1024, False, 0.0)
    assert TA._block_cap(1024, 1024, True, 0.0) == \
        JA._block_cap(1024, 1024, True, 0.0)


@pytest.mark.parametrize("h,d", [(1, 64), (2, 64), (3, 64), (15, 64),
                                 (16, 64), (2, 32), (4, 32), (3, 128),
                                 (2, 96)])
def test_native_geometry_matches_jax(h, d):
    assert TA._native_g0(h, d) == JA._native_g0(h, d)


@pytest.mark.parametrize("shape,mode", [((1, 1, 8, 12), "shared"),
                                        ((2, 1, 1, 12), "batch"),
                                        ((1, 3, 8, 12), "head"),
                                        ((2, 3, 1, 12), "full"),
                                        ((2, 3, 8, 1), "full")])
def test_bias_modes_match_jax(shape, mode):
    bias = np.zeros(shape, np.float32)
    assert JA._bias_group_nl(jnp.asarray(bias), 2, 3, 8, 12)[1] == mode
    assert TA._bias_mode(torch.tensor(bias), 2, 3, 8, 12) == mode


@pytest.mark.parametrize("shape", [(3, 1, 8, 12), (1, 2, 8, 12),
                                   (1, 1, 7, 12), (1, 1, 8, 5)])
def test_bias_refusals_match_jax(shape):
    bias = np.zeros(shape, np.float32)
    with pytest.raises(ValueError) as jerr:
        JA._bias_group_nl(jnp.asarray(bias), 2, 3, 8, 12)
    with pytest.raises(ValueError) as terr:
        TA._bias_mode(torch.tensor(bias), 2, 3, 8, 12)
    assert str(terr.value).split(" must")[1] == \
        str(jerr.value).split(" must")[1]


def _call_both(fn_name, shape_q=(1, 16, 2, 64), shape_k=None, bias=None,
               **kw):
    """Call the JAX and the port function with the same arguments; return
    the two exceptions (type and message)."""
    shape_k = shape_k or shape_q
    q, k = np.zeros(shape_q, np.float32), np.zeros(shape_k, np.float32)
    out = []
    for mod, conv in ((JA, jnp.asarray), (TA, torch.tensor)):
        args = (conv(q), conv(k), conv(k))
        b = None if bias is None else conv(bias)
        try:
            getattr(mod, fn_name)(*args, b, **kw)
        except (ValueError, NotImplementedError) as e:
            out.append((type(e), str(e)))
        else:
            out.append(None)
    return out


@pytest.mark.parametrize("case", [
    dict(dropout_rate=0.1),
    dict(dropout_rate=1.0, dropout_seed=3),
    dict(dropout_rate=-0.2, dropout_seed=3),
    dict(causal_offset=3),
    dict(causal=True, causal_offset=3, bias=np.zeros((1, 1, 16, 16),
                                                     np.float32)),
], ids=["no_seed", "rate_one", "rate_negative", "offset_without_causal",
        "offset_with_bias"])
def test_refusals_match_jax(case):
    jerr, terr = _call_both("flash_attention", **case)
    assert jerr is not None and terr == jerr


@pytest.mark.parametrize("case", [
    dict(dropout_block_offset=(0, 1), shape_q=(1, 512, 3, 64)),
    dict(dropout_block_offset=(0, 1), shape_q=(1, 512, 2, 64),
         bias=np.zeros((1, 1, 512, 512), np.float32)),
    dict(dropout_block_offset=(0, 1), shape_q=(1, 200, 2, 64),
         dropout_rate=0.1, dropout_seed=1),
    dict(dropout_rate=0.1, dropout_seed=1, shape_q=(1, 16, 3, 64)),
], ids=["dbo_transposed", "dbo_with_bias", "dbo_short_shard",
        "lse_dropout_transposed"])
def test_lse_refusals_match_jax(case):
    jerr, terr = _call_both("flash_attention_lse", **case)
    assert jerr is not None and terr == jerr
