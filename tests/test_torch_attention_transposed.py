"""flash_attention against the JAX package where it takes its (B·H, S, D)
kernels (rows 9-11, ``_native_g0(h, d) is None``): H = 3 with D = 64, and
D = 32 at H = 2; the port's kernels index (b, h) directly and take the same
code path as at BERT's geometry.

Every bias mode (and the bias's gradient), causal at the default frontier
and at a causal offset (the JAX package builds an additive mask from it
here), Sq != Sk, dropout, and bias with dropout; cases in
``_torch_attention_cases.py``. Then dropout across several JAX dropout
blocks (S = 520: blocks of 128).
"""

import pytest

from _torch_attention_cases import OPTIONS, check_case
from apex_tpu.ops import attention as JA
from apex_tpu_torch.ops import attention as TA


@pytest.mark.parametrize("option", list(OPTIONS))
def test_transposed_h3_matches_jax(option):
    assert JA._native_g0(3, 64) is None
    check_case(2, 3, 64, option)


@pytest.mark.parametrize("option", ["full_bias", "causal_offset", "dropout",
                                    "bias_dropout"])
def test_transposed_d32_matches_jax(option):
    assert JA._native_g0(2, 32) is None
    check_case(1, 2, 32, option)


def test_multi_block_dropout_matches_jax():
    assert TA._dropout_blocks(520, 520) == (128, 128)
    check_case(1, 2, 32, "dropout", sq=520, sk=520)
