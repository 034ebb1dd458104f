"""Parity of the port's multi_tensor_scale, multi_tensor_axpby and
multi_tensor_maxnorm with the JAX package's (its Pallas kernels in
interpret mode on the CPU; the port's plain versions).

Buffers of 2 × 65536 elements (two of the JAX launcher's blocks) from
``np.random.RandomState``, in f32, bf16 and f16, with every output dtype.
Decisions match bitwise: the all-finite flags (an inf, a NaN, inf·0, and
a value that overflows only in the f16 cast, which both packages flag as
finite because they test the f32 result before the cast) and maxnorm's
NaN with a NaN in the first or the last block. Values: scale's and
maxnorm's outputs are equal; axpby's within one ulp of the output dtype
plus one f32 ulp of |a·x| + |b·y| (XLA on the CPU contracts a·x + b·y into
a fused multiply-add, the port rounds both products, so where the sum
cancels they part by a product's last bit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import multi_tensor as JM
from apex_tpu_torch.ops import multi_tensor as TM

N = 2 * 65536
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16),
       "float16": (jnp.float16, torch.float16)}
_ULP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def _bufs(dtype, seed=0, n=2):
    """``n`` equal buffers on both sides: (jax arrays, torch tensors)."""
    jd, td = _DT[dtype]
    rng = np.random.RandomState(seed)
    xs = [(rng.randn(N) * 3).astype(np.float32) for _ in range(n)]
    return ([jnp.asarray(x, jd) for x in xs],
            [torch.tensor(x).to(td) for x in xs])


def _as_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def _within_ulp(got, want, dtype, products=0.0):
    """Within one ulp of ``dtype`` of the value, plus one f32 ulp of
    ``products`` (|a·x| + |b·y|)."""
    got, want = _as_np(got), _as_np(want)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    tol = _ULP[dtype] * np.maximum(np.abs(want), 2.0 ** -14) \
        + _ULP["float32"] * np.asarray(products, np.float32)
    tol = np.broadcast_to(tol, want.shape)[fin]
    assert np.all(np.abs(got[fin] - want[fin]) <= tol)
    assert np.array_equal(got[~fin], want[~fin], equal_nan=True)


@pytest.mark.parametrize("out", [None, "float32", "bfloat16", "float16"])
@pytest.mark.parametrize("dtype", list(_DT))
def test_scale_matches_jax(dtype, out):
    (jx,), (tx,) = _bufs(dtype, n=1)
    jo, jf = JM.multi_tensor_scale(jx, 0.37,
                                   out_dtype=_DT[out][0] if out else None)
    to, tf = TM.multi_tensor_scale(tx, 0.37,
                                   out_dtype=_DT[out][1] if out else None)
    assert str(to.dtype).removeprefix("torch.") == jnp.dtype(jo.dtype).name
    assert tf.dtype == torch.bool and tf.dim() == 0
    assert bool(tf) == bool(jf) is True
    np.testing.assert_array_equal(_as_np(to), _as_np(jo))


@pytest.mark.parametrize("out", [None, "float32", "bfloat16", "float16"])
@pytest.mark.parametrize("dtype", list(_DT))
def test_axpby_matches_jax(dtype, out):
    (jx, jy), (tx, ty) = _bufs(dtype, seed=1)
    jo, jf = JM.multi_tensor_axpby(1.7, jx, -0.6, jy,
                                   out_dtype=_DT[out][0] if out else None)
    to, tf = TM.multi_tensor_axpby(1.7, tx, -0.6, ty,
                                   out_dtype=_DT[out][1] if out else None)
    assert str(to.dtype).removeprefix("torch.") == jnp.dtype(jo.dtype).name
    assert bool(tf) == bool(jf) is True
    _within_ulp(to, jo, out or dtype,
                1.7 * np.abs(_as_np(tx)) + 0.6 * np.abs(_as_np(ty)))


def test_scalars_may_be_device_tensors():
    (jx, jy), (tx, ty) = _bufs("float32", seed=2)
    to, tf = TM.multi_tensor_axpby(torch.tensor(0.5), tx, torch.tensor(2.0),
                                   ty)
    jo, _ = JM.multi_tensor_axpby(0.5, jx, 2.0, jy)
    _within_ulp(to, jo, "float32",
                0.5 * np.abs(_as_np(tx)) + 2.0 * np.abs(_as_np(ty)))
    so, _ = TM.multi_tensor_scale(tx, torch.tensor(0.25))
    np.testing.assert_array_equal(so.numpy(),
                                  _as_np(JM.multi_tensor_scale(jx, 0.25)[0]))


# (case, position, x value, y value, scale or (a, b), output dtype)
_FLAG_CASES = [
    ("inf", 17, np.inf, 1.0, 1.0, None),
    ("-inf last block", N - 3, -np.inf, 1.0, 1.0, None),
    ("nan", 65536, np.nan, 1.0, 1.0, None),
    ("inf times 0", 5, np.inf, 1.0, 0.0, None),
    ("overflow in the f32 product", 9, 1e30, 1.0, 1e10, None),
    ("overflow only in the f16 cast", 70000, 1e5, 1.0, 1.0, "float16"),
]


@pytest.mark.parametrize("case", _FLAG_CASES, ids=[c[0] for c in _FLAG_CASES])
def test_scale_flags_match_jax_bitwise(case):
    _, pos, xv, _, s, out = case
    x = (np.random.RandomState(3).randn(N)).astype(np.float32)
    x[pos] = xv
    od = _DT[out] if out else (None, None)
    jo, jf = JM.multi_tensor_scale(jnp.asarray(x), s, out_dtype=od[0])
    to, tf = TM.multi_tensor_scale(torch.tensor(x), s, out_dtype=od[1])
    assert bool(tf) == bool(jf)
    np.testing.assert_array_equal(_as_np(to), _as_np(jo))
    if out == "float16":            # JAX's kernel: f32 result tested
        assert bool(tf) and np.isinf(_as_np(to)[pos])


@pytest.mark.parametrize("case", _FLAG_CASES, ids=[c[0] for c in _FLAG_CASES])
def test_axpby_flags_match_jax_bitwise(case):
    _, pos, xv, yv, s, out = case
    rng = np.random.RandomState(4)
    x, y = (rng.randn(2, N)).astype(np.float32)
    x[pos], y[pos] = xv, yv
    od = _DT[out] if out else (None, None)
    jo, jf = JM.multi_tensor_axpby(s, jnp.asarray(x), 1.0, jnp.asarray(y),
                                   out_dtype=od[0])
    to, tf = TM.multi_tensor_axpby(s, torch.tensor(x), 1.0, torch.tensor(y),
                                   out_dtype=od[1])
    assert bool(tf) == bool(jf)
    with np.errstate(invalid="ignore", over="ignore"):
        _within_ulp(to, jo, out or "float32",
                    np.abs(np.float32(s) * x) + np.abs(y))
    # the bad value in y instead of x gives the same decision
    jf2 = JM.multi_tensor_axpby(1.0, jnp.asarray(y), s, jnp.asarray(x),
                                out_dtype=od[0])[1]
    tf2 = TM.multi_tensor_axpby(1.0, torch.tensor(y), s, torch.tensor(x),
                                out_dtype=od[1])[1]
    assert bool(tf2) == bool(jf2)


@pytest.mark.parametrize("dtype", list(_DT))
def test_maxnorm_matches_jax(dtype):
    (jx,), (tx,) = _bufs(dtype, seed=5, n=1)
    got, want = TM.multi_tensor_maxnorm(tx), JM.multi_tensor_maxnorm(jx)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert np.float32(got.item()).tobytes() == \
        np.asarray(want, np.float32).tobytes()


@pytest.mark.parametrize("pos", [0, 65535, 65536, N - 1],
                         ids=["first", "end of first block", "second block",
                              "last"])
@pytest.mark.parametrize("value", [np.nan, -np.inf], ids=["nan", "-inf"])
def test_maxnorm_nan_and_inf_match_jax(pos, value):
    x = (np.random.RandomState(6).randn(N)).astype(np.float32)
    x[pos] = value
    got = TM.multi_tensor_maxnorm(torch.tensor(x)).item()
    want = float(JM.multi_tensor_maxnorm(jnp.asarray(x)))
    assert np.isnan(got) == np.isnan(want)
    if np.isnan(value):
        assert np.isnan(got)
    else:
        assert got == want == np.inf


def test_maxnorm_of_zeros_is_zero():
    z = np.zeros(N, np.float32)
    assert TM.multi_tensor_maxnorm(torch.tensor(z)).item() == \
        float(JM.multi_tensor_maxnorm(jnp.asarray(z))) == 0.0


def test_lengths_must_be_arena_multiples():
    with pytest.raises(ValueError, match="BUFFER_MULTIPLE"):
        TM.multi_tensor_scale(torch.ones(1000), 2.0)
    with pytest.raises(ValueError, match="one length"):
        TM.multi_tensor_axpby(1.0, torch.ones(N), 1.0, torch.ones(65536))
    with pytest.raises(ValueError, match="BUFFER_MULTIPLE"):
        TM.multi_tensor_maxnorm(torch.ones(70000))
