"""The port's integrity fingerprints against the JAX package's.

- ``fingerprint_tree`` bit for bit against ``apex_tpu.guard.
  fingerprint_tree`` on trees carried over by ``convert`` (a tiny BERT's
  flax params: sorted keys, Dense kernels (in, out) against the port's
  (out, in) weights, visited in the JAX layout without a transposed copy)
  and on f32, bf16, fp16, fp8 (e4m3, e5m2), int8, int32, int64, uint8,
  f64 and bool leaves with empty and 0-d leaves, at several fold chunk
  sizes; ``TypeError`` on complex; single-bit flips move it.
- ``vote``, ``integrity_commit``, ``integrity_resize`` and
  ``absorb_verify`` against the JAX package's.
- Three gloo processes: fingerprint and compare every step, chaos flips
  one mantissa bit of rank 2's params, every rank flags the divergence at
  that step and skips it, the vote names rank 2, ``repair`` restores it
  and the re-verify agrees; every rank ends bit-equal to the others, and
  every rank's gathered fingerprints equal the JAX package's fingerprints
  of the same trees.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_parallel_cases as cases
from apex_tpu import guard as jguard
from apex_tpu import models as jmodels
from apex_tpu_torch import guard as tguard
from apex_tpu_torch.convert import params_from_jax

_ML = {torch.bfloat16: ml_dtypes.bfloat16,
       torch.float8_e4m3fn: ml_dtypes.float8_e4m3fn,
       torch.float8_e5m2: ml_dtypes.float8_e5m2}
_BITS = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.uint16)}


def _to_numpy(t):
    """A port tensor as the numpy array JAX gets (extension dtypes through
    their bits)."""
    if t.dtype in _ML:
        tb, nb = _BITS[t.dtype.itemsize]
        return t.view(tb).numpy().view(nb).view(_ML[t.dtype])
    return t.numpy()


def _jax_fp(tree):
    return int(jguard.fingerprint_tree(jax.tree_util.tree_map(
        jnp.asarray, tree)))


def test_fingerprint_of_a_converted_bert_matches_jax():
    jenc = jmodels.BertEncoder(1000, hidden=64, layers=2, heads=2,
                               max_len=32)
    params = jenc.init(jax.random.PRNGKey(3),
                       jnp.zeros((1, 32), jnp.int32))["params"]
    port = params_from_jax(params, device="cpu")
    want = int(jguard.fingerprint_tree(params))
    for chunk in (tguard.integrity.CHUNK_ELEMS, 4099):
        assert int(tguard.fingerprint_tree(port, chunk=chunk)) == want
    name = next(k for k in port if k.endswith("qkv_proj.weight"))
    flipped = dict(port)
    flipped[name] = port[name].clone()
    flipped[name].view(-1).view(torch.int32)[5] ^= 1
    assert int(tguard.fingerprint_tree(flipped)) != want


def _dtype_tree(seed):
    rng = np.random.RandomState(seed)
    return {
        "f32": torch.tensor(rng.randn(6, 4).astype(np.float32)),
        "bf16": torch.tensor(rng.randn(9)).to(torch.bfloat16),
        "f16": torch.tensor(rng.randn(3, 3)).to(torch.float16),
        "e4m3": torch.tensor(rng.randn(5)).to(torch.float8_e4m3fn),
        "e5m2": torch.tensor(rng.randn(5)).to(torch.float8_e5m2),
        "i8": torch.tensor([-128, -1, 0, 7], dtype=torch.int8),
        "i32": torch.tensor(rng.randint(-2 ** 31, 2 ** 31 - 1, (4,)),
                            dtype=torch.int32),
        "i64": torch.tensor([2 ** 40 + 3, -(2 ** 35), 1], dtype=torch.int64),
        "u8": torch.tensor([0, 200, 255], dtype=torch.uint8),
        "f64": torch.tensor(rng.randn(3)),
        "bool": torch.tensor([True, False, True, True]),
        "empty": torch.zeros((0, 4)),
        "scalar": torch.tensor(2.5),
    }


@pytest.mark.parametrize("keys", [
    ("f32",), ("bf16",), ("f16",), ("e4m3", "e5m2"), ("i8", "i32", "u8"),
    ("i64",), ("f64",), ("bool",), ("empty", "scalar", "f32"),
    tuple(_dtype_tree(0))])
@pytest.mark.parametrize("chunk", [1 << 24, 3])
def test_fingerprint_dtypes_match_jax(keys, chunk):
    tree = {k: v for k, v in _dtype_tree(1).items() if k in keys}
    with jax.enable_x64(True):
        want = _jax_fp({k: _to_numpy(v) for k, v in tree.items()})
    assert int(tguard.fingerprint_tree(tree, chunk=chunk)) == want


def test_fingerprint_refuses_complex_and_sees_flips():
    with pytest.raises(TypeError, match="complex"):
        tguard.fingerprint_tree({"c": torch.zeros(2, dtype=torch.complex64)})
    with pytest.raises(TypeError, match="complex"):
        tguard.fingerprint_tree({"c": torch.zeros(0, dtype=torch.complex64)})
    base = {"a": torch.arange(8.0), "b": torch.arange(8.0)}
    fp = int(tguard.fingerprint_tree(base))
    swapped = {"a": base["a"][[1, 0, 2, 3, 4, 5, 6, 7]], "b": base["b"]}
    assert int(tguard.fingerprint_tree(swapped)) != fp
    for bit in (0, 22, 31):
        f = {k: v.clone() for k, v in base.items()}
        f["b"].view(torch.int32)[3] ^= (1 << bit) - (2 ** 32 if bit == 31
                                                      else 0)
        assert int(tguard.fingerprint_tree(f)) != fp


@pytest.mark.parametrize("fps", [
    [5, 5, 9], [7, 3, 3], [1, 2], [4, 4], [1, 2, 3], [8, 8, 1, 1],
    [2 ** 32 - 1, 2 ** 32 - 1, 0], [6, 6, 6, 2, 6]])
def test_vote_matches_jax(fps):
    got = tguard.vote(torch.tensor(fps, dtype=torch.int64))
    want = jguard.vote(np.asarray(fps, np.uint32))
    assert tuple(got) == tuple(want)
    assert tuple(tguard.vote(fps)) == tuple(want)


def _jax_ist(ist):
    """The JAX IntegrityState of the same values (the port keeps 32-bit
    fingerprints in int64)."""
    return jguard.IntegrityState(**{
        f: jnp.asarray(getattr(ist, f).numpy().astype(np.uint32)
                       if getattr(ist, f).dtype == torch.int64
                       else getattr(ist, f).numpy())
        for f in ist._fields})


def _assert_ist_equal(t, j):
    for f in j._fields:
        got, want = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        if want.dtype == np.uint32:
            assert got.dtype == np.int64
            got = got.astype(np.uint32)
        assert got.dtype == want.dtype and np.array_equal(got, want), f


def test_state_helpers_match_jax():
    cfg = tguard.IntegrityConfig(check_every=2)
    t = tguard.integrity_init(cfg, world=3, device="cpu")
    j = jguard.integrity_init(jguard.IntegrityConfig(check_every=2), world=3)
    _assert_ist_equal(t, j)
    t = t._replace(divergent=torch.tensor(True),
                   rank_fps=torch.tensor([1, 1, 2 ** 32 - 5]),
                   fingerprint=torch.tensor(7), fp_min=torch.tensor(1),
                   fp_max=torch.tensor(2 ** 32 - 5),
                   mismatch_count=torch.tensor(2, dtype=torch.int32),
                   last_check_step=torch.tensor(4, dtype=torch.int32))
    j = _jax_ist(t)
    _assert_ist_equal(t, j)
    for world in (3, 4, 2):
        _assert_ist_equal(tguard.integrity_resize(t, world=world),
                          jguard.integrity_resize(j, world=world))
    fps = [9, 9, 9]
    _assert_ist_equal(tguard.absorb_verify(t, 9, 9, torch.tensor(fps)),
                      jguard.absorb_verify(j, jnp.uint32(9), jnp.uint32(9),
                                           jnp.asarray(fps, jnp.uint32)))
    new, old = {"w": torch.ones(2)}, {"w": torch.zeros(2)}
    got = tguard.integrity_commit(t, new, old)
    want = jguard.integrity_commit(j, {"w": jnp.ones(2)},
                                   {"w": jnp.zeros(2)})
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    assert bool(tguard.integrity_ok(t)) == bool(jguard.integrity_ok(j))
    for bad in (dict(world=1), dict(world=2)):
        if bad["world"] < 2:
            with pytest.raises(ValueError):
                tguard.integrity_init(cfg, device="cpu", **bad)
    with pytest.raises(ValueError):
        tguard.integrity_init(tguard.IntegrityConfig(check_every=0),
                              world=2, device="cpu")


def test_three_ranks_flip_vote_repair(tmp_path):
    inputs = {"params": cases.integrity_inputs(0)}
    res = cases.ranks(cases.run(3, ["integrity_flip_repair"], tmp_path,
                                inputs), "integrity_flip_repair")
    tree = dict(inputs["params"])
    tree["b"] = tree["b"].astype(ml_dtypes.bfloat16)
    good = _jax_fp(tree)
    flipped = res[2]["flipped"]
    bad_tree = dict(tree)
    bad_tree["a"] = np.asarray(flipped["a"])
    bad = _jax_fp(bad_tree)
    assert bad != good
    for r, out in enumerate(res):
        fps = [np.asarray(f).astype(np.int64).tolist() for f in out["fps"]]
        assert fps[0] == fps[1] == [good] * 3, r
        assert fps[2] == [good, good, bad], r
        assert fps[3] == [good] * 3, r
        assert out["divergent"] == [False, False, True, False], r
        assert out["skipped"] == [False, False, True, False], r
        assert out["minority"] == [2] and out["verified"] is True, r
        assert np.asarray(out["absorbed"]).tolist() == [good] * 3
        assert out["check_count"] == 4 and out["mismatch_count"] == 1
        assert out["collectives"] == {"guard/integrity_check": 15,
                                      "guard/integrity_repair": 3}
        for k in tree:
            np.testing.assert_array_equal(np.asarray(out["params"][k]),
                                          np.asarray(res[0]["params"][k]))
    np.testing.assert_array_equal(
        np.asarray(res[0]["params"]["a"]), inputs["params"]["a"])
    assert not np.array_equal(np.asarray(flipped["a"]),
                              inputs["params"]["a"])
