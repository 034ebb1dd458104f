"""The port's input pipeline against the JAX package's, bit for bit.

On one JPEG tree written by the JAX package (PIL), the port's
``ImageFolderSource`` (RandomResizedCrop + flip, eval centre crop) and
``PackedSource`` (crop + flip, ``rrc=True``, eval, raw uint8) give the JAX
package's batches and labels exactly; the caches the two packages build
from one tree have byte-equal shards and each package reads the other's;
cursors cross between them. Then the cases of ``tests/test_data.py`` on
the port: file shards and their rank defaults (``torch.distributed``,
else ``RANK``/``WORLD_SIZE``), cursor resume, ``skip_batches`` (no image
decoded), mismatch refusals, the JSON round trip, cache reuse and
rebuilds, the prefetcher's order, cast and error path on the CPU, the
``python -m apex_tpu_torch.data`` probe, and the example's on-card uint8
normalise against JAX for all 256 values.
"""

import json
import os

import numpy as np
import pytest
import torch

import apex_tpu.data as jdata
from apex_tpu_torch.data import (DevicePrefetcher, ImageFolderSource,
                                 PackedSource, build_cache,
                                 make_fake_imagefolder, measure_source,
                                 normalize_uint8, synthetic_source)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX package's fake tree (PIL-encoded JPEGs)."""
    root = tmp_path_factory.mktemp("fakeimagenet")
    return jdata.make_fake_imagefolder(str(root), n_classes=3, per_class=4,
                                       size=64)


@pytest.fixture(scope="module")
def caches(tree, tmp_path_factory):
    j = jdata.build_cache(tree, str(tmp_path_factory.mktemp("jcache")),
                          store_size=48, shard_images=5)
    t = build_cache(tree, str(tmp_path_factory.mktemp("tcache")),
                    store_size=48, shard_images=5)
    return j, t


def _same_stream(a, b):
    n = 0
    for (xa, ya), (xb, yb) in zip(a, b):
        assert xa.dtype == xb.dtype and xa.shape == xb.shape
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        n += 1
    return n


# --- against the JAX package ----------------------------------------------------

@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_imagefolder_batches_equal_jax(tree, train):
    kw = dict(workers=2, seed=3, train=train)
    a = jdata.ImageFolderSource(tree, 4, 32, **kw)
    b = ImageFolderSource(tree, 4, 32, **kw)
    assert _same_stream(a.batches(5), b.batches(5)) == 5   # two epochs


@pytest.mark.parametrize("mode", ["crop_flip", "rrc", "eval", "uint8"])
def test_packed_batches_equal_jax(caches, mode):
    kw = {"crop_flip": {}, "rrc": {"rrc": True},
          "eval": {"train": False}, "uint8": {"dtype": np.uint8}}[mode]
    jcache, tcache = caches
    with jdata.PackedSource(jcache, 4, 32, seed=1, workers=2, **kw) as a, \
            PackedSource(tcache, 4, 32, seed=1, workers=2, **kw) as b:
        assert _same_stream(a.batches(5), b.batches(5)) == 5


def test_caches_are_byte_equal_and_read_across(caches):
    jcache, tcache = caches
    for name in sorted(os.listdir(jcache)):
        if name.endswith(".npy"):
            with open(os.path.join(jcache, name), "rb") as f, \
                    open(os.path.join(tcache, name), "rb") as g:
                assert f.read() == g.read(), name
    with open(os.path.join(jcache, "meta.json")) as f, \
            open(os.path.join(tcache, "meta.json")) as g:
        assert json.load(f) == json.load(g)
    # each package reads the other's cache
    with jdata.PackedSource(tcache, 4, 32, seed=2) as a, \
            PackedSource(jcache, 4, 32, seed=2) as b:
        assert _same_stream(a.epoch(), b.epoch()) == 3


def test_cache_reuse_across_packages(tree, tmp_path):
    """A cache the JAX package built is reused by the port's build_cache
    (and the reverse): same meta, same fingerprint, nothing rewritten."""
    for first, second in ((jdata.build_cache, build_cache),
                          (build_cache, jdata.build_cache)):
        d = str(tmp_path / first.__module__.split(".")[0])
        first(tree, d, store_size=48)
        m0 = os.path.getmtime(os.path.join(d, "shard_00000.npy"))
        second(tree, d, store_size=48)
        assert os.path.getmtime(os.path.join(d, "shard_00000.npy")) == m0


def test_cursors_cross_packages(tree):
    j = jdata.ImageFolderSource(tree, 4, 32, workers=2, seed=5)
    next(j.batches(2))
    t = ImageFolderSource(tree, 4, 32, workers=2, seed=5)
    t.load_state(json.loads(json.dumps(j.state())))
    assert t.state() == j.state()
    assert _same_stream(j.batches(3), t.batches(3)) == 3
    j2 = jdata.ImageFolderSource(tree, 4, 32, workers=2, seed=5)
    j2.load_state(t.state())
    assert j2.cursor_index() == t.cursor_index()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_uint8_normalise_equals_jax_for_all_values(dtype):
    import jax.numpy as jnp
    x = np.arange(256, dtype=np.uint8)
    want = np.asarray((jnp.asarray(x).astype(getattr(jnp, dtype))
                       * (1.0 / 255.0)).astype(jnp.float32))
    got = normalize_uint8(torch.from_numpy(x), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_prefetcher_cast_equals_jax_host_cast():
    """The host half cast rounds to nearest even from f32, as the JAX
    package's ``astype`` does."""
    import jax.numpy as jnp
    src = list(synthetic_source(2, 8, 3, seed=4))
    got = list(DevicePrefetcher(iter(src), device="cpu",
                                cast_dtype=torch.bfloat16))
    for (x, y), (gx, gy) in zip(src, got):
        want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                          .astype(jnp.float32))
        assert gx.dtype == torch.bfloat16
        np.testing.assert_array_equal(gx.float().numpy(), want)
        np.testing.assert_array_equal(gy.numpy(), y)


# --- the cases of tests/test_data.py ----------------------------------------------

def test_imagefolder_batches(tree):
    src = ImageFolderSource(tree, batch=4, size=32, workers=2, seed=0)
    assert len(src.classes) == 3
    batches = list(src.epoch())
    assert len(batches) == 3
    for x, y in batches:
        assert x.shape == (4, 32, 32, 3) and x.dtype == np.float32
        assert x.min() >= 0.0 and x.max() <= 1.0
        assert y.dtype == np.int32 and set(y) <= {0, 1, 2}


def test_epochs_reshuffle_and_steps(tree):
    src = ImageFolderSource(tree, batch=4, size=32, workers=2, seed=0)
    a = [y.tolist() for _, y in src.epoch()]
    b = [y.tolist() for _, y in src.epoch()]
    assert a != b
    assert sum(1 for _ in src.batches(7)) == 7


def test_device_prefetcher_order_and_cast():
    src = synthetic_source(2, 8, 5, seed=3)
    got = list(DevicePrefetcher(src, device="cpu",
                                cast_dtype=torch.bfloat16, depth=2))
    assert len(got) == 5
    assert got[0][0].dtype == torch.bfloat16
    want = list(synthetic_source(2, 8, 5, seed=3))
    np.testing.assert_allclose(got[0][0].float().numpy(), want[0][0],
                               atol=1e-2)
    for (gx, gy), (_, wy) in zip(got, want):
        np.testing.assert_array_equal(gy.numpy(), wy)


def test_device_prefetcher_propagates_errors():
    def bad():
        yield np.zeros((1, 2, 2, 3), np.float32), np.zeros(1, np.int32)
        raise ValueError("decode failed")

    it = iter(DevicePrefetcher(bad(), device="cpu"))
    next(it)
    with pytest.raises(ValueError, match="decode failed"):
        list(it)


def test_measure_source_runs(tree):
    src = ImageFolderSource(tree, batch=4, size=32, workers=2)
    assert measure_source(src.batches(4), steps=3) > 0


def test_too_small_dataset_raises(tmp_path):
    make_fake_imagefolder(str(tmp_path), n_classes=1, per_class=2, size=32)
    src = ImageFolderSource(str(tmp_path), batch=8, size=16, workers=1)
    with pytest.raises(ValueError, match="no batch"):
        next(src.batches(1))


def test_process_file_shards_are_disjoint_and_cover(tree):
    full = ImageFolderSource(tree, batch=1, size=16, workers=1)
    shards = [ImageFolderSource(tree, batch=1, size=16, workers=1,
                                process_index=r, process_count=3)
              for r in range(3)]
    sets = [set(s.paths) for s in shards]
    for i in range(3):
        for j in range(i + 1, 3):
            assert not (sets[i] & sets[j])
    assert set().union(*sets) == set(full.paths)
    for s in shards:
        for p, lab in zip(s.paths, s.labels):
            assert full.labels[full.paths.index(p)] == lab
    uneven = [ImageFolderSource(tree, batch=1, size=16, workers=1,
                                process_index=r, process_count=5)
              for r in range(5)]
    ns = [len(s.paths) for s in uneven]
    assert len(set(ns)) == 1 and ns[0] == len(full.paths) // 5


def test_shard_defaults_field_by_field(tree, monkeypatch):
    """No process group: ``RANK``/``WORLD_SIZE``, each field on its own
    (a caller passing only the count still lands on its own rank), as
    the JAX package's ``jax.process_*`` fallback does."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "3")
    both = ImageFolderSource(tree, batch=1, size=16, workers=1)
    assert (both.process_index, both.process_count) == (1, 3)
    only_count = ImageFolderSource(tree, batch=1, size=16, workers=1,
                                   process_count=2)
    assert (only_count.process_index, only_count.process_count) == (1, 2)
    only_rank = ImageFolderSource(tree, batch=1, size=16, workers=1,
                                  process_index=2)
    assert (only_rank.process_index, only_rank.process_count) == (2, 3)
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    plain = ImageFolderSource(tree, batch=1, size=16, workers=1)
    assert (plain.process_index, plain.process_count) == (0, 1)
    assert plain.paths == jdata.ImageFolderSource(tree, 1, 16).paths


def test_shard_rank_out_of_range_and_empty_raise(tree, tmp_path):
    with pytest.raises(ValueError, match="out of range"):
        ImageFolderSource(tree, batch=1, size=16, workers=1,
                          process_index=3, process_count=3)
    make_fake_imagefolder(str(tmp_path / "tiny"), n_classes=1,
                          per_class=2, size=32)
    with pytest.raises(ValueError, match="empty file shard"):
        ImageFolderSource(str(tmp_path / "tiny"), batch=1, size=16,
                          workers=1, process_index=5, process_count=9)


def test_cursor_resume_is_exact(tree):
    ref = ImageFolderSource(tree, batch=4, size=32, workers=2, seed=5)
    stream = [(x.copy(), y.copy()) for x, y in ref.batches(5)]
    src = ImageFolderSource(tree, batch=4, size=32, workers=2, seed=5)
    it = src.batches(5)
    for _ in range(2):
        next(it)
    cursor = src.state()
    it.close()
    resumed = ImageFolderSource(tree, batch=4, size=32, workers=2,
                                seed=5).load_state(cursor)
    rest = list(resumed.batches(3))
    assert len(rest) == 3
    for (xa, ya), (xb, yb) in zip(stream[2:], rest):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_skip_batches_fast_forward_is_exact(tree):
    """``skip_batches(n)`` lands on the stream of a run that read those
    n batches, decoding no image for them, also from the post-epoch
    transient cursor."""
    ref = ImageFolderSource(tree, batch=4, size=32, workers=2, seed=5)
    stream = [(x.copy(), y.copy()) for x, y in ref.batches(7)]
    src = ImageFolderSource(tree, batch=4, size=32, workers=2, seed=5)
    next(src.batches(1))
    src.skip_batches(3)
    assert src.cursor_index() == 4 and src.n_decoded == 4
    x, _ = next(src.batches(1))
    np.testing.assert_array_equal(x, stream[4][0])
    assert src.n_decoded == 8

    src = ImageFolderSource(tree, batch=4, size=32, workers=2, seed=5)
    it = src.epoch()
    for _ in range(len(src)):
        next(it)
    cursor = src.state()
    assert cursor["batch"] == len(src)
    resumed = ImageFolderSource(tree, batch=4, size=32, workers=2,
                                seed=5).load_state(cursor)
    resumed.skip_batches(2)
    assert resumed.cursor_index() == len(src) + 2
    x, _ = next(resumed.batches(1))
    np.testing.assert_array_equal(x, stream[len(src) + 2][0])
    assert resumed.n_decoded == 4
    with pytest.raises(ValueError, match="n >= 0"):
        resumed.skip_batches(-1)


def test_cursor_mismatch_is_refused(tree):
    cursor = ImageFolderSource(tree, batch=4, size=32, workers=2,
                               seed=5).state()
    with pytest.raises(ValueError, match="cursor mismatch"):
        ImageFolderSource(tree, batch=4, size=32, workers=2,
                          seed=6).load_state(cursor)
    with pytest.raises(ValueError, match="batch_size"):
        ImageFolderSource(tree, batch=2, size=32, workers=2,
                          seed=5).load_state(cursor)
    with pytest.raises(ValueError, match="shard"):
        ImageFolderSource(tree, batch=4, size=32, workers=2, seed=5,
                          process_index=1,
                          process_count=2).load_state(cursor)


def test_cursor_json_roundtrips(tree):
    src = ImageFolderSource(tree, batch=4, size=32, workers=2, seed=1)
    next(src.batches(1))
    cur = json.loads(json.dumps(src.state()))
    src2 = ImageFolderSource(tree, batch=4, size=32, workers=2,
                             seed=1).load_state(cur)
    assert src2.state() == src.state()


def test_build_cache_layout_and_idempotence(tree, caches):
    cache = caches[1]
    with open(os.path.join(cache, "meta.json")) as f:
        meta = json.load(f)
    assert meta["n"] == 12 and meta["store_size"] == 48
    assert [s["n"] for s in meta["shards"]] == [5, 5, 2]
    labels = np.load(os.path.join(cache, "labels.npy"))
    assert labels.shape == (12,) and set(labels) == {0, 1, 2}
    m0 = os.path.getmtime(os.path.join(cache, "shard_00000.npy"))
    build_cache(tree, cache, store_size=48)
    assert os.path.getmtime(os.path.join(cache, "shard_00000.npy")) == m0


def test_build_cache_rebuilds_on_content_change(tmp_path):
    root = make_fake_imagefolder(str(tmp_path / "imgs"), n_classes=2,
                                 per_class=3, size=64)
    cdir = str(tmp_path / "cache")
    meta_path = os.path.join(cdir, "meta.json")
    build_cache(root, cdir, store_size=48, shard_images=4)
    with open(meta_path) as f:
        fp0 = json.load(f)["fingerprint"]
    # the JAX package fingerprints the same listing the same way
    assert fp0 == jdata.packed._fingerprint(
        root, *jdata.pipeline._list_imagefolder(root)[:2])
    cls = sorted(os.listdir(root))[0]
    os.rename(os.path.join(root, cls), os.path.join(root, "zzz_" + cls))
    build_cache(root, cdir, store_size=48, shard_images=4)
    with open(meta_path) as f:
        fp1 = json.load(f)["fingerprint"]
    assert fp1 != fp0
    cls0 = sorted(os.listdir(root))[0]
    img0 = os.path.join(root, cls0,
                        sorted(os.listdir(os.path.join(root, cls0)))[0])
    os.utime(img0, ns=(os.stat(img0).st_atime_ns,
                       os.stat(img0).st_mtime_ns + 10**9))
    build_cache(root, cdir, store_size=48, shard_images=4)
    with open(meta_path) as f:
        assert json.load(f)["fingerprint"] != fp1


def test_packed_source_batches_and_labels(caches):
    with PackedSource(caches[1], batch=4, size=32, seed=0) as src:
        assert len(src) == 3
        for x, y in src.epoch():
            assert x.shape == (4, 32, 32, 3) and x.dtype == np.float32
            assert x.min() >= 0.0 and x.max() < 1.0
            assert y.dtype == np.int32


def test_packed_uint8_matches_float_path(caches):
    with PackedSource(caches[1], 4, 32, seed=5) as a, \
            PackedSource(caches[1], 4, 32, seed=5, dtype=np.uint8) as b:
        xf, yf = next(a.epoch())
        xu, yu = next(b.epoch())
    np.testing.assert_array_equal(yf, yu)
    np.testing.assert_allclose(xf, xu.astype(np.float32) / 255.0,
                               atol=1e-7)


def test_packed_epochs_reshuffle_and_bounds(caches):
    with PackedSource(caches[1], 4, 32, seed=1, dtype=np.uint8) as src:
        e1 = [y.tolist() for _, y in src.epoch()]
        e2 = [y.tolist() for _, y in src.epoch()]
    assert e1 != e2
    with pytest.raises(ValueError):
        PackedSource(caches[1], 4, 64)


def test_packed_source_through_prefetcher(caches):
    with PackedSource(caches[1], 4, 32, seed=3, dtype=np.uint8) as src:
        got = list(DevicePrefetcher(src.batches(3), device="cpu"))
    assert len(got) == 3 and got[0][0].dtype == torch.uint8


def test_loader_probe_cli(tree, tmp_path, capsys, monkeypatch):
    import sys
    from apex_tpu_torch.data import __main__ as cli
    monkeypatch.setattr(sys, "argv", [
        "x", "--bench", tree, "--cache", str(tmp_path / "c"), "-b", "4",
        "--size", "32", "--store-size", "48", "--workers", "2",
        "--steps", "2"])
    cli.main()
    out = capsys.readouterr().out
    assert "packed cache ready" not in out
    assert out.startswith("loader: ") and "img/s (batch 4, size 32" in out
