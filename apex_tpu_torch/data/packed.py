"""Packed pre-decoded dataset cache — the DALI-accelerated-input role.

The port of ``apex_tpu/data/packed.py``. JPEG decode on host CPUs cannot
feed a fast card; the answer is a one-time decode into packed uint8-NHWC
shards:

- **build**: decode every image once (resize short side to
  ``store_size``, center crop) with the thread pool, write
  ``shard_*.npy`` files of (N, S, S, 3) uint8 plus ``labels.npy`` and
  ``meta.json`` — the JAX package's layout, meta and content fingerprint,
  so a cache either package built is read by the other (and caches the
  two build from one tree have byte-equal shards: the port's codec and
  resampler compute PIL's pixels);
- **read**: ``PackedSource`` memory-maps the shards and assembles
  batches by global index — per-epoch shuffle, random-crop + horizontal
  flip in numpy slicing (the same ``RandomState`` draws as the JAX
  package), float scale into one contiguous output buffer, or raw uint8
  (``dtype=np.uint8``) normalised on the card.

``rrc=True`` does true RandomResizedCrop on the cached pixels (the
port's PIL-exact bilinear resampler from the array).

Measured with ``python -m apex_tpu_torch.data --bench DIR --cache CACHE``.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from apex_tpu_torch.data import image

META = "meta.json"


def _v3_view_on_strided() -> bool:
    """numpy>=1.23 allows an itemsize-changing view on arrays that are
    contiguous only in the last axis — probed once, not per image."""
    try:
        np.zeros((4, 4, 3), np.uint8)[1:3, 1:3].view("V3")
        return True
    except ValueError:
        return False


_V3_STRIDED_OK = _v3_view_on_strided()


def _fingerprint(root: str, paths, labels) -> str:
    """Content identity of the source listing: relative paths, labels,
    and each file's (size, mtime_ns). Guards cache reuse against a
    same-count dataset whose files, labels, or in-place contents
    changed (a count+size check alone would serve stale pixels).

    Detecting in-place edits costs one metadata sweep even on the
    cache-HIT path; it is batched as one scandir per class directory
    (readdir-plus filesystems serve size/mtime from the directory
    pass), which bounds the warm-start cost at directory enumeration —
    the same order as the listing build_cache already does."""
    stats = {}
    for d in sorted({os.path.dirname(p) for p in paths}):
        with os.scandir(d) as it:
            for e in it:
                stats[e.path] = e.stat()
    h = hashlib.sha256()
    for p, y in zip(paths, labels):
        st = stats.get(p)
        if st is None:
            # deleted/renamed between the listing and this sweep, or a
            # path-normalization mismatch with the scandir key: fall
            # back to a direct stat; a file that is truly gone
            # fingerprints as absent (so the cache rebuilds) instead of
            # raising KeyError on the warm-check path
            try:
                st = os.stat(p)
            except OSError:
                h.update(os.path.relpath(p, root).encode())
                h.update(b"\0%d\0missing\n" % int(y))
                continue
        h.update(os.path.relpath(p, root).encode())
        h.update(b"\0%d\0%d\0%d\n" % (int(y), st.st_size,
                                      st.st_mtime_ns))
    return h.hexdigest()


def _decode_store(path: str, store_size: int) -> np.ndarray:
    """Resize short side to store_size, center crop — the one-time
    decode transform (deterministic; augmentation happens at read)."""
    from apex_tpu_torch.data.pipeline import _center_box
    from apex_tpu_torch.data.resample import resize

    img = image.read_rgb(path)
    return resize(img, (store_size, store_size),
                  _center_box(img.shape[1], img.shape[0]))


def build_cache(root: str, cache_dir: str, *, store_size: int = 256,
                shard_images: int = 4096,
                workers: Optional[int] = None) -> str:
    """One-time decode of an ImageFolder tree into packed shards.
    Idempotent: an existing complete cache (matching meta) is reused."""
    from apex_tpu_torch.data.pipeline import _list_imagefolder

    paths, labels, classes = _list_imagefolder(root)
    os.makedirs(cache_dir, exist_ok=True)
    meta_path = os.path.join(cache_dir, META)
    fp = _fingerprint(root, paths, labels)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if (meta.get("n") == len(paths)
                and meta.get("store_size") == store_size
                and meta.get("fingerprint") == fp):
            return cache_dir

    workers = workers or min(16, (os.cpu_count() or 1))
    pool = concurrent.futures.ThreadPoolExecutor(workers)
    try:
        shards = []
        for s0 in range(0, len(paths), shard_images):
            chunk = paths[s0:s0 + shard_images]
            buf = np.empty((len(chunk), store_size, store_size, 3),
                           np.uint8)
            for i, arr in enumerate(pool.map(
                    lambda p: _decode_store(p, store_size), chunk)):
                buf[i] = arr
            name = f"shard_{len(shards):05d}.npy"
            np.save(os.path.join(cache_dir, name), buf)
            shards.append({"file": name, "n": len(chunk)})
    finally:
        pool.shutdown(wait=False)
    np.save(os.path.join(cache_dir, "labels.npy"), labels)
    meta = {"n": len(paths), "store_size": store_size,
            "shards": shards, "classes": classes, "fingerprint": fp}
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    return cache_dir


class PackedSource:
    """Batched (x, y) iterator over a packed cache — drop-in for
    :class:`ImageFolderSource` (same epoch/shuffle/batches surface, so
    the prefetcher and `measure_source` compose unchanged)."""

    def __init__(self, cache_dir: str, batch: int, size: int = 224, *,
                 train: bool = True, seed: int = 0, dtype=np.float32,
                 drop_last: bool = True, rrc: bool = False,
                 workers: Optional[int] = None):
        with open(os.path.join(cache_dir, META)) as f:
            self.meta = json.load(f)
        self.store = self.meta["store_size"]
        if size > self.store:
            raise ValueError(f"crop size {size} > cached store size "
                             f"{self.store}")
        self.batch = batch
        self.size = size
        self.train = train
        self.seed = seed
        self.dtype = dtype
        self.drop_last = drop_last
        self.rrc = rrc
        self.classes = self.meta["classes"]
        self.labels = np.load(os.path.join(cache_dir, "labels.npy"))
        # memory-mapped shards + global-index offsets
        self._maps = [np.load(os.path.join(cache_dir, s["file"]),
                              mmap_mode="r")
                      for s in self.meta["shards"]]
        self._starts = np.cumsum(
            [0] + [s["n"] for s in self.meta["shards"]])
        self.workers = workers or min(8, (os.cpu_count() or 1))
        self._pool = concurrent.futures.ThreadPoolExecutor(self.workers)
        self._epoch = 0

    def close(self) -> None:
        self._pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __len__(self):
        n = self.meta["n"] // self.batch
        if not self.drop_last and self.meta["n"] % self.batch:
            n += 1
        return n

    def _fill_slab(self, idx, shard_ids, y0s, x0s, flips, rrc_seeds,
                   u8, j0, j1):
        """Crop/flip cached images idx[j0:j1] into u8[j0:j1] — one
        contiguous slab per worker (per-image task dispatch costs more
        than the crop itself on small copies)."""
        c = self.size
        u8v = u8.view("V3")   # 3-byte items: reversed-width copies run
        # ~1.8x faster than numpy's per-channel negative-stride loop
        for j in range(j0, j1):
            img = self._maps[shard_ids[j]][idx[j]
                                           - self._starts[shard_ids[j]]]
            if rrc_seeds is not None:
                from apex_tpu_torch.data.pipeline import (
                    _random_resized_crop, _seeded)
                crop = _random_resized_crop(np.asarray(img), c,
                                            _seeded(int(rrc_seeds[j])))
            else:
                crop = img[y0s[j]:y0s[j] + c, x0s[j]:x0s[j] + c]
            if flips is not None and flips[j]:
                if _V3_STRIDED_OK:
                    u8v[j] = crop.view("V3")[:, ::-1]
                else:
                    u8[j] = crop[:, ::-1]
            else:
                u8[j] = crop

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.RandomState(self.seed + self._epoch)
        order = rng.permutation(self.meta["n"])
        self._epoch += 1
        b = self.batch
        c, s = self.size, self.store
        stop = len(order) - (b - 1 if self.drop_last else 0)
        out_u8 = self.dtype == np.uint8 or self.dtype is np.uint8
        for start in range(0, stop, b):
            idx = order[start:start + b]
            n = len(idx)
            shard_ids = np.searchsorted(self._starts, idx, "right") - 1
            # augment decisions drawn vectorized, once per batch
            if self.train:
                y0s = rng.randint(0, s - c + 1, n)
                x0s = rng.randint(0, s - c + 1, n)
                flips = rng.rand(n) < 0.5
                rrc_seeds = (rng.randint(1 << 31, size=n)
                             if self.rrc else None)
            else:
                y0s = x0s = np.full(n, (s - c) // 2)
                flips = rrc_seeds = None
            u8 = np.empty((n, c, c, 3), np.uint8)
            if self.workers <= 1 or n < 2 * self.workers:
                self._fill_slab(idx, shard_ids, y0s, x0s, flips,
                                rrc_seeds, u8, 0, n)
            else:
                w = self.workers
                bounds = [(n * i // w, n * (i + 1) // w)
                          for i in range(w)]
                list(self._pool.map(
                    lambda se: self._fill_slab(idx, shard_ids, y0s,
                                               x0s, flips, rrc_seeds,
                                               u8, *se), bounds))
            if out_u8:
                # raw mode: normalization happens on-device (the DALI
                # GPU-normalize role) — quarter the host-side bytes
                yield u8, self.labels[idx]
            else:
                # one-pass convert+scale ufunc (no separate astype)
                x = np.multiply(u8, np.float32(1.0 / 255.0),
                                dtype=np.float32)
                if self.dtype != np.float32:
                    x = x.astype(self.dtype)
                yield x, self.labels[idx]

    def batches(self, steps: int) -> Iterator[Tuple[np.ndarray,
                                                    np.ndarray]]:
        if len(self) == 0:
            raise ValueError("cache smaller than one batch")
        done = 0
        while done < steps:
            for xb, yb in self.epoch():
                yield xb, yb
                done += 1
                if done >= steps:
                    return
