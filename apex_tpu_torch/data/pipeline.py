"""Threaded ImageFolder input pipeline + device prefetch.

The port of ``apex_tpu/data/pipeline.py``: the reference's input machinery
for ``examples/imagenet`` (torch DataLoader / DALI decode+augment feeding
the CUDA-stream ``data_prefetcher``).

- **Decode/augment workers**: a thread pool decodes each file by its
  content, as PIL does (:func:`~apex_tpu_torch.data.image.read_rgb`:
  JPEG through the port's codec, whose C++ stages run under ctypes, which
  drops the GIL, so threads scale to the host's cores; PNG and BMP in
  numpy) and
  applies the standard train transform — RandomResizedCrop (scale
  0.08-1.0, ratio 3/4-4/3) through PIL's bilinear resampler
  (:mod:`~apex_tpu_torch.data.resample`) + horizontal flip — with the
  JAX package's ``RandomState`` draws in the same order, so a tree gives
  the JAX loader's batches bit for bit.
- **Batch assembly** into one contiguous NHWC array per batch, scaled to
  [0, 1) in ``dtype`` (host numpy, as in the JAX package).
- **Device prefetch**: :class:`DevicePrefetcher` stages each batch in
  pinned host memory (cast to the compute dtype there, so the copy moves
  the half bytes), copies it to the card on a side stream and hands it to
  the consumer's stream through an event.

``measure_source`` reports loader-only throughput, so an input-bound
configuration shows instead of silently capping training numbers.
"""

from __future__ import annotations

import concurrent.futures
import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from apex_tpu_torch.data import image, jpeg
from apex_tpu_torch.data.resample import resize
from apex_tpu_torch.utils.ranks import rank_default, world_default

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")

#: bounded retries for transient decode-path IO (shared-fs blips) —
#: override with APEX_TPU_DATA_IO_RETRIES, the JAX package's variable
_IO_ATTEMPTS = max(int(os.environ.get("APEX_TPU_DATA_IO_RETRIES", "3")), 1)


def _read_rgb_with_retry(path: str, attempts: int = None) -> np.ndarray:
    """Read + fully decode one image to (H, W, 3) uint8, retrying
    ``OSError`` with jittered backoff; a file that stays unreadable after
    ``attempts`` tries raises with the path and attempt count named."""
    attempts = _IO_ATTEMPTS if attempts is None else max(int(attempts), 1)
    last = None
    for k in range(attempts):
        try:
            return image.read_rgb(path)
        except OSError as e:
            last = e
            if k + 1 < attempts:
                from apex_tpu_torch.utils.backoff import backoff_sleep
                backoff_sleep(k, base_s=0.05, cap_s=0.5)
    raise OSError(f"failed to read image {path!r} after {attempts} "
                  f"attempts: {last}") from last


def _list_imagefolder(root: str):
    """(paths, labels, class_names) for a torchvision-ImageFolder-style
    tree: root/<class>/<image>."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for i, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for f in sorted(os.listdir(cdir)):
            if f.lower().endswith(IMG_EXTS):
                paths.append(os.path.join(cdir, f))
                labels.append(i)
    if not paths:
        raise FileNotFoundError(f"no images under {root!r}")
    return paths, np.asarray(labels, np.int32), classes


def _random_resized_crop(img: np.ndarray, size: int,
                         rng: np.random.RandomState,
                         scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop semantics on an (H, W, 3) uint8
    array, drawing from ``rng`` as the JAX package does."""
    h, w = img.shape[:2]
    area = w * h
    for _ in range(10):
        target = area * rng.uniform(*scale)
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        ar = np.exp(log_r)
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = rng.randint(0, w - cw + 1)
            y0 = rng.randint(0, h - ch + 1)
            box = (x0, y0, x0 + cw, y0 + ch)
            break
    else:  # fallback: center crop of the short side
        s = min(w, h)
        x0, y0 = (w - s) // 2, (h - s) // 2
        box = (x0, y0, x0 + s, y0 + s)
    return resize(img, (size, size), box)


def _stable_seed(seed: int, epoch: int, pos: int) -> int:
    """Per-image augmentation seed as a pure function of ``(source seed,
    epoch, position in the epoch's order)`` (the JAX package's
    splitmix-style avalanche), so resuming an epoch at batch k reproduces
    the augmentation stream without replaying the first k batches."""
    x = (seed * 0x9E3779B9 + epoch * 0x85EBCA6B + pos * 0xC2B2AE35
         + 0x27D4EB2F) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return x & 0x7FFFFFFF


def _center_box(w: int, h: int):
    s = min(w, h)
    return ((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2)


_RNG = threading.local()


def _seeded(seed: int) -> np.random.RandomState:
    """``RandomState(seed)``'s stream from this thread's generator,
    reseeded: constructing a RandomState gathers OS entropy before it is
    seeded (≈ 0.27 ms under the GIL, a decode thread's largest serial
    cost); ``seed`` alone takes microseconds."""
    rng = getattr(_RNG, "rng", None)
    if rng is None:
        rng = _RNG.rng = np.random.RandomState()
    rng.seed(seed)
    return rng


def _decode_one(path: str, size: int, seed: int, train: bool):
    rng = _seeded(seed & 0x7FFFFFFF)
    img = _read_rgb_with_retry(path)
    if train:
        arr = _random_resized_crop(img, size, rng)
    else:
        arr = resize(img, (size, size), _center_box(img.shape[1],
                                                    img.shape[0]))
    if train and rng.rand() < 0.5:
        arr = arr[:, ::-1]
    return arr


class ImageFolderSource:
    """Batched (x, y) iterator over an ImageFolder tree.

    A thread pool decodes/augments ``workers`` images concurrently;
    batches come out as one contiguous NHWC numpy array scaled to [0, 1)
    in ``dtype``. Iteration order reshuffles per epoch.

    **Multi-process**: ``process_index``/``process_count`` default, each
    on its own, to ``torch.distributed``'s rank and world size when a
    group is initialised, else ``RANK``/``WORLD_SIZE``, else 0/1; each rank
    reads a disjoint strided slice of the sorted file list, equalised to
    ``floor(N / world)`` files a rank.

    **Resumable**: :meth:`state` returns the ``(epoch, batch)`` cursor with
    the shard identity (capture it with
    ``CheckpointManager.save(..., extra={"cursor": src.state()})``) and
    :meth:`load_state` resumes at exactly the next batch: the epoch order
    is a pure function of ``seed + epoch`` and per-image augmentation
    seeds are position-derived (:func:`_stable_seed`). The cursor is the
    JAX package's, field for field.
    """

    def __init__(self, root: str, batch: int, size: int = 224, *,
                 workers: Optional[int] = None, train: bool = True,
                 seed: int = 0, dtype=np.float32,
                 drop_last: bool = True,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.paths, self.labels, self.classes = _list_imagefolder(root)
        if process_count is None:
            process_count = world_default()
        if process_index is None:
            process_index = rank_default()
        self.process_count = max(int(process_count), 1)
        self.process_index = int(process_index)
        if not (0 <= self.process_index < self.process_count):
            raise ValueError(f"process_index {self.process_index} out of "
                             f"range for process_count "
                             f"{self.process_count}")
        if self.process_count > 1:
            per = len(self.paths) // self.process_count
            if per == 0:
                raise ValueError(
                    f"rank {self.process_index}/{self.process_count} "
                    f"got an empty file shard — fewer files than ranks")
            sl = slice(self.process_index, per * self.process_count,
                       self.process_count)
            self.paths = self.paths[sl]
            self.labels = self.labels[sl]
        self.batch = batch
        self.size = size
        self.train = train
        self.seed = seed
        self.dtype = dtype
        self.drop_last = drop_last
        self.workers = workers or min(16, (os.cpu_count() or 1))
        self._pool = concurrent.futures.ThreadPoolExecutor(self.workers)
        self._epoch = 0
        self._batch = 0            # next batch index within the epoch
        #: images decoded so far (skip_batches decodes none)
        self.n_decoded = 0

    def __len__(self):
        n = len(self.paths) // self.batch
        if not self.drop_last and len(self.paths) % self.batch:
            n += 1
        return n

    def close(self) -> None:
        """Shut the decode pool down (idempotent)."""
        self._pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- the resumable cursor ------------------------------------------------

    def state(self) -> dict:
        """The cursor of the NEXT batch this source will yield, plus the
        shard identity (host ints only; JSON-safe)."""
        return {"epoch": int(self._epoch), "batch": int(self._batch),
                "shard": int(self.process_index),
                "n_shards": int(self.process_count),
                "seed": int(self.seed), "n_files": len(self.paths),
                "batch_size": int(self.batch),
                "drop_last": bool(self.drop_last)}

    def load_state(self, cursor: dict) -> "ImageFolderSource":
        """Resume from a :meth:`state` cursor. Refuses a cursor from a
        different file shard, a changed file set, or a different batch
        geometry."""
        for key, have in (("shard", self.process_index),
                          ("n_shards", self.process_count),
                          ("seed", self.seed),
                          ("n_files", len(self.paths)),
                          ("batch_size", self.batch),
                          ("drop_last", self.drop_last)):
            want = cursor.get(key, have)
            if int(want) != int(have):
                raise ValueError(
                    f"data cursor mismatch: checkpoint has {key}="
                    f"{want}, this source has {have} — rebuild the "
                    f"source with the same seed and shard assignment "
                    f"(or the dataset changed under the checkpoint)")
        self._epoch = int(cursor["epoch"])
        self._batch = int(cursor["batch"])
        return self

    def cursor_index(self) -> int:
        """Linear batch index of the cursor: ``epoch · batches_per_epoch
        + batch`` (the coordinate ``GuardPolicy.rewind`` differences)."""
        return self._epoch * len(self) + self._batch

    def skip_batches(self, n: int) -> "ImageFolderSource":
        """Advance the cursor ``n`` batches WITHOUT decoding anything (the
        guard's poison-batch fast-forward); crosses epoch boundaries.
        Rebuild iteration after calling this."""
        per = len(self)
        if per == 0:
            raise ValueError("cannot skip batches on a source that "
                             "yields none (fewer files than batch size)")
        n = int(n)
        if n < 0:
            raise ValueError(f"skip_batches needs n >= 0, got {n}")
        idx = self._epoch * per + self._batch + n
        self._epoch, self._batch = divmod(idx, per)
        return self

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Iterate the current epoch from the cursor position."""
        e = self._epoch
        order = np.random.RandomState(self.seed + e).permutation(
            len(self.paths))
        b = self.batch
        starts = range(0, len(order) - (b - 1 if self.drop_last
                                        else 0), b)
        for bi, start in enumerate(starts):
            if bi < self._batch:
                continue                 # cursor skip: nothing decoded
            idx = order[start:start + b]
            futs = [self._pool.submit(
                _decode_one, self.paths[i], self.size,
                _stable_seed(self.seed, e, start + j), self.train)
                    for j, i in enumerate(idx)]
            x = np.empty((len(idx), self.size, self.size, 3), self.dtype)
            for j, f in enumerate(futs):
                x[j] = f.result()
            self.n_decoded += len(idx)
            x *= np.asarray(1.0 / 255.0, self.dtype)
            self._batch = bi + 1
            yield x, self.labels[idx]
        self._epoch += 1
        self._batch = 0

    def batches(self, steps: int) -> Iterator[Tuple[np.ndarray,
                                                    np.ndarray]]:
        """Exactly ``steps`` batches, re-entering epochs as needed."""
        if len(self) == 0:
            raise ValueError(
                f"dataset has {len(self.paths)} images < batch size "
                f"{self.batch} with drop_last — no batch can be formed")
        done = 0
        while done < steps:
            for xb, yb in self.epoch():
                yield xb, yb
                done += 1
                if done >= steps:
                    return


def synthetic_source(batch, size, steps, seed=0, num_classes=1000):
    """Host-synthetic batches (the no-dataset default)."""
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        x = rng.rand(batch, size, size, 3).astype(np.float32)
        y = rng.randint(0, num_classes, batch).astype(np.int32)
        yield x, y


class DevicePrefetcher:
    """Host→device prefetch: the reference's ``data_prefetcher`` role.

    A producer thread takes each ``(x, y, ...)`` batch of host arrays,
    stages every element in a pinned host buffer (``x`` cast to
    ``cast_dtype`` there, rounding to nearest even as the JAX package's
    host ``astype`` does, so the copy moves the cast bytes), and copies it
    to ``device`` on a side stream with ``non_blocking=True``, recording
    an event after the copies. The consumer's current stream waits on that
    event before it sees the batch, and each device tensor is
    ``record_stream``-ed on it, so the caching allocator never hands the
    memory to the side stream while the step still reads it. A pinned
    buffer is reused only after its copy's event has completed. ``depth``
    batches wait ready on the card. An error in the producer comes out in
    the consumer. On a CPU device the prefetcher only keeps order and
    casts.
    """

    def __init__(self, it, device="cuda", cast_dtype=None, depth: int = 2):
        import torch

        self.device = torch.device(device)
        self.q = queue.Queue(maxsize=max(int(depth), 1))
        self._sentinel = object()
        self._error = None
        cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        slots = [{"bufs": {}, "event": None}
                 for _ in range(max(int(depth), 1) + 1)]

        def host(batch):
            """(tensor, staged dtype) of each element: x in cast_dtype."""
            for j, a in enumerate(batch):
                t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                    np.ascontiguousarray(a))
                yield t, (cast_dtype if j == 0 and cast_dtype is not None
                          else t.dtype)

        def stage(k, batch):
            slot = slots[k % len(slots)]
            if slot["event"] is not None:
                slot["event"].synchronize()      # its last copy is done
            outs = []
            with torch.cuda.stream(self.stream):
                for j, (src, dt) in enumerate(host(batch)):
                    buf = slot["bufs"].get(j)
                    if buf is None or buf.shape != src.shape or \
                            buf.dtype != dt:
                        buf = torch.empty(src.shape, dtype=dt,
                                          pin_memory=True)
                        slot["bufs"][j] = buf
                    buf.copy_(src)               # the cast, on the host
                    outs.append(buf.to(self.device, non_blocking=True))
                ev = torch.cuda.Event()
                ev.record(self.stream)
            slot["event"] = ev
            return tuple(outs), ev

        def work():
            try:
                for k, batch in enumerate(it):
                    if cuda:
                        item = stage(k, batch)
                    else:
                        item = (tuple(t.to(dt) for t, dt in host(batch)),
                                None)
                    self.q.put(item)
            except BaseException as e:          # surface in the consumer
                self._error = e
            finally:
                self.q.put(self._sentinel)

        self.t = threading.Thread(target=work, daemon=True,
                                  name="apex_tpu_torch.data.prefetch")
        self.t.start()

    def __iter__(self):
        import torch

        while True:
            item = self.q.get()
            if item is self._sentinel:
                if self._error is not None:
                    raise self._error
                return
            tensors, ev = item
            if ev is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(ev)
                for t in tensors:
                    t.record_stream(cur)
            yield tensors


def normalize_uint8(x, dtype):
    """uint8 pixels -> [0, 1) in ``dtype`` on their device, as the JAX
    example's ``x.astype(dtype) * (1.0 / 255.0)``: JAX turns the weak
    Python float into ``dtype`` first, so every pixel is
    ``round(x · dtype(1/255))`` — a product of a half-dtype constant, not
    of f32(1/255), whose rounding can land one half ulp away."""
    import torch

    c = torch.tensor(1.0 / 255.0, dtype=dtype, device=x.device)
    return x.to(dtype) * c


def measure_source(src, steps: int = 20) -> float:
    """Loader-only images/sec — the input-bound-vs-compute-bound probe.
    Compare against the model's synthetic-data img/s."""
    import time

    it = iter(src)
    x, _ = next(it)       # warm the pool
    n = 0
    t0 = time.perf_counter()
    for i, (x, _) in enumerate(it):
        n += x.shape[0]
        if i + 1 >= steps:
            break
    dt = time.perf_counter() - t0
    return n / dt if dt > 0 else float("inf")


def make_fake_imagefolder(root: str, n_classes: int = 4,
                          per_class: int = 8, size: int = 256,
                          seed: int = 0) -> str:
    """Write a small synthetic ImageFolder tree of JPEGs: the JAX
    package's ``RandomState(seed)`` pixels, encoded by the port's encoder
    (quality 85, 4:2:0, as PIL's ``save(quality=85)``)."""
    rng = np.random.RandomState(seed)
    for c in range(n_classes):
        d = os.path.join(root, f"class_{c:03d}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            arr = rng.randint(0, 256, (size, size, 3), np.uint8)
            with open(os.path.join(d, f"img_{i:04d}.jpg"), "wb") as f:
                f.write(jpeg.encode(arr, quality=85))
    return root
