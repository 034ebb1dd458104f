"""Async device→host snapshots — the step-path half of a checkpoint.

The port of ``apex_tpu.ckpt.snapshot``. A checkpoint that copies the
training state to the host synchronously stalls the step loop for the
whole transfer; one that merely holds references races the next step,
whose buffers the caching allocator hands back out once the state that
owned them is replaced. This module does neither:

1. **Capture** (:func:`device_snapshot`, on the step path): every device
   leaf is copied into one fresh flat device buffer per dtype by a grouped
   ``torch._foreach_copy_`` on the current (compute) stream, in stream
   order after the step that produced the state, and an event is recorded
   behind the copies. No host sync: the step path pays the copy's launch.
2. **Materialize** (worker thread inside :class:`Snapshotter`): a side
   stream waits on that event and copies each flat buffer into pinned
   host memory, one copy per dtype; the worker waits for the side stream
   only, then drops the device copies (their memory was also marked as
   used by the side stream with ``record_stream``). The finished
   :class:`HostSnapshot` becomes :attr:`Snapshotter.last` — the state an
   escalation persists without touching the (possibly wedged) device.

Double-buffered: at most one capture is in flight. A new capture first
waits for the previous one, so the device holds at most one extra copy of
the tree and the stall stays bounded instead of queueing behind a slow
disk. Pinned host buffers alternate between two pools, so the newest
finished snapshot is never overwritten by the capture after it.

RNG state. The JAX package's typed PRNG keys become ``torch.Generator``
leaves: a snapshot holds ``get_state()`` (a uint8 CPU tensor) and the
manifest tags the path in ``prng_impls`` with :data:`GENERATOR_IMPL`; a
restore ``set_state``s the like-tree's generator.

Paths (:func:`tree_paths`) spell a leaf's position as the JAX package's
``keystr`` does: ``.field`` for a NamedTuple field, ``['key']`` for a dict
key, ``[i]`` for a sequence index; ``None`` holds no leaf.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["HostSnapshot", "ShardChunks", "Snapshotter",
           "device_snapshot", "tree_paths", "map_with_paths",
           "GENERATOR_IMPL"]

#: the ``prng_impls`` tag of a ``torch.Generator`` leaf
GENERATOR_IMPL = "torch.Generator"


class ShardChunks:
    """This process's pieces of a sharded array (a ZeRO slot buffer).

    ``chunks`` is ``[(index, array)]`` where ``index`` is a tuple of
    ``(start, stop)`` pairs per dim into the global ``shape``; the format
    layer writes each chunk with its global index so a restore can gather
    by manifest."""

    __slots__ = ("shape", "dtype", "chunks")

    def __init__(self, shape, dtype, chunks):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype
        self.chunks = list(chunks)


def _key(k) -> str:
    return f"[{k!r}]"


def map_with_paths(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``fn(path, leaf)`` over every leaf, rebuilding dicts, lists, tuples
    and NamedTuples; ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return type(tree)((k, map_with_paths(fn, v, prefix + _key(k)))
                          for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_paths(fn, getattr(tree, f),
                                           f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def tree_paths(tree) -> List[Tuple[str, Any]]:
    """``(path_str, leaf)`` pairs in the tree's own order — the leaf
    addressing shared by capture (here) and the on-disk format."""
    out: List[Tuple[str, Any]] = []
    map_with_paths(lambda p, leaf: out.append((p, leaf)), tree)
    return out


class _Capture:
    """The device half of one snapshot: flat device copies per dtype, the
    event behind them, and where each leaf sits in them."""

    def __init__(self, tree):
        self.keys: Dict[str, str] = {}
        self.slots: Dict[str, Tuple[torch.dtype, int, int, tuple]] = {}
        self.host_leaves: Dict[str, Any] = {}
        self.flat: Dict[Tuple[torch.device, torch.dtype], torch.Tensor] = {}
        self.event = None
        groups: Dict[Tuple[torch.device, torch.dtype], list] = {}
        for path, leaf in tree_paths(tree):
            if isinstance(leaf, torch.Generator):
                self.keys[path] = GENERATOR_IMPL
                self.host_leaves[path] = leaf.get_state().clone()
            elif isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                groups.setdefault((leaf.device, leaf.dtype), []).append(
                    (path, leaf.detach()))
            elif isinstance(leaf, torch.Tensor):
                self.host_leaves[path] = leaf.detach().clone()
            else:
                self.host_leaves[path] = np.array(leaf, copy=True)
        self.structure = tree
        for (dev, dt), items in groups.items():
            total = sum(t.numel() for _, t in items)
            flat = torch.empty(total, dtype=dt, device=dev)
            dsts, srcs, off = [], [], 0
            for path, t in items:
                n = t.numel()
                self.slots[path] = ((dev, dt), off, n, tuple(t.shape))
                dsts.append(flat[off:off + n])
                srcs.append(t.reshape(-1))
                off += n
            # one grouped copy per dtype: fresh buffers for a handful of
            # launches, in stream order after the step's writes
            torch._foreach_copy_(dsts, srcs)
            self.flat[(dev, dt)] = flat
        if self.flat:
            self.event = torch.cuda.Event()
            self.event.record()


def device_snapshot(tree) -> _Capture:
    """Fresh device copies of ``tree``'s CUDA leaves (one flat buffer per
    device and dtype, one grouped copy each, an event recorded behind
    them on the current stream), its generators' states and copies of its
    host leaves. No host sync; the D2H copy is :class:`Snapshotter`'s."""
    return _Capture(tree)


class _PinnedPool:
    """Pinned host buffers by (dtype, length), reused by every other
    capture (the buffers of the newest finished snapshot stay intact)."""

    def __init__(self):
        self.bufs: Dict[Tuple[torch.dtype, int], torch.Tensor] = {}

    def get(self, dtype, n) -> torch.Tensor:
        buf = self.bufs.get((dtype, n))
        if buf is None:
            buf = torch.empty(n, dtype=dtype, pin_memory=True)
            self.bufs[(dtype, n)] = buf
        return buf


def _materialize(cap: _Capture, pool: _PinnedPool):
    """Device copies → CPU tensors (the worker-thread fetch)."""
    host: Dict[Tuple[torch.device, torch.dtype], torch.Tensor] = {}
    if cap.flat:
        dev = next(iter(cap.flat))[0]
        side = torch.cuda.Stream(device=dev)
        with torch.cuda.stream(side):
            side.wait_event(cap.event)
            for key, flat in cap.flat.items():
                dst = pool.get(key[1], flat.numel())
                dst.copy_(flat, non_blocking=True)
                flat.record_stream(side)
                host[key] = dst
        side.synchronize()
    cap.flat = {}                      # the device copies may go now

    def leaf(path, x):
        if path in cap.host_leaves:
            return cap.host_leaves[path]
        key, off, n, shape = cap.slots[path]
        return host[key][off:off + n].view(shape)

    return map_with_paths(leaf, cap.structure)


class HostSnapshot:
    """One fully-materialized host-side snapshot of the training state.

    ``tree`` mirrors the captured tree with CPU tensors (generators as
    their state tensors — ``prng_impls`` names those paths); ``extra`` is
    the host-side side-channel (data cursor, user tags) captured with the
    device state."""

    __slots__ = ("step", "tree", "prng_impls", "extra", "wall_time",
                 "stall_ms", "persist")

    def __init__(self, step: int, tree, prng_impls: Dict[str, str],
                 extra: Optional[Dict[str, Any]], stall_ms: float,
                 persist: bool = True):
        self.step = int(step)
        self.tree = tree
        self.prng_impls = dict(prng_impls)
        self.extra = dict(extra) if extra else {}
        self.wall_time = time.time()
        self.stall_ms = float(stall_ms)
        #: False = capture-only (kept as ``Snapshotter.last`` for an
        #: escalation to persist on demand; nothing written eagerly)
        self.persist = persist


class Snapshotter:
    """Double-buffered async snapshot pipeline.

    ::

        snap = ckpt.Snapshotter()
        for i, batch in enumerate(data):
            state = train_step(state, batch)
            if i % 100 == 0:
                snap.capture(i, state, extra={"cursor": src.state()})
        snap.wait()
        snap.last                                  # newest HostSnapshot

    ``capture`` is the only call on the step path; its wall time is the
    snapshot's step stall (``HostSnapshot.stall_ms``). ``on_ready`` fires
    on the worker thread with each finished snapshot — the
    CheckpointManager's async-write hook.
    """

    def __init__(self, on_ready: Optional[Callable[[HostSnapshot],
                                                   None]] = None):
        self.on_ready = on_ready
        self.last: Optional[HostSnapshot] = None
        #: first error the worker thread hit (materialization OR
        #: on_ready); re-raised by the next capture()/wait() so a dead
        #: snapshot pipeline can never silently stop checkpointing
        self.error: Optional[BaseException] = None
        self._pending: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._pools = (_PinnedPool(), _PinnedPool())
        self._turn = 0

    def capture(self, step: int, tree, *,
                extra: Optional[Dict[str, Any]] = None,
                block: bool = False, persist: bool = True) -> float:
        """Snapshot ``tree``. Returns the step-path stall in milliseconds.
        ``block=True`` waits for the host copy and any ``on_ready`` work
        before returning. ``persist=False`` marks the snapshot
        capture-only — ``on_ready`` consumers that write to disk honor the
        flag (``CheckpointManager.snapshot``)."""
        t0 = time.perf_counter()
        self.wait()                      # double-buffer: one in flight
        cap = device_snapshot(tree)
        stall_ms = (time.perf_counter() - t0) * 1e3
        pool = self._pools[self._turn]
        self._turn ^= 1

        def work():
            try:
                host = _materialize(cap, pool)
                snap = HostSnapshot(step, host, cap.keys, extra, stall_ms,
                                    persist=persist)
                with self._lock:
                    self.last = snap
                if self.on_ready is not None:
                    self.on_ready(snap)
            except BaseException as e:   # surfaced on next capture/wait
                with self._lock:
                    if self.error is None:
                        self.error = e

        t = threading.Thread(target=work, daemon=True,
                             name="apex_tpu_torch.ckpt.snapshot")
        self._pending = t
        t.start()
        if block:
            self.wait()
            stall_ms = (time.perf_counter() - t0) * 1e3
        return stall_ms

    def wait(self, timeout: Optional[float] = None) -> None:
        """Drain the in-flight materialization (no-op when idle);
        re-raises any error the worker hit."""
        t = self._pending
        if t is not None and t.is_alive():
            t.join(timeout)
        if t is not None and not t.is_alive():
            self._pending = None
        self.raise_pending()

    def raise_pending(self) -> None:
        with self._lock:
            err, self.error = self.error, None
        if err is not None:
            raise err
