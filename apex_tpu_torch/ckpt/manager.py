"""CheckpointManager: the save/restore orchestrator.

The port of ``apex_tpu.ckpt.manager``. Glues the three layers together —
async capture (:mod:`.snapshot`), the crash-safe one-file-per-process
format (:mod:`.format`) and elastic ZeRO re-partitioning (:mod:`.elastic`)
— and emits the ``ckpt`` events to ``event_sink``.

::

    mgr = ckpt.CheckpointManager("ckpts", keep=2)
    for i, batch in enumerate(batches):
        state = train_step(state, batch)
        if i % save_every == 0:
            mgr.save(i, {"amp": state, "gen": step.generator},
                     params=params0, extra={"cursor": source.state()})
    mgr.wait()

    # resume — on any world size for ZeRO state:
    like = {"amp": fresh_state, "gen": fresh_generator}
    tree, manifest = mgr.restore(like)
    cursor = manifest["extra"]["cursor"]

``save`` costs the step path the grouped device copy's launches (the
``stall_ms`` of the event); the device→host copy, serialization, hashing
and the temp-then-rename commit all happen on the snapshot worker thread.
``save_last_snapshot`` is the escalation entry point: it durably writes
the newest already-fetched host snapshot without touching the (possibly
wedged) device — see :class:`apex_tpu_torch.ckpt.EscalationPolicy`.

ZeRO state: a rank's ``ShardedOptState`` slot buffers are its shards;
each is written as the chunk ``[r · per, (r + 1) · per)`` of the global
buffer, ``r`` the process rank over a data axis of all the processes. A
restore gathers the global buffer, re-partitions it to the process count
and takes this rank's shard.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.ckpt import elastic as _elastic
from apex_tpu_torch.ckpt import format as _format
from apex_tpu_torch.ckpt.format import CheckpointError
from apex_tpu_torch.ckpt.snapshot import (GENERATOR_IMPL, HostSnapshot,
                                          ShardChunks, Snapshotter,
                                          map_with_paths, tree_paths)
from apex_tpu_torch.utils.ranks import rank_default, world_default

__all__ = ["CheckpointManager"]


class CheckpointManager:
    """See the module docstring.

    ``event_sink`` is any callable taking one JSON-able dict; ``keep``
    bounds retention (rank 0 deletes older committed checkpoints after
    each commit); ``meta`` statics land in every manifest.

    ``fence`` (any object with ``generation`` + ``check(what, *, path,
    step)``, duck-typed as in the JAX package) generation-fences every
    mutation: data-file writes, the manifest commit and retention deletes
    all validate the fence token first, so a zombie of a previous
    incarnation is refused instead of corrupting its successor's
    checkpoints. ``rank``/``process_count`` override the
    ``torch.distributed`` defaults (a per-rank local checkpoint tree passes
    ``rank=0, process_count=1``); they also place ZeRO shards.
    """

    def __init__(self, root: str, *, keep: int = 2,
                 event_sink: Optional[Callable[[Dict], None]] = None,
                 meta: Optional[Dict] = None,
                 barrier_timeout_s: float = 120.0,
                 fence=None,
                 rank: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.root = root
        self.keep = int(keep)
        self.event_sink = event_sink
        self.meta = dict(meta or {})
        self.barrier_timeout_s = float(barrier_timeout_s)
        self.fence = fence
        self.rank = rank_default() if rank is None else int(rank)
        self.process_count = (world_default() if process_count is None
                              else int(process_count))
        self._snap = Snapshotter(on_ready=self._write_snapshot)
        self._pending_zero: Dict[str, int] = {}
        self._last_committed: Optional[str] = None
        self.error: Optional[BaseException] = None
        # serializes _write between the snapshot worker and an
        # escalation thread — two writers racing on the same step dir
        # would interleave bytes under one manifest hash
        self._write_lock = threading.Lock()
        # the arena plan behind zero_layout is static for fixed params
        # names, shapes and dtypes: cache it by those (never by the params
        # tree itself, which would keep a replaced tree's tensors on the
        # device) so a per-step snapshot() never re-plans
        self._zero_cache: Optional[Tuple[tuple, Dict[str, int]]] = None

    # -- events ----------------------------------------------------------------

    def _emit(self, event: Dict) -> None:
        if self.event_sink is None:
            return
        try:
            ev = _format.tag_generation(
                dict(event, rank=self.rank, wall_time=time.time()),
                self.fence)
            self.event_sink(ev)
        except Exception:
            pass                  # telemetry must never break a save

    # -- save ------------------------------------------------------------------

    def save(self, step: int, tree, *, params: Any = None,
             zero: Optional[Dict[str, int]] = None,
             extra: Optional[Dict] = None,
             block: bool = False) -> float:
        """Snapshot + asynchronously persist the training state.

        ``params`` (the tree a ZeRO optimizer was initialized from) lets
        the manager record each slot buffer's logical length for elastic
        restore; ``zero=`` gives the map directly. Returns the step-path
        stall in ms (full duration when ``block=True``). Raises any error
        a previous async write hit."""
        self.raise_pending()
        self._snap.wait()              # the write in flight keeps its map
        self._pending_zero = self._layout_for(tree, params, zero)
        return self._snap.capture(step, tree, extra=extra, block=block)

    def snapshot(self, step: int, tree, *, params: Any = None,
                 zero: Optional[Dict[str, int]] = None,
                 extra: Optional[Dict] = None) -> float:
        """Capture WITHOUT committing: refresh the host-side snapshot (what
        an escalation persists) at step cadence while disk commits run at
        a coarser ``save`` cadence. Returns the stall in ms."""
        self.raise_pending()
        self._snap.wait()
        self._pending_zero = self._layout_for(tree, params, zero)
        return self._snap.capture(step, tree, extra=extra, persist=False)

    def _layout_for(self, tree, params, zero) -> Dict[str, int]:
        if zero is not None:
            return dict(zero)
        nodes = tuple(p for p, _ in _elastic._zero_nodes(tree))
        if not nodes:
            return {}
        key = (nodes, tuple(
            (p, tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor)
            else (p, type(x)) for p, x in tree_paths(params)))
        if self._zero_cache is not None and self._zero_cache[0] == key:
            return self._zero_cache[1]
        layout = _elastic.zero_layout(tree, params=params)
        self._zero_cache = (key, layout)
        return layout

    def _shard(self, leaf: torch.Tensor) -> ShardChunks:
        """This rank's ZeRO shard as its chunk of the global buffer."""
        per = int(leaf.shape[0])
        r = self.rank
        return ShardChunks((per * self.process_count,), leaf.dtype,
                           [(((r * per, (r + 1) * per),), leaf)])

    def _write_snapshot(self, snap: HostSnapshot) -> None:
        if not snap.persist:
            return                 # capture-only (snapshot() cadence)
        try:
            self._write(snap, wait_for_ranks=True)
        except BaseException as e:     # surfaced on the next save/wait
            self.error = e

    def _write(self, snap: HostSnapshot, *, wait_for_ranks: bool,
               reason: str = "periodic",
               lock_timeout_s: Optional[float] = None) -> Optional[str]:
        t0 = time.perf_counter()
        # serialize writers; the escalation path bounds its wait (a worker
        # wedged on the multi-rank commit barrier will not come back)
        acquired = self._write_lock.acquire(
            timeout=lock_timeout_s if lock_timeout_s is not None
            else -1)
        if not acquired:
            return None
        zero = self._pending_zero
        try:
            d = _format.step_dir(self.root, snap.step)
            if os.path.exists(os.path.join(d, _format.MANIFEST)):
                return d           # this step already committed
            leaves = [(p, self._shard(leaf) if p in zero else leaf)
                      for p, leaf in tree_paths(snap.tree)]
            rec = _format.write_process_file(d, self.rank, leaves,
                                             fence=self.fence)
            if self.rank == 0:
                _format.commit_manifest(
                    d, step=snap.step,
                    process_count=self.process_count,
                    meta=dict(self.meta, reason=reason),
                    zero=zero, extra=snap.extra,
                    prng_impls=snap.prng_impls,
                    wait_for_ranks=wait_for_ranks,
                    barrier_timeout_s=self.barrier_timeout_s,
                    fence=self.fence)
                self._last_committed = d
                # retention runs only after COOPERATIVE commits: a
                # lone-rank escalation manifest may cover only this
                # rank's leaves, and must not gc its own fallback
                if self.keep > 0 and wait_for_ranks:
                    _format.gc_checkpoints(self.root, self.keep,
                                           fence=self.fence)
        finally:
            self._write_lock.release()
        self._emit({
            "kind": "ckpt_save", "step": snap.step, "path": d,
            "reason": reason, "bytes": int(rec.get("bytes", 0)),
            "n_arrays": len(rec.get("arrays", [])),
            "stall_ms": round(snap.stall_ms, 3),
            "dur_ms": round((time.perf_counter() - t0) * 1e3, 3),
        })
        if (self.rank != 0 and not wait_for_ranks
                and not os.path.exists(os.path.join(d,
                                                    _format.MANIFEST))):
            # a lone-rank escalation on a non-zero rank: nothing will
            # ever commit its manifest
            return None
        return d

    def save_last_snapshot(self, reason: str = "escalation"
                           ) -> Optional[str]:
        """Durably persist the newest fetched host snapshot — the
        escalation path. Never touches the device and never waits for
        peer ranks; the manifest commits with whatever files exist, and
        restore's coverage check decides usability. Returns the
        checkpoint dir, or None when no snapshot ever finished."""
        snap = self._snap.last
        if snap is None:
            return None
        try:
            return self._write(snap, wait_for_ranks=False,
                               reason=reason, lock_timeout_s=15.0)
        except BaseException:
            return None

    def wait(self) -> None:
        """Drain the in-flight snapshot + write; raise its error."""
        self._snap.wait()
        self.raise_pending()

    def raise_pending(self) -> None:
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    @property
    def last_host_snapshot(self) -> Optional[HostSnapshot]:
        return self._snap.last

    # -- discovery -------------------------------------------------------------

    def latest(self) -> Optional[str]:
        return _format.latest_checkpoint(self.root)

    def all_steps(self):
        return _format.committed_steps(self.root)

    # -- restore ---------------------------------------------------------------

    def restore(self, like, *, ckpt_dir: Optional[str] = None,
                verify: bool = True,
                io_deadline_s: float = 30.0) -> Tuple[Any, Dict]:
        """Load the newest committed checkpoint into the structure (and
        onto the devices) of ``like``.

        ``like`` is a freshly-initialized state tree: its shapes, dtypes,
        devices and memory formats define where every leaf lands; a
        ``torch.Generator`` leaf gets the saved state (``set_state``, in
        place). ZeRO slot buffers (named in the manifest's ``zero`` map)
        are gathered, truncated to their logical length, re-padded to the
        process count and cut to this rank's shard.
        Returns ``(tree, manifest)``; the data cursor and any other
        save-time ``extra`` ride in ``manifest["extra"]``."""
        t0 = time.perf_counter()
        d = ckpt_dir or self.latest()
        if d is None:
            raise CheckpointError(
                f"no committed checkpoint under {self.root!r} — nothing "
                f"to restore (a crash before the first commit leaves "
                f"only partial step_* dirs, which are not checkpoints)")
        want = [p for p, _ in tree_paths(like)]
        with _format.checkpoint_in_use(d, self.rank):
            manifest = _format.read_manifest(d)
            loaded = _format.assemble_arrays(d, manifest, paths=want,
                                             verify=verify,
                                             io_deadline_s=io_deadline_s)
        zero = manifest.get("zero", {})
        impls = manifest.get("prng_impls", {})
        resharded = [0]

        def leaf(pstr, like_leaf):
            val = loaded[pstr]
            if isinstance(like_leaf, torch.Generator):
                if impls.get(pstr) != GENERATOR_IMPL:
                    raise CheckpointError(
                        f"{pstr} is a torch.Generator here but the "
                        f"checkpoint holds {impls.get(pstr) or 'an array'}")
                like_leaf.set_state(val.to(torch.uint8))
                return like_leaf
            shape = tuple(np.shape(like_leaf))
            if pstr in zero:
                if len(shape) != 1:
                    raise CheckpointError(
                        f"{pstr} is recorded as a ZeRO slot buffer but "
                        f"the like leaf is not 1-D ({shape})")
                per = shape[0]
                full = _elastic.repartition_flat(
                    val, int(zero[pstr]), per * self.process_count)
                if full.shape[0] != val.shape[0]:
                    resharded[0] += 1
                val = full[self.rank * per:(self.rank + 1) * per]
            elif tuple(val.shape) != shape:
                raise CheckpointError(
                    f"shape mismatch for {pstr}: checkpoint has "
                    f"{tuple(val.shape)}, target expects {shape} — only "
                    f"ZeRO slot buffers reshape across worlds; did the "
                    f"model change?")
            if isinstance(like_leaf, torch.Tensor):
                if val.dtype != like_leaf.dtype:
                    raise CheckpointError(
                        f"dtype mismatch for {pstr}: checkpoint "
                        f"{val.dtype}, target {like_leaf.dtype}")
                return torch.empty_like(like_leaf).copy_(val)
            if isinstance(like_leaf, np.ndarray):
                return val.numpy().astype(like_leaf.dtype, copy=False)
            return type(like_leaf)(val.item())

        tree = map_with_paths(leaf, like)
        self._emit({
            "kind": "ckpt_restore", "step": int(manifest["step"]),
            "path": d, "n_arrays": len(want),
            "resharded": resharded[0],
            "from_processes": int(manifest.get("process_count", 1)),
            "dur_ms": round((time.perf_counter() - t0) * 1e3, 3),
        })
        return tree, manifest
