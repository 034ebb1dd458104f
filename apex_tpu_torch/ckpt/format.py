"""Durable sharded checkpoint format: one file per process + a manifest.

The port of ``apex_tpu.ckpt.format``, file for file: a checkpoint written
by either package loads in the other. The commit protocol (veScale-style
save-where-it-lives, crash-safe like a WAL):

1. every process writes ``proc{rank:05d}.npz`` to a ``*.tmp`` path,
   fsyncs, then renames — a crash mid-write leaves only a ``.tmp``
   orphan;
2. each process then writes ``proc{rank:05d}.files.json`` (content
   hash + per-array chunk metadata) the same way — the data file is
   now durable and described;
3. rank 0 waits for every rank's files.json (shared-filesystem
   barrier), then writes ``manifest.json`` **last** — again
   temp-then-rename.

``manifest.json`` IS the commit record: a checkpoint directory without
one does not exist as far as :func:`latest_checkpoint` is concerned, so
a crash at ANY point of a save leaves the previous committed checkpoint
untouched and loadable.

Arrays are addressed by path string (``snapshot.tree_paths``: the JAX
package's ``keystr`` spelling) and stored as **chunks**: a replicated
leaf is one whole-array chunk written by rank 0; a ZeRO shard is this
rank's slice of the global buffer with its index. Restore gathers chunks
by manifest (any file layout → the full logical array).

Extension dtypes. ``npz`` cannot name bfloat16 or fp8: the JAX package
writes them as raw void records and restores them from the manifest's
``"dtype"``. The port writes their bits as ``uint16``/``uint8`` under
the same dtype name (the JAX reader's itemsize-matched ``.view`` takes
them back) and reads either spelling through :data:`EXT_DTYPES`, with no
``ml_dtypes``.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import signal
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["write_process_file", "commit_manifest", "read_manifest",
           "assemble_arrays", "latest_checkpoint", "committed_steps",
           "gc_checkpoints", "step_dir", "MANIFEST", "CheckpointError",
           "checkpoint_in_use", "checkpoint_is_in_use", "INUSE_PREFIX",
           "EXT_DTYPES", "host_array", "to_tensor", "FORMAT_VERSION"]

MANIFEST = "manifest.json"
FORMAT_VERSION = 1
#: in-use marker files (``inuse.rank00000.12345.json``): a restore in
#: progress pins its directory against a concurrent ``gc_checkpoints``
#: on another rank — see :func:`checkpoint_in_use`
INUSE_PREFIX = "inuse."

#: test hook: crash the process (SIGKILL — no handlers, no atexit) at a
#: named point of the save. Points: "before_data_rename" (data tmp
#: written, not committed), "before_manifest" (data committed, manifest
#: not). Used by the crash-consistency tests to prove every crash point
#: leaves the previous checkpoint loadable.
_CRASH_ENV = "APEX_TPU_TORCH_CKPT_TEST_CRASH"

#: dtypes numpy cannot name without ``ml_dtypes``: manifest name ->
#: (torch dtype, the same-width integer the bits are stored and read as)
EXT_DTYPES = {
    "bfloat16": (torch.bfloat16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8),
}
_EXT_BY_TORCH = {t: (name, bits) for name, (t, bits) in EXT_DTYPES.items()}
_TORCH_BITS = {np.uint16: torch.int16, np.uint8: torch.uint8}


class CheckpointError(RuntimeError):
    """A checkpoint could not be written or read consistently."""


# shared-filesystem polls (the rank barrier, manifest reads, restore
# gathers) MUST NOT poll in lockstep: N ranks hammering one metadata
# server at a fixed 50 ms phase is exactly the thundering herd that
# turns a slow NFS into a stalled commit — hence the de-phased,
# seed-independent jittered backoff (see apex_tpu_torch/utils/backoff.py)
from apex_tpu_torch.utils.backoff import backoff_sleep as _backoff_sleep
from apex_tpu_torch.utils.fsio import write_atomic


def host_array(leaf) -> Tuple[np.ndarray, str]:
    """``(numpy array, manifest dtype name)`` of one host leaf: a CPU
    tensor (an extension dtype as its integer bits under its JAX name),
    a numpy array or a Python scalar."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        ext = _EXT_BY_TORCH.get(t.dtype)
        if ext is not None:
            name, bits = ext
            return t.view(_TORCH_BITS[bits]).numpy().view(bits), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """The CPU tensor of a stored array under its manifest dtype name (the
    inverse of :func:`host_array`; raw void records and integer bits both
    read back for an extension dtype)."""
    ext = EXT_DTYPES.get(dtype_name)
    if ext is None:
        want = np.dtype(dtype_name)
        if arr.dtype != want:
            if arr.dtype.itemsize != want.itemsize:
                raise CheckpointError(
                    f"stored dtype {arr.dtype} cannot reinterpret as "
                    f"recorded {want}")
            arr = arr.view(want)
        return torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))
    tdt, bits = ext
    if arr.dtype.itemsize != np.dtype(bits).itemsize:
        raise CheckpointError(f"stored dtype {arr.dtype} cannot reinterpret "
                              f"as recorded {dtype_name}")
    arr = np.ascontiguousarray(arr).reshape(arr.shape).view(bits)
    return torch.from_numpy(arr).view(_TORCH_BITS[bits]).view(tdt)


def _test_crash(point: str) -> None:
    if os.environ.get(_CRASH_ENV) == point:
        os.kill(os.getpid(), signal.SIGKILL)


def _check_fence(fence, what: str, *, path: Optional[str] = None,
                 step: Optional[int] = None) -> None:
    """Validate a generation fence token before mutating shared state.

    ``fence`` is any object with ``check(what, *, path, step)`` —
    in practice a cluster-membership object. The
    check re-reads the cluster's COMMITTED generation and raises
    ``StaleGenerationError`` (after emitting the ``cluster_fence``
    refusal event) when this process's token is stale — the zombie
    fence: a rank resumed from a pause/preemption must not write into
    a checkpoint tree a newer generation already owns. ``fence=None``
    keeps the whole path unconditional (single-incarnation runs)."""
    if fence is not None:
        fence.check(what, path=path, step=step)


def tag_generation(event: Dict, fence) -> Dict:
    """Stamp the fence token on a checkpoint-layer event (in place) —
    the forensic half of generation fencing: a refused zombie's
    save/escalation record names the stale epoch it acted FROM. One
    helper so every emitter (CheckpointManager, EscalationPolicy)
    tags identically and a change to the contract lands once."""
    if fence is not None and "generation" not in event:
        event["generation"] = int(getattr(fence, "generation", 0))
    return event


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{int(step):08d}")


def _write_atomic(path: str, data: bytes, crash_point: str = "") -> None:
    """temp → fsync → rename; durable against crash at any instant."""
    write_atomic(path, data,
                 before_rename=((lambda: _test_crash(crash_point))
                                if crash_point else None))


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# --- chunk extraction ---------------------------------------------------------

def _chunks_of(leaf, rank: int) -> Optional[List[Tuple[Optional[List],
                                                       np.ndarray]]]:
    """This process's chunks of one leaf: ``[(index, array), ...]``.

    ``index`` is ``None`` for a whole-array chunk, else
    ``[[start, stop], ...]`` per dim. Whole-array chunks are written by
    rank 0 only (replicated leaves exist everywhere; N identical copies
    on disk would be waste, and restore dedupes by index anyway).
    Returns None when this rank has nothing to write for the leaf.
    """
    from apex_tpu_torch.ckpt.snapshot import ShardChunks  # circular: late

    if isinstance(leaf, ShardChunks):
        out = []
        for idx, arr in leaf.chunks:
            whole = all(a == 0 and b == d
                        for (a, b), d in zip(idx, leaf.shape))
            if whole:
                if rank == 0:
                    out.append((None, arr))
            else:
                out.append(([list(p) for p in idx], arr))
        return out or None
    if rank != 0:
        return None              # plain host array == replicated
    return [(None, leaf)]


def write_process_file(ckpt_dir: str, rank: int,
                       leaves: Sequence[Tuple[str, Any]], *,
                       fence=None) -> Dict:
    """Write this process's data file + its files.json piece.

    ``leaves`` is ``[(path_str, leaf)]`` where a leaf is a CPU tensor, a
    numpy array, a scalar, or a
    :class:`~apex_tpu_torch.ckpt.snapshot.ShardChunks`. Returns
    the files.json record (also written to disk, atomically, after the
    data file commits). ``fence`` refuses the write when this process's
    generation token is stale — checked BEFORE the first byte lands: a
    zombie overwriting ``proc{rank}.npz`` under an already-committed
    manifest would otherwise break that manifest's content hash.
    """
    _check_fence(fence, "write", path=ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    fname = f"proc{rank:05d}.npz"
    arrays: List[Dict] = []
    payload: Dict[str, np.ndarray] = {}
    key_i = 0
    for path, leaf in leaves:
        chunks = _chunks_of(leaf, rank)
        if not chunks:
            continue
        for idx, arr in chunks:
            arr, dtype_name = host_array(arr)
            key = f"a{key_i:05d}"
            key_i += 1
            payload[key] = arr
            # global shape: the chunk's own shape for whole-array
            # chunks; recorded so assembly can allocate without a like
            gshape = (list(arr.shape) if idx is None
                      else [d for d in _global_shape_of(leaf)])
            arrays.append({
                "path": path, "key": key, "index": idx,
                "shape": list(arr.shape), "dtype": dtype_name,
                "global_shape": gshape,
            })
    buf = io.BytesIO()
    np.savez(buf, **payload)
    data = buf.getvalue()
    _write_atomic(os.path.join(ckpt_dir, fname), data,
                  crash_point="before_data_rename")
    record = {"rank": rank, "file": fname, "sha256": _sha256(data),
              "bytes": len(data), "arrays": arrays}
    _write_atomic(os.path.join(ckpt_dir, f"proc{rank:05d}.files.json"),
                  json.dumps(record).encode())
    return record


def _global_shape_of(leaf):
    from apex_tpu_torch.ckpt.snapshot import ShardChunks
    if isinstance(leaf, ShardChunks):
        return leaf.shape
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
        else np.asarray(leaf).shape


# --- commit -------------------------------------------------------------------

def commit_manifest(ckpt_dir: str, *, step: int, process_count: int,
                    meta: Optional[Dict] = None,
                    zero: Optional[Dict[str, int]] = None,
                    extra: Optional[Dict] = None,
                    prng_impls: Optional[Dict[str, str]] = None,
                    wait_for_ranks: bool = True,
                    barrier_timeout_s: float = 120.0,
                    fence=None,
                    generation: Optional[int] = None) -> str:
    """Rank 0's commit: gather every rank's files.json, write the
    manifest LAST. ``wait_for_ranks=False`` (the escalation path — dead
    peers will never write theirs) commits with whatever files exist;
    restore's coverage check decides whether the result is usable.

    ``fence`` re-validates the generation token immediately before the
    manifest rename (the commit point — a zombie that passed the write
    fence but was lapped during the rank barrier is still refused
    here); ``generation`` (defaulting to ``fence.generation``) is
    recorded in the manifest, so every committed checkpoint names the
    epoch that produced it.
    """
    deadline = time.monotonic() + barrier_timeout_s
    if generation is None and fence is not None:
        generation = int(getattr(fence, "generation", 0))
    files: List[Dict] = []
    attempt = 0
    while True:
        files = []
        missing = []
        for r in range(process_count):
            p = os.path.join(ckpt_dir, f"proc{r:05d}.files.json")
            if os.path.exists(p):
                with open(p) as f:
                    files.append(json.load(f))
            else:
                missing.append(r)
        if not missing or not wait_for_ranks:
            break
        if time.monotonic() > deadline:
            raise CheckpointError(
                f"checkpoint barrier timed out after {barrier_timeout_s}s"
                f" waiting for ranks {missing} (have "
                f"{sorted(f['rank'] for f in files)}) under {ckpt_dir} "
                f"— NOT committing (the previous checkpoint stays the "
                f"latest); the named ranks never wrote their files.json "
                f"(dead, preempted, or a shared-fs visibility lag "
                f"longer than the timeout)")
        # jittered exponential poll: fast while peers are mid-write,
        # backed off once something is clearly slow — and never in
        # phase across waiters. Cap 0.2 s: a blocking save's commit
        # barrier can sit on the MAIN thread (save(block=True)) where
        # every extra poll latency is step-heartbeat latency a
        # HangWatchdog with a tight deadline would misread as a stall
        _backoff_sleep(attempt, cap_s=0.2)
        attempt += 1
    manifest = {
        "format": FORMAT_VERSION, "step": int(step),
        "wall_time": time.time(), "process_count": int(process_count),
        "n_files": len(files),
        "complete_barrier": len(files) == process_count,
        "generation": (int(generation) if generation is not None
                       else None),
        "meta": dict(meta or {}),
        "zero": dict(zero or {}),
        "extra": dict(extra or {}),
        "prng_impls": dict(prng_impls or {}),
        "files": files,
    }
    # the fence is re-validated at the COMMIT POINT, after the (possibly
    # long) rank barrier: a generation bump that landed while this rank
    # waited means the cluster moved on — committing now would publish
    # a stale epoch's state as the newest checkpoint
    _check_fence(fence, "commit", path=ckpt_dir, step=int(step))
    path = os.path.join(ckpt_dir, MANIFEST)
    _write_atomic(path, json.dumps(manifest, indent=1).encode(),
                  crash_point="before_manifest")
    return path


# --- read side ----------------------------------------------------------------

def read_manifest(ckpt_dir: str, *, attempts: int = 3) -> Dict:
    """Read the commit record, retrying transient shared-fs failures.

    A manifest is written atomically (temp → fsync → rename), but on a
    networked filesystem a reader racing the rename — or a brief NFS
    staleness window — can see ENOENT/EIO/short-read for a file that is
    durably there. Bounded jittered retries absorb that; a manifest
    still unreadable after ``attempts`` is genuinely absent or broken.
    """
    path = os.path.join(ckpt_dir, MANIFEST)
    last: Optional[Exception] = None
    for k in range(max(int(attempts), 1)):
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            last = e
            if k + 1 < attempts:
                _backoff_sleep(k, base_s=0.05)
    raise CheckpointError(f"no committed checkpoint at {ckpt_dir}: "
                          f"{last} (after {attempts} attempts)") from last


def _read_file_deadline(fpath: str, deadline_s: float) -> bytes:
    """Read a checkpoint data file with jittered retries under one
    overall deadline — the timeout on the elastic-restore *gather*: a
    multi-rank restore pulling dozens of shard files over a shared fs
    must degrade to an actionable refusal naming the file, never hang
    a whole relaunch on one stuck read."""
    t0 = time.monotonic()
    attempt = 0
    not_found = 0
    last: Optional[Exception] = None
    while True:
        try:
            with open(fpath, "rb") as f:
                return f.read()
        except FileNotFoundError as e:
            # absence is retried only briefly (rename-visibility lag);
            # a file still absent after that is deleted/never-written —
            # fail fast with the actionable "missing" message instead
            # of burning the whole gather deadline on it
            last = e
            not_found += 1
            if not_found >= 3:
                raise CheckpointError(
                    f"checkpoint data file missing: {fpath} ({e})"
                ) from e
        except OSError as e:
            last = e
        if time.monotonic() - t0 >= deadline_s:
            raise CheckpointError(
                f"checkpoint data file unreadable within "
                f"{deadline_s:.0f}s: {fpath} ({last}) — the restore "
                f"gather timed out; restore from another checkpoint or "
                f"raise io_deadline_s if the filesystem is just slow"
            ) from last
        _backoff_sleep(attempt, base_s=0.05)
        attempt += 1


def _stored_bits(arr: np.ndarray, dtype_name: str) -> np.ndarray:
    """A stored chunk in a numpy dtype that holds it exactly: its recorded
    dtype, or for an extension dtype its integer bits."""
    ext = EXT_DTYPES.get(dtype_name)
    want = np.dtype(ext[1] if ext is not None else dtype_name)
    if arr.dtype != want:
        # npz round-trips extension dtypes as raw void records (the JAX
        # package's files) or as their integer bits (the port's)
        if arr.dtype.itemsize != want.itemsize:
            raise CheckpointError(f"stored dtype {arr.dtype} cannot "
                                  f"reinterpret as recorded {dtype_name}")
        arr = arr.view(want)
    return arr


def assemble_arrays(ckpt_dir: str, manifest: Dict, *,
                    paths: Optional[Sequence[str]] = None,
                    verify: bool = True,
                    io_deadline_s: float = 30.0) -> Dict[str, torch.Tensor]:
    """Gather-by-manifest: read every referenced data file and assemble
    each leaf's full logical array from its chunks, as a CPU tensor.

    ``paths`` restricts assembly (restore only pulls what the like-tree
    needs); ``verify`` checks each data file's sha256 against the
    manifest before trusting it; ``io_deadline_s`` bounds each file
    read (transient shared-fs errors are retried with jittered backoff
    inside the deadline). Raises :class:`CheckpointError` on a hash
    mismatch, a read timeout, or a leaf whose chunks do not cover the
    full array (e.g. a lone-rank escalation save of ZeRO-sharded state
    — the actionable message names the uncovered leaf).
    """
    want = set(paths) if paths is not None else None
    loaded: Dict[str, torch.Tensor] = {}
    per_path: Dict[str, List[Tuple[Optional[Tuple], np.ndarray,
                                   List[int], str]]] = {}
    for frec in manifest.get("files", []):
        if want is not None and not any(a["path"] in want
                                        for a in frec["arrays"]):
            continue
        fpath = os.path.join(ckpt_dir, frec["file"])
        data = _read_file_deadline(fpath, io_deadline_s)
        if verify and _sha256(data) != frec["sha256"]:
            raise CheckpointError(
                f"content hash mismatch for {fpath} — the file does not "
                f"match the committed manifest (corruption or a mixed-up "
                f"directory); refusing to load")
        try:
            npz = np.load(io.BytesIO(data))
        except (OSError, ValueError) as e:
            raise CheckpointError(f"unreadable data file {fpath}: {e}") \
                from e
        for arec in frec["arrays"]:
            p = arec["path"]
            if want is not None and p not in want:
                continue
            idx = (None if arec["index"] is None else
                   tuple(tuple(pair) for pair in arec["index"]))
            arr = _stored_bits(npz[arec["key"]], arec["dtype"])
            per_path.setdefault(p, []).append(
                (idx, arr, arec["global_shape"], arec["dtype"]))
    for p, chunks in per_path.items():
        # dedupe identical indices (replicated shards saved by several
        # ranks); distinct addressable shards of one array never overlap
        seen = {}
        for idx, arr, gshape, dt in chunks:
            seen.setdefault(idx, (arr, gshape, dt))
        whole = seen.pop(None, None)
        if whole is not None:
            loaded[p] = to_tensor(whole[0], whole[2])  # whole copy wins
            continue
        gshape = tuple(next(iter(seen.values()))[1])
        dt = next(iter(seen.values()))[2]
        out = np.zeros(gshape, dtype=next(iter(seen.values()))[0].dtype)
        covered = 0
        for idx, (arr, _, _) in seen.items():
            sl = tuple(slice(a, b) for a, b in idx)
            out[sl] = arr
            covered += int(np.prod([b - a for a, b in idx]))
        total = int(np.prod(gshape)) if gshape else 1
        if covered < total:
            raise CheckpointError(
                f"leaf {p!r} is only partially covered by the saved "
                f"chunks ({covered}/{total} elements) — this manifest "
                f"was committed without all ranks (a lone-rank "
                f"escalation save of sharded state); restore from the "
                f"previous fully-committed checkpoint instead")
        loaded[p] = to_tensor(out, dt)
    if want is not None:
        missing = want - set(loaded)
        if missing:
            raise CheckpointError(
                "checkpoint is missing required leaves: "
                + ", ".join(sorted(missing)[:8])
                + (" …" if len(missing) > 8 else "")
                + " — was it saved from a state with a different "
                  "structure?")
    return loaded


# --- discovery / retention ----------------------------------------------------

def committed_steps(root: str) -> List[int]:
    """Steps with a committed (manifest-bearing) checkpoint, ascending."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        if not name.startswith("step_"):
            continue
        if os.path.exists(os.path.join(root, name, MANIFEST)):
            try:
                out.append(int(name[len("step_"):]))
            except ValueError:
                continue
    return sorted(out)


def latest_checkpoint(root: str) -> Optional[str]:
    """Newest committed checkpoint directory under ``root`` (None when
    nothing has ever committed). Partial directories — a crash mid-save
    — have no manifest and are invisible here by construction."""
    steps = committed_steps(root)
    return step_dir(root, steps[-1]) if steps else None


@contextmanager
def checkpoint_in_use(ckpt_dir: str, rank: int = 0, *,
                      refresh_s: float = 60.0):
    """Pin a checkpoint directory against concurrent retention.

    ``gc_checkpoints(keep=N)`` on one rank can race a ``restore`` on
    another and delete the directory mid-read — the reader then fails
    its gather (or worse, its hash check) on a checkpoint that was
    committed and healthy. A restore wraps its gather in this context
    manager: it drops an ``inuse.rank{r}.{pid}.json`` marker
    (atomically) that :func:`gc_checkpoints` honors, and removes it on
    exit. The marker is advisory and TTL'd (``gc``'s ``inuse_ttl_s``)
    so a reader that died mid-restore cannot pin a directory forever —
    a LIVE reader re-stamps it every ``refresh_s`` (<< the ttl) on a
    daemon thread, so a legitimately slow gather on a degraded fs
    stays pinned however long it runs. A marker write that fails must
    never block the restore itself (``refresh_s=0`` disables the
    refresher).
    """
    path = os.path.join(
        ckpt_dir, f"{INUSE_PREFIX}rank{int(rank):05d}.{os.getpid()}.json")

    def _stamp() -> None:
        _write_atomic(path, json.dumps(
            {"rank": int(rank), "pid": os.getpid(),
             "wall_time": time.time()}).encode())

    try:
        _stamp()
    except OSError:
        path = None
    stop = thread = None
    if path is not None and refresh_s > 0:
        stop = threading.Event()

        def _refresh() -> None:
            while not stop.wait(refresh_s):
                try:
                    _stamp()
                except OSError:
                    pass       # a lost re-stamp falls back to the ttl
                if stop.is_set():
                    # the owner may have removed the marker while our
                    # stamp was in flight on a stalled fs — a re-stamp
                    # landing AFTER that removal would pin a finished
                    # restore's directory against gc for a full ttl
                    try:
                        os.remove(path)
                    except OSError:
                        pass
        thread = threading.Thread(target=_refresh,
                                  name="apex_tpu_torch.ckpt.inuse",
                                  daemon=True)
        thread.start()
    try:
        yield
    finally:
        if stop is not None:
            stop.set()
            thread.join(timeout=1.0)
        if path is not None:
            try:
                os.remove(path)
            except OSError:
                pass


def checkpoint_is_in_use(ckpt_dir: str, *,
                         ttl_s: float = 300.0) -> bool:
    """True when the directory carries a live in-use marker (younger
    than ``ttl_s``). A torn/unreadable marker counts as live — it is
    probably a reader racing its own marker write, and skipping one gc
    round is cheaper than deleting under a reader."""
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return False
    now = time.time()
    for name in names:
        if not (name.startswith(INUSE_PREFIX)
                and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(ckpt_dir, name)) as f:
                rec = json.load(f)
            if now - float(rec.get("wall_time", 0)) < ttl_s:
                return True
        except (OSError, ValueError, TypeError):
            return True
    return False


def gc_checkpoints(root: str, keep: int, *, fence=None,
                   inuse_ttl_s: float = 300.0) -> List[str]:
    """Delete committed checkpoints beyond the newest ``keep`` (and any
    uncommitted partial dirs older than the newest committed one).
    Returns the removed directory paths.

    Two guards make retention safe at pod scale: ``fence`` refuses the
    whole pass when the caller's generation token is stale (a zombie
    must not delete checkpoints the new epoch may still restore from),
    and directories pinned by a live :func:`checkpoint_in_use` marker
    (a concurrent restore on another rank) are skipped this round —
    they fall to a later pass once the reader finishes or its marker
    ages past ``inuse_ttl_s``.
    """
    import shutil
    _check_fence(fence, "delete", path=root)
    steps = committed_steps(root)
    removed = []
    for s in steps[:-keep] if keep > 0 else []:
        d = step_dir(root, s)
        if checkpoint_is_in_use(d, ttl_s=inuse_ttl_s):
            continue               # a reader holds it; next round's job
        shutil.rmtree(d, ignore_errors=True)
        removed.append(d)
    if steps:
        newest = step_dir(root, steps[-1])
        try:
            names = os.listdir(root)
        except OSError:
            names = []
        for name in names:
            d = os.path.join(root, name)
            if (name.startswith("step_") and d != newest
                    and not os.path.exists(os.path.join(d, MANIFEST))
                    and d < newest
                    and not checkpoint_is_in_use(d, ttl_s=inuse_ttl_s)):
                shutil.rmtree(d, ignore_errors=True)
                removed.append(d)
    return removed
