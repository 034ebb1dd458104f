"""Kernel autotuner: the launch knobs of the hand kernels, a committed
tuning DB, and the consult every kernel family's dispatch seam makes.

The port of ``apex_tpu/ops/autotune.py``. A sweep times each candidate
of a family's grid of launch knobs on the card
(:func:`sweep_entry`) and the winners are kept in a committed JSON DB
(``scripts/torch_kernel_tuning_db.json``, written by
``scripts/torch_kernel_tune.py --update-db``) that each kernel wrapper
consults before it launches.

Fingerprint key, as in the JAX package (stable identity, never a
measured number)::

    family|dims|dtype|chip      e.g.  layer_norm|8192x1024|bfloat16|nvidia_h100_80gb_hbm3

``dims`` is the family's logical problem shape, joined with ``x``:

- ``attention``  — (B, Sq, Sk, H, D) of :func:`~apex_tpu_torch.ops.flash_attention`
- ``mlp``        — (rows, d0, d1, ..., dN) of :func:`~apex_tpu_torch.ops.fused_mlp`
- ``layer_norm`` — (rows, H) of the flattened input
- ``xentropy``   — (rows, V) of the flattened logits
- ``optimizer``  — (n_elements,) of the arena buffer an arena kernel takes

``dtype`` is the numpy name of the torch dtype (``torch.bfloat16`` →
``bfloat16``), so a key is the JAX package's key for the same shape.
``chip`` is the card's name (:func:`chip_kind`), not its architecture: an
H100 PCIe and an SXM share ``sm_90`` but not their bandwidth.

**The knobs.** An entry's ``block`` holds the port's own launch
parameters, not the Pallas block shapes of the JAX entries, and only
values an existing kernel instantiation accepts (:func:`legal_values`):

- ``optimizer``: ``BLOCK`` and ``num_warps`` of the elementwise arena
  updates (``optim_kernels``: LAMB's stages, Adam, SGD, Adagrad,
  NovoGrad; default 1024 and 4), and ``NORM_BLOCK`` and ``norm_warps`` of
  the stage-1 programs of the arena reductions (``multi_tensor``: the L2
  and max norms, scale, axpby; default 4096 and 8). Every ``BLOCK`` is a
  power of two that divides ``BUFFER_MULTIPLE``, hence every arena buffer
  and every ZeRO shard (both multiples of it); one that does not divide
  the buffer at hand is refused at the seam.
- ``xentropy``: ``BLOCK`` (the vocab chunk, default 4096) and
  ``num_warps`` (default 8) of both Triton kernels.
- ``layer_norm``: ``epl``, the elements a lane of the warp-a-row CUDA
  instances (8, 16, 32 or 64, at least H/32; default the least), and
  ``bwd_blocks``, the most blocks of the backward's grid (1–256, default
  256: its finishers add at most 256 partial rows). The warps of a block
  (``kWarps``) are compiled in, so they are no knob.
- ``mlp``: none. ``csrc/mlp_fwd.cu`` takes its whole plan (rows a block,
  fused or a launch a layer) from the widths, so the family is consulted
  and counted but its grid holds only the default.
- ``attention``: ``block_q``/``block_k``, consulted by :func:`tuned_qk`
  exactly as the JAX package's ``_tuned_qk`` (no dropout, an explicit
  override wins). In the port they only place the dropout mask's blocks,
  and the consult skips dropout, so they change no launch: the family's
  grid holds only the default and no attention entry is committed. The
  same consult fronts both flash families (the wgmma kernels and the
  generic f32/any-D ones, ``flash_attn_generic.cu``), whose launches take
  no knob: every generic call is a counted miss.

A tuned launch keeps the kernels' determinism: its partials are reduced
in an order fixed by the shape and the knob, with no float atomics, so
two tuned launches agree bit for bit. A different knob may sum in
another order, and agrees with the plain version at the same tolerance.

**Consultation contract** (the ``autotune/no-extra-dispatch`` compile
check): exact-key hit → the tuned knobs; miss → exactly today's launch
arguments. A nearest miss never matches. An entry whose recorded identity
no longer fingerprints to its key is stale and refused loudly at load
(:class:`StaleTuningEntry`); an entry whose value is off the kernel's
legal grid warns, names its fingerprint, and the defaults are launched.
The consult runs on the host at every eager launch (the JAX package
consults once, at trace time), so its answer is cached per key: it adds
no device work and no host sync.

Env control, shared with the JAX package: ``APEX_TPU_AUTOTUNE=off|db|sweep``
(default ``db``) and ``APEX_TPU_AUTOTUNE_DB`` (the DB's path). ``off``
skips the DB (the launches of the code before the tuner); ``sweep`` acts
as ``db`` and marks the process as a sweep run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import threading
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "FAMILIES", "MODES", "StaleTuningEntry", "TuningEntry", "TuningDB",
    "fingerprint", "chip_kind", "mode", "default_db_path", "active_db",
    "set_db", "use_db", "reload_db", "lookup_blocks", "launch_knobs",
    "tuned_qk", "legal_values", "counters", "reset_counters",
    "recent_consults", "db_stats", "candidate_grid", "measure_candidate",
    "pair_verdict", "sweep_entry", "tune_report", "tune_event",
    "tuned_lint_shapes", "DEFAULTS", "SWEEP_PAIRS", "SWEEP_MIN_WINS",
]

#: the five fused-op families, named as ``prof.roofline.classify_family``
#: names them, so ``worst_gaps`` rows join DB entries directly
FAMILIES = ("attention", "mlp", "layer_norm", "xentropy", "optimizer")

MODES = ("off", "db", "sweep")

_ENV = "APEX_TPU_AUTOTUNE"
_ENV_DB = "APEX_TPU_AUTOTUNE_DB"

#: the launch knobs each wrapper launches on a miss, and the sweep's
#: baseline: the kernel modules take their constants from here
#: (``layer_norm``'s ``epl`` default is its shape's least, from
#: ``layer_norm._ln_plan``)
DEFAULTS: Dict[str, Dict[str, int]] = {
    "attention": {},
    "mlp": {},
    "layer_norm": {"bwd_blocks": 256},
    "xentropy": {"BLOCK": 4096, "num_warps": 8},
    "optimizer": {"BLOCK": 1024, "num_warps": 4, "NORM_BLOCK": 4096,
                  "norm_warps": 8},
}
#: a sweep keeps a candidate only when it beats the default in at least
#: ``SWEEP_MIN_WINS`` of ``SWEEP_PAIRS`` alternating pairs, each time by
#: more than the default's interquartile spread over those pairs
SWEEP_PAIRS, SWEEP_MIN_WINS = 10, 9


class StaleTuningEntry(ValueError):
    """A tuning-DB entry whose recorded identity does not re-fingerprint
    to its key — refused loudly instead of silently applied."""


def mode() -> str:
    """The autotune mode from ``APEX_TPU_AUTOTUNE`` (default ``db``)."""
    m = os.environ.get(_ENV, "db")
    if m not in MODES:
        raise ValueError(
            f"{_ENV}={m!r} is not one of {MODES} — refusing to guess")
    return m


@functools.lru_cache(maxsize=None)
def _card_kind() -> str:
    import torch
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name().strip().lower().replace(" ", "_")


def chip_kind() -> str:
    """Chip key of fingerprints: the card's name lower-cased with spaces
    as ``_`` (``nvidia_h100_80gb_hbm3``), or ``cpu`` without a card."""
    return _card_kind()


def _dtype_name(dtype) -> str:
    """The dtype's numpy name (``float32``, ``bfloat16``, ...): a torch
    dtype by its own name, a numpy dtype or a string as numpy names it."""
    s = str(dtype)
    if s.startswith("torch."):
        return s[len("torch."):]
    import numpy as np
    try:
        return np.dtype(dtype).name
    except TypeError:
        return s


def fingerprint(family: str, dims: Sequence[int], dtype,
                chip: Optional[str] = None) -> str:
    """``family|dims|dtype|chip`` — the DB key. Pure arithmetic on Python
    ints and the dtype's name: the same in every process."""
    if family not in FAMILIES:
        raise ValueError(f"unknown kernel family {family!r} "
                         f"(one of {FAMILIES})")
    dims_s = "x".join(str(int(d)) for d in dims)
    return (f"{family}|{dims_s}|{_dtype_name(dtype)}"
            f"|{chip if chip is not None else chip_kind()}")


# --- the tuning DB -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TuningEntry:
    """One committed winner: identity + launch knobs + sweep provenance
    (the measured evidence; never part of the key)."""

    family: str
    dims: Tuple[int, ...]
    dtype: str
    chip: str
    block: Dict[str, int]
    sweep: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: normalized dot-shape signatures the JAX package's lint joins (kept
    #: as data: the port has no lint pass yet)
    lint_sigs: Tuple[str, ...] = ()

    @property
    def fingerprint(self) -> str:
        return fingerprint(self.family, self.dims, self.dtype, self.chip)

    def to_json(self) -> Dict[str, Any]:
        out = {"family": self.family, "dims": list(self.dims),
               "dtype": self.dtype, "chip": self.chip,
               "block": dict(self.block)}
        if self.sweep:
            out["sweep"] = dict(self.sweep)
        if self.lint_sigs:
            out["lint_sigs"] = list(self.lint_sigs)
        return out

    @classmethod
    def from_json(cls, rec: Dict[str, Any]) -> "TuningEntry":
        return cls(family=str(rec["family"]),
                   dims=tuple(int(d) for d in rec["dims"]),
                   dtype=str(rec["dtype"]), chip=str(rec["chip"]),
                   block={str(k): int(v)
                          for k, v in rec["block"].items()},
                   sweep=dict(rec.get("sweep", {})),
                   lint_sigs=tuple(rec.get("lint_sigs", ())))


def default_db_path() -> str:
    """``scripts/torch_kernel_tuning_db.json`` at the repository root, or
    the ``APEX_TPU_AUTOTUNE_DB`` override."""
    env = os.environ.get(_ENV_DB)
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "scripts", "torch_kernel_tuning_db.json")


class TuningDB:
    """Exact-key fingerprint → :class:`TuningEntry` map with a JSON round
    trip. Load checks every entry's recorded identity against its key:
    a mismatch raises :class:`StaleTuningEntry` naming the key."""

    def __init__(self, entries: Optional[Dict[str, TuningEntry]] = None,
                 path: Optional[str] = None):
        self.entries: Dict[str, TuningEntry] = dict(entries or {})
        self.path = path

    def __len__(self) -> int:
        return len(self.entries)

    @classmethod
    def load(cls, path: str) -> "TuningDB":
        """Parse and check a DB file. A missing file is an empty DB (a
        fresh clone consults nothing); a corrupt or stale one raises."""
        try:
            with open(path) as f:
                data = json.load(f)
        except FileNotFoundError:
            return cls(path=path)
        if not isinstance(data, dict) or not isinstance(
                data.get("entries"), dict):
            raise ValueError(
                f"{path}: not a tuning DB (expected "
                '{"version": 1, "entries": {fingerprint: {...}}})')
        entries: Dict[str, TuningEntry] = {}
        for key, rec in data["entries"].items():
            try:
                e = TuningEntry.from_json(rec)
            except (KeyError, TypeError, ValueError) as err:
                raise StaleTuningEntry(
                    f"{path}: entry {key!r} is malformed ({err}) — "
                    f"re-run scripts/torch_kernel_tune.py to regenerate it"
                ) from err
            if e.fingerprint != key:
                raise StaleTuningEntry(
                    f"{path}: stale tuning entry {key!r}: its recorded "
                    f"identity re-fingerprints to {e.fingerprint!r} — "
                    f"refused, not silently applied; re-run "
                    f"scripts/torch_kernel_tune.py --update-db")
            entries[key] = e
        return cls(entries, path=path)

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("no path to save the tuning DB to")
        body = {"version": 1,
                "entries": {k: self.entries[k].to_json()
                            for k in sorted(self.entries)}}
        with open(path, "w") as f:
            json.dump(body, f, indent=1)
            f.write("\n")
        self.path = path
        return path

    def lookup(self, fp: str) -> Optional[TuningEntry]:
        """Exact-key lookup: a nearest miss (a dim off by one, another
        dtype or chip) returns None."""
        return self.entries.get(fp)

    def add(self, entry: TuningEntry) -> None:
        self.entries[entry.fingerprint] = entry

    def families(self) -> List[str]:
        return sorted({e.family for e in self.entries.values()})

    def stats(self) -> Dict[str, Any]:
        return {"entries": len(self.entries),
                "tuned_families": self.families(),
                "path": self.path}


# --- the legal grid ------------------------------------------------------------

def _pow2(lo: int, hi: int) -> Tuple[int, ...]:
    out, v = [], lo
    while v <= hi:
        out.append(v)
        v *= 2
    return tuple(out)


def legal_values(family: str, dims: Sequence[int],
                 dtype) -> Dict[str, Tuple[int, ...]]:
    """``{knob: values an existing instantiation accepts}`` at one shape
    (an empty tuple: the knob has no legal value there)."""
    dims = tuple(int(d) for d in dims)
    if family == "optimizer":
        from apex_tpu_torch.arena.arena import BUFFER_MULTIPLE
        n = dims[0]
        blocks = tuple(b for b in _pow2(256, 16384)
                       if BUFFER_MULTIPLE % b == 0 and n % b == 0)
        return {"BLOCK": blocks, "num_warps": (1, 2, 4, 8, 16),
                "NORM_BLOCK": blocks, "norm_warps": (1, 2, 4, 8, 16)}
    if family == "xentropy":
        return {"BLOCK": _pow2(512, 16384), "num_warps": (2, 4, 8, 16, 32)}
    if family == "layer_norm":
        h = dims[1]
        name = _dtype_name(dtype)
        f32_scalar = name == "float32" and (h * 4) % 16 != 0
        epl = tuple(e for e in (8, 16, 32, 64)
                    if 32 * e >= h and not (f32_scalar and e > 16))
        return {"epl": epl, "bwd_blocks": tuple(range(1, 257))}
    if family == "attention":
        sq, sk = dims[1], dims[2]
        return {"block_q": tuple(range(8, max(sq, 8) + 8, 8)),
                "block_k": tuple(range(8, max(sk, 8) + 8, 8))}
    if family == "mlp":
        return {}
    raise ValueError(f"unknown kernel family {family!r}")


def _refusal(family, dims, dtype, block) -> Optional[str]:
    legal = legal_values(family, dims, dtype)
    for k, v in block.items():
        if k not in legal:
            return (f"{k} is no launch knob of the {family} kernels "
                    f"(knobs: {sorted(legal) or 'none'})")
        if int(v) not in legal[k]:
            vals = legal[k]
            shown = (f"{vals[0]}..{vals[-1]}" if len(vals) > 8
                     else f"{list(vals)}")
            return f"{k}={v} is off the legal grid ({shown}) at {dims}"
    return None


# --- runtime consult state ---------------------------------------------------

_lock = threading.Lock()
_state: Dict[str, Any] = {"db": None}
_counters = {"hits": 0, "misses": 0}
_recent: List[Tuple[str, bool]] = []      # last consults, for audits
_RECENT_CAP = 256
#: (family, dims, dtype) -> (fingerprint, raw block or None, legal knobs)
_cache: Dict[Tuple, Tuple[str, Optional[Dict[str, int]],
                          Dict[str, int]]] = {}


def active_db() -> TuningDB:
    """The DB the seams consult — loaded at first use from
    :func:`default_db_path` unless one was installed by :func:`set_db` or
    :func:`use_db`."""
    with _lock:
        db = _state["db"]
        if db is None:
            db = _state["db"] = TuningDB.load(default_db_path())
        return db


def set_db(db: Optional[TuningDB]) -> None:
    """Install ``db`` as the active DB (None: load the default again at
    the next consult)."""
    with _lock:
        _state["db"] = db
        _cache.clear()


def reload_db(path: Optional[str] = None) -> TuningDB:
    db = TuningDB.load(path or default_db_path())
    set_db(db)
    return db


@contextlib.contextmanager
def use_db(db_or_path):
    """Consult a given DB (or DB file) inside the block."""
    db = (db_or_path if isinstance(db_or_path, TuningDB)
          else TuningDB.load(db_or_path))
    with _lock:
        prev = _state["db"]
        _state["db"] = db
        _cache.clear()
    try:
        yield db
    finally:
        with _lock:
            _state["db"] = prev
            _cache.clear()


def _consult(family, dims, dtype):
    """``(fingerprint, raw block or None, legal knobs)`` of one key,
    cached, counted; None with ``APEX_TPU_AUTOTUNE=off``."""
    if mode() == "off":
        return None
    key = (family, tuple(dims), dtype)
    got = _cache.get(key)
    if got is None:
        fp = fingerprint(family, dims, dtype)
        entry = active_db().lookup(fp)
        raw = dict(entry.block) if entry else None
        knobs: Dict[str, int] = {}
        if raw:
            why = _refusal(family, dims, dtype, raw)
            if why is None:
                knobs = {k: int(v) for k, v in raw.items()}
            else:
                warnings.warn(
                    f"tuning entry {fp}: {why} — launching the default "
                    f"knobs; re-run scripts/torch_kernel_tune.py "
                    f"--update-db", RuntimeWarning, stacklevel=4)
        got = (fp, raw, knobs)
        with _lock:
            _cache[key] = got
    with _lock:
        _counters["hits" if got[1] is not None else "misses"] += 1
        _recent.append((got[0], got[1] is not None))
        if len(_recent) > 2 * _RECENT_CAP:
            del _recent[:-_RECENT_CAP]
    return got


def lookup_blocks(family: str, dims: Sequence[int],
                  dtype) -> Optional[Dict[str, int]]:
    """The consult: exact-key DB hit → the entry's knobs as recorded;
    miss (or ``APEX_TPU_AUTOTUNE=off``) → None."""
    got = _consult(family, dims, dtype)
    if got is None or got[1] is None:
        return None
    return dict(got[1])


def launch_knobs(family: str, dims: Sequence[int],
                 dtype) -> Dict[str, int]:
    """What a seam launches with beside its defaults: a hit's knobs when
    every one is on the legal grid (:func:`legal_values`), else ``{}``
    (a miss, ``off``, or an entry refused with a warning that names its
    fingerprint). Cached per key: a dict read after the first call."""
    got = _consult(family, dims, dtype)
    return {} if got is None else got[2]


def tuned_qk(q, k, block_q, block_k, dropout_rate, default_q,
             default_k) -> Tuple[int, int]:
    """The attention family's consult, as the JAX package's ``_tuned_qk``:
    only when the caller left ``(block_q, block_k)`` at the defaults (an
    explicit override wins) and never under dropout (the mask's hash is a
    function of the block coordinates). A miss returns the pair as
    given."""
    if (block_q, block_k) != (default_q, default_k):
        return block_q, block_k
    if dropout_rate > 0.0:
        return block_q, block_k
    b, sq, h, d = q.shape
    knobs = launch_knobs("attention", (b, sq, k.shape[1], h, d), q.dtype)
    return (int(knobs.get("block_q", block_q)),
            int(knobs.get("block_k", block_k)))


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def reset_counters() -> None:
    with _lock:
        _counters["hits"] = _counters["misses"] = 0
        del _recent[:]


def recent_consults() -> List[Tuple[str, bool]]:
    """(fingerprint, hit) of the last consults (at most a few hundred)."""
    with _lock:
        return list(_recent[-_RECENT_CAP:])


def db_stats() -> Dict[str, Any]:
    """The loaded DB's stats and this process's consult counters: no
    device access."""
    st = active_db().stats()
    st.update(counters())
    return st


# --- candidate grids ---------------------------------------------------------

def _defaults(family, dims, dtype) -> Dict[str, int]:
    out = dict(DEFAULTS[family])
    if family == "layer_norm":
        epl = legal_values(family, dims, dtype)["epl"]
        if epl:
            out["epl"] = epl[0]
    return out


def candidate_grid(family: str, dims: Sequence[int],
                   dtype) -> List[Dict[str, int]]:
    """The knob sets a sweep times at one shape, the defaults first (the
    sweep can always keep them), then each knob moved alone, all on the
    legal grid. ``mlp`` and ``attention`` have no knob that changes a
    launch, so their grid is the default alone."""
    base = _defaults(family, dims, dtype)
    legal = legal_values(family, dims, dtype)
    moves: Dict[str, Tuple[int, ...]] = {}
    if family == "optimizer":
        moves = {"BLOCK": (512, 2048, 4096), "num_warps": (2, 8),
                 "NORM_BLOCK": (2048, 8192), "norm_warps": (4, 16)}
    elif family == "xentropy":
        moves = {"BLOCK": (2048, 8192), "num_warps": (4, 16)}
    elif family == "layer_norm":
        moves = {"epl": legal["epl"][1:2], "bwd_blocks": (132, 128, 64)}
    out = [base]
    for knob, vals in moves.items():
        for v in vals:
            if v in legal.get(knob, ()) and v != base.get(knob):
                cand = dict(base, **{knob: v})
                if cand not in out:
                    out.append(cand)
    return out


# --- the sweep engine --------------------------------------------------------

def measure_candidate(fn: Callable[[], Any], *, iters: int = 10,
                      flush: Optional[Callable[[], Any]] = None) -> float:
    """Device µs of one ``fn()`` call: its first call (the Triton
    specialization it may compile) under ``prof.autotune_scope`` — a
    tuning compile, never a retrace — then ``prof.report.device_ms`` over
    ``iters`` calls, each after ``flush()`` (an L2 sweep)."""
    import torch
    from apex_tpu_torch.prof import compile_watch, report
    with compile_watch.autotune_scope():
        fn()
        torch.cuda.synchronize()
    return report.device_ms(fn, iters=iters, flush=flush) * 1e3


def _median(xs: Sequence[float]) -> float:
    import statistics
    return statistics.median(xs)


def pair_verdict(default_us: Sequence[float], cand_us: Sequence[float],
                 min_wins: int = SWEEP_MIN_WINS) -> Dict[str, Any]:
    """One candidate against the default over alternating pairs (the
    i-th time of each list taken back to back): a pair is a win when the
    candidate beat that pair's default by more than the default's
    interquartile spread over all the pairs; the candidate passes with at
    least ``min_wins`` wins."""
    import statistics
    if len(default_us) != len(cand_us) or len(default_us) < 2:
        raise ValueError("pair_verdict takes two equal lists of >= 2 "
                         "timings")
    q1, _, q3 = statistics.quantiles(default_us, n=4, method="inclusive")
    iqr = q3 - q1
    wins = sum(c < d - iqr for d, c in zip(default_us, cand_us))
    return {"us": round(_median(cand_us), 3),
            "default_us": round(_median(default_us), 3),
            "iqr_us": round(iqr, 3), "wins": int(wins),
            "passed": wins >= min_wins}


def sweep_entry(family: str, dims: Sequence[int], dtype,
                fn: Callable[[], Any], *,
                candidates: Optional[List[Dict[str, int]]] = None,
                pairs: int = SWEEP_PAIRS, min_wins: int = SWEEP_MIN_WINS,
                iters: int = 10,
                flush: Optional[Callable[[], Any]] = None,
                ) -> TuningEntry:
    """Time every candidate (:func:`candidate_grid` unless given; the
    first is the default) of one shape on the card and return the entry to
    commit. ``fn()`` launches the family's kernels at ``(dims, dtype)``
    through their wrappers; each candidate reaches them through the real
    consult (a one-entry DB under ``use_db``). Each candidate is timed
    against the default in ``pairs`` back-to-back pairs, the default first
    in every other pair (:func:`pair_verdict` judges them). The winner is
    the passing candidate with the least median; with none, the entry holds
    the default knobs, and its sweep record shows why."""
    import torch
    grid = candidates if candidates is not None else candidate_grid(
        family, dims, dtype)
    if not grid:
        raise ValueError(f"empty candidate grid for {family} {dims}")
    chip = chip_kind()
    if chip == "cpu":
        raise RuntimeError("sweep_entry times kernels on a card; there is "
                           "none")
    dims = tuple(int(d) for d in dims)
    base, rest = dict(grid[0]), [dict(c) for c in grid[1:] if c != grid[0]]

    def timed(block):
        entry = TuningEntry(family, dims, _dtype_name(dtype), chip, block)
        with use_db(TuningDB({entry.fingerprint: entry})):
            return measure_candidate(fn, iters=iters, flush=flush)

    recs, pooled = [], []
    prev = os.environ.get(_ENV)
    os.environ[_ENV] = "sweep"
    try:
        if not rest:
            pooled = [timed(base) for _ in range(pairs)]
        for cand in rest:
            d, c = [], []
            for i in range(pairs):
                if i % 2 == 0:
                    d.append(timed(base))
                    c.append(timed(cand))
                else:
                    c.append(timed(cand))
                    d.append(timed(base))
            pooled += d
            recs.append(dict(pair_verdict(d, c, min_wins), block=cand,
                             us_pairs=[round(x, 3) for x in c],
                             default_us_pairs=[round(x, 3) for x in d]))
    finally:
        if prev is None:
            os.environ.pop(_ENV, None)
        else:
            os.environ[_ENV] = prev
    torch.cuda.synchronize()
    default_us = round(_median(pooled), 3)
    passed = [r for r in recs if r["passed"]]
    pick = min(passed, key=lambda r: r["us"]) if passed else None
    return TuningEntry(
        family=family, dims=dims, dtype=_dtype_name(dtype), chip=chip,
        block=dict(pick["block"] if pick else base),
        sweep={"mode": "cuda", "rule": f"won >= {min_wins} of {pairs} "
                                       f"pairs by > the default's IQR",
               "pairs": int(pairs), "iters": int(iters),
               "n_candidates": len(rest) + 1,
               "best_us": pick["us"] if pick else default_us,
               "default_us": default_us,
               "fastest_us": min([default_us] + [r["us"] for r in recs]),
               "won": pick is not None,
               "candidates": recs})


# --- joins: roofline worst_gaps ------------------------------------------------

def tuned_lint_shapes(db: Optional[TuningDB] = None) -> List[str]:
    """Dot-shape signatures covered by DB entries (the JAX lint pass's
    ``tuned_shapes`` input; data only until the port has a lint pass)."""
    db = db if db is not None else active_db()
    out: List[str] = []
    for e in db.entries.values():
        out.extend(s for s in e.lint_sigs if s not in out)
    return out


def _row_dims(shape: str) -> List[Tuple[int, ...]]:
    import re
    return [tuple(int(d) for d in m.group(2).split(",") if d)
            for m in re.finditer(r"(\w+)\[([\d,]*)\]", shape or "")]


def tune_report(db: Optional[TuningDB] = None,
                worst_gaps: Optional[Sequence[Dict[str, Any]]] = None,
                ) -> Dict[str, Any]:
    """Join DB entries to ``RooflineReport.worst_gaps()`` rows by family
    and dims: a row is covered by the entries of its family whose dims
    start with the row's first operand's shape (LayerNorm's (rows, H),
    cross-entropy's (rows, V), an arena buffer's (n,), an MLP's (rows,
    d0)), and the sweep's predicted closure is their ``default_us −
    best_us`` summed."""
    db = db if db is not None else active_db()
    by_family: Dict[str, List[TuningEntry]] = {}
    for e in db.entries.values():
        by_family.setdefault(e.family, []).append(e)

    candidates = []
    for g in (worst_gaps or ()):
        fam = g.get("family")
        shapes = _row_dims(g.get("shape", ""))
        first = shapes[0] if shapes else None
        entries = [e for e in by_family.get(fam, [])
                   if first is not None
                   and tuple(e.dims[:len(first)]) == first]
        predicted = sum(
            max(0.0, float(e.sweep.get("default_us", 0.0))
                - float(e.sweep.get("best_us", 0.0)))
            for e in entries)
        candidates.append({
            "fingerprint": g.get("fingerprint"),
            "family": fam, "op": g.get("op"),
            "measured_us": g.get("measured_us"),
            "attainable_us": g.get("attainable_us"),
            "gap_us": g.get("gap_us"),
            "covered": bool(entries),
            "db_entries": sorted(e.fingerprint for e in entries),
            "predicted_closure_us": round(predicted, 3),
        })
    covered = [c for c in candidates if c["covered"]]
    return {
        "tuned_families": db.families(),
        "n_entries": len(db.entries),
        "candidates": candidates,
        "n_candidates": len(candidates),
        "n_covered": len(covered),
        "uncovered_families": sorted(
            {c["family"] for c in candidates if not c["covered"]}),
        "workflow": ("scripts/torch_kernel_tune.py --update-db sweeps the "
                     "grid on the card and commits winners to "
                     "scripts/torch_kernel_tuning_db.json"),
    }


def tune_event(action: str, fp: str, family: str, *,
               rank: int = 0, **extra) -> Dict[str, Any]:
    """``kind="tune"`` event for the roofline channel
    (``check_metrics_schema.py --kind roofline`` validates)."""
    ev = {"kind": "tune", "rank": rank, "action": action,
          "fingerprint": fp, "family": family}
    ev.update(extra)
    return ev
