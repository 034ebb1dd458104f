"""Cross-replica integrity fingerprints: prove the replication invariant.

The port of ``apex_tpu.guard.integrity``. Data parallelism's invariant —
post-sync gradients and committed parameters are **bitwise identical** on
every replica — is assumed everywhere and verified nowhere at runtime;
the guard ladder only fires on *loud* faults. A flipped mantissa bit that
still reads as a plausible finite number silently diverges one replica.

- **the fold** (:func:`fingerprint_tree`): each replica reduces its
  committed params to one 32-bit value — every element's bit pattern is
  seeded with its global lane, avalanched through a 32-bit mix and the
  terms summed mod 2³², so the fold is reduction-order independent and
  every bit of every element matters. The fold equals the JAX package's
  bit for bit on the same tree: it visits leaves in the JAX package's
  order (sorted dict keys under the JAX names, ``convert.jax_name``) and
  each leaf's elements in the JAX layout (``convert.to_jax_layout``: a
  Dense kernel is (in, out)), a bounded chunk of rows at a time, so a
  transposed leaf is never copied whole and the int64 temporaries stay a
  chunk long. torch has no ``>>`` or ``sum`` for ``uint32`` on the CPU,
  so the arithmetic runs on int64 holding 32-bit values, products split
  in 16-bit halves so nothing leaves int64's range.
- **the compare** (:func:`integrity_check`): every ``check_every`` steps
  the fold is all-reduced MIN and MAX over the data axis (equal ⇔ all
  replicas agree) and all-gathered so the host can *name* the diverged
  minority, under the registered ``guard/integrity_check`` scope. The
  result is an :class:`IntegrityState` of device tensors carried next to
  ``GuardState``.
- **the repair** (:func:`make_repair_fn` over
  :func:`apex_tpu_torch.parallel.replica_broadcast`): re-broadcast the
  majority's bits to the minority under ``guard/integrity_repair``,
  re-verify, leave the data cursor untouched.

Detection feeds :func:`apex_tpu_torch.guard.guard_observe` via
``replica_ok``: a failed check raises the skip-class
``A_REPLICA_DIVERGENCE`` anomaly, so the polluted update never commits on
any replica while :meth:`apex_tpu_torch.guard.GuardPolicy.update_integrity`
decides.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.utils.bits import MASK32, uint_lanes

__all__ = [
    "IntegrityConfig", "IntegrityState", "IntegrityVote",
    "integrity_init", "integrity_check", "integrity_ok",
    "integrity_commit", "integrity_resize", "fingerprint_tree",
    "vote", "absorb_verify", "make_repair_fn",
    "make_verify_fn", "CHECK_SCOPE", "REPAIR_SCOPE",
]

#: golden-ratio odd constant for the lane seeds (an odd multiplier is a
#: bijection mod 2^32: distinct lanes, distinct seeds)
_MIX = 0x9E3779B1
#: the avalanche's multipliers (lowbias32)
_M1, _M2 = 0x7FEB352D, 0x846CA68B
#: elements folded at once: bounds the fold's int64 temporaries
CHUNK_ELEMS = 1 << 24

CHECK_SCOPE = "guard/integrity_check"
REPAIR_SCOPE = "guard/integrity_repair"


class IntegrityConfig(NamedTuple):
    """Static fingerprint configuration."""

    check_every: int = 1    #: fingerprint-compare cadence in steps.
                            #: 1 = every step (repair stays bitwise-
                            #: exact); N amortizes the collectives at up
                            #: to N-1 steps of detection latency


class IntegrityState(NamedTuple):
    """The integrity monitor: device scalars plus one ``[world]`` vector of
    per-replica fingerprints (int64 tensors holding 32-bit values: the
    port's stand-in for ``uint32``). ``divergent`` describes THIS step
    only; ``mismatch_count`` is cumulative and never reset."""

    step: torch.Tensor            # i32 observed (attempted) steps
    check_count: torch.Tensor     # i32 cumulative checks executed
    mismatch_count: torch.Tensor  # i32 cumulative checks that diverged
    divergent: torch.Tensor       # bool: this step's check found mismatch
    fingerprint: torch.Tensor     # this replica's fp at the last check
    fp_min: torch.Tensor          # cross-replica min at the last check
    fp_max: torch.Tensor          # cross-replica max at the last check
    rank_fps: torch.Tensor        # [world] per-replica fps, last check
    last_check_step: torch.Tensor  # i32 step of the last executed check


def _i32(v, device):
    return torch.full((), v, dtype=torch.int32, device=device)


def _u32(v, device):
    return torch.full((), v, dtype=torch.int64, device=device)


def integrity_init(cfg: IntegrityConfig = IntegrityConfig(), *,
                   world: int, device="cuda") -> IntegrityState:
    """Fresh integrity state for a data axis of ``world`` replicas."""
    if int(cfg.check_every) < 1:
        raise ValueError(f"IntegrityConfig.check_every must be >= 1, "
                         f"got {cfg.check_every}")
    if int(world) < 2:
        raise ValueError(f"integrity fingerprints compare across a data "
                         f"axis — world must be >= 2, got {world}")
    return IntegrityState(
        step=_i32(0, device), check_count=_i32(0, device),
        mismatch_count=_i32(0, device),
        divergent=torch.zeros((), dtype=torch.bool, device=device),
        fingerprint=_u32(0, device), fp_min=_u32(0, device),
        fp_max=_u32(0, device),
        rank_fps=torch.zeros((int(world),), dtype=torch.int64,
                             device=device),
        last_check_step=_i32(-1, device),
    )


# -- the fold ------------------------------------------------------------------

def _mul32_(x: torch.Tensor, c: int, tmp: torch.Tensor) -> torch.Tensor:
    """``x ← x · c mod 2^32`` in place for int64 ``x`` in [0, 2^32): the
    constant split in 16-bit halves keeps every product below 2^48;
    ``tmp`` is scratch of ``x``'s shape."""
    lo, hi = c & 0xFFFF, c >> 16
    torch.mul(x, hi, out=tmp)
    tmp.bitwise_and_(0xFFFF).bitwise_left_shift_(16)
    return x.mul_(lo).add_(tmp).bitwise_and_(MASK32)


def _mix32_(x: torch.Tensor, tmp: torch.Tensor) -> torch.Tensor:
    """The avalanche finalizer (lowbias32), in place on 32-bit values in
    int64."""
    for shift, mult in ((16, _M1), (15, _M2), (16, None)):
        torch.bitwise_right_shift(x, shift, out=tmp)
        x.bitwise_xor_(tmp)
        if mult is not None:
            _mul32_(x, mult, tmp)
    return x


def _jax_order(tree):
    """The tree's leaves in the JAX package's leaf order, each viewed in
    its JAX layout: NamedTuple fields and sequences in order, dict keys
    sorted by their JAX name's dotted components, a dict leaf through
    ``convert.to_jax_layout`` of its key."""
    from apex_tpu_torch.convert import jax_name, to_jax_layout
    if isinstance(tree, dict):
        for k in sorted(tree, key=lambda k: tuple(
                jax_name(str(k)).split("."))):
            v = tree[k]
            if isinstance(v, (dict, list, tuple)):
                yield from _jax_order(v)
            elif v is not None:
                t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
                yield to_jax_layout(str(k), t)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _jax_order(v)
    elif tree is not None:
        yield tree if isinstance(tree, torch.Tensor) else torch.as_tensor(
            tree)


def _fold_leaf(x: torch.Tensor, offset: int, fp: torch.Tensor,
               chunk: int, work) -> Tuple[torch.Tensor, int]:
    """Fold one leaf (in the JAX layout, maybe a strided view) into ``fp``
    from global lane ``offset``; returns (fp', offset'). In-place
    arithmetic on the three chunk-long int64 buffers of ``work`` (fresh
    temporaries would cost the CPU most of the fold)."""
    lanes_per = 2 if x.dtype.itemsize == 8 else 1
    if x.dim() == 0:
        x = x.reshape(1)
    row = max(x[0].numel(), 1) * lanes_per
    rows = max(chunk // row, 1)
    for r0 in range(0, x.shape[0], rows):
        part = x[r0:r0 + rows].reshape(-1)
        n = part.numel() * lanes_per
        if work.get("n", 0) < n:
            work.update(n=n, buf=[torch.empty(n, dtype=torch.int64,
                                              device=x.device)
                                  for _ in range(3)])
        bits, tmp, seed = (b[:n] for b in work["buf"])
        uint_lanes(part, out=bits)
        torch.arange(offset, offset + n, out=seed).bitwise_and_(MASK32)
        bits.bitwise_xor_(_mul32_(seed, _MIX, tmp))
        fp = (fp + _mix32_(bits, tmp).sum()) & MASK32
        offset += n
    return fp, offset


def fingerprint_tree(tree, *, chunk: int = CHUNK_ELEMS) -> torch.Tensor:
    """Reduction-order-independent, position-sensitive 32-bit fingerprint
    of a tree's bit content, equal to ``apex_tpu.guard.fingerprint_tree``
    of the same values in the JAX package's tree (``convert`` names and
    layouts). Returns a 0-d int64 tensor on the leaves' device; no host
    sync. Raises TypeError on a dtype the fold cannot read exactly
    (complex)."""
    fp = None
    offset = 0
    work: dict = {}
    for leaf in _jax_order(tree):
        if fp is None:
            fp = torch.zeros((), dtype=torch.int64, device=leaf.device)
        if leaf.numel() == 0:
            uint_lanes(leaf.reshape(-1))      # an unfoldable dtype raises
            continue
        fp, offset = _fold_leaf(leaf, offset, fp, chunk, work)
    return torch.zeros((), dtype=torch.int64) if fp is None else fp


# -- the compare ---------------------------------------------------------------

def _compare(fp: torch.Tensor, world: int, axis_name):
    """(min, max, every replica's fp) over the data axis, each collective
    under the registered check scope."""
    import torch.distributed as dist
    from apex_tpu_torch.parallel import collectives
    from apex_tpu_torch.parallel.mesh import resolve_group
    group = resolve_group(axis_name)
    mn = collectives.all_reduce(fp.clone(), group, CHECK_SCOPE,
                                op=dist.ReduceOp.MIN)
    mx = collectives.all_reduce(fp.clone(), group, CHECK_SCOPE,
                                op=dist.ReduceOp.MAX)
    fps = collectives.all_gather(fp.reshape(1), group, CHECK_SCOPE,
                                 tiled=True)
    return mn, mx, fps.reshape(world)


def integrity_check(ist: IntegrityState, cfg: IntegrityConfig, params, *,
                    axis_name="data", grads=None) -> IntegrityState:
    """Observe one step: fold + cross-replica compare every
    ``cfg.check_every`` steps, advance counters. Call on the COMMITTED
    params the step started from, with the mesh bound
    (``parallel.use_mesh``); pass the post-sync ``grads`` too to prove the
    gradient collective as well.

    With ``check_every > 1`` the cadence is decided on the host, from
    ``ist.step`` read back (a host sync a step): an off-step issues no
    fold and no collective, as the JAX package's empty ``lax.cond`` branch
    does. The fold and compare run under the ``guard/integrity_check``
    trace span (``kind="collective"``)."""
    from apex_tpu_torch.trace.spans import span
    world = ist.rank_fps.shape[0]
    subject = params if grads is None else (params, grads)
    every = int(cfg.check_every)
    if every <= 1 or int(ist.step) % every == 0:
        with span(CHECK_SCOPE, kind="collective"):
            fp = fingerprint_tree(subject)
            mn, mx, fps = _compare(fp, world, axis_name)
        div = mn != mx
        new = ist._replace(
            fingerprint=fp, fp_min=mn, fp_max=mx, rank_fps=fps,
            divergent=div,
            check_count=ist.check_count + 1,
            mismatch_count=(ist.mismatch_count
                            + div.to(torch.int32)).to(torch.int32),
            last_check_step=ist.step.clone())
    else:
        new = ist._replace(divergent=torch.zeros_like(ist.divergent))
    return new._replace(step=ist.step + 1)


def integrity_ok(ist: IntegrityState) -> torch.Tensor:
    """Commit predicate: True unless THIS step's check found a divergence
    (feed it to ``guard_observe(replica_ok=...)``)."""
    return ~ist.divergent


def integrity_commit(ist: IntegrityState, new_tree, old_tree):
    """Commit ``new_tree`` unless this step's integrity check failed."""
    from apex_tpu_torch.utils import tree_select
    return tree_select(integrity_ok(ist), new_tree, old_tree)


# -- the host half: quorum vote + repair programs ------------------------------

class IntegrityVote(NamedTuple):
    """The host-side quorum verdict over one check's gathered fingerprints
    (every rank computes the same vote from the same vector)."""

    has_majority: bool            #: a strict majority (> world/2) agrees
    source_rank: Optional[int]    #: lowest-numbered majority replica
    minority: Tuple[int, ...]     #: replicas that differ from the majority
    majority_fp: Optional[int]    #: the agreed fingerprint, or None
    n_ranks: int                  #: electorate size (the data world)


def vote(rank_fps) -> IntegrityVote:
    """Name the diverged minority from the gathered fingerprints (a tensor,
    array or sequence): a strict majority tells "one bad replica"
    (repairable) from "the collective itself is broken" (no majority:
    rewind)."""
    if isinstance(rank_fps, torch.Tensor):
        rank_fps = rank_fps.detach().cpu().reshape(-1).tolist()
    else:
        import numpy as np
        rank_fps = np.asarray(rank_fps).reshape(-1).tolist()
    fps = [int(v) for v in rank_fps]
    n = len(fps)
    counts: dict = {}
    for fp in fps:
        counts[fp] = counts.get(fp, 0) + 1
    best_fp, best_n = max(counts.items(), key=lambda kv: (kv[1], -kv[0]))
    if best_n * 2 <= n:
        return IntegrityVote(False, None, (), None, n)
    minority = tuple(r for r, fp in enumerate(fps) if fp != best_fp)
    source = min(r for r, fp in enumerate(fps) if fp == best_fp)
    return IntegrityVote(True, source, minority, best_fp, n)


def make_verify_fn(axis_name="data"):
    """``tree -> (fp_min, fp_max, rank_fps)`` over the data axis of the
    bound mesh — the host's standalone compare (repair re-verification,
    post-restore hygiene), under the ``guard/integrity_check`` trace
    span."""
    from apex_tpu_torch.parallel.mesh import axes_size
    from apex_tpu_torch.trace.spans import span

    def _verify(tree):
        with span(CHECK_SCOPE, kind="collective"):
            fp = fingerprint_tree(tree)
            return _compare(fp, axes_size(axis_name), axis_name)

    return _verify


def integrity_resize(ist: IntegrityState, *,
                     world: int) -> IntegrityState:
    """Re-shape a (restored) IntegrityState for another data world:
    cumulative counters survive, the per-replica vector and the last-check
    transients are re-initialized. Same-world states pass through."""
    if int(world) < 2:
        raise ValueError(f"integrity fingerprints compare across a data "
                         f"axis — world must be >= 2, got {world}")
    if int(world) == int(ist.rank_fps.shape[0]):
        return ist
    dev = ist.rank_fps.device
    return ist._replace(
        rank_fps=torch.zeros((int(world),), dtype=torch.int64, device=dev),
        divergent=torch.zeros((), dtype=torch.bool, device=dev),
        fingerprint=_u32(0, dev), fp_min=_u32(0, dev), fp_max=_u32(0, dev),
        last_check_step=_i32(-1, dev))


def absorb_verify(ist: IntegrityState, fp_min, fp_max,
                  rank_fps) -> IntegrityState:
    """Fold a re-verification (``policy.last_verify`` after a successful
    :meth:`~apex_tpu_torch.guard.GuardPolicy.repair`) back into the carried
    state, so a checkpoint taken this step records the post-repair
    agreement. Counters are cumulative history and stay untouched."""
    dev = ist.rank_fps.device

    def u(v):
        return torch.as_tensor(v, dtype=torch.int64).to(dev)

    return ist._replace(
        divergent=torch.zeros((), dtype=torch.bool, device=dev),
        fingerprint=u(fp_min).reshape(()), fp_min=u(fp_min).reshape(()),
        fp_max=u(fp_max).reshape(()),
        rank_fps=u(rank_fps).reshape(ist.rank_fps.shape))


def make_repair_fn(axis_name="data"):
    """``(tree, source_rank) -> tree`` over the data axis of the bound
    mesh — the in-place repair: every replica's leaves are overwritten
    with the ``source_rank`` replica's exact bits by
    :func:`apex_tpu_torch.parallel.replica_broadcast` (under the registered
    ``guard/integrity_repair`` scope and trace span). The data cursor is
    untouched: repair is state surgery, not time travel."""
    def _repair(tree, src):
        from apex_tpu_torch.parallel.distributed import replica_broadcast
        from apex_tpu_torch.trace.spans import span
        with span("guard/integrity_repair", kind="collective"):
            return replica_broadcast(tree, axis_name, source=int(src))

    return _repair
