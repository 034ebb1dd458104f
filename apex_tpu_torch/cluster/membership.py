"""Cluster membership & generation fencing over a shared filesystem.

The port of ``apex_tpu/cluster/membership.py``: the same files (generation
records, leases, the HMAC token) with the same names and contents, so a
cluster directory either package writes is fenced correctly by the other.
A rank given no ``rank=`` is ``torch.distributed``'s when a process group
is initialised, else ``RANK``, else 0.

The resilience arc (guard ladder, watchdog escalation, ``elastic_run``)
made a *single process* survive faults — but every one of those
decisions is per-rank, and nothing stops a stale "zombie" rank (paused,
preempted-then-resumed, or racing a restart) from writing into the
shared checkpoint directory a new incarnation of the job is already
using. This module is the dynamic complement of apexlint's APX201
static congruence check: cross-rank agreement at *runtime*, built from
the two shared-fs primitives the repo already trusts —
one-file-per-rank writes (the heartbeat/ckpt pattern) and a
commit-record-written-LAST atomic rename (the manifest pattern).

Two pieces:

- **leases** (:class:`LeaseWriter`): each rank periodically renews a
  small per-rank lease file carrying ``{rank, generation, expires_at}``.
  A rank whose lease expired is *dead as far as the cluster is
  concerned* — even if the process later resumes (SIGSTOP/SIGCONT, a
  VM migration pause), it must re-join and re-validate its generation
  before touching shared state. No cross-rank writes, torn-tail
  tolerant reads, jittered-retry appends
  (:mod:`apex_tpu_torch.utils.backoff`).

- **generation** (:func:`bump_generation` / :func:`read_generation`):
  a monotonic epoch counter committed as one immutable
  ``generation.{n:08d}.json`` file per epoch, published by exclusive
  hard-link (temp→fsync→link) — the *filename* is the commit, so the
  publish is a true compare-and-swap: two racers for the same epoch
  cannot both land, and a stalled writer from an old round cannot
  roll the committed epoch backwards (its target filename already
  exists). Readers take the max epoch present; epoch files are never
  deleted. Every recovery decision (coordinated rewind, elastic
  relaunch) bumps it; every checkpoint write, heartbeat, and
  escalation event carries its generation as a **fence token**, and the
  checkpoint format refuses commits (and retention refuses deletes)
  bearing a stale one — so a zombie rank from generation N cannot
  corrupt generation N+1's run.

:class:`ClusterMembership` ties both together and is the ``fence=``
object :class:`apex_tpu_torch.ckpt.CheckpointManager` accepts; events are
``kind="cluster_*"`` dicts handed to ``event_sink`` (the JAX package's
cluster-channel records).
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import secrets
import time
from typing import Callable, Dict, List, Optional

from apex_tpu_torch.utils.backoff import backoff_sleep
from apex_tpu_torch.utils.fsio import fsync_dir, write_atomic
from apex_tpu_torch.utils.ranks import rank_default

__all__ = ["ClusterMembership", "LeaseWriter", "StaleGenerationError",
           "read_generation", "read_generation_record", "bump_generation",
           "read_leases", "lease_path", "gc_stale_leases",
           "gc_stale_intents", "cluster_token", "GENERATION_PREFIX",
           "generation_path", "INTENT_PREFIX", "sign_payload", "mac_ok"]

#: immutable per-epoch commit files (``generation.00000003.json``) —
#: the FILENAME is the commit (published by exclusive create), the
#: content is forensic metadata; never deleted (a deleted epoch would
#: reopen the rollback race the scheme exists to close)
GENERATION_PREFIX = "generation."
TOKEN_FILE = "cluster_token"
_LEASE_PREFIX = "lease.rank"
#: recovery-intent files (``intent.g00000003.rank00001.json``) — owned
#: by :mod:`apex_tpu_torch.cluster.coordinator`, named here so the relaunch
#: hygiene pass can garbage-collect resolved rounds' files
INTENT_PREFIX = "intent.g"


class StaleGenerationError(RuntimeError):
    """A fence refusal: an actor carrying generation ``generation``
    tried to mutate shared state owned by ``current`` > generation.
    The actor is a zombie of a previous incarnation — the only safe
    response is to stop writing (and usually to exit)."""

    def __init__(self, what: str, *, generation: int, current: int,
                 detail: str = ""):
        super().__init__(
            f"stale generation fence: refusing {what} from generation "
            f"{generation} — the cluster is at generation {current}"
            + (f" ({detail})" if detail else "")
            + "; this process is a zombie of a previous incarnation "
              "(paused, preempted-then-resumed, or racing a restart) "
              "and must not touch shared state")
        self.what = what
        self.generation = int(generation)
        self.current = int(current)


def _rank_default() -> int:
    return rank_default()


def _write_atomic(path: str, data: bytes) -> None:
    """temp → fsync → rename (:func:`apex_tpu_torch.utils.fsio.write_atomic`
    — readers never see a torn record, the rename IS the commit point);
    the pid-qualified temp keeps concurrent writers of the SAME path
    (e.g. two ranks racing a generation bump) off each other's temp."""
    write_atomic(path, data, tmp_suffix=f".{os.getpid()}.tmp")


def _read_json_retry(path: str, *, attempts: int = 3) -> Optional[Dict]:
    """Read one atomic JSON record, absorbing the rename-visibility /
    brief-staleness window a networked fs shows racing readers. None
    when genuinely absent (or unreadable after ``attempts``)."""
    for k in range(max(int(attempts), 1)):
        try:
            with open(path) as f:
                rec = json.load(f)
            return rec if isinstance(rec, dict) else None
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            if k + 1 < attempts:
                backoff_sleep(k, base_s=0.02, cap_s=0.2)
    return None


# --- the shared signing token -------------------------------------------------

def cluster_token(directory: str) -> str:
    """The cluster's shared signing secret (hex), created on first use.

    Intents and leases are MAC'd with it (HMAC-SHA256) so a reader can
    tell a record written by a member of *this* cluster directory from
    a torn write, a stray file, or a rank pointed at the wrong run —
    integrity against accidents, not an adversary (anyone who can read
    the shared directory can read the token too)."""
    path = os.path.join(directory, TOKEN_FILE)
    rec = _read_json_retry(path)
    if rec and isinstance(rec.get("token"), str):
        return rec["token"]
    os.makedirs(directory, exist_ok=True)
    token = secrets.token_hex(16)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump({"token": token, "wall_time": time.time()}, f)
        f.flush()
        os.fsync(f.fileno())
    try:
        # first writer wins: link-style exclusive create, so two ranks
        # racing the very first join agree on ONE token
        os.link(tmp, path)
    except FileExistsError:
        pass
    except OSError:
        # filesystems without hard links: O_EXCL create keeps
        # first-writer-wins (an exists()-then-replace fallback would
        # be a TOCTOU — two first-joiners could adopt DIFFERENT
        # tokens and split the cluster into two MAC domains)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            with os.fdopen(fd, "w") as f:
                json.dump({"token": token, "wall_time": time.time()}, f)
                f.flush()
                os.fsync(f.fileno())
        except FileExistsError:
            pass
    finally:
        try:
            os.remove(tmp)
        except OSError:
            pass
    rec = _read_json_retry(path)
    if not rec or not isinstance(rec.get("token"), str):
        raise OSError(f"could not establish cluster token at {path}")
    return rec["token"]


def sign_payload(token: str, payload: Dict) -> str:
    """Deterministic HMAC over a canonical JSON encoding."""
    canon = json.dumps(payload, sort_keys=True,
                       separators=(",", ":")).encode()
    return hmac.new(bytes.fromhex(token), canon,
                    hashlib.sha256).hexdigest()


def mac_ok(token: str, rec: Dict) -> bool:
    """Does ``rec``'s ``mac`` verify against the cluster token? A
    record that fails is a torn write, a stray/foreign file, or
    tampering — never counted, always eligible for gc."""
    mac = rec.get("mac")
    if not isinstance(mac, str):
        return False
    body = {k: v for k, v in rec.items() if k != "mac"}
    try:
        return hmac.compare_digest(mac, sign_payload(token, body))
    except (TypeError, ValueError):
        return False


# --- generation ---------------------------------------------------------------

def generation_path(directory: str, generation: int) -> str:
    return os.path.join(
        directory, f"{GENERATION_PREFIX}{int(generation):08d}.json")


def _committed_epochs(directory: str) -> List[int]:
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for name in names:
        if not (name.startswith(GENERATION_PREFIX)
                and name.endswith(".json")):
            continue
        mid = name[len(GENERATION_PREFIX):-len(".json")]
        if mid.isdigit():
            out.append(int(mid))
    return sorted(out)


def read_generation_record(directory: str) -> Dict:
    """The committed generation record — the MAX epoch file present
    (``{"generation": 0}`` when the cluster directory is fresh —
    generation 0 is the implicit first epoch, so a run needs no
    bootstrap write). The filename is authoritative: an epoch file
    with unreadable content (the brief torn window of the no-hardlink
    fallback) still commits its epoch."""
    epochs = _committed_epochs(directory)
    if not epochs:
        return {"generation": 0}
    n = epochs[-1]
    rec = _read_json_retry(generation_path(directory, n))
    if not rec or rec.get("generation") != n:
        return {"generation": n}
    return rec


def read_generation(directory: str) -> int:
    return int(read_generation_record(directory)["generation"])


def bump_generation(directory: str, *, rank: Optional[int] = None,
                    reason: str = "", expect: Optional[int] = None) -> int:
    """Commit generation ``current + 1`` as a new immutable epoch file,
    published by exclusive create — a true CAS: of N racers for the
    same next epoch exactly one lands, the rest get
    :class:`StaleGenerationError`; and a writer stalled since an OLD
    round cannot roll the committed epoch backwards, because its
    target filename already exists however long it slept between its
    read and its publish.

    ``expect`` is the optimistic-concurrency guard for coordinated
    bumps: when set and the on-disk generation already moved past it,
    raise :class:`StaleGenerationError` instead of double-bumping —
    the caller lost the race (another leader already fenced this
    epoch) and must re-read rather than stack epochs. (The exclusive
    create below enforces the same property even WITHOUT ``expect`` —
    the pre-check just gives a cheaper, better-attributed refusal.)
    """
    os.makedirs(directory, exist_ok=True)
    current = read_generation(directory)
    if expect is not None and current != int(expect):
        raise StaleGenerationError(
            "generation bump", generation=int(expect), current=current,
            detail="another rank already bumped this epoch")
    new = current + 1
    rec = {"generation": new, "prev_generation": current,
           "committed_by_rank": (_rank_default() if rank is None
                                 else int(rank)),
           "reason": reason or None, "wall_time": time.time()}
    data = json.dumps(rec).encode()
    path = generation_path(directory, new)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    try:
        # exclusive hard-link publish: content already durable, the
        # link IS the commit and exactly one racer's succeeds
        os.link(tmp, path)
    except FileExistsError:
        raise StaleGenerationError(
            "generation bump", generation=current,
            current=read_generation(directory),
            detail="another rank already bumped this epoch")
    except OSError:
        # filesystems without hard links: O_EXCL create keeps the
        # exactly-one-winner property; readers may glimpse torn
        # CONTENT for an instant, but the filename already committed
        # the epoch (read_generation_record tolerates that)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            raise StaleGenerationError(
                "generation bump", generation=current,
                current=read_generation(directory),
                detail="another rank already bumped this epoch")
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
    finally:
        try:
            os.remove(tmp)
        except OSError:
            pass
    fsync_dir(directory)
    return new


# --- leases -------------------------------------------------------------------

def lease_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"{_LEASE_PREFIX}{int(rank):05d}.json")


def read_leases(directory: str, *,
                token: Optional[str] = None) -> Dict[int, Dict]:
    """``{rank: lease record}`` over every lease file present.
    Torn/corrupt files are skipped (a reader racing an atomic replace
    on a laggy fs) — the rank simply reads as lease-less until the
    next renewal lands. ``token`` additionally drops records whose
    MAC does not verify (a stray/foreign file must not read as a
    member — a phantom rank would stall every recovery barrier)."""
    out: Dict[int, Dict] = {}
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        if not (name.startswith(_LEASE_PREFIX) and name.endswith(".json")):
            continue
        try:
            rank = int(name[len(_LEASE_PREFIX):-len(".json")])
        except ValueError:
            continue
        rec = _read_json_retry(os.path.join(directory, name), attempts=1)
        if rec is None:
            continue
        if token is not None and not mac_ok(token, rec):
            continue
        out[rank] = rec
    return out


def gc_stale_leases(directory: str, current_generation: int, *,
                    token: Optional[str] = None) -> List[str]:
    """Remove lease files from generations older than ``current`` —
    the relaunch hygiene pass: a dead rank's last lease must not read
    as a live (or freshly-dead) member of the NEW epoch forever. With
    ``token``, files whose MAC fails verification are removed too
    (they can never count as members, only clutter the table).
    Returns removed paths."""
    removed: List[str] = []
    for rank, rec in read_leases(directory).items():
        gen = rec.get("generation")
        fresh = isinstance(gen, int) and gen >= int(current_generation)
        verified = token is None or mac_ok(token, rec)
        if fresh and verified:
            continue
        p = lease_path(directory, rank)
        try:
            os.remove(p)
            removed.append(p)
        except OSError:
            pass
    return removed


def gc_stale_intents(directory: str,
                     current_generation: int) -> List[str]:
    """Remove recovery-intent files of generations older than
    ``current`` — a resolved round's files are inert the moment the
    leader bumps, but on a long-running job they would otherwise
    accumulate forever under the per-step ``pending()`` listdir.
    Returns removed paths."""
    removed: List[str] = []
    try:
        names = os.listdir(directory)
    except OSError:
        return removed
    for name in names:
        if not (name.startswith(INTENT_PREFIX)
                and name.endswith(".json")):
            continue
        try:
            gen = int(name[len(INTENT_PREFIX):].split(".", 1)[0])
        except ValueError:
            continue
        if gen >= int(current_generation):
            continue
        p = os.path.join(directory, name)
        try:
            os.remove(p)
            removed.append(p)
        except OSError:
            pass
    return removed


class LeaseWriter:
    """This rank's membership lease: acquire → renew per step → release.

    A lease is one atomically-replaced JSON file ``{rank, generation,
    wall_time, expires_at, pid, n_renewals, mac}``; ``expires_at``
    (wall clock + ``ttl_s``) is the death certificate readers act on —
    a crash needs no cleanup, the lease just stops being renewed.
    Writes retry through the shared jittered backoff and then drop the
    renewal (a lost renewal must never break the train loop; the next
    one re-asserts liveness, and TTLs are sized >> one step)."""

    def __init__(self, directory: str, rank: Optional[int] = None, *,
                 ttl_s: float = 30.0, attempts: int = 3):
        self.directory = directory
        self.rank = _rank_default() if rank is None else int(rank)
        self.ttl_s = float(ttl_s)
        self.attempts = max(int(attempts), 1)
        os.makedirs(directory, exist_ok=True)
        #: cached once — the token is immutable after creation, and a
        #: per-renewal re-read would cost a shared-fs round trip per
        #: training step
        self.token = cluster_token(directory)
        self.path = lease_path(directory, self.rank)
        self.generation: Optional[int] = None
        self.n_renewals = 0
        self.n_dropped = 0

    def _record(self, *, expires_at: Optional[float] = None) -> Dict:
        now = time.time()
        payload = {
            "rank": self.rank, "generation": int(self.generation or 0),
            "wall_time": now,
            "expires_at": (now + self.ttl_s if expires_at is None
                           else float(expires_at)),
            "ttl_s": self.ttl_s, "pid": os.getpid(),
            "n_renewals": self.n_renewals,
        }
        payload["mac"] = sign_payload(self.token, payload)
        return payload

    def _write(self, rec: Dict) -> bool:
        data = json.dumps(rec).encode()
        for attempt in range(self.attempts):
            try:
                _write_atomic(self.path, data)
                return True
            except OSError:
                if attempt + 1 < self.attempts:
                    backoff_sleep(attempt, cap_s=0.2)
        self.n_dropped += 1
        return False

    def acquire(self, generation: int) -> bool:
        self.generation = int(generation)
        self.n_renewals = 0
        return self._write(self._record())

    def renew(self) -> bool:
        if self.generation is None:
            raise RuntimeError("renew() before acquire(generation)")
        self.n_renewals += 1
        return self._write(self._record())

    def release(self) -> None:
        try:
            os.remove(self.path)
        except OSError:
            pass

    def expire_now(self) -> bool:
        """Backdate this lease's expiry — the ``cluster:lease_expire``
        chaos site: the process is alive but the cluster must treat it
        as dead (exactly what a long SIGSTOP pause looks like from the
        outside)."""
        return self._write(self._record(expires_at=time.time() - 1.0))


def _lease_expired(rec: Dict, now: float) -> bool:
    exp = rec.get("expires_at")
    return not isinstance(exp, (int, float)) or now >= float(exp)


# --- the membership facade ----------------------------------------------------

class ClusterMembership:
    """Lease + generation for one rank, and the ``fence`` object the
    checkpoint layer consumes.

    ::

        member = cluster.ClusterMembership(cluster_dir,
                                           event_sink=events.append)
        gen = member.join()
        mgr = ckpt.CheckpointManager(root, fence=member)
        for step, batch in ...:
            ...
            member.heartbeat()          # renew the lease

    The **fence contract**: :attr:`generation` is this process's fence
    token (fixed at :meth:`join`, advanced only by :meth:`bump` /
    :meth:`rejoin`), and :meth:`check` re-reads the *committed*
    generation from disk and raises :class:`StaleGenerationError` when
    the token is stale — which is how a resumed zombie discovers the
    world moved on, however long it was paused. Every refusal is
    emitted as a ``cluster_fence`` event *before* the raise (fencing
    events must survive the exit they usually precede — wire an
    unbuffered sink).
    """

    def __init__(self, directory: str, *, rank: Optional[int] = None,
                 ttl_s: float = 30.0,
                 event_sink: Optional[Callable[[Dict], None]] = None):
        self.directory = directory
        self.rank = _rank_default() if rank is None else int(rank)
        self.event_sink = event_sink
        self.lease = LeaseWriter(directory, self.rank, ttl_s=ttl_s)
        self._generation: Optional[int] = None

    # -- events ----------------------------------------------------------------

    def _emit(self, event: Dict) -> None:
        if self.event_sink is None:
            return
        try:
            self.event_sink(dict(event, rank=self.rank,
                                 wall_time=time.time()))
        except Exception:
            pass              # telemetry must never break membership

    # -- lifecycle -------------------------------------------------------------

    @property
    def generation(self) -> int:
        """This process's fence token (0 before :meth:`join`)."""
        return 0 if self._generation is None else self._generation

    def join(self) -> int:
        """Read the committed generation and acquire this rank's lease
        under it. Returns the generation joined."""
        self._generation = read_generation(self.directory)
        self.lease.acquire(self._generation)
        self._emit({"kind": "cluster_lease", "action": "acquire",
                    "generation": self._generation,
                    "ttl_s": self.lease.ttl_s, "path": self.lease.path})
        return self._generation

    def heartbeat(self) -> bool:
        """Renew the lease (call at step cadence; a TTL is sized in
        steps). Not an event per renewal — that would be a per-step
        write amplification on the telemetry stream for zero forensic
        value; acquire/expire/release are the interesting edges."""
        if self._generation is None:
            self.join()
        return self.lease.renew()

    def leave(self) -> None:
        self.lease.release()
        self._emit({"kind": "cluster_lease", "action": "release",
                    "generation": self.generation,
                    "path": self.lease.path})

    def refresh(self) -> int:
        """Re-read the committed generation WITHOUT adopting it —
        observation only (the adoption path is :meth:`rejoin`, which is
        a deliberate act after recovery coordination)."""
        return read_generation(self.directory)

    def rejoin(self) -> int:
        """Adopt the current committed generation (post-coordination:
        the decision bumped it, survivors re-join under the new epoch)
        and re-acquire the lease under it."""
        new = self.join()
        self._emit({"kind": "cluster_generation", "action": "observe",
                    "generation": new, "reason": "rejoin",
                    "prev_generation": None})
        return new

    def bump(self, reason: str = "", *,
             expect: Optional[int] = None) -> int:
        """Commit the next generation (fencing out every holder of the
        old token) and adopt it. ``expect`` defaults to this member's
        own token — so a zombie cannot bump over an epoch it never
        belonged to."""
        prev = self.generation
        new = bump_generation(self.directory, rank=self.rank,
                              reason=reason,
                              expect=self.generation if expect is None
                              else expect)
        self._generation = new
        self.lease.acquire(new)
        self._emit({"kind": "cluster_generation", "action": "bump",
                    "generation": new, "prev_generation": prev,
                    "reason": reason or None})
        return new

    def claim_generation(self, generation: int) -> None:
        """Assert a LOCAL fence token without committing it — the
        ``cluster:split_brain`` chaos site: this rank now claims an
        epoch the cluster never agreed on, and every verifier
        (coordinator intents, fences on commit) must refuse it."""
        self._generation = int(generation)
        self.lease.acquire(self._generation)

    # -- liveness --------------------------------------------------------------

    def leases(self) -> Dict[int, Dict]:
        """MAC-verified lease table (stray/foreign files excluded)."""
        return read_leases(self.directory, token=self.lease.token)

    def alive_ranks(self, now: Optional[float] = None) -> List[int]:
        """Ranks holding an unexpired lease of the CURRENT committed
        generation."""
        now = time.time() if now is None else now
        cur = self.refresh()
        return sorted(r for r, rec in self.leases().items()
                      if rec.get("generation") == cur
                      and not _lease_expired(rec, now))

    def expired_ranks(self, now: Optional[float] = None) -> List[int]:
        """Ranks whose lease exists but expired — the dead-member
        signal that drives a coordinated shrink. Emits one
        ``cluster_lease`` ``action="expire"`` observation per call
        when any are found."""
        now = time.time() if now is None else now
        leases = self.leases()
        out = sorted(r for r, rec in leases.items()
                     if _lease_expired(rec, now))
        # a never-joined observer (elastic_run's controller) has no
        # fence token of its own — attribute its observations to the
        # COMMITTED epoch, not the placeholder 0
        gen = (self.generation if self._generation is not None
               else self.refresh())
        for r in out:
            exp = leases[r].get("expires_at")
            self._emit({"kind": "cluster_lease", "action": "expire",
                        "generation": gen,
                        "expires_at": (float(exp) if isinstance(
                            exp, (int, float)) else None),
                        "expired_rank": r})
        return out

    # -- the fence -------------------------------------------------------------

    def check(self, what: str = "commit", *,
              path: Optional[str] = None,
              step: Optional[int] = None) -> int:
        """Validate this process's fence token against the COMMITTED
        generation (re-read from disk — a zombie's cached view is
        exactly what cannot be trusted). Returns the current
        generation; raises :class:`StaleGenerationError` (after
        emitting the ``cluster_fence`` refusal) on ANY mismatch — a
        lower token is a zombie of a previous epoch, a higher one a
        split-brain claim the cluster never committed; neither may
        touch shared state."""
        current = self.refresh()
        if self.generation != current:
            action = {"commit": "refused_commit",
                      "write": "refused_write",
                      "delete": "refused_delete"}.get(what,
                                                      "refused_commit")
            self._emit({"kind": "cluster_fence", "action": action,
                        "generation": self.generation,
                        "current_generation": current, "what": what,
                        "path": path, "step": step, "reason": None})
            raise StaleGenerationError(
                what, generation=self.generation, current=current,
                detail=("the claimed generation was never committed "
                        "(split-brain)"
                        if self.generation > current else ""))
        return current

    # -- relaunch hygiene ------------------------------------------------------

    def gc_stale(self, *, heartbeat_dir: Optional[str] = None
                 ) -> List[str]:
        """Remove lease, recovery-intent and (when ``heartbeat_dir``
        is given) straggler heartbeat files left by older generations
        — see :func:`gc_stale_leases` / :func:`gc_stale_intents` /
        :func:`apex_tpu_torch.trace.straggler.gc_stale_heartbeats`. Returns
        removed paths."""
        cur = self.refresh()
        removed = gc_stale_leases(self.directory, cur,
                                  token=self.lease.token)
        removed += gc_stale_intents(self.directory, cur)
        if heartbeat_dir is not None:
            from apex_tpu_torch.trace.straggler import gc_stale_heartbeats
            removed += gc_stale_heartbeats(heartbeat_dir, cur)
        if removed:
            self._emit({"kind": "cluster_lease", "action": "gc",
                        "generation": cur, "n_removed": len(removed)})
        return removed
