"""Deterministic chaos injection: prove recovery, don't hope for it.

The port of ``apex_tpu.guard.chaos``: the same plans (a plan built from a
seed equals the JAX package's, JSON for JSON), the same sites, and
injections into torch trees. Each replica is a process in the port, so a
``params`` fault corrupts the tensors of the process whose ``rank`` the
plan names; ``cluster`` faults need a membership object and raise
``ValueError`` without one.

A resilience stack that has never seen a fault is a liability — the
chaos harness makes faults a *reproducible input*. A :class:`FaultPlan`
is a pure function of its construction (explicit faults, or
:meth:`FaultPlan.random` from a seed): keyed by ``(step, rank, site)``,
JSON round-trippable, and replayable bit-for-bit — the same plan run
twice injects the same faults at the same instants, which is what lets a
faulted run be compared against a fault-free oracle bitwise.

Injection sites span the layers a real pod run fails at:

========== ============================ ================================
site       kinds                        mechanism
========== ============================ ================================
batch      nan, inf, corrupt, overflow  host: poison the input batch
grads      nan, inf                     in the step (`inject_grads` +
                                        the per-step ``fault_code``)
activations nan                         in the step (`inject_activation`)
params     nan, bitflip,                host: corrupt committed state
           bitflip_mantissa             AFTER the step (silent-DMA /
                                        bit-flip model);
                                        ``bitflip_mantissa`` flips a
                                        mantissa bit only (``arg``
                                        selects which, mod the dtype's
                                        mantissa width) so the
                                        corrupted value is guaranteed
                                        FINITE — silent to the
                                        nonfinite-param probe, the
                                        exact class the integrity
                                        fingerprints exist for
collective stall                        host: sleep — a peer wedged in a
                                        collective (watchdog territory)
proc       sigkill                      host: SIGKILL this process
ckpt       truncate                     host: truncate the newest
                                        committed checkpoint's data file
cluster    lease_expire, zombie_resume, host: control-plane faults
           split_brain                  against a cluster membership
                                        (``post_step(membership=...)``)
========== ============================ ================================

The ``cluster`` site exercises the generation-fencing paths:
``lease_expire`` backdates this
rank's lease so the cluster declares it dead while the process keeps
running (what a long VM pause looks like from outside);
``zombie_resume`` SIGSTOPs this process — the driver (``cluster_audit``
or a test) escalates + relaunches around the pause and SIGCONTs it
afterwards, turning it into a live zombie whose late writes the fence
must refuse; ``split_brain`` makes this rank *claim* a generation the
cluster never committed (``arg`` = the offset, default +1), which every
verifier (intent MACs + generation checks, commit fences) must refuse.

In-step sites work through one i32 ``fault_code`` (a Python int or a
device scalar): the instrumented step calls
``grads = chaos.inject_grads(grads, code)``, a ``torch.where`` select
per leaf; a plan with no in-step faults passes code 0 every step and the
selects choose the clean branch. Chaos instrumentation is for test and
audit runs — production steps simply never take the argument.
"""

from __future__ import annotations

import json
import os
import signal
import time
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["Fault", "FaultPlan", "ChaosHarness",
           "inject_grads", "inject_activation",
           "C_GRAD_NAN", "C_GRAD_INF", "C_ACT_NAN", "SITES"]

#: fault_code bits for the in-graph sites
C_GRAD_NAN = 1
C_GRAD_INF = 2
C_ACT_NAN = 4

SITES: Dict[str, Tuple[str, ...]] = {
    "batch": ("nan", "inf", "corrupt", "overflow"),
    "grads": ("nan", "inf"),
    "activations": ("nan",),
    "params": ("nan", "bitflip", "bitflip_mantissa"),
    "collective": ("stall",),
    "proc": ("sigkill",),
    "ckpt": ("truncate",),
    "cluster": ("lease_expire", "zombie_resume", "split_brain"),
}


class Fault(NamedTuple):
    """One planned fault. ``arg`` is the site-specific magnitude:
    corrupt amplitude / overflow factor / stall seconds / bit index."""
    step: int
    site: str
    kind: str
    rank: int = 0
    arg: float = 0.0


class FaultPlan:
    """A replayable, (step, rank, site)-keyed fault schedule."""

    def __init__(self, faults: Iterable[Fault] = (), *, seed: int = 0):
        self.seed = int(seed)
        self._by_key: Dict[Tuple[int, int, str], Fault] = {}
        for f in faults:
            self.add(f.step, f.site, f.kind, rank=f.rank, arg=f.arg)

    def add(self, step: int, site: str, kind: str, *, rank: int = 0,
            arg: float = 0.0) -> "FaultPlan":
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} — one of "
                             f"{sorted(SITES)}")
        if kind not in SITES[site]:
            raise ValueError(f"site {site!r} supports kinds "
                             f"{SITES[site]}, got {kind!r}")
        key = (int(step), int(rank), site)
        if key in self._by_key:
            raise ValueError(f"duplicate fault at (step={step}, "
                             f"rank={rank}, site={site})")
        self._by_key[key] = Fault(int(step), site, kind, int(rank),
                                  float(arg))
        return self

    @classmethod
    def random(cls, seed: int, n_steps: int, *, rates: Dict[str, float],
               ranks: int = 1) -> "FaultPlan":
        """A deterministic random plan: per (step, rank), each named
        ``site:kind`` (e.g. ``{"grads:nan": 0.05}``) fires with its
        rate. Pure function of ``(seed, n_steps, rates, ranks)`` — two
        calls build identical plans. At most one rate key per SITE:
        the plan is keyed by (step, rank, site), so two kinds on one
        site would silently under-deliver whichever loses the
        collision — build multi-kind-per-site plans with explicit
        :meth:`add` calls at distinct steps instead."""
        rng = np.random.RandomState(int(seed))
        plan = cls(seed=seed)
        specs = []
        seen_sites: Dict[str, str] = {}
        for name, rate in sorted(rates.items()):
            site, sep, kind = name.partition(":")
            if not sep or site not in SITES or kind not in SITES[site]:
                raise ValueError(
                    f"unknown fault rate key {name!r} — use "
                    f"'site:kind' with site in {sorted(SITES)} and a "
                    f"kind that site supports (a typo here would make "
                    f"a chaos soak pass vacuously)")
            if site in seen_sites:
                raise ValueError(
                    f"rate keys {seen_sites[site]!r} and {name!r} "
                    f"share the site {site!r}: plans are keyed by "
                    f"(step, rank, site), so one of them would be "
                    f"silently dropped on every collision — use "
                    f"explicit add() calls for multi-kind sites")
            seen_sites[site] = name
            specs.append((name, site, kind, float(rate)))
        for step in range(int(n_steps)):
            for rank in range(int(ranks)):
                for name, site, kind, rate in specs:
                    if rng.rand() < rate:
                        key = (step, rank, site)
                        if key not in plan._by_key:
                            plan._by_key[key] = Fault(step, site, kind,
                                                      rank, 0.0)
        return plan

    def at(self, step: int, rank: int, site: str) -> Optional[Fault]:
        return self._by_key.get((int(step), int(rank), site))

    def faults(self):
        return sorted(self._by_key.values())

    def fault_code(self, step: int, rank: int = 0) -> int:
        """The i32 bitmask driving the in-graph sites at this step."""
        code = 0
        g = self.at(step, rank, "grads")
        if g is not None:
            code |= C_GRAD_NAN if g.kind == "nan" else C_GRAD_INF
        a = self.at(step, rank, "activations")
        if a is not None:
            code |= C_ACT_NAN
        return code

    # -- replayable artifact ---------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "faults": [list(f) for f in self.faults()]})

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        return cls((Fault(int(s), site, kind, int(r), float(a))
                    for s, site, kind, r, a in d["faults"]),
                   seed=d.get("seed", 0))

    def __eq__(self, other):
        return (isinstance(other, FaultPlan)
                and self._by_key == other._by_key)

    def __len__(self):
        return len(self._by_key)


# -- in-step injection helpers -------------------------------------------------

def _code(code, device) -> torch.Tensor:
    if isinstance(code, torch.Tensor):
        return code.to(device=device, dtype=torch.int32)
    return torch.full((), int(code), dtype=torch.int32, device=device)


def _poison_first(x: torch.Tensor, bad: torch.Tensor, val) -> torch.Tensor:
    """``x`` with element 0 set to ``val`` where ``bad`` (a device bool
    scalar); a new tensor, no host sync."""
    flat = x.reshape(-1).clone()
    if flat.numel():
        flat[:1] = torch.where(bad, torch.as_tensor(val, dtype=x.dtype,
                                                    device=x.device),
                               flat[:1])
    return flat.view(x.shape)


def inject_grads(grads, code):
    """Poison element 0 of every float grad leaf with NaN (code bit
    ``C_GRAD_NAN``) or Inf (``C_GRAD_INF``). Identity when neither bit is
    set (the clean-path select)."""
    from apex_tpu_torch.utils import tree_map

    def _one(g):
        if not (isinstance(g, torch.Tensor) and g.is_floating_point()):
            return g
        c = _code(code, g.device)
        bad_nan = (c & C_GRAD_NAN) != 0
        bad = bad_nan | ((c & C_GRAD_INF) != 0)
        val = torch.where(bad_nan, float("nan"), float("inf")).to(g.dtype)
        return _poison_first(g, bad, val)

    return tree_map(_one, grads)


def inject_activation(x, code):
    """Poison element 0 of an activation with NaN when ``C_ACT_NAN``."""
    c = _code(code, x.device)
    return _poison_first(x, (c & C_ACT_NAN) != 0, float("nan"))


# -- the host driver -----------------------------------------------------------

class ChaosHarness:
    """Applies a :class:`FaultPlan` to a training loop's host seams.

    ::

        harness = chaos.ChaosHarness(plan, rank=dist.get_rank())
        for step, (x, y) in enumerate(batches):
            x, y = harness.filter_batch(step, (x, y))
            code = harness.fault_code(step)
            state, gs, loss = train_step(state, gs, x, y, code)
            state = harness.post_step(step, state, ckpt_root=root)

    Host injections are a pure function of ``(plan, step, rank)`` —
    the corrupt-batch noise derives its RandomState from
    ``plan.seed ^ step``, never from consumed global RNG.
    """

    def __init__(self, plan: FaultPlan, *, rank: int = 0):
        self.plan = plan
        self.rank = int(rank)
        #: host log of injections performed: (step, site, kind)
        self.injected: list = []

    def _note(self, step, f: Fault):
        self.injected.append((int(step), f.site, f.kind))

    def fault_code(self, step: int) -> int:
        code = self.plan.fault_code(step, self.rank)
        for site in ("grads", "activations"):
            f = self.plan.at(step, self.rank, site)
            if f is not None:
                self._note(step, f)
        return code

    def filter_batch(self, step: int, batch):
        """Apply any ``batch``-site fault to an ``(x, y, ...)`` tuple whose
        first element is a host numpy array (or a tensor, poisoned through
        the host and returned on its device); returns the (possibly
        poisoned) batch."""
        f = self.plan.at(step, self.rank, "batch")
        if f is None:
            return batch
        like = batch[0]
        x = (like.detach().cpu().numpy().copy()
             if isinstance(like, torch.Tensor) else np.array(like, copy=True))
        if f.kind == "nan":
            x.reshape(-1)[0] = np.nan
        elif f.kind == "inf":
            x.reshape(-1)[0] = np.inf
        elif f.kind == "corrupt":
            amp = f.arg or 1e4
            rng = np.random.RandomState((self.plan.seed ^ step)
                                        & 0x7FFFFFFF)
            x = rng.uniform(-amp, amp, x.shape).astype(x.dtype)
        elif f.kind == "overflow":
            x = x * np.asarray(f.arg or 1e30, x.dtype)
        self._note(step, f)
        if isinstance(like, torch.Tensor):
            x = torch.as_tensor(x, dtype=like.dtype).to(like.device)
        return (x,) + tuple(batch[1:])

    def post_step(self, step: int, state, *, ckpt_root: Optional[str]
                  = None, membership=None):
        """Apply after-the-commit faults: param corruption, a stalled
        collective, SIGKILL, checkpoint truncation, cluster
        control-plane faults (``membership`` — a cluster membership
        object — is required when the plan carries a ``cluster`` fault).
        Returns the (possibly corrupted) state tree."""
        f = self.plan.at(step, self.rank, "cluster")
        if f is not None:
            if membership is None:
                raise ValueError("cluster fault planned but post_step "
                                 "got no membership")
            self._note(step, f)
            if f.kind == "lease_expire":
                membership.lease.expire_now()
            elif f.kind == "split_brain":
                # claim (locally!) an epoch the cluster never committed
                # — downstream fences/intent verification must refuse
                membership.claim_generation(
                    membership.generation + (int(f.arg) or 1))
            else:                       # zombie_resume
                # pause self; the DRIVER escalates + relaunches around
                # the pause and SIGCONTs this process into a zombie
                os.kill(os.getpid(), signal.SIGSTOP)
        f = self.plan.at(step, self.rank, "params")
        if f is not None:
            state = self._corrupt_params(state, f)
            self._note(step, f)
        f = self.plan.at(step, self.rank, "collective")
        if f is not None:
            self._note(step, f)
            time.sleep(float(f.arg or 1.0))
        f = self.plan.at(step, self.rank, "ckpt")
        if f is not None:
            if ckpt_root is None:
                raise ValueError("ckpt fault planned but post_step got "
                                 "no ckpt_root")
            self._note(step, f)
            self.truncate_latest_checkpoint(ckpt_root)
        f = self.plan.at(step, self.rank, "proc")
        if f is not None:
            self._note(step, f)
            os.kill(os.getpid(), signal.SIGKILL)
        return state

    # -- host corruption mechanics --------------------------------------------

    #: mantissa widths (bits 0..m-1 never touch the exponent, so a finite
    #: value STAYS finite after a flip there)
    _MANTISSA = {torch.float64: 52, torch.float32: 23, torch.float16: 10,
                 torch.bfloat16: 7, torch.float8_e4m3fn: 3,
                 torch.float8_e5m2: 2}

    @classmethod
    def _mantissa_bits(cls, dtype) -> Optional[int]:
        """The dtype's mantissa width (f32: 23, f16: 10, bf16: 7)."""
        return cls._MANTISSA.get(dtype)

    @staticmethod
    def _flip(flat: torch.Tensor, bit: int) -> None:
        """XOR bit ``bit`` of element 0's pattern, in place, on the
        device."""
        from apex_tpu_torch.utils.bits import uint_view_dtype
        iv = flat[:1].view(uint_view_dtype(flat.dtype))
        width = 8 * iv.dtype.itemsize
        if flat.dtype.itemsize == 8:         # the high lane holds bits 32+
            iv = flat[:1].view(torch.int32)[1:] if bit >= 32 else iv[:1]
            bit %= 32
        mask = 1 << bit
        if iv.dtype != torch.uint8 and bit == width - 1:
            mask -= 1 << width               # the sign bit of a signed view
        iv.bitwise_xor_(mask)

    @classmethod
    def _corrupt_params(cls, state, f: Fault):
        """Poison element 0 of the FIRST float leaf (the tree's own order,
        deterministic under a fixed structure): NaN, a bit flip of its
        pattern (``arg`` = bit index, default 30 — an f32's top exponent
        bit; other dtypes take ``-x · 3.4e38``, as in the JAX package), or
        a MANTISSA-only flip (``bitflip_mantissa``: ``arg`` taken
        mod the dtype's mantissa width, so the value stays finite — silent
        to the nonfinite-param probe, the class the integrity fingerprints
        exist for). A new tensor replaces the leaf; nothing is read back
        to the host."""
        from apex_tpu_torch.ckpt.snapshot import map_with_paths
        done = [False]

        def one(_path, leaf):
            if (done[0] or not isinstance(leaf, torch.Tensor)
                    or not leaf.is_floating_point() or leaf.numel() == 0):
                return leaf
            done[0] = True
            new = leaf.detach().clone()
            # a one-element view of element 0 (a conv weight kept in a
            # permuted layout has no flat view)
            flat = new[(0,) * new.dim()].view(1)
            if f.kind == "nan":
                flat[:1] = float("nan")
            elif f.kind == "bitflip_mantissa":
                cls._flip(flat, int(f.arg) % cls._mantissa_bits(new.dtype))
            elif new.dtype == torch.float32:
                cls._flip(flat, int(f.arg) or 30)
            else:                  # as the JAX package: a huge, flipped value
                flat[:1] = -flat[:1] * 3.4e38
            return new

        return map_with_paths(one, state)

    @staticmethod
    def truncate_latest_checkpoint(root: str) -> Optional[str]:
        """Truncate the newest committed checkpoint's largest data file
        to half — the manifest hash no longer matches, so a restore of
        this checkpoint must refuse (and a guard rewind falls back to
        the previous one). Returns the truncated path."""
        from apex_tpu_torch.ckpt import format as _fmt
        d = _fmt.latest_checkpoint(root)
        if d is None:
            return None
        npz = [os.path.join(d, n) for n in os.listdir(d)
               if n.endswith(".npz")]
        if not npz:
            return None
        target = max(npz, key=os.path.getsize)
        size = os.path.getsize(target)
        with open(target, "r+b") as fh:
            fh.truncate(max(size // 2, 1))
        return target
