"""Declarative registry of every collective scope the port emits.

Port of ``apex_tpu/parallel/registry.py``, pure Python: one table whose
rows name the scope a planned collective runs under, the mesh axis it
communicates over and the subsystem that owns it. In the port the scope is
the ``torch.profiler.record_function`` name around the collective
(``parallel.collectives``), so a profiler trace attributes each
collective to its row; ``distributed.KNOWN_COLLECTIVE_SCOPES`` is the flat
view of the patterns. One row is the port's own (``PORT_ONLY_PATTERNS``):
``zero/grad_norm``, the ZeRO norm sums, which the JAX package runs
unscoped.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence, Tuple

from apex_tpu_torch.parallel.mesh import (DATA_AXIS, DATA_INTER_AXIS,
                                    DATA_INTRA_AXIS, SEQ_AXIS)

__all__ = ["CollectiveScope", "COLLECTIVE_SCOPES", "PORT_ONLY_PATTERNS",
           "known_patterns", "scope_axis", "scope_entry"]


@dataclasses.dataclass(frozen=True)
class CollectiveScope:
    """One planned collective family: where it runs, over which axis."""

    pattern: str      # regex fragment matched against the scope path
    axis: str         # canonical mesh-axis name it communicates over
    subsystem: str    # owning subsystem (ddp, zero, sync_batchnorm, ...)
    description: str  # one-line: what the collective does


#: every collective this package deliberately emits runs under a scope
#: matching one row (the first match wins)
COLLECTIVE_SCOPES: Tuple[CollectiveScope, ...] = (
    # hop sub-spans of the hierarchical schedule FIRST: scope_entry
    # returns the first match, and the hierarchical hops nest under
    # ddp/sync_gradients (``ddp/sync_gradients/bucketNN/ici``) — the
    # parent row would otherwise swallow the factored-axis attribution
    # (canonical names — a deployment using its mesh model's own axis
    # names still matches the pattern)
    CollectiveScope(r"(^|/)bucket\d+/ici", DATA_INTRA_AXIS, "ddp",
                    "hierarchical sync within-slice hop (reduce-"
                    "scatter / all-gather over ICI)"),
    CollectiveScope(r"(^|/)bucket\d+/dcn", DATA_INTER_AXIS, "ddp",
                    "hierarchical sync cross-slice hop (one-member-"
                    "per-slice reduce over DCN)"),
    # dynamics sub-spans BEFORE the parent sync row for the same
    # first-match reason: a probe called inside the sync scope nests as
    # ``ddp/sync_gradients/…/dynamics_gns`` and the parent pattern
    # would swallow it
    CollectiveScope(r"ddp/dynamics_gns", DATA_AXIS, "ddp",
                    "gradient-noise-scale probe: one scalar psum of "
                    "the per-replica squared grad norm "
                    "(apex_tpu_torch.monitor.dynamics)"),
    CollectiveScope(r"ddp/dynamics_geom", DATA_AXIS, "ddp",
                    "replica-gradient geometry probe: all-gather of "
                    "the per-replica [|g_i|^2, g_i.gbar] scalar pair "
                    "(cosine spectrum + Adasum projection "
                    "coefficients)"),
    CollectiveScope(r"ddp/sync_gradients", DATA_AXIS, "ddp",
                    "gradient all-reduce across the data axis"),
    CollectiveScope(r"(^|/)bucket\d+", DATA_AXIS, "ddp",
                    "per-bucket overlapped all-reduce sub-spans"),
    CollectiveScope(r"ddp/loss_pmean", DATA_AXIS, "ddp",
                    "cross-replica loss averaging for the logged "
                    "metric"),
    CollectiveScope(r"(?i)sync_?batch_?norm", DATA_AXIS,
                    "sync_batchnorm",
                    "cross-replica batch-norm statistics psums"),
    CollectiveScope(r"zero/(grad_scatter|param_gather)", DATA_AXIS,
                    "zero",
                    "ZeRO gradient reduce-scatter / parameter "
                    "all-gather"),
    # the port's own row: the JAX package issues these psums of the ZeRO
    # optimizers outside any span (apex_tpu/optim/distributed.py:260-263,
    # 334-336), and every port collective needs a scope
    CollectiveScope(r"zero/grad_norm", DATA_AXIS, "zero",
                    "ZeRO sharded-norm sums: the global grad norm of the "
                    "clip and LAMB's per-tensor norms (unscoped in the "
                    "JAX package)"),
    CollectiveScope(r"guard/integrity_(check|repair)", DATA_AXIS,
                    "guard",
                    "cross-replica integrity fingerprint compare "
                    "(pmin/pmax/all-gather of one uint32 scalar) and "
                    "the in-place repair bit-pattern broadcast"),
    CollectiveScope(r"(^|/)ring_", SEQ_AXIS, "ring_attention",
                    "ring/Ulysses sequence-parallel attention "
                    "permutes and all-to-alls"),
)


#: patterns of the rows the JAX package's table does not have
PORT_ONLY_PATTERNS = (r"zero/grad_norm",)


def known_patterns() -> Tuple[str, ...]:
    """The regex fragments, in registry order (also
    ``parallel.distributed.KNOWN_COLLECTIVE_SCOPES``)."""
    return tuple(s.pattern for s in COLLECTIVE_SCOPES)


def scope_entry(scope: str,
                extra: Sequence[str] = ()) -> Optional[CollectiveScope]:
    """The registry row a scope path matches, or None. ``extra`` patterns
    match as anonymous rows with no axis attribution."""
    for entry in COLLECTIVE_SCOPES:
        if re.search(entry.pattern, scope):
            return entry
    for pat in extra:
        if re.search(pat, scope):
            return CollectiveScope(pat, "", "user", "caller-supplied "
                                   "known_scopes= pattern")
    return None


def scope_axis(scope: str) -> Optional[str]:
    """Canonical mesh axis a planned collective scope communicates
    over, or None for an unknown scope."""
    entry = scope_entry(scope)
    return entry.axis if entry is not None else None
