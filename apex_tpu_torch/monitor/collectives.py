"""Per-step collective-traffic accounting, from the port's collective ledger.

The port of ``apex_tpu/monitor/collectives.py``. The JAX package reads a
step's collectives off its compiled HLO: every one is an instruction with
a typed result shape. Eager PyTorch compiles no program; every collective
of the port goes through :mod:`apex_tpu_torch.parallel.collectives`
instead, which adds each call's result bytes to ``bytes_by`` by (opcode,
dtype, scope). This module runs a step once and reads that ledger:

- :func:`collective_bytes` — ``{opcode: bytes, ..., "total": bytes}``,
  the opcodes spelled as HLO spells them (``all-reduce``,
  ``reduce-scatter``, ``all-gather``, ``all-to-all``,
  ``collective-permute``, ``collective-broadcast``);
- :func:`collective_bytes_by_dtype` / ``_by_hop`` / ``_by_axis`` — the
  same bytes split per wire dtype, per link hop (:func:`scope_hop`: the
  hierarchical sync's ``bucketNN/ici|dcn`` scopes) and per mesh axis
  (:func:`scope_axis_row`, through the collective registry);
- :func:`wire_report` — wire against logical bytes of one step.

Bytes are **result** bytes, as the JAX package counts them: an all-reduce
counts its buffer, an all-gather its gathered output, a reduce-scatter
its shard. One difference: the JAX package counts an instruction once, so
a collective inside a loop counts once a step there; the port counts
every call it makes, so each iteration's collective counts.

``collective_bytes_from_text`` and its HLO row parser have no counterpart:
the port produces no HLO text to parse (ROADMAP.md lists the rule).
"""

from __future__ import annotations

import collections
import re
from typing import Dict, Optional

__all__ = ["COLLECTIVE_OPCODES", "collective_bytes",
           "collective_bytes_by_dtype", "collective_bytes_by_hop",
           "collective_bytes_by_axis", "ledger_counts", "scope_hop",
           "scope_axis_row", "wire_report"]

#: the opcodes the ledger counts under (the JAX package's prefix list,
#: less ``ragged-all-to-all``, which the port never calls)
COLLECTIVE_OPCODES = ("all-reduce", "all-gather", "reduce-scatter",
                      "all-to-all", "collective-permute",
                      "collective-broadcast")

#: hop classification of a collective's scope: the hierarchical sync
#: nests each hop under a ``bucketNN/ici`` or ``bucketNN/dcn`` sub-span
#: (:mod:`apex_tpu_torch.parallel.hierarchy`). Everything else — the flat
#: sync's whole traffic included — lands in ``"unattributed"``.
_HOP_RES = (("dcn", re.compile(r"(^|/)dcn(/|$)")),
            ("ici", re.compile(r"(^|/)ici(/|$)")))


def scope_hop(scope: str) -> str:
    """Link-hop class of a collective scope — the ONE classifier for the
    ``bucketNN/ici|dcn`` sub-span convention."""
    for hop, rx in _HOP_RES:
        if rx.search(scope):
            return hop
    return "unattributed"


def scope_axis_row(scope: str) -> str:
    """Mesh-axis attribution row of a collective scope: the
    :func:`apex_tpu_torch.parallel.registry.scope_axis` answer, or the
    explicit ``"unknown"`` row for a scope the registry doesn't know.
    The ONE scope→axis join every per-axis consumer shares; the registry
    stays the single source, and unattributable time lands in a visible
    row, never silently dropped."""
    from apex_tpu_torch.parallel import registry
    axis = registry.scope_axis(scope)
    return axis if axis else "unknown"


def ledger_counts(fn, *args, **kwargs) -> collections.Counter:
    """Run ``fn(*args, **kwargs)`` once and return the collective bytes
    its calls added, ``{(opcode, dtype, scope): bytes}``."""
    from apex_tpu_torch.parallel import collectives
    before = collections.Counter(collectives.bytes_by)
    fn(*args, **kwargs)
    return collections.Counter(collectives.bytes_by) - before


def _rows(fn, args, kwargs, counts):
    if counts is None:
        if fn is None:
            raise ValueError("pass a step function or counts=")
        counts = ledger_counts(fn, *args, **kwargs)
    return [(op, dt, n, scope) for (op, dt, scope), n in counts.items()]


def _split(rows, key) -> Dict[str, Dict[str, int]]:
    out: Dict[str, Dict[str, int]] = {}
    for op, dt, n, scope in rows:
        slot = out.setdefault(key(op, scope), {})
        slot[dt] = slot.get(dt, 0) + n
    return out


def collective_bytes_by_dtype(fn=None, *args, counts=None,
                              **kwargs) -> Dict[str, Dict[str, int]]:
    """Collective result bytes per opcode, split per wire dtype:
    ``{opcode: {dtype: bytes}}``. A ``compress="bf16"`` sync shows its
    traffic under ``{"all-reduce": {"bf16": ...}}`` while the logical
    gradient is f32. ``counts`` takes a :func:`ledger_counts` result in
    place of running ``fn``."""
    return _split(_rows(fn, args, kwargs, counts), lambda op, _s: op)


def collective_bytes_by_hop(fn=None, *args, counts=None,
                            **kwargs) -> Dict[str, Dict[str, int]]:
    """Collective result bytes per link hop (``"ici"`` | ``"dcn"`` |
    ``"unattributed"``), split per wire dtype: a hierarchical step shows
    its per-hop dtype split, a flat sync reports everything
    ``unattributed``."""
    return _split(_rows(fn, args, kwargs, counts),
                  lambda _op, scope: scope_hop(scope))


def collective_bytes_by_axis(fn=None, *args, counts=None,
                             **kwargs) -> Dict[str, Dict[str, int]]:
    """Collective result bytes per mesh axis (``"unknown"`` for a scope
    outside the registry), split per wire dtype."""
    return _split(_rows(fn, args, kwargs, counts),
                  lambda _op, scope: scope_axis_row(scope))


def wire_report(fn=None, *args, counts=None,
                logical_bytes: Optional[int] = None, **kwargs) -> Dict:
    """Logical-vs-wire collective accounting of one step, from one run::

        {"wire_bytes": int, "by_opcode": {op: {dtype: bytes}},
         "by_hop": {hop: {dtype: bytes}},
         "by_axis": {axis: {dtype: bytes}},
         "logical_bytes": int | None, "wire_to_logical": float | None}

    ``logical_bytes`` is the uncompressed payload the step semantically
    moves (``4 * n_params`` for an f32 grad sync); a
    ``compress="bf16"`` sync reports ``wire_to_logical`` ≈ 0.5."""
    rows = _rows(fn, args, kwargs, counts)
    by_op = _split(rows, lambda op, _s: op)
    wire = sum(b for per in by_op.values() for b in per.values())
    return {"wire_bytes": wire, "by_opcode": by_op,
            "by_hop": _split(rows, lambda _op, scope: scope_hop(scope)),
            "by_axis": _split(rows,
                              lambda _op, scope: scope_axis_row(scope)),
            "logical_bytes": logical_bytes,
            "wire_to_logical": (wire / logical_bytes) if logical_bytes
            else None}


def collective_bytes(fn=None, *args, counts=None,
                     **kwargs) -> Dict[str, int]:
    """Per-step collective result bytes by opcode, plus ``"total"``: runs
    ``fn(*args, **kwargs)`` once (or reads ``counts``)."""
    totals = {op: sum(per.values()) for op, per in
              collective_bytes_by_dtype(fn, *args, counts=counts,
                                        **kwargs).items()}
    totals["total"] = sum(totals.values())
    return totals
