"""The scope→axis and scope→hop joins of collective accounting.

The first part of the port of ``apex_tpu/monitor/collectives.py``: the
two classifiers every per-axis and per-hop consumer shares —
:func:`scope_axis_row` (the goodput ledger's ``comm_axes_ms`` split) and
:func:`scope_hop` (the hierarchical sync's ``bucketNN/ici|dcn`` sub-span
convention). The byte half of that module — per-opcode, per-dtype,
per-hop and per-axis collective bytes of a step, and ``wire_report`` —
reads the compiled program and waits for ROADMAP.md queue A, item 11
part 2.
"""

from __future__ import annotations

import re

__all__ = ["scope_hop", "scope_axis_row"]

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
