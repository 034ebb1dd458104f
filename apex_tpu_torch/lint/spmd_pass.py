"""The cross-rank half of apexlint — so far its one rule that needs no mesh.

The port of ``apex_tpu/lint/spmd_pass.py``'s **nondeterminism** (APX204)
detectors, :func:`nondeterminism_findings` (JAX:
``nondeterminism_jaxpr_findings`` / ``_nondet_walk``), over the record of
one run (:mod:`apex_tpu_torch.lint.record`). The same three classes, each
a thing guard's bitwise rewind-and-replay cannot replay:

- a draw with no replayable stream: a random op on the default generator
  (no ``generator=``), or on a generator made inside the step (seeded from
  a value the step fixes, so every step draws the same bits);
- a host value on the commit path: the result of an op of
  ``monitor.check.HOST_SYNC_OPS`` that feeds a committed output — a
  tensor result by the record's dataflow, a Python scalar (``.item()``)
  by its value reappearing as a literal operand on the path;
- a float accumulate whose order the card does not fix: ``index_add``,
  ``scatter_add``, ``scatter_reduce``, ``index_put(accumulate=True)`` and
  ``embedding_dense_backward`` on a float tensor, as a warning (integer
  accumulates, such as the numerics fold's int32 ``index_add_``, are
  exact in any order and exempt, as the JAX rule exempts non-floats).

The schedule, congruence and mesh rules (APX201–203) read the collective
ledger, which ROADMAP item 12b brings.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from apex_tpu_torch.lint.findings import Finding
from apex_tpu_torch.lint.record import Lit, StepRecord
from apex_tpu_torch.lint.trace_pass import packet

__all__ = ["nondeterminism_findings", "FLOAT_ACCUMULATES"]

#: ops that add into a tensor at data-dependent positions: on the card
#: their atomics leave the order of equal-index additions to the schedule
FLOAT_ACCUMULATES = frozenset({
    "aten::index_add", "aten::index_add_", "aten::scatter_add",
    "aten::scatter_add_", "aten::scatter_reduce", "aten::scatter_reduce_",
    "aten::index_put", "aten::index_put_", "aten::_index_put_impl_",
    "aten::put", "aten::put_", "aten::embedding_dense_backward",
    "aten::index_reduce", "aten::index_reduce_",
})
_ACCUMULATE_FLAG = frozenset({"aten::index_put", "aten::index_put_",
                              "aten::_index_put_impl_", "aten::put",
                              "aten::put_"})


def _on_commit_path(record: StepRecord) -> Tuple[Set[int], Set[int]]:
    """(vids, node indices) that feed the committed outputs."""
    needed: Set[int] = set(record.outputs)
    nodes: Set[int] = set()
    for n in reversed(record.nodes):
        made = set(n.outputs) | {new for _old, new in n.writes}
        if made & needed:
            nodes.add(n.index)
            needed.update(n.tensor_operands)
    return needed, nodes


def _fold(hits: Dict[Tuple, List], rule_args) -> List[Finding]:
    out = []
    for key, nodes in sorted(hits.items()):
        out.append(Finding(count=len(nodes), **rule_args(key, nodes)))
    return out


def nondeterminism_findings(record: StepRecord) -> List[Finding]:
    """APX204 over one :class:`StepRecord` — see the module docstring for
    the three detector classes. Findings fold by op and phase."""
    out: List[Finding] = []
    needed, path_nodes = _on_commit_path(record)

    draws: Dict[Tuple, List] = {}
    for n in record.nodes:
        if n.draw is not None and (n.draw.default or n.draw.made_in_step):
            why = ("the default generator" if n.draw.default else
                   "a generator made inside the step")
            draws.setdefault((packet(n.op), n.phase, why), []).append(n)
    out += _fold(draws, lambda k, ns: dict(
        rule="nondeterminism", op=k[0], scope=k[1],
        message=f"{k[0]} draws from {k[2]} ({ns[0].draw.generator}) — "
                "the stream cannot be replayed after a guard rewind"))

    syncs: Dict[Tuple, List] = {}
    for n in record.nodes:
        if n.host_sync is None:
            continue
        feeds = bool(set(n.outputs) & needed)
        if (not feeds and n.scalar_out is not None
                and not isinstance(n.scalar_out, bool)):
            val = n.scalar_out
            feeds = any(isinstance(o, Lit) and type(o.value) is type(val)
                        and o.value == val
                        for i in path_nodes
                        for o in record.nodes[i].operands)
        if feeds:
            syncs.setdefault((packet(n.op), n.phase), []).append(n)
    out += _fold(syncs, lambda k, ns: dict(
        rule="nondeterminism", op=k[0], scope=k[1],
        message=f"{k[0]}'s host value feeds the committed step outputs "
                "— host values on the commit path re-run differently on "
                "rewind/replay"))

    accs: Dict[Tuple, List] = {}
    for n in record.nodes:
        op = packet(n.op)
        if n.kind != "aten" or op not in FLOAT_ACCUMULATES:
            continue
        if op in _ACCUMULATE_FLAG and not n.kwargs.get("accumulate"):
            continue
        ops = n.tensor_operands
        if ops and record.values[ops[0]].dtype.is_floating_point:
            accs.setdefault((op, n.phase), []).append(n)
    out += _fold(accs, lambda k, ns: dict(
        rule="nondeterminism", severity="warning", op=k[0], scope=k[1],
        message=f"float {k[0]} — the order of equal-index additions is "
                "the card's schedule's, not the step's"))
    return out
