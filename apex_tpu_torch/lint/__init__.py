"""apexlint for the port — static rules over the record of one step.

The port of ``apex_tpu/lint``. The JAX lint reads ``jax.make_jaxpr``'s
trace and the compiled module's HLO text, strictly ahead of time. The port
has no HLO and no trace its hand kernels appear in, so its lint reads a
**record of one run** (:func:`~apex_tpu_torch.lint.record.record_step`:
the step run once under a ``TorchDispatchMode``, each hand kernel one
node). That is the port's one departure from the JAX lint's contract:
``lint_step`` runs the step once, and leaves no trace of it — it puts back
every generator the run drew from and every pre-existing tensor the run
wrote in place, and drops the run's result, so the caller's state, its
generators and the next step are exactly what they would have been (the
``lint/no-extra-dispatch`` and ``lint/precision-no-extra-dispatch``
compile-check cases pin this bit for bit).

Passes over the one shared record:

- the **trace pass** (:mod:`.trace_pass`, the JAX ``jaxpr_pass``):
  generator-state reuse (APX001), f64 creep (APX002), f32 matmuls under a
  half policy (APX003), host syncs in the step (APX004);
- **nondeterminism** (APX204, :mod:`.spmd_pass`): draws with no
  replayable stream, host values on the commit path, float accumulates in
  an unfixed order;
- the **precision pass** (:mod:`.precision_pass`): unscaled narrow casts
  (APX301), double rounding (APX302), loss-scale taint in committed
  outputs (APX303), half update arithmetic under a master-weights policy
  (APX304), half accumulation (APX305).

The rules that read a compiled module in JAX (APX101–104, APX201–203,
APX306 and the precision pre-flight) wait for the evidence that replaces
the HLO (ROADMAP item 12b): their parameters raise
``NotImplementedError`` here rather than do nothing.

Typical use::

    report = lint.lint_step(step, state, toks, labels, policy=policy)
    print(report.table())
    assert not report.errors

:mod:`.mesh_model` is the mesh model ``parallel.hierarchy.plan_comm``
plans over.
"""

from __future__ import annotations

from typing import Optional, Sequence

from apex_tpu_torch.lint.findings import (  # noqa: F401
    DTYPE_NAMES, PROVENANCES, RULES, SEVERITIES, Finding, Report, Rule,
    load_baseline, save_baseline,
)
from apex_tpu_torch.lint.mesh_model import (  # noqa: F401
    LINK_CLASSES, MeshAxis, MeshModel, parse_mesh_spec,
)
from apex_tpu_torch.lint.precision_pass import (  # noqa: F401
    PrecisionAnalysis, analyze_record as precision_analysis,
    precision_findings,
)
from apex_tpu_torch.lint.record import StepRecord, record_step  # noqa: F401
from apex_tpu_torch.lint.spmd_pass import (  # noqa: F401
    nondeterminism_findings,
)
from apex_tpu_torch.lint.trace_pass import lint_trace  # noqa: F401

__all__ = ["Finding", "Report", "Rule", "RULES", "SEVERITIES",
           "DTYPE_NAMES", "PROVENANCES",
           "lint_step", "lint_trace", "record_step", "StepRecord",
           "load_baseline", "save_baseline",
           "MeshAxis", "MeshModel", "parse_mesh_spec", "LINK_CLASSES",
           "nondeterminism_findings",
           "PrecisionAnalysis", "precision_analysis", "precision_findings"]

#: trace-pass rule slugs; nondeterminism's detectors ride the same record
_TRACE_RULES = frozenset({"rng-key-reuse", "f64-creep",
                          "fp32-matmul-in-amp", "host-callback-in-step",
                          "nondeterminism"})
#: precision-pass rule slugs (APX306 waits for item 12b)
_PRECISION_RULES = frozenset({"unscaled-narrow-cast", "double-rounding",
                              "scale-leak", "master-weight-violation",
                              "half-accumulation"})
#: rules whose evidence (the compiled module in JAX) ROADMAP item 12b
#: brings to the port
_ITEM_12B_RULES = frozenset({"donation-miss", "implicit-resharding",
                             "host-transfer", "tile-padding",
                             "spmd-divergence", "implicit-full-gather",
                             "dcn-flat-collective", "wire-dtype-unsafe"})
_ITEM_12B = ("{} reads the compiled program's evidence, which the port's "
             "lint does not have yet (ROADMAP.md queue A, item 12b)")


def lint_step(fn, *args, policy=None, rules: Optional[Sequence[str]] = None,
              precision=None, record: Optional[StepRecord] = None,
              fn_name: Optional[str] = None, compiled=None, hlo_text=None,
              known_scopes=None, min_donation_bytes=None, mesh_model=None,
              per_rank_hlo=None, **kwargs) -> Report:
    """Lint one training step: runs ``fn(*args, **kwargs)`` once.

    One record of that run (:func:`record_step`) is shared by the trace
    pass, APX204 and the precision pass; ``record=`` takes one already made
    (the counterpart of the JAX ``jaxpr=``), and no record is made when the
    selected ``rules`` need none. ``policy`` (the step's
    :class:`apex_tpu_torch.amp.Policy`) activates the fp32-matmul rule and
    the policy-dependent precision rules; ``precision=False`` turns the
    precision pass off.

    The run leaves no trace: the caller gets back its arguments, its
    generators and every pre-existing tensor the step wrote in place
    exactly as they were, and the step's result is dropped, so the next
    step is the one it would have been.

    The JAX ``lint_step``'s compiled-program parameters (``compiled=``,
    ``hlo_text=``, ``known_scopes=``, ``min_donation_bytes=``,
    ``mesh_model=``, ``per_rank_hlo=``, and ``precision=`` given a measured
    report) and the rules that read them raise ``NotImplementedError``
    until ROADMAP item 12b.
    """
    for name, val in (("compiled=", compiled), ("hlo_text=", hlo_text),
                      ("known_scopes=", known_scopes),
                      ("min_donation_bytes=", min_donation_bytes),
                      ("mesh_model=", mesh_model),
                      ("per_rank_hlo=", per_rank_hlo)):
        if val is not None:
            raise NotImplementedError(_ITEM_12B.format(f"lint_step({name})"))
    if precision is not None and precision is not False:
        raise NotImplementedError(_ITEM_12B.format(
            "lint_step(precision=<a precision report>) (APX306)"))
    rule_set = None if rules is None else set(rules)
    if rule_set is not None:
        unknown = rule_set - set(RULES)
        if unknown:
            raise ValueError(f"unknown lint rules {sorted(unknown)}")
        waiting = rule_set & _ITEM_12B_RULES
        if waiting:
            raise NotImplementedError(_ITEM_12B.format(
                f"rules {sorted(waiting)}"))
    want_trace = rule_set is None or bool(_TRACE_RULES & rule_set)
    want_precision = precision is not False and (
        rule_set is None or bool(_PRECISION_RULES & rule_set))
    if record is None and fn is not None and (want_trace or want_precision):
        record = record_step(fn, *args, fn_name=fn_name, **kwargs)
    findings = []
    if record is not None and want_trace:
        findings += lint_trace(record, policy=policy)
        if rule_set is None or "nondeterminism" in rule_set:
            findings += nondeterminism_findings(record)
    if record is not None and want_precision:
        findings += precision_findings(record, policy=policy)
    if rule_set is not None:
        findings = [f for f in findings if f.rule in rule_set]
    if fn_name is None:
        if fn is not None:
            fn_name = getattr(fn, "__name__", None) or type(fn).__name__
        elif record is not None:
            fn_name = record.fn_name
    return Report(findings, fn_name=fn_name)
