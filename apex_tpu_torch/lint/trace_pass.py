"""The trace half of apexlint: rules on the record of one run.

The port of ``apex_tpu/lint/jaxpr_pass.py``, renamed because the port has
no jaxpr: it reads a :class:`~apex_tpu_torch.lint.record.StepRecord`
(:func:`~apex_tpu_torch.lint.record.record_step`). Each rule keeps its JAX
evidence where the record gives the same:

- **rng-key-reuse** (APX001): two or more random draws from the same
  generator state — a generator re-seeded with the same seed, or two
  generators at the same (seed, offset). A flash call's dropout seed is an
  int32 tensor drawn once; its forward and backward both read it, as a
  JAX kernel reads ``random_bits``' output, and that is not a reuse.
- **f64-creep** (APX002): a float64 carried input or op output.
- **fp32-matmul-in-amp** (APX003): an all-f32 ``mm``/``addmm``/``bmm``/
  ``baddbmm``/``convolution`` (or a hand kernel that multiplies in f32)
  under an enabled half policy; a half-in, f32-out product is fine.
- **host-callback-in-step** (APX004): every host sync of the record, by
  :func:`apex_tpu_torch.monitor.check.host_sync` — an op of
  ``HOST_SYNC_OPS`` or a card-to-host copy. Eager PyTorch traces no Python
  callback: the one way a step round-trips to the host is a sync.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from apex_tpu_torch.lint.findings import Finding
from apex_tpu_torch.lint.record import Lit, StepRecord

__all__ = ["lint_trace", "MATMUL_OPS", "KERNEL_MATMULS"]

#: the aten ops of the matmul class (JAX: dot_general,
#: conv_general_dilated), by overload packet
MATMUL_OPS = frozenset({
    "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
    "aten::convolution", "aten::convolution_backward", "aten::_convolution",
    "aten::_scaled_mm",
})
#: hand kernels whose arithmetic is products (attention, the fused MLP)
KERNEL_MATMULS = frozenset({
    "flash_attn_fwd", "flash_attn_bwd", "flash_generic_fwd",
    "flash_generic_bwd", "mlp_fwd",
})
_HALF = (torch.float16, torch.bfloat16)


def packet(op: str) -> str:
    """``aten::mm.default`` -> ``aten::mm``."""
    return op.rsplit(".", 1)[0] if op.startswith("aten::") else op


def _float_dtypes(record: StepRecord, node) -> List[torch.dtype]:
    return [record.values[v].dtype for v in node.tensor_operands
            if record.values[v].dtype.is_floating_point]


def _rng_reuse(record: StepRecord, out: List[Finding]) -> None:
    by_state: Dict[Tuple, List] = {}
    for n in record.nodes:
        if n.draw is not None:
            by_state.setdefault(n.draw.state, []).append(n)
    for state, nodes in by_state.items():
        if len(nodes) < 2:
            continue
        who = [packet(n.op) for n in nodes]
        gens = sorted({n.draw.generator for n in nodes})
        out.append(Finding(
            rule="rng-key-reuse",
            message=f"generator state {state[1:]} on {state[0]} feeds "
                    f"{len(nodes)} random draws ({', '.join(gens)}): "
                    f"{', '.join(who[:4])}",
            op="/".join(who[:4]), scope=", ".join(gens),
            count=len(nodes)))


def _f64_creep(record: StepRecord, out: List[Finding]) -> None:
    hits: Dict[str, int] = {}
    for v in record.inputs:
        if record.values[v].dtype == torch.float64:
            hits["<argument>"] = hits.get("<argument>", 0) + 1
    for n in record.nodes:
        if any(record.values[v].dtype == torch.float64 for v in n.outputs):
            key = packet(n.op)
            hits[key] = hits.get(key, 0) + 1
    if hits:
        total = sum(hits.values())
        ops = ", ".join(sorted(hits)[:5])
        out.append(Finding(
            rule="f64-creep",
            message=f"{total} f64-producing op(s) in the step "
                    f"(ops: {ops})", op=ops, count=total))


def _multiplies_in_f32(record: StepRecord, node) -> bool:
    ins = _float_dtypes(record, node)
    if not ins or any(d != torch.float32 for d in ins):
        return False
    if node.kind == "kernel":
        # a half operand mode (mlp_fwd's operand_dtype) multiplies in half
        lits = [o.value for o in node.operands if isinstance(o, Lit)]
        lits += list(node.kwargs.values())
        return not any(d in _HALF for d in lits
                       if isinstance(d, torch.dtype))
    outs = [record.values[v].dtype for v in node.outputs
            if record.values[v].dtype.is_floating_point]
    return all(d == torch.float32 for d in outs)


def _fp32_matmul(record: StepRecord, policy, out: List[Finding]) -> None:
    if policy is None or not getattr(policy, "enabled", False):
        return
    compute = getattr(policy, "compute_dtype", None)
    if compute not in _HALF:
        return
    hits: Dict[str, int] = {}
    for n in record.nodes:
        op = packet(n.op)
        if n.kind == "kernel" and op not in KERNEL_MATMULS:
            continue
        if n.kind == "aten" and op not in MATMUL_OPS:
            continue
        if _multiplies_in_f32(record, n):
            key = f"{n.phase}/{op}"
            hits[key] = hits.get(key, 0) + 1
    for where, n in sorted(hits.items()):
        out.append(Finding(
            rule="fp32-matmul-in-amp",
            message=f"{n} all-fp32 matmul(s) under an active "
                    f"{str(compute).replace('torch.', '')} policy at "
                    f"{where}",
            op=where.rsplit("/", 1)[-1], scope=where, count=n))


def _host_syncs(record: StepRecord, out: List[Finding]) -> None:
    hits: Dict[str, Tuple[int, str]] = {}
    for n in record.nodes:
        if n.host_sync is not None:
            key = packet(n.op)
            count, phase = hits.get(key, (0, n.phase))
            hits[key] = (count + 1, phase)
    for op, (count, phase) in sorted(hits.items()):
        out.append(Finding(
            rule="host-callback-in-step",
            message=f"{count} host sync(s) ({op}) in the step",
            op=op, scope=phase, count=count))


def lint_trace(record: StepRecord, *, policy=None) -> List[Finding]:
    """Run the trace rules over one :class:`StepRecord`. ``policy`` is the
    :class:`apex_tpu_torch.amp.Policy` the step runs under; the
    fp32-matmul rule only activates for a half-precision policy."""
    out: List[Finding] = []
    _rng_reuse(record, out)
    _f64_creep(record, out)
    _fp32_matmul(record, policy, out)
    _host_syncs(record, out)
    return out
