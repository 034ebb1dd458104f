"""apex_tpu_torch.prof — profiling, the port of ``apex_tpu/prof``.

- :mod:`~apex_tpu_torch.prof.annotate` — ``scope`` (``record_function``
  + NVTX), ``annotate`` (a trace span) and ``annotate_modules`` (global
  ``nn.Module`` hooks recording each call's shapes, removed on exit);
- :mod:`~apex_tpu_torch.prof.xplane` — the ``torch.profiler`` Chrome-trace
  parser: device kernels tied to the ops and ranges that launched them;
- :mod:`~apex_tpu_torch.prof.cost` — FLOPs and bytes of one run: aten ops
  by a dispatch-mode counter, the hand kernels by a cost registry;
- :mod:`~apex_tpu_torch.prof.report` — the card's peaks, the guarded
  profiler session and ``profile_step`` (capture, parse, MFU);
- :mod:`~apex_tpu_torch.prof.memory` — device-memory attribution by class,
  peak-live estimate and batch forecast, from one tracked run;
- :mod:`~apex_tpu_torch.prof.compile_watch` — nvcc/Triton/torch.compile
  counters and the new-signature detector feeding goodput's ``recompile``;
- :mod:`~apex_tpu_torch.prof.roofline` — per-op measured vs attainable
  time, families, ``worst_gaps`` and the what-if dtype column;
- :mod:`~apex_tpu_torch.prof.sentinel` — the bench-trajectory regression
  gate (a copy of the JAX package's);
- :mod:`~apex_tpu_torch.prof.sharding` — per-mesh-axis attribution from
  the ZeRO shard plan.

``python -m apex_tpu_torch.prof <trace dir>`` prints a trace's kernel
table.
"""

from apex_tpu_torch.prof.annotate import (CallRecord, annotate,
                                          annotate_modules, scope)
from apex_tpu_torch.prof.compile_watch import (CompileWatcher, FunctionWatch,
                                               autotune_scope,
                                               global_counters)
from apex_tpu_torch.prof.cost import (CostCounter, OpEstimate, cost_analysis,
                                      op_estimates)
from apex_tpu_torch.prof.memory import (BufferRecord, MemoryReport,
                                        device_memory_sample, hbm_capacity,
                                        memory_report)
from apex_tpu_torch.prof.report import (PEAK_FLOPS, PEAK_HBM_BW, StepReport,
                                        device_ms, device_peak_flops,
                                        device_peak_hbm_bw, profile_step,
                                        trace)
from apex_tpu_torch.prof.roofline import (RooflineReport, RooflineRow,
                                          roofline_report)
from apex_tpu_torch.prof.sharding import (ShardRecord, ShardReport,
                                          shard_report)
from apex_tpu_torch.prof.xplane import (OpRecord, TraceProfile,
                                        device_kernels, parse_trace)

__all__ = [
    "CallRecord", "annotate", "annotate_modules", "scope",
    "CostCounter", "OpEstimate", "cost_analysis", "op_estimates",
    "PEAK_FLOPS", "PEAK_HBM_BW", "StepReport", "device_ms",
    "device_peak_flops", "device_peak_hbm_bw", "profile_step", "trace",
    "OpRecord", "TraceProfile", "device_kernels", "parse_trace",
    "MemoryReport", "BufferRecord", "memory_report", "hbm_capacity",
    "device_memory_sample",
    "CompileWatcher", "FunctionWatch", "autotune_scope", "global_counters",
    "RooflineReport", "RooflineRow", "roofline_report",
    "ShardRecord", "ShardReport", "shard_report",
]
