"""apex_tpu_torch.monitor — runtime training-health telemetry.

The port of ``apex_tpu.monitor`` (ROADMAP.md queue A, item 11 parts 1
and 2):

- **device** (:mod:`~apex_tpu_torch.monitor.metrics`): a :class:`Metrics`
  tuple of 0-d device counters/gauges (loss scale, overflow/skip/growth/
  backoff counts, grad & param norms) carried on the train state with no
  host sync — ``amp.Amp(..., monitor=True)`` and
  ``FP16_Optimizer(..., monitor=True)`` maintain it;
- **host** (:mod:`~apex_tpu_torch.monitor.logger` /
  :mod:`~apex_tpu_torch.monitor.sinks`): :class:`MetricsLogger` with
  pluggable sinks (stdout table / JSONL / CSV), a rolling step-time and
  throughput estimator, one device-to-host copy a flush, and the event
  channels every subsystem streams into;
- :mod:`~apex_tpu_torch.monitor.goodput` — :class:`GoodputLedger`
  decomposes each step's wall clock into compute / exposed-comm /
  input-wait / host-callback / ckpt-stall / recompile / guard-rewind
  buckets off the :class:`apex_tpu_torch.trace.Tracer` timeline, with a
  closure check and a per-mesh-axis split of the comm buckets through
  :func:`~apex_tpu_torch.monitor.collectives.scope_axis_row`;
- :mod:`~apex_tpu_torch.monitor.collectives` — per-step collective bytes
  by opcode, dtype, hop and axis, from the port's collective ledger;
  :mod:`~apex_tpu_torch.monitor.check` — a step's device kernels and host
  syncs;
- :mod:`~apex_tpu_torch.monitor.numerics` — per-tensor dynamic-range
  telemetry (:class:`NumericsState`, ``Amp.step(numerics=)``), the format
  table and :func:`precision_report` / :func:`placement_advisor`;
- :mod:`~apex_tpu_torch.monitor.dynamics` — gradient noise scale, replica
  geometry (fed by ``parallel.distributed.dynamics_probe``) and per-site
  effective LR (:class:`DynamicsState`, ``Amp.step(dynamics=)``);
- :mod:`~apex_tpu_torch.monitor.convergence` — the noise-calibrated A/B
  trajectory comparator (:func:`calibrate_band` /
  :func:`convergence_report`);
- :mod:`~apex_tpu_torch.monitor.linkbench` — α–β link calibration into a
  measured :class:`apex_tpu_torch.lint.mesh_model.MeshModel`;
  :mod:`~apex_tpu_torch.monitor.comm_drift` — each
  :class:`apex_tpu_torch.parallel.CommPlan` hop measured against the
  plan's prediction.

The JAX package's ``collective_bytes_from_text`` has no counterpart (the
port compiles no HLO). ``MetricsLogger.attach``, the MFU column and
``sample_memory`` read :mod:`apex_tpu_torch.prof`.
"""

from apex_tpu_torch.monitor.check import module_count_and_host_ops
from apex_tpu_torch.monitor.collectives import (COLLECTIVE_OPCODES,
                                                collective_bytes,
                                                collective_bytes_by_axis,
                                                collective_bytes_by_dtype,
                                                collective_bytes_by_hop,
                                                scope_axis_row, scope_hop,
                                                wire_report)
from apex_tpu_torch.monitor.comm_drift import (CommDriftReport, HopDrift,
                                               compare as compare_comm_drift,
                                               measure_hops, wire_from_pod)
from apex_tpu_torch.monitor.convergence import (Band, ConvergenceVerdict,
                                                calibrate_band,
                                                convergence_report)
from apex_tpu_torch.monitor.dynamics import (DynamicsConfig, DynamicsProbe,
                                             DynamicsReport, DynamicsState,
                                             dynamics_init, dynamics_observe,
                                             dynamics_report)
from apex_tpu_torch.monitor.goodput import (BUCKETS, GoodputLedger,
                                            StepLedger, classify_span)
from apex_tpu_torch.monitor.linkbench import (LinkFit, LinkSample, calibrate,
                                              fit_alpha_beta, linkfit_events,
                                              sweep_axis)
from apex_tpu_torch.monitor.logger import CHANNELS, ChannelSpec, MetricsLogger
from apex_tpu_torch.monitor.metrics import (METRIC_FIELDS, Metrics,
                                            metrics_init, metrics_snapshot,
                                            metrics_to_dict)
from apex_tpu_torch.monitor.numerics import (FORMAT_LADDER, FORMAT_TABLE,
                                             NumericsConfig, NumericsReport,
                                             NumericsState, SiteVerdict,
                                             numerics_init, numerics_observe,
                                             placement_advisor,
                                             precision_report, site_names)
from apex_tpu_torch.monitor.sinks import CSVSink, JSONLSink, Sink, StdoutSink

__all__ = [
    "Metrics", "metrics_init", "metrics_to_dict", "metrics_snapshot",
    "METRIC_FIELDS",
    "MetricsLogger", "CHANNELS", "ChannelSpec",
    "FORMAT_TABLE", "FORMAT_LADDER", "NumericsConfig", "NumericsState",
    "NumericsReport", "SiteVerdict", "numerics_init", "numerics_observe",
    "precision_report", "placement_advisor", "site_names",
    "DynamicsConfig", "DynamicsState", "DynamicsProbe", "DynamicsReport",
    "dynamics_init", "dynamics_observe", "dynamics_report",
    "Band", "ConvergenceVerdict", "calibrate_band", "convergence_report",
    "Sink", "StdoutSink", "JSONLSink", "CSVSink",
    "COLLECTIVE_OPCODES", "collective_bytes",
    "collective_bytes_by_dtype", "collective_bytes_by_hop",
    "collective_bytes_by_axis", "scope_hop", "scope_axis_row",
    "wire_report",
    "module_count_and_host_ops",
    "GoodputLedger", "StepLedger", "BUCKETS", "classify_span",
    "LinkFit", "LinkSample", "calibrate", "fit_alpha_beta",
    "linkfit_events", "sweep_axis",
    "CommDriftReport", "HopDrift", "compare_comm_drift",
    "measure_hops", "wire_from_pod",
]
