#!/usr/bin/env python3
"""Chip smoke test of apex_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from this checkout, holds each kernel against its
plain PyTorch version on the card at the shapes its main path gives it
(and a ragged shape), times kernel, plain version, a library call
(yardstick only) and the data-sheet bound. Then:

- BERT-Large (B16, S512, amp O1 bf16, FusedLAMB) trains 5 steps through
  the kernels with the tree update (the "auto" default at this size) and 5
  steps with the flat-arena update (``strategy="arena"``), checking every
  kernel's launches and that the two runs' losses agree. One LAMB update
  from the same state is run both ways and compared, timed in turns, and
  its device kernels counted with ``torch.profiler``. Then 5 steps of
  BERT-Large as published: padding masks and attention dropout 0.1
  (phase bert_large_dropout). A depth-2 full-width step, without and
  with mask and dropout, is compared with the same step run through the
  plain versions, and a short fp16 O1 run with dynamic loss scaling takes
  one forced overflow. The attention kernels' options (bias modes,
  causal, Sq != Sk, dropout, block offsets, head dims 32/64/128, odd H)
  are held against the plain versions, and a probe reads the dropout
  keep mask out of the forward kernel bit for bit. Two launches of each
  attention kernel at BERT's shape, as is and with padding and dropout
  0.1, are held bitwise equal; the attention rows are timed by device
  time too (the profiler's kernel time, ``device_ms``), beside SDPA's,
  and so is every other row. The CUDA LayerNorm forward and backward
  are held against their plain versions on every path (ragged, off 16
  bytes, f32, fp16, no affine, staged and streamed rows; the backward
  also below its grid), the CUDA BN sums' dr bit for bit and its ReLU
  mask by its counts, and two launches of each bitwise equal (the
  backward in dx, dγ and dβ).
- BERT-Large trains 5 steps with ``FusedNovoGrad(lr=1e-3, betas=(0.95,
  0.98), eps=1e-8, weight_decay=1e-3)`` and 5 with ``FusedAdagrad(lr=1e-2,
  weight_decay=1e-4)`` on the arena (phases bert_large_novograd and
  bert_large_adagrad: one launch of the optimizer's kernel a step), each
  with one update compared arena against tree; the public
  ``multi_tensor_scale``/``axpby``/``maxnorm`` run once each on the
  NovoGrad run's master arena (phase multi_tensor_ops). The kernel phase
  holds maxnorm, scale, axpby, Adagrad and NovoGrad against their plain
  versions on a ragged arena (every variant, the flags' edge cases) and
  at BERT-Large's arena size.
- ResNet-50 (B256, 224x224, NHWC, amp O2 bf16, FusedSGD(lr=0.1,
  momentum=0.9)) trains 5 steps with the tree update ("auto") and 5 with
  the arena, with the same checks and one SGD update compared both ways;
  then a one-block-per-stage ResNet at full widths compares its first
  step's gradients and second step's loss through the kernels with the
  same run through the plain versions. The rest of the JAX package's
  ResNet follows, 5 steps each with launches, step ms, img/s and peak
  memory: fp8 BN residuals (``APEX_TPU_FP8_RESIDUALS=1``, every BN
  backward on the e4m3 x̂, step 0's loss as the O2 run's), BASELINE
  configuration 1 (O0 f32, B128, with a one-block-per-stage step through
  the kernels and the plain versions), O1, FusedAdam on the tree and the
  arena (one update compared), ``dx_distribute="all"`` after
  one-block-per-stage "join" and "all" models are held against the fused
  one, and ``fused_bn=False`` (no BN kernel) held the same way. The
  kernel phase also holds the BN pair in f32 and on an e4m3 x̂ at the
  stem (rows ``bn_{sums,dx}_{f32,fp8}``) and the cross-entropy kernels
  on labels >= V with the logits' next row NaN.
- BASELINE configuration 3 (the JAX bench's ``_bench_resnet(sync_bn=
  True)``): an NCCL process group of world size 1 over a ``file://``
  store (phase dist_init), then ResNet-50 with every BN unit's
  statistics across the ``data`` axis and the gradients all-reduced by
  ``sync_gradients``, B256, O2 bf16, FusedSGD, 5 steps (phase
  resnet50_syncbn: 53 + 53 BN launches and 106 + 161 collectives a step,
  losses within 1e-3 of phase resnet50's), and with
  ``DistributedDataParallel(delay_allreduce=True)`` and the arena SGD
  (phase resnet50_syncbn_arena: one flat all-reduce a step); each unit
  with statistics across ranks once under
  ``torch.cuda.set_sync_debug_mode("error")`` (phase
  syncbn_units_sync_free); two processes on the card in a gloo group
  held against one process on their whole batch (phase
  syncbn_two_ranks). The kernel phase holds row 13's count-on-the-card
  variant against its plain version (row ``bn_dx_count``).
- DLRM's bottom MLP (``ops.MLP([13, 512, 256, 128])``: the
  ``--arch-mlp-bot`` of facebookresearch/dlrm's Criteo Terabyte run, at
  its ``--mini-batch-size=2048``) trains 20 steps under
  amp O2 bf16 with ``sparsity.ASP(FusedAdam(lr=1e-3), "m4n2_1d")``
  (phase mlp_dlrm_bottom: one ``mlp_fwd`` and one ``adam`` launch a step,
  every weight 2:4 under its mask after every step, falling losses); the
  reference Apex test's widths, over the kernel's 8 MiB budget, run
  forward and backward with no launch and bitwise as ``mlp_reference``
  (phase mlp_fallback); one step is compared through the kernels and the
  plain versions (phase mlp_plain_vs_kernel). The kernel phase holds
  ``mlp_fwd`` against its plain version at the path's shape, the budget's
  edge and a ragged shape (two launches of each bitwise equal), and on
  its per-layer and multi-launch plans.
- DCGAN (B128, 64x64, generator nz 100 / ngf 64, discriminator ndf 64,
  amp O1 bf16 under ``auto_cast``, two ``FusedAdam(lr=2e-4, betas=(0.5,
  0.999))`` bundles, three scaled backwards a step) trains 20 steps with
  the arena update ("auto" at these sizes: 3 Adam launches a step) and 20
  with the tree update, whose losses it holds against the arena run's; one
  Adam update is compared both ways; one step is compared through the
  kernel and through the plain versions; and a short fp16 run with three
  dynamic loss scalers takes a forced overflow on one of them.

- The amp remainder, fp16_utils and the legacy optimizers, last: DLRM's
  bottom MLP through ``amp.initialize(..., "O1")`` with the loss under
  ``auto_cast`` (phase mlp_dlrm_bottom_o1: one ``mlp_fwd`` launch a step
  in the kernel's bf16-operand mode, 2:4 after every step, one step
  against the plain versions); the JAX package's L1 grid (phase l1_grid:
  O0-O3 x dynamic/static/none scaling x keep-BN, the kernel path against
  the plain versions with a plain SGD replica, decisions bit for bit, an
  fp16 overflow injection and a resume); BERT-Large set up by
  ``amp.initialize(..., "O2", half_dtype=torch.float16)`` with two
  microbatches of B8 a step through ``backward_accumulate`` until 5 steps
  are applied (phase bert_large_o2_fp16_accum: the accumulated grads
  against one B16 backward, a ``state_dict`` resume bit for bit); the
  pre-amp ``FP16_Optimizer`` from the legacy scale 2**32 until 5 steps are
  applied (phase bert_large_fp16_optimizer); and one update of each legacy
  optimizer on a gradient scaled by 1024 against the modern one on the
  unscaled gradient (phase legacy_updates). The kernel phase also holds
  the LayerNorm, flash and cross-entropy kernels in fp16 at BERT-Large's
  shapes against their plain versions, and the MLP kernel's half-operand
  mode bit for bit against its plain version (row ``mlp_fwd_o1``).
- The attention and model-layer remainder, last: the reference Apex's MHA
  benchmark (``perf_test_multihead_attn.py``: 18 norm-add
  ``SelfMultiheadAttn(1024, 16, dropout=0.1)`` layers, B128 S64, fp16 by
  ``network_to_half``; phase mha_perf_test: forward and backward ms, 5
  warm-up trials then the median of 20, beside the ``impl="default"``
  and the ``EncdecMultiheadAttn`` stacks; a flash and a LayerNorm launch
  a layer each way; one deterministic pass against the plain versions);
  that stack trained at O2 fp16 through ``amp.initialize`` and the arena
  ``FusedAdam`` (mha_norm_add_train); 24 pre-LN ``TransformerLayer``s at
  BERT-Large's widths, B16 S512 with padding and dropout, O1 bf16, the
  arena LAMB (transformer_pre_ln, and a depth-2 step against the plain
  versions); the byte mLSTM (4096 units, B128 T256) and the word-language
  LSTM (2 x 1500, B20 T35) at O1 bf16 with the arena Adam (rnn_mlstm,
  rnn_lstm), a bidirectional GRU's gradients against the CPU's
  (rnn_gru_cpu_vs_card); weight norm at O2 fp16 on weights whose squares
  underflow (weight_norm); and the DCGAN example's own step (B64, O2
  bf16 without ``auto_cast``, two Adam launches a step; dcgan_example).
  The kernel phase adds the flash rows at the benchmark's shape
  (``flash_attn_{fwd,bwd}_s64``) and the mask probe at S = 64 and with
  the caller's blocks of 128.

- The robustness slice: right after the MLP phases, an MLP's gradients
  at O1 bf16 with ``backward()`` inside ``auto_cast`` on the card against
  the CPU (phase o1_backward_thread: autograd's device thread must see
  the policy); after bert_large_dropout, the published BERT-Large arena
  step resumed from an async checkpoint of the state and its dropout
  generator bit for bit (bert_large_ckpt_resume) and trained under
  ``Amp.step(guard=...)`` with NaN grads, a spiked batch and NaN params
  injected (bert_large_guard: skips hold the state, the rewind equals a
  run that never saw the skipped batches, launches unchanged, no host
  sync, the guard's cost, the fingerprint card vs CPU); the same resume
  through ``DistributedFusedLAMB`` at NCCL world 1
  (bert_large_zero_ckpt_resume); two gloo ranks' ZeRO checkpoint
  restored by one process (zero_elastic_two_to_one); three gloo ranks
  that fingerprint, vote and repair a flipped bit (integrity_three_ranks);
  and, last, saves killed at both crash points and an exit-75 escalation
  in subprocesses (ckpt_crash_and_escalate).
- Tracing and telemetry, right after resnet50_arena: ResNet-50 (B256,
  224^2, O2 bf16, arena FusedSGD) through ``scripts/torch_trace_resnet.py``'s
  loop under ``enable_crash_dumps``, ``Amp(monitor=True)``, a
  ``MetricsLogger`` and a ``GoodputLedger`` (resnet50_traced: launches as
  the arena run's, the Metrics, one step of the whole stack under
  ``set_sync_debug_mode("error")``, the goodput closure, every stream
  through the schema script; host ms, device kernels and ms, the
  monitor's extra kernels and host µs a span, in turns with the untraced
  step); NaN provenance on that step (debug_nans_card: off adds no
  kernel, on names ``amp/fwd`` and ``amp/bwd``, no sync); a depth-2 BERT
  child dumping on an exception, on SIGTERM after ``on_preempt()``
  (resumed bit for bit) and, through the hang watchdog, on a device-side
  hang (exit 75) (crash_dumps_card); two gloo ranks under DDP with rank 1
  late in ``data/load``, blamed by the pod view (straggler_podview_two_ranks).
  cluster_zombie_elastic's rank 0 now notices its stopped peer through
  ``HangWatchdog``.
- The numerics and dynamics monitors, right after the tracing phases:
  BERT-Large (B16 S512 O1 bf16, arena FusedLAMB) through
  ``Amp.step(numerics=, dynamics=)`` in turns with the plain step
  (bert_large_observed: losses and params bit for bit the arena run's,
  hand-kernel launches unchanged, no host sync, no surprise and no
  nonfinite site, events valid; device kernels and ms, wall ms and peak
  GiB against the plain step; the fold's kernels at 292 and 49 leaves;
  an off-step of each hook at ``check_every=10``; one NaN grad leaf named
  by ``nonfinite_sites``); the fp8 flag of a tensor straddling 2^-6
  (numerics_flag_card); two gloo ranks with a depth-2 BERT: the probe's
  two collectives and bytes, cos = proj = 1 on replicated grads, the GNS
  of injected noise within 25% (dynamics_two_ranks), and sweep → fit →
  MeshModel → ``plan_comm`` → ``measure_hops`` → ``compare`` with the pod
  join (linkbench_drift_two_ranks); and the convergence band of the DLRM
  bottom MLP: the plain path passes, a x10 learning rate is flagged
  (convergence_mlp).
- The profiler (``apex_tpu_torch.prof``), right after the monitor phases:
  ``profile_step`` and ``roofline_report`` on the arena BERT-Large step
  (bert_large_profiled: launches as the arena step's, device ms within 3%
  of ``device_ms``, closure within 5%, no row over 1.05 of its bound but
  the L2-served memory-bound aten ones, each hand kernel's bound its
  kernel row's, ``MetricsLogger.attach``'s FLOPs within 1% of the GEMMs'
  and attention's, MFU on wall and device time, ``by_family``,
  ``worst_gaps``, the CLI on the kept trace, the cost hook's host µs);
  ``memory_report`` of that step (bert_large_memory: the peak-live
  estimate and ``forecast(32)`` within 10% of the allocator's peaks, the
  memory stream valid); a fresh process's Triton JIT and a new sequence
  length seen by ``CompileWatcher`` with goodput's ``recompile`` bucket
  (compile_watch_card); the port of ``examples/simple/distributed`` at
  NCCL world 1 and on two gloo ranks (simple_distributed_example); and
  the ZeRO state's ``shard_report`` inside zero_two_ranks.
- Data, cluster and ``elastic_run``, after the ResNet phases, on a JPEG
  tree the port's encoder writes in the background from the start (512
  images, 256^2, 8 classes) and its packed cache: the codec (phase
  jpeg_codec: the encoder's coefficients back bit for bit, the IDCT
  within ±1 of a float64 IDCT, PIL's pixels if PIL imports; encode and
  decode ms by stage, decode and loader img/s beside the host CPU); the
  ImageNet example (``scripts/torch_imagenet_main_amp.py``, ResNet-50 B256
  224^2 O2) from the cache, from live decode and from synthetic data, and
  with ``--deterministic`` (imagenet_example_resnet50: step ms, img/s,
  loader img/s, peak GiB, launches; the prefetcher's batches bit for bit;
  the uint8 normalise card vs CPU); a ResNet-50 resume from an
  ``ImageFolderSource`` cursor bit for bit and ``skip_batches`` decoding
  nothing (data_cursor_resume); JAX's coordinated-rewind acceptance on
  ResNet-18 in four processes (cluster_coordinated_rewind); and
  ``elastic_run`` 2 -> 1 around a SIGSTOPped ZeRO rank whose late save and
  delete the fence refuses (cluster_zombie_elastic). After
  hierarchical_sync_world1, the example with ``--sync_bn --opt-level O1``
  at NCCL world 1 (imagenet_example_syncbn: 106 sync_batchnorm
  collectives a step).

- The autotuner and its tooling. First (phase compile_check), every case
  of ``python -m apex_tpu_torch.ops``'s compile check through
  ``compile_check.run()``: the JAX package's kernel cases at its awkward
  shapes, the kernel checks at the main paths' shapes (each kernel
  against its plain version, the masks and copies bit for bit, two
  launches bitwise equal; the kernels JSON line takes its max_abs_err
  from them), each module's no-extra-dispatch census and the autotune
  contract; and ``python -m apex_tpu_torch.ops -k autotune/`` as its own
  process. The kernel phase then times every row. Every phase runs with
  ``APEX_TPU_AUTOTUNE=off`` (the kernels' default launch knobs) but five,
  which run the default ``db`` as users do: mlp_dlrm_bottom,
  bert_large_zero and bert_large_zero_two_ranks (BERT-Large's ZeRO at
  world size 2, its shard's key; their consults checked against the
  committed DB), and
  after bert_large_arena autotune_db (the committed
  ``scripts/torch_kernel_tuning_db.json`` loads stale-free under this
  card's name, at each entry's shape the kernels its sweep timed hit it,
  match their plain versions and themselves bit for bit, its tuned device
  time beside the default's) and bert_large_tuned (BERT-Large arena 5
  steps with ``off`` and with the DB: the off losses bert_large_arena's
  bit for bit, the tuned within 1e-3, launches unchanged, the DB's hits
  counted, device ms a step and the consult's host cost). After the
  monitor phases, link_probe runs
  ``scripts/torch_link_probe.py`` (two gloo processes on the card) and
  plans with its MeshModel.

Prints one line per phase (and each CUDA kernel's registers and spills
from ``ptxas -v``), the card's name and power limit, a JSON line of
per-kernel numbers, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero on any failure, or when no CUDA device is available.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

# the H100 SXM data sheet's HBM3 bandwidth, dense bf16/fp16 tensor-core
# and f32 peaks; the profiler session guard (its spin lead and counters);
# the one bound formula, device-kernel filter and device_ms
from apex_tpu_torch.prof.cost import HASH_OPS, bound_ms
from apex_tpu_torch.prof.report import (  # noqa: F401
    _LEAD, _LOST, _SPIN_NAMES, BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S,
    MAX_LEAD, PAD_CYCLES, SHORT_CYCLES, device_ms, guarded_session)
from apex_tpu_torch.prof.xplane import device_kernels
# the kernel-vs-plain checks, their tolerances and shapes: the compile
# check's (``python -m apex_tpu_torch.ops``); this script keeps the timings
from apex_tpu_torch.ops import compile_check
from apex_tpu_torch.ops.compile_check import (  # noqa: F401
    MLP_BOTTOM, RING_B, RING_D, RING_H, RING_S, SEQ_RANKS, TOL16, TOL32,
    TOL_ARENA, check_flagged, compare, plain_versions)
EXPECTED_PER_STEP = {"layer_norm_fwd": 49, "layer_norm_bwd": 49,
                     "xentropy_fwd": 1, "xentropy_bwd": 1,
                     "flash_attn_fwd": 24, "flash_attn_bwd": 24}
# launches per step of the arena update's kernels (one f32 partition)
ARENA_PER_STEP = {"multi_tensor_l2norm": 1, "lamb_stage1": 1,
                  "lamb_stage2": 1}
# ResNet-50: 53 BN units (33 BN+ReLU, 16 joins, 4 projections)
RESNET_PER_STEP = {"bn_sums": 53, "bn_dx": 53, "xentropy_fwd": 1,
                   "xentropy_bwd": 1}
SGD_PER_STEP = {"sgd": 1}           # the arena SGD, one f32 partition
# ResNet-50 with dx_distribute="all": each block's four units are ConvBNAct
# units, whose backward runs the sums kernel and no dx kernel; the stem's
# unit stays a FusedBNAct
RESNET_ALL_PER_STEP = {"bn_sums": 53, "bn_dx": 1, "xentropy_fwd": 1,
                       "xentropy_bwd": 1}
# ResNet-50 with fused_bn=False: flax BatchNorm under autograd, no BN kernel
RESNET_UNFUSED_PER_STEP = {"xentropy_fwd": 1, "xentropy_bwd": 1}
ADAM_PER_STEP = {"adam": 1}         # the arena Adam, one f32 partition
# DCGAN: three Adam updates a step (D real, D fake, G), one f32 partition
# each under the arena; nothing else of the package is on that path
DCGAN_PER_STEP = {"adam": 3}
DCGAN_STEPS = 20
# BERT-Large with FusedNovoGrad / FusedAdagrad on the arena: one launch of
# the optimizer's kernel a step (one f32 partition), no LAMB kernel
NOVOGRAD_PER_STEP = {"novograd": 1}
ADAGRAD_PER_STEP = {"adagrad": 1}
# phase multi_tensor_ops: one call of each public function (no training
# step of either package calls them)
MULTI_TENSOR_OPS = {"multi_tensor_maxnorm": 1, "multi_tensor_scale": 1,
                    "multi_tensor_axpby": 1}
# the DLRM bottom MLP (B2048, [13, 512, 256, 128], O2 bf16, 2:4 ASP around
# FusedAdam): one mlp_fwd launch a step and one Adam launch for the f32
# masters' one arena partition
MLP_PER_STEP = {"mlp_fwd": 1, "adam": 1}
MLP_STEPS = 20
# mlp_dlrm_bottom_o1: relative L2 of each param's one-step update, kernel
# path against plain path (the forward is bitwise, and on an H100 the
# whole update was too: 0.0); an update missing or wrong in a layer is O(1)
MLP_O1_UPDATE_TOL = 1e-4
# the reference Apex test's widths (DLRM's top MLP over a 480-wide input):
# 8,782,848 bytes of f32 weights, over the kernel's 8 MiB budget
MLP_OVER_BUDGET = (480, 1024, 1024, 512, 256, 1)
# BERT-Large at O2 fp16 with two microbatches of B8 a step through
# backward_accumulate: every kernel of the forward and backward twice a
# step, the arena LAMB once; steps until 5 are applied, at most 10
BERT_ACCUM_PER_STEP = dict({k: 2 * v for k, v in EXPECTED_PER_STEP.items()},
                           **ARENA_PER_STEP)
BERT_ACCUM_MAX_STEPS = 10
# FP16_Optimizer from the legacy 2**32: backwards until 5 steps are applied
FP16_OPT_MAX_BACKWARDS = 32
REPLACES = {
    "layer_norm_fwd": "apex_tpu/ops/layer_norm.py:62",
    "layer_norm_bwd": "apex_tpu/ops/layer_norm.py:111",
    "xentropy_fwd": "apex_tpu/ops/xentropy.py:46",
    "xentropy_bwd": "apex_tpu/ops/xentropy.py:77",
    "flash_attn_fwd": "apex_tpu/ops/attention.py:720",
    "flash_attn_bwd": "apex_tpu/ops/attention.py:1064",
    "multi_tensor_l2norm": "apex_tpu/ops/multi_tensor.py:91",
    "lamb_stage1": "apex_tpu/ops/optim_kernels.py:169",
    "lamb_stage2": "apex_tpu/ops/optim_kernels.py:217",
    "bn_sums": "apex_tpu/ops/bn_act.py:178",
    "bn_dx": "apex_tpu/ops/bn_act.py:206",
    "sgd": "apex_tpu/ops/optim_kernels.py:95",
    "adam": "apex_tpu/ops/optim_kernels.py:42",
    "multi_tensor_maxnorm": "apex_tpu/ops/multi_tensor.py:114",
    "multi_tensor_scale": "apex_tpu/ops/multi_tensor.py:28",
    "multi_tensor_axpby": "apex_tpu/ops/multi_tensor.py:62",
    "adagrad": "apex_tpu/ops/optim_kernels.py:141",
    "novograd": "apex_tpu/ops/optim_kernels.py:244",
    "mlp_fwd": "apex_tpu/ops/mlp.py:52",
    "flash_generic_fwd": "apex_tpu/ops/attention.py:720",
    "flash_generic_bwd": "apex_tpu/ops/attention.py:1064",
}
# rows of the kernels JSON line beyond one per kernel: the two attention
# wrappers timed again at the published BERT path's shape (padding bias,
# dropout 0.1) and at H = 15, where the JAX package takes its (B·H, S, D)
# kernels (rows 9-11); {row: (kernel, TPU kernel replaced, phase whose run
# drives this row's geometry, or None: no path runs H = 15, 0 launches)}
EXTRA_ROWS = {
    "flash_attn_fwd_mask_dropout": ("flash_attn_fwd",
                                    "apex_tpu/ops/attention.py:720",
                                    "bert_large_dropout"),
    "flash_attn_bwd_mask_dropout": ("flash_attn_bwd",
                                    "apex_tpu/ops/attention.py:1064",
                                    "bert_large_dropout"),
    "flash_attn_fwd_h15": ("flash_attn_fwd", "apex_tpu/ops/attention.py:212",
                           None),
    "flash_attn_bwd_h15": ("flash_attn_bwd", "apex_tpu/ops/attention.py:357",
                           None),
}
# rows of the kernels JSON line for the BN pair at the stem in the dtypes
# that ResNet-50 at O0 (f32 x, g, γ, β) and with fp8 residuals (e4m3 x̂,
# bf16 g) gives them: {row: (kernel, TPU kernel replaced, phase whose run
# drives it)}
EXTRA_BN_ROWS = {
    "bn_sums_f32": ("bn_sums", "apex_tpu/ops/bn_act.py:178", "resnet50_o0"),
    "bn_dx_f32": ("bn_dx", "apex_tpu/ops/bn_act.py:206", "resnet50_o0"),
    "bn_sums_fp8": ("bn_sums", "apex_tpu/ops/bn_act.py:178", "resnet50_fp8"),
    "bn_dx_fp8": ("bn_dx", "apex_tpu/ops/bn_act.py:206", "resnet50_fp8"),
    # the dx kernel reading the group's count from the card (COUNT_PTR), as
    # the BN units with statistics across ranks launch it
    "bn_dx_count": ("bn_dx", "apex_tpu/ops/bn_act.py:206",
                    "resnet50_syncbn"),
}
# BASELINE configuration 3 (SyncBN + gradient sync) at world size 1 on
# NCCL: collectives a step by registry scope; each of the 53 BN units
# gathers its statistics in the forward and all-reduces its channel sums
# in the backward; the tree sync all-reduces each of the 161 gradients,
# DistributedDataParallel(delay_allreduce=True) one flat f32 buffer
SYNCBN_COLLECTIVES = {"sync_batchnorm": 106, "ddp/sync_gradients": 161}
SYNCBN_ARENA_COLLECTIVES = {"sync_batchnorm": 106, "ddp/sync_gradients": 1}
# ZeRO on BERT-Large (DistributedFusedLAMB, NCCL at world size 1): the arena
# LAMB kernels once a step on the shard (the clip's norm, the two stages),
# and five collectives a step: the gradient reduce-scatter, the clip's norm
# sum, the two per-tensor norm sums and the parameter all-gather
ZERO_PER_STEP = dict(ARENA_PER_STEP)
ZERO_COLLECTIVES = {"zero/grad_scatter": 1, "zero/grad_norm": 3,
                    "zero/param_gather": 1}
# rows of the kernels JSON line for the kernels at the ZeRO and ring paths'
# shapes (one row a kernel: LAMB's two stages on a shard and the flash
# forward and backward at a ring hop are two rows each): {row: (kernel,
# TPU kernel replaced, phase whose run gives this row's launches)}
EXTRA_ZERO_ROWS = {
    "lamb_shard_stage1": ("lamb_stage1", "apex_tpu/ops/optim_kernels.py:169",
                          "bert_large_zero"),
    "lamb_shard_stage2": ("lamb_stage2", "apex_tpu/ops/optim_kernels.py:217",
                          "bert_large_zero"),
    "adam_e5m2_copy": ("adam", "apex_tpu/ops/optim_kernels.py:42",
                       "zero_adam_update"),
    "flash_ring_hop_fwd": ("flash_attn_fwd", "apex_tpu/ops/attention.py:720",
                           "ring_two_ranks"),
    "flash_ring_hop_bwd": ("flash_attn_bwd",
                           "apex_tpu/ops/attention.py:1064",
                           "ring_two_ranks"),
}
# the MLP kernel's half-operand mode (amp O1's functional patch) at the DLRM
# bottom MLP's shape: {row: (kernel, TPU kernel replaced, phase)}
EXTRA_O1_ROWS = {
    "mlp_fwd_o1": ("mlp_fwd", "apex_tpu/ops/mlp.py:52",
                   "mlp_dlrm_bottom_o1"),
}
# the flash kernels at the reference Apex's MHA benchmark's shape (B128,
# S64, H16, D64, fp16, dropout 0.1): {row: (kernel, TPU kernel replaced,
# phase whose run gives this row's launches)}
EXTRA_S64_ROWS = {
    "flash_attn_fwd_s64": ("flash_attn_fwd", "apex_tpu/ops/attention.py:720",
                           "mha_perf_test"),
    "flash_attn_bwd_s64": ("flash_attn_bwd",
                           "apex_tpu/ops/attention.py:1064",
                           "mha_perf_test"),
}
# the generic flash kernels (every operand the wgmma kernels refuse): the
# rows flash_generic_{fwd,bwd} are BERT-Large's attention in f32 (phase
# bert_large_f32 gives their launches); these are the same shape with the
# padding bias and dropout 0.1, and ViT-H/14's attention, (16, 257, 16,
# 80) bf16, which no path runs (0 launches): {row: (kernel, TPU kernel
# replaced, phase whose run gives this row's launches)}
EXTRA_GENERIC_ROWS = {
    "flash_generic_fwd_mask_dropout": ("flash_generic_fwd",
                                       "apex_tpu/ops/attention.py:720", None),
    "flash_generic_bwd_mask_dropout": ("flash_generic_bwd",
                                       "apex_tpu/ops/attention.py:1064",
                                       None),
    "flash_generic_fwd_d80": ("flash_generic_fwd",
                              "apex_tpu/ops/attention.py:720", None),
    "flash_generic_bwd_d80": ("flash_generic_bwd",
                              "apex_tpu/ops/attention.py:1064", None),
}
#: ViT-H/14's attention: 1280 wide, 16 heads of 80, 256 patches + CLS
VIT_H_SHAPE = (16, 257, 16, 80)
# BERT-Large in f32 end to end (amp disabled: Policy("O0", enabled=False),
# the JAX package's default policy) on the arena LAMB: the generic flash
# kernels take every attention, the wgmma ones none; 3 steps
BERT_F32_PER_STEP = {"flash_attn_fwd": 0, "flash_attn_bwd": 0,
                     "flash_generic_fwd": 24, "flash_generic_bwd": 24}
BERT_F32_STEPS = 3
# its depth-2 first step through the kernels against the plain versions:
# loss within 1e-5 relative, each tensor's grads within 1e-4 of its max
BERT_F32_LOSS_TOL, BERT_F32_GRAD_TOL = 1e-5, 1e-4
# the reference Apex's MHA benchmark (perf_test_multihead_attn.py): seq-len
# 64, 18 layers, hidden 1024, 16 heads, at B128 (8192 rows, BERT's row
# count); 5 warm-up trials, then the median of 20, as the script times them
MHA_B, MHA_S, MHA_LAYERS, MHA_HIDDEN, MHA_HEADS = 128, 64, 18, 1024, 16
MHA_WARMUP, MHA_TRIALS = 5, 20
# one pass of the norm-add stack: a flash and a LayerNorm kernel a layer
# each way (the default path's attention is plain PyTorch: no flash)
MHA_FWD = {"flash_attn_fwd": MHA_LAYERS, "layer_norm_fwd": MHA_LAYERS}
MHA_BWD = {"flash_attn_bwd": MHA_LAYERS, "layer_norm_bwd": MHA_LAYERS}
MHA_TRAIN_PER_STEP = dict(MHA_FWD, **MHA_BWD, adam=1)
# 24 pre-LN layers at BERT-Large's widths: two LayerNorms and one attention
# a layer, the arena LAMB once a step
PRE_LN_LAYERS = 24
PRE_LN_PER_STEP = dict({"layer_norm_fwd": 48, "layer_norm_bwd": 48,
                        "flash_attn_fwd": 24, "flash_attn_bwd": 24},
                       **ARENA_PER_STEP)
# the depth-2 pre-LN stack's forward and backward through the kernels, and
# its first-step loss against the plain versions' (relative)
PRE_LN_DEPTH2 = {"layer_norm_fwd": 4, "layer_norm_bwd": 4,
                 "flash_attn_fwd": 2, "flash_attn_bwd": 2}
PRE_LN_LOSS_TOL = 5e-3
# the RNN stacks: the arena Adam once a step, no other kernel of the port
RNN_PER_STEP = {"adam": 1}
RNN_STEPS = 3
# the DCGAN example's step: D's one update on gR + gF and G's one
DCGAN_EXAMPLE_PER_STEP = {"adam": 2}
# a bidirectional 2-layer GRU on the card against the CPU (f32, TF32 off):
# the relative L2 of the loss and of each param's gradient
RNN_CPU_TOL = 1e-4
# weight norm at O2 fp16: the f32 norm against float64
WEIGHT_NORM_TOL = 1e-6
# ZeRO across two ranks: BERT at full width, depth 2, B4 a rank
ZERO_RANK_BATCH = 4
# the link rates the hierarchical phases plan with: the wire dtype of
# every hop is forced, so they only order candidates (not the card's)
PLAN_LINKS = {"ici": 1.0e11, "dcn": 1.0e10}
# the robustness phases: a resume from an async save at step RESUME_AT of
# RESUME_STEPS; the guard's config (armed early), its faults (NaN grads, a
# batch scaled by 1000, NaN params after a step), its one save and the
# steps compared after the rewind; three ranks, the flip seen at step
# INTEGRITY_FLIP of INTEGRITY_STEPS
RESUME_STEPS, RESUME_AT = 4, 2
# where the robustness phases put their tensors (their rank bodies too)
DEVICE = "cuda"
# where the compile check's summary JSON goes (git-ignored)
BUILD_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke")
GUARD_CFG = dict(window=8, min_history=4)
GUARD_SAVE, GUARD_NAN_GRAD, GUARD_SPIKE, GUARD_NAN_PARAM = 5, 7, 8, 10
GUARD_AFTER = 3
GUARD_COST_TURNS = 4           # (plain, guarded, guarded, plain) rounds
INTEGRITY_STEPS, INTEGRITY_FLIP = 5, 2
SOURCES = {
    "layer_norm_fwd": ("cuda", "apex_tpu_torch/csrc/layer_norm_fwd.cu"),
    "layer_norm_bwd": ("cuda", "apex_tpu_torch/csrc/layer_norm_bwd.cu"),
    "xentropy_fwd": ("triton", "apex_tpu_torch/ops/xentropy.py"),
    "xentropy_bwd": ("triton", "apex_tpu_torch/ops/xentropy.py"),
    "flash_attn_fwd": ("cuda", "apex_tpu_torch/csrc/flash_attn_fwd.cu"),
    "flash_attn_bwd": ("cuda", "apex_tpu_torch/csrc/flash_attn_bwd.cu"),
    "multi_tensor_l2norm": ("triton", "apex_tpu_torch/ops/multi_tensor.py"),
    "lamb_stage1": ("triton", "apex_tpu_torch/ops/optim_kernels.py"),
    "lamb_stage2": ("triton", "apex_tpu_torch/ops/optim_kernels.py"),
    "bn_sums": ("cuda", "apex_tpu_torch/csrc/bn_sums.cu"),
    "bn_dx": ("triton", "apex_tpu_torch/ops/bn_act.py"),
    "sgd": ("triton", "apex_tpu_torch/ops/optim_kernels.py"),
    "adam": ("triton", "apex_tpu_torch/ops/optim_kernels.py"),
    "multi_tensor_maxnorm": ("triton", "apex_tpu_torch/ops/multi_tensor.py"),
    "multi_tensor_scale": ("triton", "apex_tpu_torch/ops/multi_tensor.py"),
    "multi_tensor_axpby": ("triton", "apex_tpu_torch/ops/multi_tensor.py"),
    "adagrad": ("triton", "apex_tpu_torch/ops/optim_kernels.py"),
    "novograd": ("triton", "apex_tpu_torch/ops/optim_kernels.py"),
    "mlp_fwd": ("cuda", "apex_tpu_torch/csrc/mlp_fwd.cu"),
    "flash_generic_fwd": ("cuda", "apex_tpu_torch/csrc/flash_attn_generic.cu"),
    "flash_generic_bwd": ("cuda", "apex_tpu_torch/csrc/flash_attn_generic.cu"),
}
# arena against tree update on BERT-Large: p and m within 1e-5 of each
# tensor's largest magnitude; v within 2e-5, because the kernels take
# (1 - beta2) in f32 from the f32 beta2, as the JAX package's kernels do,
# and the tree update from the Python float, as the JAX tree update does
# (1.3e-5 apart at beta2 = 0.999)
TOL_UPDATE = {"p": 1e-5, "m": 1e-5, "v": 2e-5}
# SGD arena against tree: the same f32 formulas elementwise
TOL_SGD_UPDATE = {"p": 1e-5, "m": 1e-5}
# Adagrad arena against tree: the same f32 formulas elementwise
TOL_ADAGRAD_UPDATE = {"p": 1e-5, "h": 1e-5}
# NovoGrad arena against tree: m the same formula; vnorm within 1e-5 of
# each tensor's norm (the arena sums row norms and then rows, the tree
# each tensor at once: f32 sums in another order), and p, whose update
# divides by it, within 1e-5 of each tensor's largest magnitude
TOL_NOVOGRAD_UPDATE = {"p": 1e-5, "m": 1e-5, "vnorm": 1e-5}


def log(msg):
    print(msg, flush=True)


def timed(fn, iters=10, flush=None):
    """Mean ms of one ``fn()`` call on the card, each call timed alone by
    CUDA events after ``flush()`` (an L2 sweep), after 2 warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def bench_tools(rows, errs):
    """(rnd, gen, flush, row) for the kernel timings: seeded random tensors
    on the card, an L2 sweep, and ``row(...)``, which records a kernel's
    numbers in ``rows`` with its max_abs_err from ``errs`` (the compile
    check's run)."""
    import torch

    rnd, gen = compile_check.seeded(0)
    sweep = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = sweep.zero_

    # a second of GEMMs first, so the first timed kernel does not meet the
    # card's clocks still ramping up
    warm = rnd(4096, 4096)
    deadline = time.perf_counter() + 1.0
    while time.perf_counter() < deadline:
        for _ in range(20):
            warm @ warm
        torch.cuda.synchronize()
    del warm

    def row(name, ms, plain_ms, lib_ms, nbytes, flops, peak=BF16_FLOPS,
            int_ops=0, dev_ms=None, lib_dev_ms=None):
        err = errs[name]
        t_bytes = bound_ms(nbytes, 0, peak)
        t_ops = bound_ms(0, flops, peak, int_ops)
        kernel, replaces, _ = {**EXTRA_ROWS, **EXTRA_BN_ROWS,
                               **EXTRA_ZERO_ROWS, **EXTRA_O1_ROWS,
                               **EXTRA_S64_ROWS,
                               **EXTRA_GENERIC_ROWS}.get(
            name, (name, REPLACES.get(name), None))
        route, src = SOURCES[kernel]
        rows[name] = {
            "name": name, "route": route, "source": src,
            "replaces": replaces, "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "device_ms": dev_ms,
            "library_device_ms": lib_dev_ms}
        log(f"kernel {name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms  bound "
            f"{rows[name]['bound_ms']:.4f} ms ({rows[name]['bound_by']})"
            + ("" if dev_ms is None else
               f"  device time: kernel {dev_ms:.4f} ms, library "
               f"{'-' if lib_dev_ms is None else f'{lib_dev_ms:.4f}'} ms"))

    return rnd, gen, flush, row


def compile_check_phase():
    """Phase compile_check: every case of ``apex_tpu_torch.ops``'s compile
    check (the JAX package's kernel cases at its awkward shapes, the
    kernel checks at the main paths' shapes, each module's
    no-extra-dispatch census, the autotune contract) through
    ``compile_check.run()``, which the kernel phase's rows take their
    max_abs_err from; and ``python -m apex_tpu_torch.ops`` itself on its
    autotune case. Any failing case fails the run. Returns the errors by
    row."""
    os.makedirs(BUILD_OUT, exist_ok=True)
    summary = compile_check.run(json_path=os.path.join(
        BUILD_OUT, "compile_check.json"))
    if not summary["ok"]:
        raise AssertionError(
            "compile_check: failing cases " + ", ".join(
                r["case"] for r in summary["results"] if not r["ok"]))
    slow = sorted(summary["results"], key=lambda r: -r["s"])[:5]
    log(f"phase compile_check: {summary['n_cases']} cases ok on "
        f"{summary['device']} in {summary['seconds']:.1f} s (slowest "
        f"{[(r['case'], r['s']) for r in slow]})")
    out = os.path.join(BUILD_OUT, "compile_check_cli.json")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "apex_tpu_torch.ops", "-k",
                        "autotune/", "--json", out], capture_output=True,
                       text=True, cwd=os.path.dirname(os.path.abspath(
                           __file__)))
    with open(out) as f:
        cli = json.load(f)
    if r.returncode != 0 or not cli["ok"] or cli["n_cases"] != 1:
        raise AssertionError(f"compile_check: python -m apex_tpu_torch.ops "
                             f"exited {r.returncode}: {cli}\n"
                             f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
    log(f"phase compile_check: python -m apex_tpu_torch.ops -k autotune/ "
        f"exited 0 ({cli['n_cases']} case, backend {cli['backend']}, "
        f"device {cli['device']}) in {time.perf_counter() - t0:.1f} s")
    return summary["max_abs_err"]


def check_kernels(rows, errs):
    """Phase 3: every kernel's row: events-timed ms, device ms, the plain
    version's and the library call's times and the bound, at the main
    paths' shapes, with max_abs_err from the compile check (``errs``)."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import layer_norm as L
    from apex_tpu_torch.ops import xentropy as X

    dev = torch.device("cuda")
    rnd, gen, flush, row = bench_tools(rows, errs)

    # --- LayerNorm at BERT's (8192, 1024) bf16
    eps = 1e-5
    nh = 8192 * 1024
    x = rnd(8192, 1024, std=2.0)
    w = rnd(1024, dtype=torch.float32, std=0.2) + 1.0
    b = rnd(1024, dtype=torch.float32, std=0.2)
    g = rnd(8192, 1024)
    kernel = lambda: L.ln_fwd_kernel(x, w, b, eps)  # noqa: E731
    ms = timed(kernel, flush=flush)
    plain = timed(lambda: L.ln_fwd_plain(x, w, b, eps), flush=flush)
    wl, bl = w.to(x.dtype), b.to(x.dtype)
    library = lambda: F.layer_norm(x, (1024,), wl, bl, eps)  # noqa: E731
    lib = timed(library, flush=flush)
    dev_ms = device_ms(kernel, flush=flush)
    row("layer_norm_fwd", ms, plain, lib,
        nbytes=2 * nh * 2 + 2 * 1024 * 4, flops=0,
        dev_ms=dev_ms, lib_dev_ms=device_ms(library, flush=flush))
    log(f"kernel layer_norm_fwd: the wrapper's host time (events - device) "
        f"{ms - dev_ms:.4f} ms")
    kernel = lambda: L.ln_bwd_kernel(g, x, w, eps)  # noqa: E731
    ms = timed(kernel, flush=flush)
    plain = timed(lambda: L.ln_bwd_plain(g, x, w, eps), flush=flush)
    xg = x.detach().requires_grad_(True)
    wg = wl.detach().requires_grad_(True)
    bg = bl.detach().requires_grad_(True)
    yl = F.layer_norm(xg, (1024,), wg, bg, eps)
    library = lambda: torch.autograd.grad(  # noqa: E731
        yl, (xg, wg, bg), g, retain_graph=True)
    lib = timed(library, flush=flush)
    row("layer_norm_bwd", ms, plain, lib,
        nbytes=3 * nh * 2 + 3 * 1024 * 4, flops=0,
        dev_ms=device_ms(kernel, flush=flush),
        lib_dev_ms=device_ms(library, flush=flush))
    del xg, yl

    # --- cross-entropy: (8192, 30522) bf16, labels with -1
    n, v = 8192, 30522
    logits = rnd(n, v, std=3.0)
    labels = torch.randint(0, v, (n,), generator=gen, device=dev)
    labels[torch.rand(n, generator=gen, device=dev) < 0.15] = -1
    gl = torch.rand(n, generator=gen, device=dev)
    _, lse = X.xentropy_fwd_plain(logits, labels, 0.0)
    kernel = lambda: X.xentropy_fwd_kernel(logits, labels, 0.0)  # noqa: E731
    ms = timed(kernel, flush=flush)
    plain = timed(lambda: X.xentropy_fwd_plain(logits, labels, 0.0),
                  flush=flush)
    library = lambda: F.cross_entropy(  # noqa: E731
        logits, labels, ignore_index=-1, reduction="none")
    lib = timed(library, flush=flush)
    row("xentropy_fwd", ms, plain, lib,
        nbytes=n * v * 2 + n * 8 + 2 * n * 4, flops=0,
        dev_ms=device_ms(kernel, flush=flush),
        lib_dev_ms=device_ms(library, flush=flush))
    kernel = lambda: X.xentropy_bwd_kernel(  # noqa: E731
        logits, labels, lse, gl, 0.0)
    ms = timed(kernel, flush=flush)
    plain = timed(lambda: X.xentropy_bwd_plain(logits, labels, lse, gl, 0.0),
                  flush=flush)
    lg = logits.detach().requires_grad_(True)
    ll = F.cross_entropy(lg, labels, ignore_index=-1, reduction="none")
    glb = gl.to(ll.dtype)
    library = lambda: torch.autograd.grad(  # noqa: E731
        ll, lg, glb, retain_graph=True)
    lib = timed(library, flush=flush)
    row("xentropy_bwd", ms, plain, lib,
        nbytes=2 * n * v * 2 + n * 8 + 2 * n * 4, flops=0,
        dev_ms=device_ms(kernel, flush=flush),
        lib_dev_ms=device_ms(library, flush=flush))
    del logits, lg, ll
    time_xentropy_resnet(rnd, gen, flush)

    time_flash(rnd, gen, flush, row)
    time_flash_generic(rnd, gen, flush, row)
    time_arena_kernels(rnd, flush, row)
    time_arena_remainder(rnd, flush, row)
    time_bn_kernels(rnd, flush, row)
    time_bn_f32_fp8(rnd, flush, row)
    time_bn_dx_count(rnd, flush, row)
    time_sgd_kernel(rnd, flush, row)
    time_adam_kernel(rnd, flush, row)
    time_zero_kernels(rnd, flush, row)
    time_ring_hop_kernels(rnd, flush, row)
    time_mlp_kernel(rnd, flush, row)
    time_mlp_o1(rnd, flush, row)
    log(f"phase kernels: device_ms sessions lost at most {_LOST[0]} leading "
        f"kernel records (each opened with {_LEAD[0]} short spins)")


def sdpa_backend(fn):
    """The SDPA backend a call took, read from its device kernels' names
    in a guarded profiler session: "flash", "efficient" (the cutlass fmha
    kernels), "cudnn" or "math"."""
    _, ks = guarded_session(fn)
    names = " ".join(e.name for e in ks
                     if e.name not in _SPIN_NAMES).lower()
    for key, backend in (("fmha", "efficient"), ("efficient", "efficient"),
                         ("cudnn", "cudnn"), ("flash", "flash")):
        if key in names:
            return backend
    return "math"


def _flash_rows(name, q, k, v, do, scale, opts, flush, row, extra=0,
                family="flash_attn"):
    """Rows ``{family}_fwd{name}`` and ``{family}_bwd{name}``: each
    kernel beside its plain version and SDPA with the same mask and
    dropout rate (its mask differs, its work does not); the bound at the
    peak of q's dtype (f32: the f32 rate, else the bf16 tensor cores)."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention as A

    b, s, h, d = q.shape
    rate = opts.get("rate", 0.0)
    bias = opts.get("bias")
    io = b * s * h * d * q.element_size()
    peak = F32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS
    hash_ops = HASH_OPS * b * h * s * s if rate else 0
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None if bias is None else bias.to(q.dtype)

    # at f32 SDPA's default dispatch takes its math backend (two GEMMs and
    # a softmax); the yardstick is its fused f32 kernel, the efficient
    # backend
    f32 = q.dtype == torch.float32

    def sdpa(qt=qt, kt=kt, vt=vt):
        from torch.nn.attention import SDPBackend, sdpa_kernel
        with (sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]) if f32
              else contextlib.nullcontext()):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, dropout_p=rate)
    fwd = lambda: A.flash_fwd_kernel(q, k, v, scale, **opts)  # noqa: E731
    if family != "flash_attn":
        log(f"kernel {family}_fwd{name}: SDPA ({str(q.dtype)[6:]}, "
            f"{'mask' if bias is not None else 'no mask'}, dropout {rate}) "
            f"takes the {sdpa_backend(sdpa)} backend")
    row(f"{family}_fwd{name}", timed(fwd, flush=flush),
        timed(lambda: A.flash_fwd_plain(q, k, v, scale, **opts),
              flush=flush), timed(sdpa, flush=flush),
        nbytes=4 * io + b * h * s * 4 + extra,
        flops=4 * b * h * s * s * d, int_ops=hash_ops, peak=peak,
        dev_ms=device_ms(fwd, flush=flush),
        lib_dev_ms=device_ms(sdpa, flush=flush))
    o, lse = fwd()
    delta = compile_check.delta_of(do, o)
    bwd = lambda: A.flash_bwd_kernel(  # noqa: E731
        q, k, v, do, lse, delta, scale, **opts)
    plain = timed(lambda: A.flash_bwd_plain(q, k, v, do, lse, delta, scale,
                                            **opts), flush=flush)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    og = sdpa(qg, kg, vg)
    dot = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        og, (qg, kg, vg), dot, retain_graph=True)
    row(f"{family}_bwd{name}", timed(bwd, flush=flush), plain,
        timed(sdpa_bwd, flush=flush),
        nbytes=7 * io + 2 * b * h * s * 4 + extra,
        flops=10 * b * h * s * s * d, int_ops=hash_ops, peak=peak,
        dev_ms=device_ms(bwd, flush=flush),
        lib_dev_ms=device_ms(sdpa_bwd, flush=flush))
    del qg, kg, vg, og


def time_flash(rnd, gen, flush, row):
    """The flash rows: BERT's (16, 512, 16, 64) bf16 as it is, with the
    padding bias and dropout 0.1, and at H = 15; the MHA benchmark's
    (128, 64, 16, 64) fp16 with dropout 0.1."""
    import torch
    i32 = torch.tensor([12345], dtype=torch.int32, device="cuda")
    for name, (b, s, h, d), dt, opts in (
            ("", (16, 512, 16, 64), torch.bfloat16, {}),
            ("_mask_dropout", (16, 512, 16, 64), torch.bfloat16, dict(
                bias=compile_check.padding_bias(gen, 16, 512), rate=0.1,
                seed=i32)),
            ("_h15", (16, 512, 15, 64), torch.bfloat16, {}),
            ("_s64", (MHA_B, MHA_S, MHA_HEADS, MHA_HIDDEN // MHA_HEADS),
             torch.float16, dict(rate=0.1, seed=i32))):
        q, k, v, do = (rnd(b, s, h, d, dtype=dt) for _ in range(4))
        extra = b * s * 4 if "bias" in opts else 0
        _flash_rows(name, q, k, v, do, 1.0 / math.sqrt(d), opts, flush,
                    row, extra)
        del q, k, v, do


def time_flash_generic(rnd, gen, flush, row):
    """The generic flash rows: BERT-Large's (16, 512, 16, 64) in f32 as it
    is and with the padding bias and dropout 0.1 (the library call is
    SDPA at f32; its backend is logged), and ViT-H/14's attention in
    bf16."""
    import torch
    i32 = torch.tensor([12345], dtype=torch.int32, device="cuda")
    # the sweep as an add, not ``zero_``: SDPA's f32 backward zeroes its
    # accumulators with the kernel ``zero_`` launches, so device_ms, which
    # counts the flush's kernels by name, could not tell them apart
    sweep = flush.__self__
    flush = lambda: sweep.add_(1)  # noqa: E731
    for name, (b, s, h, d), dt, opts in (
            ("", (16, 512, 16, 64), torch.float32, {}),
            ("_mask_dropout", (16, 512, 16, 64), torch.float32, dict(
                bias=compile_check.padding_bias(gen, 16, 512), rate=0.1,
                seed=i32)),
            ("_d80", VIT_H_SHAPE, torch.bfloat16, {})):
        q, k, v, do = (rnd(b, s, h, d, dtype=dt) for _ in range(4))
        extra = b * s * 4 if "bias" in opts else 0
        _flash_rows(name, q, k, v, do, 1.0 / math.sqrt(d), opts, flush,
                    row, extra, family="flash_generic")
        del q, k, v, do


def time_xentropy_resnet(rnd, gen, flush):
    """The cross-entropy kernels at ResNet-50's (256, 1000) bf16 logits,
    timed for the log (the rows keep the BERT-Large shape)."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import xentropy as X

    n, v = 256, 1000
    logits = rnd(n, v, std=3.0)
    labels = torch.randint(0, v, (n,), generator=gen, device=logits.device)
    gl = torch.full((n,), 1.0 / n, device=logits.device)
    _, lse = X.xentropy_fwd_plain(logits, labels, 0.0)
    times = [timed(f, flush=flush) for f in (
        lambda: X.xentropy_fwd_kernel(logits, labels, 0.0),
        lambda: X.xentropy_fwd_plain(logits, labels, 0.0),
        lambda: F.cross_entropy(logits, labels, reduction="none"),
        lambda: X.xentropy_bwd_kernel(logits, labels, lse, gl, 0.0),
        lambda: X.xentropy_bwd_plain(logits, labels, lse, gl, 0.0))]
    lg = logits.detach().requires_grad_(True)
    ll = F.cross_entropy(lg, labels, reduction="none")
    times.append(timed(lambda: torch.autograd.grad(
        ll, lg, gl.to(ll.dtype), retain_graph=True), flush=flush))
    b_fwd = (n * v * 2 + n * 8 + 2 * n * 4) / HBM_BYTES_PER_S * 1e3
    b_bwd = (2 * n * v * 2 + n * 8 + 2 * n * 4) / HBM_BYTES_PER_S * 1e3
    log(f"kernel xentropy at (256, 1000) bf16: fwd kernel {times[0]:.4f} ms "
        f"plain {times[1]:.4f} ms library {times[2]:.4f} ms bound "
        f"{b_fwd:.4f} ms (bytes); bwd kernel {times[3]:.4f} ms plain "
        f"{times[4]:.4f} ms library {times[5]:.4f} ms bound {b_bwd:.4f} ms "
        f"(bytes)")


def time_bn_sums(args, flush):
    """The sums kernel at a layer-1 join or a layer-4 unit, for the log:
    events and device time beside the byte bound (x and g read; z read and
    dr written at a join)."""
    from apex_tpu_torch.ops import bn_act as B
    x, mode = args[0], args[7]
    m, c = x.shape
    kernel = lambda: B.bn_sums_kernel(*args)  # noqa: E731
    nbytes = (4 if mode == "addrelu" else 2) * m * c * x.element_size()
    log(f"kernel bn_sums at {m}x{c} {mode}: kernel "
        f"{timed(kernel, flush=flush):.4f} ms, device "
        f"{device_ms(kernel, flush=flush):.4f} ms, bound "
        f"{(nbytes + 4 * c * 4) / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)")


def time_bn_kernels(rnd, flush, row):
    """Rows bn_sums and bn_dx at the ResNet-50 stem (3,211,264 x 64) bf16
    in "plain" mode, against the library calls that compute the same two
    functions without a ReLU mask: ``torch.batch_norm_backward_reduce``
    (Σg, Σg·(x−μ) and dγ, dβ) and ``torch.batch_norm_backward_elemt`` (dx
    from those sums), on the same channels-last bf16 tensor. "relu" mode,
    the two-pass autograd backward of ``F.batch_norm(training=True)`` and
    the sums kernel at a layer-1 join and a layer-4 unit are timed for the
    log."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import bn_act as B

    bf16 = torch.bfloat16
    for (m, c), mode in (((802816, 256), "addrelu"), ((12544, 2048),
                                                     "plain")):
        x, g, z, scale, bias, mean, invstd = compile_check.bn_inputs(rnd, m,
                                                                     c)
        time_bn_sums((x, g, z, scale, bias, mean, invstd, mode, bf16), flush)
        del x, g, z
    (m, c), n = (3211264, 64), 256
    x, g, z, scale, bias, mean, invstd = compile_check.bn_inputs(rnd, m, c)
    times, plain_out, dev = {}, None, {}
    for mode in ("plain", "relu"):
        args = (x, g, z, scale, bias, mean, invstd, mode, bf16)
        sums = B.bn_sums_plain(*args)[0]
        dx_args = (x, g, scale, bias, mean, invstd, sums, m, mode == "relu",
                   bf16)
        if mode == "plain":
            plain_out = (sums, B.bn_dx_plain(*dx_args))
        kernels = (lambda: B.bn_sums_kernel(*args),
                   lambda: B.bn_dx_kernel(*dx_args))
        times[mode] = [timed(f, flush=flush) for f in (
            kernels[0], lambda: B.bn_sums_plain(*args),
            kernels[1], lambda: B.bn_dx_plain(*dx_args))]
        if mode == "plain":
            dev["sums"], dev["dx"] = (device_ms(f, flush=flush)
                                      for f in kernels)
    # the library calls, on the NCHW view of the same channels-last rows
    xl, gl = (t.view(n, 112, 112, c).permute(0, 3, 1, 2) for t in (x, g))
    w = scale.float()
    red = torch.batch_norm_backward_reduce(gl, xl, mean, invstd, w,
                                           True, True, True)
    counts = torch.tensor([m], dtype=torch.int32, device=x.device)
    dxl = torch.batch_norm_backward_elemt(gl, xl, mean, invstd, w, red[0],
                                          red[1], counts)
    want_s, want_dx = plain_out
    lib_err = (
        max((red[0] - want_s[0]).abs().max().item(),
            (red[1] * invstd - want_s[1]).abs().max().item())
        / want_s.abs().max().item(),
        (dxl.permute(0, 2, 3, 1).reshape(m, c).float()
         - want_dx.float()).abs().max().item())
    libs = (lambda: torch.batch_norm_backward_reduce(
        gl, xl, mean, invstd, w, True, True, True),
        lambda: torch.batch_norm_backward_elemt(
            gl, xl, mean, invstd, w, red[0], red[1], counts))
    lib_sums, lib_dx = (timed(f, flush=flush) for f in libs)
    lib_dev = [device_ms(f, flush=flush) for f in libs]
    xg = xl.detach().requires_grad_(True)
    wg = w.detach().requires_grad_(True)
    bg = bias.float().requires_grad_(True)
    yl = F.batch_norm(xg, None, None, wg, bg, training=True, eps=1e-5)
    two_pass = timed(lambda: torch.autograd.grad(yl, (xg, wg, bg), gl,
                                                 retain_graph=True),
                     flush=flush)
    del red, dxl, xg, yl
    log(f"kernel bn_sums/bn_dx at the stem, 'relu' mode: sums kernel "
        f"{times['relu'][0]:.4f} ms plain {times['relu'][1]:.4f} ms; dx "
        f"kernel {times['relu'][2]:.4f} ms plain {times['relu'][3]:.4f} ms; "
        f"autograd backward of F.batch_norm (both passes, no mask) "
        f"{two_pass:.4f} ms; the library rows' calls agree with the plain "
        f"versions to {lib_err[0]:.3e} (sums, of their max) and "
        f"{lib_err[1]:.3e} (dx, abs)")
    k = times["plain"]
    row("bn_sums", k[0], k[1], lib_sums,
        nbytes=4 * m * c + 4 * c * 4, flops=5 * m * c, peak=F32_FLOPS,
        dev_ms=dev["sums"], lib_dev_ms=lib_dev[0])
    row("bn_dx", k[2], k[3], lib_dx,
        nbytes=6 * m * c + 6 * c * 4, flops=6 * m * c, peak=F32_FLOPS,
        dev_ms=dev["dx"], lib_dev_ms=lib_dev[1])


def time_bn_f32_fp8(rnd, flush, row):
    """Rows ``bn_sums_f32``/``bn_dx_f32`` (f32 x, g, γ, β: ResNet-50 at O0)
    timed in "plain" mode beside ``torch.batch_norm_backward_reduce``/
    ``_elemt`` on the same f32 tensor, and ``bn_sums_fp8``/``bn_dx_fp8``
    (the e4m3 x̂ of fp8 residuals with bf16 g, γ, β), which no library
    call takes, at the ResNet-50 stem (3,211,264 x 64)."""
    import torch
    from apex_tpu_torch.ops import bn_act as B

    (m, c), n = (3211264, 64), 256
    f32, bf16 = torch.float32, torch.bfloat16
    x = rnd(m, c, dtype=f32, std=2.0) + 0.5
    mean = x.mean(dim=0)
    invstd = torch.rsqrt(x.var(dim=0, unbiased=False) + 1e-5)
    g = rnd(m, c, dtype=f32) * 1e-3
    z = rnd(m, c, dtype=f32).clamp_min(0.0)
    scale, bias = rnd(c, dtype=f32, std=0.3) + 1.0, rnd(c, dtype=f32, std=0.3)
    x8 = ((x - mean) * invstd).to(B.XHAT_DTYPE)
    cases = {"f32": (x, g, z, scale, bias, f32, False),
             "fp8": (x8, g.to(bf16), z.to(bf16), scale.to(bf16),
                     bias.to(bf16), bf16, True)}
    for label, (xx, gg, zz, sc, bi, dt, xhat) in cases.items():
        args = (xx, gg, zz, sc, bi, mean, invstd, "plain", dt)
        sums = B.bn_sums_plain(*args, xhat=xhat)[0]
        dx_args = (xx, gg, sc, bi, mean, invstd, sums, m, False, dt)
        kernels = (lambda: B.bn_sums_kernel(*args, xhat=xhat),
                   lambda: B.bn_dx_kernel(*dx_args, xhat=xhat))
        t = [timed(f, flush=flush) for f in (
            kernels[0], lambda: B.bn_sums_plain(*args, xhat=xhat),
            kernels[1], lambda: B.bn_dx_plain(*dx_args, xhat=xhat))]
        dev = [device_ms(f, flush=flush) for f in kernels]
        lib, lib_dev = [None, None], [None, None]
        if not xhat:
            xl, gl = (v.view(n, 112, 112, c).permute(0, 3, 1, 2)
                      for v in (x, g))
            red = torch.batch_norm_backward_reduce(gl, xl, mean, invstd, sc,
                                                   True, True, True)
            counts = torch.tensor([m], dtype=torch.int32, device=x.device)
            libs = (lambda: torch.batch_norm_backward_reduce(
                gl, xl, mean, invstd, sc, True, True, True),
                lambda: torch.batch_norm_backward_elemt(
                    gl, xl, mean, invstd, sc, red[0], red[1], counts))
            lib = [timed(f, flush=flush) for f in libs]
            lib_dev = [device_ms(f, flush=flush) for f in libs]
            del red
        # bytes: x (or x̂) and g read once; dx written once; the vectors
        xb, gb = xx.element_size(), gg.element_size()
        row(f"bn_sums_{label}", t[0], t[1], lib[0],
            nbytes=(xb + gb) * m * c + (2 if xhat else 4) * c * 4,
            flops=(3 if xhat else 5) * m * c, peak=F32_FLOPS, dev_ms=dev[0],
            lib_dev_ms=lib_dev[0])
        row(f"bn_dx_{label}", t[2], t[3], lib[1],
            nbytes=(xb + 2 * gb) * m * c + 6 * c * 4,
            flops=(4 if xhat else 6) * m * c, peak=F32_FLOPS, dev_ms=dev[1],
            lib_dev_ms=lib_dev[1])


def time_bn_dx_count(rnd, flush, row):
    """Row bn_dx_count: the dx kernel with the group's count on the card,
    "plain" mode at the stem, beside ``torch.batch_norm_backward_elemt``,
    whose per-rank counts are a tensor on the card too."""
    import torch
    from apex_tpu_torch.ops import bn_act as B

    bf16 = torch.bfloat16
    (m, c), n = (3211264, 64), 256
    x, g, _z, scale, bias, mean, invstd = compile_check.bn_inputs(rnd, m, c)
    count = torch.full((), float(m), device=x.device)
    sums = B.bn_sums_plain(x, g, None, scale, bias, mean, invstd, "plain")[0]
    args = (x, g, scale, bias, mean, invstd, sums)
    kernel = lambda: B.bn_dx_kernel(*args, count, False, bf16)  # noqa: E731
    t = [timed(f, flush=flush) for f in (
        kernel, lambda: B.bn_dx_plain(*args, count, False, bf16))]
    xl, gl = (v.view(n, 112, 112, c).permute(0, 3, 1, 2) for v in (x, g))
    w = scale.float()
    red = torch.batch_norm_backward_reduce(gl, xl, mean, invstd, w, True,
                                           True, True)
    counts = torch.tensor([m], dtype=torch.int32, device=x.device)
    lib = lambda: torch.batch_norm_backward_elemt(  # noqa: E731
        gl, xl, mean, invstd, w, red[0], red[1], counts)
    row("bn_dx_count", t[0], t[1], timed(lib, flush=flush),
        nbytes=6 * m * c + 6 * c * 4 + 4, flops=6 * m * c, peak=F32_FLOPS,
        dev_ms=device_ms(kernel, flush=flush),
        lib_dev_ms=device_ms(lib, flush=flush))
    del red


def time_sgd_kernel(rnd, flush, row):
    """Row sgd at ResNet-50's one f32 partition; the library yardstick is
    ``torch._fused_sgd_`` over ResNet-50's 161 tensors."""
    import torch
    from apex_tpu_torch import arena, models
    from apex_tpu_torch.ops import _arena, optim_kernels as K

    dev = torch.device("cuda")
    f32 = torch.float32
    rspec = arena.plan(dict(models.ResNet50(device="meta").named_parameters()))
    n = rspec.partition("float32").buffer_len
    p, g, m = (rnd(n, dtype=f32), rnd(n, dtype=f32, std=1e-2),
               rnd(n, dtype=f32, std=1e-2))
    s = _arena.device_scalars((0.1, 0.9, 0.0, 0.0, 1.0, 0.0), dev)
    kernel = lambda: K.sgd_kernel(p, g, m, s, False, False)  # noqa: E731
    ms = timed(kernel, flush=flush)
    plain = timed(lambda: K.sgd_plain(p, g, m, s, False, False), flush=flush)
    lists = [list(arena.unflatten({"float32": t.clone()}, rspec).values())
             for t in (p, g, m)]
    library = lambda: torch._fused_sgd_(  # noqa: E731
        *lists, weight_decay=0.0, momentum=0.9, lr=0.1, dampening=0.0,
        nesterov=False, maximize=False, is_first_step=False)
    try:
        lib = timed(library, flush=flush)
        lib_dev = device_ms(library, flush=flush)
    except (RuntimeError, TypeError, AttributeError) as e:
        lib = lib_dev = None
        log(f"kernel sgd: library null: torch._fused_sgd_ did not run: {e}")
    row("sgd", ms, plain, lib, nbytes=20 * n, flops=6 * n,
        peak=F32_FLOPS, dev_ms=device_ms(kernel, flush=flush),
        lib_dev_ms=lib_dev)


def time_adam_kernel(rnd, flush, row):
    """Row adam at the DCGAN generator's one f32 partition; the library
    yardstick is ``torch._fused_adam_`` over the generator's 13 tensors
    (context only; the port does not call it)."""
    import torch
    from apex_tpu_torch import arena, models
    from apex_tpu_torch.ops import _arena, optim_kernels as K

    dev = torch.device("cuda")
    f32 = torch.float32
    gparams = dict(models.Generator(device="meta").named_parameters())
    gspec = arena.plan(gparams)
    n = gspec.partition("float32").buffer_len
    p, g = rnd(n, dtype=f32, std=0.02), rnd(n, dtype=f32, std=1e-2)
    m, v = rnd(n, dtype=f32, std=1e-3), rnd(n, dtype=f32, std=1e-2).square()
    s = _arena.device_scalars((2e-4, 0.5, 0.999, 1e-8, 0.0, 1 - 0.5 ** 3,
                               1 - 0.999 ** 3, 1.0), dev)
    kernel = lambda: K.adam_kernel(p, g, m, v, s, True)  # noqa: E731
    ms = timed(kernel, flush=flush)
    plain = timed(lambda: K.adam_plain(p, g, m, v, s, True), flush=flush)
    lists = [list(arena.unflatten({"float32": t.clone()}, gspec).values())
             for t in (p, g, m, v)]
    steps = [torch.full((), 3.0, device=dev) for _ in lists[0]]
    library = lambda: torch._fused_adam_(  # noqa: E731
        *lists, [], steps, lr=2e-4, beta1=0.5, beta2=0.999,
        weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False)
    try:
        lib = timed(library, flush=flush)
        lib_dev = device_ms(library, flush=flush)
    except (RuntimeError, TypeError, AttributeError) as e:
        lib = lib_dev = None
        log(f"kernel adam: library null: torch._fused_adam_ did not run: {e}")
    row("adam", ms, plain, lib, nbytes=28 * n, flops=18 * n,
        peak=F32_FLOPS, dev_ms=device_ms(kernel, flush=flush),
        lib_dev_ms=lib_dev)


def _mlp_chain(x, ws, bs, act, od=None):
    """The chain of ``torch.addmm`` + activation in f32 on the same
    operands (rounded to ``od`` first where given): the MLP rows' library
    yardstick (no single PyTorch call computes an MLP)."""
    import torch
    acts = {"relu": torch.relu, "sigmoid": torch.sigmoid}
    xr = x.float() if od is None else x.to(od).float()
    wr = [t.float() if od is None else t.to(od).float() for t in ws]
    br = [b.float() for b in bs] if bs else None

    def chain():
        h = xr
        for i, t in enumerate(wr):
            if i and od is not None:
                h = h.to(od).float()
            h = acts[act](torch.addmm(br[i], h, t) if br else torch.mm(h, t))
        return h
    return chain


def time_mlp_kernel(rnd, flush, row):
    """mlp_fwd timed with its plain version and the addmm chain in f32, TF32
    off, at the path's shape (the JSON row), the budget's edge and the
    ragged shape of the compile check (``compile_check.MLP_CASES``)."""
    import torch
    from apex_tpu_torch.ops import mlp as P

    for name, n, dims, act, bias, dt, wdt in compile_check.MLP_CASES:
        x, ws, bs = compile_check.mlp_operands(
            rnd, n, dims, act, bias, getattr(torch, dt), getattr(torch, wdt))
        ms = timed(lambda: P.mlp_fwd_kernel(x, ws, bs, act), flush=flush)
        plain = timed(lambda: P.mlp_fused_reference(x, ws, bs, act),
                      flush=flush)
        chain = _mlp_chain(x, ws, bs, act)
        lib = timed(chain, flush=flush)
        nbytes = (x.numel() + n * dims[-1]) * x.element_size() + sum(
            t.numel() * t.element_size() for t in ws + (bs or []))
        flops = 2 * n * sum(a * b for a, b in zip(dims, dims[1:]))
        if name == "path":
            row("mlp_fwd", ms, plain, lib, nbytes, flops, F32_FLOPS,
                dev_ms=device_ms(lambda: P.mlp_fwd_kernel(x, ws, bs, act),
                                 flush=flush),
                lib_dev_ms=device_ms(chain, flush=flush))
        else:
            bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
            log(f"kernel mlp_fwd {name} {n}x{list(dims)} {dt}: kernel "
                f"{ms:.4f} ms  plain {plain:.4f} ms  library (addmm chain, "
                f"f32) {lib:.4f} ms  bound {bound:.4f} ms (operations)")


def time_mlp_o1(rnd, flush, row):
    """The MLP kernel's half-operand mode (row mlp_fwd_o1 at "path") at the
    compile check's shapes (``compile_check.MLP_O1_CASES``), timed beside
    the plain version and the addmm + ReLU chain on the rounded operands
    upcast to f32 (the same function). The bound is at the tensor cores'
    bf16/fp16 rate: half operands, f32 sums."""
    import torch
    from apex_tpu_torch.ops import mlp as P

    f32 = torch.float32
    for label, n, dims, od, _want in compile_check.MLP_O1_CASES:
        od = getattr(torch, od)
        x, ws, bs = compile_check.mlp_operands(rnd, n, dims, "relu", True,
                                               f32, f32)
        chain = _mlp_chain(x, ws, bs, "relu", od)
        kernel = lambda: P.mlp_fwd_kernel(x, ws, bs, "relu", od)  # noqa
        ms = timed(kernel, flush=flush)
        plain = timed(lambda: P.mlp_fused_reference(x, ws, bs, "relu", od),
                      iters=3, flush=flush)
        lib = timed(chain, flush=flush)
        nbytes = (x.numel() + n * dims[-1]) * 4 + sum(
            t.numel() * 4 for t in ws + bs)
        flops = 2 * n * sum(a * c for a, c in zip(dims, dims[1:]))
        dev_ms = device_ms(kernel, flush=flush)
        # the function's products are of half operands with f32 sums: the
        # tensor cores' rate, though the kernel runs them as f32 FMAs
        if label == "path":
            row("mlp_fwd_o1", ms, plain, lib, nbytes, flops, BF16_FLOPS,
                dev_ms=dev_ms, lib_dev_ms=device_ms(chain, flush=flush))
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        log(f"kernel mlp_fwd_o1 {label} {n}x{list(dims)} f32, {od} "
            f"operands: kernel {ms:.4f} ms (device {dev_ms:.4f} ms)  plain "
            f"{plain:.4f} ms  library (addmm chain) {lib:.4f} ms  bound "
            f"{max(t_bytes, t_ops) * 1e3:.4f} ms "
            f"({'bytes' if t_bytes >= t_ops else 'operations'})")


def time_arena_kernels(rnd, flush, row):
    """Rows multi_tensor_l2norm, lamb_stage1 and lamb_stage2 at
    BERT-Large's one f32 partition (``buffer_len`` from ``arena.plan``);
    the l2norm's library yardstick ``torch.linalg.vector_norm``."""
    import torch
    from apex_tpu_torch.ops import _arena, multi_tensor as M
    from apex_tpu_torch.ops import optim_kernels as K

    dev = torch.device("cuda")
    f32 = torch.float32
    s1 = _arena.device_scalars((0.9, 0.999, 1e-6, 0.01, 1 - 0.9 ** 3,
                                1 - 0.999 ** 3, 0.5, 0.1), dev)
    s2 = _arena.device_scalars((1e-3,), dev)
    n = compile_check.buffer_len("BertLarge")
    p, g, r = (rnd(n, dtype=f32), rnd(n, dtype=f32, std=3.0),
               rnd(n, dtype=f32).abs())
    m, v = rnd(n, dtype=f32, std=0.1), rnd(n, dtype=f32, std=0.01).abs()
    u = K.lamb_stage1_plain(p, g, m, v, s1, True)[0]
    kernel = lambda: M.l2norm_kernel(g)  # noqa: E731
    library = lambda: torch.linalg.vector_norm(g)  # noqa: E731
    ms = timed(kernel, flush=flush)
    plain = timed(lambda: M.l2norm_plain(g), flush=flush)
    lib = timed(library, flush=flush)
    row("multi_tensor_l2norm", ms, plain, lib, nbytes=4 * n,
        flops=2 * n, peak=F32_FLOPS, dev_ms=device_ms(kernel, flush=flush),
        lib_dev_ms=device_ms(library, flush=flush))
    kernel = lambda: K.lamb_stage1_kernel(p, g, m, v, s1, True)  # noqa: E731
    ms = timed(kernel, flush=flush)
    plain = timed(lambda: K.lamb_stage1_plain(p, g, m, v, s1, True),
                  flush=flush)
    row("lamb_stage1", ms, plain, None, nbytes=28 * n,
        flops=15 * n, peak=F32_FLOPS, dev_ms=device_ms(kernel, flush=flush))
    kernel = lambda: K.lamb_stage2_kernel(p, u, r, s2)  # noqa: E731
    ms = timed(kernel, flush=flush)
    plain = timed(lambda: K.lamb_stage2_plain(p, u, r, s2), flush=flush)
    row("lamb_stage2", ms, plain, None, nbytes=16 * n,
        flops=3 * n, peak=F32_FLOPS, dev_ms=device_ms(kernel, flush=flush))


def time_arena_remainder(rnd, flush, row):
    """Rows 15d-f and 15i-j at BERT-Large's f32 partition. Library
    yardsticks: maxnorm ``torch.linalg.vector_norm(ord=inf)``, scale
    ``torch.mul(out=)``, Adagrad ``torch._fused_adagrad_`` over
    BERT-Large's 292 tensors (if this build has it on CUDA); axpby and
    NovoGrad have no single call."""
    import torch
    from apex_tpu_torch import arena, models
    from apex_tpu_torch.ops import multi_tensor as M
    from apex_tpu_torch.ops import optim_kernels as K

    dev = torch.device("cuda")
    f32 = torch.float32
    s_scale, s_axpby, s_ada, s_novo = compile_check.remainder_scalars()
    bspec = arena.plan(dict(models.BertLarge(device=dev).named_parameters()))
    n = bspec.partition("float32").buffer_len
    p, g = rnd(n, dtype=f32), rnd(n, dtype=f32, std=1e-2)
    h, m = rnd(n, dtype=f32, std=1e-2).square(), rnd(n, dtype=f32, std=1e-3)
    vpos = rnd(n, dtype=f32).abs() + 0.1
    lists = [list(arena.unflatten({"float32": t.clone()}, bspec).values())
             for t in (p, g, h)]
    steps = [torch.full((), 3.0, device=dev) for _ in lists[0]]
    ada = lambda: torch._fused_adagrad_(  # noqa: E731
        *lists, steps, lr=1e-2, lr_decay=0.0, weight_decay=1e-4,
        eps=1e-10, maximize=False)
    try:
        ada_lib = timed(ada, flush=flush)
        ada_lib_dev = device_ms(ada, flush=flush)
    except (RuntimeError, TypeError, AttributeError,
            NotImplementedError) as e:
        ada_lib = ada_lib_dev = None
        log(f"kernel adagrad: library null: torch._fused_adagrad_ did not "
            f"run on CUDA: {str(e).splitlines()[0]}")
    del lists, steps
    o = torch.empty_like(g)
    cases = {
        "multi_tensor_maxnorm": (
            lambda: M.maxnorm_kernel(g), lambda: M.maxnorm_plain(g),
            lambda: torch.linalg.vector_norm(g, ord=math.inf), 4 * n, n),
        "multi_tensor_scale": (
            lambda: M.scale_kernel(g, s_scale, f32),
            lambda: M.scale_plain(g, s_scale, f32),
            lambda: torch.mul(g, s_scale[0], out=o), 8 * n, n),
        "multi_tensor_axpby": (
            lambda: M.axpby_kernel(p, g, s_axpby, f32),
            lambda: M.axpby_plain(p, g, s_axpby, f32), None, 12 * n, 3 * n),
        "adagrad": (lambda: K.adagrad_kernel(p, g, h, s_ada, False),
                    lambda: K.adagrad_plain(p, g, h, s_ada, False), None,
                    20 * n, 10 * n),
        "novograd": (lambda: K.novograd_kernel(p, g, m, vpos, s_novo, False),
                     lambda: K.novograd_plain(p, g, m, vpos, s_novo, False),
                     None, 24 * n, 11 * n)}
    for name, (kernel, plain, lib, nbytes, flops) in cases.items():
        ms = timed(kernel, flush=flush)
        plain_ms = timed(plain, flush=flush)
        lib_ms = ada_lib if name == "adagrad" else (
            None if lib is None else timed(lib, flush=flush))
        lib_dev = ada_lib_dev if name == "adagrad" else (
            None if lib is None else device_ms(lib, flush=flush))
        row(name, ms, plain_ms, lib_ms, nbytes=nbytes, flops=flops,
            peak=F32_FLOPS,
            dev_ms=device_ms(kernel, flush=flush), lib_dev_ms=lib_dev)


def time_zero_kernels(rnd, flush, row):
    """Rows lamb_shard_stage{1,2} (LAMB's stages on rank 1's shard of
    BERT-Large's f32 partition at world size 2) and adam_e5m2_copy (the
    Adam kernel with an e5m2 copy at ResNet-50's f32 master partition)."""
    import torch
    from apex_tpu_torch import arena, models
    from apex_tpu_torch.ops import _arena, optim_kernels as K

    dev = torch.device("cuda")
    f32 = torch.float32
    enc = models.BertLarge(device=dev)
    spec = arena.plan(dict(enc.named_parameters()))
    del enc
    valid, _start, per = compile_check.shard_valid(spec, "float32", 2, 1)
    p, g = rnd(per, dtype=f32) * valid, rnd(per, dtype=f32, std=3.0) * valid
    m = rnd(per, dtype=f32, std=0.1) * valid
    v = rnd(per, dtype=f32, std=0.01).abs() * valid
    r = rnd(per, dtype=f32).abs() + 0.5
    s1 = _arena.device_scalars((0.9, 0.999, 1e-6, 0.01, 1 - 0.9 ** 3,
                                1 - 0.999 ** 3, 0.5, 0.1), dev)
    s2 = _arena.device_scalars((1e-3,), dev)
    u = K.lamb_stage1_plain(p, g, m, v, s1, True)[0]
    kernel = lambda: K.lamb_stage1_kernel(p, g, m, v, s1, True)  # noqa: E731
    row("lamb_shard_stage1", timed(kernel, flush=flush),
        timed(lambda: K.lamb_stage1_plain(p, g, m, v, s1, True),
              flush=flush), None, nbytes=28 * per, flops=15 * per,
        peak=F32_FLOPS, dev_ms=device_ms(kernel, flush=flush))
    kernel = lambda: K.lamb_stage2_kernel(p, u, r, s2)  # noqa: E731
    row("lamb_shard_stage2", timed(kernel, flush=flush),
        timed(lambda: K.lamb_stage2_plain(p, u, r, s2), flush=flush), None,
        nbytes=16 * per, flops=3 * per, peak=F32_FLOPS,
        dev_ms=device_ms(kernel, flush=flush))
    del p, g, m, v, u, r, valid

    n = compile_check.buffer_len("ResNet50")
    p = rnd(n, dtype=f32, std=0.05)
    g, m = rnd(n, dtype=f32, std=1e-2), rnd(n, dtype=f32, std=1e-3)
    v = rnd(n, dtype=f32, std=1e-2).square()
    s = _arena.device_scalars((1e-3, 0.9, 0.999, 1e-8, 0.0, 1 - 0.9 ** 3,
                               1 - 0.999 ** 3, 1.0), dev)
    e8 = torch.float8_e5m2
    kernel = lambda: K.adam_kernel(p, g, m, v, s, True, e8)  # noqa: E731
    row("adam_e5m2_copy", timed(kernel, flush=flush),
        timed(lambda: K.adam_plain(p, g, m, v, s, True, e8), flush=flush),
        None, nbytes=29 * n, flops=18 * n, peak=F32_FLOPS,
        dev_ms=device_ms(kernel, flush=flush))


def time_ring_hop_kernels(rnd, flush, row):
    """Rows flash_ring_hop_{fwd,bwd}: the flash kernels at a ring hop's
    shape (BERT-Large's heads, B2, a 4096-query shard against a 4096-key
    block, every key visible: causal offset +4096 read from the card),
    beside SDPA."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    b, s, h, d = RING_B, RING_S // SEQ_RANKS, RING_H, RING_D
    q, k, vv, do = (rnd(b, s, h, d) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    kw = dict(causal=True, causal_off=torch.tensor([s], dtype=torch.int32,
                                                   device=dev))
    io = b * s * h * d * 2
    fwd = lambda: A.flash_fwd_kernel(q, k, vv, scale, **kw)  # noqa: E731
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, vv))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
    row("flash_ring_hop_fwd", timed(fwd, flush=flush),
        timed(lambda: A.flash_fwd_plain(q, k, vv, scale, **kw), flush=flush),
        timed(sdpa, flush=flush), nbytes=4 * io + b * h * s * 4,
        flops=4 * b * h * s * s * d, dev_ms=device_ms(fwd, flush=flush),
        lib_dev_ms=device_ms(sdpa, flush=flush))
    o, lse = fwd()
    delta = compile_check.delta_of(do, o)
    bwd = lambda: A.flash_bwd_kernel(  # noqa: E731
        q, k, vv, do, lse, delta, scale, **kw)
    plain = timed(lambda: A.flash_bwd_plain(q, k, vv, do, lse, delta, scale,
                                            **kw), flush=flush)
    qg, kg_, vg = (t.detach().transpose(1, 2).requires_grad_(True)
                   for t in (q, k, vv))
    og = F.scaled_dot_product_attention(qg, kg_, vg)
    dot = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        og, (qg, kg_, vg), dot, retain_graph=True)
    row("flash_ring_hop_bwd", timed(bwd, flush=flush), plain,
        timed(sdpa_bwd, flush=flush), nbytes=7 * io + 2 * b * h * s * 4,
        flops=10 * b * h * s * s * d, dev_ms=device_ms(bwd, flush=flush),
        lib_dev_ms=device_ms(sdpa_bwd, flush=flush))


def train_bert_large(phase, rows, strategy="auto", optimizer=None,
                     per_step=None, mesh=None, collectives=None, steps=5,
                     **options):
    """``steps`` BERT-Large steps (B16, S512, O1 bf16) with
    ``FusedLAMB(lr=1e-3, strategy=strategy)``, or with ``optimizer``, built
    by ``train.build_bert_step`` (``options``: its ``dropout``/``padded``/
    ``policy``);
    checks every kernel's launches in those steps (``per_step``: the
    optimizer's kernels). With ``mesh`` the build and the steps run inside
    ``parallel.use_mesh(mesh)`` and ``collectives`` (a step's, by registry
    scope) are checked. Returns (losses, state, step ms)."""
    import torch
    from apex_tpu_torch import ops, parallel, train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    def bound():
        return (parallel.use_mesh(mesh) if mesh is not None
                else contextlib.nullcontext())

    opt = (dict(strategy=strategy) if optimizer is None
           else dict(optimizer=optimizer))
    with bound():
        step, state, (toks, labels), _policy, enc = train.build_bert_step(
            16, 512, **opt, **options)
    n_params = sum(p.numel() for p in enc.parameters())
    tx, how = ((type(optimizer).__name__, optimizer.strategy)
               if optimizer is not None else ("FusedLAMB", strategy))
    log(f"phase {phase}: built, {n_params} params, "
        f"{len(state.params)} tensors, {tx} strategy {how!r}"
        + (f", {options}: {int(step.attn_mask.sum())} of "
           f"{step.attn_mask.numel()} tokens real, "
           f"{int((labels >= 0).sum())} labels"
           if step.attn_mask is not None else ""))
    ops.reset_launch_counts()
    parallel.reset_collective_counts()
    times, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with bound():
            state, loss = step(state, toks, labels)
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launch_counts()
    issued = dict(parallel.collective_counts)
    if issued != {k: steps * v for k, v in (collectives or {}).items()}:
        raise AssertionError(f"{phase}: collectives in {steps} steps "
                             f"{issued}, expected {steps} x "
                             f"{collectives or {}}")
    if collectives:
        log(f"phase {phase}: collectives per step "
            f"{ {k: v // steps for k, v in issued.items()} }")
    for i, (l, t) in enumerate(zip(losses, times)):
        log(f"{phase} step {i}: loss {l:.6f}  {t:.2f} ms")
        if not math.isfinite(l):
            raise AssertionError(f"step {i} loss is not finite: {l}")
    if int(state.step.item()) != steps:
        raise AssertionError(f"state.step {int(state.step)} != {steps}")
    check_launches(phase, counts, dict(
        EXPECTED_PER_STEP, **(ARENA_PER_STEP if strategy == "arena" else {}),
        **(per_step or {})), rows, steps=steps)
    step_ms = sorted(times[1:])[len(times[1:]) // 2]
    train_bert_large.peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase {phase}: launches per step "
        f"{ {k: v // steps for k, v in counts.items()} }")
    log(f"phase {phase}: median step {step_ms:.2f} ms (steps 1-"
        f"{steps - 1}), "
        f"{16 / step_ms * 1e3:.2f} seq/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return losses, state, step_ms


def check_launches(phase, counts, per_step, rows, steps=5):
    """Every kernel of the package launched ``per_step`` times a step (0
    for those not named); records the path's counts in ``rows`` (None: a
    path whose counts are checked but not reported)."""
    for name, n in counts.items():
        want = steps * per_step.get(name, 0)
        if n != want:
            raise AssertionError(f"{phase}: {name}: {n} launches in {steps} "
                                 f"steps, expected {want}")
        if want and rows is not None:
            rows[name]["launches"] = n


def bert_large_steps(rows):
    """Phase 4: 5 BERT-Large steps with the default ("auto": tree) update,
    then the tree-LAMB update alone."""
    import torch
    from apex_tpu_torch.optim import FusedLAMB

    losses, state, step_ms = train_bert_large("bert_large", rows)

    # the tree-LAMB update alone, on this run's state
    grads = {k: torch.full_like(p, 1e-3) for k, p in state.params.items()}
    tx = FusedLAMB(lr=1e-3)
    lamb = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tx.step(grads, state.opt_state, state.params)
        torch.cuda.synchronize()
        lamb.append((time.perf_counter() - t0) * 1e3)
    lamb_ms = sorted(lamb[1:])[1]
    log(f"phase bert_large: tree-LAMB update {lamb_ms:.2f} ms = "
        f"{100 * lamb_ms / step_ms:.1f}% of the step")
    return losses


def take_phase_launches(phase, rows):
    """The extra rows that ``phase`` drives take their kernel's launches
    from the run ``check_launches`` just recorded for ``phase``; the others
    keep theirs."""
    for name, (kernel, _, driven_by) in {**EXTRA_ROWS, **EXTRA_BN_ROWS,
                                         **EXTRA_ZERO_ROWS, **EXTRA_O1_ROWS,
                                         **EXTRA_GENERIC_ROWS}.items():
        if driven_by == phase:
            rows[name]["launches"] = rows[kernel]["launches"]


def bert_large_dropout(rows):
    """BERT-Large as published: padding masks (lengths from [128, 512]) and
    attention dropout 0.1, 5 steps of the default update; 24 launches of
    each attention kernel a step (the rows timed at this path's shape take
    their launches from here) and finite losses."""
    _, _, step_ms = train_bert_large("bert_large_dropout", rows, dropout=0.1,
                                     padded=True)
    take_phase_launches("bert_large_dropout", rows)
    return step_ms


def bert_large_f32(rows):
    """Phase bert_large_f32: BERT-Large (B16 S512) in f32 end to end,
    ``build_bert_step(policy=Policy("O0", enabled=False))``, the arena
    FusedLAMB, BERT_F32_STEPS steps: 24 launches of each generic flash
    kernel a step and none of the wgmma ones, the LayerNorm and
    cross-entropy kernels at f32 (49 + 49, 1 + 1), finite losses; step
    ms, seq/s and peak GiB. Then a depth-2 first step through the kernels
    against the same step through the plain versions: the loss within
    BERT_F32_LOSS_TOL relative, every tensor's grads within
    BERT_F32_GRAD_TOL of its largest magnitude. The generic rows take
    their launches from the full-depth run; the other rows keep theirs."""
    import torch
    from apex_tpu_torch import amp, ops

    phase = "bert_large_f32"
    kept = {n: r["launches"] for n, r in rows.items()}
    policy = amp.Policy(opt_level="O0", enabled=False)
    losses, state, step_ms = train_bert_large(
        phase, rows, "arena", per_step=BERT_F32_PER_STEP,
        steps=BERT_F32_STEPS, policy=policy)
    dtypes = {p.dtype for p in state.params.values()}
    if dtypes != {torch.float32}:
        raise AssertionError(f"{phase}: params in {dtypes}, not f32")
    for n in rows:
        if n not in ("flash_generic_fwd", "flash_generic_bwd"):
            rows[n]["launches"] = kept[n]
    log(f"phase {phase}: " + json.dumps({
        "step_ms": round(step_ms, 3),
        "seq_s": round(16 / step_ms * 1e3, 2),
        "peak_gib": round(train_bert_large.peak_gib, 3),
        "losses": [round(v, 6) for v in losses]}))
    del state
    torch.cuda.empty_cache()

    enc = depth2_encoder()
    mp = {k: v.detach().requires_grad_(True)
          for k, v in enc.named_parameters()}
    toks, labels = _bert_inputs(16, 512)
    loss_fn = _mlm_fn(enc)

    def first_step():
        loss = loss_fn(mp, toks, labels)
        grads = torch.autograd.grad(loss, list(mp.values()))
        return loss.item(), {k: g.float() for k, g in zip(mp, grads)}

    ops.reset_launch_counts()
    loss_k, grads_k = first_step()
    counts = ops.launch_counts()
    if (counts["flash_generic_fwd"], counts["flash_generic_bwd"],
            counts["flash_attn_fwd"], counts["flash_attn_bwd"]) != (
                2, 2, 0, 0):
        raise AssertionError(f"{phase}: depth-2 step launched {counts}")
    with plain_versions():
        loss_p, grads_p = first_step()
    _close_grads(f"{phase} depth-2 kernel vs plain", grads_k, grads_p,
                 loss_k, loss_p, tol=BERT_F32_GRAD_TOL,
                 loss_tol=BERT_F32_LOSS_TOL)


def bert_large_arena(rows, tree_losses):
    """Phase 5: 5 BERT-Large steps with ``strategy="arena"`` from the same
    seed: one launch per step of each arena kernel, and every loss within
    1e-3 relative of the tree run's at the same step. Then one update from
    this run's state, arena against tree. Returns the losses."""
    losses, state, _ = train_bert_large("bert_large_arena", rows, "arena")
    for i, (a, t) in enumerate(zip(losses, tree_losses)):
        rel = abs(a - t) / abs(t)
        if not rel <= 1e-3:
            raise AssertionError(f"arena step {i} loss {a} vs tree {t}: "
                                 f"rel {rel:.2e} > 1e-3")
    log(f"phase bert_large_arena: losses within "
        f"{max(abs(a - t) / abs(t) for a, t in zip(losses, tree_losses)):.2e}"
        f" relative of the tree run's (limit 1e-3)")
    from apex_tpu_torch.optim import FusedLAMB
    arena_vs_tree_update(state.params, state.opt_state,
                         lambda s: FusedLAMB(lr=1e-3, strategy=s), TOL_UPDATE)
    return losses


def tree_slots(slots, spec):
    """Arena slots per tensor: a buffer slot unflattened, a slot of one
    value per tensor (NovoGrad's ``vnorm``, a (num_tensors,) vector per
    partition) read through each partition's tensor order."""
    from apex_tpu_torch import arena

    out = {}
    for name, bufs in slots.items():
        if all(b.numel() == len(spec.partition(dt).sizes)
               for dt, b in bufs.items()):
            out[name] = {spec.names[i]: bufs[dt][j]
                         for i, (dt, j) in enumerate(spec.leaf_partition)}
        else:
            out[name] = arena.unflatten(bufs, spec)
    return out


def arena_vs_tree_update(params, opt_state, make_tx, tols):
    """One update from the same params, grads and state, arena against
    tree: p and each slot compared per tensor (``tols``), the two timed
    alone in turns, and the device kernels of each counted by
    ``torch.profiler``. ``make_tx(strategy)`` builds the optimizer."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from apex_tpu_torch import arena
    from apex_tpu_torch.optim import FusedOptState

    spec = arena.plan(params)
    dev = next(iter(params.values())).device
    gen = torch.Generator(dev).manual_seed(1)
    grads = {k: torch.randn(p.shape, generator=gen, device=dev) * 1e-2
             for k, p in params.items()}
    txs = {"arena": make_tx("arena"), "tree": make_tx("tree")}
    states = {"arena": opt_state, "tree": FusedOptState(
        count=opt_state.count, slots=tree_slots(opt_state.slots, spec))}

    def update(name):
        return txs[name].step(grads, states[name], params)

    (pa, sa), (pt, st) = update("arena"), update("tree")
    got = {"p": pa, **tree_slots(sa.slots, spec)}
    want = {"p": pt, **st.slots}
    worst = {}
    for key, tol in tols.items():
        errs = torch.stack([
            (got[key][k] - want[key][k]).abs().max()
            / want[key][k].abs().max().clamp(min=1e-30) for k in params])
        worst[key] = errs.max().item()
        if not worst[key] <= tol:
            raise AssertionError(f"arena vs tree update: {key} differs by "
                                 f"{worst[key]:.3e} of a tensor's max > {tol}")
    del pa, sa, pt, st, got, want
    log(f"phase arena_vs_tree: one {type(txs['tree']).__name__} update from "
        f"the same state agrees, worst per-tensor error / max: "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))

    times = {"arena": [], "tree": []}
    for name in ("arena", "tree", "tree", "arena") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update(name)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    log(f"phase arena_vs_tree: update alone, median of 4 in turns: arena "
        f"{med['arena']:.2f} ms, tree {med['tree']:.2f} ms "
        f"(arena {sorted(times['arena'])}, tree {sorted(times['tree'])})")

    kernels = {}
    for name in txs:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            update(name)
            torch.cuda.synchronize()
        kernels[name] = len(device_kernels(prof))
    seen = kernels["arena"] > 0 and kernels["tree"] > 0
    log(f"phase arena_vs_tree: device kernels in one update (torch.profiler):"
        f" arena {kernels['arena']}, tree {kernels['tree']}, "
        f"{len(params)} tensors"
        + ("" if seen else " (not measured: the profiler saw no device "
           "events)"))


def novograd(strategy):
    """The JAX package's own check's NovoGrad (``compile_check.py``)."""
    from apex_tpu_torch.optim import FusedNovoGrad
    return FusedNovoGrad(lr=1e-3, betas=(0.95, 0.98), eps=1e-8,
                         weight_decay=1e-3, strategy=strategy)


def adagrad(strategy):
    """The JAX package's own check's Adagrad (``compile_check.py``)."""
    from apex_tpu_torch.optim import FusedAdagrad
    return FusedAdagrad(lr=1e-2, weight_decay=1e-4, strategy=strategy)


def bert_large_remainder(rows, phase, make_tx, per_step, tols):
    """5 BERT-Large steps (B16, S512, O1 bf16) through
    ``train.build_bert_step(16, 512, optimizer=make_tx("arena"))``: finite
    losses, ``state.step`` 5, one launch a step of the optimizer's kernel
    and none of LAMB's, the attention, LN and CE launches of every BERT
    step. Then one update from this run's state, arena against tree.
    Returns the run's state."""
    _, state, _ = train_bert_large(phase, rows, optimizer=make_tx("arena"),
                                   per_step=per_step)
    arena_vs_tree_update(state.params, state.opt_state, make_tx, tols)
    return state


def multi_tensor_ops(rows, state):
    """Phase multi_tensor_ops: the public multi_tensor functions, one call
    each, on BERT-Large's f32 master arena from a training run, as amp
    uses them in the reference: the master-to-model copy (``scale`` by 1
    into bf16), a scaled gradient unscaled into a stashed one (``axpby``
    with 1/65536) and the L∞ norm of the sum (``maxnorm``). Each is held
    against its plain version on the same inputs; the flags are True."""
    import torch
    from apex_tpu_torch import arena, ops
    from apex_tpu_torch.ops import multi_tensor as M

    spec = arena.plan(state.params)
    p = arena.flatten(state.params, spec)["float32"]
    gen = torch.Generator(p.device).manual_seed(2)
    stash = torch.randn(p.shape, generator=gen, device=p.device) * 1e-3
    scaled = torch.randn(p.shape, generator=gen, device=p.device) * 64.0
    ops.reset_launch_counts()
    model, ok_copy = ops.multi_tensor_scale(p, 1.0,
                                            out_dtype=torch.bfloat16)
    acc, ok_acc = ops.multi_tensor_axpby(1.0, stash, 1.0 / 65536, scaled)
    norm = ops.multi_tensor_maxnorm(acc)
    check_launches("multi_tensor_ops", ops.launch_counts(), MULTI_TENSOR_OPS,
                   rows, steps=1)
    one = torch.ones(1, device=p.device)
    two = torch.tensor([1.0, 1.0 / 65536], device=p.device)
    check_flagged("multi_tensor_ops scale", (model, ok_copy),
                   M.scale_plain(p, one, torch.bfloat16))
    check_flagged("multi_tensor_ops axpby", (acc, ok_acc),
                   M.axpby_plain(stash, scaled, two, torch.float32))
    want = M.maxnorm_plain(acc)
    if not (bool(ok_copy) and bool(ok_acc) and norm.item() == want.item()):
        raise AssertionError(f"multi_tensor_ops: flags {bool(ok_copy)}, "
                             f"{bool(ok_acc)}; maxnorm {norm.item()} vs "
                             f"{want.item()}")
    log(f"phase multi_tensor_ops: scale, axpby, maxnorm once each on the "
        f"{p.numel()}-element master arena: agree with the plain versions, "
        f"flags True, L-inf norm {norm.item():.6e}")


def train_resnet50(phase, rows, strategy="auto", batch=256, opt_level="O2",
                   optimizer=None, model=None, per_step=None, report=True,
                   build_kw=None, collectives=None):
    """5 ResNet-50 steps (224x224, B256 and O2 bf16 unless given) with
    ``FusedSGD(lr=0.1, momentum=0.9, strategy=strategy)`` or ``optimizer``,
    built by ``train.build_resnet_step`` (``model``: a given ResNet-50;
    ``build_kw``: its data-parallel arguments; ``collectives``: the
    collectives a step by registry scope, checked);
    checks every kernel's launches in those steps (``per_step``, else the
    fused model's with the arena SGD's when ``strategy`` is "arena"), the
    step count and the running statistics; ``report=False`` keeps the
    counts out of the kernels' rows (the JAX package's experiment and
    oracle models, which launch the BN kernels another number of times
    than the path the rows report). Returns (losses, state, step ms, peak
    GiB)."""
    import torch
    from apex_tpu_torch import ops, parallel, train
    from apex_tpu_torch.ops import bn_act

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = (dict(strategy=strategy) if optimizer is None
           else dict(optimizer=optimizer))
    step, (state, bstats), (x, y), _policy, model = train.build_resnet_step(
        batch, 224, opt_level=opt_level, model=model, **opt,
        **(build_kw or {}))
    n_params = sum(p.numel() for p in model.parameters())
    tx, how = ((type(optimizer).__name__, optimizer.strategy)
               if optimizer is not None else ("FusedSGD", strategy))
    log(f"phase {phase}: built, {n_params} params, {len(state.params)} "
        f"tensors, input {tuple(x.shape)} {x.dtype}, {opt_level}, {tx} "
        f"strategy {how!r}")
    ops.reset_launch_counts()
    parallel.reset_collective_counts()
    copies = bn_act.layout_copies
    times, losses = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, bstats, loss = step(state, bstats, x, y)
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launch_counts()
    issued = dict(parallel.collective_counts)
    copies = bn_act.layout_copies - copies
    if issued != {k: 5 * v for k, v in (collectives or {}).items()}:
        raise AssertionError(f"{phase}: collectives in 5 steps {issued}, "
                             f"expected 5 x {collectives or {}}")
    if collectives:
        log(f"phase {phase}: collectives per step "
            f"{ {k: v // 5 for k, v in issued.items()} }")
    for i, (l, t) in enumerate(zip(losses, times)):
        log(f"{phase} step {i}: loss {l:.6f}  {t:.2f} ms")
        if not math.isfinite(l):
            raise AssertionError(f"step {i} loss is not finite: {l}")
    if int(state.step.item()) != 5:
        raise AssertionError(f"state.step {int(state.step)} != 5")
    if not torch.stack([torch.isfinite(v).all()
                        for v in bstats.values()]).all().item():
        raise AssertionError("a running statistic is not finite")
    check_launches(phase, counts, per_step if per_step is not None else dict(
        RESNET_PER_STEP, **(SGD_PER_STEP if strategy == "arena" else {})),
        rows if report else None)
    step_ms = sorted(times[1:])[len(times[1:]) // 2]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase {phase}: launches per step "
        f"{ {k: v // 5 for k, v in counts.items() if v} }, gradients "
        f"copied into the BN row layout per step {copies / 5:g}")
    log(f"phase {phase}: median step {step_ms:.2f} ms (steps 1-4), "
        f"{batch / step_ms * 1e3:.2f} img/s, peak memory {peak:.2f} GiB")
    return losses, state, step_ms, peak


def resnet50_arena(rows, tree_losses):
    """5 ResNet-50 steps with ``strategy="arena"`` from the same seed: one
    ``sgd`` launch a step, every loss within 1e-3 relative of the tree
    run's. Then one SGD update from this run's state, arena against tree."""
    from apex_tpu_torch.optim import FusedSGD

    losses, state, _, _ = train_resnet50("resnet50_arena", rows, "arena")
    rel = [abs(a - t) / max(abs(t), 1e-30)
           for a, t in zip(losses, tree_losses)]
    if not max(rel) <= 1e-3:
        raise AssertionError(f"arena losses {losses} vs tree {tree_losses}: "
                             f"rel {max(rel):.2e} > 1e-3")
    log(f"phase resnet50_arena: losses within {max(rel):.2e} relative of "
        f"the tree run's (limit 1e-3)")
    arena_vs_tree_update(
        state.params, state.opt_state,
        lambda s: FusedSGD(lr=0.1, momentum=0.9, strategy=s), TOL_SGD_UPDATE)


def resnet_plain_vs_kernel(phase="resnet_plain_vs_kernel", opt_level="O2",
                           batch=256, grad_tol=2e-2, loss_tol=5e-3):
    """One block per stage at full widths (224x224; B256, O2 bf16 unless
    given): the first step's gradients (per tensor, within ``grad_tol`` of
    the tensor's max: at O2 2e-2, bf16 activations, and ReLU-threshold ties
    may flip a mask bit where the sums differ in order) and the second
    step's loss (within ``loss_tol`` relative) through the kernels and
    through the plain versions."""
    import torch
    from torch.func import functional_call
    from apex_tpu_torch import amp, models, ops, train
    from apex_tpu_torch.optim import FusedSGD

    grads, losses = {}, {}
    for mode in ("kernel", "plain"):
        model = models.ResNet(stage_sizes=[1, 1, 1, 1], dtype=amp.Policy
                              .from_opt_level(opt_level).compute_dtype)
        step, (state, bs), (x, y), policy, _ = train.build_resnet_step(
            batch, 224, opt_level=opt_level, model=model)
        amp_opt = amp.Amp(policy, FusedSGD(lr=0.1, momentum=0.9))

        def loss_fn(mp):
            logits, new = functional_call(model, {**mp, **bs}, (x,),
                                          {"train": True})
            return torch.mean(ops.softmax_cross_entropy_loss(logits, y)), new

        ops.reset_launch_counts()
        with (plain_versions() if mode == "plain"
              else contextlib.nullcontext()):
            _, grads[mode], _, _ = amp_opt.backward(state, loss_fn,
                                                    has_aux=True)
            for _ in range(2):
                state, bs, loss = step(state, bs, x, y)
        losses[mode] = loss.item()
        counts = ops.launch_counts()
        bn = (counts["bn_sums"], counts["bn_dx"])
        if mode == "kernel" and bn != (51, 51):
            raise AssertionError(f"kernel run: BN launches {bn}, expected "
                                 f"51 each (17 units, 3 backward passes)")
        if mode == "plain" and sum(counts.values()):
            raise AssertionError(f"plain run launched kernels: {counts}")
        del step, state, bs, model, amp_opt
        torch.cuda.empty_cache()
    errs = {k: ((grads["kernel"][k] - g).abs().max()
                / g.abs().max().clamp(min=1e-30)).item()
            for k, g in grads["plain"].items()}
    worst = max(errs, key=errs.get)
    rel = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
    log(f"phase {phase}: first-step grads of {len(errs)} "
        f"tensors, worst {errs[worst]:.2e} of the tensor's max ({worst}); "
        f"second-step loss kernel {losses['kernel']:.6f} plain "
        f"{losses['plain']:.6f} rel {rel:.2e}")
    if not errs[worst] <= grad_tol:
        raise AssertionError(f"kernel/plain grads of {worst} differ by "
                             f"{errs[worst]:.2e} of its max > {grad_tol}")
    if not rel <= loss_tol:
        raise AssertionError(f"kernel/plain loss differ by {rel:.2e} > "
                             f"{loss_tol}")


def resnet50_o0(rows):
    """Phase resnet50_o0: BASELINE configuration 1, ResNet-50 in f32 at O0,
    B128 (the first batch of ``bench.py``'s O0 sweep), FusedSGD "auto"
    (the tree update at 25.5M params), through the kernels in f32; then a
    one-block-per-stage O0 step at B128 through the kernels and the plain
    versions: first-step grads within 1e-3 of each tensor's max (f32 sums
    in another order), second-step loss within 1e-4 relative."""
    import torch
    log(f"phase resnet50_o0: torch.backends.cudnn.allow_tf32 "
        f"{torch.backends.cudnn.allow_tf32}, "
        f"torch.backends.cuda.matmul.allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32} (as chip_smoke.py's main "
        f"leaves them; the package sets neither)")
    train_resnet50("resnet50_o0", rows, batch=128, opt_level="O0")
    take_phase_launches("resnet50_o0", rows)
    torch.cuda.empty_cache()
    resnet_plain_vs_kernel("resnet50_o0_plain_vs_kernel", "O0", 128,
                           grad_tol=1e-3, loss_tol=1e-4)


def resnet50_adam(rows):
    """Phases resnet50_adam and resnet50_adam_arena: ResNet-50 at O2 bf16,
    B256, with ``FusedAdam(lr=1e-3)`` ("auto": the tree update), then with
    the arena (one ``adam`` launch a step), every loss within 1e-3
    relative of the tree run's; then one Adam update from the arena run's
    state, arena against tree, within ``TOL_UPDATE``."""
    import torch
    from apex_tpu_torch.optim import FusedAdam

    tree = train_resnet50("resnet50_adam", rows, optimizer=FusedAdam(lr=1e-3),
                          per_step=RESNET_PER_STEP)[0]
    torch.cuda.empty_cache()
    losses, state, _, _ = train_resnet50(
        "resnet50_adam_arena", rows,
        optimizer=FusedAdam(lr=1e-3, strategy="arena"),
        per_step=dict(RESNET_PER_STEP, **ADAM_PER_STEP))
    rel = max(abs(a - t) / max(abs(t), 1e-30) for a, t in zip(losses, tree))
    if not rel <= 1e-3:
        raise AssertionError(f"resnet50_adam_arena losses {losses} vs tree "
                             f"{tree}: rel {rel:.2e} > 1e-3")
    log(f"phase resnet50_adam_arena: losses within {rel:.2e} relative of "
        f"the tree run's (limit 1e-3)")
    arena_vs_tree_update(state.params, state.opt_state,
                         lambda s: FusedAdam(lr=1e-3, strategy=s), TOL_UPDATE)


@contextlib.contextmanager
def bn_operands(seen):
    """Count each BN unit's backward (one ``bn_sums`` and one ``bn_dx``
    launch on the card) by the dtype of its saved x operand and its
    ``fp8`` flag in ``seen`` (a Counter). The kernel wrappers count their
    own launches under their module names, so the watch is on
    ``bn_act._bwd``, which hands both that operand."""
    from apex_tpu_torch.ops import bn_act as B
    saved = B._bwd

    def watch(cfg, x, *args):
        seen[str(x.dtype).rpartition(".")[2], cfg.fp8] += 1
        return saved(cfg, x, *args)

    B._bwd = watch
    try:
        yield
    finally:
        B._bwd = saved


def resnet50_fp8(rows, base_loss, base_peak):
    """Phase resnet50_fp8: the ``resnet50`` phase (O2 bf16, FusedSGD, B256)
    with ``APEX_TPU_FP8_RESIDUALS=1``: every one of the 53 BN backwards a
    step (53 + 53 kernel launches) takes the e4m3 x̂ (``xhat=True``);
    step 0's loss within
    1e-6 relative of phase resnet50's (the forward is unchanged); losses
    finite; peak memory beside resnet50's."""
    import collections
    import os
    from apex_tpu_torch.ops import bn_act

    seen, old = collections.Counter(), os.environ.get(bn_act.FP8_ENV)
    os.environ[bn_act.FP8_ENV] = "1"
    try:
        with bn_operands(seen):
            losses, _, _, peak = train_resnet50("resnet50_fp8", rows)
    finally:
        if old is None:
            del os.environ[bn_act.FP8_ENV]
        else:
            os.environ[bn_act.FP8_ENV] = old
    want = {("float8_e4m3fn", True): 5 * 53}
    if dict(seen) != want:
        raise AssertionError(f"resnet50_fp8: BN backward operands "
                             f"{dict(seen)}, expected {want}")
    rel = abs(losses[0] - base_loss) / abs(base_loss)
    if not rel <= 1e-6:
        raise AssertionError(f"resnet50_fp8 step 0 loss {losses[0]} vs "
                             f"resnet50's {base_loss}: rel {rel:.2e} > 1e-6")
    take_phase_launches("resnet50_fp8", rows)
    log(f"phase resnet50_fp8: every BN backward (a bn_sums and a bn_dx "
        f"launch each) took the e4m3 x-hat ({dict(seen)}); step 0 loss "
        f"{losses[0]:.6f} vs resnet50's "
        f"{base_loss:.6f} (rel {rel:.2e}); peak memory {peak:.2f} GiB "
        f"against resnet50's {base_peak:.2f} GiB")


def _first_step(model, opt_level="O2", batch=256):
    """(loss, grads by name, launch counts) of one ``Amp.backward`` of
    ``model`` at 224x224 with FusedSGD, on ``build_resnet_step``'s seeded
    batch."""
    import torch
    from torch.func import functional_call
    from apex_tpu_torch import amp, ops, train
    from apex_tpu_torch.optim import FusedSGD

    _, (state, bs), (x, y), policy, _ = train.build_resnet_step(
        batch, 224, opt_level=opt_level, model=model)
    amp_opt = amp.Amp(policy, FusedSGD(lr=0.1, momentum=0.9))

    def loss_fn(mp):
        logits, new = functional_call(model, {**mp, **bs}, (x,),
                                      {"train": True})
        return torch.mean(ops.softmax_cross_entropy_loss(logits, y)), new

    ops.reset_launch_counts()
    (loss, _), grads, _, _ = amp_opt.backward(state, loss_fn, has_aux=True)
    return loss.item(), grads, ops.launch_counts()


def _close_grads(phase, got, want, loss, want_loss, tol=2e-2,
                 loss_tol=5e-3, l2_tol=None):
    """Per tensor within ``tol`` of the tensor's max (``tol`` None: only
    logged) and, with ``l2_tol``, within that relative L2 distance; loss
    within ``loss_tol`` relative; logs the worst."""
    errs = {k: ((got[k] - g).abs().max() / g.abs().max().clamp(min=1e-30))
            .item() for k, g in want.items()}
    worst = max(errs, key=errs.get)
    rel = abs(loss - want_loss) / abs(want_loss)
    l2 = max(((got[k] - g).norm() / g.norm().clamp(min=1e-30)).item()
             for k, g in want.items())
    log(f"phase {phase}: first-step grads of {len(errs)} tensors, worst "
        f"{errs[worst]:.2e} of the tensor's max ({worst}), median "
        f"{sorted(errs.values())[len(errs) // 2]:.2e}, worst relative L2 "
        f"{l2:.2e}; loss {loss:.6f} vs {want_loss:.6f}, rel {rel:.2e}")
    if l2_tol is not None and not l2 <= l2_tol:
        raise AssertionError(f"{phase}: a tensor's grads differ by "
                             f"{l2:.2e} relative L2 > {l2_tol}")
    if tol is not None and not errs[worst] <= tol:
        raise AssertionError(f"{phase}: grads of {worst} differ by "
                             f"{errs[worst]:.2e} of its max > {tol}")
    if not rel <= loss_tol:
        raise AssertionError(f"{phase}: loss differs by {rel:.2e} > "
                             f"{loss_tol}")


def dist_name(base, name, mode):
    """The name in a ``dx_distribute=mode`` ResNet of the fused baseline
    ``base``'s leaf ``name`` (the leaf map of the JAX package's
    ``tests/test_conv_bn.py``): under "all" each conv and its BN become
    one ConvBNAct (the projection ``ConvBNAct_2``, the join the last);
    under "join" the final 1x1 conv and the join BN become ``ConvBNAct_0``
    and the projection conv ``Conv_2``."""
    blk, mod, *rest = name.split(".")
    if not blk.startswith("BottleneckBlock_"):
        return name
    proj = getattr(base, blk).proj
    if mode == "all":
        units = {"Conv_0": 0, "_BN_0": 0, "Conv_1": 1, "_BN_1": 1}
        units.update({"Conv_3": 2, "_BN_2": 2, "Conv_2": 3, "_BN_3": 3}
                     if proj else {"Conv_2": 2, "_BN_2": 2})
        new = f"ConvBNAct_{units[mod]}"
    else:
        join = "_BN_3" if proj else "_BN_2"
        new = {"Conv_2": "ConvBNAct_0", join: "ConvBNAct_0",
               **({"Conv_3": "Conv_2"} if proj else {})}.get(mod, mod)
    if new.startswith("ConvBNAct") and rest[0] == "FusedBNAct_0":
        rest = rest[1:]
    return ".".join([blk, new, *rest])


def randomize_bn(model, seed=1):
    """Every BN unit's γ ~ 1 + 0.2·N(0, 1) and β ~ 0.2·N(0, 1), from a
    seeded generator: at initialisation each block's join has γ = 0, which
    zeroes its whole backward and would hide a fault there."""
    import torch
    gen = torch.Generator("cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith((".scale", ".bias")) and p.dim() == 1 \
                    and not name.startswith("Dense_"):
                noise = 0.2 * torch.randn(p.shape, generator=gen)
                p.copy_((noise + (1.0 if name.endswith(".scale") else 0.0))
                        .to(p.device))


def resnet_dx_distribute(rows):
    """Phase resnet_dx_distribute: one block per stage at full widths
    (224x224), BN γ and β drawn from a seed (``randomize_bn``), the fused
    baseline's parameters and statistics copied into
    ``dx_distribute="join"`` and ``"all"`` models, the sums kernel launched
    for all 17 units and the dx kernel for the 13 / 1 units left FusedBNAct:

    - O0 f32, B128: first-step grads within 1e-3 of each tensor's max and
      loss within 1e-5 of the fused baseline's (the same function in
      exact arithmetic: the wiring of every unit), and of the same model's
      run through the plain versions (the kernels inside ConvBNAct);
    - O2 bf16, B256: loss within 5e-3 of the baseline's; the grads against
      the baseline's and the plain versions' are logged, not gated: the
      distributed form adds separately rounded bf16 conv transposes whose
      per-channel mean terms cancel, so a last-bit change of the sums moves
      its grads by up to a tenth of a tensor's max (the JAX package's own
      bf16 fused-vs-"all" gap is 0.15 of a tensor's max on the CPU).

    Then ResNet-50 "all" trains 5 steps at O2 bf16, B256 (53 ``bn_sums``
    and 1 ``bn_dx`` launches a step)."""
    import torch
    from apex_tpu_torch import models

    bf16 = torch.bfloat16
    for opt_level, batch, dt in (("O0", 128, torch.float32),
                                 ("O2", 256, bf16)):
        exact = opt_level == "O0"
        base = models.ResNet(stage_sizes=[1, 1, 1, 1], dtype=dt)
        randomize_bn(base)
        want_loss, want, _ = _first_step(base, opt_level, batch)
        sd = base.state_dict()
        for mode, n_dx in (("join", 13), ("all", 1)):
            phase = f"resnet_dx_distribute ({mode}, {opt_level})"
            model = models.ResNet(stage_sizes=[1, 1, 1, 1], dtype=dt,
                                  dx_distribute=mode)
            names = {n: dist_name(base, n, mode) for n in sd}
            model.load_state_dict({names[n]: v for n, v in sd.items()})
            loss, grads, counts = _first_step(model, opt_level, batch)
            bn = (counts["bn_sums"], counts["bn_dx"])
            if bn != (17, n_dx):
                raise AssertionError(f"{phase}: BN launches {bn}, expected "
                                     f"(17, {n_dx})")
            _close_grads(f"{phase} against the fused baseline",
                         {n: grads[names[n]] for n in want}, want, loss,
                         want_loss, tol=1e-3 if exact else None,
                         loss_tol=1e-5 if exact else 5e-3)
            with plain_versions():
                plain_loss, plain, counts = _first_step(model, opt_level,
                                                        batch)
            if sum(counts.values()):
                raise AssertionError(f"{phase}: the plain run launched "
                                     f"kernels: {counts}")
            _close_grads(f"{phase} kernel against plain", grads, plain, loss,
                         plain_loss, tol=1e-3 if exact else None,
                         loss_tol=1e-5 if exact else 5e-3)
            del model, grads, plain
        del base, want
        torch.cuda.empty_cache()
    train_resnet50("resnet_dx_distribute", rows,
                   model=models.ResNet50(dtype=bf16, dx_distribute="all"),
                   per_step=RESNET_ALL_PER_STEP, report=False)


def resnet_unfused(rows):
    """Phase resnet_unfused: ResNet-50 with ``fused_bn=False`` (flax
    BatchNorm under autograd, the JAX package's autodiff oracle), O2 bf16,
    B256, 5 steps with no BN kernel launch; then one block per stage (BN γ
    and β from a seed) with the fused model's parameters copied in
    (``FusedBNAct_0`` → ``BatchNorm_0``), first-step grads against the
    fused model's through the kernels:

    - O0 f32, B128: each tensor within 2e-2 in relative L2, loss within
      1e-5. Measured on the H100: 4.1e-3 in relative L2, but up to 2.3e-2
      of a tensor's max, and 3.6e-2 with the fused moments exact
      (``torch.var_mean``): autodiff of the one-pass E[x²] − E[x]² in
      f32 cancels where |mean| ≫ std, so the oracle itself is that far
      off at the last block's few elements;
    - O2 bf16, B256: loss within 5e-3; grads logged only (bf16 first-step
      grads of either model are ~45% from the f32 grads in relative L2 on
      the CPU, so the two differ by as much)."""
    import torch
    from apex_tpu_torch import models

    bf16 = torch.bfloat16
    train_resnet50("resnet_unfused", rows,
                   model=models.ResNet50(dtype=bf16, fused_bn=False),
                   per_step=RESNET_UNFUSED_PER_STEP, report=False)
    torch.cuda.empty_cache()
    for opt_level, batch, dt in (("O0", 128, torch.float32),
                                 ("O2", 256, bf16)):
        base = models.ResNet(stage_sizes=[1, 1, 1, 1], dtype=dt)
        randomize_bn(base)
        want_loss, want, _ = _first_step(base, opt_level, batch)
        model = models.ResNet(stage_sizes=[1, 1, 1, 1], dtype=dt,
                              fused_bn=False)
        rename = {n: n.replace(".FusedBNAct_0.", ".BatchNorm_0.")
                  for n in base.state_dict()}
        model.load_state_dict({rename[n]: v
                               for n, v in base.state_dict().items()})
        loss, grads, counts = _first_step(model, opt_level, batch)
        if counts["bn_sums"] or counts["bn_dx"]:
            raise AssertionError(f"resnet_unfused: BN kernels launched "
                                 f"{counts}")
        exact = opt_level == "O0"
        _close_grads(f"resnet_unfused (one block per stage, {opt_level})",
                     {n: grads[rename[n]] for n in want}, want, loss,
                     want_loss, tol=None, l2_tol=2e-2 if exact else None,
                     loss_tol=1e-5 if exact else 5e-3)
        del base, model, want, grads
        torch.cuda.empty_cache()


# --- data parallelism: BASELINE configuration 3 ------------------------------

# the two-rank phase: one-block-per-stage ResNet at full widths, O0 f32, this
# many images a rank (and the single-process reference at WORLD x as many)
TWO_RANKS, TWO_RANKS_BATCH = 2, 32


def dist_init():
    """Phase dist_init: an NCCL process group of world size 1 over a
    ``file://`` store in a temporary directory (no network), its
    ``device_id`` set, through ``parallel.distributed_init``; one
    all-reduce starts the communicator. Returns (the ``data`` mesh, the
    store's directory)."""
    import tempfile
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import parallel

    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    parallel.distributed_init(init_method=f"file://{store}/store",
                              num_processes=1, process_id=0, timeout_s=300)
    mesh = parallel.data_parallel_mesh()
    warm = torch.ones(1, device="cuda")
    dist.all_reduce(warm)
    torch.cuda.synchronize()
    log(f"phase dist_init: backend {dist.get_backend()}, world "
        f"{dist.get_world_size()}, NCCL "
        f"{'.'.join(map(str, torch.cuda.nccl.version()))}, {mesh}")
    return mesh, store


def resnet50_syncbn(rows, base_losses):
    """Phase resnet50_syncbn: BASELINE configuration 3, the JAX bench's
    ``_bench_resnet(sync_bn=True)``: ResNet-50 with every BN unit's
    statistics across the ``data`` axis, O2 bf16, B256, FusedSGD ("auto":
    the tree update), ``sync_gradients`` over ``data`` after the amp
    backward, 5 steps on NCCL at world size 1 (every collective issued as
    at any world size). 53 + 53 BN kernel launches a step, the collectives
    of ``SYNCBN_COLLECTIVES``; losses within 1e-3 relative of phase
    resnet50's (at world 1 the combine is exact up to rounding)."""
    losses, _, _, _ = train_resnet50(
        "resnet50_syncbn", rows, build_kw=dict(bn_axis_name="data"),
        collectives=SYNCBN_COLLECTIVES)
    take_phase_launches("resnet50_syncbn", rows)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, base_losses))
    if not rel <= 1e-3:
        raise AssertionError(f"resnet50_syncbn losses {losses} vs resnet50's "
                             f"{base_losses}: rel {rel:.2e} > 1e-3")
    log(f"phase resnet50_syncbn: losses within {rel:.2e} relative of phase "
        f"resnet50's (limit 1e-3)")
    return losses


def resnet50_syncbn_arena(rows, tree_losses, mesh):
    """Phase resnet50_syncbn_arena: the same with
    ``DistributedDataParallel(mesh, delay_allreduce=True)`` (one flat f32
    all-reduce a step) and ``FusedSGD(strategy="arena")`` (one ``sgd``
    launch a step); losses within 1e-3 relative of the tree run's."""
    from apex_tpu_torch import parallel
    from apex_tpu_torch.optim import FusedSGD

    ddp = parallel.DistributedDataParallel(mesh, delay_allreduce=True)
    losses, _, _, _ = train_resnet50(
        "resnet50_syncbn_arena", rows,
        optimizer=FusedSGD(lr=0.1, momentum=0.9, strategy="arena"),
        per_step=dict(RESNET_PER_STEP, **SGD_PER_STEP),
        build_kw=dict(bn_axis_name="data", ddp=ddp),
        collectives=SYNCBN_ARENA_COLLECTIVES)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, tree_losses))
    if not rel <= 1e-3:
        raise AssertionError(f"resnet50_syncbn_arena losses {losses} vs the "
                             f"tree run's {tree_losses}: rel {rel:.2e} > 1e-3")
    log(f"phase resnet50_syncbn_arena: losses within {rel:.2e} relative of "
        f"the tree run's (limit 1e-3)")


def syncbn_units_sync_free(mesh):
    """Phase syncbn_units_sync_free: one forward and backward of each unit
    with statistics across the ``data`` axis (FusedBNAct alone and as a
    residual join, ConvBNAct 3x3, SyncBatchNorm) at a layer-1 shape (B256,
    56x56x64, bf16), once to warm up, then under
    ``torch.cuda.set_sync_debug_mode("error")``, where any operation that
    makes the host wait for the card raises: the group's count and
    statistics stay on the card. Each run issues the unit's two
    collectives and the BN kernels it should."""
    import torch
    from apex_tpu_torch import ops, parallel
    from apex_tpu_torch.ops import conv_bn

    bf16 = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(3)
    shape = (256, 56, 56, 64)
    x = torch.randn(shape, generator=gen, device="cuda").to(bf16) \
        .requires_grad_(True)
    r = torch.randn(shape, generator=gen, device="cuda").to(bf16)
    gz = torch.randn(shape, generator=gen, device="cuda").to(bf16)
    conv = conv_bn.ConvBNAct(64, 64, (3, 3), axis_name="data", dtype=bf16)
    with torch.no_grad():
        conv.weight.normal_(0.0, (1 / 576) ** 0.5, generator=gen)
    units = {
        "FusedBNAct": (ops.FusedBNAct(64, axis_name="data", dtype=bf16),
                       (x,), (1, 1)),
        "FusedBNAct join": (ops.FusedBNAct(64, axis_name="data",
                                           dtype=bf16), (x, r), (1, 1)),
        "ConvBNAct": (conv, (x,), (1, 0)),
        "SyncBatchNorm": (parallel.SyncBatchNorm(64, axis_name="data"), (x,),
                          (0, 0))}
    for name, (unit, args, (n_sums, n_dx)) in units.items():
        def run():
            stats = {}
            with parallel.use_mesh(mesh):
                unit(*args, train=True, stats=stats).backward(gz)
            return stats

        run()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        parallel.reset_collective_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            stats = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        counts = ops.launch_counts()
        issued = dict(parallel.collective_counts)
        if (counts["bn_sums"], counts["bn_dx"]) != (n_sums, n_dx) or \
                issued != {"sync_batchnorm": 2}:
            raise AssertionError(f"syncbn_units_sync_free {name}: launches "
                                 f"{counts}, collectives {issued}")
        if not all(torch.isfinite(v).all().item() for v in stats[unit]):
            raise AssertionError(f"{name}: running statistics not finite")
    log(f"phase syncbn_units_sync_free: {', '.join(units)} ran forward and "
        f"backward under set_sync_debug_mode('error') with no host sync, "
        f"each with its two collectives and BN kernels")


def two_ranks_model(kind, axis_name):
    """The one-block-per-stage ResNet at full widths in f32 (``kind``
    "fused": FusedBNAct units; "all": ``dx_distribute="all"``), seed 0, BN
    γ and β drawn by ``randomize_bn``."""
    from apex_tpu_torch import models
    model = models.ResNet(stage_sizes=[1, 1, 1, 1], bn_axis_name=axis_name,
                          dx_distribute=None if kind == "fused" else "all")
    randomize_bn(model)
    return model


def two_ranks_step(kind, mesh, batch, plain):
    """(loss, grads, launch counts) of one O0 step's ``Amp.backward`` at
    224x224 over ``build_resnet_step``'s seeded global batch ``batch``:
    with ``mesh``, this rank's rows, BN statistics across ranks and the
    gradients synced by ``sync_gradients``; through the plain versions
    when ``plain``."""
    import torch
    from torch.func import functional_call
    from apex_tpu_torch import amp, ops, parallel, train
    from apex_tpu_torch.optim import FusedSGD

    model = two_ranks_model(kind, None if mesh is None else "data")
    kw = {} if mesh is None else dict(bn_axis_name="data")
    _, (state, bs), (x, y), policy, _ = train.build_resnet_step(
        batch, 224, opt_level="O0", model=model, **kw)
    amp_opt = amp.Amp(policy, FusedSGD(lr=0.1, momentum=0.9))

    def loss_fn(mp):
        logits, new = functional_call(model, {**mp, **bs}, (x,),
                                      {"train": True})
        return torch.mean(ops.softmax_cross_entropy_loss(logits, y)), new

    ops.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        if plain:
            stack.enter_context(plain_versions())
        if mesh is not None:
            stack.enter_context(parallel.use_mesh(mesh))
        (loss, _), grads, _, _ = amp_opt.backward(state, loss_fn,
                                                  has_aux=True)
        if mesh is not None:
            grads = parallel.sync_gradients(grads, "data")
    torch.cuda.synchronize()
    return loss.item(), grads, ops.launch_counts()


def two_ranks_rank(rank, world):
    """One rank of phase syncbn_two_ranks (a gloo group on ``cuda:0``, see
    ``_run_rank``): both models through the kernels and through the plain
    versions."""
    from apex_tpu_torch import parallel
    mesh = parallel.data_parallel_mesh()
    out = {}
    for kind in ("fused", "all"):
        for plain in (False, True):
            loss, grads, counts = two_ranks_step(kind, mesh,
                                                 TWO_RANKS_BATCH * world,
                                                 plain)
            out[kind, plain] = (loss, {k: v.cpu() for k, v in
                                       grads.items()}, counts)
    return out


def two_ranks_body(rank, world, tmp):
    _run_rank(two_ranks_rank, rank, world, tmp)


def _is_bn_param(name):
    return name.endswith((".scale", ".bias")) and not name.startswith(
        "Dense_")


def syncbn_two_ranks():
    """Phase syncbn_two_ranks: two processes on ``cuda:0`` in a gloo group
    (NCCL takes one rank a card; gloo carries CUDA tensors for the
    all-reduce, all-gather and broadcast), the one-block-per-stage ResNet
    at full widths, O0 f32, 32 images a rank, fused and
    ``dx_distribute="all"``, with statistics across both ranks and the
    gradients synced; against one process on all 64 images without
    ``axis_name``:

    - the mean of the ranks' losses within 1e-4 relative of the full
      batch's;
    - every other gradient (convolutions, the Dense) within 2e-2 of the
      full batch's in relative L2, per tensor, and every BN unit's dγ and
      dβ (each rank's mean loss) within 2e-2 of 2x the full batch's: the
      unit returns its group's summed channel sums, as the JAX unit does
      (ROADMAP.md, caveats). The largest error relative to a tensor's max
      is logged: the units' one-pass f32 moments, E[x²] − E[x]², round
      otherwise over 32 rows a rank than over 64 and their backward
      amplifies it where |mean| ≫ std, up to 5.9e-2 of a tensor's max at
      the last block on an H100 (the unfused-vs-fused check of phase
      resnet_unfused meets the same amplification; ROADMAP.md, caveats);
    - both ranks' synced gradients equal bit for bit; the kernels against
      ``plain_versions()`` in the same two ranks within 1e-3 of each
      tensor's max (the same moments: f32 sums in another order), loss
      within 1e-4."""
    import torch

    ranks = _spawn("syncbn_two_ranks", two_ranks_body, TWO_RANKS)
    for kind, n_dx in (("fused", 17), ("all", 1)):
        loss_ref, ref, _ = two_ranks_step(kind, None,
                                          TWO_RANKS_BATCH * TWO_RANKS, False)
        ref = {k: v.cpu() for k, v in ref.items()}
        torch.cuda.empty_cache()
        (loss, got, counts), (ploss, plain, pcounts) = (
            ranks[0][kind, False], ranks[0][kind, True])
        if (counts["bn_sums"], counts["bn_dx"]) != (17, n_dx) or \
                sum(pcounts.values()):
            raise AssertionError(f"syncbn_two_ranks {kind}: launches "
                                 f"{counts}, plain run {pcounts}")
        for k, g in got.items():
            if not torch.equal(g, ranks[1][kind, False][1][k]):
                raise AssertionError(f"syncbn_two_ranks {kind}: {k} differs "
                                     f"between the ranks")
        errs = {"other": {}, "bn": {}}       # (max-relative, relative L2)
        for k, want in ref.items():
            want = want * (float(TWO_RANKS) if _is_bn_param(k) else 1.0)
            d = got[k] - want
            errs["bn" if _is_bn_param(k) else "other"][k] = (
                (d.abs().max() / want.abs().max().clamp(min=1e-30)).item(),
                (d.norm() / want.norm().clamp(min=1e-30)).item())
        kp = {k: ((got[k] - g).abs().max()
                  / g.abs().max().clamp(min=1e-30)).item()
              for k, g in plain.items()}
        rel = abs(loss - ploss) / abs(ploss)
        mean_loss = sum(r[kind, False][0] for r in ranks) / TWO_RANKS
        rel_full = abs(mean_loss - loss_ref) / abs(loss_ref)
        summary = []
        for name, d in errs.items():
            wmax = max(d, key=lambda k: d[k][0])
            wl2 = max(d, key=lambda k: d[k][1])
            summary.append(f"{name}: worst {d[wmax][0]:.2e} of a tensor's "
                           f"max ({wmax}), relative L2 {d[wl2][1]:.2e} "
                           f"({wl2}), {sum(v[0] > 1e-3 for v in d.values())}"
                           f" of {len(d)} tensors past 1e-3 of their max")
            if not d[wl2][1] <= 2e-2:
                raise AssertionError(f"syncbn_two_ranks {kind}: {name} grads "
                                     f"of {wl2} differ by {d[wl2][1]:.2e} in "
                                     f"relative L2 > 2e-2")
        worst = max(kp, key=kp.get)
        log(f"phase syncbn_two_ranks ({kind}): rank losses "
            f"{[r[kind, False][0] for r in ranks]}, mean {mean_loss:.6f} vs "
            f"the full batch's {loss_ref:.6f} (rel {rel_full:.2e}); synced "
            f"grads against the full batch's (BN dγ/dβ against 2x): "
            f"{'; '.join(summary)}; kernels against plain versions: worst "
            f"{kp[worst]:.2e} ({worst}), loss rel {rel:.2e}")
        if not kp[worst] <= 1e-3:
            raise AssertionError(f"syncbn_two_ranks {kind}: kernel/plain "
                                 f"grads of {worst} differ by "
                                 f"{kp[worst]:.2e} > 1e-3")
        if not (rel <= 1e-4 and rel_full <= 1e-4):
            raise AssertionError(f"syncbn_two_ranks {kind}: loss rel "
                                 f"{rel:.2e} (kernel/plain), {rel_full:.2e} "
                                 f"(ranks' mean/full batch) > 1e-4")




def bert_large_zero(rows, arena_losses, mesh):
    """Phase bert_large_zero, the slice's main path: BERT-Large (B16, S512,
    O1 bf16) trained 5 steps through ``train.build_bert_step(optimizer=
    DistributedFusedLAMB(lr=1e-3))`` inside ``parallel.use_mesh`` of the
    NCCL world-size-1 ``data`` mesh, every collective issued: one launch of
    each arena LAMB kernel a step and the five collectives of
    ``ZERO_COLLECTIVES``; losses within 1e-3 relative of phase
    bert_large_arena's (at world size 1 the sharded step is the arena
    step). The steps run as users run them, with
    ``APEX_TPU_AUTOTUNE=db``: the LayerNorm, cross-entropy and shard
    consults hit the committed DB where it holds their keys
    (``check_db_consults``). Step ms, seq/s and peak GiB are logged."""
    from apex_tpu_torch.ops import autotune
    from apex_tpu_torch.optim import DistributedFusedLAMB

    opt = DistributedFusedLAMB(lr=1e-3)
    autotune.reset_counters()
    with autotune_mode("db"):
        losses, state, step_ms = train_bert_large(
            "bert_large_zero", rows, optimizer=opt, per_step=ZERO_PER_STEP,
            mesh=mesh, collectives=ZERO_COLLECTIVES)
        shard = state.opt_state.slots["master"]["float32"].numel()
        check_db_consults("bert_large_zero", [autotune.fingerprint(
            "optimizer", (shard,), "float32")])
    take_phase_launches("bert_large_zero", rows)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, arena_losses))
    if not rel <= 1e-3:
        raise AssertionError(f"bert_large_zero losses {losses} vs the arena "
                             f"run's {arena_losses}: rel {rel:.2e} > 1e-3")
    held = sum(t.numel() * 4 for d in state.opt_state.slots.values()
               for t in d.values())
    want = opt.state_bytes(state.params, world=1)["sharded_bytes"]
    if held != want:
        raise AssertionError(f"bert_large_zero: the state holds {held} "
                             f"bytes, state_bytes says {want}")
    log(f"phase bert_large_zero: losses within {rel:.2e} relative of the "
        f"arena run's (limit 1e-3); median step {step_ms:.2f} ms, "
        f"{16 / step_ms * 1e3:.2f} seq/s, peak "
        f"{train_bert_large.peak_gib:.2f} GiB; optimizer state {held} bytes "
        f"(master, m, v shards at world size 1)")


def zero_adam_update(rows, mesh):
    """Phase zero_adam_update: one ``DistributedFusedAdam`` update on
    ResNet-50's O2 f32 masters (NCCL world size 1) against
    ``FusedAdam(strategy="arena")`` from the same state (the arena state
    after one update, carried into the sharded state), p, m and v per
    tensor within ``TOL_UPDATE``, with its collectives (one scatter, one
    gather) and one ``adam`` launch; then the update of the bf16 model
    params with ``param_gather_dtype=torch.float8_e5m2``: every gathered
    bf16 param equals its new f32 master rounded to e5m2, bit for bit."""
    import torch
    from apex_tpu_torch import arena, models, ops, parallel
    from apex_tpu_torch.optim import (DistributedFusedAdam, FusedAdam,
                                      ShardedOptState)

    dev = torch.device("cuda")
    model = models.ResNet50(dtype=torch.bfloat16, device=dev)
    masters = {k: p.detach().float() for k, p in model.named_parameters()}
    # the bf16 params O2 gives the model (Policy.cast_params casts all 161)
    half = {k: p.to(torch.bfloat16) for k, p in masters.items()}
    del model
    gen = torch.Generator(dev).manual_seed(5)
    g1, g2 = ({k: torch.randn(p.shape, generator=gen, device=dev) * 1e-2
               for k, p in masters.items()} for _ in range(2))
    kw = dict(lr=1e-3, weight_decay=0.01)
    tx = FusedAdam(strategy="arena", **kw)
    p1, st = tx.step(g1, tx.init(masters), masters)
    spec = arena.plan(p1)
    zst = ShardedOptState(count=st.count.clone(), slots={
        "master": arena.flatten(p1, spec, cast=torch.float32),
        "m": {dt: b.clone() for dt, b in st.slots["m"].items()},
        "v": {dt: b.clone() for dt, b in st.slots["v"].items()}})
    ztx = DistributedFusedAdam(**kw)
    ops.reset_launch_counts()
    parallel.reset_collective_counts()
    with parallel.use_mesh(mesh):
        zp, zst = ztx.step(g2, zst, p1)
    issued, launched = dict(parallel.collective_counts), ops.launch_counts()
    ap, ast = tx.step(g2, st, p1)
    if issued != {"zero/grad_scatter": 1, "zero/param_gather": 1} or \
            launched["adam"] != 1:
        raise AssertionError(f"zero_adam_update: collectives {issued}, adam "
                             f"launches {launched['adam']}")
    worst = {}
    for name, got, want in (
            ("p", zp, ap),
            ("m", arena.unflatten(zst.slots["m"], spec),
             arena.unflatten(ast.slots["m"], spec)),
            ("v", arena.unflatten(zst.slots["v"], spec),
             arena.unflatten(ast.slots["v"], spec))):
        errs = {k: ((got[k].float() - w.float()).abs().max()
                    / w.float().abs().max().clamp(min=1e-30)).item()
                for k, w in want.items()}
        k = max(errs, key=errs.get)
        worst[name] = (errs[k], k)
        if not errs[k] <= TOL_UPDATE[name]:
            raise AssertionError(f"zero_adam_update {name}: {k} differs by "
                                 f"{errs[k]:.2e} of its max > "
                                 f"{TOL_UPDATE[name]}")
    log(f"phase zero_adam_update: ResNet-50 ({len(masters)} tensors) one "
        f"sharded Adam update against the arena's from the same state: "
        f"worst {worst} (limits {TOL_UPDATE}); collectives {issued}")
    e8 = DistributedFusedAdam(param_gather_dtype=torch.float8_e5m2, **kw)
    with parallel.use_mesh(mesh):
        st8 = e8.init(half)
        ops.reset_launch_counts()
        new, st8 = e8.step(g2, st8, half)
    launched = ops.launch_counts()["adam"]
    rows["adam_e5m2_copy"]["launches"] = launched
    hspec = arena.plan(half)
    master = arena.unflatten(st8.slots["master"], hspec)
    bad = [k for k, p in new.items() if p.dtype != torch.bfloat16
           or not torch.equal(p, master[k].to(torch.float8_e5m2)
                              .to(torch.bfloat16))]
    if bad or launched != 1:
        raise AssertionError(f"zero_adam_update e5m2: {len(bad)} params "
                             f"({bad[:3]}) are not the e5m2 rounding of "
                             f"their masters; adam launches {launched}")
    log(f"phase zero_adam_update: param_gather_dtype=float8_e5m2: all "
        f"{len(new)} gathered bf16 params equal their new masters rounded "
        f"to e5m2, bit for bit (one adam launch with the e5m2 copy)")


def hierarchical_sync_world1():
    """Phase hierarchical_sync_world1: BERT-Large's f32 gradients (seeded
    normal) through ``DistributedDataParallel(comm_plan=plan_comm(dp1x1,
    dtypes=(dt,)))`` over a (``data_inter``, ``data_intra``) mesh of sizes
    (1, 1) on the NCCL world-size-1 group, each hop's wire dtype forced to
    None, bf16 and int8 in turn; every hop issued (scatter and gather over
    ``bucket00/ici``, the cross-node reduce over ``bucket00/dcn``). The
    synced gradients equal the input bit for bit for None and lie within
    the JAX suite's bounds for bf16 (3e-2) and int8 (5e-2)
    (``tests/test_comm_compress.py:154, 231``). Logs ms a sync."""
    import torch
    from apex_tpu_torch import models, parallel
    from apex_tpu_torch.lint.mesh_model import parse_mesh_spec

    dev = torch.device("cuda")
    enc = models.BertLarge(device=dev)
    shapes = {k: p.shape for k, p in enc.named_parameters()}
    del enc
    gen = torch.Generator(dev).manual_seed(11)
    grads = {k: torch.randn(sh, generator=gen, device=dev)
             for k, sh in shapes.items()}
    nbytes = 4 * sum(g.numel() for g in grads.values())
    mesh = parallel.make_mesh([("data_inter", 1), ("data_intra", 1)])
    model = parse_mesh_spec("dp1x1", link_bytes_per_s=PLAN_LINKS)
    for dt, bound, hops in ((None, 0.0, (2, 1)), ("bf16", 3e-2, (2, 1)),
                            ("int8", 5e-2, (4, 4))):
        plan = parallel.plan_comm(model, nbytes, dtypes=(dt,))
        ddp = parallel.DistributedDataParallel(mesh, comm_plan=plan)
        parallel.reset_collective_counts()
        synced = ddp.sync(grads)
        issued = dict(parallel.collective_counts)
        if issued != {"bucket00/ici": hops[0], "bucket00/dcn": hops[1]}:
            raise AssertionError(f"hierarchical_sync_world1 {dt}: "
                                 f"collectives {issued}")
        worst = 0.0
        for k, g in grads.items():
            if dt is None:
                if not torch.equal(synced[k], g):
                    raise AssertionError(f"hierarchical_sync_world1: {k} "
                                         f"changed with f32 hops")
                continue
            err = ((synced[k] - g).abs() - bound * g.abs()).max().item()
            worst = max(worst, ((synced[k] - g).abs()
                                / (g.abs() + bound)).max().item())
            if err > bound:
                raise AssertionError(f"hierarchical_sync_world1 {dt}: {k} "
                                     f"past rtol = atol = {bound}")
        del synced
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ddp.sync(grads)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        log(f"phase hierarchical_sync_world1: {plan.describe()}: "
            f"{nbytes / 2**20:.0f} MiB of gradients, "
            f"{sorted(times)[1]:.2f} ms a sync (median of 3), collectives "
            f"{issued}, worst |err| / (|g| + {bound}) {worst:.2e}")
    del grads


def _spawn(phase, target, world, timeout_s=600):
    """Run ``target(rank, world, tmp)`` in ``world`` spawned processes and
    return each rank's saved result (``tmp/rank{r}.pt``); raise with the
    ranks' tracebacks if one fails."""
    import multiprocessing
    import tempfile
    import torch

    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{phase}_")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, daemon=True, args=(r, world, tmp))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        errs = [open(f"{tmp}/rank{r}.err").read()[-3000:]
                for r in range(world) if os.path.exists(f"{tmp}/rank{r}.err")]
        shutil.rmtree(tmp, ignore_errors=True)
        raise AssertionError(f"{phase}: exit codes {codes}\n"
                             + "\n".join(errs))
    out = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
           for r in range(world)]
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase {phase}: {world} ranks ran in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def _gloo_rank(rank, world, tmp):
    """A gloo process group of ``world`` processes on ``cuda:0``."""
    import datetime
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/store", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=300))


def _run_rank(body, rank, world, tmp):
    """``body(rank, world)`` in a gloo group of the spawned processes."""
    import torch.distributed as dist

    def grouped(rank, world):
        _gloo_rank(rank, world, tmp)
        out = body(rank, world)
        dist.destroy_process_group()
        return out
    _run_solo(grouped, rank, world, tmp)


def _flat(tree):
    import torch
    return torch.cat([t.reshape(-1).float() for t in tree.values()])


def zero_rank(rank, world):
    """ZeRO on two ranks: BERT at full width, depth 2, O1 bf16, this rank's
    ``ZERO_RANK_BATCH`` rows of ``build_bert_step``'s seeded global batch:
    one ``DistributedFusedLAMB`` and one ``DistributedFusedAdam`` update
    each, held in the rank against one process's arena ``FusedLAMB`` /
    ``FusedAdam`` update with the mean of the ranks' gradients (the whole
    batch's gradient: each rank's loss is the mean over its rows); rank 0
    also takes the whole batch's gradient itself and reports its distance
    from that mean. Returns the errors, the new params' digest, the state's
    bytes and ``state_bytes``."""
    import torch
    import torch.distributed as dist
    from torch.func import functional_call
    from apex_tpu_torch import amp, parallel, train
    from apex_tpu_torch.models.transformer import _mlm_head
    from apex_tpu_torch.optim import (DistributedFusedAdam,
                                      DistributedFusedLAMB, FusedAdam,
                                      FusedLAMB)
    from apex_tpu_torch.parallel import collectives

    mesh = parallel.data_parallel_mesh()
    out = {}
    for name, zopt, ref in (
            ("lamb", DistributedFusedLAMB(lr=1e-3),
             FusedLAMB(lr=1e-3, strategy="arena")),
            ("adam", DistributedFusedAdam(lr=1e-3, weight_decay=0.01),
             FusedAdam(lr=1e-3, weight_decay=0.01, strategy="arena"))):
        with parallel.use_mesh(mesh):
            _, state, (toks, labels), policy, enc = train.build_bert_step(
                ZERO_RANK_BATCH * world, 512, encoder=depth2_encoder(),
                optimizer=zopt)
        app = amp.Amp(policy, zopt)

        def grads_of(tk, lb):
            def loss_fn(mp):
                with amp.auto_cast(policy):
                    hidden = functional_call(enc, mp, (tk, None),
                                             {"deterministic": True})
                    return _mlm_head(hidden, mp["tok_emb.weight"], lb)
            return app.backward(state, loss_fn)[1]

        n = ZERO_RANK_BATCH
        g = grads_of(toks[rank * n:(rank + 1) * n],
                     labels[rank * n:(rank + 1) * n])
        parallel.reset_collective_counts()
        with parallel.use_mesh(mesh):
            new = app.apply_gradients(state, g, True)
        issued = dict(parallel.collective_counts)
        # the reference: the mean of both ranks' gradients, one process's
        # arena update from the same masters
        flat = _flat(g)
        both = collectives.all_gather(flat, None, "check")
        mean = (both[0] + both[1]) / 2
        off, gmean = 0, {}
        for k, t in g.items():
            gmean[k] = mean[off:off + t.numel()].view(t.shape)
            off += t.numel()
        want, _ = ref.step(gmean, ref.init(state.params), state.params)
        errs = {k: (new.params[k] - w).abs().max().item()
                for k, w in want.items()}
        digest = _flat(new.params)
        peers = collectives.all_gather(digest, None, "check")
        held = sum(t.numel() * 4 for d in new.opt_state.slots.values()
                   for t in d.values())
        res = {"err": max(errs.values()), "worst": max(errs, key=errs.get),
               "bit_equal": bool(torch.equal(peers[0], peers[1])),
               "held": held,
               "state_bytes": zopt.state_bytes(state.params, world=world),
               "collectives": issued, "count": int(new.opt_state.count)}
        res["shard"] = zero_shard_report(app, new, g, zopt, mesh, world)
        if rank == 0:
            full = _flat(grads_of(toks, labels))
            res["full_vs_mean"] = ((full - mean).norm()
                                   / full.norm()).item()
        out[name] = res
        del state, new, g, both, want
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def zero_shard_report(app, state, grads, zopt, mesh, world):
    """``prof.shard_report`` of this rank's ZeRO state on the ``data``
    mesh, its classes from ``prof.memory_report`` of one more update:
    the ratio of the optimizer state's local to global bytes, the
    closure, and which classes' tensors are sharded by ``data``."""
    from apex_tpu_torch import parallel, prof
    from apex_tpu_torch.lint.mesh_model import MeshAxis, MeshModel
    with parallel.use_mesh(mesh):
        mem = prof.memory_report(
            lambda s: app.apply_gradients(s, grads, True), state)
    sr = prof.shard_report(state, MeshModel([MeshAxis("data", world)],
                                            {"ici": 1.0}, name="data"),
                           report=mem, optimizer=zopt)
    sharded = {}
    for r in sr.records:
        sharded.setdefault(r.cls, set()).add(r.sharded_by("data"))
    return {"ratio": sr.class_shard_ratio("optimizer_state"),
            "closure": list(sr.closure()),
            "sharded": {k: sorted(v) for k, v in sharded.items()},
            "sources": sorted({r.source for r in sr.records}),
            "axis": sr.axis_bytes("data")}


def ring_rank(rank, world):
    """Ring and Ulysses attention on two ranks over a ``seq`` mesh:
    BERT-Large's attention width at a global sequence of ``RING_S`` (bf16,
    seeded, the same on both ranks), this rank's shard; o and the q/k/v
    gradients (cotangent ``do``) of ring attention non-causal, causal and
    causal with dropout 0.1, and of Ulysses non-causal and causal; each
    run's kernel launches and collectives; Ulysses' dropout refusal; and a
    keep-mask probe of the ring (below)."""
    import torch
    from apex_tpu_torch import ops, parallel
    from apex_tpu_torch.parallel import collectives

    dev = torch.device("cuda")
    mesh = parallel.make_mesh([("seq", world)])
    b, s, h, d = RING_B, RING_S, RING_H, RING_D
    sl = s // world
    gen = torch.Generator(dev).manual_seed(7)
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    seed = torch.tensor([4321], dtype=torch.int32, device=dev)
    local = lambda t: t[:, rank * sl:(rank + 1) * sl].contiguous()  # noqa
    out = {}
    runs = (("ring", parallel.ring_attention, {}),
            ("ring_causal", parallel.ring_attention, {"causal": True}),
            ("ring_dropout", parallel.ring_attention,
             {"causal": True, "dropout_rate": 0.1, "dropout_seed": seed}),
            ("ulysses", parallel.ulysses_attention, {}),
            ("ulysses_causal", parallel.ulysses_attention, {"causal": True}))
    with parallel.use_mesh(mesh):
        for name, fn, kw in runs:
            ql, kl, vl = (local(t).requires_grad_(True) for t in (q, k, v))
            ops.reset_launch_counts()
            parallel.reset_collective_counts()
            o = fn(ql, kl, vl, "seq", **kw)
            (o.float() * local(do).float()).sum().backward()
            torch.cuda.synchronize()
            out[name] = {"o": o.detach().cpu(), "dq": ql.grad.cpu(),
                         "dk": kl.grad.cpu(), "dv": vl.grad.cpu(),
                         "dtype": str(o.dtype),
                         "launches": {kk: vv for kk, vv in
                                      ops.launch_counts().items() if vv},
                         "collectives": dict(parallel.collective_counts),
                         "staged": dict(collectives.staged)}
        try:
            parallel.ulysses_attention(local(q), local(k), local(v), "seq",
                                       dropout_rate=0.1, dropout_seed=seed)
            out["ulysses_dropout"] = "no error"
        except NotImplementedError as e:
            out["ulysses_dropout"] = str(e)
        out["mask"] = ring_mask_probe(rank, world)
    return out


def ring_mask_probe(rank, world):
    """The ring's dropout keep mask read out through ``ring_attention`` on
    this rank's query rows: B1, H2, D64, 512 rows a rank. With q = k = 0
    every score is equal, so o = Σ_j keep[r, j]·v[j]/(S(1 − rate)) over the
    global keys; v is the identity on a 64-key window (on the rank that
    holds it) and zero elsewhere, so o[r, c]·S·(1 − rate) is keep[r, j0 +
    c]. The windows sweep the global keys; returns this rank's rows of the
    mask read this way and of the single-device ``_keep_mask_dense`` of the
    global sequence."""
    import torch
    from apex_tpu_torch import parallel
    from apex_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    b, h, d, sl, rate = 1, 2, 64, 512, 0.1
    s = sl * world
    seed = torch.tensor([-97531], dtype=torch.int32, device=dev)
    zero = torch.zeros(b, sl, h, d, dtype=torch.bfloat16, device=dev)
    eye = torch.eye(d, dtype=torch.bfloat16, device=dev)
    got = torch.zeros(b * h, sl, s, dtype=torch.bool, device=dev)
    for j0 in range(0, s, d):
        v = torch.zeros_like(zero)
        if j0 // sl == rank:
            v[:, j0 - rank * sl:j0 - rank * sl + d] = eye[None, :, None, :]
        o = parallel.ring_attention(zero, zero, v, "seq", dropout_rate=rate,
                                    dropout_seed=seed)
        bits = o.float() * s * (1 - rate) > 0.5            # (b, sl, h, d)
        got[:, :, j0:j0 + d] = bits.transpose(1, 2).reshape(b * h, sl, d)
    want = A._keep_mask_dense(seed, b, h, s, s, 512, 512, rate)[
        :, rank * sl:(rank + 1) * sl]
    return {"wrong": int((got != want).sum()), "bits": want.numel(),
            "kept": want.float().mean().item()}


def zero_and_ring_body(rank, world, tmp):
    """One rank of phases zero_two_ranks and ring_two_ranks."""
    _run_rank(lambda r, w: {"zero": zero_rank(r, w),
                            "ring": ring_rank(r, w)}, rank, world, tmp)


def zero_and_ring_two_ranks(rows):
    """Phases zero_two_ranks and ring_two_ranks: two processes on
    ``cuda:0`` in one gloo group (NCCL takes one rank a card; gloo's
    send/recv, which the ring's permutes need, is staged through the host
    for CUDA tensors, ``collectives.GLOO_HOST_STAGED``).

    zero_two_ranks: per optimizer (``DistributedFusedLAMB``,
    ``DistributedFusedAdam``) the new params within 1e-5 / 1e-6 (the JAX
    suite's bounds, ``tests/test_distributed_optimizers.py:86, 185``) of
    one process's arena update with the mean of the ranks' gradients, both
    ranks' params bit for bit equal, each rank's state what
    ``state_bytes`` says and half the replicated state (ratio <= 0.51),
    and one scatter, one gather (and LAMB's three norm sums) issued;
    ``prof.shard_report`` of each rank's state: the optimizer state's
    local/global bytes 0.49-0.51, its slots sharded by ``data``, the
    params replicated over it, rows from the shard plan (``layout``),
    the per-axis table closing over ``memory_report``'s classes.

    ring_two_ranks: against single-process ``flash_attention_lse`` on the
    gathered sequence through the kernels, o and the q/k/v gradients within
    ``TOL16`` of the largest (bf16: the hand kernels take 16-bit inputs),
    for ring attention non-causal, causal and causal with dropout 0.1, and
    for Ulysses non-causal and causal; the ring's output in f32 (the merge
    promotes), Ulysses' in bf16; the ring's keep mask read out through the
    ring bit for bit the single-device mask; Ulysses' dropout refused; per
    run and rank, 2 forward and 2 backward flash launches for the ring (4
    permutes) and 1 each for Ulysses (8 all-to-alls)."""
    import torch
    from apex_tpu_torch.ops import attention as A

    ranks = _spawn("zero_two_ranks and ring_two_ranks", zero_and_ring_body,
                   SEQ_RANKS, timeout_s=900)
    for name, bound in (("lamb", 1e-5), ("adam", 1e-6)):
        per = [r["zero"][name] for r in ranks]
        sb = per[0]["state_bytes"]
        want_coll = {"zero/grad_scatter": 1, "zero/param_gather": 1}
        if name == "lamb":
            want_coll["zero/grad_norm"] = 3
        for r, res in enumerate(per):
            if not res["err"] <= bound:
                raise AssertionError(f"zero_two_ranks {name} rank {r}: "
                                     f"{res['worst']} differs by "
                                     f"{res['err']:.2e} > {bound}")
            if not res["bit_equal"] or res["count"] != 1 or \
                    res["collectives"] != want_coll:
                raise AssertionError(f"zero_two_ranks {name} rank {r}: "
                                     f"{res}")
            if res["held"] != sb["sharded_bytes"] or not sb["ratio"] <= 0.51:
                raise AssertionError(f"zero_two_ranks {name}: state "
                                     f"{res['held']} bytes, {sb}")
            shard = res["shard"]
            # the ZeRO slots are sharded by data (1/2 each; the step count
            # rides along, replicated, and the shards' padding is slack),
            # the params replicated over it; the table closes
            if (not 0.49 <= shard["ratio"] <= 0.51
                    or shard["sharded"].get("params") != [False]
                    or True not in shard["sharded"].get("optimizer_state",
                                                        [])
                    or not shard["closure"][0]
                    or shard["sources"] != ["layout"]):
                raise AssertionError(f"zero_two_ranks {name} rank {r}: "
                                     f"shard report {shard}")
        log(f"phase zero_two_ranks ({name}): params within "
            f"{max(p['err'] for p in per):.2e} of one process's arena "
            f"update on the mean gradient (limit {bound}), bit-equal on "
            f"both ranks; state {sb['sharded_bytes']} of "
            f"{sb['replicated_bytes']} bytes a rank (ratio "
            f"{sb['ratio']:.4f}); whole-batch gradient vs the ranks' mean: "
            f"relative L2 {per[0]['full_vs_mean']:.2e}; shard report: "
            f"optimizer state local/global {per[0]['shard']['ratio']:.5f}, "
            f"closure error {per[0]['shard']['closure'][1]:.2e}, data axis "
            f"{per[0]['shard']['axis']}")

    dev = torch.device("cuda")
    b, s, h, d = RING_B, RING_S, RING_H, RING_D
    gen = torch.Generator(dev).manual_seed(7)
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    seed = torch.tensor([4321], dtype=torch.int32, device=dev)
    refs = {"ring": {}, "ring_causal": {"causal": True},
            "ring_dropout": {"causal": True, "dropout_rate": 0.1,
                             "dropout_seed": seed},
            "ulysses": {}, "ulysses_causal": {"causal": True}}
    ring_launches = {}
    for name, kw in refs.items():
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        o = A.flash_attention_lse(qg, kg, vg, **kw)[0]
        (o.float() * do.float()).sum().backward()
        want = {"o": o.detach(), "dq": qg.grad, "dk": kg.grad, "dv": vg.grad}
        worst = {}
        for key, w in want.items():
            got = torch.cat([r["ring"][name][key] for r in ranks],
                            dim=1).to(dev)
            err = (got.float() - w.float()).abs().max().item()
            lim = TOL16 * w.float().abs().max().item()
            worst[key] = err
            if not err <= lim:
                raise AssertionError(f"ring_two_ranks {name}: {key} "
                                     f"{err:.3e} > {lim:.3e}")
        ring = name.startswith("ring")
        want_launch = ({"flash_attn_fwd": 2, "flash_attn_bwd": 2} if ring
                       else {"flash_attn_fwd": 1, "flash_attn_bwd": 1})
        want_coll = ({"ring_ppermute": 4} if ring
                     else {"ring_all_to_all": 8})
        for r, rk in enumerate(ranks):
            res = rk["ring"][name]
            if res["launches"] != want_launch or \
                    res["collectives"] != want_coll or \
                    res["dtype"] != ("torch.float32" if ring
                                     else "torch.bfloat16"):
                raise AssertionError(f"ring_two_ranks {name} rank {r}: "
                                     f"{res['launches']}, "
                                     f"{res['collectives']}, {res['dtype']}")
            if ring:
                for kname, n in res["launches"].items():
                    ring_launches[kname] = ring_launches.get(kname, 0) + (
                        n if r == 0 else 0)
        log(f"phase ring_two_ranks ({name}): o and grads within TOL16 of "
            f"single-device flash attention, max |err| "
            f"{ {kk: f'{vv:.2e}' for kk, vv in worst.items()} }; per rank "
            f"{ranks[0]['ring'][name]['launches']}, collectives "
            f"{ranks[0]['ring'][name]['collectives']}, staged through the "
            f"host {ranks[0]['ring'][name]['staged'] or 'none'}")
        del qg, kg, vg, o, want
    rows["flash_ring_hop_fwd"]["launches"] = ring_launches["flash_attn_fwd"]
    rows["flash_ring_hop_bwd"]["launches"] = ring_launches["flash_attn_bwd"]
    for r, rk in enumerate(ranks):
        if "batch-head mask coordinate" not in rk["ring"]["ulysses_dropout"]:
            raise AssertionError(f"ring_two_ranks: Ulysses' dropout on rank "
                                 f"{r}: {rk['ring']['ulysses_dropout']}")
        mask = rk["ring"]["mask"]
        if mask["wrong"]:
            raise AssertionError(f"ring_two_ranks mask probe rank {r}: "
                                 f"{mask['wrong']} of {mask['bits']} keep "
                                 f"bits differ from the single-device mask")
    log(f"phase ring_two_ranks: the ring's keep mask read through "
        f"ring_attention equals the single-device mask bit for bit "
        f"({sum(rk['ring']['mask']['bits'] for rk in ranks)} bits, kept "
        f"{ranks[0]['ring']['mask']['kept']:.4f}); Ulysses' dropout "
        f"refused; rank 0 launched {ring_launches} in the three ring runs")


def hierarchy_rank(rank, world):
    """One rank of phase hierarchy_four_ranks: small gradients (a (300, 7)
    tensor scaled by the rank and a (513,) one) with a residual of the
    rank's own through ``hierarchical_sync`` over the 2x2 (``data_inter``,
    ``data_intra``) mesh, each hop's wire dtype forced to None, bf16 and
    int8; and the flat f32 sync over a ``data`` mesh of the four."""
    import torch
    from apex_tpu_torch import parallel
    from apex_tpu_torch.lint.mesh_model import parse_mesh_spec

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(3)
    base = {"a": torch.randn(300, 7, generator=gen, device=dev),
            "b": torch.randn(513, generator=gen, device=dev)}
    g = {"a": base["a"] * float(rank + 1), "b": base["b"]}
    r_in = {k: torch.full_like(t, 0.01 * (rank + 1)) for k, t in g.items()}
    mesh = parallel.hierarchical_data_mesh(2)
    model = parse_mesh_spec("dp2x2", link_bytes_per_s=PLAN_LINKS)
    out = {"x": {k: (g[k] + r_in[k]).cpu() for k in g}}
    with parallel.use_mesh(mesh):
        for dt in (None, "bf16", "int8"):
            plan = parallel.plan_comm(model, 1 << 20, dtypes=(dt,))
            synced, r_out = parallel.hierarchical_sync(g, plan,
                                                       residual=r_in)
            out[str(dt)] = {"synced": {k: t.cpu() for k, t in synced.items()},
                            "residual": {k: t.cpu()
                                         for k, t in r_out.items()}}
    flat = parallel.make_mesh([("data", world)])
    with parallel.use_mesh(flat):
        out["flat"] = {k: t.cpu() for k, t in parallel.bucketed_all_reduce(
            {k: g[k] + r_in[k] for k in g}, "data").items()}
    return out


def hierarchy_body(rank, world, tmp):
    _run_rank(hierarchy_rank, rank, world, tmp)


def hierarchy_four_ranks():
    """Phase hierarchy_four_ranks: four processes on ``cuda:0`` in a gloo
    group, the hierarchical sync on a 2x2 (``data_inter``, ``data_intra``)
    mesh with residuals (the rank's gradients plus its residual are the
    sync's input x_r). None: equal to the flat f32 sync within 1e-6
    relative (two orders of the same four-term f32 sums). bf16 and int8:
    within the JAX suite's bounds of the exact mean (3e-2, 5e-2). The
    error feedback: bf16's residual is x_r's own cast error, bit for bit
    (every later bf16 hop carries bf16 values, and the rounding of the
    sums inside a bf16 collective reaches no residual, in JAX as here);
    int8's residuals are the hops' errors, each counted once (the sums run
    in f32 after dequantizing): 4·synced equals Σ_r (x_r − residual_r)
    within 1e-5 of Σ_r |x_r| (the f32 rounding of the sums), as it does
    for None with zero residuals."""
    import torch

    ranks = _spawn("hierarchy_four_ranks", hierarchy_body, 4)
    xs = {k: torch.stack([r["x"][k] for r in ranks]) for k in ranks[0]["x"]}
    exact = {k: x.mean(0) for k, x in xs.items()}
    for dt, bound in ((None, 1e-6), ("bf16", 3e-2), ("int8", 5e-2)):
        worst = 0.0
        for r, rk in enumerate(ranks):
            res = rk[str(dt)]
            for k, want in exact.items():
                got = res["synced"][k]
                if dt is None:
                    torch.testing.assert_close(got, rk["flat"][k], rtol=1e-6,
                                               atol=1e-6)
                torch.testing.assert_close(got, want, rtol=bound, atol=bound)
                e = res["residual"][k]
                if dt == "bf16":
                    x = xs[k][r]
                    if not torch.equal(e, x - x.bfloat16().float()):
                        raise AssertionError(f"hierarchy_four_ranks bf16 "
                                             f"rank {r} {k}: the residual is "
                                             f"not the local cast error")
        for k, x in xs.items():
            if dt == "bf16":
                continue
            synced = ranks[0][str(dt)]["synced"][k]
            sent = (x - torch.stack([rk[str(dt)]["residual"][k]
                                     for rk in ranks])).sum(0)
            err = (4 * synced - sent).abs().max().item()
            lim = 1e-5 * x.abs().sum(0).max().item()
            worst = max(worst, err)
            if not err <= lim:
                raise AssertionError(f"hierarchy_four_ranks {dt} {k}: "
                                     f"4·synced − Σ(x − e) = {err:.3e} > "
                                     f"{lim:.3e}")
        log(f"phase hierarchy_four_ranks ({dt}): synced within {bound} of "
            f"the exact mean on all 4 ranks; "
            + ("each residual the rank's cast error, bit for bit"
               if dt == "bf16" else f"4·synced − Σ_r (x_r − residual_r) at "
               f"most {worst:.2e}")
            + ("; equal to the flat sync within 1e-6" if dt is None
               else ""))


def _bf16_close(a, b, rtol=1e-3):
    """Within ``rtol`` relative, or one bf16 ulp apart (a bf16 loss
    resolves no finer: 2**-8 to 2**-7 of its value)."""
    ulp = max(2.0 ** (math.frexp(x)[1] - 8) for x in (a, b))
    return abs(a - b) <= max(rtol * abs(b), ulp)


def train_dcgan(phase, rows, strategy="auto"):
    """DCGAN_STEPS DCGAN steps (B128, 64x64, O1 bf16, two ``FusedAdam(lr=
    2e-4, betas=(0.5, 0.999), strategy=strategy)`` bundles), built by
    ``train.build_dcgan_step``; checks every kernel's launches, the step
    counts (G once a step, D twice), the running statistics and that all
    three losses are finite. Returns (losses per step, (G state, D
    state), step ms)."""
    import torch
    from apex_tpu_torch import ops, train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, (gs, ds, gbs, dbs), (z, real), _policy, (G, D) = \
        train.build_dcgan_step(128, strategy=strategy)
    log(f"phase {phase}: built, generator "
        f"{sum(p.numel() for p in G.parameters())} params in "
        f"{len(gs.params)} tensors, discriminator "
        f"{sum(p.numel() for p in D.parameters())} in {len(ds.params)}, "
        f"z {tuple(z.shape)}, real {tuple(real.shape)}, FusedAdam strategy "
        f"{strategy!r}")
    ops.reset_launch_counts()
    times, losses = [], []
    for _ in range(DCGAN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gs, ds, gbs, dbs, out = step(gs, ds, gbs, dbs, z, real)
        losses.append([l.item() for l in out])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launch_counts()
    for i in (0, 1, DCGAN_STEPS // 2, DCGAN_STEPS - 1):
        log(f"{phase} step {i}: loss D(real) {losses[i][0]:.6f} D(fake) "
            f"{losses[i][1]:.6f} G {losses[i][2]:.6f}  {times[i]:.2f} ms")
    bad = [(i, l) for i, l in enumerate(losses)
           if not all(math.isfinite(x) for x in l)]
    if bad:
        raise AssertionError(f"{phase}: losses not finite at {bad[:3]}")
    n = DCGAN_STEPS
    got = (int(gs.step), int(gs.opt_state.count), int(ds.step),
           int(ds.opt_state.count))
    if got != (n, n, 2 * n, 2 * n):
        raise AssertionError(f"{phase}: G step/count, D step/count {got}, "
                             f"expected {(n, n, 2 * n, 2 * n)}")
    if not torch.stack([torch.isfinite(v).all() for v in
                        (*gbs.values(), *dbs.values())]).all().item():
        raise AssertionError(f"{phase}: a running statistic is not finite")
    check_launches(phase, counts,
                   DCGAN_PER_STEP if strategy != "tree" else {}, rows, n)
    step_ms = sorted(times[1:])[len(times[1:]) // 2]
    log(f"phase {phase}: launches per step "
        f"{ {k: v / n for k, v in counts.items() if v} }")
    log(f"phase {phase}: median step {step_ms:.2f} ms (steps 1-{n - 1}), "
        f"{128 / step_ms * 1e3:.2f} img/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return losses, (gs, ds), step_ms


def dcgan_tree(rows, arena_losses):
    """DCGAN_STEPS steps with ``strategy="tree"`` from the same seed (no
    ``adam`` launch). Free-running, the two runs part: the update's last
    bits differ ((1 − β2) is rounded in f32 by the kernel and taken from
    the Python float by the tree, as in the JAX package), a bf16 weight
    then rounds the other way, and the GAN's dynamics grow that; their
    distance is logged. What is held: the arena run is replayed, and from
    each state it passes through one tree step gives the three losses
    within 1e-3 relative of the arena step's (a bf16 D loss: or one bf16
    ulp). Then one Adam update from the replay's last generator state,
    arena against tree."""
    from apex_tpu_torch import arena, train
    from apex_tpu_torch.optim import FusedAdam, FusedOptState

    losses, _, _ = train_dcgan("dcgan_tree", rows, "tree")
    apart = [max(abs(t - a) / abs(a) for t, a in zip(tl, al))
             for tl, al in zip(losses, arena_losses)]
    log(f"phase dcgan_tree: free-running, the tree run's losses are "
        f"{', '.join(f'{x:.1e}' for x in apart)} relative from the arena "
        f"run's (worst of three, steps 0-{len(apart) - 1})")

    def as_tree(state):
        opt = state.opt_state
        return state._replace(opt_state=FusedOptState(
            count=opt.count,
            slots=tree_slots(opt.slots, arena.plan(state.params))))

    tree_step = train.build_dcgan_step(128, strategy="tree")[0]
    step, (gs, ds, gbs, dbs), (z, real), _, _ = train.build_dcgan_step(128)
    worst = 0.0
    for i in range(DCGAN_STEPS):
        t_out = tree_step(as_tree(gs), as_tree(ds), gbs, dbs, z, real)[-1]
        gs, ds, gbs, dbs, a_out = step(gs, ds, gbs, dbs, z, real)
        for name, t, a in zip(("D(real)", "D(fake)", "G"), t_out, a_out):
            t, a = t.item(), a.item()
            if not _bf16_close(t, a):
                raise AssertionError(f"dcgan_tree step {i} from the arena "
                                     f"run's state: {name} loss {t} vs {a}")
            worst = max(worst, abs(t - a) / abs(a))
    log(f"phase dcgan_tree: from each of {DCGAN_STEPS} arena states, one "
        f"tree step's losses within {worst:.2e} relative of the arena "
        f"step's (limit 1e-3, or one bf16 ulp for the bf16 D losses)")
    arena_vs_tree_update(
        gs.params, gs.opt_state,
        lambda s: FusedAdam(lr=2e-4, betas=(0.5, 0.999), strategy=s),
        TOL_UPDATE)


def dcgan_plain_vs_kernel():
    """One DCGAN step (B128, O1 bf16, arena) from the same seed through the
    Adam kernel and inside ``plain_versions()``: the three losses within
    1e-3 relative (a bf16 D loss: or one bf16 ulp), and per tensor the
    update each run made within 1e-2 of its norm, ‖Δ_kernel − Δ_plain‖ ≤
    1e-2·‖Δ_plain‖. (Elementwise bounds say nothing here: Adam moves an
    element by about lr whatever its gradient's size, so a near-zero
    gradient whose last bits differ moves it up to 2·lr apart.)"""
    import torch
    from apex_tpu_torch import ops, train

    runs = {}
    for mode in ("kernel", "plain"):
        step, (gs, ds, gbs, dbs), (z, real), _, _ = train.build_dcgan_step(
            128)
        p0 = {**{f"G.{k}": v.clone() for k, v in gs.params.items()},
              **{f"D.{k}": v.clone() for k, v in ds.params.items()}}
        ops.reset_launch_counts()
        with (plain_versions() if mode == "plain"
              else contextlib.nullcontext()):
            gs, ds, _, _, out = step(gs, ds, gbs, dbs, z, real)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        want = DCGAN_PER_STEP if mode == "kernel" else {}
        if counts != want:
            raise AssertionError(f"{mode} DCGAN step launched {counts}, "
                                 f"expected {want}")
        p1 = {**{f"G.{k}": v for k, v in gs.params.items()},
              **{f"D.{k}": v for k, v in ds.params.items()}}
        runs[mode] = ([l.item() for l in out],
                      {k: p1[k] - p0[k] for k in p0})
        del step, gs, ds
        torch.cuda.empty_cache()
    (lk, dk), (lp, dp) = runs["kernel"], runs["plain"]
    errs = {k: ((dk[k] - d).norm() / d.norm().clamp(min=1e-30)).item()
            for k, d in dp.items()}
    worst = max(errs, key=errs.get)
    log(f"phase dcgan_plain_vs_kernel: first-step losses kernel "
        f"{[f'{x:.6f}' for x in lk]} plain {[f'{x:.6f}' for x in lp]}; "
        f"updates of {len(errs)} tensors, worst {errs[worst]:.2e} of the "
        f"update's norm ({worst})")
    for name, a, b in zip(("D(real)", "D(fake)", "G"), lk, lp):
        if not _bf16_close(a, b):
            raise AssertionError(f"kernel/plain {name} loss {a} vs {b}")
    if not errs[worst] <= 1e-2:
        raise AssertionError(f"kernel/plain update of {worst} differs by "
                             f"{errs[worst]:.2e} of its norm > 1e-2")


def dcgan_fp16_overflow():
    """Three DCGAN steps (B128) at O1 fp16: dynamic loss scaling, one
    scaler per loss (D's two, G's one). Before the third step D's
    ``scalers[1]`` is set to 2**24, which overflows. Every update is
    recorded: each scaler follows the schedule its own finite flags give
    (halve on overflow, else keep and count), the injected one halves,
    and every skipped update leaves the bundle's params, Adam count and
    step bitwise as they were, while the other two losses update."""
    import torch
    from apex_tpu_torch import amp, train
    from apex_tpu_torch.amp.scaler import LossScaleState

    step, (gs, ds, gbs, dbs), (z, real), policy, _ = train.build_dcgan_step(
        128, half_dtype=torch.float16)
    calls = []
    original = amp.Amp.apply_gradients

    def recording(self, state, grads, finite):
        new = original(self, state, grads, finite)
        calls.append((state, new, bool(finite)))
        return new

    amp.Amp.apply_gradients = recording
    try:
        expect = {("D", 0): (2.0 ** 16, 0), ("D", 1): (2.0 ** 16, 0),
                  ("G", 0): (2.0 ** 16, 0)}
        for i in range(3):
            if i == 2:
                ds = ds._replace(scalers=(ds.scalers[0], LossScaleState(
                    torch.tensor(2.0 ** 24, device=z.device),
                    ds.scalers[1].growth_tracker)))
                expect[("D", 1)] = (2.0 ** 24, expect[("D", 1)][1])
            del calls[:]
            gs, ds, gbs, dbs, out = step(gs, ds, gbs, dbs, z, real)
            flags = [f for _, _, f in calls]
            for key, (before, after, ok) in zip(
                    (("D", 0), ("D", 1), ("G", 0)), calls):
                scale, tracker = expect[key]
                expect[key] = (scale, tracker + 1) if ok else (scale / 2, 0)
                if not ok and not (
                        int(after.step) == int(before.step)
                        and int(after.opt_state.count)
                        == int(before.opt_state.count)
                        and all(torch.equal(after.params[k], before.params[k])
                                for k in before.params)):
                    raise AssertionError(f"fp16 step {i}: skipped {key} "
                                         f"update moved the state")
            got = {("D", 0): ds.scalers[0], ("D", 1): ds.scalers[1],
                   ("G", 0): gs.scalers[0]}
            for key, sc in got.items():
                if (sc.loss_scale.item(), int(sc.growth_tracker)) \
                        != expect[key]:
                    raise AssertionError(
                        f"fp16 step {i}: scaler {key} at "
                        f"{(sc.loss_scale.item(), int(sc.growth_tracker))}, "
                        f"expected {expect[key]}")
            log(f"dcgan fp16 step {i}: finite (D real, D fake, G) {flags}; "
                f"scales {[got[k].loss_scale.item() for k in got]}; losses "
                f"{[f'{l.item():.5f}' for l in out]}")
            if i == 2 and (flags[1] or not flags[0] or not flags[2]):
                raise AssertionError(f"fp16 step 2: finite flags {flags}, "
                                     f"expected D fake alone to overflow")
    finally:
        amp.Amp.apply_gradients = original
    if not math.isfinite(out[2].item()):
        raise AssertionError("fp16 run: the last G loss is not finite")
    log("phase dcgan_fp16_overflow: the injected scaler halved, its skipped "
        "D update held params and count bitwise, the other two scalers "
        "followed their own schedules")


def _check_two_four(phase, i, state):
    """Every pruned weight is 0 where its mask is 0, and each mask keeps 2
    of every 4 along the last dim (density 0.5)."""
    for k, m in state.opt_state.masks.items():
        if m is None:
            continue
        p = state.params[k]
        kept = m.reshape(-1, 4).sum(dim=-1)
        if bool((p[~m] != 0).any()) or not bool((kept == 2).all()):
            raise AssertionError(f"{phase} step {i}: {k} is not 2:4 under "
                                 f"its mask")


def _o1_grads(model, x, t, device, inside):
    """Each param's gradient of the MLP's loss at O1 bf16 with the
    forward under ``amp.auto_cast``, the backward run inside that block or
    after it; f64 CPU copies. ``t`` None: the loss of the JAX test,
    ``sum(y * y)``; else the DLRM phases' MSE to ``t``."""
    import torch
    from torch.func import functional_call
    from apex_tpu_torch import amp

    policy = amp.Policy.from_opt_level("O1")
    mp = {k: v.detach().to(device).requires_grad_(True)
          for k, v in model.named_parameters()}
    xt = torch.as_tensor(x, device=device)
    with amp.auto_cast(policy):
        y = functional_call(model, mp, (xt,)).float()
        loss = (y * y).sum() if t is None else torch.mean(torch.square(
            y - torch.as_tensor(t, device=device)))
        if inside:
            loss.backward()
    if not inside:
        loss.backward()
    return {k: v.grad.detach().cpu().double() for k, v in mp.items()}


def o1_backward_thread():
    """Phase o1_backward_thread (ROADMAP queue C): an MLP's gradients at O1
    bf16 with ``backward()`` called inside ``auto_cast`` and after it, on
    the card and in this process on the CPU. On the CPU autograd runs a
    custom Function's backward on the calling thread, which sees the
    policy (the MLP's backward then rounds its products' operands to bf16,
    as a backward inside the block does); for CUDA tensors it runs on
    autograd's device thread, which reaches the policy only through the
    torch-function mode that the patched ``backward()`` pushes. For each
    ``inside``, every param's gradient on the card must lie within a tenth
    of the CPU's inside-vs-outside gap of the CPU's, in L2 over the tensor
    (the largest single difference is set by the operands whose bf16
    rounding flips between two f32 sum orders, a few of a million on
    DLRM's layers; both are logged). Inputs: the JAX test's MLP [13, 64,
    32, 8] on 16 rows of ``RandomState(1)``, then DLRM's bottom MLP
    (B2048, [13, 512, 256, 128]) on the MSE loss of mlp_dlrm_bottom_o1."""
    import numpy as np
    from apex_tpu_torch import ops

    worst = {}
    for name, dims, n in (("test_mlp", (13, 64, 32, 8), 16),
                          ("dlrm_bottom", MLP_BOTTOM, 2048)):
        rng = np.random.RandomState(1)
        x = rng.randn(n, dims[0]).astype(np.float32)
        t = None if name == "test_mlp" else rng.rand(
            n, dims[-1]).astype(np.float32)
        model = ops.MLP(dims, device="cpu", seed=1)
        cpu = {inside: _o1_grads(model, x, t, "cpu", inside)
               for inside in (False, True)}
        card = {inside: _o1_grads(model, x, t, "cuda", inside)
                for inside in (False, True)}
        for k in cpu[False]:
            gap = cpu[True][k] - cpu[False][k]
            if not gap.abs().max().item() > 0.0:
                raise AssertionError(f"o1_backward_thread {name} {k}: the "
                                     f"CPU's inside and outside grads agree")
            for inside in (False, True):
                err = card[inside][k] - cpu[inside][k]
                ratio = (err.norm() / gap.norm()).item()
                peak = (err.abs().max() / gap.abs().max()).item()
                key = (name, inside)
                w = worst.get(key, (0.0, 0.0))
                worst[key] = (max(w[0], ratio), max(w[1], peak))
                if not ratio <= 0.1:
                    raise AssertionError(
                        f"o1_backward_thread {name} {k} inside={inside}: "
                        f"card vs CPU {err.norm().item():.3e} > 0.1 x the "
                        f"CPU's inside-outside gap {gap.norm().item():.3e} "
                        f"(L2)")
    log("phase o1_backward_thread: card vs CPU grads, worst over params as "
        "a share of the CPU's inside-vs-outside gap, L2 (limit 0.1) / "
        "largest element: "
        + ", ".join(f"{n} inside={i}: {r:.3e} / {p:.3e}"
                    for (n, i), (r, p) in worst.items()))


def mlp_dlrm_bottom(rows):
    """MLP_STEPS steps of DLRM's bottom MLP (``--arch-mlp-bot=13-512-256-128``
    at ``--mini-batch-size=2048``) under amp O2 bf16 with
    ``ASP(FusedAdam(lr=1e-3), "m4n2_1d")`` on an MSE loss, built by
    ``train.build_mlp_step``: one mlp_fwd launch and one adam launch a step
    (the masters are one f32 arena partition), every weight 2:4 under its
    mask after every step, the biases dense, and finite, falling losses.
    The steps run as users run them, with ``APEX_TPU_AUTOTUNE=db``: the
    Adam partition's consult hits the committed DB where it holds the
    key (``check_db_consults``)."""
    import torch
    from apex_tpu_torch import arena, ops, sparsity, train
    from apex_tpu_torch.ops import autotune

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, state, (x, t), policy, model = train.build_mlp_step(2048)
    masks = state.opt_state.masks
    parts = arena.plan(state.params).partitions
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase mlp_dlrm_bottom: built MLP{list(MLP_BOTTOM)}, {n_params} "
        f"params in {len(state.params)} tensors, x {tuple(x.shape)} "
        f"{x.dtype}, model params "
        f"{sorted({str(v.dtype) for v in policy.cast_params(state.params).values()})}, "
        f"{len(parts)} arena partition(s) "
        f"{[p.dtype for p in parts]}, masks "
        f"{ {k: sparsity.density(m) for k, m in masks.items() if m is not None} }")
    if sorted(k for k, m in masks.items() if m is not None) != [
            f"weight_{i}" for i in range(len(MLP_BOTTOM) - 1)] or any(
            sparsity.density(m) != 0.5 for m in masks.values()
            if m is not None) or len(parts) != 1:
        raise AssertionError("mlp_dlrm_bottom: expected 2:4 masks on the "
                             "three weights only and one arena partition")
    ops.reset_launch_counts()
    autotune.reset_counters()
    times, losses = [], []
    with autotune_mode("db"):
        for i in range(MLP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, x, t)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
            _check_two_four("mlp_dlrm_bottom", i, state)
        check_db_consults("mlp_dlrm_bottom", [autotune.fingerprint(
            "optimizer", (parts[0].buffer_len,), "float32")])
    counts = ops.launch_counts()
    for i in (0, 1, MLP_STEPS // 2, MLP_STEPS - 1):
        log(f"mlp_dlrm_bottom step {i}: loss {losses[i]:.6f}  "
            f"{times[i]:.3f} ms")
    if not all(math.isfinite(l) for l in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"mlp_dlrm_bottom: losses not finite and "
                             f"falling: {losses}")
    check_launches("mlp_dlrm_bottom", counts, MLP_PER_STEP, rows, MLP_STEPS)
    if int(state.step) != MLP_STEPS:
        raise AssertionError(f"mlp_dlrm_bottom: state.step {int(state.step)}")
    step_ms = sorted(times[1:])[len(times[1:]) // 2]
    log(f"phase mlp_dlrm_bottom: launches per step "
        f"{ {k: v / MLP_STEPS for k, v in counts.items() if v} }, weights "
        f"2:4 after all {MLP_STEPS} steps, loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}")
    log(f"phase mlp_dlrm_bottom: median step {step_ms:.3f} ms (steps "
        f"1-{MLP_STEPS - 1}), {2048 / step_ms * 1e3:.1f} rows/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


def mlp_fallback():
    """The reference Apex test's widths [480, 1024, 1024, 512, 256, 1] at
    B1024, bf16 and f32: over the 8 MiB budget, so ``fused_mlp`` computes
    ``mlp_reference`` and launches nothing; output and input gradient
    bitwise equal to ``mlp_reference``'s on the card."""
    import torch
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import mlp as P

    dev = torch.device("cuda")
    model = P.MLP(MLP_OVER_BUDGET, device=dev, seed=1)
    ws32 = [getattr(model, f"weight_{i}").detach() for i in range(5)]
    bs32 = [getattr(model, f"bias_{i}").detach() for i in range(5)]
    if P.weights_fit(ws32):
        raise AssertionError("mlp_fallback: the widths fit the budget")
    gen = torch.Generator(dev).manual_seed(3)
    for dt in (torch.bfloat16, torch.float32):
        ws = [w.to(dt).requires_grad_(True) for w in ws32]
        bs = [b.to(dt).requires_grad_(True) for b in bs32]
        x = torch.randn(1024, 480, generator=gen, device=dev).to(dt)
        x.requires_grad_(True)
        g = torch.randn(1024, 1, generator=gen, device=dev).to(dt)

        def run(fn):
            y = fn(x, ws, bs, "relu")
            return (y, *torch.autograd.grad(y, [x, *ws, *bs], g))

        ops.reset_launch_counts()
        got = run(P.fused_mlp)
        launched = {k: v for k, v in ops.launch_counts().items() if v}
        want = run(P.mlp_reference)
        if launched:
            raise AssertionError(f"mlp_fallback {dt}: launched {launched}")
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"mlp_fallback {dt}: fused_mlp differs from "
                                 f"mlp_reference")
        ms = timed(lambda: run(P.fused_mlp))
        log(f"phase mlp_fallback: {dt}: 0 launches, output and all 11 "
            f"gradients bitwise equal to mlp_reference; forward + backward "
            f"{ms:.4f} ms")


def mlp_plain_vs_kernel():
    """One mlp_dlrm_bottom step from the same seed through the kernels and
    inside ``plain_versions()``: the loss within 1e-3 relative and each
    updated param within 1e-2 of the tensor's largest magnitude (the bf16
    forward rounds once in both; Adam moves an element by about lr whatever
    its gradient, so a near-zero gradient whose last bits differ moves it
    up to 2·lr apart)."""
    import torch
    from apex_tpu_torch import ops, train

    runs = {}
    for mode in ("kernel", "plain"):
        step, state, (x, t), _, _ = train.build_mlp_step(2048)
        ops.reset_launch_counts()
        with (plain_versions() if mode == "plain"
              else contextlib.nullcontext()):
            state, loss = step(state, x, t)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        want = MLP_PER_STEP if mode == "kernel" else {}
        if counts != want:
            raise AssertionError(f"{mode} MLP step launched {counts}, "
                                 f"expected {want}")
        runs[mode] = (loss.item(), state.params)
    (lk, pk), (lp, pp) = runs["kernel"], runs["plain"]
    errs = {k: ((pk[k] - v).abs().max() / v.abs().max()).item()
            for k, v in pp.items()}
    worst = max(errs, key=errs.get)
    log(f"phase mlp_plain_vs_kernel: loss kernel {lk:.6f} plain {lp:.6f}; "
        f"params worst {errs[worst]:.2e} of the tensor's max ({worst})")
    if not abs(lk - lp) <= 1e-3 * abs(lp):
        raise AssertionError(f"kernel/plain MLP loss {lk} vs {lp}")
    if not errs[worst] <= 1e-2:
        raise AssertionError(f"kernel/plain MLP {worst} differs by "
                             f"{errs[worst]:.2e} of its max > 1e-2")


def mlp_phases(rows):
    t0 = time.perf_counter()
    mlp_dlrm_bottom(rows)
    mlp_fallback()
    mlp_plain_vs_kernel()
    log(f"phase mlp: mlp_dlrm_bottom, mlp_fallback and mlp_plain_vs_kernel "
        f"in {time.perf_counter() - t0:.1f} s")


def depth2_encoder(dropout=0.0):
    from apex_tpu_torch import models
    return models.BertEncoder(30522, hidden=1024, layers=2, heads=16,
                              dropout=dropout)


def plain_vs_kernel_step():
    """Phase 6: first-step loss, kernels vs plain versions, depth 2: as
    the bert_large step, then with padding masks and attention dropout 0.1
    (both runs draw the same dropout seeds from the step's generator)."""
    import torch
    from apex_tpu_torch import ops, train

    for dropout, padded in ((0.0, False), (0.1, True)):
        losses = {}
        for mode in ("kernel", "plain"):
            step, state, (toks, labels), _p, _e = train.build_bert_step(
                16, 512, encoder=depth2_encoder(dropout), padded=padded)
            ops.reset_launch_counts()
            with (plain_versions() if mode == "plain"
                  else contextlib.nullcontext()):
                state, loss = step(state, toks, labels)
            losses[mode] = loss.item()
            used = sum(ops.launch_counts().values())
            if (used == 0) != (mode == "plain"):
                raise AssertionError(f"{mode} step launched {used} kernels")
            del step, state
            torch.cuda.empty_cache()
        rel = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
        what = (f"padded, dropout {dropout}" if padded
                else "no mask, no dropout")
        log(f"phase plain_vs_kernel: depth-2 {what} first-step loss kernel "
            f"{losses['kernel']:.6f} plain {losses['plain']:.6f} rel "
            f"{rel:.2e}")
        if not rel <= 5e-3:
            raise AssertionError(f"kernel/plain loss differ by {rel:.2e} > "
                                 f"5e-3 ({what})")


def fp16_overflow_run():
    """Phase 7: fp16 O1 + dynamic scaling, one forced overflow, depth 2."""
    import numpy as np
    import torch
    from apex_tpu_torch import amp, models
    from apex_tpu_torch.optim import FusedLAMB

    enc = depth2_encoder()
    policy = amp.Policy.from_opt_level("O1", half_dtype=torch.float16)
    amp_opt = amp.Amp(policy, FusedLAMB(lr=1e-3))
    state = amp_opt.init(dict(enc.named_parameters()))
    rng = np.random.RandomState(0)
    toks = torch.as_tensor(rng.randint(0, 30000, (16, 512)), device="cuda")
    labels = torch.as_tensor(rng.randint(0, 30000, (16, 512)), device="cuda")
    for i in range(3):
        inject = i == 1

        def loss_fn(mp):
            with amp.auto_cast(policy):
                loss = models.mlm_loss(enc, mp, toks, labels)
            return loss * float("inf") if inject else loss

        before = state
        scale0 = before.scalers[0].loss_scale.item()
        loss, grads, state, finite = amp_opt.backward(state, loss_fn)
        state = amp_opt.apply_gradients(state, grads, finite)
        scale1 = state.scalers[0].loss_scale.item()
        log(f"fp16 step {i}: loss {loss.item():.6f} finite "
            f"{bool(finite.item())} scale {scale0:g} -> {scale1:g} "
            f"step {int(state.step.item())}")
        if inject:
            same = all(torch.equal(state.params[k], before.params[k])
                       for k in state.params)
            if (bool(finite.item()) or scale1 != scale0 / 2 or not same
                    or int(state.step) != int(before.step)
                    or int(state.opt_state.count)
                    != int(before.opt_state.count)):
                raise AssertionError("forced overflow did not halve the "
                                     "scale and hold params and step")
        elif not math.isfinite(loss.item()):
            raise AssertionError(f"fp16 step {i} loss not finite")
    log("phase fp16_overflow: scale halved, params and step held")


# --- the amp remainder, fp16_utils and the legacy optimizers -----------------



def _bert_inputs(batch, seq, seed=0, vocab=30000):
    """Tokens and labels as ``train.build_bert_step`` draws them."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    toks = torch.as_tensor(rng.randint(0, vocab, (batch, seq)),
                           dtype=torch.int64, device="cuda")
    labels = torch.as_tensor(rng.randint(0, vocab, (batch, seq)),
                             dtype=torch.int64, device="cuda")
    return toks, labels


def _mlm_fn(enc, policy=None, div=1.0):
    """``loss_fn(mp, toks, labels)``: the MLM loss of ``enc`` at ``mp``
    (under ``auto_cast(policy)`` when given), divided by ``div``."""
    from torch.func import functional_call
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.transformer import _mlm_head

    def loss_fn(mp, toks, labels):
        scope = (amp.auto_cast(policy) if policy is not None
                 else contextlib.nullcontext())
        with scope:
            hidden = functional_call(enc, mp, (toks,))
            return _mlm_head(hidden, mp["tok_emb.weight"], labels) / div
    return loss_fn


def _equal_trees(a, b):
    import torch
    return all(torch.equal(a[k], b[k]) for k in a)


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(
        1e-30)).item()


def bert_large_o2_fp16_accum(enc):
    """This slice's main path: BERT-Large (B16 S512) set up by
    ``amp.initialize(params, FusedLAMB(lr=1e-3, strategy="arena"), "O2",
    half_dtype=torch.float16)``; each step two microbatches of B8 through
    ``backward_accumulate`` (each loss halved) and one ``apply_gradients``,
    until 5 steps are applied (at most BERT_ACCUM_MAX_STEPS). Hard checks:
    BERT_ACCUM_PER_STEP launches a step; every skipped step holds params,
    the optimizer count and ``step`` and halves the scale; the losses of
    applied steps finite; the first applied step's accumulated grads
    within 1e-2 relative L2 per tensor of one B16 backward from the same
    state; a ``state_dict`` taken after step 2, carried with the params,
    optimizer state and step into the state of a second ``initialize``,
    continues steps 3-4 bit for bit (losses, scale, params). Returns
    (state, accumulated grads of the last step)."""
    import torch
    from apex_tpu_torch import amp, ops
    from apex_tpu_torch.optim import FusedLAMB

    phase = "bert_large_o2_fp16_accum"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = dict(enc.named_parameters())
    amp_opt, state = amp.initialize(
        params, FusedLAMB(lr=1e-3, strategy="arena"), "O2",
        half_dtype=torch.float16)
    footprint = amp_opt.memory_footprint(params)
    toks, labels = _bert_inputs(16, 512)
    micro = [(toks[:8], labels[:8]), (toks[8:], labels[8:])]
    loss_fn = _mlm_fn(enc, amp_opt.policy, div=2.0)

    def step(state):
        return _accum_step(amp_opt, state, micro, loss_fn)

    ops.reset_launch_counts()
    times, log_rows, applied, steps = [], [], 0, 0
    saved, first_acc = None, None
    while applied < 5:
        if steps == BERT_ACCUM_MAX_STEPS:
            raise AssertionError(f"{phase}: {applied} steps applied in "
                                 f"{steps}")
        before = state
        scale0 = state.scalers[0].loss_scale.item()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, acc, fin, loss = step(state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if steps == 0:       # before the checks below hold extra states
            step_peak = torch.cuda.max_memory_allocated() / 2**30
        ok = bool(fin.item())
        scale1 = state.scalers[0].loss_scale.item()
        log_rows.append((steps, loss.item(), ok, scale0, scale1, times[-1]))
        if not ok:
            same = _equal_trees(state.params, before.params)
            if (scale1 != scale0 / 2 or not same
                    or int(state.step) != int(before.step)
                    or int(state.opt_state.count)
                    != int(before.opt_state.count)):
                raise AssertionError(f"{phase} step {steps}: a skipped step "
                                     f"moved the state or did not halve the "
                                     f"scale")
        else:
            applied += 1
            if not math.isfinite(loss.item()):
                raise AssertionError(f"{phase} step {steps}: loss {loss}")
            if first_acc is None:
                first_acc = (before, acc)
        steps += 1
        if steps == 3:
            saved = (amp_opt.state_dict(state),
                     {k: v.clone() for k, v in state.params.items()},
                     type(state.opt_state)(
                         count=state.opt_state.count.clone(),
                         slots={n: {d: b.clone() for d, b in s.items()}
                                for n, s in state.opt_state.slots.items()}),
                     state.step.clone())
        if steps == 5:
            tail = (log_rows[3:5], state.params)
    counts = ops.launch_counts()
    for i, loss, ok, s0, s1, ms in log_rows:
        log(f"{phase} step {i}: loss {loss:.6f} finite {ok} scale {s0:g} -> "
            f"{s1:g}  {ms:.2f} ms")
    check_launches(phase, counts, BERT_ACCUM_PER_STEP, None, steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = sorted(times[1:5])[len(times[1:5]) // 2]
    log(f"phase {phase}: launches per step "
        f"{ {k: v // steps for k, v in counts.items() if v} }; {applied} "
        f"applied of {steps} steps")
    log(f"phase {phase}: median step {step_ms:.2f} ms (steps 1-4), "
        f"{16 / step_ms * 1e3:.2f} seq/s, peak memory {step_peak:.2f} GiB "
        f"over step 0 ({peak:.2f} GiB with the resume check's copies); "
        f"memory_footprint {footprint}")

    # the first applied step's accumulation against one B16 backward
    st0, acc0 = first_acc
    full_fn = _mlm_fn(enc, amp_opt.policy)
    _, full, _, ffin = amp_opt.backward(st0, full_fn, toks, labels)
    if not bool(ffin.item()):
        raise AssertionError(f"{phase}: the B16 backward overflowed")
    dist = {k: _rel_l2(acc0[k], full[k]) for k in full}
    worst = max(dist, key=dist.get)
    log(f"phase {phase}: accumulated grads vs one B16 backward: worst "
        f"relative L2 {dist[worst]:.3e} ({worst}), median "
        f"{sorted(dist.values())[len(dist) // 2]:.3e}")
    if not dist[worst] <= 1e-2:
        raise AssertionError(f"{phase}: accumulated grads {worst} at "
                             f"{dist[worst]:.3e} > 1e-2 of the B16 grads")
    del full, first_acc, st0, acc0

    # resume: a second initialize, the state carried across, steps 3-4
    sd, p2, o2, s2 = saved
    amp_opt2, st2 = amp.initialize(params, FusedLAMB(lr=1e-3,
                                                     strategy="arena"),
                                   "O2", half_dtype=torch.float16,
                                   verbosity=0)
    st2 = amp_opt2.load_state_dict(st2._replace(params=p2, opt_state=o2,
                                                step=s2), sd)
    del saved, p2, o2
    want_rows, want_params = tail
    for i, want_loss, want_ok, _, want_scale, _ in want_rows:
        st2, _, fin, loss = _accum_step(amp_opt2, st2, micro, loss_fn)
        if (loss.item() != want_loss or bool(fin.item()) != want_ok
                or st2.scalers[0].loss_scale.item() != want_scale):
            raise AssertionError(f"{phase}: resumed step {i} differs: loss "
                                 f"{loss.item()} vs {want_loss}")
    if not _equal_trees(st2.params, want_params):
        raise AssertionError(f"{phase}: resumed params differ after step 4")
    log(f"phase {phase}: state_dict after step 2 carried into a second "
        f"initialize; steps 3-4 bit for bit (losses, scale, params)")
    del st2, amp_opt2, want_params, tail
    return state, acc


def _accum_step(amp_opt, state, micro, loss_fn):
    """One accumulated step: each microbatch through
    ``backward_accumulate``, then one ``apply_gradients``. Returns (state',
    accumulated grads, finite, summed loss)."""
    acc, fin, losses = None, True, []
    for t, l in micro:
        loss, acc, state, fin = amp_opt.backward_accumulate(
            state, loss_fn, t, l, stashed=acc, finite=fin)
        losses.append(loss)
    return amp_opt.apply_gradients(state, acc, fin), acc, fin, sum(losses)


def bert_large_fp16_optimizer(enc):
    """The pre-amp path: BERT-Large (B16 S512) through
    ``fp16_utils.FP16_Optimizer(FusedLAMB(lr=1e-3, strategy="arena"),
    dynamic_loss_scale=True)`` (legacy schedule: init 2**32, never above
    it), the forward at the masters cast as ``network_to_half(params)``
    casts them, ``clip_master_grads(grads, 1.0)``, until 5 steps are
    applied (at most FP16_OPT_MAX_BACKWARDS backwards). Hard checks: each
    overflow halves the scale exactly and holds the masters and ``step``;
    the scale never exceeds 2**32; one launch each of the arena LAMB
    kernels a ``step`` call (the update is computed on every call and
    committed only where the grads were finite). Returns (masters, the
    last applied step's clipped grads)."""
    import torch
    from apex_tpu_torch import fp16_utils, ops
    from apex_tpu_torch.optim import FusedLAMB

    phase = "bert_large_fp16_optimizer"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = dict(enc.named_parameters())
    like = fp16_utils.network_to_half(params)
    ln_dtypes = sorted({str(v.dtype) for k, v in like.items()
                        if "LayerNorm" in k})
    opt = fp16_utils.FP16_Optimizer(FusedLAMB(lr=1e-3, strategy="arena"),
                                    dynamic_loss_scale=True)
    state = opt.init(params)
    toks, labels = _bert_inputs(16, 512)
    mlm = _mlm_fn(enc)

    def loss_fn(mp):
        return mlm({k: v.to(like[k].dtype) for k, v in mp.items()}, toks,
                   labels)

    ops.reset_launch_counts()
    applied, calls, rows, times, grads = 0, 0, [], [], None
    while applied < 5:
        if calls == FP16_OPT_MAX_BACKWARDS:
            raise AssertionError(f"{phase}: {applied} steps applied in "
                                 f"{calls} backwards")
        before = state
        scale0 = opt.loss_scale(state).item()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g, fin, state = opt.backward(state, loss_fn)
        g, norm = opt.clip_master_grads(g, 1.0)
        state = opt.step(state, g, fin)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        ok = bool(fin.item())
        scale1 = opt.loss_scale(state).item()
        rows.append((calls, loss.item(), ok, scale0, scale1, norm.item()))
        if scale1 > 2.0 ** 32:
            raise AssertionError(f"{phase}: scale {scale1} > 2**32")
        if ok:
            applied += 1
            grads = g
            if not math.isfinite(loss.item()):
                raise AssertionError(f"{phase}: loss {loss}")
        elif (scale1 != scale0 / 2 or int(state.step) != int(before.step)
              or not _equal_trees(state.masters, before.masters)):
            raise AssertionError(f"{phase} backward {calls}: an overflow did "
                                 f"not halve the scale and hold the state")
        calls += 1
    counts = ops.launch_counts()
    for i, loss, ok, s0, s1, nrm in rows:
        log(f"{phase} backward {i}: loss {loss:.6f} finite {ok} scale "
            f"{s0:g} -> {s1:g} grad norm {nrm:.4g}")
    check_launches(phase, counts, dict(EXPECTED_PER_STEP, **ARENA_PER_STEP),
                   None, calls)
    if int(state.step) != 5:
        raise AssertionError(f"{phase}: state.step {int(state.step)}")
    ms = [t for (_, _, ok, *_), t in zip(rows, times) if ok]
    step_ms = sorted(ms)[len(ms) // 2]
    log(f"phase {phase}: {calls - applied} overflows skipped before 5 "
        f"applied steps (scale 2**32 -> {opt.loss_scale(state).item():g}); "
        f"LayerNorm params as network_to_half gives them: {ln_dtypes}; "
        f"median applied step {step_ms:.2f} ms, {16 / step_ms * 1e3:.2f} "
        f"seq/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return state.masters, grads


def legacy_updates(masters, grads):
    """One update of each legacy optimizer (``legacy.FusedLAMB(
    max_grad_norm=1.0)``, ``legacy.FusedAdam``, ``legacy.FusedSGD(
    momentum=0.9)``) from BERT-Large's f32 params and a gradient scaled by
    1024, with ``scale=1024.0, output_dtype=torch.float16``, against the
    modern arena optimizer on the unscaled gradient: params and slots
    within TOL_UPDATE of each tensor's max, the fp16 copy bitwise the new
    params cast to fp16, and one launch of each optimizer kernel."""
    import torch
    from apex_tpu_torch import arena, ops
    from apex_tpu_torch.optim import FusedAdam, FusedLAMB, FusedSGD, legacy

    phase = "legacy_updates"
    scaled = {k: g * 1024.0 for k, g in grads.items()}
    spec = arena.plan(masters)
    cases = (
        ("FusedLAMB", legacy.FusedLAMB(max_grad_norm=1.0),
         FusedLAMB(max_grad_norm=1.0, strategy="arena"),
         dict(ARENA_PER_STEP)),
        ("FusedAdam", legacy.FusedAdam(), FusedAdam(strategy="arena"),
         dict(ADAM_PER_STEP)),
        ("FusedSGD", legacy.FusedSGD(momentum=0.9),
         FusedSGD(momentum=0.9, strategy="arena"), dict(SGD_PER_STEP)))
    for name, lo, modern, per in cases:
        ops.reset_launch_counts()
        p1, s1, copy = lo.step(scaled, lo.init(masters), masters,
                               scale=1024.0, output_dtype=torch.float16)
        check_launches(f"{phase} {name}", ops.launch_counts(), per, None, 1)
        p2, s2 = modern.step(grads, modern.init(masters), masters)
        worst = {}
        for k in masters:
            ref = p2[k].abs().max().item()
            worst[f"p:{k}"] = (p1[k] - p2[k]).abs().max().item() / max(
                ref, 1e-30)
            if not torch.equal(copy[k], p1[k].half()):
                raise AssertionError(f"{phase} {name}: the fp16 copy of {k} "
                                     f"is not the new param cast")
        ta, tb = tree_slots(s1.slots, spec), tree_slots(s2.slots, spec)
        for slot in tb:
            a, b = ta[slot], tb[slot]
            for k in a:
                ref = b[k].abs().max().item()
                worst[f"{slot}:{k}"] = (a[k] - b[k]).abs().max().item() / \
                    max(ref, 1e-30)
        by_slot = {}
        for key, e in worst.items():
            slot = key.split(":")[0]
            by_slot[slot] = max(by_slot.get(slot, 0.0), e)
            if e > TOL_UPDATE.get(slot, TOL_UPDATE["p"]):
                raise AssertionError(f"{phase} {name}: {key} {e:.3e} of its "
                                     f"max")
        log(f"phase {phase}: legacy.{name}(scale=1024, fp16 copy) vs "
            f"optim.{name}(strategy='arena') on the unscaled grad: worst "
            f"{ {k: f'{v:.2e}' for k, v in by_slot.items()} } of each "
            f"tensor's max; fp16 copy bitwise")
        del p1, s1, copy, p2, s2


def mlp_dlrm_bottom_o1(rows):
    """DLRM's bottom MLP (B2048, [13, 512, 256, 128], ASP around
    FusedAdam(lr=1e-3) as ``train.build_mlp_step``) through ``amp.initialize(
    ..., "O1")`` with the loss under ``amp.auto_cast(policy)``, MLP_STEPS
    steps: one mlp_fwd launch a step, in the bf16-operand mode; every
    weight 2:4 after every step; finite, falling losses; one step through
    the kernels against ``plain_versions()`` (loss within 1e-3 relative,
    each param's update from its pruned start within MLP_O1_UPDATE_TOL
    relative L2); the first forward differs from the same forward with the
    mode off."""
    import numpy as np
    import torch
    from torch.func import functional_call
    from apex_tpu_torch import amp, ops, sparsity
    from apex_tpu_torch.ops import mlp as P
    from apex_tpu_torch.optim import FusedAdam

    phase = "mlp_dlrm_bottom_o1"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def build():
        model = ops.MLP(MLP_BOTTOM, device="cuda", seed=0)
        rng = np.random.RandomState(0)
        x = torch.as_tensor(rng.randn(2048, MLP_BOTTOM[0]).astype(
            np.float32), device="cuda")
        t = torch.as_tensor(rng.rand(2048, MLP_BOTTOM[-1]).astype(
            np.float32), device="cuda")
        amp_opt, state = amp.initialize(
            dict(model.named_parameters()),
            sparsity.ASP(FusedAdam(lr=1e-3), pattern="m4n2_1d"), "O1",
            verbosity=0)

        def loss_fn(mp):
            with amp.auto_cast(amp_opt.policy):
                y = functional_call(model, mp, (x,))
            return torch.mean(torch.square(y.float() - t))

        def step(state):
            loss, grads, state, fin = amp_opt.backward(state, loss_fn)
            return amp_opt.apply_gradients(state, grads, fin), loss
        return model, x, amp_opt, state, step

    model, x, amp_opt, state, step = build()
    modes = []
    real = P._FusedMLPFn.apply

    def spy(*a):            # (x, activation, n_layers, has_bias, mode, ...)
        modes.append(a[4])
        return real(*a)

    mp0 = amp_opt.model_params(state)
    with torch.no_grad():
        with amp.auto_cast(amp_opt.policy):
            y_on = functional_call(model, mp0, (x,))
        y_off = functional_call(model, mp0, (x,))
    moved = (y_on - y_off).abs().max().item()
    if not moved > 0.0:
        raise AssertionError(f"{phase}: the O1 forward equals the mode-off "
                             f"forward")
    ops.reset_launch_counts()
    P._FusedMLPFn.apply = spy
    try:
        losses, times = [], []
        for i in range(MLP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
            _check_two_four(phase, i, state)
    finally:
        del P._FusedMLPFn.apply      # back to torch.autograd.Function's
    counts = ops.launch_counts()
    check_launches(phase, counts, MLP_PER_STEP, None, MLP_STEPS)
    rows["mlp_fwd_o1"]["launches"] = counts["mlp_fwd"]
    if modes != [torch.bfloat16] * MLP_STEPS:
        raise AssertionError(f"{phase}: kernel modes {set(modes)}")
    if not all(math.isfinite(v) for v in losses) or not \
            losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: losses not finite and falling")
    step_ms = sorted(times[1:])[len(times[1:]) // 2]
    log(f"phase {phase}: 1 mlp_fwd launch a step in the bf16-operand mode, "
        f"1 adam; weights 2:4 after all {MLP_STEPS} steps; loss "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}; the first forward "
        f"{moved:.3e} from the mode off; median step {step_ms:.3f} ms, "
        f"{2048 / step_ms * 1e3:.1f} rows/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    runs = {}
    for mode in ("kernel", "plain"):
        _, _, _, st, stp = build()
        # the update from the params as ASP's masks prune them
        p0 = sparsity.prune(st.params, st.opt_state.masks)
        ops.reset_launch_counts()
        with (plain_versions() if mode == "plain"
              else contextlib.nullcontext()):
            st, loss = stp(st)
        used = {k: v for k, v in ops.launch_counts().items() if v}
        if used != (MLP_PER_STEP if mode == "kernel" else {}):
            raise AssertionError(f"{phase} {mode} step launched {used}")
        runs[mode] = (loss.item(), {k: v - p0[k]
                                    for k, v in st.params.items()})
    (lk, dk), (lp, dp) = runs["kernel"], runs["plain"]
    errs = {k: _rel_l2(dk[k], v) for k, v in dp.items()}
    worst = max(errs, key=errs.get)
    log(f"phase {phase}: one step kernel vs plain: loss {lk:.6f} / {lp:.6f}, "
        f"each param's update worst {errs[worst]:.3e} relative L2 "
        f"({worst}; limit {MLP_O1_UPDATE_TOL:g}), update norms "
        f"{ {k: f'{v.norm().item():.3e}' for k, v in dp.items()} }")
    if not abs(lk - lp) <= 1e-3 * abs(lp) or \
            not errs[worst] <= MLP_O1_UPDATE_TOL:
        raise AssertionError(f"{phase}: kernel and plain steps differ")


def l1_grid():
    """The JAX package's L1 grid on the card (the net and runner of
    ``tests/_torch_l1_grid.py``): every cell that validation admits, the
    kernel path (LayerNorm and cross-entropy kernels, the arena
    SGD) against the plain path inside ``plain_versions()`` with RefSGD;
    decisions bitwise, losses and params within 1e-5 (f32 compute) or 2e-2
    (half), the kernels launched once each a step (SGD once a partition);
    then the fp16 overflow injection (steps 2 and 4 poisoned) and the
    resume after 3 steps, both bit for bit."""
    import torch
    from apex_tpu_torch import ops
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import _torch_l1_grid as G

    t0 = time.perf_counter()
    cells = skipped = 0
    worst = {}
    for ol, sn, sv, kb in G.GRID:
        policy = G.policy(ol, sv, kb)
        label = f"{ol}-{sn}-bn{int(kb)}"
        if policy is None:
            skipped += 1
            continue
        ops.reset_launch_counts()
        fused = G.run(policy, True)
        counts = ops.launch_counts()
        parts = len({str(p.dtype) for p in fused[3].params.values()})
        check_launches(f"l1 {label}", counts, dict(
            G.PER_STEP, sgd=parts), None, G.STEPS)
        with plain_versions():
            ref = G.run(policy, False)
        if ops.launch_counts() != counts:
            raise AssertionError(f"l1 {label}: the plain path launched")
        tol = 1e-5 if policy.compute_dtype == torch.float32 else 2e-2
        worst[label] = G.compare(label, fused, ref, tol)
        cells += 1
    log(f"phase l1_grid: {cells} cells (skipped {skipped}) kernel path vs "
        f"plain path: decisions bitwise; worst float distance "
        f"{max(worst.values()):.3e} ({max(worst, key=worst.get)}); f32 "
        f"cells worst "
        f"{max(v for k, v in worst.items() if k.startswith('O0')):.3e}")
    policy = G.policy("O2", "dynamic", True, half_dtype=torch.float16)
    fused = G.run(policy, True, poison_steps=(2, 4))
    with plain_versions():
        ref = G.run(policy, False, poison_steps=(2, 4))
    G.compare("fp16 overflow", fused, ref, 2e-2)
    _, fin, scales, st, _ = fused
    if [i for i, f in enumerate(fin) if not f] != [2, 4] or \
            int(st.step) != G.STEPS - 2 or scales[2] != scales[1] / 2 or \
            scales[4] != scales[3] / 2:
        raise AssertionError(f"l1 fp16 overflow: finite {fin}, scales "
                             f"{scales}")
    policy = G.policy("O2", "dynamic", True, half_dtype=torch.float16)
    whole = G.run(policy, True)
    first = G.run(policy, True, steps=3)
    saved = (first[3]._replace(
        params={k: v.clone() for k, v in first[3].params.items()}),
        {k: v.clone() for k, v in first[4].items()}, 3)
    rest = G.run(policy, True, steps=G.STEPS - 3, state=saved)
    if rest[0] != whole[0][3:] or not _equal_trees(rest[3].params,
                                                   whole[3].params):
        raise AssertionError("l1 resume: the resumed run differs")
    log(f"phase l1_grid: fp16 overflow at steps 2 and 4 skipped and halved "
        f"the scale on both paths ({scales}); the resume after 3 steps is "
        f"bit for bit; {time.perf_counter() - t0:.1f} s")


def amp_remainder_phases(rows):
    """This slice's phases, in order; each logs its time."""
    from apex_tpu_torch import models

    t0 = time.perf_counter()
    mlp_dlrm_bottom_o1(rows)
    l1_grid()
    enc = models.BertLarge(device="cuda", seed=0)
    _, acc = bert_large_o2_fp16_accum(enc)
    del acc
    masters, grads = bert_large_fp16_optimizer(enc)
    legacy_updates(masters, grads)
    del masters, grads, enc
    log(f"phase amp_remainder: all in {time.perf_counter() - t0:.1f} s")


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def mha_perf_test(rows):
    """The reference Apex's MHA benchmark at its published width: 18 x
    ``SelfMultiheadAttn(1024, 16, dropout=0.1, include_norm_add=True)``,
    B128 x S64, cast to fp16 by ``fp16_utils.network_to_half``; forward and
    backward ms by events (5 warm-up trials, then the median of 20), beside
    the ``impl="default"`` stack (``--ref``) and the
    ``EncdecMultiheadAttn(include_norm_add=True)`` stack (``--encdec-attn``,
    a memory of the same length). Gates: a flash and a LayerNorm launch a
    layer each way (no flash on the default path), and one pass of the
    stack at ``deterministic=True`` through the kernels against the plain
    versions (output within TOL16, each grad within 2e-2 of its max)."""
    import torch
    from apex_tpu_torch import ops, train

    results = {}
    for label, kw in (("fast", {}), ("default", dict(impl="default")),
                      ("encdec", dict(encdec=True))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run, params, inputs = train.build_mha_perf_test(
            MHA_B, MHA_S, MHA_LAYERS, MHA_HIDDEN, MHA_HEADS, **kw)
        fwd = dict(MHA_FWD)
        bwd = dict(MHA_BWD)
        if label == "default":
            fwd.pop("flash_attn_fwd")
            bwd.pop("flash_attn_bwd")
        grads = torch.randn(inputs[0].shape, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(3)
                            ).to(inputs[0].dtype)
        ops.reset_launch_counts()
        out = run(params)
        check_launches(f"mha_perf_test {label} forward",
                       ops.launch_counts(), fwd, None, 1)
        ops.reset_launch_counts()
        out.backward(grads)
        check_launches(f"mha_perf_test {label} backward",
                       ops.launch_counts(), bwd, None, 1)
        ops.reset_launch_counts()
        f_ms, b_ms = [], []
        for trial in range(MHA_WARMUP + MHA_TRIALS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            out = run(params)
            ev[1].record()
            out.backward(grads)
            ev[2].record()
            torch.cuda.synchronize()
            if trial >= MHA_WARMUP:
                f_ms.append(ev[0].elapsed_time(ev[1]))
                b_ms.append(ev[1].elapsed_time(ev[2]))
        counts = ops.launch_counts()
        n = MHA_WARMUP + MHA_TRIALS
        check_launches(f"mha_perf_test {label}", counts, {**fwd, **bwd},
                       None, n)
        if not torch.isfinite(out).all().item():
            raise AssertionError(f"mha_perf_test {label}: output not finite")
        results[label] = (_median(f_ms), _median(b_ms))
        log(f"phase mha_perf_test: {label} stack ({MHA_LAYERS} layers, "
            f"B{MHA_B} S{MHA_S}, fp16): forward {results[label][0]:.4f} ms, "
            f"backward {results[label][1]:.4f} ms (median of {MHA_TRIALS} "
            f"after {MHA_WARMUP} warm-up), launches a trial "
            f"{ {k: v // n for k, v in counts.items() if v} }, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if label == "fast":
            for name in EXTRA_S64_ROWS:
                rows[name]["launches"] = counts[EXTRA_S64_ROWS[name][0]]
            mha_plain_vs_kernel(run, params, inputs, grads)
        del run, params, inputs, out
    f, d, e = (results[k] for k in ("fast", "default", "encdec"))
    log(f"phase mha_perf_test: fast/default forward {f[0] / d[0]:.3f}, "
        f"backward {f[1] / d[1]:.3f}; encdec/self forward "
        f"{e[0] / f[0]:.3f}, backward {e[1] / f[1]:.3f}")
    return results


def grads_within(phase, names, gk, gp, tol=TOL16):
    """Each gradient through the kernels within ``tol`` of its plain
    version's max magnitude; returns the worst ratio."""
    worst = 0.0
    for name, a, b in zip(names, gk, gp):
        e = (a.float() - b.float()).abs().max().item()
        ref = b.float().abs().max().item()
        if not e <= tol * max(ref, 1e-6):
            raise AssertionError(f"{phase} grad {name}: {e:.3e} > {tol} x "
                                 f"{ref:.3e}")
        worst = max(worst, e / max(ref, 1e-6))
    return worst


def mha_plain_vs_kernel(run, params, inputs, grads):
    """One pass of the stack at ``deterministic=True``, kernels against
    plain versions: output within TOL16 of its max, each grad (params and
    input) within 2e-2 of its tensor's max."""
    import torch

    leaves = [*params.values(), *inputs]
    outs = {}
    for mode in ("kernel", "plain"):
        with (plain_versions() if mode == "plain"
              else contextlib.nullcontext()):
            y = run(params, deterministic=True)
            outs[mode] = (y.detach(), torch.autograd.grad(y, leaves, grads))
    (yk, gk), (yp, gp) = outs["kernel"], outs["plain"]
    err = compare("mha_perf_test plain_vs_kernel output", [yk], [yp])
    worst = grads_within("mha_perf_test plain_vs_kernel", [*params, "input"],
                         gk, gp)
    log(f"phase mha_perf_test: deterministic pass kernel vs plain: output "
        f"max_abs_err {err:.3e}, grads within {worst:.3e} of their max")


def _train_phase(phase, step, state, per_step, items, steps, unit):
    """``steps`` steps of ``step(state) -> (state, loss)``: the launches of
    each kernel a step, finite losses; logs the median step ms (after the
    first), items/s and peak memory. Returns (losses, state, step ms)."""
    import torch
    from apex_tpu_torch import ops

    ops.reset_launch_counts()
    times, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state)
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launch_counts()
    for i, (l, t) in enumerate(zip(losses, times)):
        log(f"{phase} step {i}: loss {l:.6f}  {t:.2f} ms")
        if not math.isfinite(l):
            raise AssertionError(f"{phase} step {i} loss is not finite: {l}")
    check_launches(phase, counts, per_step, None, steps)
    step_ms = _median(times[1:])
    log(f"phase {phase}: launches per step "
        f"{ {k: v // steps for k, v in counts.items() if v} }")
    log(f"phase {phase}: median step {step_ms:.2f} ms (steps 1-{steps - 1}), "
        f"{items / step_ms * 1e3:.2f} {unit}/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return losses, state, step_ms


def mha_norm_add_train():
    """The MHA benchmark's norm-add stack trained through
    ``amp.initialize(..., "O2", half_dtype=torch.float16)`` and
    ``FusedAdam`` on the arena, MSE against a seeded target, dropout on: 5
    steps, one ``adam`` launch a step."""
    import torch
    from apex_tpu_torch import train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, state, _, _, _ = train.build_mha_train_step(
        MHA_B, MHA_S, MHA_LAYERS, MHA_HIDDEN, MHA_HEADS)
    _, state, _ = _train_phase("mha_norm_add_train", step, state,
                               MHA_TRAIN_PER_STEP, MHA_B, 5, "seq")
    log(f"phase mha_norm_add_train: {int(state.step)} of 5 steps applied, "
        f"loss scale {state.scalers[0].loss_scale.item():.0f}")


def transformer_pre_ln():
    """24 x ``TransformerLayer(1024, 16, 4096, dropout=0.1, pre_ln=True)``,
    B16 x S512 with ``bert_large_dropout``'s padding masks, O1 bf16, the
    arena ``FusedLAMB``, MSE against a seeded target: 5 steps (48 LN and 24
    flash launches each way a step, the arena LAMB once). Then
    :func:`pre_ln_plain_vs_kernel`."""
    import torch
    from apex_tpu_torch import train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, state, (_, mask, _), _, model = train.build_transformer_step(
        16, 512, PRE_LN_LAYERS)
    log(f"phase transformer_pre_ln: built, "
        f"{sum(p.numel() for p in model.parameters())} params, "
        f"{int(mask.sum())} of {mask.numel()} tokens real")
    _train_phase("transformer_pre_ln", step, state, PRE_LN_PER_STEP, 16, 5,
                 "seq")
    del step, state, model
    torch.cuda.empty_cache()
    pre_ln_plain_vs_kernel()


def pre_ln_plain_vs_kernel():
    """A depth-2 pre-LN stack (B16 S512, padded, O1 bf16), without and with
    dropout, through the kernels and through ``plain_versions()``: the
    first step's loss within PRE_LN_LOSS_TOL relative, the output (f32:
    bf16 sublayers on the f32 residual) within TOL16 of its max, and each
    param's gradient within TOL16 of its tensor's max (``grads_within``).
    Both modes draw dropout from the same seed; the kernel pass launches
    every LN and flash kernel of the stack, the plain pass none."""
    import torch
    from apex_tpu_torch import amp, ops, train

    for dropout in (0.0, 0.1):
        outs = {}
        for mode in ("kernel", "plain"):
            _, _, (x, mask, target), policy, model = \
                train.build_transformer_step(16, 512, 2, dropout=dropout)
            names, params = zip(*model.named_parameters())
            gen = torch.Generator("cuda").manual_seed(0)
            ops.reset_launch_counts()
            with (plain_versions() if mode == "plain"
                  else contextlib.nullcontext()):
                with amp.auto_cast(policy):
                    y = model(x, mask, deterministic=dropout == 0.0,
                              generator=gen)
                loss = torch.mean(torch.square(y.float() - target))
                grads = torch.autograd.grad(loss, params)
            check_launches(f"pre_ln_plain_vs_kernel {mode}",
                           ops.launch_counts(),
                           {} if mode == "plain" else PRE_LN_DEPTH2, None, 1)
            outs[mode] = (loss.item(), y.detach(), grads)
            del model, y, grads
        (lk, yk, gk), (lp, yp, gp) = outs["kernel"], outs["plain"]
        rel = abs(lk - lp) / abs(lp)
        if not rel <= PRE_LN_LOSS_TOL:
            raise AssertionError(f"pre-LN kernel/plain loss differ by "
                                 f"{rel:.2e} > {PRE_LN_LOSS_TOL} (dropout "
                                 f"{dropout})")
        err = compare(f"pre_ln_plain_vs_kernel dropout {dropout} output",
                      [yk], [yp], tol32=TOL16)
        worst = grads_within(f"pre_ln_plain_vs_kernel dropout {dropout}",
                             names, gk, gp)
        log(f"phase transformer_pre_ln: depth-2 dropout {dropout} kernel vs "
            f"plain: first-step loss {lk:.6f} / {lp:.6f} (rel {rel:.2e}), "
            f"output max_abs_err {err:.3e}, {len(gk)} params' grads within "
            f"{worst:.3e} of their max")
        del outs


def _step_kernels(step, state):
    """(device kernels, device busy ms, wall ms) of one more step, from
    ``torch.profiler``; the launch counts are reset after it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from apex_tpu_torch import ops

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ks = device_kernels(prof)
    ops.reset_launch_counts()
    return len(ks), sum(e.time_range.elapsed_us() for e in ks) / 1e3, wall


def train_rnn(phase, make, batch, seq, input_size):
    """RNN_STEPS steps of ``make()`` under O1 bf16 with the arena
    ``FusedAdam``, MSE against a seeded target: one ``adam`` launch a step,
    finite losses; then one profiled step (device kernels a step, busy
    share)."""
    import torch
    from apex_tpu_torch import train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = make()
    step, state, (x, _), _, _ = train.build_rnn_step(model, batch, seq,
                                                     input_size)
    log(f"phase {phase}: built, {sum(p.numel() for p in model.parameters())}"
        f" params, input {tuple(x.shape)}, dropout {model.dropout}")
    _, state, step_ms = _train_phase(phase, step, state, RNN_PER_STEP, batch,
                                     RNN_STEPS, "seq")
    n, busy, wall = _step_kernels(step, state)
    log(f"phase {phase}: profiled step: {n} device kernels, busy "
        f"{busy:.2f} ms of {wall:.2f} ms (idle share "
        f"{max(0.0, 1 - busy / wall):.3f})")
    return step_ms


def rnn_gru_cpu_vs_card():
    """A bidirectional 2-layer GRU (32 -> 64, B4, T12) in f32 (no
    ``auto_cast``: an enabled policy casts the Dense layers to bf16, O0
    too): the MSE loss of one forward and every param's gradient on the
    card against the CPU, within RNN_CPU_TOL relative L2 (TF32 off). The
    gradients, not the updated params: a param's update (p1 − p0) carries
    p's rounding, an ulp of p against an update of lr·g."""
    import numpy as np
    import torch
    from apex_tpu_torch import models

    rng = np.random.RandomState(0)
    x = rng.randn(4, 12, 32).astype(np.float32)
    target = rng.rand(4, 12, 128).astype(np.float32) * 2 - 1
    out = {}
    for dev in ("cpu", "cuda"):
        model = models.GRU(32, 64, num_layers=2, bidirectional=True,
                           device="cpu", seed=5).to(dev)
        y = model(torch.tensor(x, device=dev))
        loss = torch.mean(torch.square(y - torch.tensor(target, device=dev)))
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
        out[dev] = {"loss": loss.detach().cpu().double().reshape(1),
                    **{n: g.cpu().double() for n, g in zip(names, grads)}}
    worst = 0.0
    for name, want in out["cpu"].items():
        got = out["cuda"][name]
        rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
        if not rel <= RNN_CPU_TOL:
            raise AssertionError(f"rnn GRU card vs CPU {name}: rel L2 "
                                 f"{rel:.3e} > {RNN_CPU_TOL}")
        worst = max(worst, rel)
    log(f"phase rnn_gru_cpu_vs_card: bidirectional 2-layer GRU, card vs "
        f"CPU: the loss and {len(out['cpu']) - 1} params' gradients within "
        f"rel L2 {worst:.3e}")


def weight_norm_phase():
    """``apply_weight_norm(Dense(1024, 4096))`` at O2 fp16 with weights near
    1e-4, whose squares underflow fp16: the f32 normalized weight against
    float64 within WEIGHT_NORM_TOL relative, the fp16 weight that value
    rounded, and ``remove_weight_norm`` giving the same forward within
    TOL16."""
    import torch
    from torch.func import functional_call
    from apex_tpu_torch import amp, models, reparam
    from apex_tpu_torch.reparam import weight_norm as WN

    gen = torch.Generator("cuda").manual_seed(7)
    layer = models.Dense(1024, 4096)
    with torch.no_grad():
        layer.weight.normal_(0.0, 1e-4, generator=gen)
        layer.bias.normal_(0.0, 1e-2, generator=gen)
    wn = reparam.apply_weight_norm(layer)
    with torch.no_grad():
        wn.scale.normal_(1.0, 0.1, generator=gen)
    policy = amp.Policy.from_opt_level("O2", half_dtype=torch.float16)
    hp = policy.cast_params(dict(wn.named_parameters()))
    v16, g16 = hp["layer.weight"], hp["scale"]
    under = int(((v16 * v16).sum(dim=1).double()
                 < 0.5 * (v16.double() ** 2).sum(dim=1)).sum())
    v64, g64 = v16.double(), g16.double()
    ref = g64[:, None] * v64 / v64.norm(dim=1, keepdim=True)
    w32 = WN.normalized_weight(v16, g16, torch.float32)
    rel = ((w32.double() - ref).abs().max() / ref.abs().max()).item()
    if not rel <= WEIGHT_NORM_TOL:
        raise AssertionError(f"weight_norm: f32 norm {rel:.3e} from float64")
    if not torch.equal(WN.normalized_weight(v16, g16), w32.half()):
        raise AssertionError("weight_norm: the fp16 weight is not the f32 "
                             "normalized weight rounded")
    naive = v16 * torch.rsqrt((v16 * v16).sum(dim=1, keepdim=True)
                              + WN.EPS) * g16[:, None]
    bad = int((~torch.isfinite(naive)).sum())
    naive_err = (naive.double() - ref).nan_to_num(float("inf")).abs().max()
    x = torch.randn(8192, layer.in_features, generator=gen,
                    device="cuda").half()
    folded = reparam.remove_weight_norm(dict(wn.named_parameters()))
    with torch.no_grad():
        y = functional_call(wn, hp, (x,))
        y2 = functional_call(layer, {
            k[len("layer."):]: v for k, v in
            policy.cast_params(folded).items()}, (x,))
    err = compare("weight_norm remove_weight_norm forward", [y2], [y])
    log(f"phase weight_norm: {under} of {v16.shape[0]} rows' fp16 sums of "
        f"squares "
        f"under half their float64 value; f32 norm within {rel:.3e} of "
        f"float64, fp16 weight its rounding; the weight's-dtype arithmetic "
        f"(flax's) off by {naive_err.item():.3e} with {bad} non-finite; "
        f"remove_weight_norm forward max_abs_err {err:.3e}")


def dcgan_example():
    """The DCGAN example's step (``examples/dcgan/main_amp.py``'s defaults:
    B64, 64x64, O2 bf16, ngf = ndf = 64, no ``auto_cast``): 20 steps, two
    ``adam`` launches a step (D's one update on gR + gF, G's one), finite
    losses; data drawn before each step's clock."""
    import torch
    from apex_tpu_torch import ops, train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, (sd, sg, bsd, bsg), draw, _, _ = train.build_dcgan_example_step(64)
    ops.reset_launch_counts()
    times, losses = [], []
    for _ in range(DCGAN_STEPS):
        real, z = draw()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sd, sg, bsd, bsg, err_d, err_g = step(sd, sg, bsd, bsg, real, z)
        losses.append((err_d.item(), err_g.item()))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    for i in (0, 1, DCGAN_STEPS - 1):
        log(f"dcgan_example step {i}: Loss_D {losses[i][0]:.4f} Loss_G "
            f"{losses[i][1]:.4f}  {times[i]:.2f} ms")
    if not all(math.isfinite(v) for l in losses for v in l):
        raise AssertionError("dcgan_example: a loss is not finite")
    check_launches("dcgan_example", ops.launch_counts(),
                   DCGAN_EXAMPLE_PER_STEP, None, DCGAN_STEPS)
    if (int(sd.step), int(sg.step)) != (DCGAN_STEPS, DCGAN_STEPS):
        raise AssertionError(f"dcgan_example: D/G steps {int(sd.step)}, "
                             f"{int(sg.step)}")
    step_ms = _median(times[1:])
    log(f"phase dcgan_example: median step {step_ms:.2f} ms (steps "
        f"1-{DCGAN_STEPS - 1}), {64 / step_ms * 1e3:.2f} img/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


def attention_remainder_phases(rows):
    """This slice's phases, in order; each logs its time."""
    import torch
    from apex_tpu_torch import models

    for name, fn in (
            ("mha_perf_test", lambda: mha_perf_test(rows)),
            ("mha_norm_add_train", mha_norm_add_train),
            ("transformer_pre_ln", transformer_pre_ln),
            ("rnn_mlstm", lambda: train_rnn(
                "rnn_mlstm", lambda: models.mLSTM(64, 4096), 128, 256, 64)),
            ("rnn_lstm", lambda: train_rnn(
                "rnn_lstm", lambda: models.LSTM(1500, 1500, num_layers=2,
                                                dropout=0.65), 20, 35, 1500)),
            ("rnn_gru_cpu_vs_card", rnn_gru_cpu_vs_card),
            ("weight_norm", weight_norm_phase),
            ("dcgan_example", dcgan_example)):
        t0 = time.perf_counter()
        fn()
        torch.cuda.empty_cache()
        log(f"phase {name}: took {time.perf_counter() - t0:.1f} s")


# --- robustness: checkpoints and the guard ------------------------------------

def _leaves_equal(a, b):
    """Every leaf of two state trees bit for bit (generators by state);
    returns the paths that differ."""
    import torch
    from apex_tpu_torch.ckpt import tree_paths
    pa, pb = tree_paths(a), tree_paths(b)
    if [p for p, _ in pa] != [p for p, _ in pb]:
        return ["<structure>"]
    bad = []
    for (p, x), (_, y) in zip(pa, pb):
        if isinstance(x, torch.Generator):
            x, y = x.get_state(), y.get_state()
        if not (x.dtype == y.dtype and x.shape == y.shape
                and torch.equal(x.reshape(-1).view(torch.uint8)
                                if x.is_floating_point() else x,
                                y.reshape(-1).view(torch.uint8)
                                if y.is_floating_point() else y)):
            bad.append(p)
    return bad


def _dir_bytes(d):
    return sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d))


class _Clock:
    """Seconds a phase spends in each named part (``with clock("build"):``)
    and in the rest; ``line(phase)`` is the phase's breakdown."""

    def __init__(self):
        self.t0, self.parts = time.perf_counter(), {}

    @contextlib.contextmanager
    def __call__(self, part):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.parts[part] = (self.parts.get(part, 0.0)
                                + time.perf_counter() - t)

    def line(self, phase):
        total = time.perf_counter() - self.t0
        rest = total - sum(self.parts.values())
        return (f"phase {phase}: took {total:.1f} s: "
                + ", ".join(f"{k} {v:.1f}" for k, v in self.parts.items())
                + f", other {rest:.1f}")


def _ckpt_resume(phase, build, bound=contextlib.nullcontext, params=False):
    """Run A: RESUME_STEPS steps; run B: RESUME_AT steps, an async ``save``
    at step RESUME_AT while the rest run; then a restore into a freshly
    built state and generator, and the rest again. Gates: B's and the resumed
    run's losses and every leaf of the resumed state (the generator's
    state too) equal run A's bit for bit. Returns the manifest."""
    import tempfile
    import torch
    from apex_tpu_torch import ckpt

    clock = _Clock()

    def run(step, state, toks, labels, steps):
        losses = []
        with clock("steps"):
            for _ in range(steps):
                with bound():
                    state, loss = step(state, toks, labels)
                losses.append(loss.item())
        return state, losses

    with clock("build"):
        step, sa, toks, labels = build()
    sa, la = run(step, sa, toks, labels, RESUME_STEPS)
    want = {"amp": sa, "gen": step.generator}
    root = tempfile.mkdtemp(prefix=f"chip_smoke_{phase}_")
    try:
        with clock("build"):
            step, sb, toks, labels = build()
        sb, lb = run(step, sb, toks, labels, RESUME_AT)
        events = []
        mgr = ckpt.CheckpointManager(root, keep=1, event_sink=events.append)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        segs = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        torch.cuda.reset_peak_memory_stats()
        t_save = time.time()
        with clock("save"):
            stall = mgr.save(RESUME_AT, {"amp": sb, "gen": step.generator},
                             params=sb.params if params else None,
                             extra={"cursor": {"epoch": 0,
                                               "batch": RESUME_AT}})
        new_segs = torch.cuda.memory_stats().get(
            "segment.all.allocated", 0) - segs
        sb, rest = run(step, sb, toks, labels, RESUME_STEPS - RESUME_AT)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        with clock("commit wait"):
            mgr.wait()
        saved = [e for e in events if e["kind"] == "ckpt_save"][0]
        commit_s = saved["wall_time"] - t_save
        d = mgr.latest()
        nbytes = _dir_bytes(d)
        lb += rest
        del sb, step
        torch.cuda.empty_cache()
        with clock("build"):
            step, sc, toks, labels = build()
        with clock("restore"):
            tree, manifest = mgr.restore({"amp": sc, "gen": step.generator})
        restore_s = clock.parts["restore"]
        sc, lc = run(step, tree["amp"], toks, labels,
                     RESUME_STEPS - RESUME_AT)
        got = {"amp": sc, "gen": step.generator}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if lb != la or lc != la[RESUME_AT:]:
        raise AssertionError(f"{phase}: losses uninterrupted {la}, with the "
                             f"async save {lb}, resumed {lc}")
    with clock("compare"):
        bad = _leaves_equal(got, want)
    if bad:
        raise AssertionError(f"{phase}: resumed state differs at {bad[:5]}")
    log(f"phase {phase}: losses {la} bit for bit with the async save at "
        f"step {RESUME_AT} and after the restore; every leaf of the resumed "
        f"state (and the generator's) equal the uninterrupted run's")
    log(f"phase {phase}: save() step-path stall {stall:.3f} ms ({new_segs} "
        f"new device segments allocated in it), snapshot-to-commit "
        f"{commit_s:.3f} s (write {saved['dur_ms']:.1f} ms), {nbytes} bytes "
        f"on disk ({saved['n_arrays']} arrays), peak {peak:.3f} GiB over "
        f"the state with the snapshot in HBM, restore {restore_s:.3f} s")
    log(clock.line(phase))
    return manifest


def bert_large_ckpt_resume():
    """Phase bert_large_ckpt_resume: the published BERT-Large step
    (``build_bert_step(16, 512, strategy="arena", dropout=0.1,
    padded=True)``, O1 bf16) resumed from an async checkpoint of the
    amp state and ``step.generator`` (the dropout seeds' source) bit for
    bit (``_ckpt_resume``)."""
    from apex_tpu_torch import train

    def build():
        step, state, (toks, labels), _, _ = train.build_bert_step(
            16, 512, strategy="arena", dropout=0.1, padded=True)
        return step, state, toks, labels

    _ckpt_resume("bert_large_ckpt_resume", build)


def bert_large_zero_ckpt_resume(mesh):
    """Phase bert_large_zero_ckpt_resume: the same through
    ``DistributedFusedLAMB`` at NCCL world 1 (the mesh bound for the build,
    the steps and the save), the manifest's ``zero`` map naming every slot
    shard with its logical length."""
    from apex_tpu_torch import arena, parallel, train
    from apex_tpu_torch.optim import DistributedFusedLAMB

    def build():
        with parallel.use_mesh(mesh):
            step, state, (toks, labels), _, _ = train.build_bert_step(
                16, 512, optimizer=DistributedFusedLAMB(lr=1e-3),
                dropout=0.1, padded=True)
        return step, state, toks, labels

    manifest = _ckpt_resume("bert_large_zero_ckpt_resume", build,
                            bound=lambda: parallel.use_mesh(mesh),
                            params=True)
    zero = manifest["zero"]
    slots = {f".opt_state.slots['{s}']['float32']" for s in
             ("master", "m", "v")}
    want = {f"['amp']{p}" for p in slots}
    if set(zero) != want or len(set(zero.values())) != 1:
        raise AssertionError(f"bert_large_zero_ckpt_resume: zero map {zero}")
    log(f"phase bert_large_zero_ckpt_resume: zero map {zero}")


def zero_ckpt_rank(rank, world):
    """One rank of zero_elastic_two_to_one: a depth-2 encoder at BERT-Large
    widths (O1 bf16) with ``DistributedFusedLAMB`` takes one step on this
    rank's rows of the seeded batch and saves its shards (rank 0 commits
    the manifest); returns the slots' logical buffers gathered from both
    ranks."""
    from apex_tpu_torch import arena, ckpt, parallel, train
    from apex_tpu_torch.optim import DistributedFusedLAMB
    from apex_tpu_torch.parallel import collectives

    mesh = parallel.data_parallel_mesh(DEVICE)
    with parallel.use_mesh(mesh):
        step, state, (toks, labels), _, _ = train.build_bert_step(
            ZERO_RANK_BATCH * world, 512, encoder=depth2_encoder(),
            optimizer=DistributedFusedLAMB(lr=1e-3))
        n = ZERO_RANK_BATCH
        state, _ = step(state, toks[rank * n:(rank + 1) * n],
                        labels[rank * n:(rank + 1) * n])
    mgr = ckpt.CheckpointManager(os.environ["CHIP_SMOKE_CKPT_ROOT"],
                                 rank=rank, process_count=world)
    mgr.save(1, {"amp": state}, params=state.params, block=True)
    n_logical = {p.dtype: p.buffer_len
                 for p in arena.plan(state.params).partitions}
    logical = {s: {dt: collectives.all_gather(b, None, "check", tiled=True)
                   [:n_logical[dt]].cpu()
                   for dt, b in d.items()}
               for s, d in state.opt_state.slots.items()}
    return {"logical": logical, "count": int(state.opt_state.count)}


def zero_ckpt_body(rank, world, tmp):
    _run_rank(zero_ckpt_rank, rank, world, tmp)


def zero_restore(mesh, root, logical):
    """The world-1 half of zero_elastic_two_to_one, in this process on its
    NCCL world-1 ``mesh``: restore the two ranks' checkpoint under
    ``root`` into a freshly built world-1 state, then one step from it and
    one from a world-1 state made directly from the gathered ``logical``
    buffers."""
    import torch
    from apex_tpu_torch import ckpt, parallel, train
    from apex_tpu_torch.optim import DistributedFusedLAMB, ShardedOptState
    from apex_tpu_torch.optim.distributed import _padded_len

    with parallel.use_mesh(mesh):
        step, like, (toks, labels), _, _ = train.build_bert_step(
            ZERO_RANK_BATCH, 512, encoder=depth2_encoder(),
            optimizer=DistributedFusedLAMB(lr=1e-3))
    mgr = ckpt.CheckpointManager(root, rank=0, process_count=1)
    tree, manifest = mgr.restore({"amp": like})
    got = tree["amp"]
    slots_equal = all(
        torch.equal(got.opt_state.slots[s][dt][:len(b)].cpu(), b)
        and not got.opt_state.slots[s][dt][len(b):].any()
        for s, d in logical.items() for dt, b in d.items())
    direct = got._replace(opt_state=ShardedOptState(
        count=got.opt_state.count.clone(),
        slots={s: {dt: torch.nn.functional.pad(
            b.to(DEVICE), (0, _padded_len(len(b), 1) - len(b)))
            for dt, b in d.items()} for s, d in logical.items()}))
    with parallel.use_mesh(mesh):
        a, la = step(got, toks, labels)
        b, lb = step(direct, toks, labels)
    next_equal = not _leaves_equal(a, b) and la.item() == lb.item()
    return {"slots_equal": slots_equal, "next_equal": next_equal,
            "resharded_from": manifest["process_count"],
            "zero": manifest["zero"], "loss": la.item(),
            "count": int(got.opt_state.count)}


def zero_elastic_two_to_one(mesh):
    """Phase zero_elastic_two_to_one: two gloo processes on the card save a
    ZeRO state (the model of zero_two_ranks); this process restores it at
    world 1 (``mesh``): the slot buffers equal the saved logical buffers
    bit for bit (zero past them), and the next step equals a world-1 step
    from a state made directly from the gathered buffers, bit for bit."""
    import tempfile
    import torch

    clock = _Clock()
    root = tempfile.mkdtemp(prefix="chip_smoke_zero_elastic_")
    os.environ["CHIP_SMOKE_CKPT_ROOT"] = root
    try:
        with clock("two ranks save"):
            saved = _spawn("zero_elastic_two_to_one (save)", zero_ckpt_body,
                           2)
        for s, d in saved[0]["logical"].items():
            for dt, b in d.items():
                if not torch.equal(b, saved[1]["logical"][s][dt]):
                    raise AssertionError("zero_elastic_two_to_one: the "
                                         "ranks gathered different buffers")
        with clock("world-1 restore and steps"):
            out = zero_restore(mesh, root, saved[0]["logical"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
        os.environ.pop("CHIP_SMOKE_CKPT_ROOT", None)
    if not (out["slots_equal"] and out["next_equal"]
            and out["resharded_from"] == 2 and out["count"] == 1):
        raise AssertionError(f"zero_elastic_two_to_one: {out}")
    log(f"phase zero_elastic_two_to_one: 2 ranks saved, 1 restored: slots "
        f"= the gathered logical buffers bit for bit; next step (loss "
        f"{out['loss']:.6f}) = a world-1 step from the gathered state; zero "
        f"map {out['zero']}")
    log(clock.line("zero_elastic_two_to_one"))


class _TokenSource:
    """A seeded, cursor-bearing source of BERT batches (the duck type
    ``GuardPolicy.rewind`` takes): batch ``i`` is drawn from
    ``RandomState(seed + i)``, labels -1 where ``mask`` pads; each batch is
    ``(weights, toks, labels)``, ``weights`` a float per sequence (ones)
    that scales the loss — the batch site a corrupted batch poisons."""

    def __init__(self, mask, seed=1, vocab=30000, per_epoch=1000):
        self.mask, self.seed, self.vocab, self.per = mask, seed, vocab, \
            per_epoch
        self.i = 0

    def state(self):
        return {"epoch": self.i // self.per, "batch": self.i % self.per}

    def load_state(self, c):
        self.i = int(c["epoch"]) * self.per + int(c["batch"])

    def cursor_index(self):
        return self.i

    def skip_batches(self, n):
        self.i += int(n)

    def next(self):
        import numpy as np
        import torch
        rng = np.random.RandomState(self.seed + self.i)
        self.i += 1
        b, s = self.mask.shape
        toks = torch.as_tensor(rng.randint(0, self.vocab, (b, s)),
                               device=DEVICE)
        labels = torch.as_tensor(rng.randint(0, self.vocab, (b, s)),
                                 device=DEVICE)
        labels = torch.where(self.mask, labels, -1)
        return torch.ones(b, device=DEVICE), toks, labels


def _nan_grad():
    """An identity on the loss whose backward multiplies its gradient by a
    device scalar: NaN poisons every gradient, the loss stays finite (the
    ``grads:nan`` fault of the plan's ``fault_code``)."""
    import torch

    class NanGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, factor):
            ctx.save_for_backward(factor)
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return g * ctx.saved_tensors[0], None

    return NanGrad.apply


def _guarded_bert(step, state, gs, gcfg, batch, code, poison):
    """One guarded step of the BERT-Large arena step on ``batch``:
    ``(state', loss, committed, gs')``; ``code`` the plan's fault code."""
    import torch
    from apex_tpu_torch.guard import chaos

    weights, toks, labels = batch
    w = weights.mean()
    factor = torch.full((), float("nan") if code & chaos.C_GRAD_NAN
                        else 1.0, device=DEVICE)
    inner = step.make_loss(toks, labels)

    def loss_fn(mp):
        return poison(inner(mp) * w, factor)
    return step.amp_opt.step(state, loss_fn, guard=(gs, gcfg))


def bert_large_guard(rows):
    """Phase bert_large_guard: the published BERT-Large arena step under
    ``Amp.step(guard=...)`` with ``GuardConfig(window=8, min_history=4)``,
    a ``FaultPlan`` (NaN grads at GUARD_NAN_GRAD, a batch scaled by 1000 at
    GUARD_SPIKE, NaN params after GUARD_NAN_PARAM), a ``_TokenSource``
    and a ``GuardPolicy`` over a ``CheckpointManager`` (one save at
    GUARD_SAVE). Gates: each skipped step leaves params, optimizer state
    and ``step`` bit for bit; the nonfinite params make the policy rewind
    to the saved step with the cursor fast-forwarded, and the steps after
    it equal bit for bit a run of the plain (unguarded) step that never
    saw the skipped batches; every guarded step launches the hand kernels
    the unguarded step does, skipped or committed; one guarded step runs
    under ``set_sync_debug_mode("error")``; the guard's finite probe sees
    one NaN or inf anywhere in a param-sized tensor of each dtype. Then
    the guard's cost a step (device ms and device kernels from the
    profiler, host ms in turns) and the integrity fingerprint of
    BERT-Large's params on the card against the same tensors' on the
    CPU."""
    import tempfile
    import torch
    from apex_tpu_torch import ckpt, guard, ops, train

    phase = "bert_large_guard"
    clock = _Clock()
    per_step = dict(EXPECTED_PER_STEP, **ARENA_PER_STEP)
    gcfg = guard.GuardConfig(**GUARD_CFG)
    with clock("build"):
        step, state, _, _, _ = train.build_bert_step(
            16, 512, strategy="arena", dropout=0.1, padded=True)
    gs = guard.guard_init(gcfg, device=DEVICE)
    src = _TokenSource(step.attn_mask)
    plan = guard.FaultPlan([
        guard.Fault(GUARD_NAN_GRAD, "grads", "nan"),
        guard.Fault(GUARD_SPIKE, "batch", "overflow", arg=1000.0),
        guard.Fault(GUARD_NAN_PARAM, "params", "nan")], seed=0)
    harness = guard.ChaosHarness(plan)
    poison = _nan_grad()
    root = tempfile.mkdtemp(prefix="chip_smoke_guard_")
    mgr = ckpt.CheckpointManager(root, keep=1)
    events = []
    policy = guard.GuardPolicy(manager=mgr, event_sink=events.append)
    losses, actions, skipped, after, rewound = {}, {}, [], [], None
    try:
        i = 0
        while len(after) < GUARD_AFTER:
            batch = harness.filter_batch(i, src.next())
            code = harness.fault_code(i)
            prev = state
            ops.reset_launch_counts()
            with clock("guarded steps"):
                state, loss, committed, gs = _guarded_bert(
                    step, state, gs, gcfg, batch, code, poison)
                counts = {k: v for k, v in ops.launch_counts().items() if v}
                losses[i] = loss.item()
                act = policy.update(i, gs)
            if counts != per_step:
                raise AssertionError(f"{phase} step {i}: launches {counts}")
            actions[i] = (act.kind, act.classes)
            if not bool(committed):
                with clock("compare"):
                    bad = _leaves_equal(state, prev)
                if bad:
                    raise AssertionError(f"{phase}: skipped step {i} moved "
                                         f"{bad[:5]}")
                skipped.append(i)
            if act.kind == "rewind":
                with clock("rewind (restore)"):
                    tree, manifest = policy.rewind(
                        i, {"amp": state, "gs": gs, "gen": step.generator},
                        src, reason=act.reason)
                state, gs = tree["amp"], tree["gs"]
                rewound = (i, int(manifest["step"]), src.cursor_index())
            elif rewound is not None and act.kind == "none":
                after.append((i, losses[i]))
            state = harness.post_step(i, state)
            if i == GUARD_SAVE:
                with clock("save (blocking)"):
                    mgr.save(i, {"amp": state, "gs": gs,
                                 "gen": step.generator},
                             extra={"cursor": src.state()}, block=True)
            i += 1
        final = state
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want_skips = [GUARD_NAN_GRAD, GUARD_SPIKE, GUARD_NAN_PARAM + 1]
    if skipped != want_skips or rewound[:2] != (GUARD_NAN_PARAM + 1,
                                                GUARD_SAVE):
        raise AssertionError(f"{phase}: skipped {skipped}, rewound "
                             f"{rewound}, actions {actions}")
    log(f"phase {phase}: actions "
        f"{ {k: v for k, v in actions.items() if v[0] != 'none'} }; skipped "
        f"steps {skipped} left params, optimizer state and step bit for "
        f"bit; rewound at step {rewound[0]} to step {rewound[1]}, cursor at "
        f"{rewound[2]}; {len(losses)} guarded steps, each with the "
        f"unguarded step's hand-kernel launches {per_step}")

    # the oracle: the unguarded step, fresh, on batches 0..GUARD_SAVE and
    # then from the rewound cursor on
    del state, prev, gs
    torch.cuda.empty_cache()
    with clock("build"):
        ostep, ostate, _, _, _ = train.build_bert_step(
            16, 512, strategy="arena", dropout=0.1, padded=True)
    osrc = _TokenSource(ostep.attn_mask)
    olosses = []
    with clock("oracle steps"):
        for _ in range(GUARD_SAVE + 1):
            _, toks, labels = osrc.next()
            ostate, _ = ostep(ostate, toks, labels)
        osrc.skip_batches(rewound[2] - osrc.cursor_index())
        for _ in range(GUARD_AFTER):
            _, toks, labels = osrc.next()
            ostate, loss = ostep(ostate, toks, labels)
            olosses.append(loss.item())
    with clock("compare"):
        bad = _leaves_equal(final, ostate)
    if [l for _, l in after] != olosses or bad or not torch.equal(
            step.generator.get_state(), ostep.generator.get_state()):
        raise AssertionError(f"{phase}: after the rewind {after} vs a run "
                             f"that never saw the skipped batches "
                             f"{olosses}; differing leaves {bad[:5]}")
    log(f"phase {phase}: the {GUARD_AFTER} steps after the rewind equal a "
        f"run that never saw batches {GUARD_SAVE + 1}-{rewound[2] - 1} bit "
        f"for bit (losses {olosses}, every leaf, the generator)")

    # no host sync in a guarded step
    gs = guard.guard_init(gcfg, device=DEVICE)
    batch = src.next()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ostate, _, _, gs = _guarded_bert(ostep, ostate, gs, gcfg, batch, 0,
                                         poison)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    # the finite probe on the card: one NaN or inf anywhere in a
    # param-sized tensor of each dtype, among clean ones
    from apex_tpu_torch.guard.detect import _all_finite
    big = {"clean": torch.ones(1024, 1024, device=DEVICE)}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for at in (0, 777_777, 4 * 1024 * 1024 - 1):
            for bad_v in (float("nan"), float("-inf")):
                x = torch.ones(4 * 1024 * 1024, dtype=dt, device=DEVICE)
                x[at] = bad_v
                if bool(_all_finite(dict(big, x=x))):
                    raise AssertionError(f"{phase}: the finite probe "
                                         f"missed {bad_v} at {at} in {dt}")
        x = torch.full((4 * 1024 * 1024,), torch.finfo(dt).max, dtype=dt,
                       device=DEVICE)
        if not bool(_all_finite(dict(big, x=x))):
            raise AssertionError(f"{phase}: the finite probe flagged "
                                 f"{dt}'s largest value")
    del big, x

    # the guard's cost: guarded and plain steps in turns
    def plain():
        nonlocal ostate
        ostate, _ = ostep(ostate, batch[1], batch[2])

    def guarded():
        nonlocal ostate, gs
        ostate, _, _, gs = _guarded_bert(ostep, ostate, gs, gcfg, batch, 0,
                                         poison)

    times = {"plain": [], "guarded": []}
    with clock("cost: host-timed steps"):
        for fn in (plain, guarded, guarded, plain) * GUARD_COST_TURNS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times["plain" if fn is plain else "guarded"].append(
                (time.perf_counter() - t0) * 1e3)
    kernels, dev = {}, {"plain": [], "guarded": []}
    with clock("cost: profiled steps"):
        for name, fn in (("plain", plain), ("guarded", guarded),
                         ("guarded", guarded), ("plain", plain)):
            # a guarded session (its lead of short spins doubled up to
            # MAX_LEAD while a session keeps none of them); the spins are
            # left out by name
            _, ks = guarded_session(fn, lambda ks: any(
                e.name in _SPIN_NAMES for e in ks))
            ks = [e for e in ks if e.name not in _SPIN_NAMES]
            kernels.setdefault(name, collections.Counter(e.name for e in ks))
            dev[name].append(sum(e.time_range.elapsed_us() for e in ks)
                             / 1e3)
    pm, gm = (_median(times["plain"]), _median(times["guarded"]))
    pd, gd = (_median(dev["plain"]), _median(dev["guarded"]))
    extra = kernels["guarded"] - kernels["plain"]
    n_g, n_p = (sum(kernels[k].values()) for k in ("guarded", "plain"))
    log(f"phase {phase}: guard cost on the device {gd - pd:.3f} ms a step "
        f"(kernel time guarded {dev['guarded']}, plain {dev['plain']} ms, "
        f"profiled in turns); on the host clock {gm - pm:.3f} ms (guarded "
        f"{gm:.3f} ms, plain {pm:.3f} ms, medians of "
        f"{2 * GUARD_COST_TURNS} in turns; guarded {times['guarded']}, "
        f"plain {times['plain']}); device kernels a step {n_g} guarded, "
        f"{n_p} plain ({n_g - n_p} extra; most: "
        f"{[(k[:40], v) for k, v in extra.most_common(5)]})")

    # the fingerprint of BERT-Large's params, card against CPU
    params = ostate.params
    n = sum(p.numel() for p in params.values())
    guard.fingerprint_tree(params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fp_card = int(guard.fingerprint_tree(params))
    fp_ms = (time.perf_counter() - t0) * 1e3
    extra = (torch.cuda.max_memory_allocated() - base) / 2**30
    with clock("fingerprint on the CPU"):
        t0 = time.perf_counter()
        fp_cpu = int(guard.fingerprint_tree({k: v.cpu()
                                             for k, v in params.items()}))
        cpu_s = time.perf_counter() - t0
    if fp_card != fp_cpu:
        raise AssertionError(f"{phase}: fingerprint card {fp_card:#010x} "
                             f"vs CPU {fp_cpu:#010x}")
    log(f"phase {phase}: fingerprint of {len(params)} tensors, {n} params: "
        f"{fp_card:#010x} on the card = on the CPU; {fp_ms:.2f} ms on the "
        f"card (extra peak {extra:.3f} GiB), {cpu_s:.1f} s on the CPU")
    log(clock.line(phase))


def integrity_rank(rank, world):
    """One rank of integrity_three_ranks: a depth-2 encoder at BERT-Large
    widths, O1 bf16, arena FusedLAMB replicated, this rank's rows of the
    seeded batch, gradients averaged by ``sync_gradients``; every step
    fingerprints the params and compares (``integrity_check``), and the
    guard (``replica_ok``) vetoes a divergent step; after step
    INTEGRITY_FLIP - 1 chaos flips a mantissa bit of rank 2's params; the
    policy votes, repairs and re-verifies."""
    import torch
    from apex_tpu_torch import guard, parallel, train

    mesh = parallel.data_parallel_mesh(DEVICE)
    n = ZERO_RANK_BATCH
    step, state, (toks, labels), _, _ = train.build_bert_step(
        n * world, 512, encoder=depth2_encoder(), strategy="arena")
    toks, labels = toks[rank * n:(rank + 1) * n], labels[rank * n:
                                                         (rank + 1) * n]
    amp_opt, loss_fn = step.amp_opt, step.make_loss(toks, labels)
    icfg, gcfg = guard.IntegrityConfig(), guard.GuardConfig(**GUARD_CFG)
    ist = guard.integrity_init(icfg, world=world, device=DEVICE)
    gs = guard.guard_init(gcfg, device=DEVICE)
    harness = guard.ChaosHarness(guard.FaultPlan([guard.Fault(
        INTEGRITY_FLIP - 1, "params", "bitflip_mantissa", rank=2,
        arg=3)]), rank=rank)
    pol = guard.GuardPolicy()
    out = {"divergent": [], "committed": [], "losses": []}
    with parallel.use_mesh(mesh):
        for i in range(INTEGRITY_STEPS):
            ist = guard.integrity_check(ist, icfg, state.params)
            loss, grads, after, _ = amp_opt.backward(state, loss_fn)
            grads = parallel.sync_gradients(grads)
            gs = guard.guard_observe(
                gs, gcfg, loss=loss, grad_norm=torch.linalg.vector_norm(
                    torch.stack(torch._foreach_norm(list(grads.values())))),
                params=state.params, replica_ok=guard.integrity_ok(ist))
            committed = guard.guard_ok(gs, gcfg)
            state = amp_opt.apply_gradients(after, grads, committed)
            out["divergent"].append(bool(ist.divergent))
            out["committed"].append(bool(committed))
            out["losses"].append(loss.item())
            act = pol.update_integrity(i, ist)
            if act.kind == "repair":
                out["minority"] = list(pol.last_vote.minority)
                params, ok = pol.repair(i, state.params,
                                        repair_fn=guard.make_repair_fn(),
                                        verify_fn=guard.make_verify_fn())
                state = state._replace(params=params)
                ist = guard.absorb_verify(ist, *pol.last_verify)
                out["verified"] = ok
            state = harness.post_step(i, state)
        fp = guard.fingerprint_tree(state.params)
        everyone = parallel.collectives.all_gather(fp.reshape(1), None,
                                                   "check", tiled=True)
    out["fps"] = everyone.cpu().tolist()
    out["mismatch_count"] = int(ist.mismatch_count)
    return out


def integrity_body(rank, world, tmp):
    _run_rank(integrity_rank, rank, world, tmp)


def integrity_three_ranks():
    """Phase integrity_three_ranks: three gloo processes on the card (a
    vote needs three replicas to name a minority). Gates: every rank flags
    the divergence at step INTEGRITY_FLIP and no other; that step is
    skipped on every rank; the vote names rank 2; the repair's re-verify
    passes; every rank's params end bit-equal to the others' (their
    fingerprints, gathered on every rank)."""
    ranks = _spawn("integrity_three_ranks", integrity_body, 3)
    want_div = [i == INTEGRITY_FLIP for i in range(INTEGRITY_STEPS)]
    for r, out in enumerate(ranks):
        if (out["divergent"] != want_div
                or out["committed"] != [not d for d in want_div]
                or out.get("minority") != [2] or not out.get("verified")
                or len(set(out["fps"])) != 1 or out["mismatch_count"] != 1
                or out["fps"] != ranks[0]["fps"]
                or not all(math.isfinite(v) for v in out["losses"])):
            raise AssertionError(f"integrity_three_ranks rank {r}: {out}")
    log(f"phase integrity_three_ranks: every rank flagged step "
        f"{INTEGRITY_FLIP} and skipped it, the vote named rank 2, the repair "
        f"re-verified; all 3 ranks end on fingerprint "
        f"{ranks[0]['fps'][0]:#010x}; rank 0's losses {ranks[0]['losses']}")


_CRASH_CHILD = r"""
import os, sys, torch
sys.path.insert(0, os.getcwd())
import chip_smoke as C
from apex_tpu_torch import ckpt, train
root, mode = sys.argv[1], sys.argv[2]
step, state, (toks, labels), _, _ = train.build_bert_step(
    4, 512, encoder=C.depth2_encoder(), strategy="arena")
mgr = ckpt.CheckpointManager(root, keep=3)
for i in range(1, 3):
    state, loss = step(state, toks, labels)
    if mode == "escalate":
        mgr.snapshot(i, {"amp": state}, extra={"loss": loss.item()})
    else:
        if i == 2:
            os.environ[ckpt.format._CRASH_ENV] = mode
        mgr.save(i, {"amp": state}, extra={"loss": loss.item()}, block=True)
mgr.wait()
ckpt.EscalationPolicy(mgr).trip("stall")
"""


def ckpt_crash_and_escalate():
    """Phase ckpt_crash_and_escalate: the depth-2 encoder at BERT-Large
    widths (B4, O1 bf16, arena LAMB) in three processes on the card at
    once. Two save step 1, then are SIGKILLed inside step 2's save (before
    the data rename; before the manifest): step 1 stays the latest
    checkpoint and loads. The third keeps host snapshots and trips
    ``EscalationPolicy`` (exit mode): it exits 75 with a committed
    checkpoint of its last snapshot, which resumes to the uninterrupted
    run's next loss bit for bit (this process runs that run)."""
    import signal
    import tempfile
    from apex_tpu_torch import ckpt, train

    phase = "ckpt_crash_and_escalate"
    roots = {m: tempfile.mkdtemp(prefix=f"chip_smoke_crash_{m}_")
             for m in ("before_data_rename", "before_manifest", "escalate")}
    t0 = time.perf_counter()
    try:
        procs = {m: subprocess.Popen([sys.executable, "-c", _CRASH_CHILD, r,
                                      m], stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
                 for m, r in roots.items()}
        step, state, (toks, labels), _, _ = train.build_bert_step(
            4, 512, encoder=depth2_encoder(), strategy="arena")
        losses = []
        for _ in range(3):
            state, loss = step(state, toks, labels)
            losses.append(loss.item())
        codes = {}
        for m, p in procs.items():
            try:
                _, err = p.communicate(timeout=300)
            finally:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            codes[m] = p.returncode
            if codes[m] not in (-signal.SIGKILL, ckpt.ESCALATION_EXIT_CODE):
                raise AssertionError(f"{phase} {m}: exit {codes[m]}\n"
                                     f"{err[-3000:]}")
        want = {"before_data_rename": -signal.SIGKILL,
                "before_manifest": -signal.SIGKILL,
                "escalate": ckpt.ESCALATION_EXIT_CODE}
        if codes != want:
            raise AssertionError(f"{phase}: exit codes {codes}")
        for m in ("before_data_rename", "before_manifest"):
            mgr = ckpt.CheckpointManager(roots[m])
            if mgr.all_steps() != [1] or not os.path.isdir(
                    ckpt.step_dir(roots[m], 2)):
                raise AssertionError(f"{phase} {m}: committed "
                                     f"{mgr.all_steps()}")
            fresh = train.build_bert_step(
                4, 512, encoder=depth2_encoder(), strategy="arena")[1]
            tree, manifest = mgr.restore({"amp": fresh})
            if manifest["extra"]["loss"] != losses[0] or int(
                    tree["amp"].step) != 1:
                raise AssertionError(f"{phase} {m}: step 1 did not load")
        mgr = ckpt.CheckpointManager(roots["escalate"])
        fresh = train.build_bert_step(
            4, 512, encoder=depth2_encoder(), strategy="arena")[1]
        tree, manifest = mgr.restore({"amp": fresh})
        resumed, loss = step(tree["amp"], toks, labels)
        if (manifest["step"] != 2 or manifest["meta"]["reason"] != "stall"
                or manifest["extra"]["loss"] != losses[1]
                or loss.item() != losses[2]
                or _leaves_equal(resumed, state)):
            raise AssertionError(f"{phase}: escalation checkpoint step "
                                 f"{manifest['step']}, resumed loss "
                                 f"{loss.item()} vs {losses[2]}")
    finally:
        for r in roots.values():
            shutil.rmtree(r, ignore_errors=True)
    log(f"phase {phase}: SIGKILL before the data rename and before the "
        f"manifest left step 1 the latest checkpoint, loadable; the "
        f"escalation exited {ckpt.ESCALATION_EXIT_CODE} with step 2 "
        f"committed from the host snapshot, which resumed to loss "
        f"{losses[2]:.6f} bit for bit; {time.perf_counter() - t0:.1f} s")


# --- data, cluster, elastic_run and the ImageNet example ----------------------

#: the JPEG ImageFolder tree the data phases share: 512 images at 256^2
#: (8 classes) written by the port's encoder, and its packed cache
DATA_CLASSES, DATA_PER_CLASS, DATA_SIZE = 8, 64, 256
DATA_SAMPLE = 32              # images encoded again / stage-timed
IMAGENET_BATCH, IMAGENET_SIZE, IMAGENET_STEPS = 256, 224, 10
#: steps the prefetcher (depth 2, one more in staging) can have ready when
#: the first step's warm-up ends: the steady state starts after them
IMAGENET_FILL = 4
SYNCBN_STEPS = 3
SYNCBN_EXAMPLE = {"sync_batchnorm": 106}
CURSOR_STEPS, CURSOR_AT, CURSOR_SKIP = 4, 2, 3
#: the coordinated rewind: ResNet-18 B32 128^2, chaos NaNs rank 1's params
#: after REWIND_POISON; the oracle skips the poison window by the cursor
REWIND_BATCH, REWIND_SIZE, REWIND_STEPS, REWIND_POISON = 32, 128, 14, 7
REWIND_GUARD = dict(window=16, min_history=4, z_threshold=1e4,
                    grad_factor=1e6)
#: the zombie: two gloo ranks (depth-2 ResNet, DistributedFusedAdam), saves
#: at ZOMBIE_SAVES, rank 1 SIGSTOPs after ZOMBIE_STOP, rank 0 trips after
#: ZOMBIE_DEADLINE_S without its beat; world 1 resumes for ZOMBIE_RESUMED
ZOMBIE_BATCH, ZOMBIE_SIZE, ZOMBIE_STOP, ZOMBIE_SAVES = 16, 64, 4, (1, 3)
ZOMBIE_DEADLINE_S, ZOMBIE_TTL_S, ZOMBIE_RESUMED = 4.0, 2.0, 3
_DATA = {}


def _data_tree_code():
    return ("import sys, time\n"
            "sys.path.insert(0, sys.argv[2])\n"
            "from apex_tpu_torch.data import make_fake_imagefolder\n"
            "t = time.perf_counter()\n"
            f"make_fake_imagefolder(sys.argv[1], n_classes={DATA_CLASSES}, "
            f"per_class={DATA_PER_CLASS}, size={DATA_SIZE}, seed=0)\n"
            "print(time.perf_counter() - t)\n")


def start_data_tree():
    """Write the shared JPEG tree in a background process while the
    kernels build and the earlier phases run (the encoder is host numpy);
    ``jpeg_codec`` waits for it."""
    import atexit
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    tree = os.path.join(root, "tree")
    proc = subprocess.Popen(
        [sys.executable, "-c", _data_tree_code(), tree, os.getcwd()],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _DATA.update(root=root, tree=tree, cache=os.path.join(root, "cache"),
                 proc=proc)

    def cleanup():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    atexit.register(cleanup)


def _host_cpu():
    """The host CPU's model and thread count: ``/proc/cpuinfo``'s model
    name where it has one, else ``lscpu``'s."""
    try:
        with open("/proc/cpuinfo") as f:
            names = [line.split(":", 1)[1].strip() for line in f
                     if line.startswith("model name")]
        if names and names[0].lower() not in ("", "unknown"):
            return f"{names[0]}, {len(names)} threads"
    except OSError:
        pass
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=10).stdout
        info = dict(line.split(":", 1) for line in out.splitlines()
                    if ":" in line)
        return (f"{info.get('Model name', '?').strip()}, "
                f"{info.get('CPU(s)', '?').strip()} threads")
    except (OSError, subprocess.SubprocessError):
        return f"unknown model, {os.cpu_count()} threads"


def _float_idct(c):
    """A float64 IDCT of a component's dequantised coefficients."""
    import numpy as np
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    rows, cols = c.coefs.shape[:2]
    deq = (c.coefs.astype(np.float64) * c.qtable).reshape(rows, cols, 8, 8)
    ref = np.einsum("ui,abuv,vj->abij", m, deq, m) + 128
    return np.clip(np.round(ref), 0, 255).transpose(0, 2, 1, 3).reshape(
        rows * 8, cols * 8)


def jpeg_codec():
    """Phase jpeg_codec: the port's codec on the shared tree (written by
    its encoder: 512 images, 256^2, 8 classes, quality 85, 4:2:0). Gates:
    the files are the encoder's bytes; decoding gives back the encoder's
    quantised coefficients bit for bit; the IDCT stage is within ±1 of a
    float64 IDCT of the same coefficients (IEEE 1180's peak error); if PIL
    imports here, the pixels equal PIL's bit for bit. Reports encode and
    decode ms an image (decode by stage), decode img/s at 1 thread and at
    the default thread count, and ``measure_source`` img/s for live decode
    and for the packed cache at B256 224: host numbers, beside the host
    CPU."""
    import concurrent.futures
    import numpy as np
    from apex_tpu_torch.data import (ImageFolderSource, PackedSource,
                                     build_cache, jpeg, measure_source)
    from apex_tpu_torch.data.pipeline import (_list_imagefolder,
                                              _random_resized_crop)

    phase = "jpeg_codec"
    proc = _DATA["proc"]
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{phase}: writing the tree failed:\n{err}")
    tree_s = float(out.strip().splitlines()[-1])
    paths, labels, classes = _list_imagefolder(_DATA["tree"])
    if len(paths) != DATA_CLASSES * DATA_PER_CLASS or \
            len(classes) != DATA_CLASSES:
        raise AssertionError(f"{phase}: {len(paths)} files, {classes}")
    rng = np.random.RandomState(0)          # make_fake_imagefolder's draws
    enc_s, idct_err = 0.0, 0
    for i in range(DATA_SAMPLE):
        arr = rng.randint(0, 256, (DATA_SIZE, DATA_SIZE, 3), np.uint8)
        t = time.perf_counter()
        data, coefs = jpeg.encode(arr, quality=85, return_coefficients=True)
        enc_s += time.perf_counter() - t
        with open(paths[i], "rb") as f:
            if f.read() != data:
                raise AssertionError(f"{phase}: {paths[i]} is not the "
                                     f"encoder's output")
        frame = jpeg.read_coefficients(data, paths[i])
        for c, want in zip(frame.components, coefs):
            if not np.array_equal(c.coefs, want):
                raise AssertionError(f"{phase}: {paths[i]}: decoded "
                                     f"coefficients differ")
            idct_err = max(idct_err, int(np.abs(
                jpeg.idct(c).astype(np.int64) - _float_idct(c)).max()))
    if idct_err > 1:
        raise AssertionError(f"{phase}: IDCT off the float64 IDCT by "
                             f"{idct_err}")
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        import io
        for p, b in zip(paths, blobs):
            want = np.asarray(Image.open(io.BytesIO(b)).convert("RGB"))
            if not np.array_equal(jpeg.decode(b, p), want):
                raise AssertionError(f"{phase}: {p} differs from PIL")
        pil = f"PIL {Image.__version__} imports here: all " \
              f"{len(paths)} files decode to PIL's pixels bit for bit"
    else:
        pil = "PIL does not import here (no pixel check against it)"
    parts = dict(entropy=0.0, idct=0.0, upsample_colour=0.0, resize=0.0)
    for i, b in enumerate(blobs[:DATA_SAMPLE]):
        t0 = time.perf_counter()
        frame = jpeg.read_coefficients(b)
        t1 = time.perf_counter()
        planes = [jpeg.idct(c) for c in frame.components]
        t2 = time.perf_counter()
        rgb = jpeg.to_rgb(frame, planes)
        t3 = time.perf_counter()
        _random_resized_crop(rgb, IMAGENET_SIZE, np.random.RandomState(i))
        t4 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[k] += dt * 1e3 / DATA_SAMPLE

    def decode_all(workers):
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            t = time.perf_counter()
            list(pool.map(jpeg.decode, blobs))
            return len(blobs) / (time.perf_counter() - t)
    default = ImageFolderSource(_DATA["tree"], IMAGENET_BATCH,
                                IMAGENET_SIZE)
    decode_1, decode_n = decode_all(1), decode_all(default.workers)
    with default as src:
        live = measure_source(src.batches(5), steps=4)
    t = time.perf_counter()
    build_cache(_DATA["tree"], _DATA["cache"], store_size=DATA_SIZE)
    cache_s = time.perf_counter() - t
    with PackedSource(_DATA["cache"], IMAGENET_BATCH, IMAGENET_SIZE,
                      dtype=np.uint8) as src:
        cached = measure_source(src.batches(9), steps=8)
        cache_workers = src.workers
    host = _host_cpu()
    log(f"phase jpeg_codec: {len(paths)} files written in {tree_s:.1f} s in "
        f"the background; encoder bytes and coefficients bit for bit on "
        f"{DATA_SAMPLE}, IDCT within {idct_err} of a float64 IDCT; {pil}")
    log("phase jpeg_codec: " + json.dumps({
        "host_cpu": host, "encode_ms": round(enc_s * 1e3 / DATA_SAMPLE, 3),
        "decode_ms_by_stage": {k: round(v, 4) for k, v in parts.items()},
        "decode_ms": round(sum(list(parts.values())[:3]), 4),
        "decode_img_s_1_thread": round(decode_1, 1),
        f"decode_img_s_{default.workers}_threads": round(decode_n, 1),
        "loader_live_img_s_b256_224": round(live, 1),
        "cache_build_s": round(cache_s, 2),
        f"loader_cache_img_s_b256_224_{cache_workers}_threads":
            round(cached, 1)}))


def _imagenet_script():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_imagenet_main_amp",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                     "torch_imagenet_main_amp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _checksum(t):
    """A position-weighted sum of a tensor's bytes, on its device (int64)."""
    import torch
    b = t.contiguous().view(-1).view(torch.uint8).to(torch.int64)
    w = torch.arange(b.numel(), device=b.device, dtype=torch.int64) \
        % 65521 + 1
    return (b * w).sum()


def _hashing_prefetcher(base, seen):
    """A ``DevicePrefetcher`` that records each batch's checksums on the
    host before staging (of the bytes it will copy: the cast ones) and on
    the device after the consumer's stream waited (no host sync)."""
    import numpy as np
    import torch

    class Hashing(base):
        def __init__(self, it, device="cuda", cast_dtype=None, depth=2):
            def tap(it):
                for batch in it:
                    host = []
                    for j, a in enumerate(batch):
                        t = torch.from_numpy(np.ascontiguousarray(a))
                        if j == 0 and cast_dtype is not None:
                            t = t.to(cast_dtype)
                        host.append(int(_checksum(t)))
                    seen["host"].append(host)
                    yield batch
            super().__init__(tap(it), device, cast_dtype, depth)

        def __iter__(self):
            for tensors in super().__iter__():
                seen["device"].append([_checksum(t) for t in tensors])
                yield tensors
    return Hashing


def _run_example(mod, phase, argv, per_step, steps, hashed=False):
    """One ``run`` of the ImageNet script with the launches counted
    (``per_step``: checked; None: not), the peak memory read and, with
    ``hashed``, the prefetcher's batches checksummed (which costs the
    producer host time, so timed runs go without it)."""
    import math
    import torch
    from apex_tpu_torch import ops

    seen = {"host": [], "device": []}
    base = mod.DevicePrefetcher
    if hashed:
        mod.DevicePrefetcher = _hashing_prefetcher(base, seen)
    printed = []
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        result = mod.run(argv, emit=printed.append)
        counts = ops.launch_counts()
    finally:
        mod.DevicePrefetcher = base
    if per_step is not None:
        check_launches(phase, counts, per_step, None, steps=steps)
    device = [[int(h) for h in hs] for hs in seen["device"]]
    if hashed and (len(device) != steps or device != seen["host"]):
        raise AssertionError(f"{phase}: the prefetcher's batches differ "
                             f"from the host's (or their order): host "
                             f"{seen['host']}, device {device}")
    if not all(math.isfinite(v) for v in result["losses"]):
        raise AssertionError(f"{phase}: losses {result['losses']}")
    times = sorted(result["step_times"][min(IMAGENET_FILL,
                                               len(result["step_times"]) - 1):])
    step_ms = times[len(times) // 2] * 1e3
    return dict(result, printed=printed, step_ms=step_ms,
                peak=torch.cuda.max_memory_allocated() / 2**30,
                launches={k: v // steps for k, v in counts.items() if v})


def imagenet_example_resnet50():
    """Phase imagenet_example_resnet50: ``scripts/torch_imagenet_main_amp.py``
    at ``--arch resnet50 -b 256 --image-size 224 --opt-level O2`` from the
    packed cache (uint8, normalised on the card), from live decode and from
    synthetic data (the JAX example's host ``rand``, an input of its own),
    and the cache run again with ``--deterministic`` (what deterministic cuDNN
    costs the step). Each reports step ms (median of the steady steps:
    after the IMAGENET_FILL the prefetcher may have had ready when the
    first step's warm-up ended), img/s, the loader's printed img/s, the
    example's own last img/s (from its start), peak GiB and hand-kernel
    launches a step.
    Gates: the ResNet launches each step; finite losses; in a further
    3-step live-decode run the prefetcher hands over every batch in order
    and bit for bit (checksums on the host before staging and on the
    device after); the uint8 normalise on the card equals its CPU value for
    all 256 values in bf16, fp16 and f32."""
    import torch
    from apex_tpu_torch.data import normalize_uint8

    phase = "imagenet_example_resnet50"
    mod = _imagenet_script()
    base = ["--arch", "resnet50", "-b", str(IMAGENET_BATCH), "--image-size",
            str(IMAGENET_SIZE), "--opt-level", "O2", "--device", DEVICE,
            "--steps-per-epoch", str(IMAGENET_STEPS), "--print-freq", "1"]
    cache = ["--data", _DATA["tree"], "--cache", _DATA["cache"]]
    modes = {"cache": cache, "cache_deterministic": cache + [
        "--deterministic"], "live": ["--data", _DATA["tree"]],
        "synthetic": []}
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    out = {}
    for mode, extra in modes.items():
        try:
            r = _run_example(mod, f"{phase} ({mode})", base + extra,
                             RESNET_PER_STEP, IMAGENET_STEPS)
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = flags
        out[mode] = r
        log(f"phase {phase} ({mode}): " + json.dumps({
            "step_ms": round(r["step_ms"], 3),
            "img_s": round(IMAGENET_BATCH / r["step_ms"] * 1e3, 1),
            "loader_img_s": None if r["loader"] is None
            else round(r["loader"], 1),
            "example_img_s": r["printed"][-2].split("  ")[-1],
            "peak_gib": round(r["peak"], 3),
            "launches_per_step": r["launches"],
            "losses": [round(v, 6) for v in r["losses"]]}))
    # the prefetcher's hand-over, bit for bit and in order: live decode,
    # the bf16 cast staged on the host (the uint8 path: imagenet_example_
    # syncbn)
    _run_example(mod, f"{phase} (prefetcher check)", base[:-4] + [
        "--steps-per-epoch", "3", "--print-freq", "1", "--data",
        _DATA["tree"]], RESNET_PER_STEP, 3, hashed=True)
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        x = torch.arange(256, dtype=torch.int64).to(torch.uint8)
        cpu = normalize_uint8(x, dt)
        card = normalize_uint8(x.to(DEVICE), dt).cpu()
        if not torch.equal(cpu.view(-1).view(torch.uint8),
                           card.view(-1).view(torch.uint8)):
            raise AssertionError(f"{phase}: uint8 normalise in {dt} differs "
                                 f"between the card and the CPU")
    det = out["cache_deterministic"]["step_ms"]
    syn = out["cache"]["step_ms"]
    log(f"phase {phase}: the prefetcher handed over 3 live-decode batches "
        f"(bf16 cast on the host) in order and bit for bit; uint8 "
        f"normalise equal on the card and the CPU for "
        f"all 256 values (bf16, fp16, f32); deterministic cuDNN costs "
        f"{det - syn:.3f} ms a step ({syn:.3f} -> {det:.3f} ms)")


#: the image-format fixtures (``scripts/torch_make_image_fixtures.py``:
#: files of every format the JAX loader reads, PIL's pixels beside them)
FORMATS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "data", "torch_image_formats")
FORMATS_IMAGES, FORMATS_CLASSES, FORMATS_STEPS = 512, 8, 6
FORMATS_TIMING_S = 0.5          # decode timing a format, one thread


def imagenet_example_formats():
    """Phase imagenet_example_formats: every fixture of
    ``tests/data/torch_image_formats/`` decodes through
    ``data.image.read_rgb`` equal to PIL's pixels (its ``.npy``) bit for
    bit, and every file PIL refuses (or block-smooths) raises OSError;
    decode img/s and MPix/s by format (one thread, beside the host CPU);
    then the ImageNet example (ResNet-50 B256 224^2, O2 bf16, FusedSGD)
    trains FORMATS_STEPS steps by live decode from a FORMATS_IMAGES-image
    tree that copies the readable fixtures round-robin under
    FORMATS_CLASSES class folders: 53 + 53 BN and 1 + 1 CE launches a
    step, finite losses, step ms."""
    import tempfile

    import numpy as np
    from apex_tpu_torch.data import image

    phase = "imagenet_example_formats"
    with open(os.path.join(FORMATS_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    readable = sorted(n for n, v in manifest.items() if v["port"] == "ok")
    for name, v in sorted(manifest.items()):
        path = os.path.join(FORMATS_DIR, name)
        if v["port"] == "ok":
            got = image.read_rgb(path)
            want = np.load(path + ".npy")
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"{phase}: {name} ({v['what']}) "
                                     f"differs from PIL's pixels")
            continue
        try:
            image.read_rgb(path)
        except OSError:
            continue
        raise AssertionError(f"{phase}: {name} ({v['what']}) decoded; the "
                             f"port must raise OSError")
    log(f"phase {phase}: {len(readable)} files equal PIL's pixels bit for "
        f"bit, {len(manifest) - len(readable)} refused with OSError "
        f"({', '.join(n for n in sorted(manifest) if n not in readable)})")
    rates = {}
    for fmt in ("jpeg", "png", "bmp"):
        files = [os.path.join(FORMATS_DIR, n) for n in readable
                 if manifest[n]["format"] == fmt]
        n_img = n_pix = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < FORMATS_TIMING_S:
            for path in files:
                n_pix += image.read_rgb(path)[..., 0].size
                n_img += 1
        dt = time.perf_counter() - t0
        rates[fmt] = {"files": len(files), "img_s": round(n_img / dt, 1),
                      "mpix_s": round(n_pix / dt / 1e6, 2)}
    log(f"phase {phase}: decode by format, one thread on {_host_cpu()}: "
        + json.dumps(rates))

    root = tempfile.mkdtemp(prefix="chip_smoke_formats_")
    try:
        for i in range(FORMATS_IMAGES):
            name = readable[i % len(readable)]
            cls = os.path.join(root, f"class{i % FORMATS_CLASSES}")
            os.makedirs(cls, exist_ok=True)
            shutil.copy(os.path.join(FORMATS_DIR, name),
                        os.path.join(cls, f"{i:04d}_{name}"))
        argv = ["--arch", "resnet50", "-b", str(IMAGENET_BATCH),
                "--image-size", str(IMAGENET_SIZE), "--opt-level", "O2",
                "--device", DEVICE, "--steps-per-epoch", str(FORMATS_STEPS),
                "--print-freq", "1", "--data", root]
        r = _run_example(_imagenet_script(), phase, argv, RESNET_PER_STEP,
                         FORMATS_STEPS)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase {phase}: " + json.dumps({
        "images": FORMATS_IMAGES, "step_ms": round(r["step_ms"], 3),
        "img_s": round(IMAGENET_BATCH / r["step_ms"] * 1e3, 1),
        "loader_img_s": None if r["loader"] is None
        else round(r["loader"], 1),
        "peak_gib": round(r["peak"], 3),
        "launches_per_step": r["launches"],
        "losses": [round(v, 6) for v in r["losses"]]}))


def imagenet_example_syncbn():
    """Phase imagenet_example_syncbn: the script with ``--sync_bn
    --opt-level O1`` from the packed cache at NCCL world 1 (the process
    group ``dist_init`` started) for SYNCBN_STEPS steps: 106
    ``sync_batchnorm`` collectives a step, finite losses, and the
    prefetcher's uint8 batches handed over in order and bit for bit."""
    import math
    from apex_tpu_torch import parallel

    phase = "imagenet_example_syncbn"
    mod = _imagenet_script()
    parallel.reset_collective_counts()
    r = _run_example(mod, phase, [
        "--arch", "resnet50", "-b", str(IMAGENET_BATCH), "--image-size",
        str(IMAGENET_SIZE), "--opt-level", "O1", "--sync_bn", "--device",
        DEVICE, "--steps-per-epoch", str(SYNCBN_STEPS), "--print-freq", "1",
        "--data", _DATA["tree"], "--cache", _DATA["cache"]], None,
        SYNCBN_STEPS, hashed=True)
    issued = dict(parallel.collective_counts)
    for k, v in SYNCBN_EXAMPLE.items():
        if issued.get(k) != SYNCBN_STEPS * v:
            raise AssertionError(f"{phase}: collectives in {SYNCBN_STEPS} "
                                 f"steps {issued}")
    if not all(math.isfinite(v) for v in r["losses"]):
        raise AssertionError(f"{phase}: losses {r['losses']}")
    times = sorted(r["step_times"][1:])
    log(f"phase {phase}: uint8 batches bit for bit; collectives a step "
        f"{ {k: v // SYNCBN_STEPS for k, v in issued.items()} }, losses "
        f"{[round(v, 6) for v in r['losses']]}, median step "
        f"{times[len(times) // 2] * 1e3:.3f} ms")


def _deterministic():
    """cuDNN deterministic, no benchmark (restored on exit)."""
    import torch

    @contextlib.contextmanager
    def scope():
        flags = (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            yield
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = flags
    return scope()


def _folder_batches(src):
    """Host batches of a cursor-bearing source, re-entering epochs."""
    while True:
        yield from src.epoch()


def _to_card(xb, yb):
    import torch
    return (torch.from_numpy(xb).to(torch.bfloat16).to(DEVICE),
            torch.from_numpy(yb).to(torch.int64).to(DEVICE))


def data_cursor_resume():
    """Phase data_cursor_resume: the ResNet-50 step (B256, 224^2, O2 bf16,
    FusedSGD) from ``ImageFolderSource`` on the shared tree. Run A: 4
    steps. Run B: 2 steps, an async ``CheckpointManager.save(...,
    extra={"cursor": src.state()})`` at step 2 while steps 3-4 run, then a
    restore into a fresh state and a fresh source (``load_state`` of the
    saved cursor) and steps 3-4 again. Gates: the losses and every leaf of
    the resumed run equal run A's bit for bit; ``skip_batches(k)`` then
    iteration equals the stream of a run that read those k batches, and
    decodes no image for them. cuDNN deterministic."""
    import tempfile
    import numpy as np
    from apex_tpu_torch import ckpt, train
    from apex_tpu_torch.data import ImageFolderSource

    phase = "data_cursor_resume"
    clock = _Clock()

    def build():
        step, (state, bs), _, _, _ = train.build_resnet_step(
            IMAGENET_BATCH, IMAGENET_SIZE, device=DEVICE)
        return step, state, bs, ImageFolderSource(
            _DATA["tree"], IMAGENET_BATCH, IMAGENET_SIZE, seed=1)

    def run(step, state, bs, it, n):
        losses = []
        with clock("steps"):
            for _ in range(n):
                state, bs, loss = step(state, bs, *_to_card(*next(it)))
                losses.append(loss.item())
        return state, bs, losses

    root = tempfile.mkdtemp(prefix="chip_smoke_cursor_")
    try:
        with _deterministic():
            with clock("build"):
                step, sa, ba, src = build()
            sa, ba, la = run(step, sa, ba, _folder_batches(src),
                             CURSOR_STEPS)
            want = {"amp": sa, "bstats": ba}
            src.close()
            with clock("build"):
                step, sb, bb, src = build()
            it = _folder_batches(src)
            sb, bb, lb = run(step, sb, bb, it, CURSOR_AT)
            mgr = ckpt.CheckpointManager(root, keep=1)
            with clock("save"):
                mgr.save(CURSOR_AT, {"amp": sb, "bstats": bb},
                         extra={"cursor": src.state()})
            sb, bb, rest = run(step, sb, bb, it, CURSOR_STEPS - CURSOR_AT)
            mgr.wait()
            lb += rest
            src.close()
            del sb, bb, step
            with clock("build"):
                step, sc, bc, src = build()
            with clock("restore"):
                tree, manifest = mgr.restore({"amp": sc, "bstats": bc})
                src.load_state(manifest["extra"]["cursor"])
            sc, bc, lc = run(step, tree["amp"], tree["bstats"],
                             _folder_batches(src), CURSOR_STEPS - CURSOR_AT)
            src.close()
            got = {"amp": sc, "bstats": bc}
        if lb != la or lc != la[CURSOR_AT:]:
            raise AssertionError(f"{phase}: losses {la}, with the save "
                                 f"{lb}, resumed {lc}")
        bad = _leaves_equal(got, want)
        if bad:
            raise AssertionError(f"{phase}: resumed state differs at "
                                 f"{bad[:5]}")
        with clock("skip"):
            read = ImageFolderSource(_DATA["tree"], IMAGENET_BATCH,
                                     IMAGENET_SIZE, seed=1)
            it = _folder_batches(read)
            for _ in range(CURSOR_SKIP):
                next(it)
            want_x, want_y = next(it)
            skip = ImageFolderSource(_DATA["tree"], IMAGENET_BATCH,
                                     IMAGENET_SIZE, seed=1)
            skip.skip_batches(CURSOR_SKIP)
            decoded = skip.n_decoded
            x, y = next(_folder_batches(skip))
            read.close()
            skip.close()
        if decoded != 0 or not (np.array_equal(x, want_x)
                                and np.array_equal(y, want_y)):
            raise AssertionError(f"{phase}: skip_batches({CURSOR_SKIP}) "
                                 f"decoded {decoded} images or gave another "
                                 f"batch")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase {phase}: losses {[round(v, 6) for v in la]} bit for bit "
        f"with the async save at step {CURSOR_AT} (cursor "
        f"{manifest['extra']['cursor']}) and after the restore; every leaf "
        f"equal; skip_batches({CURSOR_SKIP}) decoded 0 images and gave the "
        f"read run's next batch bit for bit")
    log(clock.line(phase))


def _run_solo(body, rank, world, tmp):
    """``body(rank, world)`` in a spawned process; its result saved to
    ``tmp/rank{r}.pt`` for ``_spawn``, its traceback to ``.err``."""
    import traceback
    import torch
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.save(body(rank, world), f"{tmp}/rank{rank}.pt")
    except BaseException:
        with open(f"{tmp}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def _wait_file(path, deadline_s=None):
    """Wait for ``path`` to exist; False after ``deadline_s``."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if deadline_s is not None and time.monotonic() - t0 > deadline_s:
            return False
        time.sleep(0.02)
    return True


def rewind_rank(rank, world):
    """One process of cluster_coordinated_rewind: processes 0-1 are the
    faulted pair, 2-3 the oracle pair. Each trains its own ResNet-18 (O2
    bf16, FusedSGD, ``Amp.step(guard=)``) on its file shard of the tree
    (B32, 128^2), saves every 2 steps with the cursor, and meets its peer
    only through the pair's cluster directory and beat files. The faulted
    pair's rank 1 gets NaN params after REWIND_POISON; its guard asks for a
    rewind, both resolve one round. The oracle pair never sees the poison
    and skips the window through the cursor."""
    import numpy as np
    import torch
    from torch.func import functional_call
    from apex_tpu_torch import ckpt, cluster, guard, models, ops, train
    from apex_tpu_torch.data import ImageFolderSource
    from apex_tpu_torch.utils import tree_select

    pair, r = divmod(rank, 2)
    faulted = pair == 0
    work = os.path.join(os.environ["CHIP_SMOKE_REWIND_DIR"], f"pair{pair}")
    barrier = os.path.join(work, "barrier")
    os.makedirs(barrier, exist_ok=True)
    n_steps = REWIND_STEPS if faulted else REWIND_STEPS - 2
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model = models.ResNet18(num_classes=1000, dtype=torch.bfloat16,
                            device=DEVICE, seed=0)
    step, (state, bs), _, _, _ = train.build_resnet_step(
        REWIND_BATCH, REWIND_SIZE, model=model, device=DEVICE)
    amp_opt = step.amp_opt
    gcfg = guard.GuardConfig(**REWIND_GUARD)
    gs = guard.guard_init(gcfg, device=DEVICE)
    events = []
    member = cluster.ClusterMembership(os.path.join(work, "cluster"),
                                       rank=r, ttl_s=60.0,
                                       event_sink=events.append)
    member.join()
    coord = cluster.RecoveryCoordinator(member, barrier_timeout_s=120.0)
    mgr = ckpt.CheckpointManager(os.path.join(work, f"ck_r{r}"),
                                 fence=member, rank=0, process_count=1,
                                 keep=3)
    policy = guard.GuardPolicy(manager=mgr, rewind_budget=2)
    src = ImageFolderSource(os.environ["CHIP_SMOKE_DATA_TREE"],
                            REWIND_BATCH, REWIND_SIZE, seed=3, workers=4,
                            process_index=r, process_count=2)
    harness = None
    if faulted:
        harness = guard.ChaosHarness(guard.FaultPlan(seed=1).add(
            REWIND_POISON, "params", "nan", rank=1), rank=r)
    it_box = [None]

    def pull():
        while True:
            if it_box[0] is None:
                it_box[0] = src.epoch()
            try:
                return next(it_box[0])
            except StopIteration:
                it_box[0] = None

    def guarded(state, bs, gs, x, y):
        def loss_fn(mp):
            logits, new_bs = functional_call(model, {**mp, **bs}, (x,),
                                             {"train": True})
            return torch.mean(ops.softmax_cross_entropy_loss(
                logits, y)), new_bs
        state, (loss, new_bs), committed, gs = amp_opt.step(
            state, loss_fn, has_aux=True, guard=(gs, gcfg))
        return state, tree_select(committed, new_bs, bs), gs, loss

    losses, rewound = [], []
    for i in range(n_steps):
        if not faulted and src.cursor_index() == REWIND_POISON:
            src.skip_batches(2)
            it_box[0] = None
        state, bs, gs, loss = guarded(state, bs, gs, *_to_card(*pull()))
        losses.append(loss.item())
        if i % 2 == 0:
            mgr.save(i, {"amp": state, "bstats": bs, "gs": gs},
                     extra={"cursor": src.state()})
            mgr.wait()
        member.heartbeat()
        if harness is not None:
            state = harness.post_step(i, state)
        act = policy.update(i, gs)
        if act.kind == "escalate":
            raise AssertionError(f"rank {rank} escalated at {i}: {act}")
        need = act.kind == "rewind"
        like = {"amp": state, "bstats": bs, "gs": gs}
        if need:
            coord.propose(action="rewind", step=i,
                          good_step=policy.probe_good_step(like))
        open(os.path.join(barrier, f"beat_{r}_{i}"), "w").close()
        _wait_file(os.path.join(barrier, f"beat_{1 - r}_{i}"))
        if need or coord.peer_requested():
            dec, restored = coord.run_round(
                policy, i, like, src, expect_ranks=[0, 1],
                reason=act.reason if need else "peer request")
            tree = restored[0]
            state, bs, gs = tree["amp"], tree["bstats"], tree["gs"]
            it_box[0] = None
            rewound.append((i, dec.target_step, dec.generation,
                            dec.new_generation))
    src.close()
    return {"losses": losses, "rewound": rewound,
            "params": {k: v.cpu() for k, v in state.params.items()},
            "bstats": {k: v.cpu() for k, v in bs.items()},
            "generation": member.refresh(),
            "cursor": src.cursor_index(),
            "bumps": sum(1 for e in events
                         if e["kind"] == "cluster_generation"
                         and e["action"] == "bump")}


def rewind_body(rank, world, tmp):
    _run_solo(rewind_rank, rank, world, tmp)


def cluster_coordinated_rewind():
    """Phase cluster_coordinated_rewind: JAX's
    ``TestCoordinatedRewindAcceptance`` at ResNet-18 size on the card:
    four processes at once (the faulted pair and its fault-free oracle
    pair, ``rewind_rank``). Gates: both faulted ranks resolve to the same
    target, rank 1's last good step (REWIND_POISON - 1), at the step after
    the poison; the generation rises exactly once (one bump event, the
    directory at 1); both ranks' losses after the rewind and their final
    params and statistics equal the oracle's bit for bit, at the same
    cursor."""
    import tempfile
    import torch

    phase = "cluster_coordinated_rewind"
    work = tempfile.mkdtemp(prefix="chip_smoke_rewind_")
    os.environ["CHIP_SMOKE_REWIND_DIR"] = work
    os.environ["CHIP_SMOKE_DATA_TREE"] = _DATA["tree"]
    try:
        out = _spawn(phase, rewind_body, 4)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        os.environ.pop("CHIP_SMOKE_REWIND_DIR", None)
    target = REWIND_POISON - 1
    at = REWIND_POISON + 1
    for r in (0, 1):
        f, o = out[r], out[2 + r]
        if f["rewound"] != [(at, target, 0, 1)] or o["rewound"]:
            raise AssertionError(f"{phase} rank {r}: rounds {f['rewound']}, "
                                 f"oracle {o['rewound']}")
        if f["losses"][at + 1:] != o["losses"][at - 1:] or \
                f["cursor"] != o["cursor"]:
            raise AssertionError(f"{phase} rank {r}: losses after the "
                                 f"rewind {f['losses'][at + 1:]} vs the "
                                 f"oracle's {o['losses'][at - 1:]}")
        for k in ("params", "bstats"):
            bad = [n for n, v in f[k].items()
                   if not torch.equal(v.reshape(-1).view(torch.uint8),
                                      o[k][n].reshape(-1).view(torch.uint8))]
            if bad:
                raise AssertionError(f"{phase} rank {r}: final {k} differ "
                                     f"from the oracle's at {bad[:5]}")
    if [f["generation"] for f in out[:2]] != [1, 1] or \
            sum(f["bumps"] for f in out[:2]) != 1:
        raise AssertionError(f"{phase}: generations "
                             f"{[f['generation'] for f in out[:2]]}, bumps "
                             f"{[f['bumps'] for f in out[:2]]}")
    log(f"phase {phase}: both ranks resolved the round at step {at} to step "
        f"{target} (rank 1's last good), generation 0 -> 1 with one bump; "
        f"losses after it ({len(out[0]['losses']) - at - 1} a rank) and "
        f"final params and statistics bit for bit the oracle's; rank 0 "
        f"losses {[round(v, 5) for v in out[0]['losses']]}")


_ZOMBIE_CHILD = r"""
import os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as C
C.zombie_child(sys.argv[1:])
"""


def _zombie_batch(rank, i):
    import numpy as np
    import torch
    rng = np.random.RandomState(1000 * rank + i)
    x = rng.rand(ZOMBIE_BATCH, ZOMBIE_SIZE, ZOMBIE_SIZE, 3).astype(
        np.float32)
    y = rng.randint(0, 1000, ZOMBIE_BATCH)
    return (torch.from_numpy(x).to(torch.bfloat16).to(DEVICE),
            torch.from_numpy(y).to(DEVICE))


def zombie_child(argv):
    """A rank of cluster_zombie_elastic (``mode`` world2, world1 or
    oracle): a depth-2 ResNet (two bottleneck stages, O2 bf16) through
    ``DistributedFusedAdam`` over a gloo group on the card, checkpoints
    fenced by the cluster membership. Writes its report to ``out``."""
    import datetime
    import hashlib
    import signal
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import ckpt, cluster, models, parallel, trace, train
    from apex_tpu_torch.optim import DistributedFusedAdam

    mode, rank, world, root, cdir, barrier, store, out = argv
    rank, world = int(rank), int(world)
    torch.cuda.set_device(0)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"mode": mode, "rank": rank, "losses": [], "events": []}

    def dump():
        with open(out, "w") as f:
            json.dump(report, f)

    def sink(e):
        report["events"].append(e)
        dump()

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    mesh = parallel.data_parallel_mesh(DEVICE)
    model = models.ResNet(stage_sizes=[1, 1], num_classes=1000,
                          dtype=torch.bfloat16, device=DEVICE, seed=0)
    with parallel.use_mesh(mesh):
        step, (state, bs), _, _, _ = train.build_resnet_step(
            ZOMBIE_BATCH, ZOMBIE_SIZE, model=model, device=DEVICE,
            optimizer=DistributedFusedAdam(lr=1e-3))
    member = None
    if mode != "oracle":
        member = cluster.ClusterMembership(cdir, rank=rank,
                                           ttl_s=ZOMBIE_TTL_S,
                                           event_sink=sink)
        report["joined"] = member.join()
    mgr = ckpt.CheckpointManager(root, fence=member, rank=rank,
                                 process_count=world, keep=0,
                                 barrier_timeout_s=60)

    def train_step(i):
        nonlocal state, bs
        with parallel.use_mesh(mesh):
            state, bs, loss = step(state, bs, *_zombie_batch(rank, i))
        report["losses"].append(loss.item())
        dump()

    if mode == "world2":
        policy = ckpt.EscalationPolicy(mgr)          # exit mode, code 75
        tracer = contextlib.nullcontext()

        def fired(event):
            if event.get("reason") == "hang":
                report["tripped_at"] = event["last_step"]
                report["tripped_after_s"] = event["seconds_since_last_step"]
                dump()

        for i in range(1, ZOMBIE_STOP + 3):
            with tracer, trace.step(i), trace.span("dispatch"):
                train_step(i)
            member.heartbeat()
            if rank == 0 and i == 1:
                # from step 2 on (step 1 loads the kernels), rank 0
                # notices a stall through the hang watchdog: the step
                # after the peer stopped waits in its collective, no
                # step completes within the deadline, the watchdog dumps
                # and its on_stall (the policy) commits and exits 75
                tracer, _, wd, _ = parallel.enable_crash_dumps(
                    os.path.join(os.path.dirname(out), "zombie_crash.jsonl"),
                    hang_deadline_s=ZOMBIE_DEADLINE_S, escalation=policy)
                wd.on_fire = fired
            if rank == 1 and i == ZOMBIE_STOP:
                os.kill(os.getpid(), signal.SIGSTOP)
                # resumed: a zombie of the generation it joined
                refused = 0
                try:
                    mgr.save(99, {"amp": state, "bstats": bs},
                             params=state.params, block=True)
                    mgr.wait()
                except cluster.StaleGenerationError:
                    refused += 1
                try:
                    ckpt.gc_checkpoints(root, keep=1, fence=member)
                except cluster.StaleGenerationError:
                    refused += 1
                report["refused"] = refused
                dump()
                os._exit(88 if refused == 2 else 1)
            open(os.path.join(barrier, f"beat_{rank}_{i}"), "w").close()
            if rank == 1 and not _wait_file(
                    os.path.join(barrier, f"beat_{1 - rank}_{i}"),
                    ZOMBIE_DEADLINE_S):
                report["tripped_at"] = i
                dump()
                policy.trip(f"rank {1 - rank} silent after step {i}")
            if i in ZOMBIE_SAVES:
                mgr.save(i, {"amp": state, "bstats": bs},
                         params=state.params, block=True)
                mgr.wait()
        os._exit(1)                    # the peer never went silent
    with parallel.use_mesh(mesh):
        like = {"amp": state, "bstats": bs}
        d = ckpt.step_dir(root, ZOMBIE_SAVES[-1])
        tree, manifest = mgr.restore(like, ckpt_dir=d)
    state, bs = tree["amp"], tree["bstats"]
    report.update(restored=manifest["step"],
                  from_processes=manifest["process_count"],
                  latest=os.path.basename(ckpt.latest_checkpoint(root)))
    for i in range(ZOMBIE_SAVES[-1] + 1,
                   ZOMBIE_SAVES[-1] + 1 + ZOMBIE_RESUMED):
        train_step(i)
        if member is not None:
            member.heartbeat()
    if mode == "world1":
        mgr.save(100, {"amp": state, "bstats": bs}, params=state.params,
                 block=True)
        mgr.wait()
        report["committed"] = ckpt.read_manifest(
            ckpt.latest_checkpoint(root))["generation"]
    report["param_bytes"] = {
        k: hashlib.sha256(v.reshape(-1).view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()
        for k, v in state.params.items()}
    dump()
    dist.destroy_process_group()


def cluster_zombie_elastic():
    """Phase cluster_zombie_elastic: ``elastic_run(train_fn, world_sizes=
    [2, 1], cluster_dir=...)``. World 2: two gloo ranks on the card
    (``zombie_child``) save at steps 1 and 3 (process_count 2, ZeRO
    shards); rank 1 SIGSTOPs itself after step 4; rank 0, under
    ``enable_crash_dumps(hang_deadline_s=ZOMBIE_DEADLINE_S,
    escalation=EscalationPolicy(mgr))``, waits in step 5's collective
    until its ``HangWatchdog`` fires and the policy exits 75. ``elastic_run``
    reports the expired lease, relaunches at world 1 under generation 1:
    that run restores step 3 re-partitioned 2 -> 1 and takes 3 steps; an
    oracle run (no fence) from the same checkpoint runs beside it. Then the
    zombie is continued. Gates: rank 0 exited 75; the dead rank was
    reported; the world-1 run joined and committed generation 1 and its
    losses and params equal the oracle's bit for bit; the zombie's save and
    its ``gc_checkpoints`` both raised ``StaleGenerationError``, each with
    a ``cluster_fence`` event; no process of the phase outlives it."""
    import signal
    import tempfile
    from apex_tpu_torch import parallel

    phase = "cluster_zombie_elastic"
    work = tempfile.mkdtemp(prefix="chip_smoke_zombie_")
    root, cdir = os.path.join(work, "ck"), os.path.join(work, "cluster")
    os.makedirs(os.path.join(work, "barrier"))
    procs, events, seen = {}, [], []
    t0 = time.perf_counter()

    def launch(name, mode, rank, world, store):
        # each child in a session of its own: the stopped zombie must not
        # share this process's group, which a runner may have started
        # orphaned (no parent in its session): there the kernel sends a
        # group holding a stopped process SIGHUP when a member exits
        out = os.path.join(work, f"{name}.json")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-c", _ZOMBIE_CHILD, mode, str(rank),
             str(world), root, cdir, os.path.join(work, "barrier"),
             os.path.join(work, store), out],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True), out)

    def result(name, timeout=300):
        p, out = procs[name]
        _, err = p.communicate(timeout=timeout)
        with open(out) as f:
            return p.returncode, json.load(f), err

    def train_fn(world, attempt):
        seen.append((world, attempt))
        if world == 2:
            for r in (0, 1):
                launch(f"w2_rank{r}", "world2", r, 2, "store2")
            code, rep, err = result("w2_rank0")
            if code != 75:
                raise AssertionError(f"{phase}: rank 0 exited {code}, not "
                                     f"75\n{err[-3000:]}")
            seen.append(rep)
            raise SystemExit(code)
        launch("world1", "world1", 0, 1, "store1")
        launch("oracle", "oracle", 0, 1, "store_oracle")
        return {n: result(n) for n in ("world1", "oracle")}

    try:
        got = parallel.elastic_run(train_fn, world_sizes=[2, 1],
                                   cluster_dir=cdir,
                                   event_sink=events.append)
        zp = procs["w2_rank1"][0]
        os.kill(zp.pid, signal.SIGCONT)
        zcode, zombie, zerr = result("w2_rank1", timeout=120)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                try:
                    os.kill(p.pid, signal.SIGCONT)
                except OSError:
                    pass
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    alive = [n for n, (p, _) in procs.items() if p.poll() is None]
    (c1, w1, e1), (co, orc, eo) = got["world1"], got["oracle"]
    fences = [e["action"] for e in zombie["events"]
              if e["kind"] == "cluster_fence"]
    dead = [e["expired_rank"] for e in events
            if e["kind"] == "cluster_lease" and e["action"] == "expire"]
    checks = {
        "attempts": [s for s in seen if isinstance(s, tuple)]
        == [(2, 0), (1, 1)],
        "tripped": seen[1].get("tripped_at") == ZOMBIE_STOP,
        "dead reported": 1 in dead,
        "world1 ran": c1 == 0 and co == 0,
        "generation 1": w1.get("joined") == 1 and w1.get("committed") == 1,
        "restored 2 -> 1": (w1.get("restored"), w1.get("from_processes"))
        == (ZOMBIE_SAVES[-1], 2) and orc.get("restored") == w1.get(
            "restored"),
        "losses = oracle": w1["losses"] == orc["losses"]
        and len(w1["losses"]) == ZOMBIE_RESUMED,
        "params = oracle": w1.get("param_bytes") == orc.get("param_bytes"),
        "zombie refused": zcode == 88 and zombie.get("refused") == 2,
        "fence events": fences == ["refused_write", "refused_delete"],
        "no process left": not alive}
    if not all(checks.values()):
        raise AssertionError(f"{phase}: {checks}\nworld1 {e1[-2000:]}\n"
                             f"oracle {eo[-2000:]}\nzombie {zerr[-2000:]}")
    log(f"phase {phase}: world 2 -> rank 1 stopped after step {ZOMBIE_STOP}, "
        f"rank 0 waited in step {ZOMBIE_STOP + 1}'s collective until its "
        f"HangWatchdog fired {seen[1].get('tripped_after_s', 0.0):.2f} s "
        f"after step {ZOMBIE_STOP} (deadline {ZOMBIE_DEADLINE_S:g} s), "
        f"dumped and exited 75; elastic_run reported dead ranks "
        f"{sorted(set(dead))} and relaunched at world 1 under generation 1: "
        f"restored step {w1['restored']} from {w1['from_processes']} "
        f"processes, losses {[round(v, 6) for v in w1['losses']]} = the "
        f"oracle's bit for bit, params too; the zombie's save and gc "
        f"refused ({fences}); {time.perf_counter() - t0:.1f} s")


# --- observability: trace/, monitor/ and enable_crash_dumps --------------------

TRACED_STEPS = 8
TRACED_TURNS = 3              # rounds of (plain, traced, traced, plain)
TRACED_TURN_STEPS = 3         # steps a turn, host-timed one by one
SPAN_PROBES = 20000           # spans in the host-cost probe
CRASH_HANG_S = 8.0            # the hang child's deadline (> a first step)
CRASH_SLEEP_S = 30.0          # device time the hung fetch waits on
STRAGGLER_STEPS, STRAGGLER_SLOW = 12, range(4, 12)
STRAGGLER_DELAY_S = 0.05      # rank 1's extra data/load a slow step
STRAGGLER_BATCH, STRAGGLER_SIZE, STRAGGLER_WARMUP = 32, 64, 2


def _trace_script():
    """``scripts/torch_trace_resnet.py`` as a module (its loop and wiring
    are what the traced phases drive)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "torch_trace_resnet.py")
    spec = importlib.util.spec_from_file_location("torch_trace_resnet", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _schema(path, kind):
    """``scripts/check_metrics_schema.py --kind kind path`` (it imports
    no JAX); raises with its report on a violation."""
    r = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "scripts", "check_metrics_schema.py"), "--kind",
         kind, path], capture_output=True, text=True)
    if r.returncode != 0:
        raise AssertionError(f"{path} fails --kind {kind}:\n"
                             f"{r.stdout[-2000:]}{r.stderr[-2000:]}")


def _kernel_census(fn, iters=2, by_name=False):
    """(device kernels, device ms) of one ``fn()`` call, from a guarded
    profiler session of ``iters`` calls (``prof.report.guarded_session``:
    retaken with a longer lead when it lost the opening or closing spin;
    the spins left out by name). ``by_name`` adds a third element:
    {kernel name: (launches, device ms)} of one call."""
    import torch

    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()

    _, ks = guarded_session(calls)
    ks = [e for e in ks if e.name not in _SPIN_NAMES]
    out = (len(ks) / iters,
           sum(e.time_range.elapsed_us() for e in ks) / 1e3 / iters)
    if not by_name:
        return out
    names = {}
    for e in ks:
        n, ms = names.get(e.name, (0, 0.0))
        names[e.name] = (n + 1 / iters,
                         ms + e.time_range.elapsed_us() / 1e3 / iters)
    return out + (names,)


def resnet50_traced(smi):
    """Phase resnet50_traced: ResNet-50 (B256, 224², O2 bf16, arena
    FusedSGD) through ``scripts/torch_trace_resnet.py``'s loop for
    TRACED_STEPS steps under ``enable_crash_dumps``, ``Amp(monitor=True)``,
    a ``MetricsLogger`` (JSONL metrics, trace and goodput channels) and a
    ``GoodputLedger``. Gates: the hand kernels' launches a step equal
    resnet50_arena's; the Metrics after the steps read ``step`` 8,
    ``skip_count`` 0 and the last step's loss; one more step with the whole
    stack (spans, monitor, ``recorder.record_metrics``, ``logger.record``,
    no flush) runs under ``torch.cuda.set_sync_debug_mode("error")``; the
    goodput closure within 5%; the Chrome trace's structure and the event,
    goodput, metrics and crash-dump streams pass the schema script. Then,
    in turns with the untraced arena step (the same step with
    ``state.metrics`` None and no tracer): host ms a step, device ms and
    kernels a step (profiler), the kernels and device ms ``monitor=True``
    adds, and host µs a span (entered, and passive). Returns the traced
    step, its state and inputs for debug_nans_card."""
    import tempfile
    import torch
    from apex_tpu_torch import ops, trace

    phase = "resnet50_traced"
    clock = _Clock()
    tr = _trace_script()
    out = tempfile.mkdtemp(prefix="chip_smoke_traced_")
    with clock("build"):
        args = tr.parse_args(["--out", out])
        step, state, bs, x, y, model = tr.build(args)
        tracer, recorder, logger, ledger = tr.wire(out, TRACED_STEPS)
    try:
        ops.reset_launch_counts()
        with clock("steps"):
            state, bs, losses = tr.loop(TRACED_STEPS, step, state, bs, x, y,
                                        tracer, logger, recorder)
        check_launches(phase, ops.launch_counts(), dict(
            RESNET_PER_STEP, **SGD_PER_STEP), None, steps=TRACED_STEPS)
        m = state.metrics
        got = (int(m.step), int(m.skip_count), m.loss.item())
        if got != (TRACED_STEPS, 0, losses[-1]) or not all(
                math.isfinite(v) for v in losses):
            raise AssertionError(f"{phase}: metrics (step, skip, loss) "
                                 f"{got}, losses {losses}")
        # one step with the whole stack and no read-back: no host sync
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with tracer:
                state, bs, loss, _ = tr.traced_step(
                    TRACED_STEPS, step, state, bs, x, y, logger, recorder,
                    read_loss=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        logger.flush()
        ok, worst = ledger.check_closure(0.05)
        if not ok:
            raise AssertionError(f"{phase}: goodput closure {worst:.4f}")
        steady = ledger.steps[1:TRACED_STEPS]
        frac = sum(r.goodput_frac for r in steady) / len(steady)
        buckets = {b: sum(r.buckets[b] for r in steady) / len(steady)
                   for b in steady[0].buckets}
        ct = tracer.chrome_trace()
        tr.check_chrome_trace(ct)
        dump = recorder.dump(reason="manual")
        for path, kind in ((f"{out}/events.jsonl", "trace"), (dump, "trace"),
                           (f"{out}/goodput.jsonl", "goodput"),
                           (f"{out}/metrics.jsonl", "metrics")):
            _schema(path, kind)
        ops.reset_launch_counts()

        # the cost, in turns with the untraced step
        plain_state = state._replace(metrics=None)

        def plain():
            nonlocal plain_state, bs
            plain_state, bs, loss = step(plain_state, bs, x, y)
            return loss

        def traced(i=[TRACED_STEPS + 1], read=True):
            nonlocal state, bs
            with tracer:
                state, bs, loss, _ = tr.traced_step(
                    i[0], step, state, bs, x, y, logger, recorder,
                    read_loss=read)
            i[0] += 1
            return loss

        logger.flush_every = 10 ** 9            # flushes stay out of it
        host = {"plain": [], "traced": []}
        with clock("turns"):
            for _ in range(TRACED_TURNS):
                for name in ("plain", "traced", "traced", "plain"):
                    fn = plain if name == "plain" else traced
                    for _ in range(TRACED_TURN_STEPS):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        fn().item()
                        host[name].append((time.perf_counter() - t0) * 1e3)
        with clock("profiles"):
            census = {}
            for name in ("plain", "traced", "traced", "plain"):
                fn = plain if name == "plain" else (
                    lambda: traced(read=False))
                census.setdefault(name, []).append(_kernel_census(fn))
            monitored = state

            def monitor_only():
                nonlocal monitored, bs
                monitored, bs, loss = step(monitored, bs, x, y)
                return loss
            mon = _kernel_census(monitor_only)
        logger.close()
        recorder.uninstall()
        with clock("span probe"):
            probe = trace.Tracer()
            with probe:
                with trace.step(0):
                    t0 = time.perf_counter()
                    for _ in range(SPAN_PROBES):
                        with trace.span("probe"):
                            pass
                    entered = (time.perf_counter() - t0) / SPAN_PROBES * 1e6
            t0 = time.perf_counter()
            for _ in range(SPAN_PROBES):
                with trace.span("probe"):
                    pass
            passive = (time.perf_counter() - t0) / SPAN_PROBES * 1e6
    finally:
        recorder.uninstall()
        shutil.rmtree(out, ignore_errors=True)
    ops.reset_launch_counts()
    med = {k: _median(v) for k, v in host.items()}
    ck = {k: (_median([c for c, _ in v]), _median([d for _, d in v]))
          for k, v in census.items()}
    log(f"phase {phase}: {TRACED_STEPS} traced steps, losses "
        f"{[round(v, 6) for v in losses]}; launches a step as "
        f"resnet50_arena's; Metrics step {got[0]}, skip {got[1]}, loss = "
        f"the step's; one step of the whole stack under "
        f"set_sync_debug_mode('error'); goodput closure worst {worst:.2e}; "
        f"Chrome trace, events, goodput, metrics and dump streams valid")
    log(f"phase {phase}: steady goodput {frac:.4f} (steps 1-"
        f"{TRACED_STEPS - 1}), buckets ms a step "
        + ", ".join(f"{b} {v:.3f}" for b, v in buckets.items() if v))
    log(f"phase {phase}: in turns ({smi}): host ms a step plain "
        f"{med['plain']:.3f}, traced {med['traced']:.3f} "
        f"({100 * (med['traced'] / med['plain'] - 1):+.2f}%); device "
        f"kernels a step plain {ck['plain'][0]:g}, traced "
        f"{ck['traced'][0]:g}; device ms a step plain {ck['plain'][1]:.3f}, "
        f"traced {ck['traced'][1]:.3f}; monitor=True alone "
        f"{mon[0] - ck['plain'][0]:+g} kernels, "
        f"{mon[1] - ck['plain'][1]:+.4f} device ms; host us a span "
        f"{entered:.2f} under a Tracer, {passive:.2f} passive")
    log(clock.line(phase))
    return step, state, bs, x, y, model


def debug_nans_card(smi, traced):
    """Phase debug_nans_card: the traced ResNet-50 step with NaN
    provenance. Mode off: ``nan_probe`` returns its argument and a step
    launches as many device kernels as the step with the probes taken out
    of amp. Mode on: a step runs under ``set_sync_debug_mode("error")``
    (the probes fold on the card, no sync), its extra kernels counted;
    ``first_nan()`` is None after a clean step, names ``amp/fwd`` after a
    NaN written into one conv weight and ``amp/bwd`` after a NaN put into
    the gradient behind the forward (a hook on the head's output)."""
    import torch
    from apex_tpu_torch import trace
    from apex_tpu_torch.amp import api as amp_api

    phase = "debug_nans_card"
    step, state, bs, x, y, model = traced
    state = state._replace(metrics=None)
    t0 = time.perf_counter()

    def run(s=None):
        nonlocal state, bs
        out, bs_new, loss = step(state if s is None else s, bs, x, y)
        if s is None:
            state, bs = out, bs_new
        return loss

    probe = torch.ones(3, device="cuda")
    if trace.nan_probe("p", probe) is not probe or \
            trace.debug_nans_enabled():
        raise AssertionError(f"{phase}: the off probe is not the identity")
    off = _kernel_census(run)
    saved = amp_api.nan_probe
    amp_api.nan_probe = lambda name, tree: tree
    try:
        unprobed = _kernel_census(run)
    finally:
        amp_api.nan_probe = saved
    trace.reset_nan_state()
    with trace.debug_nans():
        on = _kernel_census(run)
        trace.reset_nan_state()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        clean = trace.first_nan()
        name = next(k for k, v in state.params.items()
                    if v.dim() == 4)
        bad = dict(state.params)
        bad[name] = bad[name].clone()
        bad[name].view(-1)[0] = float("nan")
        trace.reset_nan_state()
        run(state._replace(params=bad))
        fwd = trace.first_nan()
        trace.reset_nan_state()
        hooks = []

        def poison(mod, inp, out):
            if out.requires_grad:
                out.register_hook(lambda g: torch.full_like(g, float("nan")))

        hooks.append(model.Dense_0.register_forward_hook(poison))
        try:
            loss = run(state)
        finally:
            for h in hooks:
                h.remove()
        bwd = trace.first_nan()
        trace.reset_nan_state()
    checks = {"off = unprobed": off[0] == unprobed[0],
              "clean": clean is None,
              "fwd": fwd is not None and fwd["span"] == "amp/fwd",
              "bwd": (bwd is not None and bwd["span"] == "amp/bwd"
                      and math.isfinite(loss.item()))}
    if not all(checks.values()):
        raise AssertionError(f"{phase}: {checks}; off {off}, unprobed "
                             f"{unprobed}, on {on}, first_nan {clean}, "
                             f"{fwd}, {bwd}")
    log(f"phase {phase}: off: nan_probe is the identity, {off[0]:g} device "
        f"kernels a step = the unprobed step's; on: {on[0] - off[0]:+g} "
        f"kernels, {on[1] - off[1]:+.4f} device ms a step ({smi}), no host "
        f"sync; first_nan None on a clean step, {fwd['span']!r} after a NaN "
        f"in {name}, {bwd['span']!r} after a NaN gradient behind the "
        f"forward; {time.perf_counter() - t0:.1f} s")



_DUMP_CHILD = r"""
import os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as C
C.crash_dump_child(sys.argv[1:])
"""


def crash_dump_child(argv):
    """A child of crash_dumps_card (``mode`` exception, sigterm or hang):
    the depth-2 encoder at BERT-Large widths (B4, O1 bf16, arena LAMB,
    ``monitor=True``) under ``enable_crash_dumps(escalation=
    EscalationPolicy(mgr))`` with a host snapshot after each step; step 3
    raises in ``dispatch`` (exception), waits in ``fetch`` for the
    parent's SIGTERM (sigterm), or reads the loss back behind
    CRASH_SLEEP_S of ``torch.cuda._sleep`` past the hang deadline (hang)."""
    import torch
    from apex_tpu_torch import ckpt, parallel, trace, train

    root, dump, mode = argv
    torch.cuda.set_device(0)
    step, state, (toks, labels), _, _ = train.build_bert_step(
        4, 512, encoder=depth2_encoder(), strategy="arena", monitor=True)
    mgr = ckpt.CheckpointManager(root, keep=3)
    tracer, rec, _, _ = parallel.enable_crash_dumps(
        dump, hang_deadline_s=CRASH_HANG_S if mode == "hang" else None,
        escalation=ckpt.EscalationPolicy(mgr))
    cycles = 0
    if mode == "hang":
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        torch.cuda._sleep(100_000_000)
        b.record()
        b.synchronize()
        cycles = int(100_000_000 / a.elapsed_time(b) * CRASH_SLEEP_S * 1e3)
    with tracer:
        for i in range(1, 4):
            with trace.step(i):
                with trace.span("dispatch"):
                    state, loss = step(state, toks, labels)
                    if i == 3 and mode == "exception":
                        raise RuntimeError("forced mid-step exception")
                with trace.span("fetch"):
                    if i == 3 and mode == "sigterm":
                        print("MIDSTEP", flush=True)
                        while True:
                            time.sleep(0.01)
                    if i == 3 and mode == "hang":
                        torch.cuda._sleep(cycles)
                        print("MIDSTEP", flush=True)
                    value = loss.item()
                rec.record_metrics(state.metrics)
            mgr.snapshot(i, {"amp": state}, extra={"loss": value})
            mgr.wait()
    os._exit(1)                       # step 3 never completes


def _dump_lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def crash_dumps_card():
    """Phase crash_dumps_card: three ``crash_dump_child`` processes on the
    card at once, beside this process's uninterrupted run of the same
    three steps. (a) exception: exit 1 and an excepthook dump naming the
    exception, its traceback, ``dispatch`` in flight and two steps with
    their Metrics before the aborted one. (b) SIGTERM mid-step (in
    ``fetch``): ``on_preempt()`` commits step 2's snapshot, then the dump
    is written (reason ``signal:SIGTERM``), the child dies by the signal,
    and the checkpoint resumes to the uninterrupted run's step-3 loss and
    state bit for bit. (c) a device-side hang in ``fetch``: the watchdog
    fires within the deadline and a second while the main thread waits on
    the card (so the wait releases the GIL), its dump names ``fetch`` in
    flight, holds the main thread's stack and no metrics; the escalation
    commits step 2 and exits 75. Every dump passes ``--kind trace``; no
    child outlives the phase."""
    import signal
    import tempfile
    from apex_tpu_torch import ckpt, train

    phase = "crash_dumps_card"
    work = tempfile.mkdtemp(prefix="chip_smoke_dumps_")
    modes = ("exception", "sigterm", "hang")
    procs, errs, codes = {}, {}, {}
    t0 = time.perf_counter()
    try:
        for m in modes:
            os.makedirs(f"{work}/{m}")
            procs[m] = subprocess.Popen(
                [sys.executable, "-c", _DUMP_CHILD, f"{work}/{m}/ck",
                 f"{work}/{m}/crash.jsonl", m], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        step, state, (toks, labels), _, _ = train.build_bert_step(
            4, 512, encoder=depth2_encoder(), strategy="arena", monitor=True)
        losses = []
        for _ in range(3):
            state, loss = step(state, toks, labels)
            losses.append(loss.item())
        line = procs["sigterm"].stdout.readline()
        if line.strip() != "MIDSTEP":
            raise AssertionError(f"{phase}: sigterm child said {line!r}")
        procs["sigterm"].send_signal(signal.SIGTERM)
        for m, p in procs.items():
            try:
                _, errs[m] = p.communicate(timeout=300)
            finally:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            codes[m] = p.returncode
        want = {"exception": 1, "sigterm": -signal.SIGTERM,
                "hang": ckpt.ESCALATION_EXIT_CODE}
        if codes != want:
            raise AssertionError(f"{phase}: exit codes {codes}\n" + "\n".join(
                f"{m}: {e[-2000:]}" for m, e in errs.items()))
        exc = _dump_lines(f"{work}/exception/crash.jsonl")
        term = _dump_lines(f"{work}/sigterm/crash.jsonl")
        hang = _dump_lines(f"{work}/hang/crash.hang.jsonl")
        esc = _dump_lines(f"{work}/hang/crash.jsonl")
        for path in (f"{work}/exception/crash.jsonl",
                     f"{work}/sigterm/crash.jsonl",
                     f"{work}/hang/crash.hang.jsonl",
                     f"{work}/hang/crash.jsonl"):
            _schema(path, "trace")
        manifests = {m: ckpt.read_manifest(ckpt.latest_checkpoint(
            f"{work}/{m}/ck")) for m in ("sigterm", "hang")}
        mgr = ckpt.CheckpointManager(f"{work}/sigterm/ck")
        fresh = train.build_bert_step(
            4, 512, encoder=depth2_encoder(), strategy="arena",
            monitor=True)[1]
        tree, _ = mgr.restore({"amp": fresh})
        resumed, loss3 = step(tree["amp"], toks, labels)
        stacks = hang[0]["stacks"]
        main_stack = next((v for k, v in stacks.items()
                           if k.startswith("MainThread")), [])
        hang_steps = [r for r in hang[1:] if r["kind"] == "step"]
        ck_mtime = os.path.getmtime(os.path.join(
            ckpt.latest_checkpoint(f"{work}/sigterm/ck"), "manifest.json"))
        checks = {
            "exception header": exc[0]["reason"] == "exception"
            and "forced mid-step exception" in exc[0]["exception"]
            and bool(exc[0]["traceback"])
            and exc[0]["in_flight_spans"] == ["dispatch"],
            "exception steps": [(r["step"], (r.get("metrics") or {}).get(
                "step"), bool(r.get("aborted"))) for r in exc[1:]]
            == [(1, 1, False), (2, 2, False), (3, None, True)],
            "sigterm header": term[0]["reason"] == "signal:SIGTERM"
            and term[0]["in_flight_spans"] == ["fetch"]
            and term[0]["last_completed_span"] == "dispatch",
            "preempt saved first": manifests["sigterm"]["step"] == 2
            and manifests["sigterm"]["meta"]["reason"] == "preempt"
            and ck_mtime <= os.path.getmtime(f"{work}/sigterm/crash.jsonl"),
            "resumed bit for bit": loss3.item() == losses[2]
            and not _leaves_equal(resumed, state),
            "hang fired in time": hang[0]["kind"] == "watchdog"
            and hang[0]["seconds_since_last_step"] < CRASH_HANG_S + 1.0,
            "hang names fetch": hang[0]["in_flight_spans"] == ["fetch"]
            and hang[0]["last_step"] == 2,
            "main stack": any("fetch" in f or "item" in f
                              for f in main_stack),
            "no metrics fetch": bool(hang_steps) and all(
                r["metrics"] is None and r.get("metrics_error")
                for r in hang_steps),
            "escalated": esc[0]["reason"] == "escalation:stall"
            and manifests["hang"]["step"] == 2
            and manifests["hang"]["meta"]["reason"] == "stall"}
        if not all(checks.values()):
            raise AssertionError(f"{phase}: {checks}\nhang {hang[0]}\n"
                                 + "\n".join(f"{m}: {e[-2000:]}"
                                             for m, e in errs.items()))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    alive = [m for m, p in procs.items() if p.poll() is None]
    if alive:
        raise AssertionError(f"{phase}: children alive: {alive}")
    log(f"phase {phase}: exception -> exit 1, dump with its traceback and "
        f"'dispatch' aborted; SIGTERM in 'fetch' -> step 2 committed "
        f"(reason preempt) before the dump, resumed to loss {losses[2]:.6f} "
        f"and the state bit for bit; a {CRASH_SLEEP_S:g} s device wait in "
        f"'fetch' -> the watchdog fired after "
        f"{hang[0]['seconds_since_last_step']:.2f} s (deadline "
        f"{CRASH_HANG_S:g} s) while the main thread waited on the card, "
        f"dump without metrics, escalation exit 75 with step 2 committed; "
        f"all dumps valid; {time.perf_counter() - t0:.1f} s")


class _LateLoad:
    """A ``DistributedDataParallel`` stand-in for ``build_resnet_step``:
    before each gradient sync, when ``slow`` is set, rank 1's input
    pipeline hands over the next batch STRAGGLER_DELAY_S late (a
    ``data/load`` span), so the wait the other rank sees in the sync's
    collective is this load alone. A barrier just before the load lines
    the ranks up there: the host's dispatch of the forward and backward
    (≈ 13 ms a step, two processes on one card and 8 cores) varies by a
    few ms a step and by up to 20 ms now and then, and would otherwise
    add to or take from the load's skew (PERF.md §6;
    ``scripts/torch_straggler_skew.py`` measures it with ``align=False``)."""

    def __init__(self, ddp, align=True):
        self.ddp, self.mesh, self.slow = ddp, ddp.mesh, False
        self.align = align

    def sync(self, grads):
        import torch
        from apex_tpu_torch import trace
        if self.align:
            torch.distributed.barrier()
        if self.slow:
            with trace.span("data/load"):
                time.sleep(STRAGGLER_DELAY_S)
        return self.ddp.sync(grads)


def straggler_rank(rank, world, hb_dir):
    """One rank of straggler_podview_two_ranks: a small ResNet (two
    bottleneck stages, O2 bf16, arena SGD) under
    ``DistributedDataParallel(delay_allreduce=True)`` over the gloo group,
    STRAGGLER_WARMUP untraced steps, then STRAGGLER_STEPS traced steps
    with a ``HeartbeatWriter``; rank 1 spends
    STRAGGLER_DELAY_S in a ``data/load`` span on the STRAGGLER_SLOW
    steps, between its backward and the gradient sync (``_LateLoad``).
    Rank 0 runs a ``StragglerWatch`` over the heartbeats into a
    ``HangWatchdog``'s early warning (polled after every step) and
    returns the flags, warnings and stall calls; both return their span
    events and step durations."""
    import torch
    from apex_tpu_torch import models, parallel, trace, train

    mesh = parallel.data_parallel_mesh()
    model = models.ResNet(stage_sizes=[1, 1], num_classes=1000,
                          dtype=torch.bfloat16, device="cuda", seed=0)
    late = _LateLoad(parallel.DistributedDataParallel(
        mesh, delay_allreduce=True))
    step, (state, bs), (x, y), _, _ = train.build_resnet_step(
        STRAGGLER_BATCH, STRAGGLER_SIZE, model=model, strategy="arena",
        ddp=late)
    for _ in range(STRAGGLER_WARMUP):   # kernels loaded before the trace
        state, bs, loss = step(state, bs, x, y)
        loss.item()
    tracer = trace.Tracer()
    hb = trace.HeartbeatWriter(hb_dir, rank=rank)
    tracer.subscribe(hb.on_step)
    out = {"flags": [], "warnings": [], "stalls": []}
    if rank == 0:
        wd = trace.HangWatchdog(600.0, tracer=tracer,
                                on_fire=out["warnings"].append,
                                on_stall=out["stalls"].append)
        watch = trace.StragglerWatch(trace.StragglerDetector(hb_dir),
                                     watchdog=wd, renotify_s=0.0)
        wd.start()
    with tracer:
        for i in range(STRAGGLER_STEPS):
            late.slow = rank == 1 and i in STRAGGLER_SLOW
            with trace.step(i):
                with trace.span("dispatch"):
                    state, bs, loss = step(state, bs, x, y)
                    loss.item()
            if rank == 0:
                out["flags"].append([r.rank for r in watch.poll_once()])
    torch.distributed.barrier()
    if rank == 0:
        out["flags"].append([r.rank for r in watch.poll_once()])
        wd.stop()
    out["spans"] = tracer.span_events(rank)
    out["durs"] = [st.dur_ms for st in tracer.steps]
    return out


def straggler_body(rank, world, tmp):
    _run_rank(lambda r, w: straggler_rank(r, w, f"{tmp}/hb"), rank, world,
              tmp)


def straggler_podview_two_ranks():
    """Phase straggler_podview_two_ranks: two gloo ranks on the card
    (``straggler_rank``), rank 1 STRAGGLER_DELAY_S late in ``data/load``
    before the gradient sync on steps 4-11. (A load at the top of the
    step puts the slow rank's forward in the wait window, and the blame,
    the deepest span there, goes to ``amp/fwd``: PERF.md §6, PR 18.)
    ``PodTimeline.merge`` of both ranks' span events
    blames rank 1's ``data/load`` for every ``ddp/sync_gradients`` skew of
    steps 4-11, at 50 ± 15 ms; steps 0-3 blame no load, and steps 1-3
    skew under 15 ms (step 0 is each rank's warm-up). The
    heartbeat tier is held to what the heartbeats can show: the step
    barrier of the gradient sync makes both ranks' step durations equal
    (rank 0 waits in the collective what rank 1 spends loading), so the
    detector's duration lag stays under its 1 ms floor plus the
    ranks' jitter and it flags nobody at any step — and with two ranks
    its robust z can never pass 1/1.4826 anyway (PERF.md §7) — and the
    watchdog's early warning and its stall hook both stay silent."""
    from apex_tpu_torch import trace

    phase = "straggler_podview_two_ranks"
    ranks = _spawn(phase, straggler_body, 2)
    pod = trace.PodTimeline.merge({r: out["spans"]
                                   for r, out in enumerate(ranks)})
    skews = [c for c in pod.collective_skew()
             if c.name == "ddp/sync_gradients"]
    slow = [c for c in skews if c.step in STRAGGLER_SLOW]
    fast = [c for c in skews if c.step not in STRAGGLER_SLOW]
    lags = [d1 - d0 for d0, d1 in zip(ranks[0]["durs"], ranks[1]["durs"])]
    want = STRAGGLER_DELAY_S * 1e3
    checks = {
        "matched": len(skews) == STRAGGLER_STEPS,
        "blame": all(c.blamed_rank == 1 and c.blamed_span == "data/load"
                     and abs(c.skew_ms - want) <= 15.0 for c in slow),
        "steps 0-3": all(c.blamed_span != "data/load" for c in fast)
        and all(c.skew_ms < 15.0 for c in fast if c.step > 0),
        "no flag": not any(ranks[0]["flags"]),
        "watchdog quiet": not ranks[0]["warnings"]
        and not ranks[0]["stalls"]}
    if not all(checks.values()):
        raise AssertionError(
            f"{phase}: {checks}; skews "
            f"{[(c.step, round(c.skew_ms, 2), c.blamed_rank, c.blamed_span) for c in skews]}"
            f", flags {ranks[0]['flags']}, lags {lags}")
    log(f"phase {phase}: ddp/sync_gradients skew blamed on rank 1 "
        f"'data/load' at steps 4-11: "
        f"{[round(c.skew_ms, 2) for c in slow]} ms (want {want:g} ± 15), "
        f"steps 0-3 {[round(c.skew_ms, 2) for c in fast]} ms; step "
        f"duration lag rank 1 - rank 0 {[round(v, 2) for v in lags]} ms: "
        f"the barrier evens the steps, the detector flagged nobody and the "
        f"watchdog stayed silent")


# --- observability part 2: the numerics and dynamics monitors -----------------

OBSERVED_STEPS = 5
OBSERVED_TURNS = 2            # rounds of (plain, observed, observed, plain)
OBSERVED_SPARSE = 10          # check_every of the off-step census
FOLD_LEAVES = 49              # leaves of the short tree of the fold census
PROBE_BATCH = 4               # per-rank batch of dynamics_two_ranks
PROBE_STEPS = 3
PLAN_BYTES = 1 << 24          # payload the two-rank link plan is made for
CONV_STEPS, CONV_SEEDS = 40, (0, 1, 2)
MONITOR_KEPT_BYTES = 32 << 20  # device memory the monitor phases may keep


def _numerics_sites_of(name):
    """The ``amp/grads`` site of one port parameter."""
    import torch
    from apex_tpu_torch.monitor import numerics as nx
    return nx.site_names({"amp/grads": {name: torch.zeros(1)}})[0]


def _poison_grad():
    """An identity on one tensor whose backward returns NaN."""
    import torch

    class PoisonGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return g * float("nan")

    return PoisonGrad.apply


def _write_events(events, name):
    import tempfile
    fd, path = tempfile.mkstemp(prefix=f"chip_smoke_{name}_",
                                suffix=".jsonl")
    with os.fdopen(fd, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")
    return path


def bert_large_observed(smi, arena_losses):
    """Phase bert_large_observed: BERT-Large (B16, S512, O1 bf16,
    FusedLAMB arena, ``train.build_bert_step``) stepped OBSERVED_STEPS
    times through ``Amp.step(numerics=(ns, NumericsConfig()),
    dynamics=(ds, DynamicsConfig(local_batch=16)))`` in turns with the
    plain step from the same state. Gates: losses equal
    bert_large_arena's and the plain run's, and every param the plain
    run's, bit for bit; each observed step launches the hand kernels as
    the arena step does; the hooks add no host sync (the port's
    ``monitor.check.module_count_and_host_ops`` on a plain and an observed
    step, which also counts their device kernels; the observed step then
    runs under ``set_sync_debug_mode("error")`` when the plain one syncs
    nowhere); ``precision_report`` finds no surprise at the sites'
    current formats, ``nonfinite_sites`` is empty, and the numerics and
    dynamics events pass the schema script. Cost in turns: device kernels
    and device ms a step (profiler), wall ms a step, peak GiB; the fold's
    kernels over all 292 leaves and over FOLD_LEAVES of them. With
    ``check_every=OBSERVED_SPARSE`` an off-step of each hook adds at most
    one kernel. Last, one grad leaf poisoned with NaN under
    ``guard=``: ``nonfinite_sites`` names exactly its ``amp/grads`` site
    and ``scale_amax`` is inf in that row."""
    import torch
    from apex_tpu_torch import guard, ops, train
    from apex_tpu_torch.monitor import dynamics as dx
    from apex_tpu_torch.monitor import numerics as nx
    from apex_tpu_torch.monitor.check import module_count_and_host_ops

    phase = "bert_large_observed"
    clock = _Clock()
    torch.cuda.empty_cache()
    with clock("build"):
        step, state0, (toks, labels), _policy, _enc = train.build_bert_step(
            16, 512, strategy="arena")
        app = step.amp_opt
        loss_fn = step.make_loss(toks, labels)
        sites = app.numerics_sites(state0.params)
        dsites = app.dynamics_sites(state0.params)
        ncfg, dcfg = nx.NumericsConfig(), dx.DynamicsConfig(local_batch=16)
        ns = nx.numerics_init(ncfg, sites=sites, device=DEVICE)
        ds = dx.dynamics_init(dcfg, sites=dsites, device=DEVICE)
    per_step = dict(EXPECTED_PER_STEP, **ARENA_PER_STEP)
    plain_state, obs_state = state0, state0
    plain_losses, obs_losses = [], []

    def plain():
        nonlocal plain_state
        plain_state, loss = step(plain_state, toks, labels)
        return loss

    def observed():
        nonlocal obs_state, ns, ds
        obs_state, loss, _fin, ns, ds = app.step(
            obs_state, loss_fn, numerics=(ns, ncfg), dynamics=(ds, dcfg))
        return loss

    def counted(fn):
        # (fn(), device kernels, host syncs) of one call
        out = []
        kernels, host = module_count_and_host_ops(lambda: out.append(fn()))
        return out[0], kernels, host

    with clock("steps"):
        for i in range(OBSERVED_STEPS):
            plain_losses.append(plain().item())
            ops.reset_launch_counts()
            if i == 0:
                loss, obs_kernels, obs_syncs = counted(observed)
            elif i == 1 and not plain_syncs:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    loss = observed()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            else:
                loss = observed()
            check_launches(phase, ops.launch_counts(), per_step, None,
                           steps=1)
            obs_losses.append(loss.item())
            if i == 0:
                _, plain_kernels, plain_syncs = counted(
                    lambda: step(state0, toks, labels))
    if not (obs_losses == plain_losses == list(arena_losses)):
        raise AssertionError(f"{phase}: losses observed {obs_losses}, "
                             f"plain {plain_losses}, arena {arena_losses}")
    differ = [k for k in plain_state.params if not torch.equal(
        plain_state.params[k], obs_state.params[k])]
    if differ or len(obs_syncs) > len(plain_syncs):
        raise AssertionError(f"{phase}: params differ at {differ[:5]}; "
                             f"syncs observed {obs_syncs}, plain "
                             f"{plain_syncs}")
    if int(ns.check_count) != OBSERVED_STEPS or \
            int(ds.check_count) != OBSERVED_STEPS:
        raise AssertionError(f"{phase}: folds {int(ns.check_count)}, "
                             f"{int(ds.check_count)}")
    # the sites' formats today: the cast copy's dtypes, f32 grads and
    # updates
    cast = app.policy.cast_params(obs_state.params)
    current = {s: (cast[k].dtype if s.startswith("amp/cast/")
                   else torch.float32)
               for s, k in zip(sites, _jax_ordered(cast) * 3)}
    report = nx.precision_report(ns, sites, current_dtypes=current)
    bad = nx.nonfinite_sites(ns, sites)
    if report.surprises() or bad:
        raise AssertionError(f"{phase}: surprises "
                             f"{[r.site for r in report.surprises()][:5]}, "
                             f"nonfinite {bad[:5]}")
    drep = dx.dynamics_report(ds, dsites, local_batch=16)
    if any(v is None or not v > 0 for v in drep.eff_lr + drep.uw_ratio):
        raise AssertionError(f"{phase}: dynamics rows {drep.table()}")
    with clock("schema"):
        npath = _write_events(nx.check_events(ns, sites)
                              + report.to_events(step=OBSERVED_STEPS),
                              "numerics")
        dpath = _write_events(dx.check_events(ds, dsites, local_batch=16),
                              "dynamics")
        try:
            _schema(npath, "numerics")
            _schema(dpath, "dynamics")
        finally:
            os.remove(npath)
            os.remove(dpath)
    with clock("cost"):
        wall = {"plain": [], "observed": []}
        for _ in range(OBSERVED_TURNS):
            for name in ("plain", "observed", "observed", "plain"):
                fn = plain if name == "plain" else observed
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn().item()
                wall[name].append((time.perf_counter() - t0) * 1e3)
        census = {}
        for name in ("plain", "observed", "observed", "plain"):
            census.setdefault(name, []).append(_kernel_census(
                plain if name == "plain" else observed))
        peak = {}
        for name, fn in (("plain", plain), ("observed", observed)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fn().item()
            peak[name] = torch.cuda.max_memory_allocated() / 2**30
        leaves = dict(obs_state.params)
        short = dict(list(leaves.items())[:FOLD_LEAVES])
        fold = {}
        for tree in (leaves, short):
            fsites = nx.site_names({"p": tree})
            fns = [nx.numerics_init(ncfg, sites=fsites, device=DEVICE)]

            def one(tree=tree, fns=fns):
                fns[0] = nx.numerics_observe(fns[0], ncfg, {"p": tree})
            fold[len(tree)] = _kernel_census(one, by_name=True)
    with clock("sparse"):
        sparse = nx.NumericsConfig(check_every=OBSERVED_SPARSE)
        dsparse = dx.DynamicsConfig(check_every=OBSERVED_SPARSE,
                                    local_batch=16)
        hooks = {"numerics": nx.numerics_init(sparse, sites=sites,
                                              device=DEVICE),
                 "dynamics": dx.dynamics_init(dsparse, sites=dsites,
                                              device=DEVICE)}

        def sparse_step(which):
            nonlocal obs_state
            kw = ({"numerics": (hooks[which], sparse)}
                  if which == "numerics"
                  else {"dynamics": (hooks[which], dsparse)})
            obs_state, loss, _fin, hooks[which] = app.step(
                obs_state, loss_fn, **kw)
            return loss

        off = {}
        for which in ("numerics", "dynamics"):
            sparse_step(which).item()             # step 0 folds
            off[which] = _kernel_census(lambda: sparse_step(which))
        off_plain = _kernel_census(plain)
        extra = {k: v[0] - off_plain[0] for k, v in off.items()}
        if any(v > 1 for v in extra.values()) or \
                int(hooks["numerics"].check_count) != 1:
            raise AssertionError(f"{phase}: off-step kernels beyond the "
                                 f"plain step's {extra}")
    with clock("poison"):
        victim = "TransformerLayer_0.FusedLayerNormModule_0.scale"

        poison = _poison_grad()

        def poisoned(mp):
            return loss_fn(dict(mp, **{victim: poison(mp[victim])}))

        gcfg = guard.GuardConfig(**GUARD_CFG)
        gs = guard.guard_init(gcfg, device=DEVICE)
        pns = nx.numerics_init(ncfg, sites=sites, device=DEVICE)
        _s, ploss, committed, gs, pns = app.step(
            obs_state, poisoned, guard=(gs, gcfg), numerics=(pns, ncfg))
        bad = nx.nonfinite_sites(pns, sites)
        want = _numerics_sites_of(victim)
        amax = nx.scale_amax(pns).cpu()
        row = sites.index(want)
        if [s for s, _ in bad] != [want] or not math.isinf(
                float(amax[row])) or bool(committed):
            raise AssertionError(f"{phase}: poisoned {want}: nonfinite "
                                 f"{bad}, scale_amax {float(amax[row])}, "
                                 f"committed {bool(committed)}")
    med = {k: _median(v) for k, v in wall.items()}
    ck = {k: (_median([c for c, _ in v]), _median([d for _, d in v]))
          for k, v in census.items()}
    log(f"phase {phase}: {OBSERVED_STEPS} steps through Amp.step(numerics="
        f", dynamics=): losses {[round(v, 6) for v in obs_losses]} = "
        f"bert_large_arena's and the plain run's, every param bit for bit; "
        f"hand-kernel launches a step {per_step}; {len(sites)} numerics "
        f"sites, {len(dsites)} dynamics sites; module_count_and_host_ops "
        f"of step 0: device kernels plain {plain_kernels}, observed "
        f"{obs_kernels}, host syncs plain {len(plain_syncs)}, observed "
        f"{len(obs_syncs)}"
        + ("; step 1 under set_sync_debug_mode('error')" if not plain_syncs
           else f" ({plain_syncs[:2]})")
        + f"; 0 surprises, 0 nonfinite sites; events valid")
    log(f"phase {phase}: in turns ({smi}): wall ms a step plain "
        f"{med['plain']:.3f}, observed {med['observed']:.3f}; device "
        f"kernels a step plain {ck['plain'][0]:g}, observed "
        f"{ck['observed'][0]:g} (+{ck['observed'][0] - ck['plain'][0]:g}); "
        f"device ms a step plain {ck['plain'][1]:.3f}, observed "
        f"{ck['observed'][1]:.3f} "
        f"(+{ck['observed'][1] - ck['plain'][1]:.3f}; each census "
        f"{ {k: [round(d, 3) for _, d in v] for k, v in census.items()} }"
        f"); peak GiB plain "
        f"{peak['plain']:.2f}, observed {peak['observed']:.2f}")
    top = sorted(fold[len(leaves)][2].items(), key=lambda kv: -kv[1][1])
    log(f"phase {phase}: one numerics fold alone: "
        + ", ".join(f"{n} leaves {k:g} kernels {d:.3f} device ms"
                    for n, (k, d, _) in fold.items())
        + f"; its costliest kernels at {len(leaves)} leaves: "
        + "; ".join(f"{name[:60]} x{n:g} {ms:.3f} ms"
                    for name, (n, ms) in top[:8]))
    log(f"phase {phase}: at check_every={OBSERVED_SPARSE}"
        + f": off-step kernels beyond the "
        f"plain step's {extra}, device ms "
        f"{ {k: round(v[1] - off_plain[1], 4) for k, v in off.items()} }")
    log(f"phase {phase}: NaN in the grad of {victim!r}: nonfinite_sites "
        f"{bad}, scale_amax inf in its row, the guard skipped the step")
    log(clock.line(phase))


def _jax_ordered(params):
    """The parameter names in the sites' (the JAX package's) order."""
    from apex_tpu_torch.monitor.numerics import _key_parts
    return sorted(params, key=_key_parts)


def numerics_flag_card():
    """Phase numerics_flag_card: ``scripts/numerics_audit.py``'s claim (b)
    on the card. A seeded log-uniform tensor over [2^-12, 2^-2] straddles
    e4m3's smallest normal 2^-6: flagged at its own site (unscaled e4m3
    underflow > 0.3), verdict ``fp8_e4m3`` with a recommended scale > 1;
    its sibling over [2^-4, 2^4] stays clean; the tensor scaled by the
    recommendation and measured again underflows under the threshold."""
    import numpy as np
    import torch
    from apex_tpu_torch.monitor import numerics as nx

    rng = np.random.RandomState(7)

    def signed(lo, hi):
        return torch.tensor((2.0 ** rng.uniform(lo, hi, (4096,))
                             * np.where(rng.rand(4096) < 0.5, -1.0, 1.0)
                             ).astype(np.float32), device=DEVICE)

    tiny, normal = signed(-12, -2), signed(-4, 4)
    cfg = nx.NumericsConfig()

    def measure(t):
        trees = {"probe": {"tiny": t, "normal": normal}}
        sites = nx.site_names(trees)
        ns = nx.numerics_observe(
            nx.numerics_init(cfg, sites=sites, device=DEVICE), cfg, trees)
        rep = nx.precision_report(ns, sites)
        return rep, {r.site: r for r in rep.rows}

    rep, by = measure(tiny)
    t, n = by["probe/['tiny']"], by["probe/['normal']"]
    t_u0 = t.by_format["fp8_e4m3"]["unscaled_underflow"]
    n_u0 = n.by_format["fp8_e4m3"]["unscaled_underflow"]
    rep2, by2 = measure(tiny * t.recommended_scale)
    t2 = by2["probe/['tiny']"].by_format["fp8_e4m3"]
    ok = (t_u0 > 0.3 and n_u0 <= rep.underflow_threshold
          and t.required_dtype == "fp8_e4m3" and t.recommended_scale > 1
          and t.predicted_underflow_frac <= rep.underflow_threshold
          and t2["unscaled_underflow"] <= rep.underflow_threshold
          and t2["unscaled_saturation"] <= rep.saturation_threshold)
    if not ok:
        raise AssertionError(f"numerics_flag_card: {t}, {n}, {t2}")
    log(f"phase numerics_flag_card: probe/['tiny'] flagged (unscaled e4m3 "
        f"underflow {t_u0:.4f}, sibling {n_u0:.4f}), verdict "
        f"{t.required_dtype} with scale {t.recommended_scale:g}; scaled "
        f"and measured again its underflow is "
        f"{t2['unscaled_underflow']:.6f} (threshold "
        f"{rep.underflow_threshold:g})")


def observed_rank(rank, world):
    """One rank of dynamics_two_ranks and linkbench_drift_two_ranks (gloo
    on ``cuda:0``): a depth-2 BERT (B PROBE_BATCH a rank, S512, O1 bf16,
    arena LAMB) stepped PROBE_STEPS times as backward, DDP sync,
    ``dynamics_probe``, apply, ``dynamics_observe``, with the collectives
    counted a step; the probe of replicated grads; ``collective_bytes`` of
    sync + probe; dynamics_audit's claim (a) (``gns_fold`` of
    ``tests/_torch_parallel_cases.py``: folds of mu + noise); then ``linkbench.calibrate`` → ``plan_comm`` →
    ``measure_hops`` → ``compare`` for a PLAN_BYTES sync, and ``ici``
    collective spans of that sync for the pod join."""
    import numpy as np
    import torch
    from apex_tpu_torch import parallel, trace, train
    from apex_tpu_torch.lint.mesh_model import parse_mesh_spec
    from apex_tpu_torch.monitor import comm_drift, linkbench
    from apex_tpu_torch.monitor import dynamics as dx
    from apex_tpu_torch.parallel.distributed import dynamics_probe

    mesh = parallel.data_parallel_mesh(DEVICE)
    ddp = parallel.DistributedDataParallel(mesh)
    out = {}
    t0 = time.perf_counter()
    with parallel.use_mesh(mesh):
        step, state, (toks, labels), _, _ = train.build_bert_step(
            PROBE_BATCH, 512, encoder=depth2_encoder(), strategy="arena",
            seed=rank)
        app, loss_fn = step.amp_opt, step.make_loss(toks, labels)
        cfg = dx.DynamicsConfig(local_batch=PROBE_BATCH)
        sites = app.dynamics_sites(state.params)
        ds = dx.dynamics_init(cfg, sites=sites, world=world, device=DEVICE)
        counts = []
        for _ in range(PROBE_STEPS):
            parallel.reset_collective_counts()
            loss, grads, mid, finite = app.backward(state, loss_fn)
            synced = ddp.sync(grads)
            probe = dynamics_probe(grads, synced, "data")
            new = app.apply_gradients(mid, synced, finite)
            delta = {k: new.params[k] - state.params[k] for k in grads}
            ds = dx.dynamics_observe(
                ds, cfg, {"dynamics/update": delta}, probe=probe,
                grads={"dynamics/update": synced},
                weights={"dynamics/update": state.params})
            state = new
            counts.append(dict(parallel.collective_counts))
        rep = dx.dynamics_report(ds, sites, local_batch=PROBE_BATCH)
        same = dynamics_probe(synced, synced, "data")
        grad_bytes = sum(g.numel() * g.element_size()
                         for g in grads.values())
        cb = ddp.collective_bytes(
            lambda: dynamics_probe(grads, ddp.sync(grads), "data"))
        out.update(counts=counts, gns=rep.gns, world=rep.world,
                   cos=rep.cos_spectrum, eff_lr=rep.eff_lr,
                   same_cos=(same.dots / torch.sqrt(
                       same.local_sqs * same.pooled_sq)).tolist(),
                   same_proj=(same.dots / same.local_sqs).tolist(),
                   bytes=cb, grad_bytes=grad_bytes,
                   bert_s=time.perf_counter() - t0)
        del step, state, grads, synced, new, delta, mid
        # dynamics_audit's claim (a): mu + per-replica noise, by the
        # harness the CPU tests run
        t0 = time.perf_counter()
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tests"))
        import _torch_parallel_cases as cases
        gns = cases.gns_fold(world, rank, device=DEVICE)
        out.update(gns_fold=gns["gns"], gns_true=gns["true_gns"],
                   gns_s=time.perf_counter() - t0)
        # the link model: sweep, fit, plan, measure, compare
        t0 = time.perf_counter()
        template = parse_mesh_spec(f"ici{world}",
                                   link_bytes_per_s={"ici": 1e9})
        model, fits, samples = linkbench.calibrate(mesh, template)
        plan = parallel.plan_comm(model, PLAN_BYTES)
        measured = comm_drift.measure_hops(plan, mesh)
        drift = comm_drift.compare(plan, measured)
        tracer = trace.Tracer()
        x = torch.ones(PLAN_BYTES // 4, device=DEVICE)
        group = mesh.get_group("data")
        with tracer:
            for i in range(4):
                with trace.step(i):
                    with trace.span("ici", kind="collective"):
                        parallel.collectives.all_reduce(
                            x, group, "ddp/sync_gradients")
                        torch.cuda.synchronize()
        out.update(model=model.to_json(), plan=plan.to_json(),
                   measured=measured, table=linkbench.fit_table(fits,
                                                                 samples),
                   drift=drift.to_events(), drift_table=drift.table(),
                   spans=tracer.span_events(rank),
                   link_s=time.perf_counter() - t0)
    return out


def observed_body(rank, world, tmp):
    _run_rank(observed_rank, rank, world, tmp)


def dynamics_and_links_two_ranks():
    """Phases dynamics_two_ranks and linkbench_drift_two_ranks: two gloo
    processes on the card (``observed_rank``).

    dynamics_two_ranks: each of PROBE_STEPS steps runs exactly one
    ``ddp/dynamics_gns`` and one ``ddp/dynamics_geom``; the probe of
    replicated grads reads cosine and projection 1 to 1e-5; the synced
    step's ``collective_bytes`` is the grad tree's bytes under
    ``all-reduce`` plus the probe's 4 + 8·W; on injected noise
    ``B_simple`` within 25% of the analytic ``d·σ²/|μ|²``.

    linkbench_drift_two_ranks: ``calibrate`` gives a measured MeshModel
    (finite α ≥ 0, bytes/s > 0, 9 samples) that ``plan_comm``,
    ``measure_hops`` and ``compare`` take to a drift report with one row
    a hop, and ``wire_from_pod`` joins the ``ici`` spans of both ranks'
    ``PodTimeline`` to the plan's hop; α, bytes/s and the residual are
    logged, which describe gloo through this host, not NVLink (the
    linkbench caveat)."""
    from apex_tpu_torch import parallel, trace
    from apex_tpu_torch.lint.mesh_model import MeshModel
    from apex_tpu_torch.monitor import comm_drift

    ranks = _spawn("dynamics_two_ranks", observed_body, 2)
    world = 2
    r0 = ranks[0]
    per_step = [{k: v for k, v in c.items() if "dynamics" in k}
                for r in ranks for c in r["counts"]]
    want_bytes = {"all-reduce": r0["grad_bytes"] + 4,
                  "all-gather": 8 * world,
                  "total": r0["grad_bytes"] + 4 + 8 * world}
    checks = {
        "one gns and one geom a step": all(
            c == {"ddp/dynamics_gns": 1, "ddp/dynamics_geom": 1}
            for c in per_step),
        "replicated cos = proj = 1": all(
            abs(v - 1.0) <= 1e-5 for r in ranks
            for v in r["same_cos"] + r["same_proj"]),
        "bytes": all(r["bytes"] == want_bytes for r in ranks),
        "gns within 25%": all(
            r["gns_fold"] is not None
            and abs(r["gns_fold"] - r["gns_true"]) <= 0.25 * r["gns_true"]
            for r in ranks),
        "world 2": all(r["world"] == 2.0 for r in ranks)}
    if not all(checks.values()):
        raise AssertionError(f"dynamics_two_ranks: {checks}; counts "
                             f"{per_step}, bytes {[r['bytes'] for r in ranks]}"
                             f", gns {[r['gns_fold'] for r in ranks]} vs "
                             f"{r0['gns_true']}")
    log(f"phase dynamics_two_ranks: depth-2 BERT B{PROBE_BATCH}/rank: "
        f"collectives a step {r0['counts'][-1]}; probe bytes "
        f"{r0['bytes']} (grads {r0['grad_bytes']} + 4 + 8*{world}); "
        f"replicated cos/proj 1 within 1e-5; step GNS {r0['gns']}, cos "
        f"{[round(v, 6) for v in r0['cos']]}; injected-noise B_simple "
        f"{[round(r['gns_fold'], 3) for r in ranks]} vs analytic "
        f"{r0['gns_true']:.3f}; took {r0['bert_s']:.1f} + "
        f"{r0['gns_s']:.1f} s in rank 0")
    model = MeshModel.from_json(r0["model"])
    plan = parallel.CommPlan(
        hops=tuple(parallel.Hop(**h) for h in r0["plan"]["hops"]),
        compress_block=r0["plan"]["compress_block"],
        source=r0["plan"]["source"], mesh_name=r0["plan"]["mesh"],
        grad_bytes=r0["plan"]["grad_bytes"])
    cal = model.calibration["ici"]
    pod = trace.PodTimeline.merge({r: out["spans"]
                                   for r, out in enumerate(ranks)})
    wires = comm_drift.wire_from_pod(pod, plan)
    pod_drift = None if wires is None else comm_drift.compare(plan, wires)
    checks = {
        "measured model": model.measured and cal["n_samples"] == 9,
        "finite fit": all(math.isfinite(cal[k]) for k in
                          ("alpha_us", "bytes_per_s", "residual"))
        and cal["alpha_us"] >= 0 and cal["bytes_per_s"] > 0,
        "ranks agree": all(r["model"] == r0["model"]
                           and r["measured"] == r0["measured"]
                           for r in ranks),
        "drift rows": len(r0["drift"]) == len(plan.hops)
        and all(math.isfinite(e["measured_ms"]) and e["measured_ms"] > 0
                for e in r0["drift"]),
        "pod join": wires is not None and len(wires) == len(plan.hops)
        and all(math.isfinite(w) and w > 0 for w in wires)}
    if not all(checks.values()):
        raise AssertionError(f"linkbench_drift_two_ranks: {checks}; "
                             f"{r0['table']}\n{r0['drift_table']}")
    log(f"phase linkbench_drift_two_ranks: gloo on this host, not NVLink: "
        f"alpha {cal['alpha_us']} us, {cal['bytes_per_s']:.4g} bytes/s, "
        f"residual {cal['residual']}; plan {plan.describe()}; measured "
        f"{[round(v * 1e3, 4) for v in r0['measured']]} ms vs predicted "
        f"{[round(v * 1e3, 4) for v in plan.hop_seconds()]} ms (drift "
        f"{[e['ratio'] for e in r0['drift']]}); pod wire "
        f"{[round(w * 1e3, 4) for w in wires]} ms (drift "
        f"{[round(h.ratio, 4) for h in pod_drift.hops]}); took "
        f"{r0['link_s']:.1f} s in rank 0")


def _mlp_run(seed, steps, lr_scale=1.0):
    """``steps`` losses of the DLRM bottom MLP step (B2048, O2 bf16, ASP
    with arena FusedAdam) on seed 0's batch from weights drawn with
    ``seed`` (paired seeds: the same data, another init), the Adam lr
    scaled by ``lr_scale``; counts row 14's launches."""
    from apex_tpu_torch import ops, train
    from apex_tpu_torch.optim import FusedAdam

    class Scaled(FusedAdam):
        def __init__(self, lr=1e-3, **kw):
            super().__init__(lr=lr * lr_scale, **kw)

    saved, train.FusedAdam = train.FusedAdam, Scaled
    try:
        step, state, (x, t), _, _ = train.build_mlp_step(
            2048, model=ops.MLP(MLP_BOTTOM, device=DEVICE, seed=seed))
    finally:
        train.FusedAdam = saved
    ops.reset_launch_counts()
    losses = []
    for _ in range(steps):
        state, loss = step(state, x, t)
        losses.append(loss.item())
    return losses, ops.launch_counts()


def convergence_mlp():
    """Phase convergence_mlp: the DLRM bottom MLP (B2048, O2 bf16,
    ``ASP(FusedAdam(lr=1e-3), "m4n2_1d")``, row 14 launched once a step)
    for CONV_STEPS steps on one batch from the weights of each of
    CONV_SEEDS; ``calibrate_band`` of those runs (z=8); seed 0 through ``plain_versions()`` against seed 0
    through the kernels passes (``convergence_report``, grace 5); seed 0
    with the learning rate x10 is flagged, its ``first_flag_step``
    logged; the verdicts pass the schema script."""
    from apex_tpu_torch.monitor import convergence as cv

    runs = []
    for seed in CONV_SEEDS:
        losses, counts = _mlp_run(seed, CONV_STEPS)
        if counts.get("mlp_fwd") != CONV_STEPS:
            raise AssertionError(f"convergence_mlp: seed {seed} launches "
                                 f"{counts}")
        runs.append(losses)
    with plain_versions():
        plain, counts = _mlp_run(0, CONV_STEPS)
    if counts.get("mlp_fwd", 0):
        raise AssertionError(f"convergence_mlp: plain run launched {counts}")
    hot, _ = _mlp_run(0, CONV_STEPS, lr_scale=10.0)
    band = cv.calibrate_band(runs, z=8)
    same = cv.convergence_report(runs[0], plain, band=band, grace=5)
    jolt = cv.convergence_report(runs[0], hot, band=band, grace=5)
    if not same.ok or jolt.ok:
        raise AssertionError(f"convergence_mlp: {same.summary()}; "
                             f"{jolt.summary()}")
    path = _write_events([same.to_event(), jolt.to_event()], "convergence")
    try:
        _schema(path, "dynamics")
    finally:
        os.remove(path)
    log(f"phase convergence_mlp: band {band.threshold:.6g} (median gap "
        f"{band.median_gap:.6g}, MAD {band.mad_gap:.6g}, z 8, "
        f"{band.n_pairs} pairs x {band.n_steps} steps); plain vs kernels: "
        f"{same.summary()}; lr x10: {jolt.summary()} (first_flag_step "
        f"{jolt.first_flag_step})")


# --- prof/: the profiled, memory, compile-watch and example phases ---------

#: on-path hand kernels whose roofline bound must equal their kernel row's
PROFILED_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "xentropy_fwd",
                    "xentropy_bwd", "flash_attn_fwd", "flash_attn_bwd",
                    "multi_tensor_l2norm", "lamb_stage1", "lamb_stage2")
PROFILED_ITERS = 3            # profiled steps (after 2 warm-up steps)
#: the H100 SXM's L2 cache (50 MB): an op whose operands fit may read them
#: from L2, which its HBM bound does not price
L2_BYTES = 50 << 20
#: leading dimensions of BERT-Large's batch-scaled buffers at B16 S512:
#: the batch, the token rows and the (batch * heads) rows of the lse
BERT_BATCH_LEADS = (16, 16 * 512, 16 * 16)


def bert_analytic_flops(enc, batch, seq, heads):
    """FLOPs of one BERT training step's GEMMs and attention: 6 x tokens x
    the matmul weights (every 2-D weight but the position embedding, plus
    the token embedding once, as the tied decoder), and 14·B·H·S²·D a
    layer of attention (4 forward, 10 backward)."""
    weights = sum(p.numel() for n, p in enc.named_parameters()
                  if p.dim() == 2 and "emb" not in n)
    weights += enc.tok_emb.weight.numel()
    d = enc.hidden // heads
    attn = 14 * enc.layers * batch * heads * seq * seq * d
    return 6 * batch * seq * weights + attn


def hook_host_us(turns=4, n=2000):
    """Host µs of one launch of the LayerNorm forward through its priced
    wrapper and through the function it wraps (the wrapper without the
    cost hook: the parent's code), off a profiler, medians of ``turns``
    timings of ``n`` launches taken in turns (hooked, raw, raw, hooked,
    ...) on a (64, 1024) bf16 input, each timing ended before the card
    can fall behind."""
    import statistics
    import torch
    from apex_tpu_torch.ops import layer_norm as L
    dev = torch.device("cuda")
    x = torch.randn(64, 1024, device=dev).to(torch.bfloat16)
    w, b = torch.ones(1024, device=dev), torch.zeros(1024, device=dev)
    fns = {"hooked": L.ln_fwd_kernel, "raw": L.ln_fwd_kernel.__wrapped__}
    times = {k: [] for k in fns}
    for t in range(turns):
        order = ("hooked", "raw") if t % 2 == 0 else ("raw", "hooked")
        for name in order:
            fn = fns[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn(x, w, b, 1e-12)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            times[name].append((t1 - t0) / n * 1e6)
    return {k: statistics.median(v) for k, v in times.items()}


def bert_large_profiled(smi, rows):
    """Phase bert_large_profiled: ``prof.profile_step`` on the arena
    BERT-Large step (B16, S512, O1 bf16, FusedLAMB arena; 2 warm-up and
    PROFILED_ITERS profiled steps, on its own state). Gates: every hand
    kernel of the path launched the arena step's count a step, in every
    run profile_step made and in the profiled window; the report's device
    ms within 3% of ``device_ms`` of the same step (over 2 steps);
    ``roofline_report``'s closure within 5% of the window's kernel time;
    no row's raw efficiency (attainable / measured) above 1.05, but for a
    memory-bound aten op whose operands fit the L2 (L2_BYTES: the kernel
    before it may have left them there, and the HBM bound does not price
    an L2 read; logged); each hand kernel's attainable time its kernel
    row's bound (within 1e-4 ms); the flops
    ``MetricsLogger.attach`` takes from one run within 1% of the step's
    GEMMs and attention (``bert_analytic_flops``); ``python -m
    apex_tpu_torch.prof`` on the kept trace exits 0 with gemm and
    flash_attn categories. Logged: MFU on wall and device time,
    ``by_family``, ``worst_gaps(5)``."""
    import tempfile
    import torch
    from apex_tpu_torch import monitor, ops, prof, train

    phase = "bert_large_profiled"
    clock = _Clock()
    with clock("build"):
        step, state, (toks, labels), _p, enc = train.build_bert_step(
            16, 512, strategy="arena")
    per_step = dict(EXPECTED_PER_STEP, **ARENA_PER_STEP)
    holder = [state]
    del state

    def run():
        holder[0], loss = step(holder[0], toks, labels)
        return loss

    with clock("device_ms"):
        dev_ms = device_ms(run, iters=2)
    logdir = tempfile.mkdtemp(prefix="chip_smoke_prof_")
    try:
        ops.reset_launch_counts()
        with clock("profile_step"):
            rep = prof.profile_step(run, iters=PROFILED_ITERS, warmup=2,
                                    logdir=logdir)
        counts = ops.launch_counts()
        runs = {name: counts[name] / n for name, n in per_step.items()}
        if (len(set(runs.values())) != 1
                or any(r != int(r) or r < 1 for r in runs.values())
                or any(v for k, v in counts.items() if k not in per_step)):
            raise AssertionError(f"{phase}: launches {counts} are not a "
                                 f"whole number of arena steps {per_step}")
        with clock("roofline"):
            roof = prof.roofline_report(rep)
        ranges = {}
        for r in roof.rows:
            if r.opcode.startswith("apex_tpu_torch::"):
                k = r.opcode.split("::", 1)[1]
                ranges[k] = ranges.get(k, 0) + r.occurrences
        want = {k: v * PROFILED_ITERS for k, v in per_step.items()}
        if ranges != want:
            raise AssertionError(f"{phase}: kernel calls in the profiled "
                                 f"window {ranges}, expected {want}")
        rep_ms = rep.device_us / 1e3
        if not abs(rep_ms - dev_ms) <= 0.03 * dev_ms:
            raise AssertionError(f"{phase}: profile_step device "
                                 f"{rep_ms:.3f} ms vs device_ms "
                                 f"{dev_ms:.3f} ms (limit 3%)")
        ok, err = roof.check_closure(0.05)
        if not ok:
            raise AssertionError(f"{phase}: roofline closure error "
                                 f"{err:.4f} > 0.05")
        def l2_served(r):
            est = rep.counter.ops.get(r.name)
            return (r.bound == "memory" and est is not None
                    and not r.opcode.startswith("apex_tpu_torch::")
                    and est.in_bytes <= L2_BYTES)

        above = sorted((r for r in roof.rows
                        if (r.raw_efficiency or 0.0) > 1.05),
                       key=lambda r: -r.raw_efficiency)
        high = [r for r in above if not l2_served(r)]
        for r in above[:10]:
            log(f"{phase}: row above its bound"
                f"{' (operands fit the L2)' if l2_served(r) else ''}: "
                f"{r.name[:90]} "
                f"({r.family}, {r.bound}) raw efficiency "
                f"{r.raw_efficiency:.3f}: measured {r.measured_us:.2f} us, "
                f"attainable {r.attainable_us:.2f} us, {r.bytes:.0f} B, "
                f"{r.flops:.3g} flops, kernels {r.hlo[:80]}")
        for name in PROFILED_KERNELS:
            krows = [r for r in roof.rows
                     if r.opcode == f"apex_tpu_torch::{name}"]
            if len(krows) != 1:
                raise AssertionError(f"{phase}: {len(krows)} roofline rows "
                                     f"for {name}")
            att = krows[0].attainable_us / 1e3
            bound = rows[name]["bound_ms"]
            if not abs(att - bound) <= 1e-4:
                raise AssertionError(f"{phase}: {name} attainable "
                                     f"{att:.6f} ms vs its kernel row's "
                                     f"bound {bound:.6f} ms")
            log(f"{phase}: {name}: {krows[0].occurrences} calls, measured "
                f"{krows[0].measured_us / 1e3:.4f} ms a call, attainable "
                f"{att:.4f} ms = kernel row bound {bound:.4f} ms")
        with clock("attach"):
            logger = monitor.MetricsLogger(sinks=[])
            logger.attach(run)
            logger.close()
        analytic = bert_analytic_flops(enc, 16, 512, 16)
        rel = abs(logger.flops_per_step - analytic) / analytic
        if not rel <= 0.01:
            raise AssertionError(f"{phase}: attach flops "
                                 f"{logger.flops_per_step:.6g} vs analytic "
                                 f"{analytic:.6g} (rel {rel:.2e} > 1%)")
        with clock("cli"):
            cli = subprocess.run(
                [sys.executable, "-m", "apex_tpu_torch.prof", logdir,
                 "--top", "15"], capture_output=True, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__)), timeout=300)
        if cli.returncode != 0 or "gemm" not in cli.stdout \
                or "flash_attn" not in cli.stdout:
            raise AssertionError(f"{phase}: python -m apex_tpu_torch.prof "
                                 f"rc {cli.returncode}: {cli.stdout[-800:]}"
                                 f" {cli.stderr[-800:]}")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    if high:
        raise AssertionError(f"{phase}: {len(high)} roofline rows above "
                             f"1.05 of their bound")
    fams = roof.by_family()
    log(f"{phase}: {smi}: device {rep_ms:.3f} ms a step (device_ms "
        f"{dev_ms:.3f}), wall {rep.wall_us / 1e3:.3f} ms; "
        f"{len(rep.profile.kernels) // PROFILED_ITERS} kernels a step; "
        f"closure error {err:.5f}; flops a step {rep.cost['flops']:.6g} "
        f"counted, {logger.flops_per_step:.6g} by attach, analytic "
        f"{analytic:.6g} (rel {rel:.2e}); MFU {rep.mfu(on='wall'):.4f} on "
        f"wall time, {rep.mfu():.4f} on device time (peak "
        f"{prof.device_peak_flops():.3g} FLOP/s)")
    log(f"{phase}: by_family (ms a step, efficiency): " + ", ".join(
        f"{k} {v['measured_us'] / 1e3 / PROFILED_ITERS:.3f}"
        f"@{v['efficiency']}" for k, v in fams.items()))
    log(f"{phase}: by_category (ms a step): " + ", ".join(
        f"{k} {v / 1e3 / PROFILED_ITERS:.3f}"
        for k, v in rep.by_category().items()))
    for g in roof.worst_gaps(5):
        log(f"{phase}: worst gap {g['gap_us'] / PROFILED_ITERS / 1e3:.3f} "
            f"ms a step: {g['op'][:100]} ({g['family']}, {g['bound']}, "
            f"x{g['occurrences'] // PROFILED_ITERS} a step, measured "
            f"{g['measured_us']:.2f} us, attainable "
            f"{g['attainable_us']:.2f} us, efficiency {g['efficiency']})")
    with clock("hook_cost"):
        hook = hook_host_us()
    calls = sum(per_step.values())
    extra_ms = (hook["hooked"] - hook["raw"]) * calls / 1e3
    log(f"{phase}: {smi}: the cost hook off a profiler: "
        f"{hook['hooked']:.3f} µs a LayerNorm-forward launch through the "
        f"priced wrapper vs {hook['raw']:.3f} µs without it (medians of 4 "
        f"turns of 2000 launches); {calls} priced calls a step -> "
        f"{extra_ms:.4f} ms of host time a step, "
        f"{100 * extra_ms / (rep.wall_us / 1e3):.3f}% of the "
        f"{rep.wall_us / 1e3:.3f} ms step")
    log(clock.line(phase))


def _state_bytes(*trees):
    """Bytes of the distinct storages under ``trees``."""
    from apex_tpu_torch.ckpt.snapshot import tree_paths
    seen, total = set(), 0
    for tree in trees:
        for _, leaf in tree_paths(tree):
            if hasattr(leaf, "untyped_storage"):
                st = leaf.untyped_storage()
                if st.data_ptr() not in seen:
                    seen.add(st.data_ptr())
                    total += st.nbytes()
    return total


def _measured_peak(step, state, toks, labels):
    """(new state, peak bytes the step held: the allocator's peak over the
    step less what was allocated before it, plus the state and inputs)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, loss = step(state, toks, labels)
    loss.item()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return state, peak - before


def bert_large_memory(smi, rows):
    """Phase bert_large_memory: ``prof.memory_report`` of the arena
    BERT-Large step (B16, S512), after one warm-up step. Gates: the
    classes (the footprint at the peak) sum exactly to the tracked total;
    the tracked arguments are the state and inputs; the peak-live estimate
    within
    10% of what the step held by the allocator (its
    ``max_memory_allocated`` after ``reset_peak_memory_stats``, less what
    was allocated before the step, plus the state and inputs, which the
    estimate counts); ``forecast(32)`` within 10% of a B32 step's measured
    peak, the same way; ``sample_memory`` emits a ``kind="memory"`` event
    with every value set, and the stream (with the report's event) passes
    ``scripts/check_metrics_schema.py --kind memory``."""
    import tempfile
    import torch
    from apex_tpu_torch import monitor, prof, train

    phase = "bert_large_memory"
    clock = _Clock()
    with clock("build"):
        step, state, (toks, labels), _p, _e = train.build_bert_step(
            16, 512, strategy="arena")
        state, _ = step(state, toks, labels)
    with clock("measured"):
        state, held = _measured_peak(step, state, toks, labels)
    args_bytes = _state_bytes(state, toks, labels)
    with clock("memory_report"):
        rep = prof.memory_report(step, state, toks, labels, batch_size=16,
                                 batch_leads=BERT_BATCH_LEADS)
    if rep.attributed_total() != rep.total_bytes:
        raise AssertionError(f"{phase}: classes {rep.attributed_total()} "
                             f"!= total {rep.total_bytes}")
    if rep.stats["argument"] != args_bytes:
        raise AssertionError(f"{phase}: tracked arguments "
                             f"{rep.stats['argument']} != state + inputs "
                             f"{args_bytes}")
    measured = held + args_bytes
    err = abs(rep.peak_live_bytes - measured) / measured
    log(rep.table(top=8))
    if not err <= 0.10:
        raise AssertionError(f"{phase}: peak-live estimate "
                             f"{rep.peak_live_bytes} vs measured {measured} "
                             f"bytes (rel {err:.3f} > 0.10)")
    fc = rep.forecast(32)
    del state, step, toks, labels
    torch.cuda.empty_cache()
    with clock("b32"):
        step, state, (toks, labels), _p, _e = train.build_bert_step(
            32, 512, strategy="arena")
        state, _ = step(state, toks, labels)
        state, held32 = _measured_peak(step, state, toks, labels)
        measured32 = held32 + _state_bytes(state, toks, labels)
    del state, step, toks, labels
    torch.cuda.empty_cache()
    err32 = abs(fc["peak_bytes"] - measured32) / measured32
    if not err32 <= 0.10:
        raise AssertionError(f"{phase}: forecast(32) {fc['peak_bytes']} vs "
                             f"a B32 step's {measured32} bytes (rel "
                             f"{err32:.3f} > 0.10)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mem_")
    try:
        path = os.path.join(tmp, "memory.jsonl")
        logger = monitor.MetricsLogger(sinks=[],
                                       memory_sink=monitor.JSONLSink(path))
        sample = logger.sample_memory(step=0)
        logger.attach_memory_report(rep)
        logger.close()
        if any(sample[k] is None for k in ("bytes_in_use",
                                           "peak_bytes_in_use",
                                           "bytes_limit")):
            raise AssertionError(f"{phase}: memory sample {sample}")
        chk = subprocess.run(
            [sys.executable, "scripts/check_metrics_schema.py", "--kind",
             "memory", path], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)), timeout=120)
        if chk.returncode != 0:
            raise AssertionError(f"{phase}: schema check rc "
                                 f"{chk.returncode}: {chk.stdout[-600:]} "
                                 f"{chk.stderr[-600:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gib = 1 << 30
    log(f"{phase}: {smi}: peak-live estimate {rep.peak_live_bytes / gib:.3f}"
        f" GiB vs measured {measured / gib:.3f} GiB (rel {err:.4f}); "
        f"classes at the peak (GiB): " + ", ".join(
            f"{k} {v / gib:.3f}" for k, v in rep.classes.items())
        + f"; {rep.stats['allocated'] / gib:.3f} GiB of temps allocated "
        f"over the step; batch-scaled {rep.batch_bytes / gib:.3f} GiB; "
        f"forecast(32) "
        f"{fc['peak_bytes'] / gib:.3f} GiB vs a B32 step's "
        f"{measured32 / gib:.3f} GiB (rel {err32:.4f}); max batch "
        f"{rep.max_batch()} of {rep.hbm_limit / gib:.1f} GiB; sample "
        f"{sample['bytes_in_use']} bytes in use")
    log(clock.line(phase))


def compile_watch_child():
    """The compile_watch_card child (a fresh process, so Triton's JIT runs
    here): a depth-2 BERT (B16, full width, arena) stepped at S 512, 512,
    512, 384, 384 through ``CompileWatcher.watch`` under a Tracer and a
    GoodputLedger. Prints one JSON line: the compiles of each call, the
    retraces, each step's ``recompile`` bucket and the process counters."""
    import torch
    from apex_tpu_torch import monitor, prof, trace, train
    torch.cuda.set_device(0)
    step, state, (toks, labels), _p, _e = train.build_bert_step(
        16, 512, encoder=depth2_encoder(), strategy="arena")
    watcher = prof.CompileWatcher(warn_after=1)
    wstep = watcher.watch(step, "bert_step")
    tracer = trace.Tracer()
    ledger = monitor.GoodputLedger(tracer)
    seqs = (512, 512, 512, 384, 384)
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with tracer:
            for i, s in enumerate(seqs):
                with trace.step(i):
                    with trace.span("dispatch"):
                        state, loss = wstep(state, toks[:, :s].contiguous(),
                                            labels[:, :s].contiguous())
                        loss.item()
    rec = watcher["bert_step"]
    print(json.dumps({
        "per_call": rec.per_call, "n_traces": rec.n_traces,
        "retraces": rec.retraces,
        "recompile_ms": [st.buckets["recompile"] for st in ledger.steps],
        "closure": ledger.check_closure()[0],
        "warned": [str(w.message) for w in caught
                   if "compile_watch" in str(w.message)],
        "process": prof.global_counters(), "report": watcher.report()}))


def compile_watch_card(smi, rows):
    """Phase compile_watch_card: ``compile_watch_child`` in a child
    process. Gates: the first step JIT-compiles Triton specializations
    (> 0 compiles) and the next two compile nothing; the S 512 -> 384 call
    is a retrace whose report names the changed arguments (``[0][1]`` and
    ``[0][2]``, the tokens and labels); the warning fires after it; the
    goodput ``recompile`` bucket is > 0 on exactly the steps that compiled
    and 0 on the others; the ledger closes."""
    phase = "compile_watch_card"
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
         "import chip_smoke; chip_smoke.compile_watch_child()"],
        capture_output=True, text=True, cwd=root, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{phase}: child rc {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    per_call, rc = res["per_call"], res["recompile_ms"]
    if not (per_call[0] > 0 and per_call[1] == 0 and per_call[2] == 0):
        raise AssertionError(f"{phase}: compiles a call {per_call}")
    changed = res["retraces"][0]["changed"] if res["retraces"] else ""
    if (res["n_traces"] != 2 or len(res["retraces"]) != 1
            or res["retraces"][0]["call"] != 4
            or "[0][1]: ((16, 512), 'int64') -> ((16, 384), 'int64')"
            not in changed or "[0][2]" not in changed or not res["warned"]):
        raise AssertionError(f"{phase}: retraces {res['retraces']}, "
                             f"traces {res['n_traces']}, warned "
                             f"{res['warned']}")
    if any((ms > 0) != (n > 0) for ms, n in zip(rc, per_call)):
        raise AssertionError(f"{phase}: recompile bucket {rc} vs compiles "
                             f"{per_call}")
    if not res["closure"]:
        raise AssertionError(f"{phase}: goodput ledger does not close")
    log(f"{phase}: {smi}: compiles a call {per_call} (S 512 x3, 384 x2); "
        f"recompile bucket ms a step {[round(x, 1) for x in rc]}; retrace "
        f"at call 4: {changed}; process {res['process']}")


def simple_distributed_example(smi, rows):
    """Phase simple_distributed_example: ``scripts/torch_simple_distributed
    .py`` (amp O1 + DDP + FusedSGD, ``logger.attach``) 20 steps at NCCL
    world 1 and as two gloo ranks on ``cuda:0``. Gates: each run exits 0;
    the printed ``collective_bytes_per_step`` is the DDP gradient bytes
    (65600: w 1024x16 and b 16, f32) plus the logged loss's mean (4);
    the MFU column holds numbers (not n/a); both ranks end on the world-1
    run's final loss within 2e-3 relative (the same global batch; the
    O1 bf16 GEMMs over 64 and over 32 rows may round apart)."""
    import tempfile
    phase = "simple_distributed_example"
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_simple_")
    script = os.path.join(root, "scripts", "torch_simple_distributed.py")
    base = [sys.executable, script, "--steps", "20", "--log-every", "10"]
    try:
        procs = [subprocess.Popen(
            base + ["--dist-url", f"file://{tmp}/s1", "--world-size", "1",
                    "--rank", "0"], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=root)]
        procs += [subprocess.Popen(
            base + ["--dist-url", f"file://{tmp}/s2", "--world-size", "2",
                    "--rank", str(r), "--backend-device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=root) for r in range(2)]
        outs = []
        for p in procs:
            try:
                out, errs = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            if p.returncode != 0:
                raise AssertionError(f"{phase}: rc {p.returncode}: "
                                     f"{errs[-1500:]}")
            outs.append(out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    finals = []
    for i, out in enumerate(outs):
        lines = out.strip().splitlines()
        cb = [l for l in lines if l.startswith("collective_bytes_per_step")]
        if not cb or not cb[0].startswith(
                "collective_bytes_per_step: 65604 (DDP gradient bytes 65600"):
            raise AssertionError(f"{phase}: run {i}: {cb}")
        head = [l for l in lines if l.split()[:1] == ["step"]]
        table = lines[lines.index(head[0]) + 1:]
        mfu_col = head[0].split().index("mfu")
        vals = [l.split()[mfu_col] for l in table
                if l.split() and l.split()[0].isdigit()]
        if not vals or any(v == "n/a" for v in vals[1:]):
            raise AssertionError(f"{phase}: run {i}: mfu column {vals}")
        finals.append(float(lines[-1].split("=")[-1]))
    for f in finals[1:]:
        # bf16 GEMMs at 64 and 32 rows may round apart: 2e-3 relative
        if not abs(f - finals[0]) <= 2e-3 * abs(finals[0]):
            raise AssertionError(f"{phase}: final losses {finals}")
    log(f"{phase}: {smi}: world 1 (NCCL) and 2 (gloo) runs print "
        f"collective_bytes_per_step 65604 (65600 gradient + 4 loss), mfu "
        f"column {vals[-1]} (rank 1 of 2, last step); final losses "
        f"{finals}")


# --- the autotuner, its DB and the link probe on the card -------------------

#: BERT-Large's consults a step of the families with a committed entry:
#: 49 + 49 LayerNorm launches, the cross-entropy's 2, the arena LAMB's 3
TUNED_CONSULTS_PER_STEP = {"layer_norm": 98, "xentropy": 2, "optimizer": 3}
TUNED_STEPS = 5


def _tune_script():
    """``scripts/torch_kernel_tune.py`` as a module (its launchers)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "torch_kernel_tune.py")
    spec = importlib.util.spec_from_file_location("torch_kernel_tune", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def autotune_mode(mode):
    """``APEX_TPU_AUTOTUNE=mode`` inside the block."""
    prev = os.environ.get("APEX_TPU_AUTOTUNE")
    os.environ["APEX_TPU_AUTOTUNE"] = mode
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("APEX_TPU_AUTOTUNE", None)
        else:
            os.environ["APEX_TPU_AUTOTUNE"] = prev


def autotune_db(smi):
    """Phase autotune_db: the committed ``scripts/torch_kernel_tuning_db.json``
    loads stale-free with every entry under this card's ``chip_kind``; at
    each entry's shape exactly the kernels its sweep timed (the ones the
    main path consults there, ``torch_kernel_tune.launcher``) consult it
    and hit, match their plain versions at the kernel rows' tolerances
    (f32 TOL_ARENA for the arena kernels, else TOL32; 16-bit TOL16) and
    themselves bit for bit on a second launch; each tuned knob's device
    time beside the default's (``autotune.sweep_entry`` over the two, in
    alternating pairs). Returns the DB."""
    import torch
    from apex_tpu_torch.ops import autotune

    tune = _tune_script()
    db = autotune.TuningDB.load(tune.DB_PATH)
    chip = autotune.chip_kind()
    fams = {e.family for e in db.entries.values()}
    if not db.entries or any(e.chip != chip for e in db.entries.values()) \
            or not set(tune.TUNED_FAMILIES) <= fams:
        raise AssertionError(f"autotune_db: the committed DB does not cover "
                             f"{tune.TUNED_FAMILIES} on {chip}: "
                             f"{sorted(db.entries)}")
    flush = tune.flusher()
    with autotune_mode("db"), autotune.use_db(db):
        for fp, e in sorted(db.entries.items()):
            kernels = e.sweep.get("kernels")
            run, plain = tune.launcher(e.family, e.dims, e.dtype, kernels)
            autotune.reset_counters()
            got = run()
            consults = autotune.recent_consults()
            if not consults or any(c != (fp, True) for c in consults):
                raise AssertionError(f"autotune_db: {fp}: consults "
                                     f"{consults}, not each a hit")
            if not all(torch.equal(a, b) for a, b in zip(got, run())):
                raise AssertionError(f"autotune_db: {fp}: two tuned "
                                     f"launches differ")
            tol = TOL_ARENA if e.family == "optimizer" else TOL32
            err = compare(f"autotune_db {fp}", got, plain(), tol)
            default = autotune.candidate_grid(e.family, e.dims, e.dtype)[0]
            cmp = autotune.sweep_entry(e.family, e.dims, e.dtype, run,
                                       candidates=[default, e.block],
                                       flush=flush).sweep
            now = (f"device {cmp['candidates'][0]['us']} us tuned vs "
                   f"{cmp['default_us']} us default now, won "
                   f"{cmp['candidates'][0]['wins']} of {cmp['pairs']} "
                   f"pairs" if cmp["candidates"] else
                   f"device {cmp['default_us']} us now (the default)")
            log(f"phase autotune_db: {fp} ({', '.join(kernels)}): knobs "
                f"{e.block} (default {default}; swept "
                f"{e.sweep['default_us']} -> {e.sweep['best_us']} us, won "
                f"{e.sweep['won']}): {now}; {len(consults)} consults, all "
                f"hits; max_abs_err {err:.3e}; {smi}")
            del run, plain, got
            torch.cuda.empty_cache()
    return db


def check_db_consults(phase, fps):
    """Under the default ``APEX_TPU_AUTOTUNE=db``: every consult since the
    counters' reset hit exactly when the committed DB holds its key, and
    each of ``fps`` that the DB holds was hit. Returns the fingerprints
    that hit."""
    from apex_tpu_torch.ops import autotune
    if autotune.mode() != "db":
        raise AssertionError(f"{phase}: runs with APEX_TPU_AUTOTUNE="
                             f"{autotune.mode()}, not the default db")
    db = autotune.active_db()
    recent = set(autotune.recent_consults())
    wrong = {(fp, hit) for fp, hit in recent
             if hit != (db.lookup(fp) is not None)}
    hits = {fp for fp, hit in recent if hit}
    missing = {fp for fp in fps if db.lookup(fp) is not None} - hits
    if wrong or missing:
        raise AssertionError(f"{phase}: consults {sorted(recent)}; wrong "
                             f"{sorted(wrong)}, DB keys not hit "
                             f"{sorted(missing)}")
    log(f"phase {phase}: autotune db, {autotune.counters()} consults, hits "
        f"{ {fp: db.lookup(fp).block for fp in sorted(hits)} }")
    return hits


ZERO_SHARD_STEPS = 2


def zero_shard_rank(rank, world):
    """One rank of bert_large_zero_two_ranks: BERT-Large (B16 S512, O1
    bf16, every rank the same seeded batch) ZERO_SHARD_STEPS steps of
    ``DistributedFusedLAMB(lr=1e-3)`` on its half of the f32 partition,
    with the default ``APEX_TPU_AUTOTUNE=db``. Returns the losses, the
    shard's length, the kernels' launches and the consults (each checked
    against the committed DB: a hit exactly where it holds the key)."""
    import torch
    from apex_tpu_torch import ops, parallel, train
    from apex_tpu_torch.ops import autotune
    from apex_tpu_torch.optim import DistributedFusedLAMB

    os.environ["APEX_TPU_AUTOTUNE"] = "db"
    with parallel.use_mesh(parallel.data_parallel_mesh()):
        step, state, (toks, labels), _, _ = train.build_bert_step(
            16, 512, optimizer=DistributedFusedLAMB(lr=1e-3))
        ops.reset_launch_counts()
        autotune.reset_counters()
        losses = []
        for _ in range(ZERO_SHARD_STEPS):
            state, loss = step(state, toks, labels)
            losses.append(loss.item())
    db = autotune.active_db()
    recent = set(autotune.recent_consults())
    return {"losses": losses,
            "shard": state.opt_state.slots["master"]["float32"].numel(),
            "counts": dict(ops.launch_counts()),
            "counters": autotune.counters(),
            "hits": sorted(fp for fp, hit in recent if hit),
            "wrong": sorted((fp, hit) for fp, hit in recent
                            if hit != (db.lookup(fp) is not None))}


def zero_shard_body(rank, world, tmp):
    _run_rank(zero_shard_rank, rank, world, tmp)


def bert_large_zero_two_ranks(arena_losses, smi):
    """Phase bert_large_zero_two_ranks: BERT-Large's ZeRO at world size 2
    (two gloo processes on the card), as users run it, with the default
    ``APEX_TPU_AUTOTUNE=db``: each rank's update consults the committed DB
    at its shard of the f32 partition (``_padded_len(n, 2) / 2``) and
    hits where the DB holds it, every other consult a hit exactly where
    the DB holds its key; the ranks' losses equal bit for bit and within
    1e-3 relative of bert_large_arena's (the same batch on both ranks:
    the mean gradient is the whole batch's); each kernel's launches a step
    bert_large_zero's."""
    from apex_tpu_torch.ops import autotune

    t0 = time.perf_counter()
    ranks = _spawn("bert_large_zero_two_ranks", zero_shard_body, 2,
                   timeout_s=600)
    shard = ranks[0]["shard"]
    fp = autotune.fingerprint("optimizer", (shard,), "float32")
    db = autotune.active_db()
    for r, res in enumerate(ranks):
        check_launches(f"bert_large_zero_two_ranks rank {r}", res["counts"],
                       dict(EXPECTED_PER_STEP, **ZERO_PER_STEP), None,
                       ZERO_SHARD_STEPS)
        if res["wrong"] or res["shard"] != shard or (
                db.lookup(fp) is not None and fp not in res["hits"]):
            raise AssertionError(f"bert_large_zero_two_ranks rank {r}: "
                                 f"shard {res['shard']}, hits "
                                 f"{res['hits']}, wrong {res['wrong']}")
    losses = ranks[0]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, arena_losses))
    if ranks[1]["losses"] != losses or not rel <= 1e-3:
        raise AssertionError(f"bert_large_zero_two_ranks: losses "
                             f"{[r['losses'] for r in ranks]} vs the arena "
                             f"run's {arena_losses}: rel {rel:.2e}")
    log(f"phase bert_large_zero_two_ranks: a rank's shard {shard} "
        f"elements of the f32 partition, consults "
        f"{ranks[0]['counters']} a rank, hits "
        f"{ {h: db.lookup(h).block for h in ranks[0]['hits']} }; losses "
        f"{losses} (both ranks bit for bit), within {rel:.2e} relative of "
        f"bert_large_arena's (limit 1e-3); launches a step "
        f"bert_large_zero's; {time.perf_counter() - t0:.1f} s; {smi}")


def consult_host_us(n=20000):
    """Host µs of one cached consult (``autotune.launch_knobs`` of a key
    already answered), the median of 5 runs of ``n`` calls."""
    from apex_tpu_torch.ops import autotune
    autotune.launch_knobs("optimizer", (65536,), "float32")
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            autotune.launch_knobs("optimizer", (65536,), "float32")
        runs.append((time.perf_counter() - t0) / n * 1e6)
    return _median(runs)


def bert_large_tuned(rows, arena_losses, db, smi):
    """Phase bert_large_tuned: BERT-Large (B16 S512, O1 bf16, arena
    FusedLAMB) TUNED_STEPS steps with ``APEX_TPU_AUTOTUNE=off`` and with
    ``db`` against the committed DB: the off run's losses equal
    bert_large_arena's bit for bit, the tuned run's within its 1e-3
    relative of them, the kernels' launches a step those of the arena run
    (rows 1-6, 15a-c) in both, and the tuned run's consults hit the DB at
    TUNED_CONSULTS_PER_STEP a step (the attention's miss: no entry). Device
    ms a step of both (one profiled step each) and the consult's host cost
    a step."""
    import torch
    from apex_tpu_torch import ops, train
    from apex_tpu_torch.ops import autotune

    per_step = dict(EXPECTED_PER_STEP, **ARENA_PER_STEP)
    out = {}
    for mode in ("off", "db"):
        torch.cuda.empty_cache()
        with autotune_mode(mode), autotune.use_db(db):
            step, state, (toks, labels), _, _ = train.build_bert_step(
                16, 512, strategy="arena")
            ops.reset_launch_counts()
            autotune.reset_counters()
            losses = []
            for _ in range(TUNED_STEPS):
                state, loss = step(state, toks, labels)
                losses.append(loss.item())
            counts = ops.launch_counts()
            consults = autotune.counters()
            check_launches(f"bert_large_tuned ({mode})", counts, per_step,
                           None, TUNED_STEPS)
            box = [state]

            def one():
                box[0], _ = step(box[0], toks, labels)
            n_k, dev_ms = _kernel_census(one, iters=1)
        out[mode] = (losses, consults, n_k, dev_ms)
        del step, state, box
    off, tuned = out["off"][0], out["db"][0]
    if off != arena_losses:
        raise AssertionError(f"bert_large_tuned: off losses {off} are not "
                             f"bert_large_arena's {arena_losses} bit for bit")
    rel = max(abs(a - b) / abs(b) for a, b in zip(tuned, off))
    if not rel <= 1e-3:
        raise AssertionError(f"bert_large_tuned: tuned losses {tuned} vs off "
                             f"{off}: rel {rel:.2e} > 1e-3")
    want_hits = TUNED_STEPS * sum(
        v for k, v in TUNED_CONSULTS_PER_STEP.items()
        if any(e.family == k for e in db.entries.values()))
    hits = out["db"][1]["hits"]
    if hits != want_hits or out["off"][1] != {"hits": 0, "misses": 0}:
        raise AssertionError(f"bert_large_tuned: consults {out['db'][1]} "
                             f"(want {want_hits} hits), off "
                             f"{out['off'][1]}")
    per_consult = consult_host_us()
    n_consults = sum(out["db"][1].values()) / TUNED_STEPS
    log(f"phase bert_large_tuned: losses off {off} (bert_large_arena's bit "
        f"for bit), tuned {tuned} (rel {rel:.2e}); launches a step as the "
        f"arena run's both ways; consults a step {n_consults:.0f} "
        f"({hits // TUNED_STEPS} hits); device ms a step: tuned "
        f"{out['db'][3]:.3f} ({out['db'][2]:.0f} kernels) vs off "
        f"{out['off'][3]:.3f} ({out['off'][2]:.0f} kernels); the consult's "
        f"host cost {per_consult:.3f} us a call, "
        f"{per_consult * n_consults:.1f} us a step; {smi}")


def link_probe_phase(smi):
    """Phase link_probe: ``scripts/torch_link_probe.py`` end to end (two
    gloo processes on this one card: gloo through this host, not NVLink),
    its JSON read by ``lint.mesh_model.MeshModel`` (measured, the backend
    named) and planned with by ``parallel.plan_comm``."""
    from apex_tpu_torch import parallel
    from apex_tpu_torch.lint.mesh_model import MeshModel

    os.makedirs(BUILD_OUT, exist_ok=True)
    path = os.path.join(BUILD_OUT, "mesh_measured.json")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "scripts",
        "torch_link_probe.py"), "--out", path], capture_output=True,
        text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"link_probe: exit {r.returncode}\n"
                             f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
    with open(path) as f:
        data = json.load(f)
    model = MeshModel.from_json(data)
    plan = parallel.plan_comm(model, PLAN_BYTES)
    cal = model.calibration["ici"]
    if not (model.measured and data["probe"]["backend"] in ("gloo", "nccl")
            and cal["bytes_per_s"] > 0 and plan.hops):
        raise AssertionError(f"link_probe: {data}")
    log(f"phase link_probe: {data['probe']['world']} ranks over "
        f"{data['probe']['backend']} on {data['probe']['device']}: alpha "
        f"{cal['alpha_us']} us, {cal['bytes_per_s']:.4g} bytes/s, residual "
        f"{cal['residual']}; plan_comm({PLAN_BYTES}) {plan.describe()}; took "
        f"{time.perf_counter() - t0:.1f} s; {smi}")


def prof_phases(smi, rows):
    """This slice's phases, after the monitor phases; each logs its wall
    time."""
    import torch
    for fn in (bert_large_profiled, bert_large_memory, compile_watch_card,
               simple_distributed_example):
        t = time.perf_counter()
        fn(smi, rows)
        torch.cuda.empty_cache()
        log(f"phase {fn.__name__}: {time.perf_counter() - t:.1f} s")


def monitor_phases(smi, arena_losses):
    """This slice's phases, after the observability phases: the observed
    BERT-Large step, the fp8 flag on the card, the two-rank dynamics and
    link model, and the convergence comparator; each logs its wall
    time. Device memory allocated after them is back to its level before
    (within MONITOR_KEPT_BYTES): nothing they build outlives them into the
    peaks of later phases."""
    import gc
    import torch

    def allocated():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    before = allocated()
    for fn, args in ((bert_large_observed, (smi, arena_losses)),
                     (numerics_flag_card, ()),
                     (dynamics_and_links_two_ranks, ()),
                     (convergence_mlp, ())):
        t = time.perf_counter()
        fn(*args)
        torch.cuda.empty_cache()
        log(f"phase {fn.__name__}: {time.perf_counter() - t:.1f} s")
    kept = allocated() - before
    log(f"phase monitor_phases: device memory allocated after them "
        f"{kept:+d} bytes against before")
    if kept > MONITOR_KEPT_BYTES:
        raise AssertionError(f"monitor_phases keep {kept} bytes of device "
                             f"memory alive past their end")


def observability_phases(smi):
    """This slice's phases, after resnet50_arena: the traced ResNet-50
    step, NaN provenance on it, the crash dumps and the straggler/pod
    view; each logs its wall time."""
    import torch
    t = time.perf_counter()
    traced = resnet50_traced(smi)
    log(f"phase resnet50_traced: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    debug_nans_card(smi, traced)
    del traced
    torch.cuda.empty_cache()
    log(f"phase debug_nans_card: {time.perf_counter() - t:.1f} s")
    for fn in (crash_dumps_card, straggler_podview_two_ranks):
        t = time.perf_counter()
        fn()
        torch.cuda.empty_cache()
        log(f"phase {fn.__name__}: {time.perf_counter() - t:.1f} s")


def data_cluster_phases():
    """This slice's phases, after the ResNet phases: the codec, the
    ImageNet example from JPEGs, the data-cursor resume, the coordinated
    rewind and the elastic zombie."""
    import torch
    for fn in (jpeg_codec, imagenet_example_resnet50,
               imagenet_example_formats, data_cursor_resume,
               cluster_coordinated_rewind, cluster_zombie_elastic):
        t = time.perf_counter()
        fn()
        torch.cuda.empty_cache()
        log(f"phase {fn.__name__}: {time.perf_counter() - t:.1f} s")


def _instance_name(mangled):
    """A readable name for an instance of the port's CUDA kernels:
    ``flash_fwd<bf16, D=64, opts=0>``, ``ln_fwd_warp<bf16, CH=8, NC=4>``,
    ``ln_bwd_block<f32, staged=1>``, ``bn_sums<bf16 x8, relu>`` (``scalar``
    on the path of one element a thread), ``mlp_fused<bf16>``; other
    kernels keep their mangled name."""
    import re
    dt = {"13__nv_bfloat16": "bf16", "6__half": "fp16", "f": "f32"}
    t = r"(13__nv_bfloat16|6__half|f)"
    f = re.search(r"(flash_(?:fwd|bwd_dkv|bwd_dq))I\d+(__nv_bfloat16|"
                  r"__half)Li(\d+)ELb([01])E", mangled)
    if f:
        kind = "bf16" if "bfloat" in f.group(2) else "fp16"
        return f"{f.group(1)}<{kind}, D={f.group(3)}, opts={f.group(4)}>"
    f = re.search(rf"(ln_(?:fwd|bwd)_warp)I{t}Li(\d+)ELi(\d+)E", mangled)
    if f:
        return (f"{f.group(1)}<{dt[f.group(2)]}, CH={f.group(3)}, "
                f"NC={f.group(4)}>")
    f = re.search(rf"(ln_(?:fwd|bwd)_block)I{t}Lb([01])E", mangled)
    if f:
        return f"{f.group(1)}<{dt[f.group(2)]}, staged={f.group(3)}>"
    f = re.search(rf"(mlp_(?:fused|layer))I{t}E", mangled)
    if f:
        return f"{f.group(1)}<{dt[f.group(2)]}>"
    f = re.search(rf"bn_sumsINS_(?:5Vec16I{t}E|6Scalar)ELi([012])E",
                  mangled)
    if f:
        mode = ("plain", "relu", "addrelu")[int(f.group(2))]
        width = ("scalar" if f.group(1) is None else
                 f"{dt[f.group(1)]} x{4 if f.group(1) == 'f' else 8}")
        return f"bn_sums<{width}, {mode}>"
    return mangled


def ptxas_entries(text):
    """[(kernel, registers, spill stores, spill loads)] of each entry
    function in a ``ptxas -v`` log (named by :func:`_instance_name`), and
    its warning lines."""
    import re
    entries, warnings, cur, spill = [], [], None, (None, None)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur, spill = _instance_name(m.group(1)), (None, None)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            entries.append((cur, int(m.group(1)), *spill))
            cur = None
        elif "warning" in line.lower():
            warnings.append(line.strip())
    return entries, warnings


def echo_ptxas(libs):
    """Each kernel's registers and spills, and ptxas' warnings, from the
    ``ptxas -v`` logs the build keeps beside each library."""
    for name, path in libs.items():
        info = path.with_suffix(".ptxas.txt")
        if not info.exists():
            continue
        entries, warnings = ptxas_entries(info.read_text())
        for kernel, regs, st, ld in entries:
            log(f"  ptxas {name}: {kernel}: {regs} registers, {st} bytes "
                f"spill stores, {ld} bytes spill loads")
        for w in warnings:
            log(f"  ptxas {name}: {w}")


def main() -> int:
    import torch
    import torch.distributed
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from apex_tpu_torch.ops import _build

    start_data_tree()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase device: {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"phase build: {len(libs)} CUDA libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    echo_ptxas(libs)

    # the phases run with the kernels' default launch knobs (the earlier
    # slices' launches) but mlp_dlrm_bottom, bert_large_zero,
    # bert_large_zero_two_ranks, autotune_db and bert_large_tuned, which
    # consult the committed DB
    os.environ["APEX_TPU_AUTOTUNE"] = "off"
    rows = {}
    errs = compile_check_phase()
    check_kernels(rows, errs)
    mlp_phases(rows)
    o1_backward_thread()
    tree_losses = bert_large_steps(rows)
    arena_losses = bert_large_arena(rows, tree_losses)
    torch.cuda.empty_cache()
    db = autotune_db(smi)
    bert_large_tuned(rows, arena_losses, db, smi)
    bert_large_dropout(rows)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    bert_large_f32(rows)
    log(f"phase bert_large_f32: {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()
    bert_large_ckpt_resume()
    torch.cuda.empty_cache()
    bert_large_guard(rows)
    torch.cuda.empty_cache()
    state = bert_large_remainder(rows, "bert_large_novograd", novograd,
                                 NOVOGRAD_PER_STEP, TOL_NOVOGRAD_UPDATE)
    multi_tensor_ops(rows, state)
    del state
    bert_large_remainder(rows, "bert_large_adagrad", adagrad,
                         ADAGRAD_PER_STEP, TOL_ADAGRAD_UPDATE)
    torch.cuda.empty_cache()
    plain_vs_kernel_step()
    fp16_overflow_run()
    torch.cuda.empty_cache()
    resnet_losses, _, _, resnet_peak = train_resnet50("resnet50", rows)
    resnet50_arena(rows, resnet_losses)
    torch.cuda.empty_cache()
    observability_phases(smi)
    torch.cuda.empty_cache()
    monitor_phases(smi, arena_losses)
    torch.cuda.empty_cache()
    link_probe_phase(smi)
    prof_phases(smi, rows)
    torch.cuda.empty_cache()
    resnet_plain_vs_kernel()
    torch.cuda.empty_cache()
    resnet50_fp8(rows, resnet_losses[0], resnet_peak)
    torch.cuda.empty_cache()
    resnet50_o0(rows)
    torch.cuda.empty_cache()
    train_resnet50("resnet50_o1", rows, opt_level="O1")
    torch.cuda.empty_cache()
    resnet50_adam(rows)
    torch.cuda.empty_cache()
    resnet_dx_distribute(rows)
    torch.cuda.empty_cache()
    resnet_unfused(rows)
    torch.cuda.empty_cache()
    data_cluster_phases()
    mesh, store = dist_init()
    syncbn_losses = resnet50_syncbn(rows, resnet_losses)
    torch.cuda.empty_cache()
    resnet50_syncbn_arena(rows, syncbn_losses, mesh)
    torch.cuda.empty_cache()
    syncbn_units_sync_free(mesh)
    torch.cuda.empty_cache()
    syncbn_two_ranks()
    torch.cuda.empty_cache()
    bert_large_zero(rows, arena_losses, mesh)
    torch.cuda.empty_cache()
    bert_large_zero_ckpt_resume(mesh)
    torch.cuda.empty_cache()
    zero_elastic_two_to_one(mesh)
    torch.cuda.empty_cache()
    zero_adam_update(rows, mesh)
    torch.cuda.empty_cache()
    hierarchical_sync_world1()
    torch.cuda.empty_cache()
    imagenet_example_syncbn()
    torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    shutil.rmtree(store, ignore_errors=True)
    zero_and_ring_two_ranks(rows)
    torch.cuda.empty_cache()
    bert_large_zero_two_ranks(arena_losses, smi)
    torch.cuda.empty_cache()
    hierarchy_four_ranks()
    torch.cuda.empty_cache()
    integrity_three_ranks()
    torch.cuda.empty_cache()
    dcgan_tree(rows, train_dcgan("dcgan", rows)[0])
    dcgan_plain_vs_kernel()
    dcgan_fp16_overflow()
    torch.cuda.empty_cache()
    amp_remainder_phases(rows)
    torch.cuda.empty_cache()
    attention_remainder_phases(rows)
    torch.cuda.empty_cache()
    ckpt_crash_and_escalate()

    from apex_tpu_torch import ops
    print(json.dumps({"kernels": [rows[n] for n in (
        *ops.KERNELS, *EXTRA_ROWS, *EXTRA_BN_ROWS, *EXTRA_ZERO_ROWS,
        *EXTRA_O1_ROWS, *EXTRA_S64_ROWS, *EXTRA_GENERIC_ROWS)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
