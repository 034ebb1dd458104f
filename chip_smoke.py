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
  keep mask out of the forward kernel bit for bit.
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
  same run through the plain versions.
- DCGAN (B128, 64x64, generator nz 100 / ngf 64, discriminator ndf 64,
  amp O1 bf16 under ``auto_cast``, two ``FusedAdam(lr=2e-4, betas=(0.5,
  0.999))`` bundles, three scaled backwards a step) trains 20 steps with
  the arena update ("auto" at these sizes: 3 Adam launches a step) and 20
  with the tree update, whose losses it holds against the arena run's; one
  Adam update is compared both ways; one step is compared through the
  kernel and through the plain versions; and a short fp16 run with three
  dynamic loss scalers takes a forced overflow on one of them.

Prints one line per phase, the card's name and power limit, a JSON line of
per-kernel numbers, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero on any failure, or when no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet HBM3 bandwidth
BF16_FLOPS = 989e12           # dense bf16/fp16 tensor-core peak
F32_FLOPS = 67e12             # f32 outside the tensor cores
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
# integer operations of the dropout hash per score element (mix, avalanche,
# compare, select and scale), counted at the f32 rate of the CUDA cores
HASH_OPS = 20
SOURCES = {
    "layer_norm_fwd": ("triton", "apex_tpu_torch/ops/layer_norm.py"),
    "layer_norm_bwd": ("triton", "apex_tpu_torch/ops/layer_norm.py"),
    "xentropy_fwd": ("triton", "apex_tpu_torch/ops/xentropy.py"),
    "xentropy_bwd": ("triton", "apex_tpu_torch/ops/xentropy.py"),
    "flash_attn_fwd": ("cuda", "apex_tpu_torch/csrc/flash_attn_fwd.cu"),
    "flash_attn_bwd": ("cuda", "apex_tpu_torch/csrc/flash_attn_bwd.cu"),
    "multi_tensor_l2norm": ("triton", "apex_tpu_torch/ops/multi_tensor.py"),
    "lamb_stage1": ("triton", "apex_tpu_torch/ops/optim_kernels.py"),
    "lamb_stage2": ("triton", "apex_tpu_torch/ops/optim_kernels.py"),
    "bn_sums": ("triton", "apex_tpu_torch/ops/bn_act.py"),
    "bn_dx": ("triton", "apex_tpu_torch/ops/bn_act.py"),
    "sgd": ("triton", "apex_tpu_torch/ops/optim_kernels.py"),
    "adam": ("triton", "apex_tpu_torch/ops/optim_kernels.py"),
    "multi_tensor_maxnorm": ("triton", "apex_tpu_torch/ops/multi_tensor.py"),
    "multi_tensor_scale": ("triton", "apex_tpu_torch/ops/multi_tensor.py"),
    "multi_tensor_axpby": ("triton", "apex_tpu_torch/ops/multi_tensor.py"),
    "adagrad": ("triton", "apex_tpu_torch/ops/optim_kernels.py"),
    "novograd": ("triton", "apex_tpu_torch/ops/optim_kernels.py"),
}
# tolerances: 16-bit outputs within 2% of the plain output's max magnitude
# (a few bf16 ulps: the kernels sum in another order and round P per tile);
# f32 outputs within 1e-3 of it (f32 sums in another order); the arena
# kernels' f32 outputs within 1e-5 of it (the same elementwise formulas,
# and one f32 sum in another order for the norm)
TOL16, TOL32, TOL_ARENA = 2e-2, 1e-3, 1e-5
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


def compare(name, outs_k, outs_p, tol32=TOL32):
    """Max abs error over paired outputs; raise past the stated tolerance."""
    import torch
    worst = 0.0
    for i, (k, p) in enumerate(zip(outs_k, outs_p)):
        err = (k.float() - p.float()).abs().max().item()
        ref = p.float().abs().max().item()
        tol = (tol32 if p.dtype == torch.float32 else TOL16) * max(ref, 1e-6)
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"{name} output {i}: max|kernel-plain| "
                                 f"{err:.3e} > tolerance {tol:.3e}")
        worst = max(worst, err)
    return worst


@contextlib.contextmanager
def plain_versions():
    """Run the model through the plain versions on the card: rebind each
    op module's kernel wrapper to its plain version (the wrappers counted
    in ``ops.KERNELS`` are not called, so their counts stay put)."""
    from apex_tpu_torch.ops import attention as A, bn_act as B
    from apex_tpu_torch.ops import layer_norm as L
    from apex_tpu_torch.ops import multi_tensor as M, optim_kernels as K
    from apex_tpu_torch.ops import xentropy as X
    swaps = [(L, "ln_fwd_kernel", L.ln_fwd_plain),
             (L, "ln_bwd_kernel", L.ln_bwd_plain),
             (X, "xentropy_fwd_kernel", X.xentropy_fwd_plain),
             (X, "xentropy_bwd_kernel", X.xentropy_bwd_plain),
             (A, "flash_fwd_kernel", A.flash_fwd_plain),
             (A, "flash_bwd_kernel", A.flash_bwd_plain),
             (M, "l2norm_kernel", M.l2norm_plain),
             (K, "lamb_stage1_kernel", K.lamb_stage1_plain),
             (K, "lamb_stage2_kernel", K.lamb_stage2_plain),
             (B, "bn_sums_kernel", B.bn_sums_plain),
             (B, "bn_dx_kernel", B.bn_dx_plain),
             (K, "sgd_kernel", K.sgd_plain),
             (K, "adam_kernel", K.adam_plain),
             (M, "maxnorm_kernel", M.maxnorm_plain),
             (M, "scale_kernel", M.scale_plain),
             (M, "axpby_kernel", M.axpby_plain),
             (K, "adagrad_kernel", K.adagrad_plain),
             (K, "novograd_kernel", K.novograd_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def check_kernels(rows):
    """Phase 3: every kernel against its plain version, with timings."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention as A, layer_norm as L
    from apex_tpu_torch.ops import xentropy as X

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    sweep = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flush = sweep.zero_

    def rnd(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    # a second of GEMMs first, so the first timed kernel does not meet the
    # card's clocks still ramping up
    warm = rnd(4096, 4096)
    deadline = time.perf_counter() + 1.0
    while time.perf_counter() < deadline:
        for _ in range(20):
            warm @ warm
        torch.cuda.synchronize()
    del warm

    def row(name, err, ms, plain_ms, lib_ms, nbytes, flops, peak=BF16_FLOPS,
            int_ops=0):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(flops / peak, int_ops / F32_FLOPS) * 1e3
        kernel, replaces, _ = EXTRA_ROWS.get(
            name, (name, REPLACES.get(name), None))
        route, src = SOURCES[kernel]
        rows[name] = {
            "name": name, "route": route, "source": src,
            "replaces": replaces, "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms}
        log(f"kernel {name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms  bound "
            f"{rows[name]['bound_ms']:.4f} ms ({rows[name]['bound_by']})")

    # --- LayerNorm: (8192, 1024) bf16 at both BERT eps, ragged (300, 1000)
    fwd_err = bwd_err = 0.0
    for (n, h), eps in (((8192, 1024), 1e-12), ((8192, 1024), 1e-5),
                        ((300, 1000), 1e-5)):
        x = rnd(n, h, std=2.0) + 0.5
        w = rnd(h, dtype=torch.float32, std=0.2) + 1.0
        b = rnd(h, dtype=torch.float32, std=0.2)
        g = rnd(n, h)
        e1 = compare(f"layer_norm_fwd {n}x{h} eps={eps}",
                     [L.ln_fwd_kernel(x, w, b, eps)],
                     [L.ln_fwd_plain(x, w, b, eps)])
        e2 = compare(f"layer_norm_bwd {n}x{h} eps={eps}",
                     L.ln_bwd_kernel(g, x, w, eps),
                     L.ln_bwd_plain(g, x, w, eps))
        if n == 8192:
            fwd_err, bwd_err = max(fwd_err, e1), max(bwd_err, e2)
    log("phase kernels: layer_norm fwd/bwd agree with the plain versions")
    eps = 1e-5
    nh = 8192 * 1024
    x = rnd(8192, 1024, std=2.0)
    w = rnd(1024, dtype=torch.float32, std=0.2) + 1.0
    b = rnd(1024, dtype=torch.float32, std=0.2)
    g = rnd(8192, 1024)
    ms = timed(lambda: L.ln_fwd_kernel(x, w, b, eps), flush=flush)
    plain = timed(lambda: L.ln_fwd_plain(x, w, b, eps), flush=flush)
    wl, bl = w.to(x.dtype), b.to(x.dtype)
    lib = timed(lambda: F.layer_norm(x, (1024,), wl, bl, eps), flush=flush)
    row("layer_norm_fwd", fwd_err, ms, plain, lib,
        nbytes=2 * nh * 2 + 2 * 1024 * 4, flops=0)
    ms = timed(lambda: L.ln_bwd_kernel(g, x, w, eps), flush=flush)
    plain = timed(lambda: L.ln_bwd_plain(g, x, w, eps), flush=flush)
    xg = x.detach().requires_grad_(True)
    wg = wl.detach().requires_grad_(True)
    bg = bl.detach().requires_grad_(True)
    yl = F.layer_norm(xg, (1024,), wg, bg, eps)
    lib = timed(lambda: torch.autograd.grad(yl, (xg, wg, bg), g,
                                            retain_graph=True), flush=flush)
    row("layer_norm_bwd", bwd_err, ms, plain, lib,
        nbytes=3 * nh * 2 + 3 * 1024 * 4, flops=0)
    del xg, yl

    # --- cross-entropy: (8192, 30522) bf16, labels with -1, eps 0 and 0.1
    n, v = 8192, 30522
    logits = rnd(n, v, std=3.0)
    labels = torch.randint(0, v, (n,), generator=gen, device=dev)
    labels[torch.rand(n, generator=gen, device=dev) < 0.15] = -1
    gl = torch.rand(n, generator=gen, device=dev)
    fwd_err = bwd_err = 0.0
    for sm in (0.0, 0.1):
        fwd_err = max(fwd_err, compare(
            f"xentropy_fwd eps={sm}", X.xentropy_fwd_kernel(logits, labels, sm),
            X.xentropy_fwd_plain(logits, labels, sm)))
        _, lse = X.xentropy_fwd_plain(logits, labels, sm)
        bwd_err = max(bwd_err, compare(
            f"xentropy_bwd eps={sm}",
            [X.xentropy_bwd_kernel(logits, labels, lse, gl, sm)],
            [X.xentropy_bwd_plain(logits, labels, lse, gl, sm)]))
    log("phase kernels: xentropy fwd/bwd agree with the plain versions")
    ms = timed(lambda: X.xentropy_fwd_kernel(logits, labels, 0.0), flush=flush)
    plain = timed(lambda: X.xentropy_fwd_plain(logits, labels, 0.0),
                  flush=flush)
    lib = timed(lambda: F.cross_entropy(logits, labels, ignore_index=-1,
                                        reduction="none"), flush=flush)
    row("xentropy_fwd", fwd_err, ms, plain, lib,
        nbytes=n * v * 2 + n * 8 + 2 * n * 4, flops=0)
    ms = timed(lambda: X.xentropy_bwd_kernel(logits, labels, lse, gl, 0.0),
               flush=flush)
    plain = timed(lambda: X.xentropy_bwd_plain(logits, labels, lse, gl, 0.0),
                  flush=flush)
    lg = logits.detach().requires_grad_(True)
    ll = F.cross_entropy(lg, labels, ignore_index=-1, reduction="none")
    glb = gl.to(ll.dtype)
    lib = timed(lambda: torch.autograd.grad(ll, lg, glb, retain_graph=True),
                flush=flush)
    row("xentropy_bwd", bwd_err, ms, plain, lib,
        nbytes=2 * n * v * 2 + n * 8 + 2 * n * 4, flops=0)
    del logits, lg, ll
    check_xentropy_resnet(rnd, gen, flush)

    # --- attention: (16, 512, 16, 64) bf16, ragged (2, 200, 4, 64), fp16
    fwd_err = bwd_err = 0.0
    for shape, dt in (((16, 512, 16, 64), torch.bfloat16),
                      ((2, 200, 4, 64), torch.bfloat16),
                      ((2, 200, 4, 64), torch.float16)):
        bsz, s, h, d = shape
        q, k, vv = (rnd(*shape, dtype=dt) for _ in range(3))
        do = rnd(*shape, dtype=dt)
        scale = 1.0 / math.sqrt(d)
        e1 = compare(f"flash_attn_fwd {shape} {dt}",
                     A.flash_fwd_kernel(q, k, vv, scale),
                     A.flash_fwd_plain(q, k, vv, scale))
        o, lse = A.flash_fwd_plain(q, k, vv, scale)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(
            bsz * h, s).contiguous()
        e2 = compare(f"flash_attn_bwd {shape} {dt}",
                     A.flash_bwd_kernel(q, k, vv, do, lse, delta, scale),
                     A.flash_bwd_plain(q, k, vv, do, lse, delta, scale))
        if s == 512:
            fwd_err, bwd_err = e1, e2
            main = (q, k, vv, do, lse, delta, scale)
    log("phase kernels: flash attention fwd/bwd agree with the plain "
        "versions")
    q, k, vv, do, lse, delta, scale = main
    bsz, s, h, d = q.shape
    io = bsz * s * h * d * 2
    ms = timed(lambda: A.flash_fwd_kernel(q, k, vv, scale), flush=flush)
    plain = timed(lambda: A.flash_fwd_plain(q, k, vv, scale), flush=flush)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, vv))
    lib = timed(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                flush=flush)
    row("flash_attn_fwd", fwd_err, ms, plain, lib,
        nbytes=4 * io + bsz * h * s * 4, flops=4 * bsz * h * s * s * d)
    ms = timed(lambda: A.flash_bwd_kernel(q, k, vv, do, lse, delta, scale),
               flush=flush)
    plain = timed(lambda: A.flash_bwd_plain(q, k, vv, do, lse, delta, scale),
                  flush=flush)
    qg, kg, vg = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, vv))
    og = F.scaled_dot_product_attention(qg, kg, vg)
    dot = do.transpose(1, 2)
    lib = timed(lambda: torch.autograd.grad(og, (qg, kg, vg), dot,
                                            retain_graph=True), flush=flush)
    row("flash_attn_bwd", bwd_err, ms, plain, lib,
        nbytes=7 * io + 2 * bsz * h * s * 4, flops=10 * bsz * h * s * s * d)
    del qg, kg, vg, og
    check_attention_options(rnd, gen, flush, row)
    mask_probe()
    check_arena_kernels(rnd, flush, row)
    check_arena_remainder(rnd, flush, row)
    check_bn_kernels(rnd, flush, row)
    check_sgd_kernel(rnd, flush, row)
    check_adam_kernel(rnd, flush, row)
    del sweep


def _padding_bias(gen, b, s):
    """BERT's (B, 1, 1, S) f32 padding bias: lengths from [128, S], 0 on a
    sequence's tokens and -1e9 past its end (the models' mask → bias)."""
    import torch
    dev = torch.device("cuda")
    lengths = torch.randint(128, s + 1, (b,), generator=gen, device=dev)
    keep = torch.arange(s, device=dev) < lengths[:, None]
    return torch.where(keep, 0.0, -1e9).view(b, 1, 1, s)


def check_attention_options(rnd, gen, flush, row):
    """The flash kernels' options against their plain versions (TOL16 for
    16-bit outputs, TOL32 for lse): BERT's shape with the padding bias and
    dropout 0.1; Sq 200 / Sk 328 at H = 3 in fp16, causal at the default
    frontier, at a runtime offset and with dropout; D = 128 with a full
    bias; D = 32 with a head bias and dropout; dropout block offsets; a
    multi-block S = 600 (the JAX dropout blocks are 128 there) with padding
    and dropout; Sq > Sk causal, whose first rows see no key (o = 0, lse =
    -1e30, zero gradients). Then the two wrappers are timed at BERT's shape
    with padding and dropout and at H = 15."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    bf16, fp16, f32 = torch.bfloat16, torch.float16, torch.float32

    def i32(*vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    cases = [
        ("BERT padding+dropout", (16, 512, 512, 16, 64), bf16,
         dict(bias=_padding_bias(gen, 16, 512), rate=0.1, seed=i32(12345))),
        ("causal", (2, 200, 328, 3, 64), fp16, dict(causal=True)),
        ("causal offset 50", (2, 200, 328, 3, 64), fp16,
         dict(causal=True, causal_off=i32(50))),
        ("causal+dropout", (2, 200, 328, 3, 64), fp16,
         dict(causal=True, rate=0.1, seed=i32(-77))),
        ("D128 full bias", (2, 256, 192, 4, 128), bf16,
         dict(bias=rnd(2, 4, 256, 192, dtype=f32))),
        ("D32 head bias+dropout", (2, 300, 300, 5, 32), bf16,
         dict(bias=rnd(1, 5, 300, 300, dtype=f32), rate=0.1, seed=i32(9))),
        ("dropout block offset", (2, 512, 512, 2, 64), bf16,
         dict(rate=0.1, seed=i32(31), dbo=i32(1, 2))),
        ("S600 padding+dropout", (2, 600, 600, 4, 64), bf16,
         dict(bias=_padding_bias(gen, 2, 600), rate=0.1, seed=i32(5))),
        ("Sq>Sk causal", (2, 200, 128, 2, 64), bf16, dict(causal=True)),
        ("H15", (16, 512, 512, 15, 64), bf16, {}),
    ]
    main = {}
    for label, (b, sq, sk, h, d), dt, opts in cases:
        q, do = rnd(b, sq, h, d, dtype=dt), rnd(b, sq, h, d, dtype=dt)
        k, v = rnd(b, sk, h, d, dtype=dt), rnd(b, sk, h, d, dtype=dt)
        scale = 1.0 / math.sqrt(d)
        o_k, lse_k = A.flash_fwd_kernel(q, k, v, scale, **opts)
        o_p, lse_p = A.flash_fwd_plain(q, k, v, scale, **opts)
        blind = lse_p == A.NEG_INF            # rows that see no key
        if not torch.equal(blind, lse_k == A.NEG_INF):
            raise AssertionError(f"flash_attn_fwd {label}: rows without a "
                                 f"key differ")
        n_blind = int(blind.sum())
        if n_blind:
            rows_k = o_k.transpose(1, 2).reshape(b * h, sq, d)[blind]
            if rows_k.abs().max().item() != 0.0:
                raise AssertionError(f"flash_attn_fwd {label}: a row "
                                     f"without a key has o != 0")
        e1 = compare(f"flash_attn_fwd {label}", [o_k, lse_k.masked_fill(
            blind, 0.0)], [o_p, lse_p.masked_fill(blind, 0.0)])
        delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).reshape(
            b * h, sq).contiguous()
        e2 = compare(f"flash_attn_bwd {label}",
                     A.flash_bwd_kernel(q, k, v, do, lse_p, delta, scale,
                                        **opts),
                     A.flash_bwd_plain(q, k, v, do, lse_p, delta, scale,
                                       **opts))
        log(f"kernel flash attention {label} {(b, sq, sk, h, d)} "
            f"{str(dt)[6:]}: fwd max_abs_err {e1:.3e}, bwd {e2:.3e}"
            + (f", {n_blind} rows see no key" if n_blind else ""))
        if label in ("BERT padding+dropout", "H15"):
            main[label] = (e1, e2, q, k, v, do, lse_p, delta, scale, opts)
    log("phase kernels: flash attention options (bias modes, causal, "
        "offsets, Sq != Sk, dropout, block offsets, D 32/64/128, odd H) "
        "agree with the plain versions")

    for label, suffix in (("BERT padding+dropout", "mask_dropout"),
                          ("H15", "h15")):
        e1, e2, q, k, v, do, lse, delta, scale, opts = main.pop(label)
        b, s, h, d = q.shape
        rate = opts.get("rate", 0.0)
        bias = opts.get("bias")
        io = b * s * h * d * 2
        extra = b * s * 4 if bias is not None else 0
        hash_ops = HASH_OPS * b * h * s * s if rate else 0
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None if bias is None else bias.to(q.dtype)

        def sdpa(qt=qt, kt=kt, vt=vt):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  dropout_p=rate)
        ms = timed(lambda: A.flash_fwd_kernel(q, k, v, scale, **opts),
                   flush=flush)
        plain = timed(lambda: A.flash_fwd_plain(q, k, v, scale, **opts),
                      flush=flush)
        lib = timed(sdpa, flush=flush)
        row(f"flash_attn_fwd_{suffix}", e1, ms, plain, lib,
            nbytes=4 * io + b * h * s * 4 + extra,
            flops=4 * b * h * s * s * d, int_ops=hash_ops)
        ms = timed(lambda: A.flash_bwd_kernel(q, k, v, do, lse, delta, scale,
                                              **opts), flush=flush)
        plain = timed(lambda: A.flash_bwd_plain(q, k, v, do, lse, delta,
                                                scale, **opts), flush=flush)
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        og = sdpa(qg, kg, vg)
        dot = do.transpose(1, 2)
        lib = timed(lambda: torch.autograd.grad(og, (qg, kg, vg), dot,
                                                retain_graph=True),
                    flush=flush)
        row(f"flash_attn_bwd_{suffix}", e2, ms, plain, lib,
            nbytes=7 * io + 2 * b * h * s * 4 + extra,
            flops=10 * b * h * s * s * d, int_ops=hash_ops)
        del qg, kg, vg, og


def mask_probe():
    """The dropout keep mask read out of the forward kernel through
    ``flash_attention``, bit for bit against the plain ``_keep_mask_dense``
    (a tolerance alone can miss a wrong bit: at S = 512 one changed keep
    bit moves o by about 1/512). With q = k = 0 and a (1, 1, 1, S) bias 0
    on keys [j0, j0 + 64) and -1e9 elsewhere, p is 1/64 on that window; v
    is the identity there, so o[r, d]·64·(1 − rate) is 1 where keep[r, j0 +
    d] and 0 where not (> 0.5 read as kept; o is bf16). j0 sweeps the keys,
    at S = 512 (one JAX dropout block) and S = 600 (blocks of 128), B = H =
    2."""
    import torch
    from apex_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    b, h, d, rate = 2, 2, 64, 0.1
    seed = torch.tensor([-1234567], dtype=torch.int32, device=dev)
    for s in (512, 600):
        qk = torch.zeros(b, s, h, d, dtype=torch.bfloat16, device=dev)
        got = torch.zeros(b * h, s, s, dtype=torch.bool, device=dev)
        starts = list(range(0, s - d + 1, d))
        if starts[-1] + d < s:
            starts.append(s - d)
        eye = torch.eye(d, dtype=torch.bfloat16, device=dev)
        for j0 in starts:
            bias = torch.full((1, 1, 1, s), -1e9, device=dev)
            bias[..., j0:j0 + d] = 0.0
            v = torch.zeros_like(qk)
            v[:, j0:j0 + d] = eye[None, :, None, :]
            o = A.flash_attention(qk, qk, v, bias=bias, dropout_rate=rate,
                                  dropout_seed=seed)
            bits = o.float() * d * (1 - rate) > 0.5          # (b, s, h, d)
            got[:, :, j0:j0 + d] = bits.transpose(1, 2).reshape(b * h, s, d)
        want = A._keep_mask_dense(seed, b, h, s, s, *A._dropout_blocks(s, s),
                                  rate)
        wrong = int((got != want).sum())
        if wrong:
            raise AssertionError(f"mask probe S={s}: {wrong} of "
                                 f"{want.numel()} keep bits differ")
        log(f"phase kernels: mask probe S={s}: {want.numel()} keep bits "
            f"equal the plain mask bit for bit (kept "
            f"{want.float().mean().item():.4f}, {len(starts)} windows)")


def check_xentropy_resnet(rnd, gen, flush):
    """The cross-entropy kernels at ResNet-50's (256, 1000) bf16 logits
    (every label valid, the mean's 1/256 as the incoming gradient): held
    against the plain versions and timed (a check line; the rows keep the
    BERT-Large shape)."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import xentropy as X

    n, v = 256, 1000
    logits = rnd(n, v, std=3.0)
    labels = torch.randint(0, v, (n,), generator=gen, device=logits.device)
    gl = torch.full((n,), 1.0 / n, device=logits.device)
    e1 = compare("xentropy_fwd (256, 1000)",
                 X.xentropy_fwd_kernel(logits, labels, 0.0),
                 X.xentropy_fwd_plain(logits, labels, 0.0))
    _, lse = X.xentropy_fwd_plain(logits, labels, 0.0)
    e2 = compare("xentropy_bwd (256, 1000)",
                 [X.xentropy_bwd_kernel(logits, labels, lse, gl, 0.0)],
                 [X.xentropy_bwd_plain(logits, labels, lse, gl, 0.0)])
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
    log(f"kernel xentropy at (256, 1000) bf16: fwd max_abs_err {e1:.3e} "
        f"kernel {times[0]:.4f} ms plain {times[1]:.4f} ms library "
        f"{times[2]:.4f} ms bound {b_fwd:.4f} ms (bytes); bwd max_abs_err "
        f"{e2:.3e} kernel {times[3]:.4f} ms plain {times[4]:.4f} ms "
        f"library {times[5]:.4f} ms bound {b_bwd:.4f} ms (bytes)")


def check_bn_kernels(rnd, flush, row):
    """The BN backward pair against its plain versions: every mode at the
    ResNet-50 stem (3,211,264 x 64), at a layer-4 unit (12,544 x 2048) and
    at a ragged (12,345 x 96); "addrelu" at a layer-1 join (802,816 x
    256). bf16 activations and scale/bias (O2 casts them), f32 statistics
    of x. The incoming gradient has a per-channel mean and a part along
    x̂, so k1 and x̂·k2 are as large as g itself: at every shape and mode
    the check asserts that a dx fed zeroed sums, a negated Σg·x̂ or twice
    the count lies outside the tolerance.

    Timed at the stem in "plain" mode, against the library calls that
    compute the same two functions without a ReLU mask:
    ``torch.batch_norm_backward_reduce`` (Σg, Σg·(x−μ) and dγ, dβ) and
    ``torch.batch_norm_backward_elemt`` (dx from those sums), on the same
    channels-last bf16 tensor. "relu" mode and the two-pass autograd
    backward of ``F.batch_norm(training=True)`` are timed for the log."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import bn_act as B

    bf16 = torch.bfloat16
    all_modes = ("plain", "relu", "addrelu")
    errs = {"sums": 0.0, "dx": 0.0}
    for (m, c), modes in (((3211264, 64), all_modes),
                          ((802816, 256), ("addrelu",)),
                          ((12544, 2048), all_modes),
                          ((12345, 96), all_modes)):
        x = rnd(m, c, std=2.0) + 0.5
        z = rnd(m, c).clamp_min(0.0)
        scale, bias = rnd(c, std=0.3) + 1.0, rnd(c, std=0.3)
        x32 = x.float()
        mean = x32.mean(dim=0)
        invstd = torch.rsqrt(x32.var(dim=0, unbiased=False) + 1e-5)
        g = ((rnd(m, c, dtype=torch.float32)
              + rnd(c, dtype=torch.float32, std=0.5)
              + rnd(c, dtype=torch.float32, std=0.7) * (x32 - mean) * invstd)
             * 1e-3).to(bf16)
        del x32
        for mode in modes:
            args = (x, g, z, scale, bias, mean, invstd, mode, bf16)
            ks, kdr = B.bn_sums_kernel(*args)
            ps, pdr = B.bn_sums_plain(*args)
            e1 = compare(f"bn_sums {m}x{c} {mode}",
                         [ks] + ([kdr] if kdr is not None else []),
                         [ps] + ([pdr] if pdr is not None else []))
            dx_args = (x, pdr if mode == "addrelu" else g, scale, bias,
                       mean, invstd, ps, m, mode == "relu", bf16)
            want = B.bn_dx_plain(*dx_args)
            e2 = compare(f"bn_dx {m}x{c} {mode}", [B.bn_dx_kernel(*dx_args)],
                         [want])
            for fault, sums, count in (
                    ("zeroed sums", torch.zeros_like(ps), m),
                    ("negated sum of g*xhat", ps * ps.new_tensor([[1.], [-1.]]),
                     m),
                    ("twice the count", ps, 2 * m)):
                bad = B.bn_dx_kernel(*dx_args[:6], sums, count, *dx_args[8:])
                try:
                    compare("", [bad], [want])
                except AssertionError:
                    continue
                raise AssertionError(f"bn_dx {m}x{c} {mode}: a dx with "
                                     f"{fault} passes the check")
            if m == 3211264:
                errs["sums"] = max(errs["sums"], e1)
                errs["dx"] = max(errs["dx"], e2)
                stem = (x, g, z, scale, bias, mean, invstd)
        if m != 3211264:
            del x, g, z
    log("phase kernels: bn_sums (3 modes) and bn_dx (2 modes) agree with "
        "the plain versions at the stem, a layer-1 join, layer 4 and a "
        "ragged shape; a dx with zeroed sums, a negated sum of g*xhat or "
        "twice the count fails the check at each")

    (m, c), n = (3211264, 64), 256
    x, g, z, scale, bias, mean, invstd = stem
    times, plain_out = {}, None
    for mode in ("plain", "relu"):
        args = (x, g, z, scale, bias, mean, invstd, mode, bf16)
        sums = B.bn_sums_plain(*args)[0]
        dx_args = (x, g, scale, bias, mean, invstd, sums, m, mode == "relu",
                   bf16)
        if mode == "plain":
            plain_out = (sums, B.bn_dx_plain(*dx_args))
        times[mode] = [timed(f, flush=flush) for f in (
            lambda: B.bn_sums_kernel(*args), lambda: B.bn_sums_plain(*args),
            lambda: B.bn_dx_kernel(*dx_args), lambda: B.bn_dx_plain(*dx_args))]
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
    lib_sums = timed(lambda: torch.batch_norm_backward_reduce(
        gl, xl, mean, invstd, w, True, True, True), flush=flush)
    lib_dx = timed(lambda: torch.batch_norm_backward_elemt(
        gl, xl, mean, invstd, w, red[0], red[1], counts), flush=flush)
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
    row("bn_sums", errs["sums"], k[0], k[1], lib_sums,
        nbytes=4 * m * c + 4 * c * 4, flops=5 * m * c, peak=F32_FLOPS)
    row("bn_dx", errs["dx"], k[2], k[3], lib_dx,
        nbytes=6 * m * c + 6 * c * 4, flops=6 * m * c, peak=F32_FLOPS)


def check_sgd_kernel(rnd, flush, row):
    """The SGD kernel against its plain version: every flag on a ragged
    arena of an f32 and a bf16 partition (the f32 one with a bf16
    copy-out), then ResNet-50's one f32 partition, where it is timed. The
    library yardstick is ``torch._fused_sgd_`` over ResNet-50's 161
    tensors."""
    import torch
    from apex_tpu_torch import arena, models
    from apex_tpu_torch.ops import _arena, optim_kernels as K

    dev = torch.device("cuda")
    f32 = torch.float32
    tree = {"w": rnd(1000, 300, dtype=f32), "e": rnd(513, 129),
            "b": rnd(77, dtype=f32), "s": rnd(5)}
    spec = arena.plan(tree)
    pb = arena.flatten(tree, spec)
    gb = arena.flatten({k: rnd(*t.shape, dtype=f32) for k, t in tree.items()},
                       spec, cast=f32)
    for dt, p in pb.items():
        m = rnd(p.numel(), dtype=f32, std=0.1)
        copy = torch.bfloat16 if dt == "float32" else None
        for nesterov in (False, True):
            for wd_after in (False, True):
                for first in (0.0, 1.0):
                    s = _arena.device_scalars((0.1, 0.9, 0.0, 1e-4, 0.5,
                                               first), dev)
                    compare(f"sgd ragged {dt} nesterov={nesterov} "
                            f"wd_after={wd_after} first={first}",
                            K.sgd_kernel(p, gb[dt], m, s, nesterov, wd_after,
                                         copy),
                            K.sgd_plain(p, gb[dt], m, s, nesterov, wd_after,
                                        copy), TOL_ARENA)

    rspec = arena.plan(dict(models.ResNet50(device="meta").named_parameters()))
    n = rspec.partition("float32").buffer_len
    p, g, m = (rnd(n, dtype=f32), rnd(n, dtype=f32, std=1e-2),
               rnd(n, dtype=f32, std=1e-2))
    s = _arena.device_scalars((0.1, 0.9, 0.0, 0.0, 1.0, 0.0), dev)
    err = compare("sgd ResNet-50", K.sgd_kernel(p, g, m, s, False, False),
                  K.sgd_plain(p, g, m, s, False, False), TOL_ARENA)
    log(f"phase kernels: sgd agrees with the plain version (ResNet-50 "
        f"buffer of {n} elements, ragged bf16 + f32, every flag)")
    ms = timed(lambda: K.sgd_kernel(p, g, m, s, False, False), flush=flush)
    plain = timed(lambda: K.sgd_plain(p, g, m, s, False, False), flush=flush)
    lists = [list(arena.unflatten({"float32": t.clone()}, rspec).values())
             for t in (p, g, m)]
    try:
        lib = timed(lambda: torch._fused_sgd_(
            *lists, weight_decay=0.0, momentum=0.9, lr=0.1, dampening=0.0,
            nesterov=False, maximize=False, is_first_step=False), flush=flush)
    except (RuntimeError, TypeError, AttributeError) as e:
        lib = None
        log(f"kernel sgd: library null: torch._fused_sgd_ did not run: {e}")
    row("sgd", err, ms, plain, lib, nbytes=20 * n, flops=6 * n,
        peak=F32_FLOPS)


def check_adam_kernel(rnd, flush, row):
    """The Adam kernel against its plain version: AdamW mode on and off,
    the copy-out on and off, on a ragged arena of an f32 and a bf16
    partition; then at the DCGAN generator's one f32 partition, where it
    is timed. The library yardstick is ``torch._fused_adam_`` over the
    generator's 13 tensors (context only; the port does not call it)."""
    import torch
    from apex_tpu_torch import arena, models
    from apex_tpu_torch.ops import _arena, optim_kernels as K

    dev = torch.device("cuda")
    f32 = torch.float32
    s = _arena.device_scalars((2e-4, 0.5, 0.999, 1e-8, 1e-2, 1 - 0.5 ** 3,
                               1 - 0.999 ** 3, 0.5), dev)
    tree = {"w": rnd(1000, 300, dtype=f32), "e": rnd(513, 129),
            "b": rnd(77, dtype=f32), "s": rnd(5)}
    spec = arena.plan(tree)
    pb = arena.flatten(tree, spec)
    gb = arena.flatten({k: rnd(*t.shape, dtype=f32) for k, t in tree.items()},
                       spec, cast=f32)
    for dt, p in pb.items():
        m = rnd(p.numel(), dtype=f32, std=0.1)
        v = rnd(p.numel(), dtype=f32, std=0.01).abs()
        half = torch.bfloat16 if dt == "float32" else torch.float16
        for adam_w in (True, False):
            for copy in (None, half):
                compare(f"adam ragged {dt} adam_w={adam_w} copy={copy}",
                        K.adam_kernel(p, gb[dt], m, v, s, adam_w, copy),
                        K.adam_plain(p, gb[dt], m, v, s, adam_w, copy),
                        TOL_ARENA)

    gparams = dict(models.Generator(device="meta").named_parameters())
    gspec = arena.plan(gparams)
    n = gspec.partition("float32").buffer_len
    live = sum(t.numel() for t in gparams.values())
    p, g = rnd(n, dtype=f32, std=0.02), rnd(n, dtype=f32, std=1e-2)
    m, v = rnd(n, dtype=f32, std=1e-3), rnd(n, dtype=f32, std=1e-2).square()
    s = _arena.device_scalars((2e-4, 0.5, 0.999, 1e-8, 0.0, 1 - 0.5 ** 3,
                               1 - 0.999 ** 3, 1.0), dev)
    err = max(compare(f"adam generator adam_w={w}",
                      K.adam_kernel(p, g, m, v, s, w),
                      K.adam_plain(p, g, m, v, s, w), TOL_ARENA)
              for w in (True, False))
    log(f"phase kernels: adam agrees with the plain version (DCGAN "
        f"generator buffer of {n} elements for {live} params, ragged bf16 "
        f"+ f32, AdamW on/off, copy-out on/off)")
    ms = timed(lambda: K.adam_kernel(p, g, m, v, s, True), flush=flush)
    plain = timed(lambda: K.adam_plain(p, g, m, v, s, True), flush=flush)
    lists = [list(arena.unflatten({"float32": t.clone()}, gspec).values())
             for t in (p, g, m, v)]
    steps = [torch.full((), 3.0, device=dev) for _ in lists[0]]
    try:
        lib = timed(lambda: torch._fused_adam_(
            *lists, [], steps, lr=2e-4, beta1=0.5, beta2=0.999,
            weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False),
            flush=flush)
    except (RuntimeError, TypeError, AttributeError) as e:
        lib = None
        log(f"kernel adam: library null: torch._fused_adam_ did not run: {e}")
    row("adam", err, ms, plain, lib, nbytes=28 * n, flops=18 * n,
        peak=F32_FLOPS)


def check_arena_kernels(rnd, flush, row):
    """The arena kernels against their plain versions: a ragged arena of
    an f32 and a bf16 partition (stage 2 with a bf16 copy-out), then
    BERT-Large's one f32 partition (``buffer_len`` from ``arena.plan``),
    where they are timed."""
    import torch
    from apex_tpu_torch import arena, models
    from apex_tpu_torch.ops import _arena, multi_tensor as M
    from apex_tpu_torch.ops import optim_kernels as K

    dev = torch.device("cuda")
    f32 = torch.float32
    s1 = _arena.device_scalars((0.9, 0.999, 1e-6, 0.01, 1 - 0.9 ** 3,
                                1 - 0.999 ** 3, 0.5, 0.1), dev)
    s2 = _arena.device_scalars((1e-3,), dev)

    def moments(n):
        return rnd(n, dtype=f32, std=0.1), rnd(n, dtype=f32, std=0.01).abs()

    # ragged: two partitions, each of the kernels' constexpr variants
    tree = {"w": rnd(1000, 300, dtype=f32), "e": rnd(513, 129),
            "b": rnd(77, dtype=f32), "s": rnd(5)}
    spec = arena.plan(tree)
    pb = arena.flatten(tree, spec)
    gb = arena.flatten({k: rnd(*t.shape, dtype=f32) for k, t in tree.items()},
                       spec, cast=f32)
    for dt, adam_w, copy in (("float32", True, torch.bfloat16),
                             ("bfloat16", False, None)):
        p, g = pb[dt], gb[dt]
        m, v = moments(p.numel())
        for x in (p, g):
            compare(f"multi_tensor_l2norm ragged {dt} {x.dtype}",
                    [M.l2norm_kernel(x)], [M.l2norm_plain(x)], TOL_ARENA)
        compare(f"lamb_stage1 ragged {dt} adam_w={adam_w}",
                K.lamb_stage1_kernel(p, g, m, v, s1, adam_w),
                K.lamb_stage1_plain(p, g, m, v, s1, adam_w), TOL_ARENA)
        u = K.lamb_stage1_plain(p, g, m, v, s1, adam_w)[0]
        r = rnd(p.numel(), dtype=f32).abs()
        outs = [K.lamb_stage2_kernel(p, u, r, s2, copy),
                K.lamb_stage2_plain(p, u, r, s2, copy)]
        if copy is None:
            outs = [[o] for o in outs]
        compare(f"lamb_stage2 ragged {dt} copy={copy}", *outs, TOL_ARENA)

    # BERT-Large: one f32 partition of buffer_len elements
    n = arena.plan(dict(models.BertLarge(device=dev).named_parameters())
                   ).partition("float32").buffer_len
    p, g, r = (rnd(n, dtype=f32), rnd(n, dtype=f32, std=3.0),
               rnd(n, dtype=f32).abs())
    m, v = moments(n)
    l2_err = compare("multi_tensor_l2norm BERT-Large", [M.l2norm_kernel(g)],
                     [M.l2norm_plain(g)], TOL_ARENA)
    s1_err = compare("lamb_stage1 BERT-Large",
                     K.lamb_stage1_kernel(p, g, m, v, s1, True),
                     K.lamb_stage1_plain(p, g, m, v, s1, True), TOL_ARENA)
    u = K.lamb_stage1_plain(p, g, m, v, s1, True)[0]
    s2_err = compare("lamb_stage2 BERT-Large",
                     [K.lamb_stage2_kernel(p, u, r, s2)],
                     [K.lamb_stage2_plain(p, u, r, s2)], TOL_ARENA)
    log(f"phase kernels: arena l2norm and LAMB stages agree with the plain "
        f"versions (BERT-Large buffer of {n} elements, ragged bf16 + f32)")
    ms = timed(lambda: M.l2norm_kernel(g), flush=flush)
    plain = timed(lambda: M.l2norm_plain(g), flush=flush)
    lib = timed(lambda: torch.linalg.vector_norm(g), flush=flush)
    row("multi_tensor_l2norm", l2_err, ms, plain, lib, nbytes=4 * n,
        flops=2 * n, peak=F32_FLOPS)
    ms = timed(lambda: K.lamb_stage1_kernel(p, g, m, v, s1, True),
               flush=flush)
    plain = timed(lambda: K.lamb_stage1_plain(p, g, m, v, s1, True),
                  flush=flush)
    row("lamb_stage1", s1_err, ms, plain, None, nbytes=28 * n,
        flops=15 * n, peak=F32_FLOPS)
    ms = timed(lambda: K.lamb_stage2_kernel(p, u, r, s2), flush=flush)
    plain = timed(lambda: K.lamb_stage2_plain(p, u, r, s2), flush=flush)
    row("lamb_stage2", s2_err, ms, plain, None, nbytes=16 * n,
        flops=3 * n, peak=F32_FLOPS)


def _check_flagged(name, got, want):
    """(out, all-finite flag) of a kernel against its plain version: flags
    equal, outputs within TOL_ARENA (16-bit: TOL16) of the largest."""
    if bool(got[1]) != bool(want[1]):
        raise AssertionError(f"{name}: flag {bool(got[1])}, plain "
                             f"{bool(want[1])}")
    return compare(name, [got[0]], [want[0]], TOL_ARENA)


def check_arena_remainder(rnd, flush, row):
    """Rows 15d-f and 15i-j against their plain versions: maxnorm, scale
    and axpby (out_dtype None, bf16, f16), Adagrad (both weight-decay
    modes) and NovoGrad (both moment modes) on a ragged arena of an f32
    and a bf16 partition; the flags' cases (an inf makes each flag False;
    1e5 scaled into f16 overflows only in the cast, so the flag is True
    and the output inf, as in the JAX package); maxnorm NaN with a NaN in
    the first or the last block, 0 on zeros. Then BERT-Large's f32
    partition, where each is timed. Library yardsticks: maxnorm
    ``torch.linalg.vector_norm(ord=inf)``, scale ``torch.mul(out=)``,
    Adagrad ``torch._fused_adagrad_`` over BERT-Large's 292 tensors (if
    this build has it on CUDA); axpby and NovoGrad have no single call."""
    import torch
    from apex_tpu_torch import arena, models
    from apex_tpu_torch.ops import _arena, multi_tensor as M
    from apex_tpu_torch.ops import optim_kernels as K

    dev = torch.device("cuda")
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    s_scale = _arena.device_scalars((0.37,), dev)
    s_axpby = _arena.device_scalars((1.7, -0.6), dev)
    s_ada = _arena.device_scalars((1e-2, 1e-10, 1e-4, 0.5), dev)
    s_novo = _arena.device_scalars((1e-3, 0.95, 0.05, 1e-8, 1e-3,
                                    1 - 0.95 ** 3,
                                    math.sqrt(1 - 0.98 ** 3)), dev)
    tree = {"w": rnd(1000, 300, dtype=f32), "e": rnd(513, 129),
            "b": rnd(77, dtype=f32), "s": rnd(5)}
    spec = arena.plan(tree)
    pb = arena.flatten(tree, spec)
    gb = arena.flatten({k: rnd(*t.shape, dtype=f32) for k, t in tree.items()},
                       spec, cast=f32)
    for dt, p in pb.items():
        n, g = p.numel(), gb[dt]
        h = rnd(n, dtype=f32, std=0.1).abs()
        m = rnd(n, dtype=f32, std=0.1)
        vpos = rnd(n, dtype=f32).abs() + 0.1
        for x in (p, g):
            compare(f"multi_tensor_maxnorm ragged {dt} {x.dtype}",
                    [M.maxnorm_kernel(x)], [M.maxnorm_plain(x)], TOL_ARENA)
        for out in (p.dtype, bf16, f16):
            _check_flagged(f"multi_tensor_scale ragged {dt} -> {out}",
                           M.scale_kernel(p, s_scale, out),
                           M.scale_plain(p, s_scale, out))
            _check_flagged(f"multi_tensor_axpby ragged {dt} -> {out}",
                           M.axpby_kernel(p, g, s_axpby, out),
                           M.axpby_plain(p, g, s_axpby, out))
        for w in (False, True):
            compare(f"adagrad ragged {dt} adagrad_w={w}",
                    K.adagrad_kernel(p, g, h, s_ada, w),
                    K.adagrad_plain(p, g, h, s_ada, w), TOL_ARENA)
        for r in (False, True):
            compare(f"novograd ragged {dt} reg_inside_moment={r}",
                    K.novograd_kernel(p, g, m, vpos, s_novo, r),
                    K.novograd_plain(p, g, m, vpos, s_novo, r), TOL_ARENA)

    # the flags' and the norm's edge cases, each on kernel and plain
    x = rnd(2 * 65536, dtype=f32)
    one = _arena.device_scalars((1.0,), dev)
    for pos in (0, x.numel() - 1):
        bad = x.clone()
        bad[pos] = float("nan")
        for fn in (M.maxnorm_kernel, M.maxnorm_plain):
            if not math.isnan(fn(bad).item()):
                raise AssertionError(f"{fn.__name__}: a NaN at {pos} did "
                                     f"not give NaN")
        bad[pos] = float("inf")
        for fn, args in ((M.scale_kernel, (bad, one, f32)),
                         (M.scale_plain, (bad, one, f32)),
                         (M.axpby_kernel, (x, bad, s_axpby, f32)),
                         (M.axpby_plain, (x, bad, s_axpby, f32))):
            if bool(fn(*args)[1]):
                raise AssertionError(f"{fn.__name__}: an inf at {pos} left "
                                     f"the flag True")
    big = x.clone()
    big[70000] = 1e5
    for fn in (M.scale_kernel, M.scale_plain):
        out, ok = fn(big, one, f16)
        if not (bool(ok) and math.isinf(out[70000].item())):
            raise AssertionError(f"{fn.__name__}: 1e5 into f16 gave flag "
                                 f"{bool(ok)}, out {out[70000].item()}")
    zeros = torch.zeros_like(x)
    if M.maxnorm_kernel(zeros).item() != 0.0:
        raise AssertionError("maxnorm of zeros is not 0")
    log("phase kernels: maxnorm, scale, axpby, adagrad and novograd agree "
        "with the plain versions (ragged bf16 + f32, every variant); NaN "
        "gives NaN from maxnorm, an inf makes each flag False, 1e5 into "
        "f16 gives inf with the flag True, as in the JAX package")

    # BERT-Large: one f32 partition of buffer_len elements
    bspec = arena.plan(dict(models.BertLarge(device=dev).named_parameters()))
    n = bspec.partition("float32").buffer_len
    p, g = rnd(n, dtype=f32), rnd(n, dtype=f32, std=1e-2)
    h, m = rnd(n, dtype=f32, std=1e-2).square(), rnd(n, dtype=f32, std=1e-3)
    vpos = rnd(n, dtype=f32).abs() + 0.1
    errs = {
        "multi_tensor_maxnorm": compare("multi_tensor_maxnorm BERT-Large",
                                        [M.maxnorm_kernel(g)],
                                        [M.maxnorm_plain(g)], TOL_ARENA),
        "multi_tensor_scale": _check_flagged(
            "multi_tensor_scale BERT-Large", M.scale_kernel(g, s_scale, f32),
            M.scale_plain(g, s_scale, f32)),
        "multi_tensor_axpby": _check_flagged(
            "multi_tensor_axpby BERT-Large",
            M.axpby_kernel(p, g, s_axpby, f32),
            M.axpby_plain(p, g, s_axpby, f32)),
        "adagrad": compare("adagrad BERT-Large",
                           K.adagrad_kernel(p, g, h, s_ada, False),
                           K.adagrad_plain(p, g, h, s_ada, False), TOL_ARENA),
        "novograd": compare("novograd BERT-Large",
                            K.novograd_kernel(p, g, m, vpos, s_novo, False),
                            K.novograd_plain(p, g, m, vpos, s_novo, False),
                            TOL_ARENA)}
    log(f"phase kernels: maxnorm, scale, axpby, adagrad and novograd agree "
        f"with the plain versions (BERT-Large buffer of {n} elements)")

    lists = [list(arena.unflatten({"float32": t.clone()}, bspec).values())
             for t in (p, g, h)]
    steps = [torch.full((), 3.0, device=dev) for _ in lists[0]]
    try:
        ada_lib = timed(lambda: torch._fused_adagrad_(
            *lists, steps, lr=1e-2, lr_decay=0.0, weight_decay=1e-4,
            eps=1e-10, maximize=False), flush=flush)
    except (RuntimeError, TypeError, AttributeError,
            NotImplementedError) as e:
        ada_lib = None
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
        row(name, errs[name], ms, plain_ms, lib_ms, nbytes=nbytes,
            flops=flops, peak=F32_FLOPS)


def train_bert_large(phase, rows, strategy="auto", optimizer=None,
                     per_step=None, **options):
    """5 BERT-Large steps (B16, S512, O1 bf16) with ``FusedLAMB(lr=1e-3,
    strategy=strategy)``, or with ``optimizer``, built by
    ``train.build_bert_step`` (``options``: its ``dropout``/``padded``);
    checks every kernel's launches in those steps (``per_step``: the
    optimizer's kernels). Returns (losses, state, step ms)."""
    import torch
    from apex_tpu_torch import ops, train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = (dict(strategy=strategy) if optimizer is None
           else dict(optimizer=optimizer))
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
    times, losses = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, toks, labels)
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launch_counts()
    for i, (l, t) in enumerate(zip(losses, times)):
        log(f"{phase} step {i}: loss {l:.6f}  {t:.2f} ms")
        if not math.isfinite(l):
            raise AssertionError(f"step {i} loss is not finite: {l}")
    if int(state.step.item()) != 5:
        raise AssertionError(f"state.step {int(state.step)} != 5")
    check_launches(phase, counts, dict(
        EXPECTED_PER_STEP, **(ARENA_PER_STEP if strategy == "arena" else {}),
        **(per_step or {})), rows)
    step_ms = sorted(times[1:])[len(times[1:]) // 2]
    log(f"phase {phase}: launches per step "
        f"{ {k: v // 5 for k, v in counts.items()} }")
    log(f"phase {phase}: median step {step_ms:.2f} ms (steps 1-4), "
        f"{16 / step_ms * 1e3:.2f} seq/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return losses, state, step_ms


def check_launches(phase, counts, per_step, rows, steps=5):
    """Every kernel of the package launched ``per_step`` times a step (0
    for those not named); records the path's counts in ``rows``."""
    for name, n in counts.items():
        want = steps * per_step.get(name, 0)
        if n != want:
            raise AssertionError(f"{phase}: {name}: {n} launches in {steps} "
                                 f"steps, expected {want}")
        if want:
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
    for name, (kernel, _, driven_by) in EXTRA_ROWS.items():
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


def bert_large_arena(rows, tree_losses):
    """Phase 5: 5 BERT-Large steps with ``strategy="arena"`` from the same
    seed: one launch per step of each arena kernel, and every loss within
    1e-3 relative of the tree run's at the same step. Then one update from
    this run's state, arena against tree."""
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
        kernels[name] = sum(1 for e in prof.events() if e.device_type
                            == torch.autograd.DeviceType.CUDA)
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
    _check_flagged("multi_tensor_ops scale", (model, ok_copy),
                   M.scale_plain(p, one, torch.bfloat16))
    _check_flagged("multi_tensor_ops axpby", (acc, ok_acc),
                   M.axpby_plain(stash, scaled, two, torch.float32))
    want = M.maxnorm_plain(acc)
    if not (bool(ok_copy) and bool(ok_acc) and norm.item() == want.item()):
        raise AssertionError(f"multi_tensor_ops: flags {bool(ok_copy)}, "
                             f"{bool(ok_acc)}; maxnorm {norm.item()} vs "
                             f"{want.item()}")
    log(f"phase multi_tensor_ops: scale, axpby, maxnorm once each on the "
        f"{p.numel()}-element master arena: agree with the plain versions, "
        f"flags True, L-inf norm {norm.item():.6e}")


def train_resnet50(phase, rows, strategy="auto"):
    """5 ResNet-50 steps (B256, 224x224, O2 bf16) with ``FusedSGD(lr=0.1,
    momentum=0.9, strategy=strategy)``, built by
    ``train.build_resnet_step``; checks every kernel's launches in those
    steps, the step count and the running statistics. Returns (losses,
    state, step ms)."""
    import torch
    from apex_tpu_torch import ops, train
    from apex_tpu_torch.ops import bn_act

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, (state, bstats), (x, y), _policy, model = train.build_resnet_step(
        256, 224, strategy=strategy)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase {phase}: built, {n_params} params, {len(state.params)} "
        f"tensors, input {tuple(x.shape)} {x.dtype}, FusedSGD strategy "
        f"{strategy!r}")
    ops.reset_launch_counts()
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
    copies = bn_act.layout_copies - copies
    for i, (l, t) in enumerate(zip(losses, times)):
        log(f"{phase} step {i}: loss {l:.6f}  {t:.2f} ms")
        if not math.isfinite(l):
            raise AssertionError(f"step {i} loss is not finite: {l}")
    if int(state.step.item()) != 5:
        raise AssertionError(f"state.step {int(state.step)} != 5")
    if not torch.stack([torch.isfinite(v).all()
                        for v in bstats.values()]).all().item():
        raise AssertionError("a running statistic is not finite")
    check_launches(phase, counts, dict(
        RESNET_PER_STEP, **(SGD_PER_STEP if strategy == "arena" else {})),
        rows)
    step_ms = sorted(times[1:])[len(times[1:]) // 2]
    log(f"phase {phase}: launches per step "
        f"{ {k: v // 5 for k, v in counts.items() if v} }, gradients "
        f"copied into the BN row layout per step {copies / 5:g}")
    log(f"phase {phase}: median step {step_ms:.2f} ms (steps 1-4), "
        f"{256 / step_ms * 1e3:.2f} img/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return losses, state, step_ms


def resnet50_arena(rows, tree_losses):
    """5 ResNet-50 steps with ``strategy="arena"`` from the same seed: one
    ``sgd`` launch a step, every loss within 1e-3 relative of the tree
    run's. Then one SGD update from this run's state, arena against tree."""
    from apex_tpu_torch.optim import FusedSGD

    losses, state, _ = train_resnet50("resnet50_arena", rows, "arena")
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


def resnet_plain_vs_kernel():
    """One block per stage at full widths (B256, 224x224, O2 bf16): the
    first step's gradients (per tensor, within 2e-2 of the tensor's max:
    bf16 activations, and ReLU-threshold ties may flip a mask bit where
    the sums differ in order) and the second step's loss (within 5e-3
    relative) through the kernels and through the plain versions."""
    import torch
    from torch.func import functional_call
    from apex_tpu_torch import amp, models, ops, train
    from apex_tpu_torch.optim import FusedSGD

    grads, losses = {}, {}
    for mode in ("kernel", "plain"):
        model = models.ResNet(stage_sizes=[1, 1, 1, 1], dtype=torch.bfloat16)
        step, (state, bs), (x, y), policy, _ = train.build_resnet_step(
            256, 224, model=model)
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
    log(f"phase resnet_plain_vs_kernel: first-step grads of {len(errs)} "
        f"tensors, worst {errs[worst]:.2e} of the tensor's max ({worst}); "
        f"second-step loss kernel {losses['kernel']:.6f} plain "
        f"{losses['plain']:.6f} rel {rel:.2e}")
    if not errs[worst] <= 2e-2:
        raise AssertionError(f"kernel/plain grads of {worst} differ by "
                             f"{errs[worst]:.2e} of its max > 2e-2")
    if not rel <= 5e-3:
        raise AssertionError(f"kernel/plain loss differ by {rel:.2e} > 5e-3")


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from apex_tpu_torch.ops import _build

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
    for name, path in libs.items():
        info = path.with_suffix(".ptxas.txt")
        lines = [l.strip() for l in info.read_text().splitlines()
                 if "registers" in l or "spill" in l] if info.exists() else []
        for l in lines:
            log(f"  ptxas {name}: {l}")

    rows = {}
    check_kernels(rows)
    tree_losses = bert_large_steps(rows)
    bert_large_arena(rows, tree_losses)
    bert_large_dropout(rows)
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
    resnet_losses = train_resnet50("resnet50", rows)[0]
    resnet50_arena(rows, resnet_losses)
    torch.cuda.empty_cache()
    resnet_plain_vs_kernel()
    torch.cuda.empty_cache()
    dcgan_tree(rows, train_dcgan("dcgan", rows)[0])
    dcgan_plain_vs_kernel()
    dcgan_fp16_overflow()

    from apex_tpu_torch import ops
    print(json.dumps({"kernels": [rows[n] for n in (*ops.KERNELS,
                                                     *EXTRA_ROWS)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
