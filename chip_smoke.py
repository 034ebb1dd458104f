#!/usr/bin/env python3
"""Chip smoke test of apex_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from this checkout, holds each kernel against its
plain PyTorch version on the card at the BERT-Large shapes (and a ragged
shape), times kernel, plain version, a library call (yardstick only) and
the data-sheet bound, then trains BERT-Large (B16, S512, amp O1 bf16,
FusedLAMB) for 5 steps through the kernels with the tree update (the
"auto" default at this size) and 5 steps with the flat-arena update
(``strategy="arena"``), checking that every kernel launched the expected
number of times and that the two runs' losses agree. One LAMB update
from the same state is then run both ways and compared, timed in turns,
and its device kernels counted with ``torch.profiler``. Then a depth-2
full-width step is compared with the same step run through the plain
versions, and a short fp16 O1 run with dynamic loss scaling takes one
forced overflow.

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
}
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
    from apex_tpu_torch.ops import attention as A, layer_norm as L
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
             (K, "lamb_stage2_kernel", K.lamb_stage2_plain)]
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

    def row(name, err, ms, plain_ms, lib_ms, nbytes, flops, peak=BF16_FLOPS):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        route, src = SOURCES[name]
        rows[name] = {
            "name": name, "route": route, "source": src,
            "replaces": REPLACES[name], "launches": 0,
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
    check_arena_kernels(rnd, flush, row)
    del sweep


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


def train_bert_large(phase, rows, strategy="auto"):
    """5 BERT-Large steps (B16, S512, O1 bf16) with ``FusedLAMB(lr=1e-3,
    strategy=strategy)``, built by ``train.build_bert_step``; checks every
    kernel's launches in those steps. Returns (losses, state, step ms)."""
    import torch
    from apex_tpu_torch import ops, train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, state, (toks, labels), _policy, enc = train.build_bert_step(
        16, 512, strategy=strategy)
    n_params = sum(p.numel() for p in enc.parameters())
    log(f"phase {phase}: built, {n_params} params, "
        f"{len(state.params)} tensors, FusedLAMB strategy {strategy!r}")
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
    arena = strategy == "arena"
    expected = dict(EXPECTED_PER_STEP, **{
        k: v if arena else 0 for k, v in ARENA_PER_STEP.items()})
    for name, per_step in expected.items():
        if counts[name] != 5 * per_step:
            raise AssertionError(f"{name}: {counts[name]} launches in 5 "
                                 f"steps, expected {5 * per_step}")
        if per_step:
            rows[name]["launches"] = counts[name]
    step_ms = sorted(times[1:])[len(times[1:]) // 2]
    log(f"phase {phase}: launches per step "
        f"{ {k: v // 5 for k, v in counts.items()} }")
    log(f"phase {phase}: median step {step_ms:.2f} ms (steps 1-4), "
        f"{16 / step_ms * 1e3:.2f} seq/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return losses, state, step_ms


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
    arena_vs_tree_update(state.params, state.opt_state)


def arena_vs_tree_update(params, opt_state):
    """One LAMB update from the same params, grads and state, arena against
    tree: p, m, v compared per tensor (``TOL_UPDATE``), the two timed alone
    in turns, and the device kernels of each counted by ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from apex_tpu_torch import arena
    from apex_tpu_torch.optim import FusedLAMB, FusedOptState

    spec = arena.plan(params)
    dev = next(iter(params.values())).device
    gen = torch.Generator(dev).manual_seed(1)
    grads = {k: torch.randn(p.shape, generator=gen, device=dev) * 1e-2
             for k, p in params.items()}
    txs = {"arena": FusedLAMB(lr=1e-3, strategy="arena"),
           "tree": FusedLAMB(lr=1e-3, strategy="tree")}
    states = {"arena": opt_state, "tree": FusedOptState(
        count=opt_state.count,
        slots={s: arena.unflatten(b, spec) for s, b in opt_state.slots.items()})}

    def update(name):
        return txs[name].step(grads, states[name], params)

    (pa, sa), (pt, st) = update("arena"), update("tree")
    got = {"p": pa, "m": arena.unflatten(sa.slots["m"], spec),
           "v": arena.unflatten(sa.slots["v"], spec)}
    want = {"p": pt, "m": st.slots["m"], "v": st.slots["v"]}
    worst = {}
    for key, tol in TOL_UPDATE.items():
        errs = torch.stack([
            (got[key][k] - want[key][k]).abs().max()
            / want[key][k].abs().max().clamp(min=1e-30) for k in params])
        worst[key] = errs.max().item()
        if not worst[key] <= tol:
            raise AssertionError(f"arena vs tree update: {key} differs by "
                                 f"{worst[key]:.3e} of a tensor's max > {tol}")
    del pa, sa, pt, st, got, want
    log(f"phase arena_vs_tree: one update from the same state agrees, "
        f"worst per-tensor error / max: p {worst['p']:.2e}, "
        f"m {worst['m']:.2e}, v {worst['v']:.2e}")

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


def depth2_encoder():
    from apex_tpu_torch import models
    return models.BertEncoder(30522, hidden=1024, layers=2, heads=16)


def plain_vs_kernel_step():
    """Phase 6: first-step loss, kernels vs plain versions, depth 2."""
    import torch
    from apex_tpu_torch import ops, train

    losses = {}
    for mode in ("kernel", "plain"):
        step, state, (toks, labels), _p, _e = train.build_bert_step(
            16, 512, encoder=depth2_encoder())
        ops.reset_launch_counts()
        with (plain_versions() if mode == "plain" else contextlib.nullcontext()):
            state, loss = step(state, toks, labels)
        losses[mode] = loss.item()
        used = sum(ops.launch_counts().values())
        if (used == 0) != (mode == "plain"):
            raise AssertionError(f"{mode} step launched {used} kernels")
        del step, state
        torch.cuda.empty_cache()
    rel = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
    log(f"phase plain_vs_kernel: depth-2 first-step loss kernel "
        f"{losses['kernel']:.6f} plain {losses['plain']:.6f} rel {rel:.2e}")
    if not rel <= 5e-3:
        raise AssertionError(f"kernel/plain loss differ by {rel:.2e} > 5e-3")


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
    torch.cuda.empty_cache()
    plain_vs_kernel_step()
    fp16_overflow_run()

    print(json.dumps({"kernels": [rows[n] for n in (*EXPECTED_PER_STEP,
                                                    *ARENA_PER_STEP)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
