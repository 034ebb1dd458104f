"""On-card check of every hand kernel: ``python -m apex_tpu_torch.ops``.

The port of ``apex_tpu/ops/compile_check.py``. The CPU tests reach every
kernel wrapper's plain version only; whether a CUDA or Triton kernel
compiles, launches and computes its plain version's function shows on the
card alone. This module holds those checks as a registry of cases
(``@case(name)``, under the JAX package's case names where one exists):

- **the JAX package's kernel cases**, at its own awkward shapes (short
  multi-head sequences, cross 200×112, LayerNorm widths 769 and 48, vocab
  1003, a tail partition, a non-power-of-two block preference), each
  holding the kernel path against the same call through the plain
  versions (:func:`plain_versions`) at the tolerances below. The JAX
  cases in f32 attention run at f32 through the generic flash kernels
  (``flash_attn_generic.cu``), each recording its error in :data:`ERRS`
  under ``"<label> f32"``, and again in bf16 through the wgmma kernels,
  as the JAX package's bf16 cases run. ``bn_act/pallas-bwd-variant`` runs
  its channel grid through the port's one BN backward (the CUDA sums and
  the Triton dx);
- **the kernel phase's checks** (``kernels/*``), at the main paths'
  shapes: every mode, path and edge case of each kernel against its plain
  version, the masks and copies bit for bit, two launches of each
  deterministic kernel bitwise equal. Each records the max |kernel −
  plain| of the kernels-JSON row it measures in :data:`ERRS`, which
  ``chip_smoke.py`` reports beside its timings;
- **the no-extra-dispatch cases** of the modules the port has: a depth-2
  encoder's step with the module's feature off (attached, observing, or
  on an off-step of its cadence) against the step without it: the same
  aten ops dispatched (``prof.cost``'s dispatch-mode count) and, on a
  card, the same device kernels by name and count
  (``prof.report.guarded_session``). ``autotune/no-extra-dispatch`` holds
  a DB miss to ``APEX_TPU_AUTOTUNE=off`` and shows a seeded exact-key hit
  change the launch (a new Triton specialization and a new CUDA launch
  argument). The JAX package's three ``lint/*`` cases wait for the port's
  lint pass.

Tolerances (``chip_smoke.py``'s): 16-bit outputs within ``TOL16`` (2%) of
the plain output's largest magnitude (a few bf16 ulps: the kernels sum in
another order and round P per tile), f32 outputs within ``TOL32`` (1e-3)
of it, the arena kernels' f32 outputs within ``TOL_ARENA`` (1e-5: the
same elementwise formulas, one f32 sum in another order).

``python -m apex_tpu_torch.ops [--compile-check] [-k PATTERN] [--json
PATH]`` runs the cases (``-k``: those whose name holds PATTERN) and writes
the JAX package's summary fields (``backend`` is ``cuda``, ``device`` the
card's name). Without a card it exits non-zero and builds and launches
nothing: there is no CPU fallback.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import math
import os
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

CASES: List[Tuple[str, Callable[[], None]]] = []

#: max |kernel − plain| of the kernel phase's checks, by kernels-JSON row
ERRS: Dict[str, float] = {}

#: where the cases put their tensors (a CPU rehearsal sets "cpu")
DEVICE = "cuda"

TOL16, TOL32, TOL_ARENA = 2e-2, 1e-3, 1e-5
#: the DLRM bottom MLP (``--arch-mlp-bot`` of the Criteo Terabyte run)
MLP_BOTTOM = (13, 512, 256, 128)
#: the reference Apex's MHA benchmark: B128, S64, 16 heads of 64
MHA_B, MHA_S, MHA_HEADS, MHA_D = 128, 64, 16, 64
#: a ring hop: BERT-Large's heads, B2, 8192 tokens over two ranks
RING_B, RING_S, RING_H, RING_D, SEQ_RANKS = 2, 8192, 16, 64, 2


def case(name: str):
    def reg(fn):
        CASES.append((name, fn))
        return fn
    return reg


def log(msg):
    print(msg, flush=True)


def compare(name, outs_k, outs_p, tol32=TOL32):
    """Max abs error over paired outputs; raise past the stated tolerance
    (``tol32`` for f32 outputs, ``TOL16`` for 16-bit ones, each times the
    plain output's largest magnitude)."""
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
    """Run through the plain versions on the card: rebind each op module's
    kernel wrapper to its plain version (the wrappers counted in
    ``ops.KERNELS`` are not called, so their counts stay put)."""
    from apex_tpu_torch.ops import attention as A, bn_act as B
    from apex_tpu_torch.ops import layer_norm as L, mlp as P
    from apex_tpu_torch.ops import multi_tensor as M, optim_kernels as K
    from apex_tpu_torch.ops import xentropy as X
    swaps = [(L, "ln_fwd_kernel", L.ln_fwd_plain),
             (L, "ln_bwd_kernel", L.ln_bwd_plain),
             (X, "xentropy_fwd_kernel", X.xentropy_fwd_plain),
             (X, "xentropy_bwd_kernel", X.xentropy_bwd_plain),
             (A, "flash_fwd_kernel", A.flash_fwd_plain),
             (A, "flash_bwd_kernel", A.flash_bwd_plain),
             (A, "flash_wgmma_fwd_kernel", A.flash_fwd_plain),
             (A, "flash_wgmma_bwd_kernel", A.flash_bwd_plain),
             (A, "flash_generic_fwd_kernel", A.flash_fwd_plain),
             (A, "flash_generic_bwd_kernel", A.flash_bwd_plain),
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
             (K, "novograd_kernel", K.novograd_plain),
             (P, "mlp_fwd_kernel", P.mlp_fused_reference)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def seeded(seed=0):
    """(rnd, gen): seeded random tensors on :data:`DEVICE`."""
    import torch
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(seed)

    def rnd(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    return rnd, gen


def _launched(before, kernels):
    """Raise unless each of ``kernels`` launched since ``before``."""
    from apex_tpu_torch import ops
    now = ops.launch_counts()
    idle = [k for k in kernels if now[k] == before[k]]
    if idle:
        raise AssertionError(f"kernels {idle} never launched")


def _vs_plain(label, fn, kernels, tol32=TOL32):
    """``fn()`` (a list of tensors) through the kernels, which must launch,
    against the same call through the plain versions."""
    from apex_tpu_torch import ops
    before = ops.launch_counts()
    got = fn()
    _launched(before, kernels)
    with plain_versions():
        want = fn()
    return compare(label, got, want, tol32)


def _grads(loss, leaves):
    import torch
    return list(torch.autograd.grad(loss, leaves))


# --- flash attention (the JAX package's cases) -------------------------------

#: the flash kernels a call launches: 16-bit at D in {32, 64, 128} (the
#: wgmma kernels), or f32 (the generic ones)
WGMMA = ("flash_attn_fwd", "flash_attn_bwd")
GENERIC = ("flash_generic_fwd", "flash_generic_bwd")


def _attn_case(label, b, sq, sk, h, d, *, causal=False, with_bias=False,
               block_q=None, block_k=None, f32=True, seed=0,
               dropout_rate=0.0, dropout_seed=None):
    """The JAX case against the plain versions: at f32 through the generic
    kernels (an f32 case, whose error goes to :data:`ERRS`), then in bf16
    through the wgmma kernels. Returns the bf16 run's error."""
    import torch
    from apex_tpu_torch.ops.attention import flash_attention
    kw = {k_: v_ for k_, v_ in (("block_q", block_q), ("block_k", block_k))
          if v_}
    err = 0.0
    for dt in ((torch.float32, torch.bfloat16) if f32 else (torch.bfloat16,)):
        rnd, _ = seeded(seed)
        q, k, v = (rnd(b, s, h, d, dtype=dt, std=0.5) for s in (sq, sk, sk))
        bias = rnd(b, h, sq, sk, dtype=torch.float32, std=0.5) \
            if with_bias else None
        g = rnd(b, sq, h, d, dtype=torch.float32, std=0.5)

        def run(q=q, k=k, v=v, bias=bias, g=g):
            leaves = [t.detach().requires_grad_(True)
                      for t in (q, k, v) + ((bias,) if with_bias else ())]
            o = flash_attention(*leaves[:3], bias=leaves[3] if with_bias
                                else None, causal=causal,
                                dropout_rate=dropout_rate,
                                dropout_seed=dropout_seed, **kw)
            return [o] + _grads((o.float() * g).sum(), leaves)

        f32_run = dt == torch.float32
        err = _vs_plain(label, run, GENERIC if f32_run else WGMMA)
        if f32_run:
            ERRS[f"{label} f32"] = err
            log(f"  {label} f32 (generic kernels): max_abs_err {err:.3e}")
    return err


@case("attention/basic-256")
def _():
    _attn_case("attention basic-256", 2, 256, 256, 4, 64)


@case("attention/causal-384")
def _():
    _attn_case("attention causal-384", 1, 384, 384, 2, 128, causal=True)


@case("attention/bias-256")
def _():
    _attn_case("attention bias-256", 2, 256, 256, 2, 64, with_bias=True)


@case("attention/bias-native-no-transpose")
def _():
    # the JAX case counts the compiled graph's custom calls (fwd + fused
    # bwd, no transposes); here: one launch of each flash kernel for the
    # biased forward and backward, and no copy of q, k, v into another
    # layout (the kernels read (B, S, H, D) as it is)
    import torch
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops.attention import flash_attention
    rnd, _ = seeded(0)
    B, S, H, D = 2, 256, 4, 64
    q, k, v = (rnd(B, S, H, D) for _ in range(3))
    bias = rnd(1, H, S, S, dtype=torch.float32)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    before = ops.launch_counts()
    o = flash_attention(*leaves, bias)
    _grads((o.float() ** 2).sum(), leaves)
    now = ops.launch_counts()
    got = {k_: now[k_] - before[k_] for k_ in ("flash_attn_fwd",
                                                "flash_attn_bwd")}
    if got != {"flash_attn_fwd": 1, "flash_attn_bwd": 1}:
        raise AssertionError(f"biased attention launched {got}")
    _attn_case("attention bias-native", B, S, S, H, D, with_bias=True,
               f32=False)


@case("attention/short-seq-multihead")
def _():
    # sq < 128 with several heads: half a CUDA tile of rows
    _attn_case("attention short-seq", 2, 64, 64, 4, 64)


@case("attention/cross-200x112")
def _():
    # ragged cross-attention lengths: tail masking on both sides
    _attn_case("attention cross-200x112", 1, 200, 112, 3, 64)


@case("attention/nonpow2-block-pref")
def _():
    # block_k=384 over sk=400 with a bias: a caller's tile preference
    # that the CUDA kernels do not take (they keep their own tile)
    _attn_case("attention nonpow2-block-pref", 1, 256, 400, 2, 64,
               with_bias=True, block_k=384)


@case("attention/bf16-512")
def _():
    _attn_case("attention bf16-512", 1, 512, 512, 4, 64, f32=False)


@case("attention/long-2048-1024tiles")
def _():
    _attn_case("attention long-2048", 1, 2048, 2048, 2, 64, causal=True,
               f32=False)


@case("attention/long-bias-2048")
def _():
    _attn_case("attention long-bias-2048", 1, 2048, 2048, 1, 64,
               with_bias=True, f32=False)


@case("attention/dropout-runs-finite")
def _():
    import torch
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops.attention import flash_attention
    for dt, kernels in ((torch.float32, GENERIC), (torch.bfloat16, WGMMA)):
        for s in (256, 2048):
            rnd, _ = seeded(s)
            leaves = [rnd(1, s, 2, 64, dtype=dt).requires_grad_(True)
                      for _ in range(3)]
            before = ops.launch_counts()
            o = flash_attention(*leaves, dropout_rate=0.1, dropout_seed=7)
            loss = (o.float() ** 2).sum()
            grads = _grads(loss, leaves)
            _launched(before, kernels)
            if not math.isfinite(loss.item()) or not all(
                    torch.isfinite(t).all() for t in grads):
                raise AssertionError(f"dropout S={s} {dt}: a non-finite "
                                     f"value")


@case("attention/dropout-mask-equivalence-256")
def _():
    # the kernels and the plain versions draw the one hashed keep mask
    # (kernels-phase mask probe reads it bit for bit)
    _attn_case("attention dropout 256", 1, 256, 256, 2, 64,
               dropout_rate=0.3, dropout_seed=11)


@case("attention/dropout-mask-equivalence-2048")
def _():
    _attn_case("attention dropout 2048", 1, 2048, 2048, 2, 64, causal=True,
               dropout_rate=0.3, dropout_seed=11)


@case("attention/dropout-bias-grad-equivalence")
def _():
    _attn_case("attention dropout bias 384", 1, 384, 384, 2, 64,
               with_bias=True, dropout_rate=0.3, dropout_seed=11)


@case("attention/fp32-1024-gpack-vmem")
def _():
    _attn_case("attention 4x1024", 4, 1024, 1024, 4, 64)


@case("attention/lse-dropout-block-offset")
def _():
    import torch
    from apex_tpu_torch.ops.attention import flash_attention_lse
    dbo = [2, 3]
    for dt, kernels in ((torch.float32, GENERIC), (torch.bfloat16, WGMMA)):
        rnd, _ = seeded(0)
        q, k, v = (rnd(1, 512, 2, 64, dtype=dt) for _ in range(3))
        g = rnd(1, 512, 2, 64, dtype=dt)

        def run(q=q, k=k, v=v, g=g):
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o, lse = flash_attention_lse(*leaves, dropout_rate=0.3,
                                         dropout_seed=9,
                                         dropout_block_offset=dbo)
            loss = (o.float() * g.float()).sum() + 1e-3 * lse.sum()
            return [o, lse] + _grads(loss, leaves)

        err = _vs_plain("attention lse block offset", run, kernels)
        if dt == torch.float32:
            ERRS["attention lse block offset f32"] = err
            log(f"  attention lse block offset f32 (generic kernels): "
                f"max_abs_err {err:.3e}")


@case("attention/ring-hop-shapes")
def _():
    # a ring hop: the causal frontier at a runtime offset (the second
    # shard's queries against the first shard's keys) and the additive
    # (1, 1, sq, sk) bias it replaced, grads through (o, lse) both
    import torch
    from apex_tpu_torch.ops.attention import flash_attention_lse
    rnd, _ = seeded(0)
    sq = sk = 1024
    q, k, v = (rnd(1, s, 2, 64, std=0.5) for s in (sq, sk, sk))
    g = rnd(1, sq, 2, 64, dtype=torch.float32)
    rows = torch.arange(sq, device=DEVICE)[:, None] + sq
    cols = torch.arange(sk, device=DEVICE)[None, :]
    bias = torch.where(rows >= cols, 0.0, -1e9).reshape(1, 1, sq, sk)
    off = torch.tensor([sq], dtype=torch.int32, device=DEVICE)
    outs = {}
    for form, kw in (("offset", dict(causal=True, causal_offset=off)),
                     ("bias", dict(bias=bias))):
        def run(kw=kw):
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o, lse = flash_attention_lse(*leaves, **kw)
            loss = (o.float() * g).sum() + 1e-3 * lse.sum()
            return [o, lse] + _grads(loss, leaves)
        _vs_plain(f"ring hop ({form})", run,
                  ("flash_attn_fwd", "flash_attn_bwd"))
        outs[form] = run()[0]
    compare("ring hop offset vs bias", [outs["offset"]], [outs["bias"]])


@case("attention/ulysses-resharded")
def _():
    # the Ulysses re-shard: long local sequence, 2 local heads, causal
    _attn_case("attention ulysses", 2, 2048, 2048, 2, 64, causal=True,
               f32=False)


# --- LayerNorm, MLP, cross-entropy (the JAX package's cases) ------------------

def _ln_case(label, n, h, dtype_name="float32"):
    import torch
    from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine
    dt = getattr(torch, dtype_name)
    rnd, _ = seeded(0)
    x = rnd(n, h, dtype=dt)
    w = rnd(h, dtype=torch.float32) * 0.5 + 1.0
    b = rnd(h, dtype=torch.float32) * 0.1
    g = rnd(n, h, dtype=dt)

    def run():
        leaves = [t.detach().requires_grad_(True) for t in (x, w, b)]
        y = fused_layer_norm_affine(*leaves)
        return [y] + _grads((y.float() * g.float()).sum(), leaves)

    return _vs_plain(label, run, ("layer_norm_fwd", "layer_norm_bwd"))


@case("layer_norm/1024")
def _():
    _ln_case("layer_norm 257x1024", 257, 1024)


@case("layer_norm/odd-769")
def _():
    _ln_case("layer_norm 64x769", 64, 769)


@case("layer_norm/narrow-48")
def _():
    _ln_case("layer_norm 33x48", 33, 48)


@case("layer_norm/bf16-1024")
def _():
    _ln_case("layer_norm bf16 128x1024", 128, 1024, "bfloat16")


@case("mlp/3-layer-odd-widths")
def _():
    import torch
    from apex_tpu_torch.ops.mlp import fused_mlp
    rnd, _ = seeded(0)
    f32 = torch.float32
    x = rnd(96, 224, dtype=f32)
    ws = [rnd(224, 200, dtype=f32, std=0.1), rnd(200, 136, dtype=f32,
                                                 std=0.1),
          rnd(136, 10, dtype=f32, std=0.1)]
    bs = [rnd(d, dtype=f32, std=0.1) for d in (200, 136, 10)]
    g = rnd(96, 10, dtype=f32)

    def run():
        leaves = [t.detach().requires_grad_(True) for t in [x] + ws + bs]
        y = fused_mlp(leaves[0], leaves[1:4], leaves[4:], "relu")
        return [y] + _grads((y * g).sum(), leaves)

    _vs_plain("mlp 96x[224, 200, 136, 10]", run, ("mlp_fwd",))


def _xent_case(label, n, v, smoothing):
    import torch
    from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
    rnd, gen = seeded(0)
    x = rnd(n, v, dtype=torch.float32, std=2.0)
    labels = torch.randint(0, v, (n,), generator=gen, device=DEVICE)
    g = rnd(n, dtype=torch.float32)

    def run():
        xl = x.detach().requires_grad_(True)
        loss = softmax_cross_entropy_loss(xl, labels, smoothing)
        return [loss] + _grads((loss * g).sum(), [xl])

    _vs_plain(label, run, ("xentropy_fwd", "xentropy_bwd"))


@case("xentropy/odd-vocab-1003")
def _():
    _xent_case("xentropy 37x1003", 37, 1003, 0.0)


@case("xentropy/bert-vocab-smoothing")
def _():
    _xent_case("xentropy 64x30528 smoothing 0.1", 64, 30528, 0.1)


# --- arena kernels (the JAX package's cases) -----------------------------------

def _arena_buf(n_logical, seed, dtype_name="float32"):
    """A flat arena buffer: n_logical live values, zero padding up to the
    next multiple of ``BUFFER_MULTIPLE`` (the tail-partition case)."""
    import torch
    from apex_tpu_torch.arena import BUFFER_MULTIPLE
    n = -(-n_logical // BUFFER_MULTIPLE) * BUFFER_MULTIPLE
    rnd, _ = seeded(seed)
    out = torch.zeros(n, dtype=getattr(torch, dtype_name), device=DEVICE)
    out[:n_logical] = rnd(n_logical, dtype=torch.float32)
    return out


def check_flagged(name, got, want):
    """(out, all-finite flag) of a kernel against its plain version: flags
    equal, outputs within TOL_ARENA (16-bit: TOL16) of the largest."""
    if bool(got[1]) != bool(want[1]):
        raise AssertionError(f"{name}: flag {bool(got[1])}, plain "
                             f"{bool(want[1])}")
    return compare(name, [got[0]], [want[0]], TOL_ARENA)


@case("multi_tensor/scale-axpby-norms")
def _():
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import multi_tensor as M
    x, y = _arena_buf(100_003, 0), _arena_buf(100_003, 1)
    before = ops.launch_counts()
    got = [M.multi_tensor_scale(x, 0.25), M.multi_tensor_axpby(2.0, x, -0.5,
                                                               y)]
    norms = [M.multi_tensor_l2norm(x), M.multi_tensor_maxnorm(x)]
    _launched(before, ("multi_tensor_scale", "multi_tensor_axpby",
                       "multi_tensor_l2norm", "multi_tensor_maxnorm"))
    with plain_versions():
        want = [M.multi_tensor_scale(x, 0.25),
                M.multi_tensor_axpby(2.0, x, -0.5, y)]
        wnorms = [M.multi_tensor_l2norm(x), M.multi_tensor_maxnorm(x)]
    for name, a, b in zip(("scale", "axpby"), got, want):
        check_flagged(f"multi_tensor_{name} tail partition", a, b)
    compare("multi_tensor norms tail partition", norms, wnorms, TOL_ARENA)
    bad = x.clone()
    bad[17] = float("inf")
    if bool(M.multi_tensor_scale(bad, 1.0)[1]):
        raise AssertionError("an inf left the scale flag True")


def _optim_case(label, fn, kernels, *bufs):
    return _vs_plain(label, lambda: list(fn(*bufs)), kernels, TOL_ARENA)


@case("optim/adam")
def _():
    import torch
    from apex_tpu_torch.ops.optim_kernels import adam_update
    p, g = _arena_buf(70_001, 0), _arena_buf(70_001, 1)
    m, v = _arena_buf(70_001, 2) * 0.1, _arena_buf(70_001, 3).abs() * 0.1
    _optim_case("optim adam", lambda *a: adam_update(
        *a, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
        step=3, param_copy_dtype=torch.bfloat16), ("adam",), p, g, m, v)


@case("optim/sgd-nesterov-copy")
def _():
    import torch
    from apex_tpu_torch.ops.optim_kernels import sgd_update
    p, g, m = (_arena_buf(70_001, 0), _arena_buf(70_001, 1),
               _arena_buf(70_001, 2) * 0.1)
    _optim_case("optim sgd nesterov", lambda *a: sgd_update(
        *a, lr=0.1, momentum=0.9, weight_decay=1e-4, nesterov=True,
        param_copy_dtype=torch.bfloat16), ("sgd",), p, g, m)


@case("optim/adagrad")
def _():
    from apex_tpu_torch.ops.optim_kernels import adagrad_update
    p, g = _arena_buf(70_001, 0), _arena_buf(70_001, 1)
    h = _arena_buf(70_001, 2).abs() * 0.1
    _optim_case("optim adagrad", lambda *a: adagrad_update(
        *a, lr=0.01, weight_decay=1e-4), ("adagrad",), p, g, h)


@case("optim/lamb-two-stage")
def _():
    from apex_tpu_torch.ops.optim_kernels import lamb_stage1, lamb_stage2
    p, g = _arena_buf(70_001, 0), _arena_buf(70_001, 1)
    m, v = _arena_buf(70_001, 2) * 0.1, _arena_buf(70_001, 3).abs() * 0.1
    ratio = _arena_buf(70_001, 4).abs() * 0.01 + 1.0

    def step(p, g, m, v, ratio):
        u, m2, v2 = lamb_stage1(p, g, m, v, beta1=0.9, beta2=0.999,
                                eps=1e-6, weight_decay=0.01, step=2)
        return [lamb_stage2(p, u, ratio, lr=1e-3), m2, v2]

    _optim_case("optim lamb", step, ("lamb_stage1", "lamb_stage2"), p, g,
                m, v, ratio)


@case("optim/novograd")
def _():
    from apex_tpu_torch.ops.optim_kernels import novograd_update
    p, g = _arena_buf(70_001, 0), _arena_buf(70_001, 1)
    m = _arena_buf(70_001, 2) * 0.1
    vnorm = _arena_buf(70_001, 3).abs() + 0.1
    _optim_case("optim novograd", lambda *a: novograd_update(
        *a, lr=1e-3, beta1=0.95, beta2=0.98, eps=1e-8, weight_decay=1e-3,
        step=2), ("novograd",), p, g, m, vnorm)


# --- fused BN unit (the JAX package's cases) ------------------------------------

def _bn_case(label, shape, with_res):
    import torch
    from apex_tpu_torch.ops.bn_act import (bn_act_train, bn_add_act_train,
                                           make_cfg)
    rnd, _ = seeded(0)
    c = shape[-1]
    x, r = rnd(*shape), rnd(*shape)
    s = rnd(c, dtype=torch.float32) * 0.5 + 1.0
    b = rnd(c, dtype=torch.float32) * 0.1
    g = rnd(*shape, dtype=torch.float32)
    cfg = make_cfg(relu=True)

    def run():
        leaves = [t.detach().requires_grad_(True)
                  for t in ((x, r, s, b) if with_res else (x, s, b))]
        z = (bn_add_act_train(*leaves, cfg) if with_res
             else bn_act_train(*leaves, cfg))[0]
        return [z] + _grads((z.float() * g).sum(), leaves)

    _vs_plain(label, run, ("bn_sums", "bn_dx"))


@case("bn_act/relu-grads")
def _():
    # odd spatial (14x14) and the C=64 channel case
    _bn_case("bn_act relu 16x14x14x64", (16, 14, 14, 64), False)


@case("bn_act/add-relu-grads")
def _():
    _bn_case("bn_act add-relu 8x14x14x64", (8, 14, 14, 64), True)


@case("bn_act/pallas-bwd-variant")
def _():
    # the JAX package's opt-in Pallas two-pass backward over its channel
    # grid; the port has one BN backward (the CUDA sums and the Triton
    # dx), run here over the same grid
    for c, with_res in ((64, False), (256, True), (2048, True)):
        _bn_case(f"bn_act 8x7x7x{c}", (8, 7, 7, c), with_res)


# --- the kernel phase's checks: LayerNorm ---------------------------------------

@case("kernels/layer_norm-bert")
def _():
    """LayerNorm at BERT's (8192, 1024) bf16, eps 1e-12 and 1e-5, and a
    ragged (300, 1000): forward and backward against the plain versions."""
    import torch
    from apex_tpu_torch.ops import layer_norm as L
    rnd, _ = seeded(1)
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
    ERRS.update(layer_norm_fwd=fwd_err, layer_norm_bwd=bwd_err)


@case("kernels/layer_norm-paths")
def _():
    """The LayerNorm forward kernel's other paths against the plain
    version: a ragged H = 300 and a base off 16 bytes (one element a load),
    f32 and fp16 rows, no affine, 16-bit weights, H = 2048 (64 elements a
    lane), H = 4096 (a block a row, staged in shared memory) and an f32 row
    of 70000 (a block a row, read from device memory)."""
    import torch
    from apex_tpu_torch.ops import layer_norm as L
    rnd, _ = seeded(2)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    cases = [((512, 300), bf16, f32), ((100, 768), f32, f32),
             ((33, 1024), f16, None), ((64, 1024), bf16, bf16),
             ((50, 2048), bf16, f32), ((9, 4096), bf16, f32),
             ((3, 70000), f32, f32)]
    for (n, h), dt, wdt in cases:
        x = (rnd(n, h, dtype=f32, std=2.0) + 0.5).to(dt)
        w = None if wdt is None else rnd(h, dtype=f32, std=0.2).to(wdt) + 1
        b = None if wdt is None else rnd(h, dtype=f32, std=0.2).to(wdt)
        compare(f"layer_norm_fwd {n}x{h} {dt} weights {wdt}",
                [L.ln_fwd_kernel(x, w, b, 1e-5)],
                [L.ln_fwd_plain(x, w, b, 1e-5)])
    # bases off 16 bytes: one element a load, f32 past 512 a block a row
    off = [((128, 1024), bf16), ((64, 300), f32), ((32, 1000), f32)]
    for (n, h), dt in off:
        x = rnd(n * h + 1, dtype=dt)[1:].view(n, h)
        w, b = rnd(h, dtype=f32) + 1.0, rnd(h, dtype=f32)
        compare(f"layer_norm_fwd {n}x{h} {dt} off 16 bytes",
                [L.ln_fwd_kernel(x, w, b, 1e-5)],
                [L.ln_fwd_plain(x, w, b, 1e-5)])
    log(f"  layer_norm fwd agrees with the plain version on "
        f"{len(cases) + len(off)} more shapes (ragged, off 16 bytes, f32, "
        f"fp16, no affine, 16-bit weights, H = 2048, 4096, 70000)")


@case("kernels/layer_norm-bwd-paths")
def _():
    """The LayerNorm backward kernel on every path of its plan against the
    plain version: 16-byte vectors (bf16 at 1024 and 2048, f32 rows of
    512 and 768, a ragged H = 1000), one element a load (H = 300, bases
    off 16 bytes), fp16 without affine params, bf16 weights, n below the
    grid (5 rows, one block) and just past a block a warp row, a block a
    row staged in shared memory (H = 4096 and 8192) and read from device
    memory (f32, H = 70000). dγ and dβ within TOL32 of the plain sums."""
    import torch
    from apex_tpu_torch.ops import layer_norm as L
    rnd, _ = seeded(3)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    cases = [((300, 1000), bf16, f32), ((257, 512), f32, f32),
             ((100, 768), f32, f32), ((512, 300), bf16, f32),
             ((33, 1024), f16, None), ((64, 1024), bf16, bf16),
             ((50, 2048), bf16, f32), ((5, 1024), bf16, f32),
             ((2049, 1024), bf16, f32), ((9, 4096), bf16, f32),
             ((6, 8192), bf16, f32), ((3, 70000), f32, f32),
             ((40, 1500), f32, None)]
    paths = set()
    for (n, h), dt, wdt in cases:
        x = (rnd(n, h, dtype=f32, std=2.0) + 0.5).to(dt)
        g = rnd(n, h, dtype=dt)
        w = None if wdt is None else (rnd(h, dtype=f32, std=0.2) + 1).to(wdt)
        outs = [L.ln_bwd_kernel(g, x, w, 1e-5), L.ln_bwd_plain(g, x, w, 1e-5)]
        compare(f"layer_norm_bwd {n}x{h} {dt} weights {wdt}",
                *[o if w is not None else o[:1] for o in outs])
        paths.add(L._ln_bwd_plan(n, h, x.element_size(), True)[0])
    off = [((128, 1024), bf16), ((64, 300), f32), ((32, 1000), f32)]
    for (n, h), dt in off:
        x = rnd(n * h + 1, dtype=dt)[1:].view(n, h)
        g = rnd(n * h + 1, dtype=dt)[1:].view(n, h)
        w = rnd(h, dtype=f32) + 1.0
        compare(f"layer_norm_bwd {n}x{h} {dt} off 16 bytes",
                L.ln_bwd_kernel(g, x, w, 1e-5), L.ln_bwd_plain(g, x, w, 1e-5))
        paths.add(L._ln_bwd_plan(n, h, x.element_size(), False)[0])
    if paths != {L._SCALAR, L._VECTOR, L._STAGED, L._STREAMED}:
        raise AssertionError(f"layer_norm_bwd: paths checked {paths}")


@case("kernels/norm-determinism")
def _():
    """Two launches of the LayerNorm forward (BERT's (8192, 1024) bf16) and
    of the BN sums (the stem's (3211264, 64) bf16, "addrelu") are bitwise
    equal: a warp owns a row, and the sums' blocks and their order are
    fixed by the shape."""
    import torch
    from apex_tpu_torch.ops import bn_act as B
    from apex_tpu_torch.ops import layer_norm as L
    rnd, _ = seeded(4)
    f32 = torch.float32
    x = rnd(8192, 1024, std=2.0) + 0.5
    w, b = rnd(1024, dtype=f32, std=0.2) + 1.0, rnd(1024, dtype=f32, std=0.2)
    if not torch.equal(L.ln_fwd_kernel(x, w, b, 1e-12),
                       L.ln_fwd_kernel(x, w, b, 1e-12)):
        raise AssertionError("layer_norm_fwd: two launches differ")
    m, c = 3211264, 64
    x, g = rnd(m, c, std=2.0) + 0.5, rnd(m, c, std=1e-3)
    z = rnd(m, c).clamp_min(0.0)
    mean = x.float().mean(dim=0)
    invstd = torch.rsqrt(x.float().var(dim=0, unbiased=False) + 1e-5)
    args = (x, g, z, rnd(c) + 1.0, rnd(c), mean, invstd, "addrelu",
            torch.bfloat16)
    (s1, d1), (s2, d2) = B.bn_sums_kernel(*args), B.bn_sums_kernel(*args)
    if not (torch.equal(s1, s2) and torch.equal(d1, d2)):
        raise AssertionError("bn_sums: two launches differ")


@case("kernels/layer_norm-bwd-determinism")
def _():
    """Two launches of the LayerNorm backward bitwise equal in dx, dγ and
    dβ at BERT's (8192, 1024) bf16, a ragged (300, 1000) and a block a row
    (9, 4096): the blocks' rows and the order of every sum are fixed by
    the shape."""
    import torch
    from apex_tpu_torch.ops import layer_norm as L
    rnd, _ = seeded(5)
    for n, h in ((8192, 1024), (300, 1000), (9, 4096)):
        x = rnd(n, h, std=2.0) + 0.5
        g = rnd(n, h)
        w = rnd(h, dtype=torch.float32, std=0.2) + 1.0
        one, two = L.ln_bwd_kernel(g, x, w, 1e-5), L.ln_bwd_kernel(g, x, w,
                                                                   1e-5)
        for name, a, b in zip(("dx", "dgamma", "dbeta"), one, two):
            if not torch.equal(a, b):
                raise AssertionError(f"layer_norm_bwd {n}x{h}: two launches "
                                     f"differ in {name}")


# --- the kernel phase's checks: cross-entropy -------------------------------------

@case("kernels/xentropy-bert")
def _():
    """Cross-entropy at BERT's (8192, 30522) bf16 logits, labels with -1,
    smoothing 0 and 0.1."""
    import torch
    from apex_tpu_torch.ops import xentropy as X
    rnd, gen = seeded(6)
    n, v = 8192, 30522
    logits = rnd(n, v, std=3.0)
    labels = torch.randint(0, v, (n,), generator=gen, device=DEVICE)
    labels[torch.rand(n, generator=gen, device=DEVICE) < 0.15] = -1
    gl = torch.rand(n, generator=gen, device=DEVICE)
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
    ERRS.update(xentropy_fwd=fwd_err, xentropy_bwd=bwd_err)


@case("kernels/xentropy-resnet")
def _():
    """Cross-entropy at ResNet-50's (256, 1000) bf16 logits (every label
    valid, the mean's 1/256 as the incoming gradient)."""
    import torch
    from apex_tpu_torch.ops import xentropy as X
    rnd, gen = seeded(7)
    n, v = 256, 1000
    logits = rnd(n, v, std=3.0)
    labels = torch.randint(0, v, (n,), generator=gen, device=DEVICE)
    gl = torch.full((n,), 1.0 / n, device=DEVICE)
    compare("xentropy_fwd (256, 1000)",
            X.xentropy_fwd_kernel(logits, labels, 0.0),
            X.xentropy_fwd_plain(logits, labels, 0.0))
    _, lse = X.xentropy_fwd_plain(logits, labels, 0.0)
    compare("xentropy_bwd (256, 1000)",
            [X.xentropy_bwd_kernel(logits, labels, lse, gl, 0.0)],
            [X.xentropy_bwd_plain(logits, labels, lse, gl, 0.0)])


@case("kernels/xentropy-labels")
def _():
    """Labels >= V: (4096, 1000) bf16 logits, a view of the first 4096
    rows of a buffer whose next row is NaN, with labels V, V+5 and 2**31-1
    on many rows, -1 on some and V on the last row; smoothing 0 and 0.1.
    Only a label in [0, V) names a column, so the forward must read no
    logit outside its row: a read of another row's logit shows as a wrong
    loss, and one past the last row as a NaN, against the plain
    versions."""
    import torch
    from apex_tpu_torch.ops import xentropy as X
    rnd, gen = seeded(8)
    n, v = 4096, 1000
    buf = rnd(n + 1, v, std=3.0)
    buf[n] = float("nan")
    logits = buf[:n]
    labels = torch.randint(0, v, (n,), generator=gen, device=DEVICE)
    labels[0::7] = v
    labels[1::7] = v + 5
    labels[2::11] = 2 ** 31 - 1
    labels[3::13] = -1
    labels[-1] = v
    gl = torch.rand(n, generator=gen, device=DEVICE)
    for sm in (0.0, 0.1):
        compare(f"xentropy_fwd labels >= V eps={sm}",
                X.xentropy_fwd_kernel(logits, labels, sm),
                X.xentropy_fwd_plain(logits, labels, sm))
        _, lse = X.xentropy_fwd_plain(logits, labels, sm)
        compare(f"xentropy_bwd labels >= V eps={sm}",
                [X.xentropy_bwd_kernel(logits, labels, lse, gl, sm)],
                [X.xentropy_bwd_plain(logits, labels, lse, gl, sm)])


# --- the kernel phase's checks: flash attention -----------------------------------

def padding_bias(gen, b, s):
    """BERT's (B, 1, 1, S) f32 padding bias: lengths from [128, S], 0 on a
    sequence's tokens and -1e9 past its end (the models' mask → bias)."""
    import torch
    lengths = torch.randint(128, s + 1, (b,), generator=gen, device=DEVICE)
    keep = torch.arange(s, device=DEVICE) < lengths[:, None]
    return torch.where(keep, 0.0, -1e9).view(b, 1, 1, s)


def delta_of(do, o):
    b, s, h, _ = o.shape
    return (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(
        b * h, s).contiguous()


@case("kernels/flash-bert")
def _():
    """The flash kernels at BERT's (16, 512, 16, 64) bf16 and a ragged
    (2, 200, 4, 64) in bf16 and fp16 against the plain versions."""
    import torch
    from apex_tpu_torch.ops import attention as A
    rnd, _ = seeded(9)
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
        e2 = compare(f"flash_attn_bwd {shape} {dt}",
                     A.flash_bwd_kernel(q, k, vv, do, lse, delta_of(do, o),
                                        scale),
                     A.flash_bwd_plain(q, k, vv, do, lse, delta_of(do, o),
                                       scale))
        if s == 512:
            ERRS.update(flash_attn_fwd=e1, flash_attn_bwd=e2)


@case("kernels/flash-options")
def _():
    """The flash kernels' options against their plain versions (TOL16 for
    16-bit outputs, TOL32 for lse): BERT's shape with the padding bias and
    dropout 0.1; Sq 200 / Sk 328 at H = 3 in fp16, causal at the default
    frontier, at a runtime offset and with dropout; D = 128 with a full
    bias; D = 32 with a head bias and dropout; dropout block offsets; a
    multi-block S = 600 (the JAX dropout blocks are 128 there) with padding
    and dropout; Sq > Sk causal, whose first rows see no key (o = 0, lse =
    -1e30, zero gradients); H = 15."""
    import torch
    from apex_tpu_torch.ops import attention as A
    rnd, gen = seeded(10)
    bf16, fp16, f32 = torch.bfloat16, torch.float16, torch.float32

    def i32(*vals):
        return torch.tensor(vals, dtype=torch.int32, device=DEVICE)

    cases = [
        ("BERT padding+dropout", (16, 512, 512, 16, 64), bf16,
         dict(bias=padding_bias(gen, 16, 512), rate=0.1, seed=i32(12345))),
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
         dict(bias=padding_bias(gen, 2, 600), rate=0.1, seed=i32(5))),
        ("Sq>Sk causal", (2, 200, 128, 2, 64), bf16, dict(causal=True)),
        ("H15", (16, 512, 512, 15, 64), bf16, {}),
    ]
    rows = {"BERT padding+dropout": "mask_dropout", "H15": "h15"}
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
        delta = delta_of(do, o_p)
        e2 = compare(f"flash_attn_bwd {label}",
                     A.flash_bwd_kernel(q, k, v, do, lse_p, delta, scale,
                                        **opts),
                     A.flash_bwd_plain(q, k, v, do, lse_p, delta, scale,
                                       **opts))
        log(f"  flash attention {label} {(b, sq, sk, h, d)} "
            f"{str(dt)[6:]}: fwd max_abs_err {e1:.3e}, bwd {e2:.3e}"
            + (f", {n_blind} rows see no key" if n_blind else ""))
        if label in rows:
            ERRS[f"flash_attn_fwd_{rows[label]}"] = e1
            ERRS[f"flash_attn_bwd_{rows[label]}"] = e2


def _mask_probe(s, blocks, dtype, d, seed, b=2, h=2, rate=0.1):
    """The keep mask read out of ``flash_attention`` at S = ``s`` for
    (dtype, D = ``d``): windows of ``d`` keys (see the case); returns
    (wrong bits, kept share, windows, dropout blocks)."""
    import torch
    from apex_tpu_torch.ops import attention as A
    kw = dict(zip(("block_q", "block_k"), blocks))
    qk = torch.zeros(b, s, h, d, dtype=dtype, device=DEVICE)
    got = torch.zeros(b * h, s, s, dtype=torch.bool, device=DEVICE)
    starts = list(range(0, s - d + 1, d))
    if starts[-1] + d < s:
        starts.append(s - d)
    eye = torch.eye(d, dtype=dtype, device=DEVICE)
    for j0 in starts:
        bias = torch.full((1, 1, 1, s), -1e9, device=DEVICE)
        bias[..., j0:j0 + d] = 0.0
        v = torch.zeros_like(qk)
        v[:, j0:j0 + d] = eye[None, :, None, :]
        o = A.flash_attention(qk, qk, v, bias=bias, dropout_rate=rate,
                              dropout_seed=seed, **kw)
        bits = o.float() * d * (1 - rate) > 0.5          # (b, s, h, d)
        got[:, :, j0:j0 + d] = bits.transpose(1, 2).reshape(b * h, s, d)
    drop = A._dropout_blocks(s, s, *blocks)
    want = A._keep_mask_dense(seed, b, h, s, s, *drop, rate)
    return (int((got != want).sum()), want.float().mean().item(),
            len(starts), drop, want.numel())


@case("kernels/flash-mask-probe")
def _():
    """The dropout keep mask read out of the forward kernel through
    ``flash_attention``, bit for bit against the plain ``_keep_mask_dense``
    (a tolerance alone can miss a wrong bit: at S = 512 one changed keep
    bit moves o by about 1/512). With q = k = 0 and a (1, 1, 1, S) bias 0
    on keys [j0, j0 + D) and -1e9 elsewhere, p is 1/D on that window; v
    is the identity there, so o[r, d]·D·(1 − rate) is 1 where keep[r, j0 +
    d] and 0 where not (> 0.5 read as kept). j0 sweeps the keys, at S =
    512 (one JAX dropout block), S = 600 (blocks of 128), S = 64 (the MHA
    benchmark's length: one block of 64, half a CUDA tile of rows) and S =
    512 with the caller's ``block_q = block_k = 128`` (blocks of 128), B =
    H = 2: in bf16 at D = 64 through the wgmma kernels, and through the
    generic kernels in f32 at D = 64 and in bf16 at D = 80 (ViT-H's head),
    at S = 512 and 600 and with the caller's blocks of 128."""
    import torch
    from apex_tpu_torch import ops
    seed = torch.tensor([-1234567], dtype=torch.int32, device=DEVICE)
    geos = ((512, ()), (600, ()), (64, ()), (512, (128, 128)))
    for dtype, d, kernels, sizes in (
            (torch.bfloat16, 64, WGMMA, geos),
            (torch.float32, 64, GENERIC, (geos[0], geos[1], geos[3])),
            (torch.bfloat16, 80, GENERIC, (geos[0], geos[1], geos[3]))):
        for s, blocks in sizes:
            before = ops.launch_counts()
            wrong, kept, n, drop, total = _mask_probe(s, blocks, dtype, d,
                                                      seed)
            _launched(before, kernels[:1])
            if wrong:
                raise AssertionError(
                    f"mask probe {dtype} D={d} S={s} blocks {blocks}: "
                    f"{wrong} of {total} keep bits differ")
            log(f"  mask probe {str(dtype)[6:]} D={d} S={s} "
                f"{blocks or 'default blocks'} ({kernels[0]}, dropout "
                f"blocks {drop}): {total} keep bits equal the plain mask "
                f"bit for bit (kept {kept:.4f}, {n} windows)")


@case("kernels/flash-determinism")
def _():
    """Two launches of each flash kernel on the same inputs are bitwise
    equal (each block owns its outputs and sums them in a fixed order, no
    atomics): BERT's (16, 512, 16, 64) bf16 as it is and with the padding
    bias and dropout 0.1."""
    import torch
    from apex_tpu_torch.ops import attention as A
    rnd, gen = seeded(11)
    seed = torch.tensor([4321], dtype=torch.int32, device=DEVICE)
    for label, opts in (("BERT", {}), ("BERT padding+dropout", dict(
            bias=padding_bias(gen, 16, 512), rate=0.1, seed=seed))):
        q, k, v, do = (rnd(16, 512, 16, 64) for _ in range(4))
        scale = 0.125
        runs = [A.flash_fwd_kernel(q, k, v, scale, **opts) for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"flash_attn_fwd {label}: two launches "
                                 f"differ")
        o, lse = runs[0]
        runs = [A.flash_bwd_kernel(q, k, v, do, lse, delta_of(do, o), scale,
                                   **opts) for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"flash_attn_bwd {label}: two launches "
                                 f"differ")


@case("kernels/flash-s64")
def _():
    """The flash kernels at the reference Apex's MHA benchmark's shape,
    (128, 64, 16, 64) fp16 with dropout 0.1: each against its plain
    version. At S = 64 each persistent block's 128-row tile holds 64 real
    rows."""
    import torch
    from apex_tpu_torch.ops import attention as A
    rnd, _ = seeded(12)
    b, s, h, d = MHA_B, MHA_S, MHA_HEADS, MHA_D
    opts = dict(rate=0.1, seed=torch.tensor([2024], dtype=torch.int32,
                                            device=DEVICE))
    q, k, v, do = (rnd(b, s, h, d, dtype=torch.float16) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    ERRS["flash_attn_fwd_s64"] = compare(
        "flash_attn_fwd S64", A.flash_fwd_kernel(q, k, v, scale, **opts),
        A.flash_fwd_plain(q, k, v, scale, **opts))
    o, lse = A.flash_fwd_plain(q, k, v, scale, **opts)
    ERRS["flash_attn_bwd_s64"] = compare(
        "flash_attn_bwd S64",
        A.flash_bwd_kernel(q, k, v, do, lse, delta_of(do, o), scale, **opts),
        A.flash_bwd_plain(q, k, v, do, lse, delta_of(do, o), scale, **opts))


@case("kernels/flash-generic")
def _():
    """The generic flash kernels (every operand the wgmma kernels refuse)
    against the plain versions: BERT-Large's attention in f32 (16, 512,
    16, 64) as it is and with the padding bias and dropout 0.1, and
    ViT-H/14's (16, 257, 16, 80) in bf16 (the kernels-JSON rows); then,
    for correctness only, D = 1, 33, 48, 96, 160, 255 and 256 in bf16 and
    fp16 (causal Sq 200 / Sk 328 at H = 3, D = 160 with a head bias and
    dropout), f32 at D = 80 and 256 causal and at D = 128 with a full
    bias, Sq > Sk causal in f32 (rows that see no key: o = 0, lse =
    -1e30), and q, k, v, do cut from a larger tensor at an element offset
    that leaves their first element off 16-byte alignment (f32 at D = 64
    and bf16 at D = 80 one element on: 4- and 2-byte copies; fp16 at D =
    80 four on: 8-byte copies). Two launches of each at BERT's f32 shape
    as it is and with dropout, and at D = 80, are bitwise equal. TOL32 for
    f32 outputs, TOL16 for 16-bit ones."""
    import torch
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import attention as A
    rnd, gen = seeded(14)
    bf16, fp16, f32 = torch.bfloat16, torch.float16, torch.float32

    def i32(*vals):
        return torch.tensor(vals, dtype=torch.int32, device=DEVICE)

    def offset(shape, dt, off):
        """A (B, S, H, D) tensor starting ``off`` elements into a larger
        one (off = 0: a tensor of its own)."""
        n = math.prod(shape)
        return rnd(n + off, dtype=dt)[off:].view(shape)

    cases = [
        ("", (16, 512, 512, 16, 64), f32, {}, 0),
        ("_mask_dropout", (16, 512, 512, 16, 64), f32,
         dict(bias=padding_bias(gen, 16, 512), rate=0.1, seed=i32(12345)),
         0),
        ("_d80", (16, 257, 257, 16, 80), bf16, {}, 0),
    ]
    for d in (1, 33, 48, 96, 160, 255, 256):
        for dt in (bf16, fp16):
            opts = (dict(bias=rnd(1, 3, 200, 328, dtype=f32), rate=0.1,
                         seed=i32(9)) if d == 160 else dict(causal=True))
            cases.append((None, (2, 200, 328, 3, d), dt, opts, 0))
    cases += [(None, (2, 200, 328, 3, d), f32, dict(causal=True), 0)
              for d in (80, 256)]
    cases += [(None, (2, 256, 192, 4, 128), f32,
               dict(bias=rnd(2, 4, 256, 192, dtype=f32)), 0),
              (None, (2, 200, 128, 2, 64), f32, dict(causal=True), 0)]
    cases += [(None, (2, 200, 328, 3, d), dt, dict(causal=True), off)
              for d, dt, off in ((64, f32, 1), (80, bf16, 1),
                                 (80, fp16, 4))]
    for row, (b, sq, sk, h, d), dt, opts, off in cases:
        q, do = (offset((b, sq, h, d), dt, off) for _ in range(2))
        k, v = (offset((b, sk, h, d), dt, off) for _ in range(2))
        scale = 1.0 / math.sqrt(d)
        before = ops.launch_counts()
        o_k, lse_k = A.flash_fwd_kernel(q, k, v, scale, **opts)
        o_p, lse_p = A.flash_fwd_plain(q, k, v, scale, **opts)
        blind = lse_p == A.NEG_INF
        if not torch.equal(blind, lse_k == A.NEG_INF) or (
                blind.any() and o_k.transpose(1, 2).reshape(
                    b * h, sq, d)[blind].abs().max().item() != 0.0):
            raise AssertionError(f"flash_generic {dt} D={d}: rows without "
                                 f"a key differ")
        e1 = compare(f"flash_generic_fwd {dt} D={d}", [
            o_k, lse_k.masked_fill(blind, 0.0)], [
            o_p, lse_p.masked_fill(blind, 0.0)])
        delta = delta_of(do, o_p)
        e2 = compare(f"flash_generic_bwd {dt} D={d}",
                     A.flash_bwd_kernel(q, k, v, do, lse_p, delta, scale,
                                        **opts),
                     A.flash_bwd_plain(q, k, v, do, lse_p, delta, scale,
                                       **opts))
        now = ops.launch_counts()
        if any(now[n] - before[n] != 1 for n in GENERIC) or any(
                now[n] != before[n] for n in WGMMA):
            raise AssertionError(f"flash_generic {dt} D={d}: the generic "
                                 f"kernels did not take the call")
        log(f"  flash generic {(b, sq, sk, h, d)} {str(dt)[6:]} "
            f"{sorted(opts)}" + (f", {off} elements off" if off else "")
            + f": fwd max_abs_err {e1:.3e}, bwd {e2:.3e}")
        if row is not None:
            ERRS[f"flash_generic_fwd{row}"] = e1
            ERRS[f"flash_generic_bwd{row}"] = e2
        if row in ("", "_mask_dropout", "_d80"):
            runs = [A.flash_fwd_kernel(q, k, v, scale, **opts)
                    for _ in range(2)]
            grads = [A.flash_bwd_kernel(q, k, v, do, lse_p, delta, scale,
                                        **opts) for _ in range(2)]
            if not all(torch.equal(x, y) for x, y in zip(*runs)) or not all(
                    torch.equal(x, y) for x, y in zip(*grads)):
                raise AssertionError(f"flash_generic{row}: two launches "
                                     f"differ")


@case("kernels/flash-ring-hop")
def _():
    """The flash kernels at a ring hop's shape: BERT-Large's heads (H16,
    D64), B2, a 4096-query shard against a 4096-key block, with the causal
    frontier read from the card at offsets +4096 (the block before this
    rank's: every key visible), 0 (the diagonal) and -4096 (a later rank's
    block, which the ring masks: every row sees no key), and dropout 0.1 at
    block offsets (1, 0); the backward with an lse cotangent (the merge's).
    Rows that see no key give o = 0, lse = -1e30 and zero gradients, not
    NaN, in the kernel and the plain version alike."""
    import torch
    from apex_tpu_torch.ops import attention as A
    rnd, _ = seeded(13)
    b, s, h, d = RING_B, RING_S // SEQ_RANKS, RING_H, RING_D
    q, k, vv, do = (rnd(b, s, h, d) for _ in range(4))
    dlse = rnd(b * h, s, dtype=torch.float32, std=0.1)
    scale = 1.0 / math.sqrt(d)

    def i32(*vals):
        return torch.tensor(vals, dtype=torch.int32, device=DEVICE)

    ef = eb = 0.0
    for off, drop in ((s, False), (0, False), (-s, False), (s, True)):
        kw = dict(causal=True, causal_off=i32(off))
        if drop:
            kw.update(seed=i32(1234), rate=0.1, dbo=i32(1, 0))
        (ko, kl), (po, pl) = (A.flash_fwd_kernel(q, k, vv, scale, **kw),
                              A.flash_fwd_plain(q, k, vv, scale, **kw))
        delta = (delta_of(do, po) - dlse).contiguous()
        kg = A.flash_bwd_kernel(q, k, vv, do, pl, delta, scale, **kw)
        pg = A.flash_bwd_plain(q, k, vv, do, pl, delta, scale, **kw)
        what = f"flash ring hop off={off} dropout={drop}"
        if off < 0:
            for name, t in (("o", ko), ("o plain", po), *(
                    (f"d{x}", t) for x, t in zip("qkv", kg)), *(
                    (f"d{x} plain", t) for x, t in zip("qkv", pg))):
                if not torch.isfinite(t).all() or t.abs().max().item():
                    raise AssertionError(f"{what}: {name} is not all zero "
                                         f"and finite")
            if not (kl == A.NEG_INF).all() or not (pl == A.NEG_INF).all():
                raise AssertionError(f"{what}: lse is not -1e30 everywhere")
            continue
        ef = max(ef, compare(f"{what} fwd", [ko, kl], [po, pl]))
        eb = max(eb, compare(f"{what} bwd", kg, pg))
    ERRS.update(flash_ring_hop_fwd=ef, flash_ring_hop_bwd=eb)


# --- the kernel phase's checks: BN -------------------------------------------------

def bn_inputs(rnd, m, c):
    """(x, g, z, scale, bias, mean, invstd) of a bf16 BN unit's backward:
    f32 statistics of x, and an incoming gradient with a per-channel mean
    and a part along x̂, so k1 and x̂·k2 are as large as g itself."""
    import torch
    x = rnd(m, c, std=2.0) + 0.5
    z = rnd(m, c).clamp_min(0.0)
    scale, bias = rnd(c, std=0.3) + 1.0, rnd(c, std=0.3)
    x32 = x.float()
    mean = x32.mean(dim=0)
    invstd = torch.rsqrt(x32.var(dim=0, unbiased=False) + 1e-5)
    g = ((rnd(m, c, dtype=torch.float32)
          + rnd(c, dtype=torch.float32, std=0.5)
          + rnd(c, dtype=torch.float32, std=0.7) * (x32 - mean) * invstd)
         * 1e-3).to(torch.bfloat16)
    return x, g, z, scale, bias, mean, invstd


def _check_bn_masks(name, args, kdr, pdr, xhat=False):
    """The sums kernel's masks against the plain version's, exactly: dr
    ("addrelu") bit for bit, and the "relu" mask through its count per
    channel (Σg with g = 1, an integer below 2**24, exact in any order)."""
    import torch
    from apex_tpu_torch.ops import bn_act as B
    x, g, z, scale, bias, mean, invstd, mode, r_dtype = args
    if kdr is not None and not torch.equal(kdr, pdr):
        raise AssertionError(f"{name}: dr differs from the plain version")
    if mode == "relu":
        ones = torch.ones_like(g)
        counts = [f(x, ones, z, scale, bias, mean, invstd, mode,
                    xhat=xhat)[0][0]
                  for f in (B.bn_sums_kernel, B.bn_sums_plain)]
        if not torch.equal(*counts):
            raise AssertionError(f"{name}: the ReLU mask's counts differ "
                                 f"from the plain version's")


def _check_bn_dx_faults(name, dx_args, want, m, xhat=False):
    """A dx fed zeroed sums, a negated Σg·x̂ or twice the count must fail
    the check against ``want``."""
    import torch
    from apex_tpu_torch.ops import bn_act as B
    ps = dx_args[6]
    for fault, sums, count in (
            ("zeroed sums", torch.zeros_like(ps), m),
            ("negated sum of g*xhat", ps * ps.new_tensor([[1.], [-1.]]), m),
            ("twice the count", ps, 2 * m)):
        bad = B.bn_dx_kernel(*dx_args[:6], sums, count, *dx_args[8:],
                             xhat=xhat)
        try:
            compare("", [bad], [want])
        except AssertionError:
            continue
        raise AssertionError(f"{name}: a dx with {fault} passes the check")


@case("kernels/bn")
def _():
    """The BN backward pair against its plain versions: every mode at the
    ResNet-50 stem (3,211,264 x 64), at a layer-4 unit (12,544 x 2048) and
    at a ragged (12,345 x 96); "addrelu" at a layer-1 join (802,816 x
    256). bf16 activations and scale/bias (O2 casts them), f32 statistics
    of x. At every shape and mode a dx fed zeroed sums, a negated Σg·x̂ or
    twice the count lies outside the tolerance."""
    import torch
    from apex_tpu_torch.ops import bn_act as B
    rnd, _ = seeded(14)
    bf16 = torch.bfloat16
    all_modes = ("plain", "relu", "addrelu")
    errs = {"sums": 0.0, "dx": 0.0}
    for (m, c), modes in (((3211264, 64), all_modes),
                          ((802816, 256), ("addrelu",)),
                          ((12544, 2048), all_modes),
                          ((12345, 96), all_modes)):
        x, g, z, scale, bias, mean, invstd = bn_inputs(rnd, m, c)
        for mode in modes:
            args = (x, g, z, scale, bias, mean, invstd, mode, bf16)
            ks, kdr = B.bn_sums_kernel(*args)
            ps, pdr = B.bn_sums_plain(*args)
            e1 = compare(f"bn_sums {m}x{c} {mode}",
                         [ks] + ([kdr] if kdr is not None else []),
                         [ps] + ([pdr] if pdr is not None else []))
            _check_bn_masks(f"bn_sums {m}x{c} {mode}", args, kdr, pdr)
            dx_args = (x, pdr if mode == "addrelu" else g, scale, bias,
                       mean, invstd, ps, m, mode == "relu", bf16)
            want = B.bn_dx_plain(*dx_args)
            e2 = compare(f"bn_dx {m}x{c} {mode}", [B.bn_dx_kernel(*dx_args)],
                         [want])
            _check_bn_dx_faults(f"bn_dx {m}x{c} {mode}", dx_args, want, m)
            if m == 3211264:
                errs["sums"] = max(errs["sums"], e1)
                errs["dx"] = max(errs["dx"], e2)
        del x, g, z
    ERRS.update(bn_sums=errs["sums"], bn_dx=errs["dx"])


@case("kernels/bn-f32-fp8")
def _():
    """The BN pair at the ResNet-50 stem (3,211,264 x 64) in the dtypes two
    paths give it: f32 x, g, z, γ and β (ResNet-50 at O0), and the e4m3 x̂
    of fp8 residuals with bf16 g, z, γ and β (``xhat=True``). Every mode
    against the plain versions (dr bit for bit, the ReLU mask by its
    counts), each with the check that a dx fed zeroed sums, a negated
    Σg·x̂ or twice the count fails."""
    import torch
    from apex_tpu_torch.ops import bn_act as B
    rnd, _ = seeded(15)
    m, c = 3211264, 64
    f32, bf16 = torch.float32, torch.bfloat16
    x = rnd(m, c, dtype=f32, std=2.0) + 0.5
    mean = x.mean(dim=0)
    invstd = torch.rsqrt(x.var(dim=0, unbiased=False) + 1e-5)
    g = ((rnd(m, c, dtype=f32) + rnd(c, dtype=f32, std=0.5)
          + rnd(c, dtype=f32, std=0.7) * (x - mean) * invstd) * 1e-3)
    z = rnd(m, c, dtype=f32).clamp_min(0.0)
    scale, bias = rnd(c, dtype=f32, std=0.3) + 1.0, rnd(c, dtype=f32, std=0.3)
    x8 = ((x - mean) * invstd).to(B.XHAT_DTYPE)
    cases = {"f32": (x, g, z, scale, bias, f32, False),
             "fp8": (x8, g.to(bf16), z.to(bf16), scale.to(bf16),
                     bias.to(bf16), bf16, True)}
    for label, (xx, gg, zz, sc, bi, dt, xhat) in cases.items():
        errs = {"sums": 0.0, "dx": 0.0}
        for mode in ("plain", "relu", "addrelu"):
            args = (xx, gg, zz, sc, bi, mean, invstd, mode, dt)
            ks, kdr = B.bn_sums_kernel(*args, xhat=xhat)
            ps, pdr = B.bn_sums_plain(*args, xhat=xhat)
            errs["sums"] = max(errs["sums"], compare(
                f"bn_sums {label} {mode}",
                [ks] + ([kdr] if kdr is not None else []),
                [ps] + ([pdr] if pdr is not None else [])))
            _check_bn_masks(f"bn_sums {label} {mode}", args, kdr, pdr, xhat)
            g_src = pdr if mode == "addrelu" else gg
            dx_args = (xx, g_src, sc, bi, mean, invstd, ps, m,
                       mode == "relu", dt)
            want = B.bn_dx_plain(*dx_args, xhat=xhat)
            errs["dx"] = max(errs["dx"], compare(
                f"bn_dx {label} {mode}", [B.bn_dx_kernel(*dx_args,
                                                         xhat=xhat)],
                [want]))
            _check_bn_dx_faults(f"bn_dx {label} {mode}", dx_args, want, m,
                                xhat)
        ERRS[f"bn_sums_{label}"] = errs["sums"]
        ERRS[f"bn_dx_{label}"] = errs["dx"]


@case("kernels/bn-dx-count")
def _():
    """Row 13's variant with the group's count as a 1-element f32 operand
    on the card (``COUNT_PTR``, what a unit with statistics across ranks
    launches): at the stem (3,211,264 x 64) and a ragged (12,345 x 96),
    "plain" and "relu", against ``bn_dx_plain`` fed the same tensor count,
    and bit for bit against the kernel fed the count as a number (the same
    f32 division)."""
    import torch
    from apex_tpu_torch.ops import bn_act as B
    rnd, _ = seeded(16)
    bf16 = torch.bfloat16
    err = 0.0
    for m, c in ((3211264, 64), (12345, 96)):
        x, g, _z, scale, bias, mean, invstd = bn_inputs(rnd, m, c)
        count = torch.full((), float(m), device=DEVICE)
        for mode in ("plain", "relu"):
            sums = B.bn_sums_plain(x, g, None, scale, bias, mean, invstd,
                                   mode)[0]
            args = (x, g, scale, bias, mean, invstd, sums)
            tail = (mode == "relu", bf16)
            got = B.bn_dx_kernel(*args, count, *tail)
            if not torch.equal(got, B.bn_dx_kernel(*args, m, *tail)):
                raise AssertionError(f"bn_dx_count {m}x{c} {mode}: differs "
                                     f"from the kernel fed the count as a "
                                     f"number")
            e = compare(f"bn_dx_count {m}x{c} {mode}", [got],
                        [B.bn_dx_plain(*args, count, *tail)])
            if m == 3211264:
                err = max(err, e)
    ERRS["bn_dx_count"] = err


# --- the kernel phase's checks: arena kernels ----------------------------------------

def _ragged_arena(rnd):
    """A ragged arena of an f32 and a bf16 partition: (spec, params by
    partition, f32 grads by partition)."""
    import torch
    from apex_tpu_torch import arena
    f32 = torch.float32
    tree = {"w": rnd(1000, 300, dtype=f32), "e": rnd(513, 129),
            "b": rnd(77, dtype=f32), "s": rnd(5)}
    spec = arena.plan(tree)
    pb = arena.flatten(tree, spec)
    gb = arena.flatten({k: rnd(*t.shape, dtype=f32) for k, t in tree.items()},
                       spec, cast=f32)
    return spec, pb, gb


def buffer_len(model: str, dtype_name: str = "float32") -> int:
    """``buffer_len`` of one arena partition of a model at full size:
    ``BertLarge`` (built on :data:`DEVICE`: its init draws on a
    generator there), ``ResNet50`` or ``Generator`` (the DCGAN generator;
    both planned on the meta device)."""
    from apex_tpu_torch import arena, models
    dev = DEVICE if model == "BertLarge" else "meta"
    mod = getattr(models, model)(device=dev)
    n = arena.plan(dict(mod.named_parameters())).partition(
        dtype_name).buffer_len
    del mod
    return n


@case("kernels/arena-lamb")
def _():
    """The arena kernels against their plain versions: a ragged arena of
    an f32 and a bf16 partition (stage 2 with a bf16 copy-out), then
    BERT-Large's one f32 partition (``buffer_len`` from ``arena.plan``)."""
    import torch
    from apex_tpu_torch.ops import _arena, multi_tensor as M
    from apex_tpu_torch.ops import optim_kernels as K
    rnd, _ = seeded(17)
    f32 = torch.float32
    s1 = _arena.device_scalars((0.9, 0.999, 1e-6, 0.01, 1 - 0.9 ** 3,
                                1 - 0.999 ** 3, 0.5, 0.1), DEVICE)
    s2 = _arena.device_scalars((1e-3,), DEVICE)

    def moments(n):
        return rnd(n, dtype=f32, std=0.1), rnd(n, dtype=f32, std=0.01).abs()

    _spec, pb, gb = _ragged_arena(rnd)
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

    n = buffer_len("BertLarge")
    p, g, r = (rnd(n, dtype=f32), rnd(n, dtype=f32, std=3.0),
               rnd(n, dtype=f32).abs())
    m, v = moments(n)
    ERRS["multi_tensor_l2norm"] = compare(
        "multi_tensor_l2norm BERT-Large", [M.l2norm_kernel(g)],
        [M.l2norm_plain(g)], TOL_ARENA)
    ERRS["lamb_stage1"] = compare(
        "lamb_stage1 BERT-Large", K.lamb_stage1_kernel(p, g, m, v, s1, True),
        K.lamb_stage1_plain(p, g, m, v, s1, True), TOL_ARENA)
    u = K.lamb_stage1_plain(p, g, m, v, s1, True)[0]
    ERRS["lamb_stage2"] = compare(
        "lamb_stage2 BERT-Large", [K.lamb_stage2_kernel(p, u, r, s2)],
        [K.lamb_stage2_plain(p, u, r, s2)], TOL_ARENA)


def remainder_scalars():
    """The f32 device scalars of the remainder rows: scale, axpby,
    Adagrad, NovoGrad."""
    from apex_tpu_torch.ops import _arena
    return (_arena.device_scalars((0.37,), DEVICE),
            _arena.device_scalars((1.7, -0.6), DEVICE),
            _arena.device_scalars((1e-2, 1e-10, 1e-4, 0.5), DEVICE),
            _arena.device_scalars((1e-3, 0.95, 0.05, 1e-8, 1e-3,
                                   1 - 0.95 ** 3, math.sqrt(1 - 0.98 ** 3)),
                                  DEVICE))


@case("kernels/arena-remainder")
def _():
    """Rows 15d-f and 15i-j against their plain versions: maxnorm, scale
    and axpby (out_dtype None, bf16, f16), Adagrad (both weight-decay
    modes) and NovoGrad (both moment modes) on a ragged arena of an f32
    and a bf16 partition; the flags' cases (an inf makes each flag False;
    1e5 scaled into f16 overflows only in the cast, so the flag is True
    and the output inf, as in the JAX package); maxnorm NaN with a NaN in
    the first or the last block, 0 on zeros. Then BERT-Large's f32
    partition."""
    import torch
    from apex_tpu_torch.ops import _arena, multi_tensor as M
    from apex_tpu_torch.ops import optim_kernels as K
    rnd, _ = seeded(18)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    s_scale, s_axpby, s_ada, s_novo = remainder_scalars()
    _spec, pb, gb = _ragged_arena(rnd)
    for dt, p in pb.items():
        n, g = p.numel(), gb[dt]
        h = rnd(n, dtype=f32, std=0.1).abs()
        m = rnd(n, dtype=f32, std=0.1)
        vpos = rnd(n, dtype=f32).abs() + 0.1
        for x in (p, g):
            compare(f"multi_tensor_maxnorm ragged {dt} {x.dtype}",
                    [M.maxnorm_kernel(x)], [M.maxnorm_plain(x)], TOL_ARENA)
        for out in (p.dtype, bf16, f16):
            check_flagged(f"multi_tensor_scale ragged {dt} -> {out}",
                           M.scale_kernel(p, s_scale, out),
                           M.scale_plain(p, s_scale, out))
            check_flagged(f"multi_tensor_axpby ragged {dt} -> {out}",
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
    one = _arena.device_scalars((1.0,), DEVICE)
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
    if M.maxnorm_kernel(torch.zeros_like(x)).item() != 0.0:
        raise AssertionError("maxnorm of zeros is not 0")

    n = buffer_len("BertLarge")
    p, g = rnd(n, dtype=f32), rnd(n, dtype=f32, std=1e-2)
    h, m = rnd(n, dtype=f32, std=1e-2).square(), rnd(n, dtype=f32, std=1e-3)
    vpos = rnd(n, dtype=f32).abs() + 0.1
    ERRS.update({
        "multi_tensor_maxnorm": compare("multi_tensor_maxnorm BERT-Large",
                                        [M.maxnorm_kernel(g)],
                                        [M.maxnorm_plain(g)], TOL_ARENA),
        "multi_tensor_scale": check_flagged(
            "multi_tensor_scale BERT-Large", M.scale_kernel(g, s_scale, f32),
            M.scale_plain(g, s_scale, f32)),
        "multi_tensor_axpby": check_flagged(
            "multi_tensor_axpby BERT-Large",
            M.axpby_kernel(p, g, s_axpby, f32),
            M.axpby_plain(p, g, s_axpby, f32)),
        "adagrad": compare("adagrad BERT-Large",
                           K.adagrad_kernel(p, g, h, s_ada, False),
                           K.adagrad_plain(p, g, h, s_ada, False), TOL_ARENA),
        "novograd": compare("novograd BERT-Large",
                            K.novograd_kernel(p, g, m, vpos, s_novo, False),
                            K.novograd_plain(p, g, m, vpos, s_novo, False),
                            TOL_ARENA)})


@case("kernels/sgd")
def _():
    """The SGD kernel against its plain version: every flag on a ragged
    arena of an f32 and a bf16 partition (the f32 one with a bf16
    copy-out), then ResNet-50's one f32 partition."""
    import torch
    from apex_tpu_torch.ops import _arena, optim_kernels as K
    rnd, _ = seeded(19)
    f32 = torch.float32
    _spec, pb, gb = _ragged_arena(rnd)
    for dt, p in pb.items():
        m = rnd(p.numel(), dtype=f32, std=0.1)
        copy = torch.bfloat16 if dt == "float32" else None
        for nesterov in (False, True):
            for wd_after in (False, True):
                for first in (0.0, 1.0):
                    s = _arena.device_scalars((0.1, 0.9, 0.0, 1e-4, 0.5,
                                               first), DEVICE)
                    compare(f"sgd ragged {dt} nesterov={nesterov} "
                            f"wd_after={wd_after} first={first}",
                            K.sgd_kernel(p, gb[dt], m, s, nesterov, wd_after,
                                         copy),
                            K.sgd_plain(p, gb[dt], m, s, nesterov, wd_after,
                                        copy), TOL_ARENA)
    n = buffer_len("ResNet50")
    p, g, m = (rnd(n, dtype=f32), rnd(n, dtype=f32, std=1e-2),
               rnd(n, dtype=f32, std=1e-2))
    s = _arena.device_scalars((0.1, 0.9, 0.0, 0.0, 1.0, 0.0), DEVICE)
    ERRS["sgd"] = compare("sgd ResNet-50",
                          K.sgd_kernel(p, g, m, s, False, False),
                          K.sgd_plain(p, g, m, s, False, False), TOL_ARENA)


@case("kernels/adam")
def _():
    """The Adam kernel against its plain version: AdamW mode on and off,
    the copy-out on and off, on a ragged arena of an f32 and a bf16
    partition; then at the DCGAN generator's one f32 partition."""
    import torch
    from apex_tpu_torch.ops import _arena, optim_kernels as K
    rnd, _ = seeded(20)
    f32 = torch.float32
    s = _arena.device_scalars((2e-4, 0.5, 0.999, 1e-8, 1e-2, 1 - 0.5 ** 3,
                               1 - 0.999 ** 3, 0.5), DEVICE)
    _spec, pb, gb = _ragged_arena(rnd)
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
    n = buffer_len("Generator")
    p, g = rnd(n, dtype=f32, std=0.02), rnd(n, dtype=f32, std=1e-2)
    m, v = rnd(n, dtype=f32, std=1e-3), rnd(n, dtype=f32, std=1e-2).square()
    s = _arena.device_scalars((2e-4, 0.5, 0.999, 1e-8, 0.0, 1 - 0.5 ** 3,
                               1 - 0.999 ** 3, 1.0), DEVICE)
    ERRS["adam"] = max(compare(f"adam generator adam_w={w}",
                               K.adam_kernel(p, g, m, v, s, w),
                               K.adam_plain(p, g, m, v, s, w), TOL_ARENA)
                       for w in (True, False))


def shard_valid(spec, dt, world, rank):
    """Bool mask of the tensor positions (not padding) in rank ``rank``'s
    ZeRO shard of partition ``dt``, and the shard's start and length."""
    import torch
    from apex_tpu_torch import arena
    from apex_tpu_torch.optim.distributed import _padded_len

    part = spec.partition(dt)
    per = _padded_len(part.buffer_len, world) // world
    ids = arena.segment_ids_device(spec, dt, DEVICE)
    ids = torch.cat([ids, torch.full((per * world - ids.numel(),), -1,
                                     dtype=ids.dtype, device=DEVICE)])
    return ids[rank * per:(rank + 1) * per] >= 0, rank * per, per


def _copy_bits_equal(name, kp, kc, pp, pc):
    """A copy-out kernel's low-precision copy bit for bit against the plain
    version's wherever the two f32 results are equal (elsewhere an f32 ulp
    may move a rounding); returns the count of such unequal elements."""
    import torch
    same = kp.view(torch.int32) == pp.view(torch.int32)
    width = {1: torch.uint8, 2: torch.int16}[kc.element_size()]
    bad = int(((kc.view(width) != pc.view(width)) & same).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} copy elements differ in bits "
                             f"where the f32 results agree")
    return int((~same).sum())


@case("kernels/zero")
def _():
    """The arena kernels at the ZeRO paths' shapes. ``lamb_shard``: LAMB's
    stages on rank 1's shard of BERT-Large's f32 partition at world size 2
    (the shard begins inside a tensor), the trust ratio from
    ``per_tensor_sq_shard`` spread by ``spread_per_tensor_shard``, stage 2
    also with the bf16 and e5m2 copies of the compressed gathers.
    ``adam_e5m2_copy``: the Adam kernel with an e5m2 copy at ResNet-50's
    f32 master partition (the shard at world size 1), elements at and past
    e5m2's largest finite value (57344) included: the copy bit for bit
    against the plain version's (PTX's convert saturates; the kernel rounds
    |p| >= 61440 to inf, as PyTorch and JAX do)."""
    import torch
    from apex_tpu_torch import arena, models
    from apex_tpu_torch.ops import _arena, multi_tensor as M
    from apex_tpu_torch.ops import optim_kernels as K
    rnd, _ = seeded(21)
    f32 = torch.float32
    enc = models.BertLarge(device=DEVICE)
    spec = arena.plan(dict(enc.named_parameters()))
    del enc
    part = spec.partition("float32")
    valid, start, per = shard_valid(spec, "float32", 2, 1)
    if not any(o < start < o + n for o, n in zip(part.offsets, part.sizes)):
        raise AssertionError("rank 1's shard of BERT-Large should begin "
                             "inside a tensor")
    p, g = rnd(per, dtype=f32) * valid, rnd(per, dtype=f32, std=3.0) * valid
    m = rnd(per, dtype=f32, std=0.1) * valid
    v = rnd(per, dtype=f32, std=0.01).abs() * valid
    s1 = _arena.device_scalars((0.9, 0.999, 1e-6, 0.01, 1 - 0.9 ** 3,
                                1 - 0.999 ** 3, 0.5, 0.1), DEVICE)
    s2 = _arena.device_scalars((1e-3,), DEVICE)
    e1 = compare("lamb_shard stage1", K.lamb_stage1_kernel(p, g, m, v, s1,
                                                           True),
                 K.lamb_stage1_plain(p, g, m, v, s1, True), TOL_ARENA)
    u = K.lamb_stage1_plain(p, g, m, v, s1, True)[0]
    sq_p = M.per_tensor_sq_shard(p, part.offsets, part.sizes, start)
    sq_u = M.per_tensor_sq_shard(u, part.offsets, part.sizes, start)
    ratio = torch.where((sq_p > 0) & (sq_u > 0),
                        torch.sqrt(sq_p) / torch.sqrt(sq_u), 1.0)
    r = M.spread_per_tensor_shard(ratio, part.offsets, part.sizes, start, per)
    e2 = compare("lamb_shard stage2", [K.lamb_stage2_kernel(p, u, r, s2)],
                 [K.lamb_stage2_plain(p, u, r, s2)], TOL_ARENA)
    for copy in (torch.bfloat16, torch.float8_e5m2):
        kp, kc = K.lamb_stage2_kernel(p, u, r, s2, copy)
        pp, pc = K.lamb_stage2_plain(p, u, r, s2, copy)
        e2 = max(e2, compare(f"lamb_shard stage2 copy={copy}", [kp], [pp],
                             TOL_ARENA))
        apart = _copy_bits_equal(f"lamb_shard stage2 copy={copy}", kp, kc,
                                 pp, pc)
        log(f"  lamb_shard stage2 {copy} copy bit for bit where the f32 "
            f"results agree ({apart} of {per} f32 results an ulp apart)")
    ERRS.update(lamb_shard_stage1=e1, lamb_shard_stage2=e2)
    del p, g, m, v, u, r, valid

    n = buffer_len("ResNet50")
    p = rnd(n, dtype=f32, std=0.05)
    g, m = rnd(n, dtype=f32, std=1e-2), rnd(n, dtype=f32, std=1e-3)
    v = rnd(n, dtype=f32, std=1e-2).square()
    big = torch.tensor([57344.0, 59000.0, 61439.0, 61440.0, 61441.0, 1e6,
                        -61440.0, -1e6, -57344.0, 1e-6], device=DEVICE)
    p[:big.numel()] = big
    for t in (g, m, v):
        t[:big.numel()] = 0.0
    s = _arena.device_scalars((1e-3, 0.9, 0.999, 1e-8, 0.0, 1 - 0.9 ** 3,
                               1 - 0.999 ** 3, 1.0), DEVICE)
    e8 = torch.float8_e5m2
    kout = K.adam_kernel(p, g, m, v, s, True, e8)
    pout = K.adam_plain(p, g, m, v, s, True, e8)
    ERRS["adam_e5m2_copy"] = compare("adam_e5m2_copy", kout[:3], pout[:3],
                                     TOL_ARENA)
    _copy_bits_equal("adam_e5m2_copy", kout[0], kout[3], pout[0], pout[3])
    head = kout[3][:big.numel()].view(torch.uint8).tolist()
    if head != pout[3][:big.numel()].view(torch.uint8).tolist() or \
            head[:6] != [123, 123, 123, 124, 124, 124]:
        raise AssertionError(f"adam_e5m2_copy: the copy's bytes of {big} "
                             f"are {head}")


# --- the kernel phase's checks: MLP and fp16 ------------------------------------------

def mlp_operands(rnd, n, dims, act, bias, dt, wdt):
    """x ~ N(0, 1) and weights scaled to keep every layer's output O(1)."""
    x = rnd(n, dims[0], dtype=dt)
    gain = 4.0 if act == "sigmoid" else 2.0
    ws = [rnd(a, b, dtype=wdt, std=math.sqrt(gain / a))
          for a, b in zip(dims, dims[1:])]
    bs = [rnd(b, dtype=wdt, std=0.1) for b in dims[1:]] if bias else None
    return x, ws, bs


#: the MLP kernel's timed shapes: (label, rows, dims, act, bias, x dtype,
#: weight dtype); "path" is the JSON row
MLP_CASES = (("path", 2048, MLP_BOTTOM, "relu", True, "bfloat16",
              "bfloat16"),
             ("edge", 8192, (1024, 1024, 1024), "relu", True, "float32",
              "float32"),
             ("ragged", 96, (224, 200, 136, 10), "sigmoid", False,
              "float32", "float32"))


@case("kernels/mlp")
def _():
    """mlp_fwd against its plain version (the f32 chain with one cast),
    TF32 off: at the path's shape (B2048 x [13, 512, 256, 128], relu, bias,
    bf16 x and bf16 weights as O2 gives them), the budget's edge (B8192 x
    [1024, 1024, 1024] f32, exactly 8 MiB of weights, which <= admits) and
    the ragged [224, 200, 136, 10] at 96 rows (f32, sigmoid, no bias), each
    also bitwise equal to a second launch; then a layer too wide for the
    fused kernel (one launch per layer over the f32 workspace) and 40
    layers (two fused launches), fp16, and x, weights and biases of
    different dtypes, each with its launch count."""
    import torch
    from apex_tpu_torch.ops import mlp as P
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the MLP check needs TF32 off")
    rnd, _ = seeded(22)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    for name, n, dims, act, bias, dt, wdt in MLP_CASES:
        x, ws, bs = mlp_operands(rnd, n, dims, act, bias,
                                 getattr(torch, dt), getattr(torch, wdt))
        if name == "edge" and (sum(w.numel() for w in ws) * 4 != 8 << 20
                               or not P.weights_fit(ws)):
            raise AssertionError("the edge case must hold exactly 8 MiB")
        before = P.mlp_fwd_kernel.launches
        out = P.mlp_fwd_kernel(x, ws, bs, act)
        if P.mlp_fwd_kernel.launches - before != 1:
            raise AssertionError(f"mlp_fwd {name}: "
                                 f"{P.mlp_fwd_kernel.launches - before} "
                                 f"launches, expected 1")
        err = compare(f"mlp_fwd {name} {n}x{list(dims)} {dt}", [out],
                      [P.mlp_fused_reference(x, ws, bs, act)], 1e-4)
        if not torch.equal(out, P.mlp_fwd_kernel(x, ws, bs, act)):
            raise AssertionError(f"mlp_fwd {name}: two launches differ")
        if name == "path":
            ERRS["mlp_fwd"] = err
    for name, n, dims, act, dt, wdt, bdt, want in (
            ("wide", 200, [96, 4096, 48], "relu", f16, f16, f16, 2),
            ("deep", 100, [64] * 41, "sigmoid", f16, f16, f16, 2),
            ("mixed", 50, [39, 128, 57], "none", bf16, f32, f32, 1),
            ("mixed16", 33, [20, 64, 12], "relu", f16, f32, bf16, 1)):
        x, ws, bs = mlp_operands(rnd, n, dims, act, True, dt, wdt)
        bs = [b.to(bdt) for b in bs]
        before = P.mlp_fwd_kernel.launches
        compare(f"mlp_fwd {name} {n}x{dims[:3]}... ({len(ws)} layers) x "
                f"{dt}, weights {wdt}, biases {bdt}",
                [P.mlp_fwd_kernel(x, ws, bs, act)],
                [P.mlp_fused_reference(x, ws, bs, act)], 1e-4)
        got = P.mlp_fwd_kernel.launches - before
        if got != want:
            raise AssertionError(f"mlp_fwd {name}: {got} launches, expected "
                                 f"{want}")


@case("kernels/fp16")
def _():
    """fp16 at BERT-Large's shapes against the plain versions (TOL16; f32
    outputs TOL32): LayerNorm forward and backward on fp16 x with fp16 γ/β
    (as O2 and ``network_to_half`` give them) and with f32 γ/β; flash
    forward and backward on fp16 q/k/v, plain and with the padding bias
    and dropout 0.1; cross-entropy on fp16 logits."""
    import torch
    from apex_tpu_torch.ops import attention as A
    from apex_tpu_torch.ops import layer_norm as L
    from apex_tpu_torch.ops import xentropy as X
    rnd, gen = seeded(23)
    fp16, f32 = torch.float16, torch.float32
    x = rnd(8192, 1024, dtype=fp16, std=2.0) + 0.5
    w = rnd(1024, dtype=f32, std=0.2) + 1.0
    b = rnd(1024, dtype=f32, std=0.2)
    g = rnd(8192, 1024, dtype=fp16)
    for wdt in (fp16, f32):
        wt, bt, name = w.to(wdt), b.to(wdt), f"{wdt}".split(".")[-1]
        compare(f"layer_norm_fwd fp16 x, {name} gamma",
                [L.ln_fwd_kernel(x, wt, bt, 1e-12)],
                [L.ln_fwd_plain(x, wt, bt, 1e-12)])
        compare(f"layer_norm_bwd fp16 x, {name} gamma",
                L.ln_bwd_kernel(g, x, wt, 1e-12),
                L.ln_bwd_plain(g, x, wt, 1e-12))
    del x, g
    i32 = torch.tensor([4242], dtype=torch.int32, device=DEVICE)
    for label, opts in (("plain", {}), ("padding+dropout 0.1", dict(
            bias=padding_bias(gen, 16, 512), rate=0.1, seed=i32))):
        q, k, v, do = (rnd(16, 512, 16, 64, dtype=fp16) for _ in range(4))
        scale = 0.125
        compare(f"flash_attn_fwd fp16 {label}",
                A.flash_fwd_kernel(q, k, v, scale, **opts),
                A.flash_fwd_plain(q, k, v, scale, **opts))
        o, lse = A.flash_fwd_plain(q, k, v, scale, **opts)
        compare(f"flash_attn_bwd fp16 {label}",
                A.flash_bwd_kernel(q, k, v, do, lse, delta_of(do, o), scale,
                                   **opts),
                A.flash_bwd_plain(q, k, v, do, lse, delta_of(do, o), scale,
                                  **opts))
        del q, k, v, do, o, lse
    n, vocab = 8192, 30522
    logits = rnd(n, vocab, dtype=fp16, std=3.0)
    labels = torch.randint(0, vocab, (n,), generator=gen, device=DEVICE)
    labels[torch.rand(n, generator=gen, device=DEVICE) < 0.15] = -1
    gl = torch.rand(n, generator=gen, device=DEVICE)
    compare("xentropy_fwd fp16", X.xentropy_fwd_kernel(logits, labels, 0.0),
            X.xentropy_fwd_plain(logits, labels, 0.0))
    _, lse = X.xentropy_fwd_plain(logits, labels, 0.0)
    compare("xentropy_bwd fp16",
            [X.xentropy_bwd_kernel(logits, labels, lse, gl, 0.0)],
            [X.xentropy_bwd_plain(logits, labels, lse, gl, 0.0)])


#: the MLP kernel's half-operand mode: (label, rows, dims, operand dtype,
#: launches); "path" is the JSON row ``mlp_fwd_o1``
MLP_O1_CASES = (("path", 2048, MLP_BOTTOM, "bfloat16", 1),
                ("path fp16", 2048, MLP_BOTTOM, "float16", 1),
                ("edge", 8192, (1024, 1024, 1024), "bfloat16", 1),
                ("wide", 200, (96, 4096, 48), "bfloat16", 2),
                ("wide fp16", 200, (96, 4096, 48), "float16", 2))


@case("kernels/mlp-o1")
def _():
    """The MLP kernel's half-operand mode (row mlp_fwd_o1): at the DLRM
    bottom MLP's shape in f32 (as O1 gives it) with bf16 and fp16 operands
    and at the budget's edge, and a layer past the fused width (one launch
    a layer over the f32 workspace), each bit for bit against its plain
    version (operands rounded, so every product is exact in f32 and the
    plain version sums them in the kernel's order), against a second
    launch, and apart from the mode off."""
    import torch
    from apex_tpu_torch.ops import mlp as P
    rnd, _ = seeded(24)
    f32 = torch.float32
    for label, n, dims, od, want in MLP_O1_CASES:
        od = getattr(torch, od)
        x, ws, bs = mlp_operands(rnd, n, dims, "relu", True, f32, f32)
        before = P.mlp_fwd_kernel.launches
        out = P.mlp_fwd_kernel(x, ws, bs, "relu", od)
        if P.mlp_fwd_kernel.launches - before != want:
            raise AssertionError(f"mlp_fwd_o1 {label}: expected {want} "
                                 f"launches")
        plain_out = P.mlp_fused_reference(x, ws, bs, "relu", od)
        err = compare(f"mlp_fwd_o1 {label} {od}", [out], [plain_out], 1e-4)
        if not torch.equal(out, plain_out):
            raise AssertionError(f"mlp_fwd_o1 {label}: not bitwise equal to "
                                 f"the plain version")
        if not torch.equal(out, P.mlp_fwd_kernel(x, ws, bs, "relu", od)):
            raise AssertionError(f"mlp_fwd_o1 {label}: two launches differ")
        off = (out - P.mlp_fwd_kernel(x, ws, bs, "relu")).abs().max().item()
        if off == 0.0:
            raise AssertionError(f"mlp_fwd_o1 {label}: the mode changed "
                                 f"nothing")
        if label == "path":
            ERRS["mlp_fwd_o1"] = err


# --- no-extra-dispatch: a depth-2 encoder's step with a feature off ----------------

def encoder_step(**kw):
    """``(step, state, toks, labels)`` of a depth-2 encoder's O1 bf16 step
    with the arena LAMB (``train.build_bert_step``): BERT-Large's widths at
    B2 S128 on a card, hidden 32 and 2 heads at B2 S16 on the CPU."""
    from apex_tpu_torch import models, train
    if DEVICE == "cpu":
        enc = models.BertEncoder(512, hidden=32, layers=2, heads=2,
                                 max_len=16, device="cpu")
        b, s = 2, 16
    else:
        enc = models.BertEncoder(30522, hidden=1024, layers=2, heads=16,
                                 device=DEVICE)
        b, s = 2, 128
    step, state, (toks, labels), _, _ = train.build_bert_step(
        b, s, encoder=enc, device=DEVICE, strategy="arena", **kw)
    return step, state, toks, labels


def census(fn) -> Tuple[collections.Counter, Optional[collections.Counter]]:
    """(aten ops and hand-kernel calls of one ``fn()`` call, by op and
    shapes; on a card, its device kernels by name from a guarded profiler
    session, the session's spins left out; None on the CPU)."""
    from apex_tpu_torch.prof import cost
    ops_ = collections.Counter({k: e.count
                                for k, e in cost.count(fn).ops.items()})
    if DEVICE == "cpu":
        return ops_, None
    from apex_tpu_torch.prof import report
    _, ks = report.guarded_session(fn)
    spins = report.spin_names()
    return ops_, collections.Counter(e.name for e in ks
                                     if e.name not in spins)


def same_dispatch(label, absent, off, allowed=(), between=None):
    """Census ``off()`` (the step with a feature off) against ``absent()``
    (the step without it), each after one warm-up call: the same aten ops
    and (on a card) the same device kernels, but for the ops named in
    ``allowed`` (an off-step's own bookkeeping), which may add as many
    device kernels as they are calls. ``between()`` is the feature's host
    side, run before each call of ``off`` and outside its census (between
    steps). Returns the two censuses."""
    def hosted():
        if between is not None:
            between()

    absent()
    hosted()
    off()
    a_ops, a_k = census(absent)
    hosted()
    o_ops, o_k = census(off)
    extra_ops = o_ops - a_ops
    if a_ops - o_ops or any(op.split("(")[0] not in allowed
                            for op in extra_ops):
        raise AssertionError(
            f"{label}: the step dispatched other ops with the feature off: "
            f"extra {dict(extra_ops)}, missing {dict(a_ops - o_ops)}")
    if a_k is not None:
        budget = sum(extra_ops.values())
        if a_k - o_k or sum((o_k - a_k).values()) > budget:
            raise AssertionError(
                f"{label}: device kernels differ with the feature off: extra "
                f"{dict(o_k - a_k)}, missing {dict(a_k - o_k)} (allowed "
                f"{budget} for {dict(extra_ops)})")
    return (a_ops, a_k), (o_ops, o_k)


def _stepper(step, state, toks, labels):
    """A zero-arg call of one step that carries the state along."""
    box = [state]

    def run():
        box[0], loss = step(box[0], toks, labels)
        return loss
    run.state = box
    return run


@case("monitor/no-extra-dispatch")
def _():
    """The monitored step (``Amp(monitor=True)``: the Metrics ride the
    step's state) makes no host sync; the host logger (a
    ``MetricsLogger`` with a JSONL sink, recording what the host already
    holds between steps) adds no op to the step."""
    from apex_tpu_torch import monitor
    from apex_tpu_torch.monitor.check import module_count_and_host_ops
    mstep, mstate, toks, labels = encoder_step(monitor=True)
    run = _stepper(mstep, mstate, toks, labels)
    run()
    _n, host = module_count_and_host_ops(run)
    if host:
        raise AssertionError(f"the monitored step syncs the host: {host}")
    plain = _stepper(*encoder_step())
    logger = monitor.MetricsLogger(
        sinks=[], memory_sink=monitor.JSONLSink(io.StringIO()))
    same_dispatch("monitor", plain, plain,
                  between=lambda: logger.sample_memory(step=0))
    logger.close()


@case("trace/no-extra-dispatch")
def _():
    """Spans, a tracer's step records and NaN probes with
    ``trace.debug_nans`` off add no op to the step; with it on the probes
    dispatch (the switch flips real work, not a no-op)."""
    from apex_tpu_torch import trace
    plain = _stepper(*encoder_step())
    tracer = trace.Tracer()

    def off():
        with tracer, trace.step(0):
            with trace.span("dispatch"):
                loss = plain()
            return trace.nan_probe("loss", loss)

    (a_ops, _), _ = same_dispatch("trace", plain, off)
    with trace.debug_nans():
        on_ops, _ = census(off)
    trace.reset_nan_state()
    if not on_ops - a_ops:
        raise AssertionError("trace: debug_nans on dispatched no probe")


@case("memory/no-extra-dispatch")
def _():
    """A step watched by ``prof.CompileWatcher`` with allocator samples
    between steps dispatches what the unwatched step does, and the
    watcher sees no retrace in steady state."""
    from apex_tpu_torch import prof
    plain = _stepper(*encoder_step())
    watcher = prof.CompileWatcher()
    watched = watcher.watch(plain, name="train_step")
    same_dispatch("memory", plain, watched,
                  between=prof.device_memory_sample)
    if watcher["train_step"].n_retraces:
        raise AssertionError(f"memory: {watcher['train_step'].n_retraces} "
                             f"retraces in steady state")


@case("ckpt/no-extra-dispatch")
def _():
    """A step between async checkpoint saves dispatches what a step
    without a manager does: the snapshot's device copies happen in
    ``save``, between steps, never in the step."""
    from apex_tpu_torch import ckpt
    plain = _stepper(*encoder_step())
    saved = _stepper(*encoder_step())
    with tempfile.TemporaryDirectory() as tmp:
        mgr = ckpt.CheckpointManager(tmp)
        i = [0]

        def save():
            i[0] += 1
            mgr.save(i[0], saved.state[0])     # async: writes during the step

        same_dispatch("ckpt", plain, saved, between=save)
        mgr.wait()
        if not ckpt.committed_steps(tmp):
            raise AssertionError("ckpt: no committed save")


@case("guard/no-extra-dispatch")
def _():
    """The guarded step (``Amp.step(guard=...)``) with an observe-only
    ``GuardPolicy`` polling its state into a guard sink between steps
    dispatches what the guarded step alone does."""
    from apex_tpu_torch import guard, monitor
    step, state, toks, labels = encoder_step()
    app, loss_fn = step.amp_opt, step.make_loss(toks, labels)
    cfg = guard.GuardConfig(window=8, min_history=3)

    def guarded(box):
        def run():
            box[0], loss, _fin, box[1] = app.step(box[0], loss_fn,
                                                   guard=(box[1], cfg))
            return loss
        return run

    alone = guarded([state, guard.guard_init(cfg, device=DEVICE)])
    box = [state, guard.guard_init(cfg, device=DEVICE)]
    polled = guarded(box)
    logger = monitor.MetricsLogger(
        sinks=[], guard_sink=monitor.JSONLSink(io.StringIO()))
    policy = guard.GuardPolicy(observe_only=True,
                               event_sink=logger.record_guard)
    n = [0]

    def poll():
        act = policy.update(n[0], box[1])
        n[0] += 1
        if act.kind != "none":
            raise AssertionError(f"guard: observe-only policy acted: {act}")

    same_dispatch("guard", alone, polled, between=poll)
    logger.close()


# --- apexlint: the one run leaves no trace -----------------------------------

def _same_run(label, linted, twin, steps=3):
    """``steps`` steps of ``linted`` and of its never-linted ``twin`` (two
    :func:`_stepper` calls of steps built alike): bitwise equal losses and
    states, then the same aten ops and device kernels in one step's
    census each."""
    import torch
    from apex_tpu_torch.utils import tree_leaves
    for i in range(steps):
        la, lb = linted(), twin()
        if not torch.equal(la, lb):
            raise AssertionError(f"{label}: step {i} loss {la.item()!r} "
                                 f"after linting, {lb.item()!r} unlinted")
    for j, (a, b) in enumerate(zip(tree_leaves(linted.state[0]),
                                   tree_leaves(twin.state[0]))):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: state leaf {j} differs from "
                                 f"the unlinted twin's")
    (a_ops, a_k), (o_ops, o_k) = same_dispatch(label, twin, linted)
    if a_ops != o_ops or a_k != o_k:
        raise AssertionError(f"{label}: censuses differ")


@case("lint/no-extra-dispatch")
def _():
    """Linting a step is observation: ``lint_step`` runs the step once and
    puts back every generator it drew from and every pre-existing tensor
    it wrote, so a depth-2 encoder step linted once then takes three steps
    bit for bit as its twin built alike from the same seed and never
    linted, with the same census; the lint itself sees no host sync."""
    from apex_tpu_torch import lint
    step, state, toks, labels = encoder_step()
    twin = _stepper(*encoder_step())
    rep = lint.lint_step(step, state, toks, labels,
                         policy=step.amp_opt.policy)
    if rep.by_rule("host-callback-in-step"):
        raise AssertionError(f"lint: the step syncs the host\n"
                             f"{rep.table()}")
    _same_run("lint", _stepper(step, state, toks, labels), twin)


@case("lint/precision-no-extra-dispatch")
def _():
    """The precision pass at O1 fp16 with dynamic loss scaling, so that a
    scale/unscale pair really runs the taint code (one loss-scale token
    minted and cancelled): no unscaled-narrow-cast, no scale-leak, and the
    linted step then runs three steps bit for bit as its unlinted twin."""
    import torch
    from apex_tpu_torch import lint
    step, state, toks, labels = encoder_step(half_dtype=torch.float16)
    twin = _stepper(*encoder_step(half_dtype=torch.float16))
    policy = step.amp_opt.policy
    if not policy.uses_loss_scaling:
        raise AssertionError("lint: O1 fp16 runs without a loss scaler")
    rec = lint.record_step(step, state, toks, labels)
    pa = lint.precision_analysis(rec, policy=policy)
    if pa.n_loss_scale_tokens != 1:
        raise AssertionError(f"lint: {pa.n_loss_scale_tokens} loss-scale "
                             f"tokens minted, want 1")
    rep = lint.lint_step(None, record=rec, policy=policy)
    bad = [f for f in rep.findings
           if f.rule in ("unscaled-narrow-cast", "scale-leak")]
    if bad:
        raise AssertionError(f"lint: {rep.table()}")
    _same_run("lint precision", _stepper(step, state, toks, labels), twin)


@contextlib.contextmanager
def world1():
    """A world-1 process group (NCCL on a card, gloo on the CPU) over a
    file store, and its ``data`` mesh; an existing group is used as it
    is."""
    import torch.distributed as dist
    from apex_tpu_torch import parallel
    if dist.is_initialized():
        yield parallel.data_parallel_mesh(DEVICE)
        return
    with tempfile.TemporaryDirectory() as tmp:
        parallel.distributed_init(init_method=f"file://{tmp}/store",
                                  num_processes=1, process_id=0,
                                  device=DEVICE)
        try:
            yield parallel.data_parallel_mesh(DEVICE)
        finally:
            dist.destroy_process_group()


@case("integrity/no-extra-dispatch")
def _():
    """An off-step of the fingerprint check (``check_every=4``, a step it
    skips) adds to the step only its cadence's bookkeeping: the host reads
    the state's step count back and advances it, no fold, no collective."""
    import torch.distributed as dist
    from apex_tpu_torch import guard, parallel
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < 2:
        # as the JAX case on one device: the fingerprints compare across a
        # data axis of two ranks or more (chip_smoke's
        # integrity_three_ranks runs them on the card)
        log("  (integrity: one process — no data axis to fingerprint "
            "across; run inside a group of >= 2 ranks)")
        return
    with world1() as mesh, parallel.use_mesh(mesh):
        plain = _stepper(*encoder_step())
        icfg = guard.IntegrityConfig(check_every=4)
        ist = [guard.integrity_init(icfg, world=world, device=DEVICE)]
        ist[0] = guard.integrity_check(ist[0], icfg, plain.state[0].params)

        def off():
            loss = plain()
            ist[0] = guard.integrity_check(ist[0], icfg,
                                           plain.state[0].params)
            return loss

        parallel.reset_collective_counts()
        same_dispatch("integrity", plain, off, allowed=INTEGRITY_OFF_STEP)
        if parallel.collective_counts:
            raise AssertionError(f"integrity: off-steps ran collectives "
                                 f"{dict(parallel.collective_counts)}")


#: the aten ops an integrity off-step adds: the step count read back to
#: the host (its cadence) and advanced, and the divergence flags cleared
INTEGRITY_OFF_STEP = ("aten::_local_scalar_dense", "aten::add",
                      "aten::zeros_like")


@case("goodput/no-extra-dispatch")
def _():
    """A step under a ``Tracer`` with per-phase spans, a ``GoodputLedger``
    folding every step and a heartbeat writer dispatches what the bare
    step does, and the ledger's buckets close over each step's wall
    time."""
    from apex_tpu_torch import monitor, trace
    plain = _stepper(*encoder_step())
    tracer = trace.Tracer()
    ledger = monitor.GoodputLedger(tracer, tolerance=0.05)
    with tempfile.TemporaryDirectory() as tmp:
        hb = trace.HeartbeatWriter(tmp, rank=0)
        tracer.subscribe(hb.on_step)
        n = [0]

        def off():
            with tracer, trace.step(n[0]):
                n[0] += 1
                with trace.span("dispatch"):
                    loss = plain()
                with trace.span("fetch"):
                    loss.item()
            return loss

        plain_fetched = lambda: plain().item()  # noqa: E731
        same_dispatch("goodput", plain_fetched, off)
    ok, worst = ledger.check_closure()
    if not ok or not ledger.steps:
        raise AssertionError(f"goodput: closure broke ({worst})")


@case("sharding/no-extra-dispatch")
def _():
    """The per-axis shard report of the step's state and its attachment
    to a logger are host-side reads: the step dispatches what it did."""
    from apex_tpu_torch import monitor, prof
    from apex_tpu_torch.lint.mesh_model import parse_mesh_spec
    step, state, toks, labels = encoder_step()
    plain = _stepper(step, state, toks, labels)
    mm = parse_mesh_spec("ici1", link_bytes_per_s={"ici": 1e11})
    mem = prof.memory_report(step, state, toks, labels, batch_size=2)
    logger = monitor.MetricsLogger(
        sinks=[], sharding_sink=monitor.JSONLSink(io.StringIO()))

    twin = _stepper(step, state, toks, labels)

    def attach():
        logger.attach_shard_report(prof.shard_report(twin.state[0], mm,
                                                     report=mem))

    same_dispatch("sharding", plain, twin, between=attach)
    logger.close()


@case("roofline/no-extra-dispatch")
def _():
    """Profiling the step, building its roofline report and attaching it
    to a logger leave the step's dispatch as it was."""
    from apex_tpu_torch import monitor, prof
    plain = _stepper(*encoder_step())
    rep = prof.roofline_report(prof.profile_step(
        plain, iters=1, warmup=1, device=DEVICE, count_flops=False))
    if DEVICE != "cpu" and not rep.rows:    # the CPU has no device rows
        raise AssertionError("roofline: the report attributed no op")
    logger = monitor.MetricsLogger(
        sinks=[], roofline_sink=monitor.JSONLSink(io.StringIO()))
    logger.attach_roofline_report(rep)
    logger.close()
    twin = _stepper(*encoder_step())
    same_dispatch("roofline", twin, plain)


@case("cluster/no-extra-dispatch")
def _():
    """A step under the control plane (a joined ``ClusterMembership``
    renewing its lease, a generation-fenced checkpoint manager saving
    between steps) dispatches what the bare step does."""
    from apex_tpu_torch import ckpt, cluster
    plain = _stepper(*encoder_step())
    with tempfile.TemporaryDirectory() as tmp:
        member = cluster.ClusterMembership(os.path.join(tmp, "cluster"),
                                           rank=0)
        member.join()
        mgr = ckpt.CheckpointManager(os.path.join(tmp, "ck"), fence=member,
                                     rank=0, process_count=1)
        fenced = _stepper(*encoder_step())
        i = [0]

        def control():
            i[0] += 1
            member.heartbeat()
            mgr.save(i[0], fenced.state[0])

        same_dispatch("cluster", plain, fenced, between=control)
        mgr.wait()
        member.leave()


def _hooked_step(which, every):
    """(plain step, step with the numerics or dynamics hook at cadence
    ``every``) of one encoder; the hooked one has taken its folding step
    0, so its next calls are off-steps."""
    from apex_tpu_torch.monitor import dynamics as dx
    from apex_tpu_torch.monitor import numerics as nx
    step, state, toks, labels = encoder_step()
    app, loss_fn = step.amp_opt, step.make_loss(toks, labels)
    if which == "numerics":
        cfg = nx.NumericsConfig(check_every=every)
        hook = nx.numerics_init(cfg, sites=app.numerics_sites(state.params),
                                device=DEVICE)
    else:
        cfg = dx.DynamicsConfig(check_every=every, local_batch=2)
        hook = dx.dynamics_init(cfg, sites=app.dynamics_sites(state.params),
                                device=DEVICE)
    box = [state, hook]

    def hooked():
        box[0], loss, _fin, box[1] = app.step(box[0], loss_fn,
                                              **{which: (box[1], cfg)})
        return loss

    def plain():
        box[0], loss, _fin = app.step(box[0], loss_fn)
        return loss

    hooked()
    return plain, hooked


#: the aten op an off-step of the numerics or dynamics hook adds: its
#: state's step count advanced on the device
HOOK_OFF_STEP = ("aten::add",)


@case("numerics/no-extra-dispatch")
def _():
    """An off-step of the numerics fold (``check_every=10``) adds to the
    step only its state's step count: no fold, no host sync."""
    plain, hooked = _hooked_step("numerics", 10)
    same_dispatch("numerics", plain, hooked, allowed=HOOK_OFF_STEP)


@case("dynamics/no-extra-dispatch")
def _():
    """An off-step of the dynamics fold (``check_every=10``) adds to the
    step only its state's step count."""
    plain, hooked = _hooked_step("dynamics", 10)
    same_dispatch("dynamics", plain, hooked, allowed=HOOK_OFF_STEP)


def _ddp_grads():
    step, state, toks, labels = encoder_step()
    _loss, grads, _mid, _fin = step.amp_opt.backward(
        state, step.make_loss(toks, labels))
    return grads


@case("ddp/overlap-start-done")
def _():
    """The bucketed sync (``bucket_allreduce=True``, the JAX package's
    overlapped start/done pairs) runs one all-reduce a bucket of its
    static plan, and at world size 1 returns the unbucketed sync's
    gradients bit for bit."""
    import torch
    from apex_tpu_torch import parallel
    from apex_tpu_torch.parallel import comm
    with world1() as mesh:
        grads = _ddp_grads()
        flat = parallel.DistributedDataParallel(mesh).sync(grads)
        parallel.reset_collective_counts()
        got = parallel.DistributedDataParallel(
            mesh, bucket_allreduce=True).sync(grads)
        ran = dict(parallel.collective_counts)
        want = {f"bucket{i:02d}": 1 for i in range(len(comm.bucket_plan(
            list(grads.values()), comm.DEFAULT_MESSAGE_SIZE)))}
        if ran != want:
            raise AssertionError(f"ddp: all-reduces {ran}, expected one "
                                 f"a bucket {want}")
        bad = [k for k in grads if not torch.equal(got[k], flat[k])]
        if bad:
            raise AssertionError(f"ddp: bucketed sync differs on {bad[:4]}")


@case("ddp/no-compress-bitident")
def _():
    """The default ``DistributedDataParallel`` sync (no compression)
    dispatches what ``sync_gradients`` does and returns its gradients bit
    for bit."""
    import torch
    from apex_tpu_torch import parallel
    with world1() as mesh:
        grads = _ddp_grads()
        ddp = parallel.DistributedDataParallel(mesh)
        out = {}

        def plain():
            with parallel.use_mesh(mesh):
                out["plain"] = parallel.sync_gradients(grads, "data")

        def off():
            out["ddp"] = ddp.sync(grads)

        same_dispatch("ddp", plain, off)
        bad = [k for k in grads
               if not torch.equal(out["ddp"][k], out["plain"][k])]
        if bad:
            raise AssertionError(f"ddp: default sync differs on {bad[:4]}")


# --- autotune: a miss launches what "off" does ---------------------------------------

#: the packed fields of the LayerNorm C calls that are launch arguments
#: (not addresses)
_LN_ARGS = {"layer_norm_fwd": ("n", "h", "x_dtype", "w_dtype", "b_dtype",
                               "path", "epl", "eps"),
            "layer_norm_bwd": ("n", "h", "x_dtype", "w_dtype", "path", "epl",
                               "rows", "blocks", "eps")}


@contextlib.contextmanager
def recorded_launches(forward: bool = True):
    """Record every Triton launch (kernel, grid, constexprs and options)
    and every LayerNorm C call (its launch fields) made inside the block,
    handing each on to the real launcher when ``forward`` (a CPU test
    passes False: nothing launches). Yields the list of records."""
    from apex_tpu_torch.ops import _build, layer_norm as L
    calls: List[Tuple] = []
    real_jit = _build.triton_jit

    def jit(fn):
        jf = real_jit(fn) if forward else None

        class Grid:
            def __getitem__(self, grid):
                def go(*args, **kw):
                    calls.append((fn.__name__, tuple(grid),
                                  tuple(sorted(kw.items()))))
                    if forward:
                        return jf[grid](*args, **kw)
                return go
        return Grid()

    def lib(name, fields, struct, real):
        def call(packed, stream):
            vals = dict(zip(fields, struct.unpack(packed)))
            calls.append((name, tuple((k, vals[k]) for k in _LN_ARGS[name])))
            return real()(packed, stream) if forward else 0
        return lambda: call

    saved = (_build.triton_jit, L._ln_fwd_lib, L._ln_bwd_lib)
    _build.triton_jit = jit
    L._ln_fwd_lib = lib("layer_norm_fwd", L.LN_CALL_FIELDS, L._LN_CALL,
                        saved[1])
    L._ln_bwd_lib = lib("layer_norm_bwd", L.LN_BWD_CALL_FIELDS,
                        L._LN_BWD_CALL, saved[2])
    try:
        yield calls
    finally:
        _build.triton_jit, L._ln_fwd_lib, L._ln_bwd_lib = saved


def autotune_probe():
    """One LayerNorm forward and backward at (96, 72) f32 and one
    ``multi_tensor_scale`` and LAMB stage 1 on a buffer of twice
    ``BUFFER_MULTIPLE``: shapes no committed entry has. Returns
    (outputs, launch records)."""
    import torch
    from apex_tpu_torch.arena import BUFFER_MULTIPLE
    from apex_tpu_torch.ops import _arena, layer_norm as L
    from apex_tpu_torch.ops import multi_tensor as M, optim_kernels as K
    rnd, _ = seeded(25)
    f32 = torch.float32
    x, g = rnd(96, 72, dtype=f32), rnd(96, 72, dtype=f32)
    w = rnd(72, dtype=f32) + 1.0
    n = 2 * BUFFER_MULTIPLE
    p, gg, m = (rnd(n, dtype=f32) for _ in range(3))
    v = rnd(n, dtype=f32).abs()
    s1 = _arena.device_scalars((0.9, 0.999, 1e-6, 0.01, 0.1, 0.001, 1.0,
                                0.1), DEVICE)
    with recorded_launches(DEVICE != "cpu") as calls:
        outs = [L.ln_fwd_kernel(x, w, w, 1e-5),
                *L.ln_bwd_kernel(g, x, w, 1e-5),
                *M.scale_kernel(p, _arena.device_scalars((0.5,), DEVICE),
                                f32),
                *K.lamb_stage1_kernel(p, gg, m, v, s1, True)]
    return outs, calls


#: the consults of one ``autotune_probe``: the LayerNorm forward and
#: backward, the scale and the LAMB stage
PROBE_CONSULTS = 4
#: the seeded exact-key hits of ``autotune/no-extra-dispatch``: a new
#: CUDA launch argument (the LayerNorm's ``epl`` and backward blocks) and
#: new Triton specializations (the arena kernels' blocks and warps)
AUTOTUNE_SEEDS = (("layer_norm", (96, 72), {"epl": 16, "bwd_blocks": 4}),
                  ("optimizer", (2 * 512 * 128,),
                   {"BLOCK": 2048, "num_warps": 8, "NORM_BLOCK": 8192}))


@case("autotune/no-extra-dispatch")
def _():
    """The tuning-DB consult with an exact-key contract: a shape that
    misses the DB launches exactly the arguments of
    ``APEX_TPU_AUTOTUNE=off``, with bitwise the same outputs and the same
    dispatch; an exact-key hit on a seeded DB changes the launch (a new
    CUDA launch argument, new Triton specializations)."""
    import torch
    from apex_tpu_torch.ops import autotune
    prev = os.environ.get("APEX_TPU_AUTOTUNE")

    def under(mode):
        os.environ["APEX_TPU_AUTOTUNE"] = mode
        return autotune_probe()

    try:
        out_off, off = under("off")
        autotune.reset_counters()
        out_db, miss = under("db")
        c = autotune.counters()
        if miss != off:
            raise AssertionError(f"a DB miss launched other arguments than "
                                 f"off: {set(miss) ^ set(off)}")
        if c != {"hits": 0, "misses": PROBE_CONSULTS}:
            raise AssertionError(f"expected only misses, got {c}")
        if not all(torch.equal(a, b) for a, b in zip(out_off, out_db)):
            raise AssertionError("a DB miss changed an output's bits")
        os.environ["APEX_TPU_AUTOTUNE"] = "db"
        same_dispatch("autotune miss", lambda: under("off"),
                      lambda: under("db"))
        entries = [autotune.TuningEntry(fam, dims, "float32",
                                        autotune.chip_kind(), block)
                   for fam, dims, block in AUTOTUNE_SEEDS]
        with autotune.use_db(autotune.TuningDB(
                {e.fingerprint: e for e in entries})):
            autotune.reset_counters()
            out_hit, hit = under("db")
            c = autotune.counters()
        if c != {"hits": PROBE_CONSULTS, "misses": 0}:
            raise AssertionError(f"expected only hits, got {c}")
        new = set(hit) - set(off)
        if not any(r[0] == "layer_norm_bwd" for r in new) or not any(
                r[0].endswith("_triton") for r in new):
            raise AssertionError(f"a tuned hit left a launch unchanged: "
                                 f"new launches {new}")
        compare("autotune hit vs off", out_hit, out_off, TOL_ARENA)
    finally:
        if prev is None:
            os.environ.pop("APEX_TPU_AUTOTUNE", None)
        else:
            os.environ["APEX_TPU_AUTOTUNE"] = prev


# --- the runner ------------------------------------------------------------------

def run(pattern: Optional[str] = None,
        json_path: Optional[str] = None) -> Dict:
    """Run every case whose name holds ``pattern`` on the card; return the
    summary (the JAX package's fields, and ``max_abs_err``: :data:`ERRS`)
    and write it to ``json_path``. Raises without a card, before anything
    is built or launched."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("compile check: no CUDA device — the kernels "
                           "are built and checked on a card only (no CPU "
                           "fallback)")
    device = torch.cuda.get_device_name(0)
    ERRS.clear()
    results: List[Dict] = []
    t0 = time.perf_counter()
    for name, fn in CASES:
        if pattern and pattern not in name:
            continue
        t = time.perf_counter()
        try:
            fn()
            torch.cuda.synchronize()
            results.append({"case": name, "ok": True,
                            "s": round(time.perf_counter() - t, 3)})
            print(f"  ok    {name} ({time.perf_counter() - t:.1f} s)",
                  flush=True)
        except Exception as e:  # a failing case is reported, the rest run
            err = "".join(traceback.format_exception_only(type(e), e))[:2000]
            results.append({"case": name, "ok": False, "error": err})
            print(f"  FAIL  {name}\n{traceback.format_exc()}", flush=True)
        torch.cuda.empty_cache()
    n_failed = sum(1 for r in results if not r["ok"])
    summary = {
        "backend": "cuda", "device": device, "compiled": True,
        "ok": n_failed == 0, "n_cases": len(results), "n_failed": n_failed,
        "seconds": round(time.perf_counter() - t0, 3),
        "results": results, "max_abs_err": dict(ERRS),
    }
    if json_path:
        with open(json_path, "w") as f:
            json.dump(summary, f, indent=1)
    print(f"compile-check: {len(results) - n_failed}/{len(results)} ok on "
          f"{device} (compiled)", flush=True)
    return summary


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.ops",
        description="Build, launch and check every hand kernel on the card.")
    ap.add_argument("--compile-check", action="store_true",
                    help="the default (and only) action")
    ap.add_argument("-k", "--filter", dest="pattern",
                    help="run the cases whose name holds PATTERN")
    ap.add_argument("--json", dest="json_path",
                    help="write the summary JSON here")
    args = ap.parse_args(argv)
    try:
        summary = run(args.pattern, args.json_path)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 2
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
