#!/usr/bin/env python3
"""What parts of the LayerNorm backward, fused MLP forward and generic
flash attention kernels cost: variants of this checkout's CUDA sources,
timed in turns on one card.

    python3 scripts/torch_kernel_variants.py [--only PREFIX] [--out PATH]

Each variant is a copy of ``apex_tpu_torch/csrc/layer_norm_bwd.cu``,
``mlp_fwd.cu`` or ``flash_attn_generic.cu`` with one change
(``VARIANTS``), built with the port's nvcc flags into ``build/variants/``
and loaded beside the port's own build; the port's wrapper
(``ln_bwd_kernel``, ``mlp_fwd_kernel``, ``flash_fwd_kernel`` /
``flash_bwd_kernel``) calls each variant's entry point in turn, so every
variant sees the same plan and operands. The LayerNorm variants run at
BERT-Large's (8192, 1024) bf16 (also without affine params, where no
partials are summed), the MLP variants at DLRM's bottom MLP (B2048 x [13,
512, 256, 128], bf16), the flash variants forward and backward at
BERT-Large's attention in f32 (16, 512, 16, 64) and ViT-H/14's (16, 257,
16, 80) in bf16 (their copies keep only those two width classes, which
changes no kernel they run). Device time of one call
(``chip_smoke.device_ms``), each variant timed twice, in the order given
and then reversed. A variant that drops work (``no_finish``,
``no_products``) computes wrong results and is timed only. ``--only``
keeps the variants whose name starts with PREFIX. Prints one JSON object
(and writes it to ``--out``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "variants")

# {variant: (source, [(text, replacement)], what the change shows)}
VARIANTS = {
    "ln_bwd": ("layer_norm_bwd.cu", [], "the port's kernel"),
    "ln_bwd_no_finish": (
        "layer_norm_bwd.cu",
        [("    part[h + col] = sb;\n  }\n  finish(a);",
          "    part[h + col] = sb;\n  }")],
        "the cost of adding the partials in the launch (dγ/dβ wrong)"),
    "ln_bwd_one_finisher": (
        "layer_norm_bwd.cu",
        [("constexpr int kFinishers = 32;", "constexpr int kFinishers = 1;")],
        "the last block alone adds all partials, as the BN sums do"),
    "ln_bwd_8_finishers": (
        "layer_norm_bwd.cu",
        [("constexpr int kFinishers = 32;", "constexpr int kFinishers = 8;")],
        "8 blocks add the partials"),
    "mlp_fwd": ("mlp_fwd.cu", [], "the port's kernel: 2 stages of 32 KB"),
    "mlp_fwd_ring_2x16k": (
        "mlp_fwd.cu",
        [("static constexpr int kKs = 128 / (int)sizeof(TW);",
          "static constexpr int kKs = 64 / (int)sizeof(TW);")],
        "2 stages of 16 KB (32 rows of 16-bit weights)"),
    "mlp_fwd_ring_4x8k": (
        "mlp_fwd.cu",
        [("static constexpr int kKs = 128 / (int)sizeof(TW);",
          "static constexpr int kKs = 32 / (int)sizeof(TW);"),
         ("constexpr int kStages = 2;", "constexpr int kStages = 4;")],
        "4 stages of 8 KB (16 rows of 16-bit weights), 3 slices ahead"),
    "flash_generic": ("flash_attn_generic.cu", [], "the port's kernels"),
    "flash_generic_ring3": (
        "flash_attn_generic.cu",
        [("  static constexpr int NS = F32 ? 1 : 2;",
          "  static constexpr int NS = F32 ? 2 : 3;")],
        "a stage more in each ring (the next two tiles load while one "
        "multiplies): more shared memory, fewer blocks an SM"),
    "flash_generic_one_m_tile": (
        "flash_attn_generic.cu",
        [("  static constexpr int MT = F32 && DP == 64 ? 2 : 1;",
          "  static constexpr int MT = 1;")],
        "one m16 tile a warp in the f32 forward and dQ (64-row blocks, "
        "three an SM) instead of two (128-row blocks)"),
    "flash_generic_tile32": (
        "flash_attn_generic.cu",
        [("  static constexpr int BN = F32 ? 16 : 32;",
          "  static constexpr int BN = F32 && DP == 256 ? 16 : 32;")],
        "32-row streamed tiles at f32: each split pass and A fragment "
        "serves twice the keys, fewer blocks an SM"),
    "flash_generic_dkv_slices": (
        "flash_attn_generic.cu",
        [("  static constexpr bool SPLIT = DP > 64;",
          "  static constexpr bool SPLIT = DP > 64 || F32;")],
        "dK/dV in two grid slices at f32 D = 64 too (one D-wide "
        "accumulator a thread, P recomputed)"),
    "flash_generic_cvt": (
        "flash_attn_generic.cu",
        [("  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
          "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : "
          "\"f\"(x));\n  return r;")],
        "cvt.rna.tf32.f32 itself for the TF32 rounding (its inf/NaN guard "
        "costs an instruction a rounding)"),
    "flash_generic_unrolled": (
        "flash_attn_generic.cu",
        [("#pragma unroll 1\n    for (int kk = 0; kk < nk; ++kk) {",
          "#pragma unroll\n    for (int kk = 0; kk < LDX / 16; ++kk) if "
          "(kk < nk) {"),
         ("#pragma unroll 4   // four k steps a turn: a 6% faster f32 "
          "backward than one\n    for (int kk = 0; kk < nk; ++kk) {",
          "#pragma unroll\n    for (int kk = 0; kk < LDX / 8; ++kk) if "
          "(kk < nk) {")],
        "the k loops unrolled whole (the instruction cache)"),
    "flash_generic_no_products": (
        "flash_attn_generic.cu",
        [("      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;\n  if "
          "constexpr (sizeof(T) == 2) {",
          "      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;\n  if (nk "
          ">= 0) return;\n  if constexpr (sizeof(T) == 2) {"),
         ("  const int lane = threadIdx.x & 31;\n  if constexpr (sizeof(T) == "
          "2) {\n    constexpr int GP",
          "  const int lane = threadIdx.x & 31;\n  if (nd >= 0) return;\n  "
          "if constexpr (sizeof(T) == 2) {\n    constexpr int GP")],
        "no MMA products (wrong results): the loads, split passes, softmax "
        "and barriers alone"),
}

# the flash variants' copies keep the two width classes they are timed at
FLASH_ONLY = ("""  if (d <= 64) return forward ? fwd<T, 64>(a, d, st) : bwd<T, 64>(a, d, st);
  if (d <= 128)
    return forward ? fwd<T, 128>(a, d, st) : bwd<T, 128>(a, d, st);
  return forward ? fwd<T, 256>(a, d, st) : bwd<T, 256>(a, d, st);""",
              """  if constexpr (std::is_same<T, float>::value)
    return forward ? fwd<T, 64>(a, d, st) : bwd<T, 64>(a, d, st);
  else
    return forward ? fwd<T, 128>(a, d, st) : bwd<T, 128>(a, d, st);""")


def build(names):
    """Builds each variant's library in parallel; {name: path}."""
    from apex_tpu_torch.ops import _build
    csrc = os.path.join(ROOT, "apex_tpu_torch", "csrc")
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src_name, edits, _ = VARIANTS[name]
        with open(os.path.join(csrc, src_name)) as f:
            src = f.read()
        if src_name == "flash_attn_generic.cu":
            edits = [FLASH_ONLY] + edits
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"variant {name}: {old!r} not in "
                                   f"{src_name}")
            src = src.replace(old, new)
        cu = os.path.join(OUT_DIR, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        lib = os.path.join(OUT_DIR, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        out[name] = lib
    return out


def entry(lib, symbol, argtypes=(ctypes.c_char_p, ctypes.c_void_p)):
    fn = getattr(ctypes.CDLL(lib), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def in_turns(calls, flush):
    """{name: [device ms, ...]}: each call timed in the order given, then
    in reverse."""
    from chip_smoke import device_ms
    res = {k: [] for k in calls}
    for k in list(calls) + list(calls)[::-1]:
        res[k].append(device_ms(calls[k], flush=flush))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="the variants whose name starts with this")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    names = [k for k in VARIANTS if k.startswith(args.only)]

    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from apex_tpu_torch.ops import _build, compile_check
    from apex_tpu_torch.ops import attention as A
    from apex_tpu_torch.ops import layer_norm as L, mlp as P

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    libs = build(names)
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "build_s": time.perf_counter() - t0,
           "variants": {k: VARIANTS[k][2] for k in names}}
    rows = {}
    rnd, _gen, flush, _row = chip_smoke.bench_tools(rows, {})

    def through(module, attr, fn, call):
        """``call`` with ``module.attr`` (the wrapper's entry point
        getter) answering ``fn``."""
        def run():
            saved = getattr(module, attr)
            setattr(module, attr, lambda: fn)
            try:
                return call()
            finally:
                setattr(module, attr, saved)
        return run

    flash = {k: libs[k] for k in names if k.startswith("flash_")}
    flash_args = (ctypes.c_int, ctypes.c_int, ctypes.POINTER(A._FlashArgs),
                  ctypes.c_void_p)
    for label, shape, dt in (("f32 (16, 512, 16, 64)", (16, 512, 16, 64),
                              torch.float32),
                             ("bf16 (16, 257, 16, 80)", (16, 257, 16, 80),
                              torch.bfloat16)):
        if not flash:
            break
        q, k, v, do = (rnd(*shape, dtype=dt) for _ in range(4))
        scale = shape[3] ** -0.5
        o, lse = A.flash_fwd_plain(q, k, v, scale)
        delta = compile_check.delta_of(do, o)
        want = [[o, lse], A.flash_bwd_plain(q, k, v, do, lse, delta, scale)]
        for way, call in (
                ("forward", lambda: A.flash_fwd_kernel(q, k, v, scale)),
                ("backward", lambda: A.flash_bwd_kernel(q, k, v, do, lse,
                                                        delta, scale))):
            calls = {}
            for name, lib in flash.items():
                fns = {e: entry(lib, f"apex_{e}", flash_args) for e in (
                    "flash_attn_generic_fwd", "flash_attn_generic_bwd")}
                calls[name] = with_lib(A, fns, call)
                if not name.endswith("no_products"):
                    got = calls[name]()
                    chip_smoke.compare(f"{name} {way} {label}", list(got),
                                       want[way == "backward"])
            out[f"flash {way} {label}"] = in_turns(calls, flush)
        del q, k, v, do

    if any(k.startswith("ln_") for k in names):
        ln_variants(names, libs, rnd, flush, through, out, chip_smoke, L)
    if any(k.startswith("mlp_") for k in names):
        mlp_variants(names, libs, rnd, flush, through, out, chip_smoke,
                     compile_check, P)

    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


def with_lib(A, fns, call):
    """``call`` with the attention module's library getter answering the
    variant's entry points ``fns`` (by entry name)."""
    def run():
        saved = A._lib
        A._lib = lambda lib, e=None: fns[e]
        try:
            return call()
        finally:
            A._lib = saved
    return run


def ln_variants(names, libs, rnd, flush, through, out, chip_smoke, L):
    import torch
    x = rnd(8192, 1024, std=2.0)
    g = rnd(8192, 1024)
    w = rnd(1024, dtype=torch.float32, std=0.2) + 1.0
    ln = {k: entry(libs[k], "apex_ln_bwd") for k in names
          if k.startswith("ln_")}
    want = L.ln_bwd_plain(g, x, w, 1e-5)
    for k, fn in ln.items():
        if k != "ln_bwd_no_finish":
            chip_smoke.compare(k, through(
                L, "_ln_bwd_lib", fn, lambda: L.ln_bwd_kernel(g, x, w,
                                                              1e-5))(), want)
    out["ln_bwd (8192, 1024) bf16"] = in_turns(
        {k: through(L, "_ln_bwd_lib", fn,
                    lambda: L.ln_bwd_kernel(g, x, w, 1e-5))
         for k, fn in ln.items()}, flush)
    out["ln_bwd (8192, 1024) bf16, no affine"] = in_turns(
        {"ln_bwd": lambda: L.ln_bwd_kernel(g, x, None, 1e-5)}, flush)


def mlp_variants(names, libs, rnd, flush, through, out, chip_smoke,
                 compile_check, P):
    import torch
    x, ws, bs = compile_check.mlp_operands(
        rnd, 2048, list(chip_smoke.MLP_BOTTOM), "relu", True, torch.bfloat16,
        torch.bfloat16)
    mlp = {k: entry(libs[k], "apex_mlp_fwd") for k in names
           if k.startswith("mlp_")}
    want = P.mlp_fused_reference(x, ws, bs)
    for k, fn in mlp.items():
        chip_smoke.compare(k, [through(P, "_lib", fn, lambda: P.mlp_fwd_kernel(
            x, ws, bs))()], [want], 1e-4)
    out["mlp_fwd B2048 [13, 512, 256, 128] bf16"] = in_turns(
        {k: through(P, "_lib", fn, lambda: P.mlp_fwd_kernel(x, ws, bs))
         for k, fn in mlp.items()}, flush)


if __name__ == "__main__":
    sys.exit(main())
