#!/usr/bin/env python3
"""What parts of the LayerNorm backward and fused MLP forward kernels cost:
variants of this checkout's CUDA sources, timed in turns on one card.

    python3 scripts/torch_kernel_variants.py [--out PATH]

Each variant is a copy of ``apex_tpu_torch/csrc/layer_norm_bwd.cu`` or
``mlp_fwd.cu`` with one change (``VARIANTS``), built with the port's nvcc
flags into ``build/variants/`` and loaded beside the port's own build; the
port's wrapper (``ln_bwd_kernel``, ``mlp_fwd_kernel``) calls each variant's
entry point in turn, so every variant sees the same plan and operands. The
LayerNorm variants run at BERT-Large's (8192, 1024) bf16 (also without
affine params, where no partials are summed), the MLP variants at DLRM's
bottom MLP (B2048 x [13, 512, 256, 128], bf16). Device time of one call
(``chip_smoke.device_ms``), each variant timed twice, in the order given
and then reversed. A variant that drops work (``no_finish``) computes
wrong dγ/dβ and is timed only. Prints one JSON object (and writes it to
``--out``). Needs a CUDA device.
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
}


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


def entry(lib, symbol):
    fn = getattr(ctypes.CDLL(lib), symbol)
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
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
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from apex_tpu_torch.ops import _build, compile_check
    from apex_tpu_torch.ops import layer_norm as L, mlp as P

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    libs = build(VARIANTS)
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "build_s": time.perf_counter() - t0,
           "variants": {k: v[2] for k, v in VARIANTS.items()}}
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

    x = rnd(8192, 1024, std=2.0)
    g = rnd(8192, 1024)
    w = rnd(1024, dtype=torch.float32, std=0.2) + 1.0
    ln = {k: entry(libs[k], "apex_ln_bwd") for k in VARIANTS
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
    del x, g

    x, ws, bs = compile_check.mlp_operands(
        rnd, 2048, list(chip_smoke.MLP_BOTTOM), "relu", True, torch.bfloat16,
        torch.bfloat16)
    mlp = {k: entry(libs[k], "apex_mlp_fwd") for k in VARIANTS
           if k.startswith("mlp_")}
    want = P.mlp_fused_reference(x, ws, bs)
    for k, fn in mlp.items():
        chip_smoke.compare(k, [through(P, "_lib", fn, lambda: P.mlp_fwd_kernel(
            x, ws, bs))()], [want], 1e-4)
    out["mlp_fwd B2048 [13, 512, 256, 128] bf16"] = in_turns(
        {k: through(P, "_lib", fn, lambda: P.mlp_fwd_kernel(x, ws, bs))
         for k, fn in mlp.items()}, flush)

    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
