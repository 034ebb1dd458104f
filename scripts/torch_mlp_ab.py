#!/usr/bin/env python3
"""The fused MLP forward: this checkout's CUDA kernel against another
checkout's, in one process on one card.

    python3 scripts/torch_mlp_ab.py --parent DIR [--out PATH]

``DIR`` holds another checkout's ``apex_tpu_torch`` package (for example
``git archive <commit> apex_tpu_torch | tar -x -C DIR``); its
``mlp_fwd_kernel`` is loaded from there with its own ``ops/_build.py`` (its
CUDA sources build into ``DIR/build``), beside this checkout's. First this
checkout's kernel is held against its plain version on every case of
the compile check's ``kernels/mlp`` case (path, edge, ragged, each two
launches bitwise equal; the per-layer and multi-launch plans; mixed
dtypes), then
both kernels are timed in turns (other, this, this, other) at the path's
shape (DLRM's bottom MLP, B2048 x [13, 512, 256, 128], bf16 x and
weights), the budget's edge (B8192 x [1024]·3, f32) and the ragged 96 x
[224, 200, 136, 10] (f32, sigmoid, no bias): CUDA events, device time
(``chip_smoke.device_ms``) and host time a call (``host_us``), beside the
chain of ``torch.addmm`` + activation in f32 (no single PyTorch call
computes an MLP) and the data-sheet bound (f32 FMA on the CUDA cores).
Prints one JSON object (and writes it to ``--out``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (("path", 2048, (13, 512, 256, 128), "relu", True, "bfloat16"),
         ("edge", 8192, (1024, 1024, 1024), "relu", True, "float32"),
         ("ragged", 96, (224, 200, 136, 10), "sigmoid", False, "float32"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_mlp_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke
    from apex_tpu_torch.ops import _build, compile_check, mlp as P
    from torch_norm_ab import load_parent, measure, turns

    other_build, (PP,) = load_parent(args.parent, ("mlp",))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    libs = _build.build_all()
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "build_s": time.perf_counter() - t0}
    other_build.build_all()
    chip_smoke.echo_ptxas({"mlp_fwd": libs["mlp_fwd"]})

    rows = {}
    compile_check.ERRS.clear()
    dict(compile_check.CASES)["kernels/mlp"]()
    rnd, _gen, flush, row = chip_smoke.bench_tools(rows,
                                                   compile_check.ERRS)
    chip_smoke.time_mlp_kernel(rnd, flush, row)
    acts = {"relu": torch.relu, "sigmoid": torch.sigmoid}
    for name, n, dims, act, bias, dt in CASES:
        dt = getattr(torch, dt)
        x, ws, bs = compile_check.mlp_operands(rnd, n, list(dims), act,
                                               bias, dt, dt)
        rec = turns(f"mlp_fwd {name} {n}x{list(dims)} {dt}",
                    lambda: PP.mlp_fwd_kernel(x, ws, bs, act),
                    lambda: P.mlp_fwd_kernel(x, ws, bs, act), flush, out)
        x32, w32 = x.float(), [w.float() for w in ws]
        b32 = [b.float() for b in bs] if bias else None

        def chain():
            h = x32
            for i, w in enumerate(w32):
                h = acts[act](torch.addmm(b32[i], h, w) if bias
                              else torch.mm(h, w))
            return h

        rec["library"] = measure(chain, flush)
        flops = 2 * n * sum(a * b for a, b in zip(dims, dims[1:]))
        nbytes = (x.numel() + n * dims[-1]) * x.element_size() + sum(
            t.numel() * t.element_size() for t in ws + (bs or []))
        rec["bound_ms"] = max(flops / chip_smoke.F32_FLOPS,
                              nbytes / chip_smoke.HBM_BYTES_PER_S) * 1e3
        print(f"  addmm chain {rec['library']}; bound {rec['bound_ms']:.4f} "
              f"ms", flush=True)

    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
