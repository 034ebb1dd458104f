#!/usr/bin/env python3
"""Where one BERT-Large training step of apex_tpu_torch spends its time.

    python3 scripts/torch_bert_profile.py [--steps 2] [--strategy auto]
                                          [--out PATH]

Builds the port's BERT-Large MLM step (B16, S512, amp O1 bf16, FusedLAMB
with the given strategy: "auto" takes the tree update at this size,
"arena" the flat-arena kernels) on one CUDA device, warms it up, then traces ``--steps`` steps with
``torch.profiler`` and prints one JSON object: the step's wall time, the
device kernel time summed by category (the port's kernels, GEMMs, and the
rest), the device idle share of the traced window, and the top kernels by
time. Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_CATEGORIES = (
    ("flash_attn", ("flash_fwd", "flash_bwd")),
    ("layer_norm", ("_ln_fwd_triton", "_ln_bwd_triton")),
    ("xentropy", ("_ce_fwd_triton", "_ce_bwd_triton")),
    ("arena_lamb", ("_l2norm_partials_triton", "_l2norm_finish_triton",
                    "_lamb_stage1_triton", "_lamb_stage2_triton")),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "cublas")),
)


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--strategy", default="auto",
                    choices=("auto", "tree", "arena"))
    ap.add_argument("--out", default=None,
                    help="also write the JSON (and a chrome trace beside it)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_bert_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from apex_tpu_torch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    step, state, (toks, labels), _, _ = train.build_bert_step(
        16, 512, strategy=args.strategy)
    for _ in range(2):
        state, loss = step(state, toks, labels)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, loss = step(state, toks, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_cat, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_cat[_category(e.name)] = by_cat.get(_category(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy_ms = sum(by_cat.values()) / 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "steps": args.steps, "strategy": args.strategy,
        "loss": loss.item(),
        "step_ms": wall_ms / args.steps,
        "kernel_ms_per_step": busy_ms / args.steps,
        "device_idle_share": (max(0.0, 1.0 - busy_ms / wall_ms)
                              if kernels else None),
        "kernels_per_step": len(kernels) / args.steps,
        "by_category_ms_per_step": {k: v / 1e3 / args.steps
                                    for k, v in sorted(by_cat.items())},
        "top_kernels_ms_per_step": [
            [n[:90], v / 1e3 / args.steps] for n, v in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:15]],
    }
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
        prof.export_chrome_trace(os.path.splitext(args.out)[0] + ".trace.json")
    return 0 if kernels else 1


if __name__ == "__main__":
    sys.exit(main())
