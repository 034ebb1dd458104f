#!/usr/bin/env python3
"""Where one training step of apex_tpu_torch spends its time.

    python3 scripts/torch_bert_profile.py [--model bert_large|resnet50]
        [--steps 2] [--strategy auto] [--out PATH]

Builds the port's BERT-Large MLM step (B16, S512, amp O1 bf16, FusedLAMB)
or its ResNet-50 step (B256, 224x224, amp O2 bf16, FusedSGD(lr=0.1,
momentum=0.9)) with the given optimizer strategy ("auto" takes the tree
update at both sizes, "arena" the flat-arena kernels) on one CUDA device,
warms it up, then traces ``--steps`` steps with ``torch.profiler`` and
prints one JSON object: the step's wall time, the device kernel time
summed by category (the port's kernels, convolutions, GEMMs, the plain
BN forward passes, and the rest), the device idle share of the traced
window, and the top kernels by time. Needs a CUDA device; fails without
one.
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
    ("bn_bwd", ("_bn_sums_triton", "_bn_dx_triton")),
    ("arena_sgd", ("_sgd_triton",)),
    ("conv", ("fprop", "dgrad", "wgrad", "cudnn", "convolve", "conv2d",
              "nchwtonhwc", "nhwctonchw")),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "cublas")),
)
BN_FWD = "bn_fwd"       # the record_function around the plain BN forward


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat
    return "other"


def _bn_forward_ms(prof):
    """Device ms of the kernels launched under a ``bn_fwd`` range, by the
    category their names put them in."""
    import torch
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        kernels = getattr(e, "kernels", None) or []
        if not kernels:
            continue
        parent = e
        while parent is not None and parent.name != BN_FWD:
            parent = parent.cpu_parent
        if parent is None:
            continue
        for k in kernels:
            cat = _category(k.name)
            out[cat] = out.get(cat, 0.0) + k.duration / 1e3
    return out


def _builder(model, strategy):
    """``(one_step, batch)``: ``one_step()`` runs a step and returns its
    loss."""
    from apex_tpu_torch import train
    if model == "bert_large":
        step, state, (toks, labels), _, _ = train.build_bert_step(
            16, 512, strategy=strategy)
        carry = [state]

        def one_step():
            carry[0], loss = step(carry[0], toks, labels)
            return loss
        return one_step, 16
    step, (state, bstats), (x, y), _, _ = train.build_resnet_step(
        256, 224, strategy=strategy)
    carry = [state, bstats]

    def one_step():
        carry[0], carry[1], loss = step(carry[0], carry[1], x, y)
        return loss
    return one_step, 256


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="bert_large",
                    choices=("bert_large", "resnet50"))
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
    from torch.profiler import record_function
    from apex_tpu_torch.ops import bn_act

    torch.backends.cuda.matmul.allow_tf32 = False
    fwd_common = bn_act._fwd_common

    def traced_fwd_common(*a, **kw):
        with record_function(BN_FWD):
            return fwd_common(*a, **kw)

    bn_act._fwd_common = traced_fwd_common
    one_step, batch = _builder(args.model, args.strategy)
    for _ in range(2):
        loss = one_step()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss = one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # device events, less the device-side span of the bn_fwd annotation
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name != BN_FWD]
    by_cat, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_cat[_category(e.name)] = by_cat.get(_category(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy_ms = sum(by_cat.values()) / 1e3
    by_cat = {k: v / 1e3 for k, v in by_cat.items()}
    bn_fwd = _bn_forward_ms(prof)
    for cat, ms in bn_fwd.items():       # moved out of its name's category
        by_cat[cat] -= ms
    if args.model == "resnet50":
        by_cat["bn_fwd"] = sum(bn_fwd.values()) if bn_fwd else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "model": args.model, "steps": args.steps,
        "strategy": args.strategy, "batch": batch,
        "loss": loss.item(),
        "step_ms": wall_ms / args.steps,
        "items_per_s": batch * args.steps / wall_ms * 1e3,
        "kernel_ms_per_step": busy_ms / args.steps,
        "device_idle_share": (max(0.0, 1.0 - busy_ms / wall_ms)
                              if kernels else None),
        "kernels_per_step": len(kernels) / args.steps,
        "by_category_ms_per_step": {
            k: None if v is None else v / args.steps
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
