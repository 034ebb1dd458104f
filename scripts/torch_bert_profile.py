#!/usr/bin/env python3
"""Where one training step of apex_tpu_torch spends its time.

    python3 scripts/torch_bert_profile.py [--model bert_large|
        bert_large_dropout|bert_large_zero|resnet50|resnet50_syncbn|dcgan|
        mlp_dlrm_bottom|mha_perf_test|transformer_pre_ln|imagenet_cache|
        imagenet_live] [--steps 2]
        [--strategy auto] [--out PATH]

Builds the port's BERT-Large MLM step (B16, S512, amp O1 bf16, FusedLAMB;
``bert_large_dropout``: as published, with padding masks and attention
dropout 0.1; ``bert_large_zero``: ZeRO's ``DistributedFusedLAMB(lr=1e-3)``
on an NCCL process group of world size 1 over a ``file://`` store, every
collective issued), ring attention's forward and backward on two ranks
(``ring_two_ranks``: two processes on one card in a gloo group, BERT-Large's
heads, B2, a global sequence of 8192, causal; rank 0 reports), its
ResNet-50 step (B256, 224x224, amp O2 bf16, FusedSGD(lr=0.1,
momentum=0.9); ``resnet50_syncbn``: BASELINE configuration 3, BN
statistics across ranks and the gradient sync, on an NCCL process group
of world size 1 over a ``file://`` store, with ``--strategy arena``
through ``DistributedDataParallel(delay_allreduce=True)``), its DCGAN
step (B128, 64x64, amp O1 bf16, two FusedAdam(lr=2e-4, betas=(0.5,
0.999)) bundles, three backwards) or its
fused-MLP step (DLRM's bottom MLP [13, 512, 256, 128] at B2048, amp O2
bf16, 2:4 ASP around FusedAdam(lr=1e-3)), the reference Apex's
multihead-attention benchmark (``mha_perf_test``: one forward and
backward, a "step", of 18 norm-add ``SelfMultiheadAttn(1024, 16,
dropout=0.1)`` layers at B128 S64 in fp16) or a pre-LN transformer stack
(``transformer_pre_ln``: 24 ``TransformerLayer(1024, 16, 4096,
dropout=0.1, pre_ln=True)``, B16 S512 with padding masks, amp O1 bf16, the
arena FusedLAMB), or the ImageNet example's ResNet-50 step fed from
files (``imagenet_cache``: the packed uint8 cache, normalised on the
card; ``imagenet_live``: live JPEG decode, the bf16 cast on the host;
both through ``data.DevicePrefetcher`` from a 512-image 256² tree the
port's encoder writes first, as ``chip_smoke.py``'s data phases do) with
the given optimizer strategy ("auto" takes the tree update for BERT-Large
and ResNet-50 and the arena for DCGAN and the MLP, "arena" the
flat-arena kernels)
on one CUDA device, warms it up, then traces ``--steps`` steps with
``torch.profiler`` and prints one JSON object: the step's wall time, the
device kernel time summed by category (the port's kernels, the BN
backward's two apart, the LayerNorm's forward and backward apart,
convolutions,
GEMMs, dtype casts, other elementwise and reduction kernels, the plain BN
forward of ResNet-50, DCGAN's BatchNorm forward and backward, and the
rest, NCCL's kernels), the device idle share of the traced window, the
host time inside the port's collective ranges (``collectives``' scopes),
the top kernels by time, and the top host ops by self CPU time. Needs a
CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from apex_tpu_torch.prof.xplane import category as _category  # noqa: E402

BN_FWD = "bn_fwd"       # the record_function around the plain BN forward
BATCH_NORM = "batch_norm"   # ... around DCGAN's BatchNorm modules
_BACKWARD = "autograd::engine::evaluate_function"


def _region_ms(prof, name, backward=False):
    """Device ms of the kernels launched under a ``name`` range, by the
    category their names put them in; with ``backward`` also those of the
    autograd nodes recorded there (linked by thread and sequence number).
    Casts stay casts."""
    import torch
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]

    def under(e, match):
        while e is not None and not match(e.name):
            e = e.cpu_parent
        return e is not None

    # the autograd nodes made in the range: the sequence numbers its ops
    # saw, less those ops outside it saw too (an op that makes no node
    # sees the number the next node will take)
    seen = {}
    for e in cpu:
        if (backward and e.sequence_nr >= 0
                and not under(e, lambda n: n.startswith(_BACKWARD))):
            inside = under(e, lambda n: n == name)
            seen.setdefault(inside, set()).add((e.thread, e.sequence_nr))
    fwd = seen.get(True, set()) - seen.get(False, set())

    def in_region(e):
        while e is not None:
            if e.name == name or (e.name.startswith(_BACKWARD) and (
                    e.fwd_thread, e.sequence_nr) in fwd):
                return True
            e = e.cpu_parent
        return False

    out = {}
    for e in cpu:
        kernels = getattr(e, "kernels", None) or []
        if not kernels or not in_region(e):
            continue
        for k in kernels:
            cat = _category(k.name)
            if cat != "cast":
                out[cat] = out.get(cat, 0.0) + k.duration / 1e3
    return out


def _collective_host(prof, steps):
    """{scope: [host ms, calls] a step} of the port's collectives: the CPU
    time of each ``record_function`` range that ``parallel.collectives``
    opens, by its registry scope (bucket ranges summed as ``bucketNN``)."""
    import torch
    from apex_tpu_torch.parallel import registry
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        entry = registry.scope_entry(e.name)
        if entry is None or e.name.startswith(("aten::", "cuda")):
            continue
        key = "bucketNN" if e.name.startswith("bucket") else e.name
        ms, n = out.get(key, (0.0, 0))
        out[key] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return {k: [ms / steps, n / steps] for k, (ms, n) in sorted(out.items())}


def _ring_step(rank):
    """One rank's ``(one_step, batch)`` of ``ring_two_ranks``: causal ring
    attention forward and backward on its 4096-position shard."""
    import datetime
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import parallel

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.environ['RING_STORE']}",
        world_size=2, rank=rank, timeout=datetime.timedelta(seconds=300))
    mesh = parallel.make_mesh([("seq", 2)])
    gen = torch.Generator("cuda").manual_seed(7)
    b, s, h, d = 2, 8192, 16, 64
    q, k, v, do = (torch.randn(b, s // 2, h, d, generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))

    def one_step():
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        with parallel.use_mesh(mesh):
            o = parallel.ring_attention(qg, kg, vg, "seq", causal=True)
            loss = (o * do.float()).sum()
            loss.backward()
        return loss
    return one_step, b


def _ring_ranks(argv):
    """Run this script as ranks 0 and 1 of ``ring_two_ranks``; print rank
    0's JSON."""
    import tempfile
    env = dict(os.environ, RING_STORE=f"{tempfile.mkdtemp()}/store")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               *argv, "--rank", str(r)], env=env,
                              stdout=subprocess.PIPE if r else None)
             for r in range(2)]
    codes = [p.wait(timeout=900) for p in procs]
    return max(codes, key=abs)


def _imagenet_step(model):
    """The example's step fed through the prefetcher, as
    ``scripts/torch_imagenet_main_amp.py`` feeds it (no sync a step)."""
    import tempfile
    import numpy as np
    import torch
    from apex_tpu_torch import data, train
    root = tempfile.mkdtemp(prefix="torch_profile_imagenet_")
    tree = data.make_fake_imagefolder(os.path.join(root, "tree"),
                                      n_classes=8, per_class=64, size=256)
    if model == "imagenet_cache":
        src = data.PackedSource(data.build_cache(
            tree, os.path.join(root, "cache")), 256, 224, dtype=np.uint8)
        cast = None
    else:
        src = data.ImageFolderSource(tree, 256, 224)
        cast = torch.bfloat16
    batches = iter(data.DevicePrefetcher(src.batches(1 << 30),
                                         cast_dtype=cast))
    step, (state, bstats), _, policy, _ = train.build_resnet_step(256, 224)
    carry = [state, bstats]

    def one_step():
        xb, yb = next(batches)
        if xb.dtype == torch.uint8:
            xb = data.normalize_uint8(xb, policy.compute_dtype)
        carry[0], carry[1], loss = step(carry[0], carry[1], xb, yb.long())
        return loss
    return one_step, 256


def _builder(model, strategy, rank=None):
    """``(one_step, batch)``: ``one_step()`` runs a step and returns its
    loss."""
    import contextlib
    from apex_tpu_torch import train
    if model == "ring_two_ranks":
        return _ring_step(rank)
    if model == "bert_large_zero":
        import tempfile
        from apex_tpu_torch import parallel
        from apex_tpu_torch.optim import DistributedFusedLAMB
        parallel.distributed_init(
            init_method=f"file://{tempfile.mkdtemp()}/store",
            num_processes=1, process_id=0)
        mesh = parallel.data_parallel_mesh()

        def bound():
            return parallel.use_mesh(mesh)
        opt = dict(optimizer=DistributedFusedLAMB(lr=1e-3))
    else:
        bound = contextlib.nullcontext
        opt = dict(strategy=strategy)
    if model.startswith("bert_large"):
        published = model == "bert_large_dropout"
        with bound():
            step, state, (toks, labels), _, _ = train.build_bert_step(
                16, 512, dropout=0.1 if published else 0.0,
                padded=published, **opt)
        carry = [state]

        def one_step():
            with bound():
                carry[0], loss = step(carry[0], toks, labels)
            return loss
        return one_step, 16
    if model == "mha_perf_test":
        import torch
        run, params, inputs = train.build_mha_perf_test()
        grads = torch.randn(inputs[0].shape, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(3)
                            ).to(inputs[0].dtype)

        def one_step():
            out = run(params)
            out.backward(grads)
            return out.detach().float().abs().mean()
        return one_step, inputs[0].shape[0]
    if model == "transformer_pre_ln":
        step, state, (x, _, _), _, _ = train.build_transformer_step()
        carry = [state]

        def one_step():
            carry[0], loss = step(carry[0])
            return loss
        return one_step, x.shape[0]
    if model == "mlp_dlrm_bottom":
        step, state, (x, t), _, _ = train.build_mlp_step(
            2048, strategy=strategy)
        carry = [state]

        def one_step():
            carry[0], loss = step(carry[0], x, t)
            return loss
        return one_step, 2048
    if model == "dcgan":
        step, states, (z, real), _, _ = train.build_dcgan_step(
            128, strategy=strategy)
        carry = list(states)

        def one_step():
            out = step(*carry, z, real)
            carry[:] = out[:4]
            return out[4][2]           # the generator's loss
        return one_step, 128
    if model in ("imagenet_cache", "imagenet_live"):
        return _imagenet_step(model)
    kw = dict(strategy=strategy)
    if model == "resnet50_syncbn":
        import tempfile
        from apex_tpu_torch import parallel
        from apex_tpu_torch.optim import FusedSGD
        parallel.distributed_init(
            init_method=f"file://{tempfile.mkdtemp()}/store",
            num_processes=1, process_id=0)
        kw = dict(bn_axis_name="data")
        if strategy == "arena":
            kw.update(ddp=parallel.DistributedDataParallel(
                parallel.data_parallel_mesh(), delay_allreduce=True),
                optimizer=FusedSGD(lr=0.1, momentum=0.9, strategy="arena"))
    step, (state, bstats), (x, y), _, _ = train.build_resnet_step(
        256, 224, **kw)
    carry = [state, bstats]

    def one_step():
        carry[0], carry[1], loss = step(carry[0], carry[1], x, y)
        return loss
    return one_step, 256


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="bert_large",
                    choices=("bert_large", "bert_large_dropout",
                             "bert_large_zero", "ring_two_ranks", "resnet50",
                             "resnet50_syncbn", "dcgan", "mlp_dlrm_bottom",
                             "mha_perf_test", "transformer_pre_ln",
                             "imagenet_cache", "imagenet_live"))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--strategy", default="auto",
                    choices=("auto", "tree", "arena"))
    ap.add_argument("--out", default=None,
                    help="also write the JSON (and a chrome trace beside it)")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # a ring_two_ranks rank
    args = ap.parse_args()
    if args.model == "ring_two_ranks" and args.rank is None:
        return _ring_ranks(sys.argv[1:])

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_bert_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from torch.profiler import record_function
    from apex_tpu_torch.models import layers
    from apex_tpu_torch.ops import bn_act

    torch.backends.cuda.matmul.allow_tf32 = False

    def traced(fn, name):
        def wrapper(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapper

    bn_act._fwd_common = traced(bn_act._fwd_common, BN_FWD)
    layers.BatchNorm.forward = traced(layers.BatchNorm.forward, BATCH_NORM)
    one_step, batch = _builder(args.model, args.strategy, args.rank)
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

    # device events, less the device-side spans of the annotations (the
    # script's own, and those of the trace spans and collective scopes)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in (BN_FWD, BATCH_NORM)]
    by_cat, by_name, ln_parts = {}, {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        cat = _category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        if cat == "layer_norm":     # the forward and backward apart
            part = "ln_bwd" if "ln_bwd_" in e.name else "ln_fwd"
            ln_parts[part] = ln_parts.get(part, [0.0, 0])
            ln_parts[part][0] += us
            ln_parts[part][1] += 1
    busy_ms = sum(by_cat.values()) / 1e3
    by_cat = {k: v / 1e3 for k, v in by_cat.items()}
    region, backward = {"resnet50": (BN_FWD, False),
                        "imagenet_cache": (BN_FWD, False),
                        "imagenet_live": (BN_FWD, False),
                        "resnet50_syncbn": (BN_FWD, False),
                        "dcgan": (BATCH_NORM, True)}.get(args.model,
                                                         (None, False))
    if region is not None:
        moved = _region_ms(prof, region, backward)
        for cat, ms in moved.items():    # out of its name's category
            by_cat[cat] -= ms
        by_cat[region] = sum(moved.values()) if moved else None
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
        "collective_host_ms_and_calls_per_step": _collective_host(
            prof, args.steps),
        "layer_norm_ms_and_kernels_per_step": {
            k: [us / 1e3 / args.steps, n / args.steps]
            for k, (us, n) in sorted(ln_parts.items())},
        "top_kernels_ms_per_step": [
            [n[:90], v / 1e3 / args.steps] for n, v in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:15]],
        "top_host_ops_ms_per_step": [
            [e.key[:90], e.self_cpu_time_total / 1e3 / args.steps, e.count
             // args.steps] for e in sorted(
                 prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
            [:15]],
    }
    if args.rank:            # ring_two_ranks: rank 0 reports
        return 0 if kernels else 1
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
