#!/usr/bin/env python3
"""The ImageNet amp example on the port: ``examples/imagenet/main_amp.py``'s
flags, loop and prints, through ``train.build_resnet_step``.

    python3 scripts/torch_imagenet_main_amp.py -b 128 --epochs 1 \\
        --steps-per-epoch 50
    python3 scripts/torch_imagenet_main_amp.py --data DIR --cache CACHEDIR \\
        --opt-level O2 --loss-scale dynamic

ResNet-18/50/101 under ``amp.Amp`` with ``FusedSGD(lr, momentum,
weight_decay)``; ``--opt-level/--keep-batchnorm-fp32/--loss-scale`` build
the policy as the reference feeds ``amp.initialize``. Synthetic data by
default; ``--data`` reads an ImageFolder tree through
``data.ImageFolderSource`` (the port's JPEG codec and PIL-exact resampler),
``--data --cache`` through the packed uint8 cache (``data.PackedSource``,
normalised on the card). A loader-only probe on its own source prints the
``loader:`` line, and ``data.DevicePrefetcher`` (pinned memory, side
stream, half cast on the host) feeds the step. ``--sync_bn`` syncs the BN
statistics over the data axis, and the step syncs its gradients through
``parallel.DistributedDataParallel`` when a process group is up
(``launch.distributed_init``: ``MASTER_ADDR``/``WORLD_SIZE``/``RANK``).
``-b`` is the global batch. Runs on the card; ``--device cpu`` runs the
plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from apex_tpu_torch import amp, models, parallel, train  # noqa: E402
from apex_tpu_torch.data import (DevicePrefetcher, ImageFolderSource,  # noqa
                                 PackedSource, build_cache, measure_source,
                                 normalize_uint8, synthetic_source)
from apex_tpu_torch.optim import FusedSGD  # noqa: E402
from apex_tpu_torch.parallel import launch  # noqa: E402

ARCHS = {
    "resnet18": models.ResNet18,
    "resnet50": models.ResNet50,
    "resnet101": models.ResNet101,
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="apex_tpu_torch ImageNet")
    parser.add_argument("--data", metavar="DIR", default=None,
                        help="path to dataset (synthetic if omitted)")
    parser.add_argument("--arch", "-a", default="resnet50", choices=ARCHS)
    parser.add_argument("--epochs", default=1, type=int)
    parser.add_argument("--steps-per-epoch", default=100, type=int)
    parser.add_argument("-b", "--batch-size", default=128, type=int,
                        help="GLOBAL batch size (split over the ranks)")
    parser.add_argument("--lr", "--learning-rate", default=0.1, type=float)
    parser.add_argument("--momentum", default=0.9, type=float)
    parser.add_argument("--weight-decay", "--wd", default=1e-4, type=float)
    parser.add_argument("--print-freq", "-p", default=10, type=int)
    parser.add_argument("--image-size", default=224, type=int)
    parser.add_argument("--prof", default=-1, type=int,
                        help="profile this many steps into ./prof_trace")
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--sync_bn", action="store_true",
                        help="sync BN stats over the data axis")
    parser.add_argument("--opt-level", type=str, default="O2")
    parser.add_argument("--keep-batchnorm-fp32", type=str, default=None)
    parser.add_argument("--loss-scale", type=str, default=None)
    parser.add_argument("--cache", metavar="CACHEDIR", default=None,
                        help="packed pre-decoded uint8 shard cache "
                             "(built from --data on first use)")
    parser.add_argument("--prefetch", default=2, type=int)
    parser.add_argument("--loader-workers", default=None, type=int,
                        help="decode threads for --data (default: cores)")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def _global_rows(batch, size, steps, seed, rank, world):
    """This rank's rows of the global synthetic batches."""
    n = batch // world
    for x, y in synthetic_source(batch, size, steps, seed=seed):
        yield x[rank * n:(rank + 1) * n], y[rank * n:(rank + 1) * n]


def run(argv=None, variables=None, emit=print):
    """Train as the reference example does; every ``--print-freq`` steps
    emit its line. ``variables`` = ``(params, batch_stats)`` by port name
    (``convert.resnet_variables_from_jax``) replaces the seeded init.
    Returns a dict: the printed ``losses`` and ``accs``, the ``loader``
    probe's img/s (None without ``--data``), ``step_times`` (seconds
    between prints, over ``--print-freq`` steps each), the final
    ``state`` and ``batch_stats`` and the amp ``state_dict``."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch.cuda is not available: pass --device cpu "
                           "to run the plain versions on the CPU")
    if args.deterministic:
        # the cudnn.deterministic switch of the reference; the JAX example
        # asks for "highest" matmul precision, here: no TF32 anywhere
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    launch.distributed_init(device=args.device)
    world, rank = launch.process_count(), launch.process_index()
    mesh = ddp = None
    if torch.distributed.is_initialized():
        mesh = parallel.data_parallel_mesh(args.device)
        ddp = parallel.DistributedDataParallel(mesh)
    if args.batch_size % world:
        raise SystemExit(f"global batch {args.batch_size} must divide "
                         f"over {world} ranks")
    local = args.batch_size // world

    overrides = {}
    if args.keep_batchnorm_fp32 is not None:
        overrides["keep_batchnorm_fp32"] = \
            args.keep_batchnorm_fp32.lower() == "true"
    if args.loss_scale is not None:
        overrides["loss_scale"] = (
            "dynamic" if args.loss_scale == "dynamic"
            else float(args.loss_scale))
    policy = amp.Policy.from_opt_level(args.opt_level, **overrides)

    axis = parallel.DATA_AXIS if args.sync_bn else None
    model = ARCHS[args.arch](num_classes=1000, dtype=policy.compute_dtype,
                             bn_axis_name=axis, device=device, seed=0)
    if variables is not None:
        params, stats = variables
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(params[name])
            for name, b in model.named_buffers():
                b.copy_(stats[name])
    tx = FusedSGD(lr=args.lr, momentum=args.momentum,
                  weight_decay=args.weight_decay)
    step, (state, batch_stats), _, _, _ = train.build_resnet_step(
        local, args.image_size, model=model, optimizer=tx, policy=policy,
        device=device, bn_axis_name=axis, ddp=ddp, with_accuracy=True)

    folder = None
    if args.data and args.cache:
        if rank == 0:
            build_cache(args.data, args.cache)
        if world > 1:
            torch.distributed.barrier()
        # raw uint8 out: normalised on the card in the loop
        folder = PackedSource(args.cache, local, args.image_size,
                              dtype=np.uint8, workers=args.loader_workers)
    elif args.data:
        folder = ImageFolderSource(args.data, local, args.image_size,
                                   workers=args.loader_workers)
    probe = None
    if folder is not None:
        # loader-only probe on its OWN source (probing the training source
        # would advance its epoch and shuffle state)
        if args.cache:
            probe_ctx = PackedSource(args.cache, local, args.image_size,
                                     dtype=np.uint8,
                                     workers=args.loader_workers)
        else:
            probe_ctx = ImageFolderSource(args.data, local, args.image_size,
                                          workers=args.loader_workers)
        with probe_ctx as probe_src:
            probe = measure_source(
                probe_src.batches(min(6, args.steps_per_epoch) + 1),
                steps=min(5, args.steps_per_epoch))
        emit(f"loader: {probe:.0f} img/s with {folder.workers} "
             f"{'cache-read' if args.cache else 'decode'} threads "
             f"(training is input-bound below this rate)")

    losses, accs, step_times = [], [], []
    uint8_src = folder is not None and args.cache is not None
    cast = (policy.compute_dtype
            if policy.cast_model_type is not None and not uint8_src
            else None)
    for epoch in range(args.epochs):
        src = (folder.batches(args.steps_per_epoch)
               if folder is not None else
               _global_rows(args.batch_size, args.image_size,
                            args.steps_per_epoch, epoch, rank, world))
        pre = DevicePrefetcher(src, device=device, cast_dtype=cast,
                               depth=args.prefetch)
        t0 = last = time.perf_counter()
        seen = 0
        prof = None
        for i, (xb, yb) in enumerate(pre):
            if i == 0 and 0 < args.prof:
                prof = torch.profiler.profile()
                prof.__enter__()
            if xb.dtype == torch.uint8:
                xb = normalize_uint8(xb, policy.compute_dtype
                                     or torch.float32)
            state, batch_stats, loss, acc = step(state, batch_stats, xb,
                                                 yb.long())
            seen += args.batch_size
            if prof is not None and i + 1 == args.prof:
                float(loss)
                prof.__exit__(None, None, None)
                os.makedirs("prof_trace", exist_ok=True)
                prof.export_chrome_trace(os.path.join("prof_trace",
                                                      "trace.json"))
                prof = None
            if (i + 1) % args.print_freq == 0:
                lv, av = loss.detach().float(), acc.detach().float()
                if world > 1:
                    both = torch.stack([lv, av])
                    torch.distributed.all_reduce(both)
                    lv, av = both / world
                lv, av = float(lv), float(av)   # syncs the pipeline
                now = time.perf_counter()
                step_times.append(now - last)
                last = now
                dt = now - t0
                losses.append(lv)
                accs.append(av)
                emit(f"epoch {epoch} step {i+1}: loss {lv:.4f} "
                     f"acc {av:.3f}  {seen/dt:.1f} img/s "
                     f"({seen/dt/world:.1f}/chip)")
        if prof is not None:
            prof.__exit__(None, None, None)
    sd = step.amp_opt.state_dict(state)
    emit(f"done. amp state_dict: {sd}")
    if folder is not None:
        folder.close()
    return {"losses": losses, "accs": accs, "loader": probe,
            "step_times": step_times, "state": state,
            "batch_stats": batch_stats, "state_dict": sd}


if __name__ == "__main__":
    run()
