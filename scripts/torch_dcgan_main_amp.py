#!/usr/bin/env python3
"""The DCGAN amp example on the port: ``examples/dcgan/main_amp.py``'s
flags, loop and prints, through ``train.build_dcgan_example_step``.

    python3 scripts/torch_dcgan_main_amp.py --niter 200 --batchSize 64 \\
        --opt_level O2

A generator and a discriminator, each under its own ``amp.Amp`` bundle
(D's with ``num_losses=2``) with ``FusedAdam(lr, betas=(beta1, 0.999))``;
every step D takes two backwards (real, detached fake) and one update on
their summed gradients, then G takes one. Synthetic data from
``np.random.RandomState(manualSeed)``. Runs on the card; ``--device cpu``
runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..")))

import torch  # noqa: E402

from apex_tpu_torch import train  # noqa: E402

HALF = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batchSize", type=int, default=64)
    p.add_argument("--imageSize", type=int, default=64)
    p.add_argument("--nz", type=int, default=100)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--ndf", type=int, default=64)
    p.add_argument("--niter", type=int, default=100,
                   help="number of steps (synthetic data)")
    p.add_argument("--lr", type=float, default=0.0002)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--manualSeed", type=int, default=0)
    p.add_argument("--opt_level", default="O2")
    p.add_argument("--print-freq", type=int, default=20)
    p.add_argument("--half-dtype", default="bfloat16", choices=sorted(HALF))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def run(args, nets=None, emit=print):
    """Train ``args.niter`` steps; every ``print_freq`` steps emit the
    example's line. Returns the (Loss_D, Loss_G) floats of the emitted
    lines. ``nets`` = (G, D) replaces the seeded models."""
    step, (sd, sg, bsd, bsg), draw, _, _ = train.build_dcgan_example_step(
        args.batchSize, args.imageSize, args.nz, args.ngf, args.ndf,
        lr=args.lr, beta1=args.beta1, opt_level=args.opt_level,
        half_dtype=HALF[args.half_dtype], device=args.device,
        seed=args.manualSeed, nets=nets)
    printed = []
    t0 = time.perf_counter()
    for i in range(args.niter):
        real, z = draw()
        sd, sg, bsd, bsg, err_d, err_g = step(sd, sg, bsd, bsg, real, z)
        if (i + 1) % args.print_freq == 0:
            d, g = float(err_d), float(err_g)
            printed.append((d, g))
            emit(f"[{i+1}/{args.niter}] Loss_D {d:.4f} Loss_G {g:.4f} "
                 f"({args.batchSize*(i+1)/(time.perf_counter()-t0):.1f} "
                 "img/s)")
    return printed


if __name__ == "__main__":
    run(parse_args())
