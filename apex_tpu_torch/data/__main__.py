"""``python -m apex_tpu_torch.data`` — loader-only throughput probe.

    python -m apex_tpu_torch.data --bench DIR -b 128 --size 224 --workers 8
    python -m apex_tpu_torch.data --bench DIR --cache CACHEDIR    # packed path
    python -m apex_tpu_torch.data --build-cache DIR --cache CACHEDIR
    python -m apex_tpu_torch.data --make-fake /tmp/fakeimagenet

Prints images/sec of decode+augment+batch assembly alone; compare with
the model's synthetic-data img/s to tell input-bound from compute-bound.
With ``--cache`` the bench reads the packed pre-decoded shards (built
on first use) — the DALI-class path. The port of
``apex_tpu/data/__main__.py``; decoding runs through the port's codec.
"""

import argparse

from apex_tpu_torch.data import (ImageFolderSource, PackedSource, build_cache,
                           make_fake_imagefolder, measure_source)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--bench", metavar="DIR")
    p.add_argument("--build-cache", metavar="DIR")
    p.add_argument("--cache", metavar="CACHEDIR")
    p.add_argument("--make-fake", metavar="DIR")
    p.add_argument("-b", "--batch", type=int, default=128)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--store-size", type=int, default=256)
    p.add_argument("--rrc", action="store_true",
                   help="true RandomResizedCrop from the cache")
    p.add_argument("--workers", type=int, default=None)
    p.add_argument("--steps", type=int, default=20)
    args = p.parse_args()
    if args.make_fake:
        make_fake_imagefolder(args.make_fake)
        print(f"wrote fake ImageFolder tree at {args.make_fake}")
    if args.build_cache:
        if not args.cache:
            p.error("--build-cache requires --cache CACHEDIR")
        build_cache(args.build_cache, args.cache,
                    store_size=args.store_size, workers=args.workers)
        print(f"packed cache ready at {args.cache}")
    if args.bench:
        if args.cache:
            build_cache(args.bench, args.cache,
                        store_size=args.store_size, workers=args.workers)
            src = PackedSource(args.cache, args.batch, args.size,
                               rrc=args.rrc, workers=args.workers)
            kind = f"packed cache ({'rrc' if args.rrc else 'crop+flip'})"
        else:
            src = ImageFolderSource(args.bench, args.batch, args.size,
                                    workers=args.workers)
            kind = "live decode"
        with src:
            rate = measure_source(src.batches(args.steps + 1),
                                  steps=args.steps)
        print(f"loader: {rate:.1f} img/s (batch {args.batch}, "
              f"size {args.size}, workers {src.workers}, {kind})")


if __name__ == "__main__":
    main()
