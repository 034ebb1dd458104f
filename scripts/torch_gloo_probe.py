#!/usr/bin/env python3
"""Which ``torch.distributed`` calls a gloo group carries for tensors on a
device, by trying each one.

    python3 scripts/torch_gloo_probe.py [--device cuda] [--world 2]

For each call, in f32, bf16 and uint8, starts ``--world`` processes (the
spawn start method), each a gloo rank over a ``file://`` store in a
temporary directory, with its tensors on ``--device`` (``cuda``: every rank
on ``cuda:0``), and tries it: all_reduce, broadcast,
all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single and a
ring of ``batch_isend_irecv`` (send to the next rank, receive from the
previous), checking the result. Each call gets processes of its own,
because gloo ends the process (``std::terminate``) on some calls it cannot
carry. Prints one JSON line: ``{"device", "backend", "torch", "calls":
{call: "ok" | "wrong result" | the error's first line | "process ended
(exit codes)"}}``. ``parallel.collectives`` stages through the host the
calls this reports as failing on CUDA tensors.
"""

from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing
import os
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist

DTYPES = ("float32", "bfloat16", "uint8")


CALLS = ("all_reduce", "broadcast", "all_gather", "reduce_scatter",
         "all_to_all", "send_recv")


def _call(rank, world, dev, which, dt):
    def full(dt, n, v):
        return torch.full((n,), v, dtype=torch.float32,
                          device=dev).to(getattr(torch, dt))

    def all_reduce():
        t = full(dt, 8, rank + 1)
        dist.all_reduce(t)
        return torch.all(t.float() == world * (world + 1) / 2)

    def broadcast():
        t = full(dt, 8, rank + 1)
        dist.broadcast(t, src=0)
        return torch.all(t.float() == 1)

    def all_gather():
        t = full(dt, 4, rank + 1)
        o = torch.empty(4 * world, dtype=t.dtype, device=dev)
        dist.all_gather_into_tensor(o, t)
        want = torch.arange(1, world + 1, device=dev).repeat_interleave(4)
        return torch.all(o.float() == want)

    def reduce_scatter():
        t = full(dt, 4 * world, rank + 1)
        o = torch.empty(4, dtype=t.dtype, device=dev)
        dist.reduce_scatter_tensor(o, t)
        return torch.all(o.float() == world * (world + 1) / 2)

    def all_to_all():
        t = full(dt, 4 * world, rank + 1)
        o = torch.empty_like(t)
        dist.all_to_all_single(o, t)
        want = torch.arange(1, world + 1, device=dev).repeat_interleave(4)
        return torch.all(o.float() == want)

    def send_recv():
        t = full(dt, 8, rank + 1)
        o = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, (rank + 1) % world),
               dist.P2POp(dist.irecv, o, (rank - 1) % world)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return torch.all(o.float() == (rank - 1) % world + 1)

    fn = locals()[which]
    try:
        return "ok" if bool(fn()) else "wrong result"
    except Exception as e:  # noqa: BLE001 - the probe reports it
        return (str(e).strip().splitlines() or [repr(e)])[0][:200]


def _rank(rank, world, tmp, device, which, dt):
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(0)
            dev = torch.device("cuda:0")
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/store", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=60))
        res = _call(rank, world, dev, which, dt)
        dist.destroy_process_group()
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(res, f)
    except BaseException:
        with open(f"{tmp}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=2)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    ctx = multiprocessing.get_context("spawn")
    calls = {}
    for dt in DTYPES:
        for which in CALLS:
            tmp = tempfile.mkdtemp(prefix="gloo_probe_")
            procs = [ctx.Process(target=_rank, args=(
                r, args.world, tmp, args.device, which, dt))
                for r in range(args.world)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(60)
                if p.is_alive():
                    p.kill()
                    p.join(10)
            res = []
            for r in range(args.world):
                path, err = f"{tmp}/rank{r}.json", f"{tmp}/rank{r}.err"
                if os.path.exists(path):
                    res.append(json.load(open(path)))
                elif os.path.exists(err):
                    res.append(open(err).read().strip().splitlines()[-1])
                else:
                    res.append("process ended (exit codes "
                               f"{[p.exitcode for p in procs]})")
            shutil.rmtree(tmp, ignore_errors=True)
            calls[f"{which}/{dt}"] = (res[0] if all(x == res[0] for x in res)
                                      else res)
    print(json.dumps({"device": (torch.cuda.get_device_name(0)
                                 if args.device == "cuda" else "cpu"),
                      "backend": "gloo", "torch": torch.__version__,
                      "calls": calls}))


if __name__ == "__main__":
    main()
