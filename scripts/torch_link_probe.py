#!/usr/bin/env python3
"""torch_link_probe — measure the links' α–β budgets and write a MeshModel
JSON.

The port of ``scripts/link_probe.py``. Sweeps all-reduce, reduce-scatter
and all-gather across message sizes over the ``data`` axis of a process
group (:func:`apex_tpu_torch.monitor.linkbench.calibrate`), fits latency
and inverse bandwidth, and writes an
:class:`apex_tpu_torch.lint.mesh_model.MeshModel` JSON whose
``link_bytes_per_s`` is measured, with the fit in its ``calibration``
block and the run in ``probe`` (backend, world, device). Both packages'
``MeshModel.from_json`` read it, and ``apex_tpu_torch.parallel.plan_comm``
plans with it.

Usage:
  python3 scripts/torch_link_probe.py [--out FILE] [--jsonl FILE]
      # on the card: NCCL over every visible card when there are two or
      # more; with one card, two gloo processes on it (their rates are
      # gloo through this host's memory, not NVLink: the pipeline's proof)
  python3 scripts/torch_link_probe.py --cpu N [--out FILE]
      # N gloo processes on the CPU
Options:
  --out FILE     MeshModel JSON path (default MESH_MEASURED.json)
  --jsonl FILE   also write kind="linkfit" events (goodput channel;
                 validate with scripts/check_metrics_schema.py --kind goodput)
  --sizes a,b,c  message-size ladder in bytes
  --iters N      best-of iterations per point (default 3)
"""

import argparse
import datetime
import json
import multiprocessing
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _rank(rank, world, backend, device, tmp, sizes, iters):
    """One rank: join the group, calibrate, and (rank 0) save the model."""
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import parallel
    from apex_tpu_torch.lint.mesh_model import parse_mesh_spec
    from apex_tpu_torch.monitor import linkbench

    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(
        backend, init_method=f"file://{tmp}/store", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = parallel.data_parallel_mesh(device.split(":")[0])
        # the template's rate is a placeholder: calibrate replaces it
        template = parse_mesh_spec(f"ici{world}",
                                   link_bytes_per_s={"ici": 1e9})
        kw = {"iters": iters}
        if sizes:
            kw["sizes"] = sizes
        model, fits, samples = linkbench.calibrate(mesh, template, **kw)
        if rank == 0:
            out = model.to_json()
            out["probe"] = {"backend": backend, "world": world,
                            "device": (torch.cuda.get_device_name(device)
                                       if device.startswith("cuda")
                                       else "cpu"),
                            "sizes": list(sizes or linkbench.DEFAULT_SIZES),
                            "iters": iters}
            with open(os.path.join(tmp, "model.json"), "w") as f:
                json.dump(out, f)
            with open(os.path.join(tmp, "table.txt"), "w") as f:
                f.write(linkbench.fit_table(fits, samples))
    finally:
        dist.destroy_process_group()


def probe(world: int, backend: str, devices, sizes=None, iters: int = 3,
          timeout_s: float = 600.0) -> dict:
    """Run ``world`` spawned ranks (rank r on ``devices[r]``) and return
    rank 0's MeshModel JSON (with its ``probe`` block) and fit table."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="torch_link_probe_")
    try:
        procs = [ctx.Process(target=_rank, args=(r, world, backend,
                                                 devices[r], tmp, sizes,
                                                 iters))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout_s)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise RuntimeError(f"link probe ranks exited {codes}")
        with open(os.path.join(tmp, "model.json")) as f:
            out = json.load(f)
        with open(os.path.join(tmp, "table.txt")) as f:
            out["probe"]["table"] = f.read()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Measure link budgets into a MeshModel JSON.")
    ap.add_argument("--cpu", type=int, metavar="N",
                    help="N gloo processes on the CPU")
    ap.add_argument("--out", default="MESH_MEASURED.json")
    ap.add_argument("--jsonl")
    ap.add_argument("--sizes", type=lambda s: tuple(
        int(v) for v in s.split(",")))
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)

    if args.cpu is not None:
        if args.cpu < 2:
            ap.error("--cpu needs N >= 2 ranks")
        world, backend, devices = args.cpu, "gloo", ["cpu"] * args.cpu
    else:
        import torch
        if not torch.cuda.is_available():
            print("torch_link_probe: no CUDA device (pass --cpu N for the "
                  "CPU)", file=sys.stderr)
            return 2
        n = torch.cuda.device_count()
        if n >= 2:
            world, backend = n, "nccl"
            devices = [f"cuda:{i}" for i in range(n)]
        else:
            world, backend, devices = 2, "gloo", ["cuda:0", "cuda:0"]
    out = probe(world, backend, devices, args.sizes, args.iters)
    table = out["probe"].pop("table")
    print(f"torch_link_probe: {world} ranks over {backend} on "
          f"{out['probe']['device']}")
    print(table)
    for link, bps in sorted(out["link_bytes_per_s"].items()):
        print(f"  link {link}: {bps / 1e9:.4f} GB/s (measured)")
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"wrote {args.out}")

    from apex_tpu_torch.lint.mesh_model import MeshModel
    model = MeshModel.from_json(out)
    if not model.measured or not all(
            model.link_bytes_per_s[k] > 0 for k in model.calibration):
        print("torch_link_probe: the written model is not measured",
              file=sys.stderr)
        return 1
    if args.jsonl:
        from apex_tpu_torch import monitor
        from apex_tpu_torch.monitor import linkbench
        logger = monitor.MetricsLogger(
            sinks=[], goodput_sink=monitor.JSONLSink(args.jsonl))
        for ev in linkbench.linkfit_events(model, rank=0):
            logger.record_goodput(ev)
        logger.close()
        print(f"wrote {args.jsonl}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
