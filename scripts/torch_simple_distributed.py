"""Minimal DDP + amp pattern on PyTorch — the port of
``examples/simple/distributed/distributed_data_parallel.py``.

A Linear regression trained under amp O1 with ``FusedSGD`` and
``apex_tpu_torch.parallel.DistributedDataParallel``. One process per rank:
rank r trains on its slice of the global batch and the gradients are
all-reduced. With no process group (no ``--dist-url``, no
``MASTER_ADDR``/``WORLD_SIZE``/``RANK``) it trains alone, without DDP.

Also the minimal monitor consumer: the state carries the ``Metrics``
tuple (``monitor=True``), a ``MetricsLogger`` ships it to stdout/JSONL
every ``--log-every`` steps, and ``logger.attach`` — which **runs the
step once** — reads the step's FLOPs (``prof.cost``, for the MFU column)
and its collective bytes (the collective ledger). ``--crash-dumps DIR``
installs the per-rank flight recorder and hang watchdog
(``parallel.enable_crash_dumps``) and writes the span timeline as a
Chrome trace at the end.

Run::

    python3 scripts/torch_simple_distributed.py [--steps 500] [--device cpu]
        [--metrics-jsonl metrics.jsonl] [--crash-dumps dumps/]
        [--dist-url tcp://localhost:29500 --world-size 2 --rank 0]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from apex_tpu_torch import amp, monitor, parallel, trace  # noqa: E402
from apex_tpu_torch.optim import FusedSGD  # noqa: E402
from apex_tpu_torch.parallel import launch  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", default=500, type=int)
    p.add_argument("--opt_level", default="O1", type=str)
    p.add_argument("--metrics-jsonl", default=None, type=str,
                   help="also stream metrics to this JSONL file")
    p.add_argument("--log-every", default=50, type=int,
                   help="flush cadence of the metrics logger")
    p.add_argument("--crash-dumps", default=None, type=str,
                   help="directory for per-rank flight-recorder / watchdog "
                        "dumps + a Chrome trace")
    p.add_argument("--hang-deadline", default=300.0, type=float,
                   help="watchdog deadline (s) when --crash-dumps is set")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card), or cpu")
    p.add_argument("--dist-url", default=None,
                   help="init_method of the process group (tcp://, file://)")
    p.add_argument("--world-size", default=None, type=int)
    p.add_argument("--rank", default=None, type=int)
    p.add_argument("--backend-device", default=None,
                   help="device of the process group: cuda (NCCL) or cpu "
                        "(gloo); default --device")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch.cuda is not available: pass --device cpu")
    launch.distributed_init(num_processes=args.world_size,
                            process_id=args.rank, init_method=args.dist_url,
                            device=args.backend_device or args.device)
    world, rank = launch.process_count(), launch.process_index()

    tracer, recorder = trace.Tracer(), None
    if args.crash_dumps:
        tracer, recorder, _wd, _cd = parallel.enable_crash_dumps(
            os.path.join(args.crash_dumps, "crash.jsonl"),
            hang_deadline_s=args.hang_deadline)

    mesh = ddp = None
    if torch.distributed.is_initialized():
        mesh = parallel.data_parallel_mesh(args.device)
        ddp = parallel.DistributedDataParallel(mesh)

    N, D_in, D_out = 64, 1024, 16
    if N % world:
        raise SystemExit(f"batch {N} must divide over {world} ranks")
    local = N // world
    rng = np.random.RandomState(0)
    x_all = rng.randn(N, D_in).astype(np.float32)
    y_all = rng.randn(N, D_out).astype(np.float32)
    x = torch.as_tensor(x_all[rank * local:(rank + 1) * local], device=device)
    y = torch.as_tensor(y_all[rank * local:(rank + 1) * local], device=device)
    params = {"w": torch.as_tensor(rng.randn(D_in, D_out).astype(np.float32)
                                   * 0.01, device=device),
              "b": torch.zeros(D_out, device=device)}
    amp_opt, state = amp.initialize(params, FusedSGD(lr=1e-3),
                                    opt_level=args.opt_level, monitor=True,
                                    verbosity=0)

    def step(state, xb, yb):
        def loss_fn(p):
            pred = xb @ p["w"] + p["b"]
            return torch.mean(torch.square(pred - yb))

        loss, grads, state, finite = amp_opt.backward(state, loss_fn)
        gloss = loss
        if ddp is not None:
            with parallel.use_mesh(mesh):
                grads = ddp.sync(grads)             # the DDP all-reduce
                if not isinstance(finite, bool):
                    # an fp16 scaler's commit decision must be global
                    f = torch.as_tensor(finite, dtype=torch.int32,
                                        device=device).reshape(1)
                    torch.distributed.all_reduce(
                        f, torch.distributed.ReduceOp.MIN,
                        group=mesh.get_group(ddp.axis_name))
                    finite = f[0].bool()
                gloss = ddp.pmean(loss)
        state = amp_opt.apply_gradients(state, grads, finite)
        if state.metrics is not None:
            state = state._replace(metrics=state.metrics.record_loss(gloss))
        return state, gloss

    sinks = [monitor.StdoutSink()]
    if args.metrics_jsonl:
        sinks.append(monitor.JSONLSink(args.metrics_jsonl))
    logger = monitor.MetricsLogger(sinks, flush_every=args.log_every)
    # one run of the step: its FLOPs (the MFU column) and collective bytes
    logger.attach(step, state, x, y)
    grad_bytes = sum(p.numel() * 4 for p in params.values())
    print(f"collective_bytes_per_step: {logger.collective_bytes_per_step} "
          f"(DDP gradient bytes {grad_bytes if ddp is not None else 0}, "
          f"by dtype {logger.collective_bytes_by_dtype}); "
          f"flops_per_step: {logger.flops_per_step}", flush=True)

    with tracer:
        for i in range(args.steps):
            with trace.step(i):
                with trace.span("dispatch"):
                    state, loss = step(state, x, y)
                    loss_value = loss.item()
                m = monitor.metrics_snapshot(state.metrics)
                logger.record(m)
                if recorder is not None:
                    recorder.record_metrics(m)
    logger.close()
    if args.crash_dumps:
        path = trace.rank_path(
            os.path.join(args.crash_dumps, "timeline.json"))
        tracer.write_chrome_trace(path)
        print("span timeline ->", path)
    print("final loss = ", loss_value, flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
