"""How far the pod view's skew of a late rank strays from the delay put in.

Runs the two gloo ranks of ``chip_smoke.py``'s
``straggler_podview_two_ranks`` on one card (a small ResNet under
``DistributedDataParallel(delay_allreduce=True)``, rank 1 spending
``STRAGGLER_DELAY_S`` in ``data/load`` before the gradient sync on steps
``STRAGGLER_SLOW``) ``--runs`` times for each ``--align`` mode, the modes
in turns:

- ``none``: no barrier; the ranks meet only in the gradient sync;
- ``step``: a barrier at the start of every traced step;
- ``load``: a barrier just before the load (``chip_smoke._LateLoad``'s
  default, what the phase runs).

For each run: the ``ddp/sync_gradients`` skews and their blame from
``PodTimeline.merge``, each rank's host time from the step's
``dispatch`` span to its sync's entry, step by step, the garbage
collector's pauses inside the traced steps, and (mode ``step``) how far
apart the ranks leave the barrier on the shared monotonic clock. The
summary gives, per mode, the worst and mean |skew − delay| over the slow
steps and the largest skew of steps 1–3.

Run on the card::

    python3 scripts/torch_straggler_skew.py [--runs 5]
        [--align none step load] [--out straggler_skew.json]
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def skew_rank(rank, world, hb_dir, align):
    """``chip_smoke.straggler_rank`` with the barrier where ``align``
    says, and the collector's pauses and the barrier's exits kept."""
    import torch
    from apex_tpu_torch import models, parallel, trace, train

    mesh = parallel.data_parallel_mesh()
    model = models.ResNet(stage_sizes=[1, 1], num_classes=1000,
                          dtype=torch.bfloat16, device="cuda", seed=0)
    late = cs._LateLoad(parallel.DistributedDataParallel(
        mesh, delay_allreduce=True), align=align == "load")
    step, (state, bs), (x, y), _, _ = train.build_resnet_step(
        cs.STRAGGLER_BATCH, cs.STRAGGLER_SIZE, model=model,
        strategy="arena", ddp=late)
    for _ in range(cs.STRAGGLER_WARMUP):
        state, bs, loss = step(state, bs, x, y)
        loss.item()
    tracer = trace.Tracer()
    hb = trace.HeartbeatWriter(hb_dir, rank=rank)
    tracer.subscribe(hb.on_step)
    out = {"gc_ms": [], "barrier_exit": []}
    t_gc = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            t_gc[0] = time.perf_counter()
        else:
            out["gc_ms"].append((time.perf_counter() - t_gc[0]) * 1e3)

    if rank == 0:
        wd = trace.HangWatchdog(600.0, tracer=tracer)
        watch = trace.StragglerWatch(trace.StragglerDetector(hb_dir),
                                     watchdog=wd, renotify_s=0.0)
        wd.start()
    gc.callbacks.append(on_gc)
    with tracer:
        for i in range(cs.STRAGGLER_STEPS):
            late.slow = rank == 1 and i in cs.STRAGGLER_SLOW
            if align == "step":
                torch.distributed.barrier()
                out["barrier_exit"].append(time.perf_counter())
            with trace.step(i):
                with trace.span("dispatch"):
                    state, bs, loss = step(state, bs, x, y)
                    loss.item()
            if rank == 0:
                watch.poll_once()
    gc.callbacks.remove(on_gc)
    torch.distributed.barrier()
    if rank == 0:
        wd.stop()
    out["spans"] = tracer.span_events(rank)
    return out


def _body(align):
    def body(rank, world, tmp):
        cs._run_rank(lambda r, w: skew_rank(r, w, f"{tmp}/hb", align),
                     rank, world, tmp)
    return body


def body_none(rank, world, tmp):
    _body("none")(rank, world, tmp)


def body_step(rank, world, tmp):
    _body("step")(rank, world, tmp)


def body_load(rank, world, tmp):
    _body("load")(rank, world, tmp)


BODIES = {"none": body_none, "step": body_step, "load": body_load}


def one_run(align):
    """One spawn of the two ranks in mode ``align``: skews and timings."""
    from apex_tpu_torch import trace
    ranks = cs._spawn(f"straggler_skew_{align}", BODIES[align], 2)
    pod = trace.PodTimeline.merge({r: o["spans"] for r, o in enumerate(ranks)})
    skews = [c for c in pod.collective_skew()
             if c.name == "ddp/sync_gradients"]
    to_sync = []
    for o in ranks:
        at = {}
        for e in o["spans"]:
            at.setdefault((e["step"], e["name"]), e["t_ms"])
        to_sync.append([at[(s, "ddp/sync_gradients")] - at[(s, "dispatch")]
                        for s in range(cs.STRAGGLER_STEPS)])
    exits = [o["barrier_exit"] for o in ranks]
    return {"skews": [{"step": c.step, "skew_ms": c.skew_ms,
                       "rank": c.blamed_rank, "span": c.blamed_span}
                      for c in skews],
            "dispatch_to_sync_ms": to_sync,
            "gc_ms": [o["gc_ms"] for o in ranks],
            "barrier_exit_gap_ms": [(b - a) * 1e3
                                    for a, b in zip(*exits)]}


def summary(runs):
    want = cs.STRAGGLER_DELAY_S * 1e3
    slow = [abs(k["skew_ms"] - want) for r in runs for k in r["skews"]
            if k["step"] in cs.STRAGGLER_SLOW]
    fast = [k["skew_ms"] for r in runs for k in r["skews"]
            if 0 < k["step"] < min(cs.STRAGGLER_SLOW)]
    blame = all(k["rank"] == 1 and k["span"] == "data/load"
                for r in runs for k in r["skews"]
                if k["step"] in cs.STRAGGLER_SLOW)
    d2s = [v for r in runs for rank in r["dispatch_to_sync_ms"]
           for s, v in enumerate(rank) if s not in cs.STRAGGLER_SLOW]
    gaps = [abs(v) for r in runs for v in r["barrier_exit_gap_ms"]]
    return {"slow_steps": len(slow), "worst_off_ms": max(slow),
            "mean_off_ms": sum(slow) / len(slow), "worst_fast_ms": max(fast),
            "blame_all_load": blame,
            "dispatch_to_sync_ms_unslowed": [min(d2s), max(d2s)],
            "gc_pauses_in_steps": sum(len(g) for r in runs
                                      for g in r["gc_ms"]),
            "worst_barrier_exit_gap_ms": max(gaps) if gaps else None}


def _smi():
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--align", nargs="+", default=["none", "step", "load"],
                    choices=sorted(BODIES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_straggler_skew: needs a CUDA card", file=sys.stderr)
        return 2
    from apex_tpu_torch.ops import _build
    _build.build_all()
    print(_smi(), flush=True)
    runs = {a: [] for a in args.align}
    for i in range(args.runs):
        order = args.align if i % 2 == 0 else args.align[::-1]
        for a in order:
            r = one_run(a)
            runs[a].append(r)
            print(f"{a} run {i}: slow-step skews "
                  f"{[round(k['skew_ms'], 3) for k in r['skews'] if k['step'] in cs.STRAGGLER_SLOW]}"
                  f" ms", flush=True)
    result = {a: {"summary": summary(rs), "runs": rs}
              for a, rs in runs.items()}
    for a in runs:
        print(a, json.dumps(result[a]["summary"]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
