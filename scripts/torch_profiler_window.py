"""Which records does ``torch.profiler`` keep from a short session, as a
process grows older and has opened more sessions?

Each session waits on the host for one of ``--waits`` (milliseconds,
taken in turns), launches an optional spin kernel (``torch.cuda._sleep``),
then ``--marks`` small kernels with a short spin between each two (the
first half adds, the second negates, so a lost prefix shows), waits
for the card, and last launches one probe kernel on an idle card and
waits again. A session reports how many marks it kept, whether it kept
the probe, and the probe's start less its ``cudaLaunchKernel`` call's
start (a few microseconds when the card's clock and the host's agree in
the trace).

The script runs ``--burst`` sessions back to back, then holds the card
busy for ``--idle`` seconds without the profiler (the process ages, the
session count does not grow), then runs another burst, and so on for
``--rounds`` rounds. One JSON line a session goes to standard output.

    python3 scripts/torch_profiler_window.py [--rounds 3] [--idle 40]
        [--waits 0,20]
"""
import argparse
import json
import sys
import time


def session(torch, x, marks, pad_cycles, gap_cycles, wait_ms):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(wait_ms / 1e3)
        if pad_cycles:
            torch.cuda._sleep(pad_cycles)
        for i in range(marks):
            if i < marks // 2:
                x.add_(1.0)
            else:
                x.neg_()
            torch.cuda._sleep(gap_cycles)
        torch.cuda.synchronize()
        x.mul_(1.0)
        torch.cuda.synchronize()
    evs = prof.events()
    cuda = [e for e in evs if e.device_type == torch.autograd.DeviceType.CUDA]
    adds = [e for e in cuda if "Add" in e.name or "add" in e.name]
    negs = [e for e in cuda if "neg" in e.name.lower()]
    probe = [e for e in cuda if "Mul" in e.name or "mul" in e.name]
    launches = [e for e in evs
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC")]
    offset = None
    if probe and launches:
        offset = probe[0].time_range.start - launches[-1].time_range.start
    first = min((e.time_range.start for e in cuda), default=None)
    return {"marks_kept": len(adds) + len(negs), "first_half_kept": len(adds),
            "launch_records": len(launches), "probe_kept": bool(probe),
            "probe_minus_launch_us": offset, "first_kernel_us": first}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--burst", type=int, default=15)
    ap.add_argument("--idle", type=float, default=40.0)
    ap.add_argument("--marks", type=int, default=20)
    ap.add_argument("--pad-cycles", type=int, default=0)
    ap.add_argument("--gap-cycles", type=int, default=200_000)
    ap.add_argument("--waits", default="0",
                    help="comma-separated host waits (ms), taken in turns")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    x = torch.zeros(1 << 20, device="cuda")
    a = torch.randn(4096, 4096, device="cuda")
    waits = [float(w) for w in args.waits.split(",")]
    n = 0
    for r in range(args.rounds):
        for _ in range(args.burst):
            wait = waits[n % len(waits)]
            rec = session(torch, x, args.marks, args.pad_cycles,
                          args.gap_cycles, wait)
            n += 1
            rec.update(round=r, session=n, marks=args.marks, wait_ms=wait,
                       process_s=time.perf_counter() - t0)
            print(json.dumps(rec), flush=True)
        end = time.perf_counter() + args.idle
        while time.perf_counter() < end:
            for _ in range(20):
                a = torch.tanh(a @ a * 1e-3)
            torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
