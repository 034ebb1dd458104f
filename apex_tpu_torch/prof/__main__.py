"""CLI: a ``torch.profiler`` trace's per-kernel device-time table.

Usage::

    python -m apex_tpu_torch.prof /tmp/trace            # top-30 kernels
    python -m apex_tpu_torch.prof /tmp/trace --top 100
    python -m apex_tpu_torch.prof /tmp/trace --csv      # machine-readable

The directory (or file) holds a Chrome trace (``*.pt.trace.json``), as
``profile_step(..., keep_trace=True)`` or ``export_chrome_trace`` write
it. A trace with ``profile_step``'s window range counts the kernels
launched inside it; the spins that open its session fall outside.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.prof",
        description="Per-kernel device-time analysis of a torch.profiler "
                    "trace")
    p.add_argument("logdir", help="trace directory or *.json file")
    p.add_argument("--top", type=int, default=30,
                   help="rows in the kernel table (default 30)")
    p.add_argument("--csv", action="store_true",
                   help="emit name,category,occurrences,total_us rows")
    args = p.parse_args(argv)

    from apex_tpu_torch.prof.report import WINDOW
    from apex_tpu_torch.prof.xplane import parse_trace

    try:
        tp = parse_trace(args.logdir, window=WINDOW)
    except FileNotFoundError as e:
        print(f"no trace: {e}", file=sys.stderr)
        return 1
    if not tp.ops:
        print("no device kernels in the trace (a CPU run)", file=sys.stderr)
        return 1
    if args.csv:
        print("name,category,occurrences,total_us")
        for r in tp.ops:
            print(f"\"{r.name}\",{r.category},{r.occurrences},"
                  f"{r.total_us:.1f}")
    else:
        print(tp.table(top=args.top))
        print()
        for cat, us in tp.by_category().items():
            print(f"{cat:<16} {us:12.0f}us")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
