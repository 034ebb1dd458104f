#!/usr/bin/env python3
"""ResNet-50 under the port's tracing and telemetry stack: the
counterpart of ``bench.py --trace`` and ``--monitor``.

    python3 scripts/torch_trace_resnet.py --out chiprun_out/trace
    python3 scripts/torch_trace_resnet.py --device cpu --batch 2 \\
        --size 64 --arch resnet18 --steps 3 --out /tmp/trace

Trains ResNet-50 (B256, 224², amp O2 bf16, ``FusedSGD`` with
``--strategy arena``, the default, or ``tree``) a few steps under
``parallel.enable_crash_dumps`` (a ``trace.Tracer`` and a
``trace.FlightRecorder``), ``Amp(monitor=True)``, a
``monitor.MetricsLogger`` (JSONL metrics sink, trace-event channel,
goodput channel) and a ``monitor.GoodputLedger``. Each step is
``trace.step(i)`` with a ``dispatch`` span (the step and the loss
read-back, so ``compute`` holds dispatch and device wait) and a
``fetch`` span (``logger.record`` and ``recorder.record_metrics``).

Writes to ``--out``: ``TRACE.json`` (Chrome trace; loads in Perfetto),
``events.jsonl`` (step and span events: ``scripts/check_metrics_schema.py
--kind trace``), ``goodput.jsonl`` (``--kind goodput``) and
``metrics.jsonl`` (``--kind metrics``), and prints the ``StepTimeline``
and goodput tables and one JSON summary line. Runs on the card; without
one it raises unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..")))

from apex_tpu_torch import models, monitor, parallel, trace, train  # noqa


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--arch", default="resnet50",
                   choices=("resnet18", "resnet50"))
    p.add_argument("--strategy", default="arena", choices=("arena", "tree"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="chiprun_out/trace_resnet")
    return p.parse_args(argv)


def build(args):
    """``(step, state, batch_stats, x, y, model)`` of the traced ResNet
    step (``monitor=True``)."""
    arch = {"resnet18": models.ResNet18, "resnet50": models.ResNet50}[
        args.arch]
    import torch
    model = arch(num_classes=1000, dtype=torch.bfloat16,
                 device=train._device(args.device, "torch_trace_resnet"))
    step, (state, bstats), (x, y), _, _ = train.build_resnet_step(
        args.batch, args.size, model=model, strategy=args.strategy,
        device=args.device, monitor=True)
    return step, state, bstats, x, y, model


def wire(out_dir: str, flush_every: int):
    """The stack: ``(tracer, recorder, logger, ledger)``, every stream
    under ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    tracer, recorder, _, _ = parallel.enable_crash_dumps(
        os.path.join(out_dir, "crash.jsonl"))
    logger = monitor.MetricsLogger(
        sinks=[monitor.JSONLSink(os.path.join(out_dir, "metrics.jsonl"))],
        flush_every=flush_every,
        trace_sink=monitor.JSONLSink(os.path.join(out_dir, "events.jsonl")),
        goodput_sink=monitor.JSONLSink(os.path.join(out_dir,
                                                    "goodput.jsonl")))
    rank = parallel.process_index()
    tracer.subscribe(lambda st: logger.record_event(st.to_event(rank)))
    ledger = monitor.GoodputLedger(tracer, rank=rank)
    ledger.subscribe(logger.record_goodput)
    return tracer, recorder, logger, ledger


def traced_step(i, step, state, bstats, x, y, logger, recorder, *,
                read_loss=True, images=None):
    """One traced step (inside ``with tracer:``): ``dispatch`` holds the
    step and, with ``read_loss``, the loss read-back; ``fetch`` hands the
    Metrics tuple to the logger and the recorder. Returns ``(state,
    batch_stats, loss, loss_value-or-None)``."""
    value = None
    with trace.step(i):
        with trace.span("dispatch"):
            state, bstats, loss = step(state, bstats, x, y)
            if read_loss:
                value = loss.item()
        with trace.span("fetch"):
            logger.record(state.metrics, **(
                {"images_per_step": images} if images else {}))
            recorder.record_metrics(state.metrics)
    return state, bstats, loss, value


def loop(steps, step, state, bstats, x, y, tracer, logger, recorder,
         start=0):
    """``steps`` traced steps; returns ``(state, batch_stats, losses)``."""
    losses = []
    with tracer:
        for i in range(start, start + steps):
            state, bstats, _, v = traced_step(
                i, step, state, bstats, x, y, logger, recorder,
                images=x.shape[0])
            losses.append(v)
    return state, bstats, losses


def check_chrome_trace(ct) -> None:
    """The Perfetto-loadability contract: a ``traceEvents`` list of
    complete-duration events with name/ts/dur/pid/tid, and the rank's
    metadata events."""
    evs = ct["traceEvents"]
    if not any(e["ph"] == "M" and e["name"] == "process_name" for e in evs):
        raise AssertionError("Chrome trace without process_name metadata")
    for e in evs:
        if e["ph"] != "X":
            continue
        if not (isinstance(e["name"], str) and e["name"]):
            raise AssertionError(f"unnamed trace event {e}")
        for k in ("ts", "dur"):
            if not (isinstance(e[k], (int, float)) and e[k] >= 0):
                raise AssertionError(f"bad {k} in {e}")
        for k in ("pid", "tid"):
            if not isinstance(e[k], int):
                raise AssertionError(f"bad {k} in {e}")


def main(argv=None) -> int:
    args = parse_args(argv)
    step, state, bstats, x, y, _ = build(args)
    tracer, recorder, logger, ledger = wire(args.out, args.steps)
    try:
        state, bstats, losses = loop(args.steps, step, state, bstats, x, y,
                                     tracer, logger, recorder)
    finally:
        logger.close()
        recorder.uninstall()
    ct = tracer.chrome_trace()
    check_chrome_trace(ct)
    with open(os.path.join(args.out, "TRACE.json"), "w") as f:
        json.dump(ct, f)
    print(tracer.timeline().table())
    print(ledger.table())
    ok, worst = ledger.check_closure()
    steady = ledger.steps[1:] or ledger.steps
    fracs = [r.goodput_frac for r in steady if r.goodput_frac is not None]
    print(json.dumps({
        "losses": losses, "closure_ok": ok, "worst_closure_err": worst,
        "goodput_frac": sum(fracs) / len(fracs) if fracs else None,
        "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
