"""Pluggable host-side metric sinks: stdout table / JSONL / CSV.

The port's copy of ``apex_tpu/monitor/sinks.py`` (pure Python; the
port keeps its own). A sink consumes fully materialized host records
(plain dicts of Python numbers, already fetched from the device by the
logger's flush) — sinks never touch tensors, so adding one can never
add a device sync.

The JSONL wire format is the contract validated by
``scripts/check_metrics_schema.py``; keep the two in lockstep.
"""

from __future__ import annotations

import csv
import io
import json
import os
import sys
from typing import Dict, List, Optional, TextIO

from apex_tpu_torch.utils.format import fmt_bytes

__all__ = ["Sink", "StdoutSink", "JSONLSink", "CSVSink"]


def _fmt_bytes(n) -> str:
    """``47.7M``: a byte count at column width."""
    return fmt_bytes(n, compact=True)


class Sink:
    """Interface: ``emit`` one record dict per step, ``close`` at teardown."""

    def emit(self, record: Dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _fmt(v, width=9):
    if v is None:
        return "n/a".rjust(width)
    if isinstance(v, float):
        if v == 0 or 1e-3 <= abs(v) < 1e5:
            return f"{v:.4g}".rjust(width)
        return f"{v:.2e}".rjust(width)
    return str(v).rjust(width)


class StdoutSink(Sink):
    """Aligned table line per step, header re-printed every
    ``header_every``.

    The ``wire`` column is the per-dtype collective wire breakdown
    (``MetricsLogger.collective_bytes_by_dtype``) and ``w/l`` the
    wire-to-logical ratio; both print ``n/a`` until a caller sets them
    (``MetricsLogger.attach`` reads them off one run of the step)."""

    _COLS = ("step", "loss", "loss_scale", "grad_norm", "skip_count",
             "step_time_ms", "throughput_steps_per_s", "mfu",
             "wire_by_dtype", "wire_to_logical")
    _HEADS = ("step", "loss", "scale", "gnorm", "skip", "ms/step",
              "steps/s", "mfu", "wire", "w/l")
    _WIDTHS = {"wire_by_dtype": 22}

    def __init__(self, stream: Optional[TextIO] = None,
                 header_every: int = 20):
        self.stream = stream or sys.stdout
        self.header_every = header_every
        self._n = 0

    def emit(self, record: Dict) -> None:
        if self._n % self.header_every == 0:
            self.stream.write(" ".join(
                h.rjust(self._WIDTHS.get(c, 9))
                for c, h in zip(self._COLS, self._HEADS)) + "\n")
        vals = []
        for c in self._COLS:
            v = record.get(c)
            width = self._WIDTHS.get(c, 9)
            if c == "mfu" and isinstance(v, float):
                vals.append(f"{v:.1%}".rjust(width))
                continue
            if c == "wire_by_dtype":
                if isinstance(v, dict) and v:
                    txt = "+".join(
                        f"{dt}:{_fmt_bytes(nb)}"
                        for dt, nb in sorted(v.items(),
                                             key=lambda kv: -kv[1]))
                elif isinstance(v, dict):
                    txt = "0"
                else:
                    txt = "n/a"
                if len(txt) > width:      # keep the dominant dtype
                    txt = txt[:width - 1] + "~"
                vals.append(txt.rjust(width))
                continue
            if c == "wire_to_logical" and isinstance(v, float):
                vals.append(f"{v:.2f}".rjust(width))
                continue
            vals.append(_fmt(v, width))
        self.stream.write(" ".join(vals) + "\n")
        self.stream.flush()
        self._n += 1


class JSONLSink(Sink):
    """One JSON object per line — the machine-readable stream
    (``scripts/check_metrics_schema.py`` validates it).

    Doubles as the **trace-event channel** sink: pass one as
    ``MetricsLogger(trace_sink=...)`` and span/step timeline events from
    :mod:`apex_tpu_torch.trace` stream to it (validate with
    ``check_metrics_schema.py --kind trace``).
    """

    def __init__(self, path_or_stream):
        if isinstance(path_or_stream, (str, os.PathLike)):
            self.stream: TextIO = open(path_or_stream, "w")
            self._owns = True
        else:
            self.stream = path_or_stream
            self._owns = False

    def emit(self, record: Dict) -> None:
        self.stream.write(json.dumps(record) + "\n")
        self.stream.flush()

    def close(self) -> None:
        if self._owns:
            self.stream.close()


class CSVSink(Sink):
    """CSV with a header derived from the first record's keys; later
    records are projected onto those columns (missing → empty)."""

    def __init__(self, path_or_stream):
        if isinstance(path_or_stream, (str, os.PathLike)):
            self.stream: TextIO = open(path_or_stream, "w", newline="")
            self._owns = True
        else:
            self.stream = path_or_stream
            self._owns = False
        self._writer: Optional[csv.DictWriter] = None
        self._fields: List[str] = []

    def emit(self, record: Dict) -> None:
        if self._writer is None:
            self._fields = list(record.keys())
            self._writer = csv.DictWriter(self.stream, self._fields,
                                          extrasaction="ignore")
            self._writer.writeheader()
        self._writer.writerow({k: record.get(k, "") for k in self._fields})
        self.stream.flush()

    def close(self) -> None:
        if self._owns:
            self.stream.close()
