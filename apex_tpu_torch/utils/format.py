"""Shared human-readable formatting helpers.

The port of ``apex_tpu/utils/format.py``: one byte formatter for every
table of the port (``prof.memory``, ``lint.findings``, ``monitor.sinks``),
with the same strings as the JAX package's, so a report reads the same
from either package.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["fmt_bytes"]

_UNITS = (("GiB", "G", 2 ** 30), ("MiB", "M", 2 ** 20),
          ("KiB", "K", 2 ** 10))


def fmt_bytes(n: Optional[float], *, compact: bool = False,
              none: str = "n/a") -> str:
    """``47.70 MiB`` (default) or the column-width-friendly ``47.7M``
    (``compact=True``); ``None`` renders as ``none``."""
    if n is None:
        return none
    for unit, short, div in _UNITS:
        if abs(n) >= div:
            return (f"{n / div:.1f}{short}" if compact
                    else f"{n / div:.2f} {unit}")
    return f"{int(n)}" if compact else f"{int(n)} B"
