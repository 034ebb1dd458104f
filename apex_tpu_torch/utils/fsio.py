"""Shared-filesystem atomic-commit primitives.

One temp→fsync→rename recipe for every layer that publishes records
on a shared filesystem — the checkpoint manifest (``ckpt.format``)
and the cluster control plane's generation/lease files each need the
identical guarantee (readers see either the old record or the new
one, never a torn write, and the rename IS the commit point), so the
recipe lives once. The port's copy of ``apex_tpu.utils.fsio``.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

__all__ = ["write_atomic", "fsync_dir"]


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives a crash."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass                     # not all filesystems allow dir fsync


def write_atomic(path: str, data: bytes, *,
                 tmp_suffix: str = ".tmp",
                 before_rename: Optional[Callable[[], None]] = None
                 ) -> None:
    """temp → fsync → rename; durable against crash at any instant.

    ``tmp_suffix`` disambiguates the temp file when several processes
    may replace the same path concurrently (pass a pid-qualified
    suffix); ``before_rename`` is the test-crash hook seam — it runs
    after the data is durable but before the rename commits it."""
    tmp = path + tmp_suffix
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    if before_rename is not None:
        before_rename()
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))
