"""Heartbeat files of the cross-rank straggler tier: the file helpers.

The port of the file-level part of ``apex_tpu/trace/straggler.py``: each
rank appends one JSON line per finished step to its own file
``hb.rank{r:05d}.jsonl`` under a shared directory (records ``{"step",
"rank", "wall_time", "dur_ms", "spans", "generation"}``). The port keeps
:func:`heartbeat_path`, :func:`read_heartbeats` (torn-tail tolerant,
optionally scoped to one cluster generation) and
:func:`gc_stale_heartbeats`, the relaunch hygiene pass that
``cluster.ClusterMembership.gc_stale(heartbeat_dir=)`` runs; the files are
the JAX package's, read and written interchangeably. The writer, the
lockstep straggler detector and its watch thread belong with the rest of
``trace/`` (the tracer, flight recorder and hang watchdog), which the port
does not have yet (ROADMAP.md queue A, item 11).
"""

from __future__ import annotations

import os
import json
from typing import Dict, List, Optional

__all__ = ["HB_PREFIX", "heartbeat_path", "read_heartbeats",
           "gc_stale_heartbeats"]

#: heartbeat file name prefix (``hb.rank00003.jsonl``)
HB_PREFIX = "hb.rank"


def heartbeat_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"{HB_PREFIX}{rank:05d}.jsonl")


def read_heartbeats(directory: str, *,
                    generation: Optional[int] = None
                    ) -> Dict[int, Dict[int, Dict]]:
    """``{rank: {step: record}}`` over every rank file present.

    Malformed lines (a reader racing a writer's partial append) are
    skipped; a later complete record for the same step wins.

    ``generation`` scopes the read to one cluster epoch: records whose
    ``generation`` tag differs (untagged records count as generation 0)
    are ignored, and a rank whose file carries NO current-generation
    records is omitted entirely — a dead previous attempt's heartbeats
    must not read as a live-but-silent rank of the new epoch (the
    exact bug an ``elastic_run`` restart over stale files exhibits).
    """
    out: Dict[int, Dict[int, Dict]] = {}
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        if not (name.startswith(HB_PREFIX) and name.endswith(".jsonl")):
            continue
        try:
            rank = int(name[len(HB_PREFIX):-len(".jsonl")])
        except ValueError:
            continue
        per: Dict[int, Dict] = {}
        try:
            with open(os.path.join(directory, name)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue           # torn tail of a live append
                    if generation is not None:
                        g = rec.get("generation")
                        g = g if isinstance(g, int) else 0
                        if g != int(generation):
                            continue       # another epoch's record
                    step = rec.get("step")
                    if isinstance(step, int):
                        per[step] = rec
        except OSError:
            continue
        if per:
            out[rank] = per
    return out


def gc_stale_heartbeats(directory: str,
                        current_generation: int) -> List[str]:
    """Delete heartbeat files whose NEWEST record belongs to an older
    generation — the ``elastic_run`` relaunch hygiene pass (see
    :func:`apex_tpu_torch.cluster.relaunch`): without it, a rank that died
    in generation N leaves a file whose last beat reads as a "silent
    rank" to every future detector poll. A file carrying any
    current-generation record is kept (a survivor's history is still
    its history). Returns removed paths."""
    removed: List[str] = []
    cur = int(current_generation)
    for rank, per in read_heartbeats(directory).items():
        # one read serves both questions (a second generation-scoped
        # pass would double the shared-fs traffic of the restart path)
        if any((rec.get("generation") if isinstance(
                rec.get("generation"), int) else 0) == cur
               for rec in per.values()):
            continue               # a survivor's history stays
        p = heartbeat_path(directory, rank)
        try:
            os.remove(p)
            removed.append(p)
        except OSError:
            pass
    return removed
