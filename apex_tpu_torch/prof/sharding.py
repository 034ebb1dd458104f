"""Per-axis device-memory attribution from the port's real layouts.

The port of ``apex_tpu/prof/sharding.py``. The JAX package reads each
entry parameter's ``HloSharding`` annotation. The port compiles no
program, so the evidence is the layout the training state really has:

- the ZeRO optimizers (:mod:`apex_tpu_torch.optim.distributed`) keep one
  contiguous shard of every f32 slot (``opt_state.slots``) per rank of
  their ``axis_name``: those tensors are **sharded by** that axis (the
  axes of a hierarchical name, each), ``shard_factor`` its size;
- everything else in the state (the params DDP and ZeRO replicate, the
  step count, the scalers) is **replicated over** every axis.

Rows read off a real shard plan (an optimizer given) say
``source="layout"``; without one every row is ``source="none"`` and
replicated. The per-axis table closes over
:func:`~apex_tpu_torch.prof.memory.memory_report`'s class totals by the
JAX package's construction (:meth:`ShardReport.closure`), and
:meth:`ShardReport.forecast_axes` prices a further sharding.
``parse_hlo_sharding`` and ``parameter_shardings`` have no analogue.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

from apex_tpu_torch.prof.memory import (BUFFER_CLASSES, MemoryReport,
                                        _fmt_bytes, classify_arg_path)

__all__ = ["ShardRecord", "ShardReport", "shard_report"]


@dataclasses.dataclass
class ShardRecord:
    """One state tensor's per-axis disposition."""

    name: str                 # path in the state
    path: str
    cls: str                  # one of BUFFER_CLASSES
    bytes: int                # local (this rank's) bytes
    axes: Dict[str, str]      # {axis: "sharded" | "replicated"}
    shard_factor: int         # distinct shards: global = local * factor
    source: str               # "layout" | "none"
    sharding: str = ""        # the plan's axis name(s), "" if replicated

    @property
    def global_bytes(self) -> int:
        return self.bytes * self.shard_factor

    def sharded_by(self, axis: str) -> bool:
        return self.axes.get(axis) == "sharded"


@dataclasses.dataclass
class ShardReport:
    """Per-axis disposition of one step's state (see the module
    docstring); ``axis_table[axis]`` = ``{"sharded": {cls: bytes},
    "replicated": {cls: bytes}}``, each axis summing to the memory
    report's class totals. Classes with no state tensor behind them
    (activations, outputs) are per-rank working sets, counted sharded by
    every axis — a convention, as in the JAX package."""

    mesh_name: str
    axis_names: Tuple[str, ...]
    axis_sizes: Dict[str, int]
    records: List[ShardRecord]
    axis_table: Dict[str, Dict[str, Dict[str, int]]]
    class_totals: Dict[str, int]
    memory: Optional[MemoryReport] = None

    def axis_bytes(self, axis: str) -> Dict[str, int]:
        t = self.axis_table[axis]
        return {"sharded_bytes": sum(t["sharded"].values()),
                "replicated_bytes": sum(t["replicated"].values())}

    def attributed_total(self) -> int:
        return sum(self.class_totals.values())

    def closure(self) -> Tuple[bool, float]:
        """(ok, worst relative error) of every axis's sharded+replicated
        sum against the memory report's total, within 1%."""
        total = self.attributed_total()
        worst = 0.0
        for ax in self.axis_names:
            b = self.axis_bytes(ax)
            s = b["sharded_bytes"] + b["replicated_bytes"]
            if total:
                worst = max(worst, abs(s - total) / total)
            elif s:
                worst = 1.0
        return worst <= 0.01, worst

    def class_shard_ratio(self, cls: str) -> Optional[float]:
        """local/global bytes of one state class (≈ 1/world for
        ZeRO-sharded optimizer state); None without state tensors."""
        recs = [r for r in self.records if r.cls == cls]
        if not recs:
            return None
        local = sum(r.bytes for r in recs)
        glob = sum(r.global_bytes for r in recs)
        return (local / glob) if glob else None

    def forecast_axes(self, factors: Mapping[str, int]) -> Dict[str, Any]:
        """Per-class bytes if the part replicated over every axis were
        further sharded by the product of ``factors``."""
        prod = 1
        for name, f in factors.items():
            f = int(f)
            if f < 1:
                raise ValueError(f"axis {name!r}: factor must be >= 1")
            prod *= f
        per_class: Dict[str, Dict[str, int]] = {}
        for cls in BUFFER_CLASSES:
            total = self.class_totals.get(cls, 0)
            recs = [r for r in self.records if r.cls == cls]
            arg_local = sum(r.bytes for r in recs)
            fully_rep = sum(
                r.bytes for r in recs
                if all(not r.sharded_by(ax) for ax in self.axis_names))
            eligible = 0
            if total and arg_local:
                arg_share = min(arg_local, total)
                eligible = int(round(arg_share * fully_rep / arg_local))
            forecast = total - eligible + (eligible + prod - 1) // prod
            per_class[cls] = {"now": total, "eligible": eligible,
                              "forecast": forecast}
        return {"factors": dict(factors), "per_class": per_class,
                "total_now": sum(v["now"] for v in per_class.values()),
                "total_forecast": sum(v["forecast"]
                                      for v in per_class.values())}

    def table(self) -> str:
        lines = [f"shard report — mesh={self.mesh_name} "
                 + " x ".join(f"{a}={self.axis_sizes[a]}"
                              for a in self.axis_names),
                 f"{'axis':<12} {'sharded':>12} {'replicated':>12}  "
                 f"per-class sharded"]
        for ax in self.axis_names:
            b = self.axis_bytes(ax)
            per = " ".join(
                f"{cls}={_fmt_bytes(v)}"
                for cls, v in self.axis_table[ax]["sharded"].items() if v)
            lines.append(f"{ax:<12} {_fmt_bytes(b['sharded_bytes']):>12} "
                         f"{_fmt_bytes(b['replicated_bytes']):>12}  {per}")
        lines.append("state:")
        for r in sorted(self.records, key=lambda r: -r.bytes)[:12]:
            axes = ",".join(a for a in self.axis_names
                            if r.sharded_by(a)) or "-"
            lines.append(
                f"  {_fmt_bytes(r.bytes):>12} {r.cls:<16} "
                f"sharded_by={axes:<24} x{r.shard_factor} "
                f"[{r.source}] {r.path[:48]}")
        return "\n".join(lines)

    def to_events(self, rank: int = 0, step: Optional[int] = None,
                  candidate: Optional[str] = None,
                  wire_by_axis: Optional[Mapping[str, int]] = None,
                  predicted_s: Optional[Mapping[str, float]] = None
                  ) -> List[Dict]:
        """``kind="sharding_mesh"`` header + one ``kind="sharding"`` row
        per axis (``check_metrics_schema.py --kind sharding``)."""
        now = time.time()
        wire = dict(wire_by_axis or {})
        pred = dict(predicted_s or {})
        rows = list(self.axis_names)
        rows += [a for a in wire if a not in rows]
        extra = [a for a in rows
                 if a not in self.axis_names and a != "unknown"]
        evs: List[Dict] = [{
            "kind": "sharding_mesh", "rank": rank, "step": step,
            "mesh": self.mesh_name, "axes": list(self.axis_names),
            "axis_sizes": dict(self.axis_sizes),
            "extra_axes": extra or None,
            "candidate": candidate, "wall_time": now}]
        for ax in rows:
            b = (self.axis_bytes(ax) if ax in self.axis_table
                 else {"sharded_bytes": 0, "replicated_bytes": 0})
            evs.append({
                "kind": "sharding", "rank": rank, "step": step,
                "axis": ax, "candidate": candidate,
                "hbm_sharded_bytes": b["sharded_bytes"],
                "hbm_replicated_bytes": b["replicated_bytes"],
                "wire_bytes": wire.get(ax), "predicted_s": pred.get(ax),
                "wall_time": now})
        return evs


def _axes_of(axis_name) -> Tuple[str, ...]:
    if axis_name is None:
        return ()
    if isinstance(axis_name, str):
        return (axis_name,)
    return tuple(axis_name)


def shard_report(state, mesh_model, *, report: MemoryReport,
                 optimizer=None) -> ShardReport:
    """Build a :class:`ShardReport` of ``state`` (an ``AmpState`` or any
    tree of tensors) on ``mesh_model``
    (:class:`apex_tpu_torch.lint.mesh_model.MeshModel`), with class
    totals from ``report`` (the same step's memory report). ``optimizer``:
    the ZeRO optimizer whose shard plan the state follows (its
    ``axis_name``); without one nothing is sharded."""
    from apex_tpu_torch.ckpt.snapshot import tree_paths
    names = tuple(mesh_model.axis_names)
    sizes = {a.name: a.size for a in mesh_model.axes}
    plan_axes = _axes_of(getattr(optimizer, "axis_name", None))
    unknown = [a for a in plan_axes if a not in sizes]
    if unknown:
        raise ValueError(f"the optimizer shards over {unknown}, which the "
                         f"mesh {mesh_model.name!r} does not have")
    source = "layout" if optimizer is not None else "none"
    records: List[ShardRecord] = []
    seen = set()
    for path, leaf in tree_paths(state):
        if not hasattr(leaf, "untyped_storage"):
            continue
        st = leaf.untyped_storage()
        if st.data_ptr() in seen:         # views of one arena buffer
            continue
        seen.add(st.data_ptr())
        sharded = (bool(plan_axes) and "opt_state" in path
                   and "slots" in path)
        axes = {ax: ("sharded" if sharded and ax in plan_axes
                     else "replicated") for ax in names}
        factor = 1
        if sharded:
            for ax in plan_axes:
                factor *= sizes[ax]
        records.append(ShardRecord(
            name=path, path=path, cls=classify_arg_path(path),
            bytes=int(st.nbytes()), axes=axes, shard_factor=factor,
            source=source, sharding=",".join(plan_axes) if sharded else ""))

    class_totals = dict(report.classes)
    axis_table: Dict[str, Dict[str, Dict[str, int]]] = {
        ax: {"sharded": {}, "replicated": {}} for ax in names}
    for cls in BUFFER_CLASSES:
        total = class_totals.get(cls, 0)
        recs = [r for r in records if r.cls == cls]
        arg_local = sum(r.bytes for r in recs)
        arg_share = min(arg_local, total) if arg_local else 0
        temp_share = max(total - arg_share, 0)
        for ax in names:
            sharded = 0
            if arg_local:
                sh = sum(r.bytes for r in recs if r.sharded_by(ax))
                sharded = int(round(arg_share * sh / arg_local))
            sharded += temp_share
            axis_table[ax]["sharded"][cls] = sharded
            axis_table[ax]["replicated"][cls] = total - sharded
    return ShardReport(
        mesh_name=mesh_model.name or "mesh", axis_names=names,
        axis_sizes=sizes, records=records, axis_table=axis_table,
        class_totals=class_totals, memory=report)
