"""The declarative mesh model the gradient-sync planner plans over.

The port's own copy of what ``parallel.hierarchy.plan_comm`` reads from
``apex_tpu/lint/mesh_model.py``: :class:`MeshAxis` (name, size and the
link class its collectives ride), :class:`MeshModel` (axes, major to minor,
the per-link byte rates and the link calibration, if measured) and
:func:`parse_mesh_spec`. The rest of that module serves the JAX package's
lint passes, which are not ported (ROADMAP.md queue A, item 12).

Link classes keep the JAX package's names, ``"ici"`` and ``"dcn"``, so
that a plan compares with the JAX package's by name. On H100s they mean
NVLink within a node (``"ici"``) and the network between nodes
(``"dcn"``).

The JAX package fills unset link rates from a table of TPU figures
(``DEFAULT_LINK_BYTES_PER_S``). The port has no such table: a TPU's link
rate is not a property of the card, so every model states the byte rate
of each link class its axes use, measured or taken from a data sheet.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["MeshAxis", "MeshModel", "parse_mesh_spec", "LINK_CLASSES"]

#: link classes, fastest first
LINK_CLASSES = ("ici", "dcn")


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One mesh dimension: name, size, and the link its hops ride."""

    name: str
    size: int
    link: str = "ici"

    def __post_init__(self):
        if self.link not in LINK_CLASSES:
            raise ValueError(f"axis {self.name!r}: link must be one of "
                             f"{LINK_CLASSES}, got {self.link!r}")
        if self.size < 1:
            raise ValueError(f"axis {self.name!r}: size must be >= 1, "
                             f"got {self.size}")


class MeshModel:
    """Axes (major to minor, row-major device layout as
    ``init_device_mesh`` lays ranks out), the byte rate of each link class
    (bytes/s; one for every class the axes use) and the calibration that
    measured them, if any (``{link: {"alpha_us", "bytes_per_s", ...}}``,
    the JAX package's linkbench record)."""

    def __init__(self, axes: Sequence[MeshAxis],
                 link_bytes_per_s: Dict[str, float],
                 name: Optional[str] = None,
                 calibration: Optional[Dict[str, Dict]] = None):
        axes = tuple(axes)
        if not axes:
            raise ValueError("a mesh model needs at least one axis")
        if len({a.name for a in axes}) != len(axes):
            raise ValueError("duplicate axis names")
        missing = sorted({a.link for a in axes} - set(link_bytes_per_s or {}))
        if missing:
            raise ValueError(f"no byte rate for link class(es) {missing}: "
                             "pass link_bytes_per_s (bytes/s per class)")
        self.axes = axes
        self.link_bytes_per_s = dict(link_bytes_per_s)
        self.name = name
        self.calibration = dict(calibration or {})

    @property
    def measured(self) -> bool:
        """True when the link rates carry calibration provenance."""
        return bool(self.calibration)

    @property
    def n_devices(self) -> int:
        n = 1
        for a in self.axes:
            n *= a.size
        return n

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    def axis(self, name: str) -> MeshAxis:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(name)

    def to_json(self) -> Dict:
        out = {"version": 1, "name": self.name,
               "axes": [dataclasses.asdict(a) for a in self.axes],
               "link_bytes_per_s": self.link_bytes_per_s}
        if self.calibration:
            out["calibration"] = self.calibration
        return out

    @classmethod
    def from_json(cls, data) -> "MeshModel":
        if isinstance(data, str):
            data = json.loads(data)
        if not isinstance(data, dict) or "axes" not in data:
            raise ValueError("not a mesh model "
                             '(expected {"version": 1, "axes": [...]})')
        return cls([MeshAxis(**a) for a in data["axes"]],
                   link_bytes_per_s=data.get("link_bytes_per_s"),
                   name=data.get("name"),
                   calibration=data.get("calibration"))

    def __repr__(self) -> str:
        axes = " x ".join(f"{a.name}={a.size}({a.link})"
                          for a in self.axes)
        return f"MeshModel({axes})"


_DP_RE = re.compile(r"^dp(\d+)x(\d+)$")
_SLICE_RE = re.compile(r"^(\d+)slice$")
_ICI_RE = re.compile(r"^ici(\d+)$")


def parse_mesh_spec(spec: str, n_devices: Optional[int] = None, *,
                    link_bytes_per_s: Optional[Dict[str, float]] = None
                    ) -> MeshModel:
    """A :class:`MeshModel` from the JAX package's compact spec grammar:

    - ``dpAxB``: A nodes over ``"dcn"`` x B cards over ``"ici"``, axes
      ``data_inter`` and ``data_intra``;
    - ``Nslice``: N nodes over ``"dcn"``, the local ``data`` axis taking
      ``n_devices / N``;
    - ``iciN``: one flat ``data`` axis of N cards;
    - a ``.json`` path or a JSON object: the declarative table, rates
      included.

    ``link_bytes_per_s`` gives the rates of a compact spec (required)."""
    spec = spec.strip()
    if spec.startswith("{") or spec.endswith(".json"):
        if spec.endswith(".json"):
            with open(spec) as f:
                return MeshModel.from_json(json.load(f))
        return MeshModel.from_json(spec)
    m = _DP_RE.match(spec)
    if m:
        inter, intra = int(m.group(1)), int(m.group(2))
        if n_devices is not None and inter * intra != n_devices:
            raise ValueError(f"spec {spec!r} wants {inter * intra} "
                             f"devices, have {n_devices}")
        axes = (MeshAxis("data_inter", inter, "dcn"),
                MeshAxis("data_intra", intra, "ici"))
    elif _SLICE_RE.match(spec):
        n_slices = int(_SLICE_RE.match(spec).group(1))
        if n_devices is None:
            raise ValueError(f"spec {spec!r} needs n_devices to size "
                             "the local axis")
        if n_devices % n_slices:
            raise ValueError(f"{n_devices} devices not divisible into "
                             f"{n_slices} slices")
        axes = (MeshAxis("slice", n_slices, "dcn"),
                MeshAxis("data", n_devices // n_slices, "ici"))
    elif _ICI_RE.match(spec):
        n = int(_ICI_RE.match(spec).group(1))
        if n_devices is not None and n != n_devices:
            raise ValueError(f"spec {spec!r} wants {n} devices, have "
                             f"{n_devices}")
        axes = (MeshAxis("data", n, "ici"),)
    else:
        raise ValueError(f"unknown mesh spec {spec!r} (want dpAxB | "
                         "Nslice | iciN | a mesh-model .json)")
    return MeshModel(axes, link_bytes_per_s=link_bytes_per_s, name=spec)
