"""Device meshes over ``torch.distributed`` process groups.

Port of ``apex_tpu/parallel/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names`` are
the JAX package's axis names (``data``, ``model``, ...), built over the
default process group, which the caller starts first (``launch
.distributed_init`` or ``dist.init_process_group``): a mesh never starts
one itself.

Where the JAX package binds an axis name with ``shard_map``, the port
binds it with :func:`use_mesh`: inside ``with use_mesh(mesh):`` a module
given ``axis_name="data"`` resolves it, when it runs, to
``mesh.get_group("data")``; outside, :func:`resolve_group` raises, as JAX
raises for an unbound axis name. ``axis_index_groups`` (stats sub-groups)
resolve to ``dist.new_group`` sub-groups, created once per (axis, groups)
by every rank in the same order (``dist.new_group`` is itself a collective
call) and cached on the mesh.

``replicated`` and ``batch_sharding`` (JAX ``NamedSharding``s) have no
counterpart: a torch process holds its own copy of the state, and
``distributed.DistributedDataParallel.wrap`` hands each rank its slice of
the batch.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: Canonical axis names. data = DP/ZeRO sharding, model = tensor parallel,
#: seq = sequence/context parallel, pipe = pipeline stages, expert = MoE
#: expert parallel.
DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"

#: the factored data axes of the hierarchical gradient sync
DATA_INTER_AXIS = "data_inter"
DATA_INTRA_AXIS = "data_intra"

_CURRENT = contextvars.ContextVar("apex_tpu_torch_mesh", default=None)


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: start one first, with "
            "apex_tpu_torch.parallel.distributed_init(...) (or "
            "torch.distributed.init_process_group: backend 'nccl' for "
            "cuda, 'gloo' for the CPU, an init_method such as "
            "'tcp://host:port' or 'file:///path', world_size and rank)")
    return dist.get_world_size()


def make_mesh(axis_sizes: Sequence[Tuple[str, int]],
              device="cuda") -> DeviceMesh:
    """A mesh from ``[(axis_name, size), ...]`` over every rank of the
    default process group. A size of -1 (at most one axis) absorbs the
    remaining ranks, so ``make_mesh([("data", -1)])`` is the pure-DP mesh
    at any world size."""
    world = _world_size()
    names = tuple(n for n, _ in axis_sizes)
    sizes = [int(s) for _, s in axis_sizes]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may have size -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if world % known:
            raise ValueError(
                f"{world} ranks not divisible by fixed axes {known}")
        sizes[sizes.index(-1)] = world // known
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs "
                         f"{math.prod(sizes)} ranks, have {world}")
    return init_device_mesh(torch.device(device).type, tuple(sizes),
                            mesh_dim_names=names)


def data_parallel_mesh(device="cuda") -> DeviceMesh:
    """All ranks on one ``data`` axis: the reference DDP's topology."""
    return make_mesh([(DATA_AXIS, -1)], device)


def hierarchical_data_mesh(local_size: int, device="cuda") -> DeviceMesh:
    """Data parallelism factored into (``data_inter``, ``data_intra``) axes
    of sizes (world / local_size, local_size)."""
    return make_mesh([(DATA_INTER_AXIS, -1), (DATA_INTRA_AXIS, local_size)],
                     device)


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh):
    """Bind ``mesh``'s axis names for the code run inside: the
    counterpart of running under ``shard_map`` over it."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def _bound_mesh(axis: str, mesh=None) -> DeviceMesh:
    mesh = mesh if mesh is not None else _CURRENT.get()
    if mesh is None:
        raise NameError(f"unbound axis name: {axis!r} (run inside "
                        f"`with parallel.use_mesh(mesh):`)")
    if axis not in (mesh.mesh_dim_names or ()):
        raise NameError(f"unbound axis name: {axis!r} is not an axis of "
                        f"the mesh {mesh.mesh_dim_names}")
    return mesh


def axis_size(axis: str, mesh: Optional[DeviceMesh] = None) -> int:
    """Size of a named axis of ``mesh`` (default: the bound mesh)."""
    mesh = _bound_mesh(axis, mesh)
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(axis: str, mesh: Optional[DeviceMesh] = None) -> int:
    """This rank's coordinate along a named axis."""
    return _bound_mesh(axis, mesh).get_local_rank(axis)


def axes_of(axis_name) -> Tuple[str, ...]:
    """An axis name or a tuple of them, as a tuple."""
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def axes_size(axis_name, mesh: Optional[DeviceMesh] = None) -> int:
    """The product of the sizes of an axis name or tuple."""
    return math.prod(axis_size(a, mesh) for a in axes_of(axis_name))


def linear_index(axis_name, mesh: Optional[DeviceMesh] = None) -> int:
    """This rank's index over an axis name or tuple, axis-major in tuple
    order (row-major, as ``init_device_mesh`` lays out ranks): the tile a
    scatter over each axis in turn leaves it."""
    r = 0
    for a in axes_of(axis_name):
        r = r * axis_size(a, mesh) + axis_index(a, mesh)
    return r


def local_batch(global_batch: int, mesh: DeviceMesh,
                axis: str = DATA_AXIS) -> int:
    n = axis_size(axis, mesh)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{axis}={n}")
    return global_batch // n


def normalize_groups(axis_index_groups):
    """``axis_index_groups`` as a hashable tuple of tuples (or None)."""
    if axis_index_groups is None:
        return None
    return tuple(tuple(int(i) for i in g) for g in axis_index_groups)


def axis_groups(mesh: DeviceMesh, axis: str, groups):
    """The process group of this rank's stats sub-group: ``groups`` lists
    axis indices, as JAX's ``axis_index_groups``, applied along ``axis``
    within every slice of the other axes. Every group is created on the
    first call by every rank, in the same order, and cached on the mesh."""
    groups = normalize_groups(groups)
    cache = mesh.__dict__.setdefault("_apex_axis_groups", {})
    key = (axis, groups)
    if key not in cache:
        dim = mesh.mesh_dim_names.index(axis)
        n = mesh.size(dim)
        if sorted(i for g in groups for i in g) != list(range(n)):
            raise ValueError(f"axis_index_groups {groups} must partition "
                             f"the {n} indices of axis {axis!r}")
        rows = mesh.mesh.movedim(dim, -1).reshape(-1, n).tolist()
        me, mine = dist.get_rank(), None
        for row in rows:
            for g in groups:
                ranks = [row[i] for i in g]
                pg = dist.new_group(ranks=ranks)
                if me in ranks:
                    mine = pg
        cache[key] = mine
    return cache[key]


def resolve_group(axis_name: str, axis_index_groups=None):
    """The process group that ``axis_name`` (and ``axis_index_groups``)
    name under the bound mesh; raises for an unbound name."""
    mesh = _bound_mesh(axis_name)
    if axis_index_groups is None:
        return mesh.get_group(axis_name)
    return axis_groups(mesh, axis_name, axis_index_groups)
