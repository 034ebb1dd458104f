"""Topology-aware hierarchical compressed gradient sync.

Port of ``apex_tpu/parallel/hierarchy.py``. A flat all-reduce over every
rank carries the whole gradient over the slowest link. The hierarchical
schedule on a factored (``data_inter``, ``data_intra``) mesh does not:

1. **reduce-scatter within a node** (the ``"ici"`` link class: NVLink on
   H100s); each rank then owns ``1/intra`` of the bucket, summed over the
   node;
2. **all-reduce across nodes** (``"dcn"``: the network) of the owned
   shard only, in groups of one rank per node;
3. **all-gather within the node** to the whole synced gradient.

Each hop has its own wire dtype (``None``/f32, ``"bf16"``, or ``"int8"``
blockwise-scaled), chosen by :func:`plan_comm` from a
:class:`~apex_tpu_torch.lint.mesh_model.MeshModel`: it minimises each
hop's α–β time, ``α·n_collectives + wire bytes / link rate``, walking down
the precision ladder only while a step buys ``min_gain``. The plan
records the α and rate each hop was planned with and whether they were
measured.

Error feedback across hops: every compression error re-enters the next
step's local gradient exactly once. The within-node quantization error is
the rank's own; the cross-node hop's phase-2 error belongs to the shard's
owner in its group; the gather hop compresses a value replicated across
nodes, so only the ``data_inter`` rank 0 copy re-injects it. The residual
is a per-rank tree like the flat path's (``comm.init_residual``).

Each hop's collectives run under the registry scopes ``bucketNN/ici`` and
``bucketNN/dcn`` (``collectives``). In JAX ``chain=True`` orders the
buckets with an ``optimization_barrier``; eager PyTorch already issues
them in call order on one communicator, so the argument is kept and has
nothing to add.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import collectives, comm as _comm
from apex_tpu_torch.parallel.mesh import axis_size, resolve_group
from apex_tpu_torch.utils import tree_leaves, tree_map

__all__ = ["Hop", "CommPlan", "plan_comm", "hierarchical_sync",
           "hierarchical_pmean", "DTYPE_CHOICES"]

#: wire-dtype candidates, highest precision first
DTYPE_CHOICES = (None, "bf16", "int8")


@dataclasses.dataclass(frozen=True)
class Hop:
    """One collective hop of the schedule, with its planning inputs."""

    op: str                  # "reduce_scatter" | "all_reduce" | "all_gather"
    axis: str                # mesh axis name the hop runs over
    size: int                # that axis's size
    link: str                # "ici" | "dcn"
    dtype: Optional[str]     # None | "bf16" | "int8"
    alpha_us: float          # per-collective latency used for planning
    bytes_per_s: float       # link rate used for planning
    calibrated: bool         # True when α/β were measured

    def n_collectives(self) -> int:
        """Collectives the hop issues (each pays α): int8 moves payload and
        scales (×2); the two-phase int8 all-reduce is an all-to-all and an
        all-gather of both (×4)."""
        if self.dtype != "int8":
            return 1
        return 4 if self.op == "all_reduce" else 2

    def wire_bytes(self, elems: int,
                   compress_block: int = _comm.DEFAULT_COMPRESS_BLOCK
                   ) -> int:
        """Per-rank ring-factored wire bytes for a bucket of ``elems``
        f32-logical elements entering this hop."""
        k = self.size
        payload = _comm.dtype_wire_bytes(elems, self.dtype, compress_block)
        factor = 2 * (k - 1) / k if self.op == "all_reduce" \
            else (k - 1) / k
        return int(factor * payload)

    def seconds(self, elems: int,
                compress_block: int = _comm.DEFAULT_COMPRESS_BLOCK
                ) -> float:
        return (self.n_collectives() * self.alpha_us * 1e-6
                + self.wire_bytes(elems, compress_block)
                / self.bytes_per_s)


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """The per-hop schedule and the provenance it was derived from: two
    :func:`plan_comm` calls on the same model give the same plan."""

    hops: Tuple[Hop, ...]
    compress_block: int
    source: str              # "measured" | "defaults"
    mesh_name: Optional[str]
    grad_bytes: Optional[int]  # payload the plan was optimised for

    @property
    def is_hierarchical(self) -> bool:
        return len(self.hops) > 1

    @property
    def axis_names(self) -> Tuple[str, ...]:
        seen: List[str] = []
        for h in self.hops:
            if h.axis not in seen:
                seen.append(h.axis)
        return tuple(seen)

    @property
    def world(self) -> int:
        n, seen = 1, set()
        for h in self.hops:
            if h.axis not in seen:
                seen.add(h.axis)
                n *= h.size
        return n

    @property
    def intra(self) -> Hop:
        """The within-node scatter hop (hierarchical plans)."""
        return self.hops[0]

    @property
    def inter(self) -> Hop:
        """The cross-node reduce hop (hierarchical plans)."""
        return self.hops[1]

    def dtype_by_link(self) -> Dict[str, Optional[str]]:
        out: Dict[str, Optional[str]] = {}
        for h in self.hops:
            out.setdefault(h.link, h.dtype)
        return out

    def flat_ring_factor(self) -> float:
        """The per-rank ring factor of the flat all-reduce this plan
        replaces, 2(n−1)/n: the normaliser that keeps
        ``comm.wire_bytes`` in all-reduce-equivalent units."""
        n = self.world
        return 2 * (n - 1) / n

    def _hop_elems(self, elems: int) -> List[int]:
        out = []
        for h in self.hops:
            if h.op == "all_reduce" and len(self.hops) > 1:
                out.append(-(-elems // self.hops[0].size))
            else:
                out.append(elems)
        return out

    def bucket_wire_bytes(self, elems: int) -> int:
        """Per-rank ring-factored wire bytes of one bucket through the
        whole schedule."""
        return sum(h.wire_bytes(e, self.compress_block)
                   for h, e in zip(self.hops, self._hop_elems(elems)))

    def hop_seconds(self, grad_bytes: Optional[int] = None) -> List[float]:
        """α–β-predicted seconds per hop, plan order, for one sync of
        ``grad_bytes`` (default: the planned payload)."""
        nbytes = grad_bytes if grad_bytes is not None else \
            (self.grad_bytes or 0)
        elems = nbytes // 4
        return [h.seconds(e, self.compress_block)
                for h, e in zip(self.hops, self._hop_elems(elems))]

    def predicted_seconds(self, grad_bytes: Optional[int] = None
                          ) -> Dict[str, float]:
        """Predicted seconds per link class for one sync."""
        out: Dict[str, float] = {}
        for h, s in zip(self.hops, self.hop_seconds(grad_bytes)):
            out[h.link] = out.get(h.link, 0.0) + s
        return out

    def describe(self) -> str:
        hops = " -> ".join(
            f"{h.op}[{h.axis}={h.size}/{h.link}:"
            f"{h.dtype or 'fp32'}]" for h in self.hops)
        return f"CommPlan({hops}, {self.source})"

    def to_json(self) -> Dict:
        return {
            "version": 1, "source": self.source,
            "mesh": self.mesh_name, "grad_bytes": self.grad_bytes,
            "compress_block": self.compress_block,
            "hops": [dataclasses.asdict(h) for h in self.hops],
        }


def _choose_dtype(mk_hop, elems: int, compress_block: int,
                  min_gain: float, dtypes=DTYPE_CHOICES) -> Hop:
    """Walk the precision ladder: take a lower-precision wire dtype only
    while it beats the current pick's predicted time by ``min_gain``."""
    best = mk_hop(dtypes[0])
    for dt in dtypes[1:]:
        cand = mk_hop(dt)
        if cand.seconds(elems, compress_block) < \
                best.seconds(elems, compress_block) * (1 - min_gain):
            best = cand
    return best


def plan_comm(mesh_model, grad_bytes: int, *,
              compress_block: int = _comm.DEFAULT_COMPRESS_BLOCK,
              min_gain: float = 0.05, dtypes=DTYPE_CHOICES) -> CommPlan:
    """The gradient-sync :class:`CommPlan` for a mesh model: with a
    ``"dcn"`` axis the 3-hop hierarchical schedule, else one flat
    all-reduce hop, each hop's dtype chosen from ``dtypes`` by predicted
    time (``source`` says whether the model's rates were measured)."""
    ici = [a for a in mesh_model.axes if a.link == "ici"]
    dcn = [a for a in mesh_model.axes if a.link == "dcn"]
    if len(ici) != 1 or len(dcn) > 1:
        raise NotImplementedError(
            f"plan_comm wants one ici axis and at most one dcn axis, "
            f"got {mesh_model!r}")

    def link_params(link: str):
        cal = mesh_model.calibration.get(link) or {}
        return (float(cal.get("alpha_us", 0.0)),
                float(mesh_model.link_bytes_per_s[link]), bool(cal))

    elems = int(grad_bytes) // 4
    source = "measured" if mesh_model.measured else "defaults"

    def mk(op, axis, size, link, dt):
        alpha, bps, cal = link_params(link)
        return Hop(op=op, axis=axis.name, size=size, link=link, dtype=dt,
                   alpha_us=alpha, bytes_per_s=bps, calibrated=cal)

    if not dcn:
        hop = _choose_dtype(
            lambda dt: mk("all_reduce", ici[0], ici[0].size, "ici", dt),
            elems, compress_block, min_gain, dtypes)
        return CommPlan(hops=(hop,), compress_block=compress_block,
                        source=source, mesh_name=mesh_model.name,
                        grad_bytes=int(grad_bytes))

    intra, inter = ici[0], dcn[0]
    shard_elems = -(-elems // intra.size)
    rs = _choose_dtype(
        lambda dt: mk("reduce_scatter", intra, intra.size, "ici", dt),
        elems, compress_block, min_gain, dtypes)
    ar = _choose_dtype(
        lambda dt: mk("all_reduce", inter, inter.size, "dcn", dt),
        shard_elems, compress_block, min_gain, dtypes)
    ag = _choose_dtype(
        lambda dt: mk("all_gather", intra, intra.size, "ici", dt),
        elems, compress_block, min_gain, dtypes)
    return CommPlan(hops=(rs, ar, ag), compress_block=compress_block,
                    source=source, mesh_name=mesh_model.name,
                    grad_bytes=int(grad_bytes))


# --- execution ----------------------------------------------------------------

def _int8_reduce_scatter(buf, group, block: int, scope: str):
    """Quantize, all-to-all, and an exact f32 sum of the received shards:
    the within-node scatter at about a quarter of the bytes. ``buf``'s
    length is a multiple of ``world * block``. Returns ``(shard_sum,
    err_local)``, the local quantization error over the whole buffer."""
    world = dist.get_world_size(group)
    per = buf.shape[0] // world
    q, s = _comm._quantize_int8(buf, block)
    err = buf - _comm._dequantize_int8(q, s, block)
    qt = collectives.all_to_all(q.view(world, per), group, scope)
    st = collectives.all_to_all(s.view(world, per // block), group, scope)
    deq = qt.float().view(world, per // block, block) * st[:, :, None]
    return deq.sum(dim=0).view(per), err


def _reduce_scatter_hop(flat, hop: Hop, block: int, want_err: bool, scope):
    group = resolve_group(hop.axis)
    if hop.dtype == "int8":
        shard, err = _int8_reduce_scatter(flat, group, block, scope)
        return shard, (err if want_err else None)
    if hop.dtype == "bf16":
        wire = flat.to(torch.bfloat16)
        err = (flat - wire.float()) if want_err else None
        return collectives.reduce_scatter(wire, group, scope).float(), err
    return collectives.reduce_scatter(flat, group, scope), None


def _all_reduce_hop(shard, hop: Hop, block: int, want_err: bool, scope):
    """Cross-node reduce of the owned shard; its error comes back already
    owner-resolved (each position's error re-injected once in the
    group)."""
    group = resolve_group(hop.axis)
    if hop.dtype == "int8":
        red, err_local, err_shard = _comm._int8_all_reduce(shard, group,
                                                           block, scope)
        if not want_err:
            return red, None
        rank = dist.get_rank(group)
        per = shard.shape[0] // hop.size
        err_local[rank * per:(rank + 1) * per] += err_shard
        return red, err_local
    if hop.dtype == "bf16":
        wire = shard.to(torch.bfloat16)
        err = (shard - wire.float()) if want_err else None
        return collectives.all_reduce(wire, group, scope).float(), err
    return collectives.all_reduce(shard.clone(), group, scope), None


def _all_gather_hop(shard, hop: Hop, block: int, want_err: bool,
                    inter_axis: Optional[str], scope):
    """Gather the reduced shards back within the node. The compression
    error is on a value replicated across nodes, so only the
    ``inter_axis`` rank 0 feeds it back."""
    group = resolve_group(hop.axis)

    def owner_mask(err):
        if err is None or inter_axis is None:
            return err
        if dist.get_rank(resolve_group(inter_axis)) == 0:
            return err
        return torch.zeros_like(err)

    if hop.dtype == "int8":
        q, s = _comm._quantize_int8(shard, block)
        err = (shard - _comm._dequantize_int8(q, s, block)) \
            if want_err else None
        full_q = collectives.all_gather(q, group, scope, tiled=True)
        full_s = collectives.all_gather(s, group, scope, tiled=True)
        return (_comm._dequantize_int8(full_q, full_s, block),
                owner_mask(err))
    if hop.dtype == "bf16":
        wire = shard.to(torch.bfloat16)
        err = (shard - wire.float()) if want_err else None
        full = collectives.all_gather(wire, group, scope, tiled=True)
        return full.float(), owner_mask(err)
    return collectives.all_gather(shard, group, scope, tiled=True), None


def hierarchical_sync(grads, plan: CommPlan, *,
                      message_size: Optional[int] = None,
                      gradient_average: bool = True,
                      gradient_predivide_factor: float = 1.0,
                      residual=None, chain: bool = True):
    """Bucketed hierarchical compressed all-reduce of a gradient tree per
    ``plan``, inside ``use_mesh`` over a mesh with the plan's axes
    (``mesh.hierarchical_data_mesh``). Arithmetic knobs as
    ``comm.bucketed_all_reduce``; with ``residual`` the return is
    ``(synced, new_residual)`` and every hop's compression error is fed
    into the next step (module docstring). ``chain`` is kept for the JAX
    package's signature: eager buckets are already issued in order. Each
    bucket runs under a ``bucketNN`` trace span and each hop under an
    ``ici`` or ``dcn`` one (``kind="collective"``), as the JAX package's
    do."""
    del chain
    if not plan.is_hierarchical:
        raise ValueError("flat CommPlan: use bucketed_all_reduce with "
                         f"compress={plan.hops[0].dtype!r} (DDP routes "
                         "this automatically)")
    rs_hop, ar_hop, ag_hop = plan.hops
    block = plan.compress_block
    world_i, world_x = axis_size(rs_hop.axis), axis_size(ar_hop.axis)
    if world_i != rs_hop.size or world_x != ar_hop.size:
        raise ValueError(
            f"plan sizes ({rs_hop.axis}={rs_hop.size}, "
            f"{ar_hop.axis}={ar_hop.size}) do not match the mesh "
            f"({rs_hop.axis}={world_i}, {ar_hop.axis}={world_x})")
    world = world_i * world_x
    pre = gradient_predivide_factor

    leaves = tree_leaves(grads)
    r_leaves = None
    if residual is not None:
        r_leaves = tree_leaves(residual)
        if len(r_leaves) != len(leaves):
            raise ValueError(
                f"residual has {len(r_leaves)} leaves, grads have "
                f"{len(leaves)}: build it with init_residual(grads)")
    want_err = r_leaves is not None

    from apex_tpu_torch.trace.spans import span
    out = list(leaves)
    for bi, bkt in enumerate(_comm.bucket_plan(leaves, message_size)):
        ici, dcn = f"bucket{bi:02d}/ici", f"bucket{bi:02d}/dcn"
        with span(f"bucket{bi:02d}", kind="collective"):
            flat = torch.cat([leaves[i].reshape(-1)
                              for i in bkt.leaf_idx]).float()
            n0 = flat.shape[0]
            if pre != 1.0:
                flat = flat / pre
            if want_err:
                flat = flat + torch.cat([r_leaves[i].reshape(-1)
                                         for i in bkt.leaf_idx])
            # pad so every hop tiles: the scatter needs world_i | n, the int8
            # cross-node hop (world_x * block) | shard (zeros quantize exactly)
            mult = world * block
            npad = -(-n0 // mult) * mult - n0
            fpad = torch.nn.functional.pad(flat, (0, npad)) if npad else flat

            per = fpad.shape[0] // world_i
            with span("ici", kind="collective"):
                shard, err_a = _reduce_scatter_hop(fpad, rs_hop, block,
                                                   want_err, ici)
            with span("dcn", kind="collective"):
                shard, err_b = _all_reduce_hop(shard, ar_hop, block,
                                               want_err, dcn)
            with span("ici", kind="collective"):
                full, err_c = _all_gather_hop(shard, ag_hop, block, want_err,
                                              ar_hop.axis, ici)
            if gradient_average:
                post = world / pre
                if post != 1.0:
                    full = full / post

            err = None
            if want_err:
                err = err_a if err_a is not None else torch.zeros_like(fpad)
                shard_err = None
                for e in (err_b, err_c):
                    if e is not None:
                        shard_err = e if shard_err is None else shard_err + e
                if shard_err is not None:
                    off = dist.get_rank(resolve_group(rs_hop.axis)) * per
                    err[off:off + per] += shard_err
                err = err[:n0]

            red = full[:n0]
            off = 0
            for i in bkt.leaf_idx:
                n = leaves[i].numel()
                out[i] = red[off:off + n].view(leaves[i].shape).to(
                    leaves[i].dtype)
                if err is not None:
                    r_leaves[i] = err[off:off + n].view(leaves[i].shape)
                off += n

    it = iter(out)
    synced = tree_map(lambda _: next(it), grads)
    if residual is None:
        return synced
    rit = iter(r_leaves)
    return synced, tree_map(lambda _: next(rit), residual)


def hierarchical_pmean(x: torch.Tensor, plan: CommPlan) -> torch.Tensor:
    """Mean over the ranks matching the plan's topology: one sum per axis
    (within a node, then one rank per node across) instead of one flat
    all-reduce over all ranks, under the ``ddp/loss_pmean`` scope (the
    logged loss). Out of place."""
    x = x.detach().clone()
    for axis in plan.axis_names:
        collectives.all_reduce(x, resolve_group(axis), "ddp/loss_pmean")
    return x / plan.world
