"""Data-parallel gradient synchronisation: the DDP counterpart.

Port of ``apex_tpu/parallel/distributed.py``. Each rank computes its
gradients on its slice of the batch; a sync all-reduces them over the
``data`` axis of the bound mesh (``mesh.use_mesh``). What the reference's
DDP exposes as knobs survives:

- ``gradient_average`` / ``gradient_predivide_factor``: division before
  and after the reduce;
- ``allreduce_always_fp32``: half gradients reduced in f32;
- ``delay_allreduce``: one flat all-reduce per dtype at the end
  (:func:`flat_tree_all_reduce`) instead of one a tensor;
- ``bucket_allreduce`` with ``message_size``, and ``compress``
  (``"bf16"``/``"int8"`` with error feedback): ``comm.bucketed_all_reduce``;
- ``no_sync``: gradient accumulation without communication.

``message_size`` sizes the buckets of ``bucket_allreduce`` only. In the
JAX package it also sets XLA's collective-combiner threshold, which has no
counterpart: eager PyTorch issues each all-reduce as it is called.
``comm_plan`` (a ``hierarchy.CommPlan``) replaces the axis and the
compression: a hierarchical plan syncs through
``hierarchy.hierarchical_sync`` over its (``data_inter``, ``data_intra``)
axes, a flat one through ``comm.bucketed_all_reduce`` with the plan's
dtype. ``collective_bytes`` runs a step once and reads the port's
collective ledger (``monitor.collectives``), where the JAX package reads
the compiled HLO; ``memory_report`` reads compiled HLO in JAX and raises
here (ROADMAP.md queue A, item 11 part 3). ``dynamics_probe`` feeds the
training-dynamics monitor.

Every collective runs inside a ``torch.profiler.record_function`` named by
the registry (``ddp/sync_gradients``, ``bucketNN``, ``ddp/loss_pmean``)
and is counted in ``collectives.counts``.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import collectives, comm, hierarchy
from apex_tpu_torch.parallel.mesh import (DATA_AXIS, axes_size, axis_size,
                                          linear_index, resolve_group,
                                          use_mesh)
from apex_tpu_torch.parallel.registry import known_patterns
from apex_tpu_torch.utils import tree_leaves, tree_map

#: the registry's scope patterns, in order
KNOWN_COLLECTIVE_SCOPES = known_patterns()

#: the scope of a gradient sync's all-reduces
SYNC_SCOPE = "ddp/sync_gradients"


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _reduce(flat, group, world, *, gradient_average, predivide, fp32,
            scope):
    """The arithmetic of ``allreduce_bucket`` on one tensor: optionally to
    f32, divide by ``predivide``, sum over the group, divide by ``world /
    predivide`` (when averaging); returned in the input's dtype. Never
    reduces the caller's tensor in place."""
    orig = flat.dtype
    g = flat.float() if fp32 else flat
    if predivide != 1.0:
        g = g / predivide
    if g is flat:
        g = flat.clone()
    collectives.all_reduce(g, group, scope)
    if gradient_average:
        post = world / predivide
        if post != 1.0:
            g = g / post
    return g.to(orig)


def sync_gradients(grads, axis_name: str = DATA_AXIS, *,
                   gradient_average: bool = True,
                   gradient_predivide_factor: float = 1.0,
                   allreduce_always_fp32: bool = False):
    """All-reduce every float leaf of a gradient tree over ``axis_name``,
    one all-reduce a leaf in leaf order; other leaves pass through."""
    group = resolve_group(axis_name)
    world = dist.get_world_size(group)
    return tree_map(
        lambda g: _reduce(g, group, world, gradient_average=gradient_average,
                          predivide=gradient_predivide_factor,
                          fp32=allreduce_always_fp32, scope=SYNC_SCOPE)
        if _is_float(g) else g, grads)


def flat_all_reduce(buf: torch.Tensor, axis_name: str = DATA_AXIS, *,
                    average: bool = True) -> torch.Tensor:
    """One all-reduce of a flat arena buffer (``flat_dist_call``)."""
    group = resolve_group(axis_name)
    out = collectives.all_reduce(buf.clone(), group, SYNC_SCOPE)
    return out / dist.get_world_size(group) if average else out


def flat_tree_all_reduce(grads, axis_name: str = DATA_AXIS, *,
                         gradient_average: bool = True,
                         gradient_predivide_factor: float = 1.0,
                         allreduce_always_fp32: bool = False):
    """``allreduce_fallback``: the float leaves concatenated into one flat
    buffer per dtype (in leaf order), one all-reduce a buffer, split
    back. Same arithmetic knobs as :func:`sync_gradients`."""
    group = resolve_group(axis_name)
    world = dist.get_world_size(group)
    leaves = tree_leaves(grads)
    by_dtype = {}
    for i, leaf in enumerate(leaves):
        if _is_float(leaf):
            by_dtype.setdefault(leaf.dtype, []).append(i)
    out = list(leaves)
    for idxs in by_dtype.values():
        flat = _reduce(torch.cat([leaves[i].reshape(-1) for i in idxs]),
                       group, world, gradient_average=gradient_average,
                       predivide=gradient_predivide_factor,
                       fp32=allreduce_always_fp32, scope=SYNC_SCOPE)
        off = 0
        for i in idxs:
            n = leaves[i].numel()
            out[i] = flat[off:off + n].view(leaves[i].shape)
            off += n
    it = iter(out)
    return tree_map(lambda _: next(it), grads)


def dynamics_probe(local_grads, synced_grads, axis_name: str = DATA_AXIS):
    """The training-dynamics monitor's per-step gradient scalars
    (:class:`apex_tpu_torch.monitor.dynamics.DynamicsProbe`): call between
    the sync and ``apply_gradients`` with this replica's LOCAL gradient
    tree and the synced (averaged) tree, and feed the result to
    ``Amp.step(dynamics=(ds, dcfg, probe))`` or ``dynamics_observe``.

    Two collectives, each under its registered scope and trace span
    (``kind="collective"``), run by every rank at every world size:

    - ``ddp/dynamics_gns``: one f32 scalar all-reduce (a mean) of the
      per-replica squared grad norm: the mean ``|G_local|²`` the GNS
      estimator pairs against the pooled ``|G_big|²`` (computed locally:
      the synced tree is the same on every replica);
    - ``ddp/dynamics_geom``: one all-gather of the per-replica
      ``[|g_i|², g_i·ḡ]`` f32 pair: the cosine spectrum and the Adasum
      projection coefficients, ``8·world`` bytes of result.

    ``synced_grads`` must be the averaged sync output. Non-float leaves
    are ignored, as the sync ignores them. No host sync."""
    from apex_tpu_torch.monitor.dynamics import DynamicsProbe
    from apex_tpu_torch.monitor.numerics import flat_cat
    from apex_tpu_torch.trace.spans import span
    group = resolve_group(axis_name)
    world = dist.get_world_size(group)
    g, s = (flat_cat([x for x in tree_leaves(t) if _is_float(x)])
            for t in (local_grads, synced_grads))
    if g.numel() != s.numel():
        raise ValueError("dynamics_probe: local and synced trees differ")
    local_sq = torch.dot(g, g)
    pooled_sq = torch.dot(s, s)
    dot = torch.dot(g, s)
    with span("ddp/dynamics_gns", kind="collective"):
        local_sq_mean = collectives.all_reduce(
            local_sq.clone(), group, "ddp/dynamics_gns") / world
    with span("ddp/dynamics_geom", kind="collective"):
        pairs = collectives.all_gather(torch.stack([local_sq, dot]), group,
                                       "ddp/dynamics_geom")
    return DynamicsProbe(
        local_sq_mean=local_sq_mean, pooled_sq=pooled_sq,
        local_sqs=pairs[:, 0], dots=pairs[:, 1],
        world=torch.full((), float(world), dtype=torch.float32,
                         device=g.device))


class Reducer:
    """Manual-trigger averaging: ``reduce`` averages the float leaves of a
    tree over the data axis whenever the user calls it."""

    def __init__(self, axis_name: str = DATA_AXIS):
        self.axis_name = axis_name

    def reduce(self, tree):
        return sync_gradients(tree, self.axis_name)


def replica_broadcast(tree, axis_name=DATA_AXIS, *, source: int = 0):
    """Every leaf re-broadcast from the replica at index ``source`` of
    ``axis_name``, bit for bit (a broadcast copies bits; float, integer
    and bool leaves alike). Returns new tensors."""
    group = resolve_group(axis_name)
    src = dist.get_global_rank(group, int(source))
    return tree_map(lambda x: collectives.broadcast(
        x.clone(), src, group, "guard/integrity_repair"), tree)


def replicate(tree, mesh):
    """The tree as the mesh's first rank holds it, on every rank: the
    reference DDP's construction-time broadcast from rank 0. Returns new
    tensors."""
    src = int(mesh.mesh.reshape(-1)[0])
    return tree_map(lambda x: collectives.broadcast(
        x.detach().clone(), src, None, SYNC_SCOPE), tree)


class DistributedDataParallel:
    """Data-parallel step transform over a mesh.

    ``ddp = DistributedDataParallel(mesh)``; ``ddp.wrap(step)`` runs a
    step ``(state, batch) -> (state, aux)`` on this rank's slice of the
    global batch with ``mesh`` bound, and the step syncs its gradients
    with ``ddp.sync``. The constructor flags are the reference's."""

    def __init__(self, mesh, axis_name: str = DATA_AXIS, *,
                 gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0,
                 allreduce_always_fp32: bool = False,
                 delay_allreduce: bool = False,
                 message_size: Optional[int] = None,
                 bucket_allreduce: bool = False,
                 compress: Optional[str] = None,
                 compress_block: Optional[int] = None,
                 comm_plan=None):
        names = tuple(mesh.mesh_dim_names or ())
        if comm_plan is not None:
            # the plan is the compression and topology spec: its axes
            # replace axis_name, its per-hop dtypes replace compress
            if compress is not None or allreduce_always_fp32 or \
                    delay_allreduce or compress_block is not None:
                raise ValueError(
                    "comm_plan fixes the per-hop wire dtypes, the "
                    "quantization block and the topology; it does not "
                    "compose with compress, compress_block, "
                    "allreduce_always_fp32 or delay_allreduce (set "
                    "compress_block via plan_comm)")
            for ax in comm_plan.axis_names:
                if ax not in names:
                    raise ValueError(
                        f"comm_plan axis {ax!r} not in mesh {names}: build "
                        "the mesh with hierarchical_data_mesh (or matching "
                        "axis names) for a hierarchical plan")
            for hop in comm_plan.hops:
                if axis_size(hop.axis, mesh) != hop.size:
                    raise ValueError(
                        f"comm_plan axis {hop.axis!r} has size {hop.size} "
                        f"but the mesh has {axis_size(hop.axis, mesh)}")
            axis_name = (comm_plan.axis_names[0]
                         if len(comm_plan.axis_names) == 1
                         else tuple(comm_plan.axis_names))
        elif axis_name not in names:
            raise ValueError(f"axis {axis_name!r} not in mesh {names}")
        if compress not in comm.COMPRESS_MODES:
            raise ValueError(f"compress must be one of "
                             f"{comm.COMPRESS_MODES}, got {compress!r}")
        if compress is not None and allreduce_always_fp32:
            raise ValueError("compress fixes the wire dtype; it does not "
                             "compose with allreduce_always_fp32")
        if bucket_allreduce and delay_allreduce:
            raise ValueError("bucket_allreduce (per-bucket reduction) and "
                             "delay_allreduce (one terminal flat reduce) are "
                             "opposite modes")
        self.mesh = mesh
        self.axis_name = axis_name
        #: None, or the hierarchy.CommPlan every sync follows
        self.comm_plan = comm_plan
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.delay_allreduce = delay_allreduce
        #: elements a bucket of ``bucket_allreduce`` holds at most
        self.message_size = message_size
        self.bucket_allreduce = bucket_allreduce
        self.compress = compress
        self.compress_block = (compress_block if compress_block
                               else comm.DEFAULT_COMPRESS_BLOCK)
        self._sync_enabled = True

    @property
    def world_size(self) -> int:
        return axes_size(self.axis_name, self.mesh)

    def _knobs(self):
        return dict(gradient_average=self.gradient_average,
                    gradient_predivide_factor=self.gradient_predivide_factor,
                    allreduce_always_fp32=self.allreduce_always_fp32)

    def sync(self, grads, residual=None):
        """Sync a gradient tree (inside the wrapped step, or under
        ``use_mesh(ddp.mesh)``). Honours ``no_sync`` and
        ``delay_allreduce``; ``bucket_allreduce`` or ``compress`` go through
        ``comm.bucketed_all_reduce``, a ``comm_plan`` through its schedule.
        With ``residual`` (seed it with :meth:`init_residual`) the return is
        ``(synced, new_residual)``; the exact modes pass the residual
        through. Every mode runs under the ``ddp/sync_gradients`` trace span
        (``kind="collective"``), as the JAX package's does."""
        if not self._sync_enabled:
            return grads if residual is None else (grads, residual)
        from apex_tpu_torch.trace.spans import span
        # unbucketed compression (and a plan): one bucket per dtype
        msg = self.message_size if self.message_size else (
            comm.DEFAULT_MESSAGE_SIZE if self.bucket_allreduce else None)
        with use_mesh(self.mesh), span(SYNC_SCOPE, kind="collective"):
            if self.comm_plan is not None:
                return self._plan_sync(grads, residual, msg)
            if self.bucket_allreduce or self.compress is not None:
                return comm.bucketed_all_reduce(
                    grads, self.axis_name, message_size=msg,
                    residual=residual, compress=self.compress,
                    compress_block=self.compress_block, **self._knobs())
            fn = (flat_tree_all_reduce if self.delay_allreduce
                  else sync_gradients)
            synced = fn(grads, self.axis_name, **self._knobs())
        return synced if residual is None else (synced, residual)

    def _plan_sync(self, grads, residual, msg):
        plan = self.comm_plan
        knobs = dict(gradient_average=self.gradient_average,
                     gradient_predivide_factor=self.gradient_predivide_factor)
        if plan.is_hierarchical:
            return hierarchy.hierarchical_sync(
                grads, plan, message_size=msg, residual=residual, **knobs)
        # a flat plan is the planner-chosen compress mode on one axis
        return comm.bucketed_all_reduce(
            grads, self.axis_name, message_size=msg,
            compress=plan.hops[0].dtype, residual=residual,
            compress_block=plan.compress_block, **knobs)

    def init_residual(self, grads):
        """Zeroed error-feedback residual (``comm.init_residual``)."""
        return comm.init_residual(grads)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean of ``x`` over the replicas (for the logged loss); with a
        hierarchical ``comm_plan`` one sum per axis
        (``hierarchy.hierarchical_pmean``)."""
        if self.comm_plan is not None and self.comm_plan.is_hierarchical:
            with use_mesh(self.mesh):
                return hierarchy.hierarchical_pmean(x, self.comm_plan)
        group = self.mesh.get_group(self.axis_name)
        return collectives.all_reduce(x.detach().clone(), group,
                                      "ddp/loss_pmean") / self.world_size

    @contextlib.contextmanager
    def no_sync(self):
        """Steps run inside skip the gradient all-reduce (gradient
        accumulation across microbatches)."""
        prev, self._sync_enabled = self._sync_enabled, False
        try:
            yield
        finally:
            self._sync_enabled = prev

    def wrap(self, step_fn: Callable) -> Callable:
        """``step_fn(state, batch) -> out`` run with the mesh bound, on this
        rank's slice of every tensor leaf of ``batch``, split on the leading
        dim as ``shard_map`` splits it; the state is every rank's own
        (replicated: ``replicate`` it first). ``step_fn`` syncs its
        gradients with :meth:`sync` (or use :meth:`wrap_grad_fn`)."""
        @functools.wraps(step_fn)
        def stepped(state, batch):
            n = self.world_size
            me = linear_index(self.axis_name, self.mesh)

            def shard(x):
                if not isinstance(x, torch.Tensor):
                    return x
                if x.shape[0] % n:
                    raise ValueError(f"leading dim {x.shape[0]} not "
                                     f"divisible by {self.axis_name}={n}")
                b = x.shape[0] // n
                return x[me * b:(me + 1) * b]

            with use_mesh(self.mesh):
                return step_fn(state, tree_map(shard, batch))

        return stepped

    def wrap_grad_fn(self, grad_fn: Callable) -> Callable:
        """``grad_fn(*a, **k) -> (value, grads)`` with the grads synced."""
        @functools.wraps(grad_fn)
        def wrapped(*args, **kwargs):
            value, grads = grad_fn(*args, **kwargs)
            return value, self.sync(grads)
        return wrapped

    def collective_bytes(self, step_fn: Callable, *args, **kwargs) -> dict:
        """Per-step collective traffic of a (wrapped) step, by opcode:
        ``{"all-reduce": bytes, ..., "total": bytes}``. Runs
        ``step_fn(*args, **kwargs)`` once with the mesh bound and reads the
        result bytes its collectives added to the ledger
        (:func:`apex_tpu_torch.monitor.collectives.collective_bytes`; the
        JAX package reads its compiled HLO). Feed it to
        ``MetricsLogger(collective_bytes_per_step=...)``."""
        from apex_tpu_torch.monitor.collectives import collective_bytes
        with use_mesh(self.mesh):
            return collective_bytes(step_fn, *args, **kwargs)

    def memory_report(self, *args, **kwargs):
        raise NotImplementedError(
            "memory_report reads compiled HLO in the JAX package; its port "
            "belongs to prof/ (ROADMAP.md queue A, item 11 part 3)")
