"""Rank bodies of the port's multi-process parity tests (not a test module).

It imports no JAX: the spawned ranks load only the port. ``run(world,
names, tmp, inputs)`` starts ``world`` processes (the ``spawn`` start
method), each a gloo rank over a ``file://`` store in ``tmp`` (no port to
collide between test workers), with one CPU thread and a collective
timeout of ``TIMEOUT_S``. Every rank runs the named cases in order, with
the mesh of all ranks bound (``axes``: ``[(name, size), ...]``, by default
one ``data`` axis; ``[("data_inter", 2), ("data_intra", 2)]`` or
``[("seq", W)]`` for the hierarchical sync and the ring), and saves each
case's
result (numpy arrays). The parent joins the group with a deadline
(``DEADLINE_S``) and kills what still runs, so a hung collective fails the
cases it stopped, not the suite. A case that raises records its traceback
and ends its rank: it and the cases after it report the error.
``inputs`` (what the JAX side made: weights, arrays) reach every rank
through a file. The numpy input makers here are shared by both sides.
"""

from __future__ import annotations

import datetime
import multiprocessing
import pathlib
import time
import traceback

import numpy as np
import torch

#: seconds a collective may wait before gloo raises
TIMEOUT_S = 60
#: seconds the whole group may run
DEADLINE_S = 300

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


class RankError(str):
    """What a rank left instead of a result: its traceback, or why it
    has none."""


def run(world, names, tmp, inputs=None, deadline_s=DEADLINE_S, axes=None):
    """{case name: [rank 0's result, ...]}; a rank's result is a dict of
    numpy arrays, or a :class:`RankError`. ``axes`` are the bound mesh's
    (default ``[("data", world)]``)."""
    axes = list(axes or [("data", world)])
    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(inputs or {}, tmp / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, str(tmp), list(names), axes))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(end - time.monotonic(), 0.0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    out = {}
    for name in names:
        per = []
        for r in range(world):
            ok, err = tmp / f"{name}.{r}.pt", tmp / f"{name}.{r}.err"
            if ok.exists():
                per.append(torch.load(ok, weights_only=False))
            elif err.exists():
                per.append(RankError(err.read_text()))
            else:
                per.append(RankError(f"rank {r} has no result for {name} "
                                     f"(exit codes {codes}; the deadline "
                                     f"was {deadline_s} s)"))
        out[name] = per
    return out


def ranks(results, name):
    """The per-rank results of one case; raises with a rank's error."""
    per = results[name]
    for r, res in enumerate(per):
        if isinstance(res, RankError):
            raise AssertionError(f"case {name}, rank {r}:\n{res}")
    return per


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    return tree


def _rank_main(rank, world, tmp, names, axes):
    import torch.distributed as dist
    from apex_tpu_torch import parallel

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp / 'store'}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = parallel.make_mesh(axes, "cpu")
        inputs = torch.load(tmp / "inputs.pt", weights_only=False)
        for name in names:
            try:
                with parallel.use_mesh(mesh):
                    res = CASES[name](rank, world, mesh, inputs)
                torch.save(_numpy(res), tmp / f"{name}.{rank}.pt")
            except Exception:
                (tmp / f"{name}.{rank}.err").write_text(
                    traceback.format_exc())
                break
    finally:
        dist.destroy_process_group()


def shard(a, rank, world):
    """Rank ``rank``'s rows of ``a``, split on the leading dim as
    ``shard_map`` splits it."""
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


def t(a, requires_grad=False):
    return torch.tensor(np.ascontiguousarray(a)).requires_grad_(
        requires_grad)


# --- SyncBatchNorm (tests/test_torch_sync_batchnorm.py, world 4) ------------

def syncbn_inputs(kind, world=4):
    """numpy inputs of one SyncBN case, as both sides draw them."""
    if kind == "fwd":
        rng = np.random.RandomState(0)
        return (rng.randn(16, 4, 4, 8).astype(np.float32),
                (rng.rand(8) + 0.5).astype(np.float32),
                rng.randn(8).astype(np.float32))
    if kind == "unequal":            # rank i: i + 1 valid rows of 8
        rng = np.random.RandomState(1)
        blocks = []
        for n in range(1, world + 1):
            block = np.zeros((8, 4), np.float32)
            block[:n] = rng.randn(n, 4)
            blocks.append(block)
        return np.concatenate(blocks), np.arange(1, world + 1)
    if kind == "groups":
        return (np.random.RandomState(2).randn(16, 4).astype(np.float32),)
    if kind == "add_relu":
        rng = np.random.RandomState(3)
        return (rng.randn(16, 4).astype(np.float32),
                rng.randn(16, 4).astype(np.float32))
    if kind == "grads":
        rng = np.random.RandomState(4)
        return (rng.randn(16, 4).astype(np.float32),
                (rng.rand(4) + 0.5).astype(np.float32),
                rng.randn(4).astype(np.float32))
    if kind == "module":
        return (np.random.RandomState(6).randn(16, 4, 4, 3)
                .astype(np.float32),)
    if kind == "convert":
        rng = np.random.RandomState(7)
        return (rng.randn(16, 4).astype(np.float32) * 2 + 1,
                rng.randn(16, 4).astype(np.float32))
    if kind == "group_bn":
        rng = np.random.RandomState(8)
        return (rng.randn(16, 2, 2, 4).astype(np.float32),
                rng.randn(16, 2, 2, 4).astype(np.float32))
    raise ValueError(kind)


@case
def syncbn_fwd(rank, world, mesh, inputs):
    from apex_tpu_torch import parallel
    x, scale, bias = syncbn_inputs("fwd", world)
    y, mean, var, count = parallel.sync_batch_norm(
        t(shard(x, rank, world)), t(scale), t(bias), axis_name="data")
    return {"y": y, "mean": mean, "var": var, "count": count}


@case
def syncbn_unequal(rank, world, mesh, inputs):
    from apex_tpu_torch import parallel
    x, counts = syncbn_inputs("unequal", world)
    mean, var, count = parallel.sync_moments(
        t(shard(x, rank, world)), axis_name="data", reduce_axes=(0,),
        valid_count=float(counts[rank]))
    return {"mean": mean, "var": var, "count": count}


@case
def syncbn_groups(rank, world, mesh, inputs):
    from apex_tpu_torch import parallel
    (x,) = syncbn_inputs("groups", world)
    groups = parallel.syncbn_stats_groups(world, 2)
    mean, var, count = parallel.sync_moments(
        t(shard(x, rank, world)), axis_name="data", reduce_axes=(0,),
        axis_index_groups=groups)
    return {"mean": mean, "var": var, "count": count}


@case
def syncbn_add_relu(rank, world, mesh, inputs):
    from apex_tpu_torch import parallel
    x, z = syncbn_inputs("add_relu", world)
    y, *_ = parallel.sync_batch_norm(
        t(shard(x, rank, world)), None, None, axis_name="data",
        z=t(shard(z, rank, world)), relu=True)
    return {"y": y}


@case
def syncbn_grads(rank, world, mesh, inputs):
    """dx, dγ, dβ of this rank's loss Σ y³ (dγ, dβ this rank's own)."""
    from apex_tpu_torch import parallel
    x, scale, bias = syncbn_inputs("grads", world)
    xs, s, b = (t(shard(x, rank, world), True), t(scale, True),
                t(bias, True))
    y, *_ = parallel.sync_batch_norm(xs, s, b, axis_name="data")
    dx, ds, db = torch.autograd.grad(torch.sum(y ** 3), (xs, s, b))
    return {"dx": dx, "dscale": ds, "dbias": db}


@case
def syncbn_module(rank, world, mesh, inputs):
    from apex_tpu_torch import parallel
    (x,) = syncbn_inputs("module", world)
    bn = parallel.SyncBatchNorm(3, axis_name="data", momentum=0.5,
                                device="cpu")
    stats = {}
    y = bn(t(shard(x, rank, world)), train=True, stats=stats)
    mean, var = stats[bn]
    bn.mean.copy_(mean)
    bn.var.copy_(var)
    y_eval = bn(t(x), train=False)
    return {"y": y, "mean": mean, "var": var, "y_eval": y_eval}


@case
def syncbn_convert(rank, world, mesh, inputs):
    """flax's BatchNorm (the port's ``layers.BatchNorm``) inside
    ``convert_sync_batchnorm``: y, the new running statistics, and dx of
    this rank's loss Σ y·g."""
    from apex_tpu_torch import parallel
    from apex_tpu_torch.models.layers import BatchNorm
    x, g = syncbn_inputs("convert", world)
    bn = BatchNorm(4, momentum=0.9, device="cpu")
    xs = t(shard(x, rank, world), True)
    stats = {}
    with parallel.convert_sync_batchnorm("data"):
        y = bn(xs, train=True, stats=stats)
    (dx,) = torch.autograd.grad(torch.sum(y * t(shard(g, rank, world))),
                                (xs,))
    return {"y": y, "mean": stats[bn][0], "var": stats[bn][1], "dx": dx}


@case
def syncbn_group_bn(rank, world, mesh, inputs):
    from apex_tpu_torch import ops
    x, z = syncbn_inputs("group_bn", world)
    bn = ops.BatchNorm2d_NHWC(4, fuse_relu=True, bn_group=2,
                              world_size=world, axis_name="data",
                              device="cpu")
    stats = {}
    y = bn(t(shard(x, rank, world)), t(shard(z, rank, world)), train=True,
           stats=stats)
    return {"y": y, "mean": stats[bn][0], "var": stats[bn][1]}


# --- the fused BN unit and ConvBNAct across ranks ---------------------------
# (tests/test_torch_bn_act_dist.py, world 2)

BN_MODES = ("plain", "relu", "add", "addrelu", "fp8")


def bn_inputs(seed=0, shape=(8, 3, 3, 8)):
    """x, r, γ, β and the loss weights g of a fused-unit case."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    return ((rng.randn(*shape) * 2.0 + 0.5).astype(np.float32),
            (rng.randn(*shape) * 0.5).astype(np.float32),
            (rng.randn(c) * 0.5 + 1.0).astype(np.float32),
            (rng.randn(c) * 0.3).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def bn_mode(mode):
    """(relu, residual, fp8) of a mode of ``BN_MODES``."""
    return (mode in ("relu", "addrelu", "fp8"), mode in ("add", "addrelu"),
            mode == "fp8")


def _bn_unit(rank, world, mode, axis_name="data", groups=None):
    """The fused unit on this rank's rows, grads of this rank's Σ z·g."""
    from apex_tpu_torch.ops import bn_act as TB
    relu, res, fp8 = bn_mode(mode)
    x, r, scale, bias, g = bn_inputs()
    cfg = TB.make_cfg(relu=relu, axis_name=axis_name,
                      axis_index_groups=groups, fp8=fp8)
    args = [t(shard(x, rank, world), True)]
    if res:
        args.append(t(shard(r, rank, world), True))
    args += [t(scale, True), t(bias, True)]
    unit = TB.bn_add_act_train if res else TB.bn_act_train
    z, mean, var, count = unit(*args, cfg)
    grads = torch.autograd.grad(torch.sum(z * t(shard(g, rank, world))),
                                args)
    out = {"z": z, "mean": mean, "var": var, "count": torch.tensor(count)
           if not isinstance(count, torch.Tensor) else count,
           "dx": grads[0], "dscale": grads[-2], "dbias": grads[-1]}
    if res:
        out["dr"] = grads[1]
    return out


for _mode in BN_MODES:
    CASES[f"bnact_{_mode}"] = (
        lambda rank, world, mesh, inputs, _m=_mode: _bn_unit(rank, world, _m))


@case
def bnact_rank_groups(rank, world, mesh, inputs):
    """Stats groups of one rank each: every rank's unit is its own."""
    groups = [[i] for i in range(world)]
    return {"grouped": _bn_unit(rank, world, "addrelu", groups=groups),
            "alone": _bn_unit(rank, world, "addrelu", axis_name=None)}


@case
def bnact_unfused_local_grads(rank, world, mesh, inputs):
    """The unfused SyncBatchNorm (+ReLU) on the same rows: its dγ and dβ
    are this rank's own."""
    from apex_tpu_torch import parallel
    x, _, scale, bias, g = bn_inputs()
    xs, s, b = t(shard(x, rank, world), True), t(scale, True), t(bias, True)
    y, *_ = parallel.sync_batch_norm(xs, s, b, axis_name="data", relu=True)
    dx, ds, db = torch.autograd.grad(
        torch.sum(y * t(shard(g, rank, world))), (xs, s, b))
    return {"dx": dx, "dscale": ds, "dbias": db}


@case
def bnact_module(rank, world, mesh, inputs):
    """``FusedBNAct(axis_name="data")``: output and new running stats."""
    from apex_tpu_torch import ops
    x, r, *_ = bn_inputs()
    unit = ops.FusedBNAct(8, relu=True, momentum=0.9, axis_name="data",
                          device="cpu")
    stats = {}
    z = unit(t(shard(x, rank, world)), t(shard(r, rank, world)), train=True,
             stats=stats)
    return {"z": z, "mean": stats[unit][0], "var": stats[unit][1]}


def conv_inputs(seed=3):
    """a (8, 6, 6, 4), w (8, 4, 3, 3) in the port's layout, r, γ, β, g."""
    rng = np.random.RandomState(seed)
    return ((rng.randn(8, 6, 6, 4)).astype(np.float32),
            (rng.randn(8, 4, 3, 3) / 6.0).astype(np.float32),
            (rng.randn(8, 6, 6, 8) * 0.5).astype(np.float32),
            (rng.randn(8) * 0.5 + 1.0).astype(np.float32),
            (rng.randn(8) * 0.3).astype(np.float32),
            rng.randn(8, 6, 6, 8).astype(np.float32))


def _conv_unit(rank, world, join):
    from apex_tpu_torch.ops import conv_bn as CB
    a, w, r, scale, bias, g = conv_inputs()
    cfg = CB.make_conv_cfg(relu=True, axis_name="data")
    args = [t(shard(a, rank, world), True), t(w, True)]
    if join:
        args.append(t(shard(r, rank, world), True))
    args += [t(scale, True), t(bias, True)]
    unit = CB.conv_bn_add_act_train if join else CB.conv_bn_act_train
    z, mean, var, count = unit(*args, cfg)
    grads = torch.autograd.grad(torch.sum(z * t(shard(g, rank, world))),
                                args)
    names = ["da", "dw"] + (["dr"] if join else []) + ["dscale", "dbias"]
    return {"z": z, "mean": mean, "var": var, "count": count,
            **dict(zip(names, grads))}


CASES["conv_relu"] = lambda rank, world, mesh, inputs: _conv_unit(
    rank, world, False)
CASES["conv_addrelu"] = lambda rank, world, mesh, inputs: _conv_unit(
    rank, world, True)


# --- DDP and the gradient sync (tests/test_torch_parallel.py, world 2) ------

def _collectives():
    from apex_tpu_torch import parallel
    return sum(parallel.collective_counts.values())


@case
def dp_sync_knobs(rank, world, mesh, inputs):
    from apex_tpu_torch import parallel
    x = float(rank + 1)
    out = {
        "average": parallel.sync_gradients(
            {"w": x * torch.ones(4, 128)}, "data")["w"],
        "predivide": parallel.sync_gradients(
            {"w": torch.tensor([x])}, "data",
            gradient_predivide_factor=2.0)["w"],
        "sum": parallel.sync_gradients({"w": torch.ones(1)}, "data",
                                       gradient_average=False)["w"]}
    g = torch.tensor([[1.0, 1 + 1 / 256][rank]]).bfloat16()
    s = parallel.sync_gradients({"w": g}, "data",
                                allreduce_always_fp32=True)["w"]
    out["fp32_dtype"] = str(s.dtype)
    out["fp32"] = s
    out["int_leaf"] = parallel.sync_gradients(
        {"w": torch.ones(2), "count": torch.tensor(3)}, "data")["count"]
    src = torch.full((3,), x)
    parallel.sync_gradients({"w": src}, "data")
    out["caller_grad"] = src
    out["reducer"] = parallel.Reducer("data").reduce(
        {"p": torch.tensor([float(rank)])})["p"]
    return out


def dp_regression():
    """w0 (128,), x (64, 128) of the DDP training case."""
    return (np.full(128, 0.5, np.float32),
            (np.arange(64.0 * 128).reshape(64, 128) / 1e4)
            .astype(np.float32))


@case
def dp_wrap(rank, world, mesh, inputs):
    """One DDP step on each rank's half of the batch, wrapped by
    ``ddp.wrap``, and the same through ``wrap_grad_fn``."""
    from apex_tpu_torch import parallel
    ddp = parallel.DistributedDataParallel(mesh)
    w0, x = (t(a) for a in dp_regression())
    lr = 0.1

    def grad_fn(w, xb):
        wg = w.clone().requires_grad_(True)
        loss = torch.mean(torch.square(xb @ wg))
        return loss, {"w": torch.autograd.grad(loss, wg)[0]}

    def step(w, xb):
        loss, g = grad_fn(w, xb)
        return w - lr * ddp.sync(g)["w"], ddp.pmean(loss)

    w, loss = ddp.wrap(step)(w0, x)
    with parallel.use_mesh(mesh):
        loss2, g2 = ddp.wrap_grad_fn(grad_fn)(w0, shard(x, rank, world))
    return {"w": w, "loss": loss, "w_grad_fn": w0 - lr * g2["w"]}


@case
def dp_no_sync(rank, world, mesh, inputs):
    from apex_tpu_torch import parallel
    ddp = parallel.DistributedDataParallel(mesh)
    g = {"g": torch.tensor([float(rank)])}
    before = _collectives()
    with ddp.no_sync():
        raw = ddp.sync(g)["g"]
    issued = _collectives() - before
    return {"raw": raw, "synced": ddp.sync(g)["g"],
            "no_sync_collectives": issued}


@case
def dp_flat_and_delay(rank, world, mesh, inputs):
    """``flat_all_reduce`` of an arena buffer; ``delay_allreduce`` (one
    all-reduce per dtype) against the per-tensor sync."""
    from apex_tpu_torch import parallel
    buf = shard(torch.ones(world * 65536), rank, world)
    out = {"flat": parallel.flat_all_reduce(buf, "data")}
    k = float(rank + 1)
    tree = {"a": torch.arange(24.0).reshape(3, 8) * k,
            "b": torch.ones(5, dtype=torch.bfloat16) * k,
            "c": torch.linspace(-1, 1, 7) * k, "n": torch.arange(3)}
    for name, ddp in (("delay", parallel.DistributedDataParallel(
            mesh, delay_allreduce=True)),
            ("each", parallel.DistributedDataParallel(mesh))):
        before = _collectives()
        synced = ddp.sync(tree)
        out[name] = {**synced, "collectives": _collectives() - before}
    return out


@case
def dp_replicate(rank, world, mesh, inputs):
    from apex_tpu_torch import parallel
    tree = {"w": torch.full((4,), float(rank)),
            "f": torch.tensor([-0.0 if rank == 1 else 0.0, rank + 1.5]),
            "i": torch.tensor([rank]), "b": torch.tensor([rank == 1])}
    rep = parallel.replicate(tree, mesh)
    bc = parallel.replica_broadcast(tree, "data", source=1)
    return {"replicate": rep, "broadcast": bc,
            "signbit": torch.signbit(bc["f"]),
            "pmean": parallel.DistributedDataParallel(mesh).pmean(
                torch.tensor(rank + 1.0))}


@case
def dp_mesh(rank, world, mesh, inputs):
    from apex_tpu_torch import parallel
    from apex_tpu_torch.parallel import mesh as M
    out = {"size": parallel.axis_size("data"),
           "index": parallel.axis_index("data"),
           "local_batch": parallel.local_batch(8, mesh)}
    for name, fn, exc in (
            ("odd_batch", lambda: parallel.local_batch(7, mesh), ValueError),
            ("bad_size", lambda: parallel.make_mesh([("data", 3)], "cpu"),
             ValueError),
            ("two_free", lambda: parallel.make_mesh(
                [("data", -1), ("model", -1)], "cpu"), ValueError),
            ("unbound", lambda: parallel.resolve_group("model"), NameError)):
        try:
            fn()
            out[name] = "no error"
        except exc as e:
            out[name] = type(e).__name__
    with parallel.use_mesh(None):
        try:
            parallel.resolve_group("data")
            out["outside"] = "no error"
        except NameError:
            out["outside"] = "NameError"
    h = parallel.hierarchical_data_mesh(1, "cpu")
    out["hier"] = [h.size(0), h.size(1)]
    out["hier_names"] = list(h.mesh_dim_names)
    g1 = M.axis_groups(mesh, "data", [[0], [1]])
    out["groups_cached"] = g1 is M.axis_groups(mesh, "data", ((0,), (1,)))
    import torch.distributed as dist
    out["group_size"] = dist.get_world_size(g1)
    return out


# --- bucketed and compressed all-reduce (tests/test_torch_comm.py) ----------

def grad_tree():
    """numpy leaves of the comm cases: two f32, one bf16 (drawn in f32 and
    rounded by each side), one integer."""
    rng = np.random.RandomState(0)
    return {"a": rng.randn(300, 7).astype(np.float32),
            "b": rng.randn(513).astype(np.float32),
            "c": rng.randn(40, 5).astype(np.float32),
            "n": np.arange(3)}


def _scaled_tree(rank):
    k = float(rank + 1)
    tree = grad_tree()
    return {"a": t(tree["a"]) * k, "b": t(tree["b"]) * k,
            "c": t(tree["c"]).bfloat16() * torch.tensor(k).bfloat16(),
            "n": t(tree["n"])}


@case
def comm_exact(rank, world, mesh, inputs):
    from apex_tpu_torch import parallel
    from apex_tpu_torch.parallel import comm
    g = _scaled_tree(rank)
    k = float(rank + 1)
    w = {"w": torch.full((64,), k)}
    r = comm.init_residual(w)
    out, r2 = comm.bucketed_all_reduce(w, "data", residual=r)
    return {"bucketed": comm.bucketed_all_reduce(g, "data", message_size=600),
            "plain": parallel.sync_gradients(g, "data"),
            "predivide": comm.bucketed_all_reduce(
                w, "data", message_size=32,
                gradient_predivide_factor=2.0)["w"],
            "sum": comm.bucketed_all_reduce(
                {"w": torch.ones(64)}, "data",
                gradient_average=False)["w"],
            "residual_out": out["w"], "residual": r2["w"]}


@case
def comm_bf16(rank, world, mesh, inputs):
    from apex_tpu_torch.parallel import comm
    tree = grad_tree()
    k = float(rank + 1)
    close = comm.bucketed_all_reduce(
        {"a": t(tree["a"]) * k, "b": t(tree["b"])}, "data",
        message_size=600, compress="bf16")
    a = {"a": t(tree["a"])}
    _, r2 = comm.bucketed_all_reduce(a, "data", compress="bf16",
                                     residual=comm.init_residual(a))
    g_val = 1.0 + 1.0 / 512.0            # bf16 rounds it away every step
    r = torch.zeros(256)
    total = torch.zeros(256, dtype=torch.float64)
    for _ in range(8):
        out, rr = comm.bucketed_all_reduce(
            {"w": torch.full((256,), g_val)}, "data", compress="bf16",
            residual={"w": r})
        r = rr["w"]
        total += out["w"].double()
    plain = comm.bucketed_all_reduce({"w": torch.full((256,), g_val)},
                                     "data", compress="bf16")["w"]
    return {"close": close, "residual": r2["a"],
            "err_ef": abs(float(total[0]) / 8 - g_val),
            "err_plain": abs(float(plain[0]) - g_val)}


def int8_targets(world):
    return (np.random.RandomState(7).randn(world, 512) * 3.0).astype(
        np.float32)


@case
def comm_int8(rank, world, mesh, inputs):
    """The int8 all-reduce of a tree, and 30 steps of data-parallel GD on
    0.5‖w − t_rank‖² exact, int8 with error feedback and int8 without."""
    from apex_tpu_torch.parallel import comm
    tree = grad_tree()
    close = comm.bucketed_all_reduce(
        {"a": t(tree["a"]) * float(rank + 1)}, "data", compress="int8")
    target = t(int8_targets(world)[rank])
    ws = {}
    for name, compress, ef in (("exact", None, False), ("ef", "int8", True),
                               ("int8", "int8", False)):
        w, r = torch.zeros(512), torch.zeros(512)
        for _ in range(30):
            g = {"w": w - target}
            if ef:
                out, rr = comm.bucketed_all_reduce(
                    g, "data", compress=compress, residual={"w": r})
                r = rr["w"]
            else:
                out = comm.bucketed_all_reduce(g, "data", compress=compress)
            w = w - 0.4 * out["w"]
        ws[name] = w
    return {"close": close["a"], **ws}


@case
def comm_ddp(rank, world, mesh, inputs):
    from apex_tpu_torch import parallel
    g = _scaled_tree(rank)
    bucketed = parallel.DistributedDataParallel(
        mesh, bucket_allreduce=True, message_size=600)
    ddp = parallel.DistributedDataParallel(mesh, compress="bf16")
    vals = torch.linspace(0.1, 1.7, 128)
    out, r2 = ddp.sync({"w": vals}, residual=ddp.init_residual({"w": vals}))
    x = {"w": float(rank) * torch.ones(16)}
    with ddp.no_sync():
        raw, r3 = ddp.sync(x, residual=ddp.init_residual(x))
    exact = parallel.DistributedDataParallel(mesh)
    r4 = {"w": torch.full((16,), 7.0)}
    _, r5 = exact.sync(x, residual=r4)
    return {"bucketed": bucketed.sync(g),
            "default": parallel.DistributedDataParallel(mesh).sync(g),
            "roundtrip": out["w"], "roundtrip_residual": r2["w"],
            "no_sync": raw["w"], "no_sync_residual": r3["w"],
            "exact_residual_is_passed": r5["w"] is r4["w"]}


# --- BASELINE configuration 3 at a structural size ---------------------------
# (tests/test_torch_resnet_dist.py, world 2)

RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 8, 32, 10


def _resnet(fused, opt_level):
    from apex_tpu_torch import models
    return models.ResNet(
        stage_sizes=[1, 1], num_classes=RESNET_CLASSES, width=8,
        dtype=None if opt_level == "O0" else torch.bfloat16, fused_bn=fused,
        bn_axis_name="data", device="cpu")


def _resnet_case(rank, world, mesh, inputs, fused, opt_level):
    """``train.build_resnet_step(bn_axis_name="data")`` over the JAX
    weights: the first step's loss, synced grads and new statistics
    through ``Amp.backward`` + ``sync_gradients``, then two steps' losses
    through the step itself."""
    from torch.func import functional_call
    from apex_tpu_torch import amp, ops, parallel, train
    from apex_tpu_torch.optim import FusedSGD
    params, bstats = inputs[f"{'fused' if fused else 'unfused'}"]
    model = _resnet(fused, opt_level)
    model.load_state_dict({**params, **bstats})
    step, (state, bs), (x, y), policy, _ = train.build_resnet_step(
        RESNET_BATCH, RESNET_SIZE, opt_level=opt_level, device="cpu",
        model=model, bn_axis_name="data")
    amp_opt = amp.Amp(policy, FusedSGD(lr=0.1, momentum=0.9))

    def loss_fn(mp):
        logits, new = functional_call(model, {**mp, **bs}, (x,),
                                      {"train": True})
        return torch.mean(ops.softmax_cross_entropy_loss(logits, y)), new

    (loss, new_bs), grads, _, _ = amp_opt.backward(state, loss_fn,
                                                   has_aux=True)
    with parallel.use_mesh(mesh):
        synced = parallel.sync_gradients(grads, "data")
    losses = []
    for _ in range(2):
        state, bs, step_loss = step(state, bs, x, y)
        losses.append(step_loss)
    return {"loss": loss, "grads": synced, "bstats": new_bs,
            "losses": torch.stack(losses), "x": x, "y": y}


for _fused in (True, False):
    for _level in ("O0", "O2"):
        CASES[f"resnet_{'fused' if _fused else 'unfused'}_{_level}"] = (
            lambda rank, world, mesh, inputs, _f=_fused, _l=_level:
            _resnet_case(rank, world, mesh, inputs, _f, _l))


# --- ZeRO (tests/test_torch_zero.py: 4 ranks, a 2x2 data_inter x data_intra
# mesh; world-2 cases run over data_intra, two groups of two) ---------------

def zero_inputs(seed, world):
    """(params, [grads of linear rank r]): the JAX package's
    ``tests/test_distributed_optimizers.py`` sizes (~720k elements, so
    every 65536-aligned shard of up to 8 holds content), keys sorted so both
    packages lay the arena out alike."""
    rng = np.random.RandomState(seed)
    params = {"w1": rng.randn(600, 1200).astype(np.float32),
              "w2": rng.randn(257).astype(np.float32),
              "w3": rng.randn(8, 4, 2).astype(np.float32)}
    grads = [{k: (rng.randn(*p.shape) * 0.1).astype(np.float32)
              for k, p in params.items()} for _ in range(world)]
    return params, grads


#: (case, optimizer, seed, steps, options) of the world-2 and world-4 runs
ZERO_RUNS = {
    "adam": ("adam", 0, 3, dict(lr=1e-2, weight_decay=0.01)),
    "adam_clip": ("adam", 1, 2, dict(lr=1e-2, max_grad_norm=0.05)),
    "adam_gather_bf16": ("adam", 2, 1, dict(
        lr=1e-2, param_gather_dtype="bfloat16")),
    "adam_scatter_bf16": ("adam", 6, 1, dict(
        lr=1e-2, grad_scatter_dtype="bfloat16")),
    "lamb": ("lamb", 4, 3, dict(lr=1e-2, weight_decay=0.01,
                                max_grad_norm=1.0)),
    "lamb_gather_bf16": ("lamb", 7, 2, dict(
        lr=1e-2, weight_decay=0.01, param_gather_dtype="bfloat16")),
}
ZERO_RUNS_W4 = ("adam", "lamb")


def zero_opt(kind, axis_name, options, torch_dtype):
    """The port's ZeRO optimizer (``torch_dtype`` maps dtype names)."""
    from apex_tpu_torch.optim import DistributedFusedAdam, DistributedFusedLAMB
    kw = {k: (torch_dtype(v) if k.endswith("_dtype") else v)
          for k, v in options.items()}
    cls = DistributedFusedAdam if kind == "adam" else DistributedFusedLAMB
    return cls(axis_name=axis_name, **kw)


def _zero_run(name, axis, world, me):
    from apex_tpu_torch import parallel
    kind, seed, steps, options = ZERO_RUNS[name]
    params, grads = zero_inputs(seed, world)
    opt = zero_opt(kind, axis, options, lambda n: getattr(torch, n))
    p = {k: t(v) for k, v in params.items()}
    parallel.reset_collective_counts()
    state = opt.init(p)
    for _ in range(steps):
        p, state = opt.step({k: t(v) for k, v in grads[me].items()}, state,
                            p)
    return {"params": p, "count": state.count,
            "slots": {s: state.slots[s]["float32"] for s in state.slots},
            "collectives": dict(parallel.collective_counts)}


@case
def zero_world2(rank, world, mesh, inputs):
    from apex_tpu_torch import parallel
    me = parallel.axis_index("data_intra")
    return {name: _zero_run(name, "data_intra", 2, me) for name in ZERO_RUNS}


@case
def zero_world4(rank, world, mesh, inputs):
    from apex_tpu_torch import parallel
    flat = parallel.make_mesh([("data", 4)], "cpu")
    with parallel.use_mesh(flat):
        return {name: _zero_run(name, "data", 4, rank)
                for name in ZERO_RUNS_W4}


@case
def zero_axis_tuple(rank, world, mesh, inputs):
    """One Adam step over ("data_inter", "data_intra"): the rank's linear
    index and master shard at init (global rank g must own tile g), and the
    params after the step."""
    import torch.distributed as dist
    from apex_tpu_torch import parallel
    from apex_tpu_torch.optim import DistributedFusedAdam
    axes = ("data_inter", "data_intra")
    params, grads = zero_inputs(3, 4)
    opt = DistributedFusedAdam(lr=1e-2, axis_name=axes)
    p = {k: t(v) for k, v in params.items()}
    state = opt.init(p)
    me = parallel.linear_index(axes)
    shard0 = state.slots["master"]["float32"].clone()
    p, state = opt.step({k: t(v) for k, v in grads[me].items()}, state, p)
    return {"global_rank": dist.get_rank(), "linear_rank": me,
            "world": parallel.axes_size(axes), "shard0": shard0, "params": p}


@case
def zero_skip_and_layout(rank, world, mesh, inputs):
    """``Amp.apply_gradients`` over a ShardedOptState with a device flag:
    False leaves params, slots and counts as they were, True steps; and
    ``state_bytes`` / ``checkpoint_layout``."""
    from apex_tpu_torch import amp, parallel
    from apex_tpu_torch.optim import DistributedFusedLAMB
    params, grads = zero_inputs(5, 2)
    me = parallel.axis_index("data_intra")
    opt = DistributedFusedLAMB(lr=1e-2, axis_name="data_intra")
    app = amp.Amp(amp.Policy.from_opt_level("O0"), opt)
    state = app.init({k: t(v) for k, v in params.items()})
    g = {k: t(v) for k, v in grads[me].items()}
    skipped = app.apply_gradients(state, g, torch.tensor(False))
    stepped = app.apply_gradients(state, g, torch.tensor(True))
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves_of(skipped), tree_leaves_of(state)))
    return {"skip_same": same, "skip_step": skipped.step,
            "skip_count": skipped.opt_state.count,
            "step_step": stepped.step, "step_count": stepped.opt_state.count,
            "stepped_params": stepped.params,
            "state_bytes": {w: opt.state_bytes(params, world=w)
                            for w in (1, 2, 8)},
            "layout": opt.checkpoint_layout(params)}


def tree_leaves_of(tree):
    from apex_tpu_torch.utils import tree_leaves
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


# a structural BERT for the ZeRO step (tests/test_torch_zero.py)
ZB_VOCAB, ZB_HIDDEN, ZB_LAYERS, ZB_HEADS, ZB_SEQ, ZB_LOCAL = \
    1000, 128, 2, 2, 64, 2


def zero_bert_batch(world):
    rng = np.random.RandomState(0)
    shape = (world * ZB_LOCAL, ZB_SEQ)
    return rng.randint(0, ZB_VOCAB, shape), rng.randint(0, ZB_VOCAB, shape)


def _zero_bert_encoder(inputs):
    from apex_tpu_torch import models
    enc = models.BertEncoder(ZB_VOCAB, hidden=ZB_HIDDEN, layers=ZB_LAYERS,
                             heads=ZB_HEADS, max_len=ZB_SEQ, device="cpu")
    enc.load_state_dict(inputs["bert"])
    return enc


@case
def zero_bert_o0(rank, world, mesh, inputs):
    """One O0 f32 step of the structural BERT through ``Amp`` and
    ``DistributedFusedLAMB`` over data_intra, each rank on its rows of the
    global batch, the loss outside ``auto_cast``."""
    from apex_tpu_torch import amp, models, parallel
    from apex_tpu_torch.optim import DistributedFusedLAMB
    enc = _zero_bert_encoder(inputs)
    me = parallel.axis_index("data_intra")
    toks, labels = (t(shard(a, me, 2)) for a in zero_bert_batch(2))
    app = amp.Amp(amp.Policy.from_opt_level("O0"),
                  DistributedFusedLAMB(lr=1e-3, axis_name="data_intra"))
    state = app.init(dict(enc.named_parameters()))
    loss, grads, state, finite = app.backward(
        state, lambda mp: models.mlm_loss(enc, mp, toks, labels))
    state = app.apply_gradients(state, grads, finite)
    return {"loss": loss, "params": state.params, "count":
            state.opt_state.count}


@case
def zero_bert_main_path(rank, world, mesh, inputs):
    """``train.build_bert_step(optimizer=DistributedFusedLAMB(lr=1e-3))``
    (O1 bf16) inside ``use_mesh`` of a mesh whose ``data`` axis pairs the
    ranks: 2 steps on the same batch everywhere; the losses, params and the
    collectives of a step, and the same 2 steps with
    ``FusedLAMB(strategy="arena")`` in the same process."""
    from apex_tpu_torch import parallel, train
    from apex_tpu_torch.optim import DistributedFusedLAMB, FusedLAMB
    pairs = parallel.make_mesh([("pair", 2), ("data", 2)], "cpu")
    out = {}
    for name, opt in (("zero", DistributedFusedLAMB(lr=1e-3)),
                      ("arena", FusedLAMB(lr=1e-3, strategy="arena"))):
        enc = _zero_bert_encoder(inputs)
        with parallel.use_mesh(pairs):
            step, state, (toks, labels), _, _ = train.build_bert_step(
                ZB_LOCAL, ZB_SEQ, encoder=enc, device="cpu", vocab=ZB_VOCAB,
                optimizer=opt)
            losses = []
            for _ in range(2):
                parallel.reset_collective_counts()
                state, loss = step(state, toks, labels)
                losses.append(loss)
        out[name] = {"losses": torch.stack(losses), "params": state.params,
                     "step": state.step,
                     "collectives": dict(parallel.collective_counts)}
    return out


# --- the hierarchical sync (tests/test_torch_hierarchy.py: 4 ranks on the
# 2x2 data_inter x data_intra mesh) -------------------------------------------

#: link rates both packages plan with in the parity tests (bytes/s): any
#: numbers do; these are not a card's
HIER_LINKS = {"ici": 4.5e11, "dcn": 2.5e10}


def hier_plan(dtype, spec="dp2x2", grad_bytes=1 << 20, **kw):
    """The port's plan with every hop's wire dtype forced to ``dtype``."""
    from apex_tpu_torch.lint.mesh_model import parse_mesh_spec
    from apex_tpu_torch.parallel import hierarchy
    return hierarchy.plan_comm(
        parse_mesh_spec(spec, link_bytes_per_s=HIER_LINKS), grad_bytes,
        dtypes=(dtype,), **kw)


def _hier_tree(s):
    tree = grad_tree()
    return {"a": t(tree["a"]) * float(s + 1), "b": t(tree["b"]),
            "n": t(tree["n"])}


@case
def hier_sync(rank, world, mesh, inputs):
    """Per wire dtype: the sync of a tree (bucketed at 600 elements) scaled
    by the linear rank, and one step with a residual of the rank's own."""
    from apex_tpu_torch import parallel
    from apex_tpu_torch.parallel import hierarchy
    s = rank        # linear rank on the row-major 2x2 mesh
    out = {}
    for dt in (None, "bf16", "int8"):
        plan = hier_plan(dt)
        parallel.reset_collective_counts()
        synced = hierarchy.hierarchical_sync(_hier_tree(s), plan,
                                             message_size=600)
        counts = dict(parallel.collective_counts)
        g = {"a": _hier_tree(s)["a"]}
        r = {"a": torch.full_like(g["a"], 0.01 * (s + 1))}
        ef, r2 = hierarchy.hierarchical_sync(g, plan, residual=r)
        out[str(dt)] = {"synced": synced, "counts": counts, "ef": ef["a"],
                        "residual": r2["a"]}
    return out


@case
def hier_trajectory(rank, world, mesh, inputs):
    """30 steps of data-parallel GD on 0.5‖w − t_rank‖², every gradient
    through both int8 hops with error feedback (block 64), and exact."""
    from apex_tpu_torch import parallel
    from apex_tpu_torch.parallel import hierarchy
    target = t(int8_targets(4)[rank])
    plan = hier_plan("int8", grad_bytes=512 * 4, compress_block=64)
    ws = {}
    for hier in (True, False):
        w, r = torch.zeros(512), torch.zeros(512)
        for _ in range(30):
            g = {"w": w - target}
            if hier:
                out, rr = hierarchy.hierarchical_sync(g, plan,
                                                      residual={"w": r})
                r = rr["w"]
            else:
                out = parallel.sync_gradients(g, "data_intra")
                out = parallel.sync_gradients(out, "data_inter")
            w = w - 0.4 * out["w"]
        ws["ef" if hier else "exact"] = w
    return ws


@case
def hier_ddp_and_pmean(rank, world, mesh, inputs):
    """DDP with a hierarchical plan (synced values, residual, pmean,
    world size, axis names) and with a flat bf16 plan over a flat mesh of
    the four ranks."""
    from apex_tpu_torch import parallel
    plan = hier_plan("int8")
    ddp = parallel.DistributedDataParallel(mesh, comm_plan=plan)
    vals = torch.linspace(0.1, 1.7, 640)
    out, r2 = ddp.sync({"w": vals}, residual=ddp.init_residual({"w": vals}))
    flat_mesh = parallel.make_mesh([("data", 4)], "cpu")
    flat = parallel.DistributedDataParallel(
        flat_mesh, comm_plan=hier_plan("bf16", spec="ici4"))
    x = torch.tensor(float(rank + 1))
    parallel.reset_collective_counts()
    pm = ddp.pmean(x)
    pm_counts = dict(parallel.collective_counts)
    return {"world": ddp.world_size, "axis": list(ddp.axis_name),
            "synced": out["w"], "residual": r2["w"], "pmean": pm,
            "pmean_counts": pm_counts,
            "flat": flat.sync(_hier_tree(rank)),
            "flat_axis": flat.axis_name}


# --- ring and Ulysses attention (tests/test_torch_ring.py: 4 ranks on one
# ``seq`` axis; world-2 cases pair them on a ("pair", "seq") mesh) ----------

def ring_qkv(seed, b, s, h, d):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))


#: (seed, B, S per rank, H, D, options) of the ring runs
RING_RUNS = {
    "plain": (0, 2, 32, 2, 32, dict()),
    "causal": (1, 2, 32, 2, 32, dict(causal=True)),
    "dropout": (3, 1, 512, 2, 64, dict(dropout_rate=0.3, dropout_seed=1234)),
    "dropout_causal": (4, 1, 512, 2, 64, dict(causal=True, dropout_rate=0.25,
                                              dropout_seed=77)),
    "dropout_multiblock": (8, 1, 1024, 2, 64, dict(
        causal=True, dropout_rate=0.3, dropout_seed=55)),
}
ULYSSES_RUNS = {
    "plain": (2, 2, 32, 8, 16, dict()),
    "causal": (5, 2, 32, 8, 16, dict(causal=True)),
}


def _seq_run(fn, run, world, me):
    """(o, dq, dk, dv) of this rank's shard for the loss sum(sin(o))."""
    seed, b, s, h, d, options = run
    q, k, v = (t(shard(a.transpose(1, 0, 2, 3), me, world)
                 .transpose(1, 0, 2, 3), requires_grad=True)
               for a in ring_qkv(seed, b, s * world, h, d))
    o = fn(q, k, v, "seq", **options)
    torch.sin(o).sum().backward()
    return {"o": o, "dq": q.grad, "dk": k.grad, "dv": v.grad}


def _seq_mesh(world):
    from apex_tpu_torch import parallel
    if world == 4:
        return parallel.make_mesh([("seq", 4)], "cpu")
    return parallel.make_mesh([("pair", 4 // world), ("seq", world)], "cpu")


@case
def ring_runs(rank, world, mesh, inputs):
    from apex_tpu_torch import parallel
    out = {}
    for w in (2, 4):
        with parallel.use_mesh(_seq_mesh(w)):
            me = parallel.axis_index("seq")
            for name, run in RING_RUNS.items():
                if w == 4 and name.startswith("dropout"):
                    continue
                parallel.reset_collective_counts()
                res = _seq_run(parallel.ring_attention, run, w, me)
                res["collectives"] = dict(parallel.collective_counts)
                out[f"{name}/{w}"] = res
            for name, run in ULYSSES_RUNS.items():
                parallel.reset_collective_counts()
                res = _seq_run(parallel.ulysses_attention, run, w, me)
                res["collectives"] = dict(parallel.collective_counts)
                out[f"ulysses_{name}/{w}"] = res
    return out


@case
def ring_dtypes_and_refusals(rank, world, mesh, inputs):
    """The ring's output dtype at axis size 1 (q's) and 2 (f32), and its
    refusal of dropout on shards that are not 512-multiples."""
    from apex_tpu_torch import parallel
    q, k, v = (t(a[:, :16]).bfloat16() for a in ring_qkv(6, 1, 16, 2, 64))
    out = {}
    for w in (1, 2):
        m = parallel.make_mesh([("pair", 4 // w), ("seq", w)], "cpu")
        with parallel.use_mesh(m):
            out[f"dtype/{w}"] = str(parallel.ring_attention(
                q, k, v, "seq").dtype)
            try:
                parallel.ring_attention(q, k, v, "seq", dropout_rate=0.1,
                                        dropout_seed=0)
                out[f"unaligned/{w}"] = "no error"
            except ValueError as e:
                out[f"unaligned/{w}"] = str(e)
    return out


# --- integrity: fingerprint, vote, repair ----------------------------------------

def integrity_inputs(seed=0):
    """A small mixed tree: f32, bf16 (as f32 values) and an int leaf."""
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(33, 5).astype(np.float32),
            "b": rng.randn(7).astype(np.float32),
            "c": rng.randint(-4, 4, (3,)).astype(np.int32)}


@case
def integrity_flip_repair(rank, world, mesh, inputs):
    """Every step fingerprints and compares; after step 1 chaos flips a
    mantissa bit of rank 2's first leaf; step 2's check flags it on every
    rank, the guard skips, the vote names rank 2, ``repair`` broadcasts the
    majority's bits and the re-verify agrees; step 3's check is clean."""
    from apex_tpu_torch import guard, parallel
    params = {k: torch.tensor(v) for k, v in inputs["params"].items()}
    params["b"] = params["b"].to(torch.bfloat16)
    icfg = guard.IntegrityConfig()
    ist = guard.integrity_init(icfg, world=world, device="cpu")
    gcfg = guard.GuardConfig(window=4, min_history=2)
    gs = guard.guard_init(gcfg, device="cpu")
    plan = guard.FaultPlan([guard.Fault(1, "params", "bitflip_mantissa",
                                        rank=2, arg=3)])
    harness = guard.ChaosHarness(plan, rank=rank)
    pol = guard.GuardPolicy()
    parallel.reset_collective_counts()
    out = {"fps": [], "divergent": [], "skipped": []}
    for step in range(4):
        ist = guard.integrity_check(ist, icfg, params)
        gs = guard.guard_observe(gs, gcfg, loss=1.0, grad_norm=1.0,
                                 params=params,
                                 replica_ok=guard.integrity_ok(ist))
        out["fps"].append(ist.rank_fps.clone())
        out["divergent"].append(bool(ist.divergent))
        out["skipped"].append(not bool(guard.guard_ok(gs, gcfg)))
        act = pol.update_integrity(step, ist)
        if act.kind == "repair":
            out["flipped"] = {k: v.clone() for k, v in params.items()}
            out["minority"] = list(pol.last_vote.minority)
            params, ok = pol.repair(step, params,
                                    repair_fn=guard.make_repair_fn(),
                                    verify_fn=guard.make_verify_fn())
            out["verified"] = ok
            ist = guard.absorb_verify(ist, *pol.last_verify)
            out["absorbed"] = ist.rank_fps.clone()
        params = harness.post_step(step, params)
    out["params"] = {k: v.view(torch.int16) if v.dtype == torch.bfloat16
                     else v for k, v in params.items()}
    out["flipped"] = {k: v.view(torch.int16) if v.dtype == torch.bfloat16
                      else v for k, v in out["flipped"].items()}
    out["check_count"] = int(ist.check_count)
    out["mismatch_count"] = int(ist.mismatch_count)
    out["collectives"] = dict(parallel.collective_counts)
    return out
