"""apex_tpu_torch stands alone: no JAX and nothing of apex_tpu.

Importing the port (every module of it, the checkpoint, guard, utils,
data, cluster, trace and monitor modules named) in a fresh interpreter
leaves no ``jax``, ``ml_dtypes``, ``apex_tpu`` or ``PIL`` module in
``sys.modules``
(the port decodes JPEGs with its own codec); an AST scan of its
sources, of ``chip_smoke.py``, of its scripts (``scripts/torch_*.py``) and
of the rank bodies its multi-process tests spawn
(``tests/_torch_parallel_cases.py``) and of the L1 grid's runner that
``chip_smoke.py`` loads (``tests/_torch_l1_grid.py``) finds no such
import; and its entry points ask for ``cuda`` unless the caller passes a
device.
"""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "apex_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def _forbidden(name: str, package: bool = False) -> bool:
    """``package``: the port's own modules, which import no PIL either."""
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "ml_dtypes",
                   "apex_tpu") or (package and top == "PIL")


def test_import_leaves_no_jax_or_apex_tpu():
    names = [m for _, m in _modules()]
    code = ("import importlib, json, sys\n"
            f"for m in {names!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=str(PKG.parent)).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert "apex_tpu_torch.train" in loaded
    for pkg in ("ckpt.format", "ckpt.snapshot", "ckpt.elastic",
                "ckpt.manager", "ckpt.escalate", "guard.detect",
                "guard.integrity", "guard.chaos", "guard.policy",
                "utils.fsio", "utils.backoff", "utils.bits", "utils.ranks",
                "data", "data.jpeg", "data.resample", "data.pipeline",
                "data.packed", "data.__main__", "cluster",
                "cluster.membership", "cluster.coordinator", "trace",
                "trace.straggler", "trace.spans", "trace.debug_nans",
                "trace.recorder", "trace.watchdog", "trace.podview",
                "monitor", "monitor.metrics", "monitor.sinks",
                "monitor.logger", "monitor.goodput",
                "monitor.collectives"):
        assert f"apex_tpu_torch.{pkg}" in loaded
    assert [m for m in loaded if _forbidden(m, package=True)] == []


def _sources():
    yield from _modules()
    for path in [ROOT / "chip_smoke.py",
                 ROOT / "tests" / "_torch_parallel_cases.py",
                 ROOT / "tests" / "_torch_l1_grid.py",
                 *sorted((ROOT / "scripts").glob("torch_*.py"))]:
        yield path, str(path.relative_to(ROOT))


@pytest.mark.parametrize("path", [p for p, _ in _sources()],
                         ids=[m for _, m in _sources()])
def test_sources_import_no_jax_or_apex_tpu(path):
    tree = ast.parse(path.read_text())
    package = PKG in path.parents
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names
                    if _forbidden(a.name, package)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0 and _forbidden(node.module, package):
                bad.append(node.module)
    assert bad == []


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a device the model and the step ask for cuda, which this
    check makes unavailable: they raise instead of running on the CPU."""
    from apex_tpu_torch import models, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train.build_bert_step(2, 8)
    enc = models.BertEncoder(50, hidden=16, layers=1, heads=2, max_len=8,
                             device="cpu")
    step, state, (toks, _), _, _ = train.build_bert_step(
        2, 8, encoder=enc, device="cpu")
    assert toks.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in state.params.values())


def test_resnet_entry_points_default_to_cuda(monkeypatch):
    from apex_tpu_torch import models, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train.build_resnet_step(2, 16)
    model = models.ResNet(stage_sizes=[1], num_classes=4, width=4,
                          dtype=torch.bfloat16, device="cpu")
    step, (state, bstats), (x, y), _, _ = train.build_resnet_step(
        2, 16, model=model, device="cpu")
    assert x.device.type == "cpu" and x.dtype == torch.bfloat16
    state, bstats, loss = step(state, bstats, x, y)
    assert int(state.step) == 1 and torch.isfinite(loss)
    assert all(t.device.type == "cpu" for t in bstats.values())


def test_dcgan_entry_points_and_dense_default_to_cuda(monkeypatch):
    """``build_dcgan_step``, ``Generator``, ``Discriminator`` and ``Dense``
    ask for cuda when no device is given; with ``device="cpu"`` the DCGAN
    step runs its plain versions on the CPU."""
    import inspect

    from apex_tpu_torch import models, train

    for fn in (train.build_dcgan_step, models.Generator, models.Discriminator,
               models.Dense, models.Conv, models.ConvTranspose,
               models.BatchNorm):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train.build_dcgan_step(2)
    for make in (lambda: models.Generator(nz=4, ngf=2),
                 lambda: models.Discriminator(ndf=2),
                 lambda: models.Dense(4, 2)):
        with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
            make()
    step, (gs, ds, gbs, dbs), (z, real), _, _ = train.build_dcgan_step(
        2, device="cpu", nz=4, ngf=2, ndf=2)
    assert z.device.type == real.device.type == "cpu"
    gs, ds, gbs, dbs, losses = step(gs, ds, gbs, dbs, z, real)
    assert int(gs.step) == 1 and int(ds.step) == 2
    assert all(torch.isfinite(l) for l in losses)


def test_attention_modules_and_dropout_path_default_to_cuda(monkeypatch):
    """``SelfMultiheadAttn``, ``EncdecMultiheadAttn`` and the published
    BERT path (``build_bert_step(..., dropout=0.1, padded=True)``) ask for
    cuda when no device is given; with ``device="cpu"`` the path runs a step
    of its plain versions on the CPU, drawing its dropout seeds from a CPU
    generator."""
    import inspect

    from apex_tpu_torch import models, ops, train

    for fn in (ops.SelfMultiheadAttn, ops.EncdecMultiheadAttn,
               train.build_bert_step):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train.build_bert_step(2, 256, dropout=0.1, padded=True)
    for make in (lambda: ops.EncdecMultiheadAttn(16, 2),
                 lambda: ops.SelfMultiheadAttn(16, 2)):
        with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
            make()
    enc = models.BertEncoder(50, hidden=16, layers=1, heads=2, max_len=160,
                             dropout=0.1, device="cpu")
    step, state, (toks, labels), _, _ = train.build_bert_step(
        2, 160, encoder=enc, device="cpu", padded=True)
    assert step.generator.device.type == "cpu"
    assert step.attn_mask.device.type == toks.device.type == "cpu"
    assert bool((labels[~step.attn_mask] == -1).all())
    state, loss = step(state, toks, labels)
    assert int(state.step) == 1 and torch.isfinite(loss)


def test_mlp_and_sparsity_are_covered():
    """The fused MLP and the sparsity package are among the modules the
    import and AST checks above walk."""
    names = [m for _, m in _modules()]
    for m in ("apex_tpu_torch.ops.mlp", "apex_tpu_torch.sparsity",
              "apex_tpu_torch.sparsity.asp",
              "apex_tpu_torch.sparsity.masklib"):
        assert m in names


def test_mlp_entry_points_default_to_cuda(monkeypatch):
    """``ops.MLP`` and ``train.build_mlp_step`` ask for cuda when no device
    is given; with ``device="cpu"`` the MLP step (O2, ASP around
    FusedAdam) runs its plain versions on the CPU."""
    import inspect

    from apex_tpu_torch import ops, train

    for fn in (ops.MLP, train.build_mlp_step):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train.build_mlp_step(4)
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        ops.MLP([4, 8])
    step, state, (x, t), _, model = train.build_mlp_step(
        4, (8, 16, 4), device="cpu")
    assert x.device.type == t.device.type == "cpu"
    assert x.dtype == torch.bfloat16
    state, loss = step(state, x, t)
    assert int(state.step) == 1 and torch.isfinite(loss)


def test_parallel_and_the_rank_bodies_are_covered():
    names = [m for _, m in _modules()]
    for m in ("apex_tpu_torch.parallel", "apex_tpu_torch.parallel.mesh",
              "apex_tpu_torch.parallel.distributed",
              "apex_tpu_torch.parallel.comm",
              "apex_tpu_torch.parallel.sync_batchnorm",
              "apex_tpu_torch.parallel.larc",
              "apex_tpu_torch.parallel.launch",
              "apex_tpu_torch.parallel.registry",
              "apex_tpu_torch.parallel.collectives",
              "apex_tpu_torch.ops.group_bn"):
        assert m in names
    assert "tests/_torch_parallel_cases.py" in [m for _, m in _sources()]


def test_data_parallel_entry_points_default_to_cuda(monkeypatch):
    """``build_resnet_step(bn_axis_name=...)`` asks for cuda when no
    device is given, and the meshes, SyncBatchNorm and groupbn's
    BatchNorm2d_NHWC and ``distributed_init`` default to it."""
    import inspect

    from apex_tpu_torch import ops, parallel, train

    for fn in (parallel.make_mesh, parallel.data_parallel_mesh,
               parallel.hierarchical_data_mesh, parallel.SyncBatchNorm,
               ops.BatchNorm2d_NHWC, parallel.distributed_init):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train.build_resnet_step(2, 16, bn_axis_name="data")


def test_data_parallel_mesh_without_a_process_group_raises():
    """A mesh is never started quietly: with no process group the error
    says how to start one."""
    from apex_tpu_torch import parallel

    with pytest.raises(RuntimeError, match="init_process_group"):
        parallel.data_parallel_mesh()
    with pytest.raises(RuntimeError, match="distributed_init"):
        parallel.data_parallel_mesh("cpu")


def test_zero_hierarchy_ring_and_mesh_model_are_covered():
    """ZeRO, the hierarchical sync, ring attention and the mesh model are
    among the modules the import and AST checks walk, and the probe script
    of gloo's CUDA support among the scripts."""
    names = [m for _, m in _modules()]
    for m in ("apex_tpu_torch.optim.distributed",
              "apex_tpu_torch.parallel.hierarchy",
              "apex_tpu_torch.parallel.ring",
              "apex_tpu_torch.lint", "apex_tpu_torch.lint.mesh_model"):
        assert m in names
    assert "scripts/torch_gloo_probe.py" in [m for _, m in _sources()]


def test_zero_main_path_defaults_to_cuda(monkeypatch):
    """``build_bert_step(optimizer=DistributedFusedLAMB(...))``, the ZeRO
    main path, asks for cuda when no device is given; the ZeRO optimizers
    take their devices from the params, and their state from the bound
    mesh (none bound: NameError, as JAX raises for an unbound axis)."""
    from apex_tpu_torch import models, optim, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train.build_bert_step(2, 8, optimizer=optim.DistributedFusedLAMB())
    enc = models.BertEncoder(50, hidden=16, layers=1, heads=2, max_len=8,
                             device="cpu")
    with pytest.raises(NameError, match="unbound axis name"):
        train.build_bert_step(2, 8, encoder=enc, device="cpu",
                              optimizer=optim.DistributedFusedLAMB())


def test_remainder_modules_are_scanned_and_default_to_cuda(monkeypatch):
    """The RNN stacks, weight norm and the DCGAN example's step and script
    are among the scanned sources; their entry points ask for cuda when no
    device is given."""
    import inspect

    from apex_tpu_torch import models, train
    from apex_tpu_torch.models import rnn

    scanned = {m for _, m in _sources()}
    assert {"apex_tpu_torch.models.rnn", "apex_tpu_torch.reparam",
            "apex_tpu_torch.reparam.weight_norm",
            "scripts/torch_dcgan_main_amp.py"} <= scanned
    for fn in (train.build_dcgan_example_step, rnn.StackedRNN, rnn.LSTM,
               rnn.GRU, rnn.Tanh, rnn.ReLU, rnn.mLSTM, rnn.LSTMCell):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train.build_dcgan_example_step(2)
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        models.LSTM(4, 4)


def test_data_cluster_trace_and_the_imagenet_script_are_covered(monkeypatch):
    """The input pipeline, the cluster control plane, the heartbeat
    helpers and the ImageNet script are scanned; the prefetcher, the
    ImageNet step and the script ask for cuda unless given a device."""
    import importlib.util
    import inspect

    from apex_tpu_torch import data, train

    scanned = {m for _, m in _sources()}
    assert {"apex_tpu_torch.data.jpeg", "apex_tpu_torch.data.pipeline",
            "apex_tpu_torch.cluster.membership",
            "apex_tpu_torch.trace.straggler",
            "scripts/torch_imagenet_main_amp.py"} <= scanned
    assert inspect.signature(
        data.DevicePrefetcher).parameters["device"].default == "cuda"
    spec = importlib.util.spec_from_file_location(
        "torch_imagenet_main_amp",
        ROOT / "scripts" / "torch_imagenet_main_amp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mod.run(["-b", "2", "--steps-per-epoch", "1", "--image-size", "16",
                 "--arch", "resnet18"])
    with pytest.raises(RuntimeError, match="cuda"):
        train.build_resnet_step(2, 16, with_accuracy=True)


def test_trace_monitor_and_the_trace_script_are_covered(monkeypatch):
    """trace/ and monitor/ are scanned and imported; the traced ResNet
    script and ``build_bert_step(monitor=True)`` ask for cuda unless
    given a device."""
    import importlib.util

    from apex_tpu_torch import train

    scanned = {m for _, m in _sources()}
    assert {"apex_tpu_torch.trace.spans", "apex_tpu_torch.trace.recorder",
            "apex_tpu_torch.trace.watchdog", "apex_tpu_torch.trace.podview",
            "apex_tpu_torch.trace.debug_nans", "apex_tpu_torch.monitor",
            "apex_tpu_torch.monitor.logger", "apex_tpu_torch.monitor.goodput",
            "scripts/torch_trace_resnet.py"} <= scanned
    spec = importlib.util.spec_from_file_location(
        "torch_trace_resnet", ROOT / "scripts" / "torch_trace_resnet.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(["--steps", "1", "--batch", "2", "--size", "16",
                  "--arch", "resnet18"])
    with pytest.raises(RuntimeError, match="cuda"):
        train.build_bert_step(2, 16, monitor=True)
