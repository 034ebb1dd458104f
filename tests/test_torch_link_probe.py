"""``scripts/torch_link_probe.py``: two gloo ranks on the CPU measure the
data axis, and the MeshModel JSON the script writes loads in both
packages' ``MeshModel`` (measured, with its fit in ``calibration`` and the
run in ``probe``) and plans a sync through the port's ``plan_comm``."""

import json
import os
import subprocess
import sys

from apex_tpu.lint import mesh_model as jax_mesh
from apex_tpu_torch import parallel
from apex_tpu_torch.lint import mesh_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_gloo_ranks_write_a_measured_model(tmp_path):
    out, events = tmp_path / "mesh.json", tmp_path / "link.jsonl"
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "torch_link_probe.py"),
         "--cpu", "2", "--out", str(out), "--jsonl", str(events),
         "--sizes", "4096,16384,65536", "--iters", "2"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=240,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    data = json.loads(out.read_text())
    assert data["probe"]["backend"] == "gloo" and data["probe"]["world"] == 2
    assert data["probe"]["sizes"] == [4096, 16384, 65536]
    for pkg in (mesh_model, jax_mesh):
        m = pkg.MeshModel.from_json(data)
        assert m.measured and m.n_devices == 2
        assert [a.name for a in m.axes] == ["data"] or \
            [a.link for a in m.axes] == ["ici"]
        cal = m.calibration["ici"]
        assert cal["n_samples"] == 9 and cal["bytes_per_s"] > 0
        assert m.link_bytes_per_s["ici"] == cal["bytes_per_s"]
    plan = parallel.plan_comm(mesh_model.MeshModel.from_json(data), 1 << 20)
    assert plan.hops and plan.grad_bytes == 1 << 20
    r = subprocess.run([sys.executable, os.path.join(
        ROOT, "scripts", "check_metrics_schema.py"), "--kind", "goodput",
        str(events)], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cpu_needs_two_ranks(tmp_path):
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "torch_link_probe.py"),
         "--cpu", "1"], cwd=str(tmp_path), capture_output=True, text=True,
        timeout=60)
    assert r.returncode == 2 and "N >= 2" in r.stderr
