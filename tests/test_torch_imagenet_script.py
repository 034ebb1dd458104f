"""The port's ImageNet script's other paths on the CPU.

``scripts/torch_imagenet_main_amp.py``'s ``run`` from the packed uint8
cache at O2 (the batches normalised on the device by
``data.normalize_uint8``) and from the synthetic default at O1 (the
JAX example's parity run is ``tests/test_torch_imagenet_example.py``).
"""

import importlib.util
import os

import numpy as np
import pytest

import apex_tpu.data as jdata

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_imagenet_main_amp",
        os.path.join(ROOT, "scripts", "torch_imagenet_main_amp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return jdata.make_fake_imagefolder(
        str(tmp_path_factory.mktemp("imagenet")), n_classes=2, per_class=8,
        size=48)


def test_packed_uint8_path_at_o2(tree, tmp_path):
    printed = []
    result = _script().run(
        ["--data", tree, "--cache", str(tmp_path / "cache"), "-b", "8",
         "--steps-per-epoch", "2", "--image-size", "32", "--arch",
         "resnet18", "--print-freq", "1", "--opt-level", "O2",
         "--loader-workers", "2", "--device", "cpu"], emit=printed.append)
    assert printed[0].startswith("loader: ") and "cache-read" in printed[0]
    assert len(result["losses"]) == 2
    assert all(np.isfinite(result["losses"]))
    assert int(result["state"].step) == 2
    assert os.path.exists(tmp_path / "cache" / "meta.json")


def test_synthetic_default(capsys):
    result = _script().run(
        ["-b", "4", "--steps-per-epoch", "2", "--image-size", "32",
         "--arch", "resnet18", "--print-freq", "2", "--epochs", "2",
         "--opt-level", "O1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "loader:" not in out
    assert len(result["losses"]) == 2 and result["loader"] is None
    assert all(np.isfinite(result["losses"]))


def test_prof_writes_a_trace(tmp_path, monkeypatch):
    """``--prof N`` profiles the first N steps into ``prof_trace/``."""
    import json
    monkeypatch.chdir(tmp_path)
    _script().run(["-b", "2", "--steps-per-epoch", "2", "--image-size", "32",
                   "--arch", "resnet18", "--print-freq", "1", "--prof", "1",
                   "--opt-level", "O0", "--device", "cpu"],
                  emit=lambda s: None)
    with open(tmp_path / "prof_trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
