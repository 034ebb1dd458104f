"""The port's ImageNet example against the JAX package's, on one tree.

``examples/imagenet/main_amp.py`` runs as a subprocess on a JPEG tree the
JAX package wrote (ResNet-18, B16, 32 px, O0, two steps, a print a step);
``scripts/torch_imagenet_main_amp.py``'s ``run`` trains from the same
init (``PRNGKey(0)``, carried by ``convert.resnet_variables_from_jax``)
on the same tree through the port's loader. Each printed loss agrees
within 5e-4 (the print has four decimals; f32 sums run in other orders)
and both print their ``loader:`` and ``img/s`` lines.
"""

import importlib.util
import os
import re
import subprocess
import sys

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
        str(tmp_path_factory.mktemp("imagenet")), n_classes=4, per_class=8,
        size=64)


def _losses(lines):
    return [float(m.group(1)) for m in
            (re.search(r"step \d+: loss (\S+)", l) for l in lines) if m]


def test_losses_match_the_jax_example(tree):
    args = ["--data", tree, "-b", "16", "--steps-per-epoch", "2",
            "--image-size", "32", "--arch", "resnet18", "--print-freq", "1",
            "--opt-level", "O0", "--loader-workers", "2"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, os.path.join("examples", "imagenet", "main_amp.py"),
         *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        import jax
        import jax.numpy as jnp
        from apex_tpu import models as jmodels
        from apex_tpu_torch import convert

        v = jmodels.ResNet18(num_classes=1000, dtype=None).init(
            jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3), jnp.float32),
            train=True)
        printed = []
        result = _script().run(
            args + ["--device", "cpu"], emit=printed.append,
            variables=convert.resnet_variables_from_jax(
                v["params"], v["batch_stats"], device="cpu"))
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    want = _losses(out.splitlines())
    got = _losses(printed)
    assert len(want) == len(got) == 2
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    assert got == [float(f"{x:.4f}") for x in result["losses"]]
    for lines in (out.splitlines(), printed):
        assert any(l.startswith("loader: ") and "decode threads" in l
                   for l in lines)
        assert sum("img/s" in l for l in lines) >= 3
    assert printed[-1] == "done. amp state_dict: {'loss_scaler0': None}"
