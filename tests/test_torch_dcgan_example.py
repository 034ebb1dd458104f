"""The DCGAN amp example on the port against the JAX package's example.

``examples/dcgan/main_amp.py`` runs as it is (a subprocess on the CPU) at
``--niter 2 --batchSize 8 --ngf 16 --ndf 16 --print-freq 1``; its printed
``Loss_D``/``Loss_G`` are parsed. The port's entry point
(``scripts/torch_dcgan_main_amp.py``'s ``run``) trains from the same
initial weights (the example's ``PRNGKey(1)``/``(2)`` inits, carried by
``convert.dcgan_variables_from_jax``) on the same
``RandomState(manualSeed)`` draws, and each of its losses is held against
the example's print to its 4 decimals (within 1e-4: the print's rounding
and f32 sums in other orders). Also: two Adam launches a step's worth of
updates (D's one on the summed grads, G's one), and no ``auto_cast``: the
f32 inputs meet bf16 weights and D computes in f32.
"""

import importlib.util
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import torch

from apex_tpu import models as jmodels
from apex_tpu_torch import models as tmodels
from apex_tpu_torch import train
from apex_tpu_torch.convert import dcgan_variables_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--niter", "2", "--batchSize", "8", "--ngf", "16", "--ndf", "16",
         "--print-freq", "1"]
LINE = re.compile(r"Loss_D (-?[0-9.]+) Loss_G (-?[0-9.]+)")


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_dcgan_main_amp",
        os.path.join(ROOT, "scripts", "torch_dcgan_main_amp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_prints():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "dcgan",
                                      "main_amp.py"), *FLAGS],
        capture_output=True, text=True, env=env, timeout=600, check=True)
    return [tuple(map(float, m.groups()))
            for m in map(LINE.search, out.stdout.splitlines()) if m]


def _nets(nz=100, ngf=16, ndf=16, size=64):
    nets = []
    for jm, tm, key, x in (
            (jmodels.Generator(nz=nz, ngf=ngf),
             tmodels.Generator(nz=nz, ngf=ngf, device="cpu"), 1,
             jnp.zeros((2, 1, 1, nz), jnp.float32)),
            (jmodels.Discriminator(ndf=ndf),
             tmodels.Discriminator(ndf=ndf, device="cpu"), 2,
             jnp.zeros((2, size, size, 3), jnp.float32))):
        var = jm.init(jax.random.PRNGKey(key), x, train=True)
        tp, tbs = dcgan_variables_from_jax(var["params"],
                                           var["batch_stats"], device="cpu")
        tm.load_state_dict({**tp, **tbs})
        nets.append(tm)
    return tuple(nets)


def test_example_losses_match_the_jax_example_prints():
    want = _jax_prints()
    assert len(want) == 2
    mod = _script()
    lines = []
    got = mod.run(mod.parse_args(FLAGS + ["--device", "cpu"]), nets=_nets(),
                  emit=lines.append)
    assert len(got) == len(want) == len(lines)
    for (gd, gg), (wd, wg), line in zip(got, want, lines):
        assert LINE.search(line)
        assert abs(gd - wd) <= 1e-4 and abs(gg - wg) <= 1e-4, (got, want)


def test_example_step_shape_of_an_update(monkeypatch):
    """One step: two Adam updates (D's on gR + gF, G's), D computing in f32
    at O2 (f32 inputs, bf16 weights), losses finite."""
    from apex_tpu_torch.optim import fused
    calls = []
    real_step = fused.FusedAdam.step

    def counting(self, *a, **k):
        calls.append(self)
        return real_step(self, *a, **k)

    monkeypatch.setattr(fused.FusedAdam, "step", counting)
    step, (sd, sg, bsd, bsg), draw, policy, (G, D) = \
        train.build_dcgan_example_step(4, nz=16, ngf=8, ndf=8, device="cpu")
    seen = []
    hook = D.Conv_1.register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    real, z = draw()
    assert real.dtype == z.dtype == torch.float32
    sd2, sg2, _, _, loss_d, loss_g = step(sd, sg, bsd, bsg, real, z)
    hook.remove()
    assert len(calls) == 2 and calls[0] is not calls[1]
    assert set(seen) == {torch.float32}
    assert torch.isfinite(loss_d) and torch.isfinite(loss_g)
    assert int(sd2.step) == int(sg2.step) == 1
    assert policy.cast_model_type == torch.bfloat16
