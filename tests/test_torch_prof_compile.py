"""The port's compile watcher and the simple-distributed example on the CPU.

``diff_signatures`` names a changed argument in the JAX package's words
for the same shapes; a watched step counts its compiles per call (one
on the first call, none in steady state), a new signature is a retrace
naming the changed argument, the warning fires after ``warn_after``, the
compile lands in goodput's ``recompile`` bucket and nowhere else, and
Triton specializations count from the kernels' caches. The port of
``examples/simple/distributed`` runs 3 steps on the CPU.
"""

import json
import os
import subprocess
import sys
import types
import warnings

import jax.numpy as jnp
import numpy as np
import torch

from apex_tpu.prof import compile_watch as jcw
from apex_tpu_torch import monitor as tmon
from apex_tpu_torch import trace as ttrace
from apex_tpu_torch.ops import _build
from apex_tpu_torch.prof import compile_watch as tcw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_diff_signatures_equal_jax():
    def both(*shapes, static=3):
        j = ((tuple(jnp.zeros(s, jnp.float32) for s in shapes),
              {"k": static}), {})
        t = ((tuple(torch.zeros(s) for s in shapes), {"k": static}), {})
        return jcw.signature(*j), tcw.signature(*t)
    (j0, t0), (j1, t1) = both((4, 8), (8,)), both((4, 6), (8,), static=5)
    assert t0 == j0 and t1 == j1
    assert tcw.diff_signatures(t0, t1) == jcw.diff_signatures(j0, j1)
    assert "[0][0][0]: ((4, 8), 'float32') -> ((4, 6), 'float32')" in \
        tcw.diff_signatures(t0, t1)
    (_, t2) = both((4, 8))
    assert tcw.diff_signatures(t0, t2) == jcw.diff_signatures(j0, both(
        (4, 8))[0])
    assert tcw.diff_signatures(None, t0) == "first call"


def test_watch_counts_compiles_retraces_and_feeds_goodput():
    built = []

    def step(x):
        # a first call at a new width "builds" (what ops/_build counts)
        if x.shape[1] not in built:
            built.append(x.shape[1])
            _build.BUILDS["nvcc"] += 1
        return x * 2

    tcw.reset_global_counters()
    events = []
    watcher = tcw.CompileWatcher(warn_after=2, on_event=events.append)
    wstep = watcher.watch(step, "step")
    tracer = ttrace.Tracer()
    ledger = tmon.GoodputLedger(tracer)
    widths = (8, 8, 8, 6, 6, 4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with tracer:
            for i, w in enumerate(widths):
                with ttrace.step(i):
                    with ttrace.span("dispatch"):
                        wstep(torch.ones(2, w))
    rec = watcher["step"]
    assert rec.per_call == [1, 0, 0, 1, 0, 1] and rec.n_compiles == 3
    assert (rec.n_calls, rec.n_traces, rec.n_retraces) == (6, 3, 2)
    assert [e["call"] for e in rec.retraces] == [4, 6]
    assert rec.retraces[0]["changed"] == \
        "[0][0]: ((2, 8), 'float32') -> ((2, 6), 'float32')"
    assert len([w for w in caught if "retraced" in str(w.message)
                or "new signatures" in str(w.message)]) == 1
    assert [e["kind"] for e in events].count("compile") == 3
    assert tcw.global_counters()["compiles"] == 3
    rc = [st.buckets["recompile"] for st in ledger.steps]
    assert [x > 0 for x in rc] == [n > 0 for n in rec.per_call]
    assert ledger.check_closure()[0]
    assert "retrace @call 4" in watcher.report()
    # Triton specializations count from each kernel's cache
    fake = types.SimpleNamespace(device_caches={0: ({"a": 1, "b": 2},
                                                    None)})
    _build.JITTED.append(fake)
    try:
        assert tcw.global_counters()["triton_compiles"] == 2
        with tcw.autotune_scope():
            assert tcw.in_autotune()
            wstep2 = watcher.watch(
                lambda: fake.device_caches[0][0].update(c=3), "tune")
            wstep2()
        assert watcher["tune"].n_autotune_compiles == 1
    finally:
        _build.JITTED.remove(fake)
        tcw.reset_global_counters()


def test_simple_distributed_example_runs_on_the_cpu(tmp_path):
    jsonl = tmp_path / "m.jsonl"
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "torch_simple_distributed.py"),
         "--device", "cpu", "--steps", "3", "--log-every", "3",
         "--metrics-jsonl", str(jsonl), "--crash-dumps",
         str(tmp_path / "dumps")],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    # alone, no DDP: no collective; FLOPs of x @ w forward and dw, and the
    # arena SGD's 6 an element
    assert lines[0].startswith("collective_bytes_per_step: 0 ")
    assert lines[0].endswith(
        f"flops_per_step: {float(2 * 2 * 64 * 1024 * 16 + 6 * 65536)}")
    recs = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [r_["step"] for r_ in recs] == [1, 2, 3]
    assert all(r_["mfu"] is None for r_ in recs)    # no peak on the CPU
    assert np.isfinite(float(lines[-1].split("=")[-1]))
    assert os.path.exists(tmp_path / "dumps" / "timeline.json")
