"""``python -m apex_tpu_torch.ops``: the on-card compile check's registry,
its refusal without a card, its summary, and its no-extra-dispatch
censuses run on the CPU.

The kernel cases run on a card only (``chip_smoke.py``'s phase
compile_check and ``python -m apex_tpu_torch.ops`` there); here:

- the registry holds every case name of the JAX package's compile check
  but its three ``lint/*`` (the port has no lint pass yet), and the kernel
  phase's checks under ``kernels/``;
- without a card the entry point exits non-zero with its message, builds
  nothing and runs no case;
- the summary carries the JAX package's fields, and a failing case is
  reported while the others run;
- each ported module's no-extra-dispatch census (a depth-2 encoder step
  with the feature off against the step without it: the same aten ops)
  passes on the CPU, the integrity one inside two gloo ranks, and the
  autotune one with the launchers recorded.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import _torch_parallel_cases as cases
from apex_tpu.ops import compile_check as jax_cc
from apex_tpu_torch.ops import _build, autotune, compile_check as cc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NAMES = [n for n, _ in jax_cc.CASES]
PORT_NAMES = [n for n, _ in cc.CASES]
CENSUS = sorted(n for n in PORT_NAMES
                if n.endswith("no-extra-dispatch") or n.startswith("ddp/"))


def test_registry_holds_the_jax_case_names_less_lint():
    lint = [n for n in JAX_NAMES if n.startswith("lint/")]
    assert len(lint) == 3
    assert set(JAX_NAMES) - set(lint) <= set(PORT_NAMES)
    assert not set(lint) & set(PORT_NAMES)
    extra = set(PORT_NAMES) - set(JAX_NAMES)
    assert extra and all(n.startswith("kernels/") for n in extra)
    assert len(PORT_NAMES) == len(set(PORT_NAMES))


def test_no_card_refused_and_nothing_built(monkeypatch, capsys):
    r = subprocess.run([sys.executable, "-m", "apex_tpu_torch.ops",
                        "--json", os.devnull], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and "no CUDA device" in r.stderr
    ran = []
    monkeypatch.setattr(cc, "CASES", [("fake/case", lambda: ran.append(1))])
    monkeypatch.setattr(_build, "build_all",
                        lambda: ran.append("built") or {})
    before = dict(_build.BUILDS)
    assert cc.main(["--compile-check"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert ran == [] and _build.BUILDS == before and not _build.JITTED


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "Fake Card")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)


def test_summary_fields_and_a_failing_case(fake_card, monkeypatch,
                                           tmp_path):
    def bad():
        raise AssertionError("kernel and plain disagree")

    def good():
        cc.ERRS["row"] = 0.5

    monkeypatch.setattr(cc, "CASES", [("fake/good", good), ("fake/bad", bad),
                                      ("other/skipped", bad)])
    path = tmp_path / "cc.json"
    assert cc.main(["-k", "fake/", "--json", str(path)]) == 1
    s = json.loads(path.read_text())
    # the JAX package's run() fields, then the port's
    assert {"backend", "device", "compiled", "ok", "n_cases", "n_failed",
            "results"} <= set(s)
    assert (s["backend"], s["device"], s["compiled"]) == ("cuda",
                                                          "Fake Card", True)
    assert (s["ok"], s["n_cases"], s["n_failed"]) == (False, 2, 1)
    assert [r["case"] for r in s["results"]] == ["fake/good", "fake/bad"]
    assert s["results"][0]["ok"] and not s["results"][1]["ok"]
    assert "kernel and plain disagree" in s["results"][1]["error"]
    assert s["max_abs_err"] == {"row": 0.5}
    monkeypatch.setattr(cc, "CASES", [("fake/good", good)])
    assert cc.main([]) == 0


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(cc, "DEVICE", "cpu")
    monkeypatch.delenv("APEX_TPU_AUTOTUNE", raising=False)
    torch.manual_seed(0)


@pytest.mark.parametrize("name", [n for n in CENSUS if n not in (
    "integrity/no-extra-dispatch", "autotune/no-extra-dispatch")])
def test_census_on_the_cpu(name, on_cpu):
    dict(cc.CASES)[name]()


def test_census_an_off_step_with_more_ops_fails(on_cpu):
    plain = cc._stepper(*cc.encoder_step())

    def extra():
        loss = plain()
        torch.zeros(3).add_(1.0)
        return loss

    with pytest.raises(AssertionError, match="extra"):
        cc.same_dispatch("probe", plain, extra)
    cc.same_dispatch("probe", plain, extra, allowed=("aten::zeros",
                                                     "aten::add_"))


def test_integrity_census_in_two_gloo_ranks(tmp_path):
    res = cases.run(2, ["integrity_census"], tmp_path)
    assert all(r["ok"][0] == 1 for r in cases.ranks(res,
                                                    "integrity_census"))


def test_autotune_census_with_recorded_launches(on_cpu, monkeypatch):
    monkeypatch.setattr(_build, "check_operands", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)

    def under(mode):
        os.environ["APEX_TPU_AUTOTUNE"] = mode
        try:
            return cc.autotune_probe()[1]
        finally:
            os.environ.pop("APEX_TPU_AUTOTUNE", None)

    with autotune.use_db(autotune.TuningDB()):
        assert under("off") == under("db")
        cc.same_dispatch("autotune miss", lambda: under("off"),
                         lambda: under("db"))
    seeds = [autotune.TuningEntry(f, d, "float32", "cpu", b)
             for f, d, b in cc.AUTOTUNE_SEEDS]
    with autotune.use_db(autotune.TuningDB({e.fingerprint: e
                                            for e in seeds})):
        autotune.reset_counters()
        hit = under("db")
        assert autotune.counters() == {"hits": 4, "misses": 0}
    assert set(hit) != set(under("off"))
