"""The port's lint plumbing against the JAX package's: ``lint.findings``
(the rule catalog, ``Finding``, ``Report``, baselines), ``utils.format`` and
``MetricsLogger.attach_lint_report``.

The same ``Finding`` fields give the same fingerprint and the same event
dict in both packages, the same ``table()`` ordering, summary and events,
and one baseline file serves both. The reports here are built from
findings, not from a lint run: ``tests/test_lint.py::TestReportPlumbing``'s
run-based twins fail on jax 0.9.0 because its debug print escapes APX004,
not because the plumbing is wrong.
"""

import json
import os
import sys

import pytest

from apex_tpu import monitor as jmon
from apex_tpu.lint import findings as JF
from apex_tpu.utils import format as jformat
from apex_tpu_torch import lint as tlint
from apex_tpu_torch import monitor as tmon
from apex_tpu_torch.lint import findings as TF
from apex_tpu_torch.utils import format as tformat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: one finding per rule family, every evidence field used somewhere
FIELDS = (
    dict(rule="host-callback-in-step", message="2 host sync(s)",
         op="aten::_local_scalar_dense", scope="forward", count=2),
    dict(rule="rng-key-reuse", message="one state, two draws",
         op="aten::rand/aten::randn", scope="generator #0 (cpu)"),
    dict(rule="fp32-matmul-in-amp", message="f32 mm", op="aten::mm",
         scope="forward/aten::mm", count=3),
    dict(rule="half-accumulation", message="bf16 sum", severity="info",
         op="aten::sum", scope="backward", dtype_from="bf16",
         dtype_to="bf16", count=9),
    dict(rule="scale-leak", message="leak", op="output",
         scope="result[0].params['w']", dtype_from="fp32",
         scale_provenance="loss-scaled"),
    dict(rule="unscaled-narrow-cast", message="fp8", op="aten::_to_copy",
         scope="forward", dtype_from="fp32", dtype_to="fp8_e4m3",
         scale_provenance="unscaled"),
    dict(rule="nondeterminism", message="scatter", severity="warning",
         op="aten::index_add", scope="backward"),
    dict(rule="donation-miss", message="m", op="arg0",
         scope="state.params", bytes=123456789),
    dict(rule="dcn-flat-collective", message="flat", op="all-reduce",
         scope="ddp/sync", bytes=4096, axes=["data"], ranks=[0, 3],
         hop="dcn"),
    dict(rule="tile-padding", message="pad", op="dot", bytes=1536),
)


def _pair(**kw):
    return JF.Finding(**kw), TF.Finding(**kw)


def test_rule_catalog_ids_slugs_and_vocabularies_match_jax():
    assert list(TF.RULES) == list(JF.RULES)
    for slug, r in TF.RULES.items():
        j = JF.RULES[slug]
        assert (r.id, r.slug, r.severity) == (j.id, j.slug, j.severity)
        assert r.title and r.fix
    assert TF.SEVERITIES == JF.SEVERITIES
    assert TF.DTYPE_NAMES == JF.DTYPE_NAMES
    assert TF.PROVENANCES == JF.PROVENANCES
    # reworded for the card: no TPU vocabulary in the port's catalog
    text = " ".join(r.title + " " + r.fix for r in TF.RULES.values())
    for word in ("TPU", "MXU", "HBM", "jax.", "XLA", "ICI", "DCN"):
        assert word not in text, word


@pytest.mark.parametrize("kw", FIELDS, ids=[f["rule"] for f in FIELDS])
def test_finding_fingerprint_and_event_match_jax(kw):
    j, t = _pair(**kw)
    assert t.id == j.id and t.severity == j.severity
    assert t.fingerprint() == j.fingerprint()
    jev, tev = j.to_event("step", 7), t.to_event("step", 7)
    assert set(tev) == set(jev)
    # the fix-its are reworded for the card; every other field is equal
    assert {k: v for k, v in tev.items() if k != "fix"} == \
        {k: v for k, v in jev.items() if k != "fix"}


def test_finding_validation_matches_jax():
    for bad in (dict(rule="nope", message="m"),
                dict(rule="scale-leak", message="m", severity="fatal"),
                dict(rule="dcn-flat-collective", message="m", hop="nvlink"),
                dict(rule="unscaled-narrow-cast", message="m",
                     dtype_from="f32"),
                dict(rule="scale-leak", message="m",
                     scale_provenance="scaled")):
        with pytest.raises(ValueError):
            JF.Finding(**bad)
        with pytest.raises(ValueError):
            TF.Finding(**bad)


def _reports(fn_name="seeded", suppressed=0):
    js = [JF.Finding(**kw) for kw in FIELDS]
    ts = [TF.Finding(**kw) for kw in FIELDS]
    return (JF.Report(js, fn_name=fn_name, suppressed=suppressed),
            TF.Report(ts, fn_name=fn_name, suppressed=suppressed))


def _strip_fix(lines):
    return [ln for ln in lines if not ln.strip().startswith("fix:")]


def test_report_order_table_summary_and_events_match_jax():
    jr, tr = _reports(suppressed=2)
    assert [f.fingerprint() for f in tr] == [f.fingerprint() for f in jr]
    sevs = [f.severity for f in tr]
    assert sevs == sorted(sevs, key=TF.SEVERITIES.index)
    assert tr.by_severity() == jr.by_severity()
    assert tr.max_severity() == jr.max_severity() == "error"
    assert tr.wasted_bytes() == jr.wasted_bytes() == 123456789 + 4096 + 1536
    assert tr.wasted_bytes("tile-padding") == 1536
    assert [f.rule for f in tr.errors] == [f.rule for f in jr.errors]
    assert tr.summary() == jr.summary()
    assert _strip_fix(tr.table().splitlines()) == \
        _strip_fix(jr.table().splitlines())
    assert "117.74 MiB" in tr.table() and "APX004" in tr.table()
    jev, tev = jr.to_events(step=3), tr.to_events(step=3)
    assert tev[0] == jev[0]
    assert len(tev) == len(jev) == 1 + len(FIELDS)
    empty_j, empty_t = JF.Report([], fn_name="f"), TF.Report([],
                                                             fn_name="f")
    assert empty_t.table() == empty_j.table()
    assert empty_t.max_severity() is None


def test_one_baseline_file_serves_both(tmp_path):
    jr, tr = _reports()
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    assert TF.save_baseline(str(tpath), tr) == JF.save_baseline(
        str(jpath), jr)
    assert tpath.read_text() == jpath.read_text()
    baseline = tlint.load_baseline(str(jpath))
    assert baseline == JF.load_baseline(str(tpath))
    clean = tr.apply_baseline(baseline)
    assert len(clean) == 0 and clean.suppressed == len(tr)
    assert len(jr.apply_baseline(baseline)) == 0
    assert tlint.load_baseline(str(tmp_path / "missing.json")) == []
    (tmp_path / "bad.json").write_text('{"suppress": 3}')
    with pytest.raises(ValueError):
        tlint.load_baseline(str(tmp_path / "bad.json"))


@pytest.mark.parametrize("n", [None, 0, 512, 1023, 1024, 5e6, 47.7 * 2**20,
                               3.5 * 2**30, -2048])
def test_fmt_bytes_matches_jax(n):
    for kw in ({}, {"compact": True}, {"none": ""}):
        assert tformat.fmt_bytes(n, **kw) == jformat.fmt_bytes(n, **kw)


def test_private_formatters_route_through_fmt_bytes():
    from apex_tpu_torch.monitor import sinks
    from apex_tpu_torch.prof import memory
    for n in (12, 5e6, 3 * 2**30):
        assert memory._fmt_bytes(n) == tformat.fmt_bytes(n)
        assert sinks._fmt_bytes(n) == tformat.fmt_bytes(n, compact=True)
    assert memory._fmt_bytes(None) == "n/a"


def test_attach_lint_report_emits_what_the_jax_logger_emits(tmp_path):
    jr, tr = _reports()
    jpath, tpath = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jl = jmon.MetricsLogger(sinks=[], lint_sink=jmon.JSONLSink(str(jpath)))
    tl = tmon.MetricsLogger(sinks=[], lint_sink=tmon.JSONLSink(str(tpath)))
    assert tl.lint_report is None
    assert jl.attach_lint_report(jr, step=5) is jl
    assert tl.attach_lint_report(tr, step=5) is tl
    assert tl.lint_report is tr
    jl.close()
    tl.close()
    jlines = jpath.read_text().strip().splitlines()
    tlines = tpath.read_text().strip().splitlines()
    assert len(tlines) == len(jlines) == 1 + len(FIELDS)
    strip = [{k: v for k, v in json.loads(ln).items() if k != "fix"}
             for ln in tlines]
    assert strip == [{k: v for k, v in json.loads(ln).items() if k != "fix"}
                     for ln in jlines]
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import check_metrics_schema as cms
    finally:
        sys.path.pop(0)
    assert cms.check_lint_lines(tlines) == []
    # no report: nothing emitted, the logger still chains
    tl2 = tmon.MetricsLogger(sinks=[])
    assert tl2.attach_lint_report(None) is tl2 and tl2.lint_report is None
