#!/usr/bin/env python3
"""torch_kernel_tune — the launch-knob sweep on the card, and the CPU audit
of the autotuner (exit status is the verdict).

The port of ``scripts/kernel_tune.py``.

``--update-db`` (on the card)
    Finds the tuning keys the main paths consult, each with the kernel
    wrappers that consult it — one step of BERT-Large (B16, S512, O1 bf16,
    the arena LAMB: its LayerNorm rows and width, its MLM cross-entropy,
    its arena partition) and of DLRM's bottom MLP
    (``train.build_mlp_step(2048)``: its MLP and its Adam partition) —
    plus BERT-Large's ZeRO shard at world size 2 (the kernels one
    ``DistributedFusedLAMB`` step consults at its shard). At each key it
    sweeps the family's candidate grid over exactly those kernels
    (``autotune.sweep_entry``: device time by ``prof.report.device_ms``
    after an L2 sweep, each candidate in alternating pairs against the
    default, Triton compiles under ``prof.autotune_scope``) and writes the
    entries, with their sweep records and kernels, to
    ``scripts/torch_kernel_tuning_db.json``. An entry keeps a tuned knob
    only when it beat the default in at least ``autotune.SWEEP_MIN_WINS``
    of ``autotune.SWEEP_PAIRS`` pairs by more than the default's
    interquartile spread; otherwise it holds the default, and its record
    shows why. Families without a launch knob (``mlp``, ``attention``)
    get no entry.

``--cpu-audit`` (tier-1, no card)
    (a) a DB round trip: write, reload, exact-key hit through the
        consult; (b) a nearest miss (one row off, another dtype, another
        chip) does not match; (c) a stale entry (its recorded dims no
        longer fingerprint to its key) is refused with
        ``StaleTuningEntry`` naming the key, and an off-grid value warns
        and launches the defaults; (d) the committed DB loads stale-free,
        with an entry for each family that has a launch knob, each with a
        card sweep record naming the kernels it timed; (e) ``tune_report``
        joins a synthetic ``worst_gaps`` by family and dims; (f) the
        ``kind="tune"`` events validate under
        ``scripts/check_metrics_schema.py --kind roofline``.

Usage:
  python3 scripts/torch_kernel_tune.py --update-db [--out PATH] [--pairs N]
  python3 scripts/torch_kernel_tune.py --cpu-audit
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import warnings

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
DB_PATH = os.path.join(_REPO, "scripts", "torch_kernel_tuning_db.json")
#: the families with a launch knob, hence a committed entry
TUNED_FAMILIES = ("layer_norm", "optimizer", "xentropy")
#: the wrappers ``launcher`` launches, by family (those whose seams consult)
KERNELS = {
    "layer_norm": ("ln_fwd_kernel", "ln_bwd_kernel"),
    "xentropy": ("xentropy_fwd_kernel", "xentropy_bwd_kernel"),
    "optimizer": ("l2norm_kernel", "lamb_stage1_kernel",
                  "lamb_stage2_kernel", "adam_kernel"),
}


def _schema(path: str) -> None:
    r = subprocess.run(
        [sys.executable, os.path.join(_REPO, "scripts",
                                      "check_metrics_schema.py"),
         "--kind", "roofline", path], capture_output=True, text=True)
    if r.returncode != 0:
        raise AssertionError(f"{path} fails --kind roofline:\n{r.stdout}"
                             f"{r.stderr}")


def _write_events(path, events) -> None:
    """``kind="tune"`` events through the roofline channel of a
    ``MetricsLogger`` into JSONL at ``path``, then the schema check."""
    from apex_tpu_torch import monitor
    logger = monitor.MetricsLogger(sinks=[],
                                   roofline_sink=monitor.JSONLSink(path))
    for ev in events:
        logger.record_roofline(ev)
    logger.close()
    _schema(path)


def _sweep_event(entry):
    from apex_tpu_torch.ops import autotune
    sw = entry.sweep
    return autotune.tune_event(
        "sweep", entry.fingerprint, entry.family, step=None,
        best_us=sw.get("best_us"), default_us=sw.get("default_us"),
        gap_us=max(0.0, sw.get("default_us", 0.0) - sw.get("best_us", 0.0)),
        speedup=sw.get("default_us", 0.0) / max(sw.get("best_us", 0.0),
                                                1e-9),
        n_candidates=sw.get("n_candidates"), chip=entry.chip,
        dtype=entry.dtype)


def _split(fp):
    family, dims, dtype, _chip = fp.split("|")
    return family, tuple(int(d) for d in dims.split("x")), dtype


# --- the main paths' tuning keys ---------------------------------------------

def _wrapper():
    """The kernel wrapper (a ``*_kernel`` function of ``apex_tpu_torch.ops``)
    on the stack of a consult, or None."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.endswith("_kernel") and str(
                f.f_globals.get("__name__", "")).startswith(
                "apex_tpu_torch.ops."):
            return f.f_code.co_name
        f = f.f_back
    return None


@contextlib.contextmanager
def consulting_kernels():
    """Inside the block, every consult of the seams is recorded with the
    kernel wrapper that made it: yields ``{(family, dims, dtype): {wrapper
    names}}``."""
    from apex_tpu_torch.ops import autotune
    seen = {}
    real = autotune.launch_knobs

    def knobs(family, dims, dtype):
        key = (family, tuple(int(d) for d in dims),
               autotune._dtype_name(dtype))
        seen.setdefault(key, set()).add(_wrapper())
        return real(family, dims, dtype)
    autotune.launch_knobs = knobs
    try:
        yield seen
    finally:
        autotune.launch_knobs = real


def _zero_step_kernels():
    """``{(family, dims, dtype): wrappers}`` of one BERT-Large step with
    ``DistributedFusedLAMB`` on a one-rank NCCL group (the shard there is
    the whole partition)."""
    import tempfile
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import parallel, train
    from apex_tpu_torch.optim import DistributedFusedLAMB

    store = tempfile.mkdtemp(prefix="torch_kernel_tune_store_")
    parallel.distributed_init(init_method=f"file://{store}/store",
                              num_processes=1, process_id=0, timeout_s=300)
    try:
        with parallel.use_mesh(parallel.data_parallel_mesh()):
            step, state, (x, y), *_ = train.build_bert_step(
                16, 512, optimizer=DistributedFusedLAMB(lr=1e-3))
            with consulting_kernels() as seen:
                step(state, x, y)
                torch.cuda.synchronize()
        del step, state
        torch.cuda.empty_cache()
        return seen
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def path_keys():
    """``{(family, dims, dtype): {kernel wrappers}}`` the main paths consult
    on the card, each key with the wrappers that consulted it: one step
    each of BERT-Large's arena step and DLRM's bottom MLP step under an
    empty DB, and BERT-Large's ZeRO shard of its f32 partition at world
    size 2, consulted by the kernels a ZeRO step consults at its shard
    (one step at world size 1, where the shard is the whole partition)."""
    import torch
    from apex_tpu_torch import train
    from apex_tpu_torch.ops import autotune, compile_check
    from apex_tpu_torch.optim.distributed import _padded_len

    keys = {}
    os.environ["APEX_TPU_AUTOTUNE"] = "db"
    with autotune.use_db(autotune.TuningDB()):
        for build in (lambda: train.build_bert_step(16, 512,
                                                    strategy="arena"),
                      lambda: train.build_mlp_step(2048)):
            step, state, (x, y), *_ = build()
            with consulting_kernels() as seen:
                step(state, x, y)
                torch.cuda.synchronize()
            for k, v in seen.items():
                keys.setdefault(k, set()).update(v)
            del step, state
            torch.cuda.empty_cache()
        n = compile_check.buffer_len("BertLarge")
        zero = _zero_step_kernels()[("optimizer", (n,), "float32")]
    keys.setdefault(("optimizer", (_padded_len(n, 2) // 2,), "float32"),
                    set()).update(zero)
    return keys


def _kernels(family, dims, dt, rnd, gen):
    """``{wrapper name: (run, plain)}`` of the family's kernels at one
    shape: ``run()`` launches the wrapper (its seam consults the DB),
    ``plain()`` gives the same outputs from the plain version; both
    return a list of tensors."""
    import torch
    from apex_tpu_torch.ops import _arena, compile_check
    from apex_tpu_torch.ops import layer_norm as L, multi_tensor as M
    from apex_tpu_torch.ops import optim_kernels as K
    from apex_tpu_torch.ops import xentropy as X
    f32, dev = torch.float32, compile_check.DEVICE
    if family == "layer_norm":
        n, h = dims
        x, g = rnd(n, h, dtype=dt, std=2.0), rnd(n, h, dtype=dt)
        w, b = rnd(h, dtype=f32) * 0.2 + 1.0, rnd(h, dtype=f32) * 0.2
        return {
            "ln_fwd_kernel": (lambda: [L.ln_fwd_kernel(x, w, b, 1e-12)],
                              lambda: [L.ln_fwd_plain(x, w, b, 1e-12)]),
            "ln_bwd_kernel": (lambda: [*L.ln_bwd_kernel(g, x, w, 1e-12)],
                              lambda: [*L.ln_bwd_plain(g, x, w, 1e-12)])}
    if family == "xentropy":
        n, v = dims
        logits = rnd(n, v, dtype=dt, std=3.0)
        labels = torch.randint(0, v, (n,), generator=gen, device=dev)
        gl = torch.rand(n, generator=gen, device=dev)
        _, lse = X.xentropy_fwd_plain(logits, labels, 0.0)
        return {
            "xentropy_fwd_kernel": (
                lambda: [*X.xentropy_fwd_kernel(logits, labels, 0.0)],
                lambda: [*X.xentropy_fwd_plain(logits, labels, 0.0)]),
            "xentropy_bwd_kernel": (
                lambda: [X.xentropy_bwd_kernel(logits, labels, lse, gl,
                                               0.0)],
                lambda: [X.xentropy_bwd_plain(logits, labels, lse, gl,
                                              0.0)])}
    if family == "optimizer":
        (n,) = dims
        p, g = rnd(n, dtype=dt), rnd(n, dtype=f32, std=1e-2)
        m, v = rnd(n, dtype=f32, std=1e-3), rnd(n, dtype=f32,
                                                std=1e-3).abs()
        u, r = rnd(n, dtype=f32, std=1e-3), rnd(n, dtype=f32).abs() + 0.5
        s8 = _arena.device_scalars((0.9, 0.999, 1e-6, 0.01, 0.1, 0.001,
                                    1.0, 0.1), dev)
        sa = _arena.device_scalars((1e-3, 0.9, 0.999, 1e-8, 0.01, 0.1,
                                    0.001, 1.0), dev)
        s1 = _arena.device_scalars((1e-3,), dev)
        return {
            "l2norm_kernel": (lambda: [M.l2norm_kernel(g)],
                              lambda: [M.l2norm_plain(g)]),
            "lamb_stage1_kernel": (
                lambda: [*K.lamb_stage1_kernel(p, g, m, v, s8, True)],
                lambda: [*K.lamb_stage1_plain(p, g, m, v, s8, True)]),
            "lamb_stage2_kernel": (
                lambda: [K.lamb_stage2_kernel(p, u, r, s1)],
                lambda: [K.lamb_stage2_plain(p, u, r, s1)]),
            "adam_kernel": (
                lambda: [*K.adam_kernel(p, g, m, v, sa, True)],
                lambda: [*K.adam_plain(p, g, m, v, sa, True)])}
    raise ValueError(f"{family} has no launch knob to sweep")


def launcher(family, dims, dtype_name, kernels):
    """A zero-arg call of exactly the wrappers ``kernels`` (the ones the
    main path consults at this key) at ``(dims, dtype)``, and the same
    outputs from their plain versions: ``(run, plain)``. A wrapper this
    script cannot launch is refused by name."""
    import torch
    from apex_tpu_torch.ops import compile_check

    rnd, gen = compile_check.seeded(31)
    table = _kernels(family, tuple(dims), getattr(torch, dtype_name), rnd,
                     gen)
    unknown = sorted(set(kernels) - set(table))
    if unknown or not kernels:
        raise ValueError(f"{family}|{dims}|{dtype_name}: no launcher for "
                         f"{unknown or 'no kernel'} (have {sorted(table)})")
    names = sorted(kernels)

    def run():
        return [t for k in names for t in table[k][0]()]

    def plain():
        return [t for k in names for t in table[k][1]()]
    return run, plain


def flusher():
    """The L2 sweep of chip_smoke's kernel phase: 256 MiB zeroed."""
    import torch
    return torch.empty(256 << 20, dtype=torch.uint8, device="cuda").zero_


def update_db(out_path: str, pairs: int, iters: int,
              events: str = None) -> int:
    import torch
    from apex_tpu_torch.ops import autotune
    if not torch.cuda.is_available():
        print("--update-db sweeps on a card; there is none", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    keys = {k: v for k, v in path_keys().items() if k[0] in TUNED_FAMILIES}
    print(f"main-path keys to tune: "
          f"{ {k: sorted(v) for k, v in sorted(keys.items())} }", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    db = autotune.TuningDB(path=out_path)
    flush = flusher()
    evs = []
    for (family, dims, dtype), kernels in sorted(keys.items()):
        run, _plain = launcher(family, dims, dtype, kernels)
        entry = autotune.sweep_entry(family, dims, dtype, run, pairs=pairs,
                                     iters=iters, flush=flush)
        entry.sweep["kernels"] = sorted(kernels)
        entry.sweep["card"] = smi
        entry.sweep["script"] = "scripts/torch_kernel_tune.py --update-db"
        db.add(entry)
        sw = entry.sweep
        wins = [(c["block"], c["wins"], c["us"]) for c in sw["candidates"]]
        print(f"{entry.fingerprint} ({sw['kernels']}): keep {entry.block} "
              f"(default {sw['default_us']} us, fastest {sw['fastest_us']} "
              f"us, won {sw['won']}; wins {wins})", flush=True)
        evs.append(_sweep_event(entry))
        del run, _plain
        torch.cuda.empty_cache()
    db.save(out_path)
    print(f"wrote {out_path} ({len(db)} entries)")
    if events:
        _write_events(events, evs)
    return 0


# --- the CPU audit ---------------------------------------------------------------

def cpu_audit() -> int:
    from apex_tpu_torch.ops import autotune
    checks = {}
    prev = os.environ.get("APEX_TPU_AUTOTUNE")
    os.environ["APEX_TPU_AUTOTUNE"] = "db"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # (a) round trip: write -> reload -> exact-key hit
            e = autotune.TuningEntry("layer_norm", (8192, 1024), "bfloat16",
                                     "cpu", {"epl": 64, "bwd_blocks": 128},
                                     sweep={"mode": "cuda"})
            path = autotune.TuningDB({e.fingerprint: e}).save(
                os.path.join(tmp, "db.json"))
            with autotune.use_db(path):
                autotune.reset_counters()
                hit = autotune.launch_knobs("layer_norm", (8192, 1024),
                                            "bfloat16")
                # (b) nearest misses
                near = [autotune.lookup_blocks("layer_norm", (8191, 1024),
                                               "bfloat16"),
                        autotune.lookup_blocks("layer_norm", (8192, 1024),
                                               "float32")]
                other = autotune.TuningDB.load(path).lookup(
                    autotune.fingerprint("layer_norm", (8192, 1024),
                                         "bfloat16", "nvidia_h100"))
                c = autotune.counters()
            checks["a round trip hits"] = hit == e.block and \
                autotune.recent_consults()[0] == (e.fingerprint, True)
            checks["b nearest miss"] = near == [None, None] and \
                other is None and c == {"hits": 1, "misses": 2}
            # (c) stale and off-grid entries
            with open(path) as f:
                body = json.load(f)
            body["entries"][e.fingerprint]["dims"] = [8192, 1023]
            stale = os.path.join(tmp, "stale.json")
            with open(stale, "w") as f:
                json.dump(body, f)
            try:
                autotune.TuningDB.load(stale)
                checks["c stale refused"] = False
            except autotune.StaleTuningEntry as err:
                checks["c stale refused"] = e.fingerprint in str(err)
            bad = autotune.TuningEntry("layer_norm", (8192, 1024),
                                       "bfloat16", "cpu", {"epl": 24})
            with autotune.use_db(autotune.TuningDB({bad.fingerprint: bad})):
                with warnings.catch_warnings(record=True) as w:
                    warnings.simplefilter("always")
                    knobs = autotune.launch_knobs("layer_norm",
                                                  (8192, 1024), "bfloat16")
            checks["c off-grid warns, defaults"] = knobs == {} and any(
                bad.fingerprint in str(x.message) for x in w)
        # (d) the committed DB
        db = autotune.TuningDB.load(DB_PATH)
        fams = {x.family for x in db.entries.values()}
        checks["d committed DB stale-free, every tuned family"] = (
            set(TUNED_FAMILIES) <= fams
            and all(x.sweep.get("mode") == "cuda"
                    and x.chip != "cpu" for x in db.entries.values()))
        checks["d every entry swept over the kernels it names"] = all(
            x.sweep.get("kernels") and set(x.sweep["kernels"]) <= set(
                KERNELS[x.family]) for x in db.entries.values())
        # (e) tune_report joins worst_gaps by family and dims
        gaps = [{"fingerprint": f"{x.family}|op|scope|bfloat16"
                                f"[{','.join(map(str, x.dims[:2]))}]",
                 "family": x.family, "op": "apex_tpu_torch::k",
                 "shape": f"bfloat16[{','.join(map(str, x.dims[:2]))}]",
                 "measured_us": 10.0, "attainable_us": 5.0, "gap_us": 5.0}
                for x in db.entries.values()]
        gaps.append({"fingerprint": "attention|op|scope|bfloat16[1,2]",
                     "family": "attention", "op": "k",
                     "shape": "bfloat16[1,2]", "gap_us": 1.0})
        rep = autotune.tune_report(db, gaps)
        checks["e tune_report join"] = (
            rep["n_covered"] == len(db.entries)
            and rep["uncovered_families"] == ["attention"])
        # (f) the tune events validate
        with tempfile.TemporaryDirectory() as tmp:
            evs = [_sweep_event(x) for x in db.entries.values()]
            evs += [autotune.tune_event(action, e.fingerprint, "layer_norm")
                    for action in ("hit", "miss", "refused")]
            try:
                _write_events(os.path.join(tmp, "tune.jsonl"), evs)
                checks["f tune events validate"] = len(evs) == 3 + len(
                    db.entries)
            except AssertionError as err:
                print(err)
                checks["f tune events validate"] = False
    finally:
        if prev is None:
            os.environ.pop("APEX_TPU_AUTOTUNE", None)
        else:
            os.environ["APEX_TPU_AUTOTUNE"] = prev
    for k, v in checks.items():
        print(f"  {'ok  ' if v else 'FAIL'} {k}")
    return 0 if all(checks.values()) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--update-db", action="store_true")
    mode.add_argument("--cpu-audit", action="store_true")
    ap.add_argument("--out", default=DB_PATH)
    ap.add_argument("--events", help="write the sweep's tune events here")
    ap.add_argument("--pairs", type=int, default=None,
                    help="pairs a candidate is timed in against the "
                         "default (autotune.SWEEP_PAIRS)")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if args.update_db:
        from apex_tpu_torch.ops import autotune
        return update_db(args.out, args.pairs or autotune.SWEEP_PAIRS,
                         args.iters, args.events)
    return cpu_audit()


if __name__ == "__main__":
    sys.exit(main())
