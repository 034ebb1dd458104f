#!/usr/bin/env python3
"""LayerNorm forward and backward and BN channel sums: this checkout's CUDA
kernels against another checkout's wrappers, in one process on one card.

    python3 scripts/torch_norm_ab.py --parent DIR [--out PATH]

``DIR`` holds another checkout's ``apex_tpu_torch`` package (for example
``git archive <commit> apex_tpu_torch | tar -x -C DIR``); its
``ln_fwd_kernel``, ``ln_bwd_kernel`` and ``bn_sums_kernel`` are loaded from
there, with its own ``ops/_build.py`` (its CUDA sources build into
``DIR/build``), beside this checkout's. First every shape and option of
this checkout's kernels is held against the plain versions (TOL16 / TOL32
of chip_smoke.py; the "addrelu" dr bit for bit; the "relu" mask through its
count, Σg with g = 1, exactly; the LayerNorm backward on every path of its
plan); then two launches of each are held bitwise equal; then both
checkouts' kernels are timed in turns (other, this, this, other) at the
main paths' shapes, by CUDA events (``chip_smoke.timed``) and by device
time (``chip_smoke.device_ms``), beside ``F.layer_norm`` (and its
autograd), ``torch.batch_norm_backward_reduce`` and the data-sheet byte
bound. Prints one JSON object (and writes it to ``--out``); the host time
of a call is also measured (``host_us``: calls enqueued behind a spin
kernel), and the LayerNorm forward is timed beside a copy of the same
bytes. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_parent(parent, names):
    """Op modules ``names`` of the checkout at ``parent``, each bound to
    that checkout's own ``_build`` (its sources, its build directory), so
    two versions of a CUDA entry point never share a library."""
    import apex_tpu_torch.ops as ops
    ops_dir = os.path.join(os.path.abspath(parent), "apex_tpu_torch", "ops")
    build = _load(os.path.join(ops_dir, "_build.py"), "other__build")
    saved = ops._build
    ops._build = build      # what ``from apex_tpu_torch.ops import _build``
    try:                    # finds while the modules execute
        return build, [_load(os.path.join(ops_dir, f"{n}.py"), f"other_{n}")
                       for n in names]
    finally:
        ops._build = saved


def check_layer_norm(rnd, L):
    """Every path of the forward against the plain version; returns the
    number of cases."""
    import torch
    from chip_smoke import compare
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    cases = [((8192, 1024), bf16, 1e-12, True), ((8192, 1024), bf16, 1e-5,
                                                 True),
             ((300, 1000), bf16, 1e-5, True), ((257, 300), bf16, 1e-5, True),
             ((64, 300), f32, 1e-5, True), ((33, 1024), f16, 1e-5, False),
             ((100, 768), f32, 1e-5, True), ((17, 64), bf16, 1e-5, True),
             ((50, 2048), bf16, 1e-5, True), ((40, 1500), f32, 1e-5, False),
             ((9, 4096), bf16, 1e-5, True), ((5, 65536), bf16, 1e-5, True),
             ((3, 70000), f32, 1e-5, True), ((4, 1), bf16, 1e-5, True)]
    for (n, h), dt, eps, affine in cases:
        x = (rnd(n, h, dtype=f32, std=2.0) + 0.5).to(dt)
        w = rnd(h, dtype=f32, std=0.2) + 1.0 if affine else None
        b = rnd(h, dtype=f32, std=0.2) if affine else None
        compare(f"layer_norm_fwd {n}x{h} {dt} eps={eps} affine={affine}",
                [L.ln_fwd_kernel(x, w, b, eps)],
                [L.ln_fwd_plain(x, w, b, eps)])
    # bases off 16 bytes (one element a load; f32 past 512 a block a row),
    # bf16 weights
    off = [((128, 1024), bf16), ((64, 300), f32), ((32, 1000), f32)]
    for (n, h), dt in off:
        x = rnd(n * h + 1, dtype=dt)[1:].view(n, h)
        w, b = rnd(h) + 1.0, rnd(h)
        compare(f"layer_norm_fwd {n}x{h} {dt} off 16 bytes, bf16 weights",
                [L.ln_fwd_kernel(x, w, b, 1e-5)],
                [L.ln_fwd_plain(x, w, b, 1e-5)])
    return len(cases) + len(off)


def check_bn_sums(rnd, B):
    """Every path of the sums against the plain version; returns the number
    of cases."""
    import torch
    from chip_smoke import compare
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    n = 0
    for (m, c), dt, gdt in (((3211264, 64), bf16, bf16),
                            ((802816, 256), bf16, bf16),
                            ((12544, 2048), bf16, bf16),
                            ((12345, 96), bf16, bf16),
                            ((4096, 64), f32, f32), ((1000, 100), bf16, bf16),
                            ((777, 48), f16, f16), ((3000, 40), bf16, f32),
                            ((5, 3), f32, bf16), ((1, 4096), bf16, bf16)):
        x = rnd(m, c, dtype=dt, std=2.0) + 0.5
        z = rnd(m, c, dtype=dt).clamp_min(0.0)
        scale, bias = rnd(c, std=0.3) + 1.0, rnd(c, std=0.3)
        x32 = x.float()
        mean = x32.mean(dim=0)
        invstd = torch.rsqrt(x32.var(dim=0, unbiased=False) + 1e-5)
        del x32
        g = (rnd(m, c, dtype=f32) * 1e-3).to(gdt)
        ones = torch.ones_like(g)
        for mode in ("plain", "relu", "addrelu"):
            args = (x, g, z, scale, bias, mean, invstd, mode, dt)
            ks, kdr = B.bn_sums_kernel(*args)
            ps, pdr = B.bn_sums_plain(*args)
            compare(f"bn_sums {m}x{c} {dt}/{gdt} {mode}", [ks], [ps])
            if mode == "addrelu" and not torch.equal(kdr, pdr):
                raise AssertionError(f"bn_sums {m}x{c} {mode}: dr differs "
                                     f"from the plain version")
            if mode == "relu":
                cnt = (B.bn_sums_kernel(x, ones, z, scale, bias, mean, invstd,
                                        mode)[0][0],
                       B.bn_sums_plain(x, ones, z, scale, bias, mean, invstd,
                                       mode)[0][0])
                if not torch.equal(*cnt):
                    raise AssertionError(f"bn_sums {m}x{c} relu: mask counts "
                                         f"differ")
            n += 1
        del x, z, g, ones
    # bases off 16 bytes take the scalar path
    m, c = 4096, 64
    xb, gb = rnd(m * c + 1), rnd(m * c + 1)
    x, g = xb[1:].view(m, c), gb[1:].view(m, c)
    mean = x.float().mean(dim=0)
    invstd = torch.rsqrt(x.float().var(dim=0, unbiased=False) + 1e-5)
    scale, bias = rnd(c) + 1.0, rnd(c)
    compare("bn_sums misaligned", [B.bn_sums_kernel(
        x, g, None, scale, bias, mean, invstd, "relu")[0]],
        [B.bn_sums_plain(x, g, None, scale, bias, mean, invstd, "relu")[0]])
    return n + 1


def check_determinism(rnd, L, B):
    import torch
    x = rnd(8192, 1024, std=2.0)
    w, b = rnd(1024, dtype=torch.float32) + 1.0, rnd(1024, dtype=torch.float32)
    if not torch.equal(L.ln_fwd_kernel(x, w, b, 1e-5),
                       L.ln_fwd_kernel(x, w, b, 1e-5)):
        raise AssertionError("layer_norm_fwd: two launches differ")
    m, c = 3211264, 64
    x, g = rnd(m, c, std=2.0), rnd(m, c, std=1e-3)
    z = rnd(m, c).clamp_min(0.0)
    mean = torch.zeros(c, device=x.device)
    invstd = torch.full((c,), 0.5, device=x.device)
    s = rnd(c)
    args = (x, g, z, s, s, mean, invstd, "addrelu", torch.bfloat16)
    (s1, d1), (s2, d2) = B.bn_sums_kernel(*args), B.bn_sums_kernel(*args)
    if not (torch.equal(s1, s2) and torch.equal(d1, d2)):
        raise AssertionError("bn_sums: two launches differ")


def host_us(fn, n=200):
    """Host microseconds of one ``fn()`` call: ``n`` calls enqueued behind
    a ~100 ms spin kernel, so the card never holds the host back."""
    import torch
    fn()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def measure(fn, flush):
    """Events ms, device ms and host us of one call."""
    from chip_smoke import device_ms, timed
    return {"ms": timed(fn, flush=flush),
            "device_ms": device_ms(fn, flush=flush), "host_us": host_us(fn)}


def turns(label, old, new, flush, out):
    """Times ``old`` and ``new`` in turns (old, new, new, old) by events,
    device time and host time; records the means of each."""
    runs = {"old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        runs[who].append(measure(old if who == "old" else new, flush))
    rec = {k: {key: sum(r[key] for r in v) / 2 for key in v[0]}
           for k, v in runs.items()}
    for k, v in runs.items():
        rec[k]["runs"] = v
    out[label] = rec
    print(f"{label}: other {rec['old']['ms']:.4f} ms (device "
          f"{rec['old']['device_ms']:.4f}, host {rec['old']['host_us']:.1f} "
          f"us), this {rec['new']['ms']:.4f} ms (device "
          f"{rec['new']['device_ms']:.4f}, host {rec['new']['host_us']:.1f} "
          f"us)", flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_norm_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from apex_tpu_torch.ops import _build, bn_act as B, layer_norm as L

    other_build, (PL, PB) = load_parent(args.parent,
                                        ("layer_norm", "bn_act"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    libs = _build.build_all()
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "build_s": time.perf_counter() - t0}
    other_build.build_all()
    mine = {k: v for k, v in libs.items() if k in ("layer_norm_fwd",
                                                    "layer_norm_bwd",
                                                    "bn_sums")}
    chip_smoke.echo_ptxas(mine)
    if args.out:     # the whole ptxas logs beside the JSON
        out_dir = os.path.dirname(os.path.abspath(args.out))
        os.makedirs(out_dir, exist_ok=True)
        for k, v in mine.items():
            shutil.copy(v.with_suffix(".ptxas.txt"),
                        os.path.join(out_dir, f"{k}.ptxas.txt"))

    rows = {}
    rnd, _gen, flush, _row = chip_smoke.bench_tools(rows)
    out["ln_cases"] = check_layer_norm(rnd, L)
    out["bn_cases"] = check_bn_sums(rnd, B)
    check_determinism(rnd, L, B)
    chip_smoke.check_ln_bwd_paths(rnd)
    chip_smoke.check_ln_bwd_determinism(rnd)
    print(f"checks: {out['ln_cases']} LayerNorm forward and "
          f"{out['bn_cases']} bn_sums cases and every path of the LayerNorm "
          f"backward agree with the plain versions; two launches of each "
          f"bitwise equal", flush=True)

    f32, bf16 = torch.float32, torch.bfloat16
    x = rnd(8192, 1024, std=2.0)
    w, b = rnd(1024, dtype=f32, std=0.2) + 1.0, rnd(1024, dtype=f32, std=0.2)
    wl, bl = w.to(bf16), b.to(bf16)
    rec = turns("layer_norm_fwd (8192, 1024) bf16",
                lambda: PL.ln_fwd_kernel(x, w, b, 1e-5),
                lambda: L.ln_fwd_kernel(x, w, b, 1e-5), flush, out)
    rec["library"] = measure(lambda: F.layer_norm(x, (1024,), wl, bl, 1e-5),
                             flush)
    # a copy of the same bytes: one read of x, one write
    rec["copy"] = measure(lambda: torch.empty_like(x).copy_(x), flush)
    print(f"  F.layer_norm {rec['library']}; copy {rec['copy']}", flush=True)
    rec["bound_ms"] = (2 * x.numel() * 2 + 2 * 1024 * 4) / \
        chip_smoke.HBM_BYTES_PER_S * 1e3
    g = rnd(8192, 1024)
    rec = turns("layer_norm_bwd (8192, 1024) bf16",
                lambda: PL.ln_bwd_kernel(g, x, w, 1e-5),
                lambda: L.ln_bwd_kernel(g, x, w, 1e-5), flush, out)
    xg, wg, bg = (t.detach().requires_grad_(True) for t in (x, wl, bl))
    yl = F.layer_norm(xg, (1024,), wg, bg, 1e-5)
    rec["library"] = measure(lambda: torch.autograd.grad(
        yl, (xg, wg, bg), g, retain_graph=True), flush)
    print(f"  autograd of F.layer_norm {rec['library']}", flush=True)
    rec["bound_ms"] = (3 * x.numel() * 2 + 3 * 1024 * 4) / \
        chip_smoke.HBM_BYTES_PER_S * 1e3
    del x, g, xg, yl

    for (m, c), modes, hw in (((3211264, 64), ("plain", "relu"), 112),
                              ((802816, 256), ("addrelu",), 56),
                              ((12544, 2048), ("plain",), 7)):
        x = rnd(m, c, std=2.0) + 0.5
        g = rnd(m, c, std=1e-3)
        z = rnd(m, c).clamp_min(0.0)
        scale, bias = rnd(c, std=0.3) + 1.0, rnd(c, std=0.3)
        mean = x.float().mean(dim=0)
        invstd = torch.rsqrt(x.float().var(dim=0, unbiased=False) + 1e-5)
        for mode in modes:
            a = (x, g, z, scale, bias, mean, invstd, mode, bf16)
            rec = turns(f"bn_sums ({m}, {c}) {mode}",
                        lambda: PB.bn_sums_kernel(*a),
                        lambda: B.bn_sums_kernel(*a), flush, out)
            ops = 4 if mode == "addrelu" else 2     # x, g (z, dr)
            rec["bound_ms"] = (ops * m * c * 2 + 4 * c * 4) / \
                chip_smoke.HBM_BYTES_PER_S * 1e3
            if mode == "plain":
                xl, gl = (t.view(m // (hw * hw), hw, hw, c).permute(0, 3, 1, 2)
                          for t in (x, g))
                wf = scale.float()
                lib = lambda: torch.batch_norm_backward_reduce(  # noqa: E731
                    gl, xl, mean, invstd, wf, True, True, True)
                rec["library"] = measure(lib, flush)
                print(f"  batch_norm_backward_reduce {rec['library']}",
                      flush=True)
        del x, g, z

    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
