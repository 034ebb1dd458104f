"""The Hopper LayerNorm forward and backward and BN channel-sums kernels,
on the CPU.

The kernels (``csrc/layer_norm_fwd.cu``, ``csrc/layer_norm_bwd.cu``,
``csrc/bn_sums.cu``) build and run only on the card, where chip_smoke.py
holds them against their plain versions, checks two launches bitwise equal
and times them by device time. Here: each source exports the entry point
its wrapper binds, with the argument struct the wrapper packs; the loads
are 16-byte vectors; the sums form their masks with rounded f32 operations
and add their partials without float atomics; the launch plans are pure
functions of the shape (``_ln_plan``, ``_ln_bwd_plan``, ``_bn_sums_plan``)
and cover every row once; a PyTorch model of the sums plan (block partials
over the plan's rows, added in block order) computes the plain version's
sums and dr, and the JAX package's Pallas sums kernel's; a PyTorch model
of the LN backward's dγ/dβ plan (warp slabs in row order, block partials
in warp order, group partials in block order, the result in group order)
computes the plain version's and the JAX package's Pallas backward's
(interpret mode). Also the profile script's categories and chip_smoke.py's
checks and device-time fields for these rows.
"""

import importlib.util
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from apex_tpu_torch.ops import compile_check
from apex_tpu.ops import bn_act as JB
from apex_tpu.ops import layer_norm as JL
from apex_tpu_torch.ops import bn_act as B
from apex_tpu_torch.ops import layer_norm as L

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "apex_tpu_torch" / "csrc"


def _struct_fields(src, name):
    """[(C type, field)] of ``struct name { ... };`` in a source."""
    body = src[src.index(f"struct {name} {{"):]
    body = body[body.index("{") + 1:body.index("};")]
    out = []
    for decl in re.sub(r"//.*", "", body).split(";"):
        decl = decl.strip()
        if decl:
            ctype, names = re.match(r"(long long|double|float|int)\s+(.*)",
                                    decl, re.S).groups()
            out += [(ctype, n.strip()) for n in names.split(",")]
    return out


@pytest.mark.parametrize("name,entry,struct,fields,packer,last", [
    ("layer_norm_fwd.cu", "apex_ln_fwd", "LnCall", L.LN_CALL_FIELDS,
     L._LN_CALL, "double"),
    ("layer_norm_bwd.cu", "apex_ln_bwd", "LnBwdCall", L.LN_BWD_CALL_FIELDS,
     L._LN_BWD_CALL, "double"),
    ("bn_sums.cu", "apex_bn_sums", "SumsCall", B.SUMS_CALL_FIELDS,
     B._SUMS_CALL, "long long"),
])
def test_sources_export_the_entry_point_the_wrapper_packs(
        name, entry, struct, fields, packer, last):
    """``extern "C" int <entry>(const <Struct>* k, void* stream)``, and the
    struct's fields are the wrapper's, in its order, 64 bits each."""
    src = (CSRC / name).read_text()
    assert re.search(rf'extern "C" int {entry}\(const {struct}\* k, '
                     r"void\* stream\)", src)
    got = _struct_fields(src, struct)
    assert [f for _, f in got] == list(fields)
    assert [t for t, _ in got] == ["long long"] * (len(fields) - 1) + [last]
    assert packer.size == 8 * len(fields)


def test_bn_sums_masks_are_rounded_and_no_float_atomics():
    src = re.sub(r"//.*", "", (CSRC / "bn_sums.cu").read_text())
    assert "__fmul_rn(__fsub_rn(L::get(rx[u], j), mu[j]), is[j])" in src
    assert "__fadd_rn(__fmul_rn(xh, sc[j]), bi[j]) > 0.f" in src
    # the one atomic is the integer ticket of the last-block stage 2
    assert re.findall(r"atomicAdd\(([^,]+),", src) == [
        "&a.counters[blockIdx.y]"]
    assert "__threadfence()" in src and "a.counters[blockIdx.y] = 0" in src
    assert "atomicAdd" not in (CSRC / "layer_norm_fwd.cu").read_text()


def _with_headers(name):
    """A source's text with the text of the repo headers it includes."""
    src = (CSRC / name).read_text()
    for header in re.findall(r'#include "([^"]+)"', src):
        src += (CSRC / header).read_text()
    return src


@pytest.mark.parametrize("name", ["layer_norm_fwd.cu", "bn_sums.cu",
                                  "layer_norm_bwd.cu"])
def test_sources_load_and_store_16_byte_vectors(name):
    src = _with_headers(name)
    assert "__ldg(reinterpret_cast<const uint4*>(" in src
    assert "*reinterpret_cast<uint4*>(" in src


def test_the_triton_kernels_are_gone():
    assert not hasattr(L, "_ln_fwd_triton")
    assert not hasattr(B, "_bn_sums_triton")
    for mod in (L, B):
        src = inspect.getsource(mod)
        assert "_ln_fwd_triton" not in src and "_bn_sums_triton" not in src
    # the sums' stage 2 is in the launch, not a second torch.sum launch
    assert "part.sum(" not in inspect.getsource(B.bn_sums_kernel)


@pytest.mark.parametrize("h,itemsize,aligned,want", [
    (1024, 2, True, (L._VECTOR, 32)),      # BERT-Large, bf16
    (1024, 2, False, (L._SCALAR, 32)),     # a base off 16 bytes
    (1000, 2, True, (L._VECTOR, 32)),      # 125 vectors, ragged lanes
    (300, 2, True, (L._SCALAR, 16)),       # 600-byte rows
    (300, 4, True, (L._VECTOR, 16)),       # 1200-byte f32 rows
    (300, 4, False, (L._SCALAR, 16)),
    (1000, 4, False, (L._STAGED, 0)),      # f32 scalar rows past 512
    (1001, 2, True, (L._SCALAR, 32)),
    (768, 4, True, (L._VECTOR, 32)),
    (96, 2, True, (L._VECTOR, 8)),
    (1, 2, True, (L._SCALAR, 8)),
    (2048, 2, True, (L._VECTOR, 64)),
    (2049, 2, True, (L._STAGED, 0)),
    (65536, 2, True, (L._STAGED, 0)),      # 128 KB staged
    (57856, 4, True, (L._STAGED, 0)),
    (57857, 4, True, (L._STREAMED, 0)),
])
def test_ln_plan(h, itemsize, aligned, want):
    assert L._ln_plan(h, itemsize, aligned) == want


def test_ln_plan_takes_vectors_only_on_whole_aligned_rows():
    for h in range(1, 2200, 7):
        for itemsize in (2, 4):
            for aligned in (False, True):
                path, epl = L._ln_plan(h, itemsize, aligned)
                if path == L._VECTOR:
                    assert aligned and (h * itemsize) % 16 == 0
                if path in (L._VECTOR, L._SCALAR):
                    assert epl in L._EPL and 32 * epl >= h
                    assert epl == L._EPL[0] or 16 * epl < h
                    if path == L._SCALAR and itemsize == 4:
                        assert epl <= L._SCALAR_F32_EPL
                else:
                    assert epl == 0 and (h > 32 * L._EPL[-1] or (
                        itemsize == 4 and h > 32 * L._SCALAR_F32_EPL))


PLAN_CASES = [(m, c, sms, vec)
              for m in (1, 7, 128, 1000, 12345, 802816, 3211264)
              for c in (1, 3, 64, 96, 256, 2048, 5000)
              for sms in (1, 132)
              for vec in (1, 4, 8)]


def test_bn_sums_plan_covers_every_row_once():
    for m, c, sms, vec in PLAN_CASES:
        tpr, tiles, rows, blocks = B._bn_sums_plan(m, c, sms, vec)
        assert tpr in (1, 2, 4, 8, 16, 32)
        assert (tiles - 1) * tpr * vec < c <= tiles * tpr * vec
        assert rows % (B._THREADS // tpr * B._UNROLL) == 0
        assert (blocks - 1) * rows < m <= blocks * rows
        assert blocks * tiles <= max(tiles, B._BLOCKS_PER_SM * sms)
        assert B._bn_sums_plan(m, c, sms, vec) == (tpr, tiles, rows, blocks)


def test_bn_sums_plan_at_resnet50():
    # the stem: 8 threads a 64-channel row, 64 rows a load, a block an SM
    assert B._bn_sums_plan(3211264, 64, 132, 8) == (8, 1, 24576, 131)
    # layer 4: 8 tiles of 256 channels
    tpr, tiles, rows, blocks = B._bn_sums_plan(12544, 2048, 132, 8)
    assert (tpr, tiles) == (32, 8) and blocks * tiles <= 132


def _sums_model(x2, g2, z2, scale, bias, mean, invstd, mode, r_dtype, sms,
                vec):
    """The kernel's plan in PyTorch: per channel tile and row block the
    plain sums of the block's rows (one partial), then the partials added
    in row-block order; dr assembled from the blocks."""
    m, c = x2.shape
    tpr, tiles, rows, blocks = B._bn_sums_plan(m, c, sms, vec)
    sums = torch.zeros(2, c)
    dr = torch.empty(m, c, dtype=r_dtype) if mode == "addrelu" else None
    for t in range(tiles):
        ch = slice(t * tpr * vec, min(c, (t + 1) * tpr * vec))
        acc = torch.zeros(2, ch.stop - ch.start)
        for b in range(blocks):
            r = slice(b * rows, min(m, (b + 1) * rows))
            part, d = B.bn_sums_plain(
                x2[r, ch], g2[r, ch], None if z2 is None else z2[r, ch],
                scale[ch], bias[ch], mean[ch], invstd[ch], mode, r_dtype)
            acc = acc + part
            if d is not None:
                dr[r, ch] = d
        sums[:, ch] = acc
    return sums, dr


def _unit_inputs(m, c, seed, exact):
    """x, g, z (m, c) and per-channel vectors. ``exact``: values on a
    1/64 grid with mean 0 and invstd 1, so every product and sum of the
    sums is exact in f32 in any order."""
    rng = np.random.RandomState(seed)
    if exact:
        x = rng.randint(-128, 129, (m, c)) / 64.0
        g = rng.randint(-64, 65, (m, c)) / 64.0
        mean, invstd = np.zeros(c), np.ones(c)
    else:
        x = rng.randn(m, c) * 2.0 + 0.5
        g = (rng.randn(m, c) + rng.randn(c) * 0.5) * 1e-2
        mean, invstd = x.mean(0), 1.0 / np.sqrt(x.var(0) + 1e-5)
    z = np.maximum(rng.randn(m, c), 0.0)
    scale, bias = rng.randn(c) * 0.3 + 1.0, rng.randn(c) * 0.3
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return (f32(x), f32(g), f32(z), f32(scale), f32(bias), f32(mean),
            f32(invstd))


@pytest.mark.parametrize("mode", ["plain", "relu", "addrelu"])
@pytest.mark.parametrize("m,c", [(12345, 96), (4096, 64)])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("vec", [1, 8])
def test_bn_sums_plan_model_matches_the_plain_version(m, c, mode, exact,
                                                      vec):
    x, g, z, scale, bias, mean, invstd = _unit_inputs(m, c, 7, exact)
    args = (x, g, z, scale, bias, mean, invstd, mode, torch.float32)
    want, want_dr = B.bn_sums_plain(*args)
    got, dr = _sums_model(*args, sms=132, vec=vec)
    if exact:
        assert torch.equal(got, want)
    else:
        # f32 sums in another order: within 1e-6 of the sum of |terms|
        gm = torch.where(B._relu_mask(B._xhat(x, mean, invstd), scale, bias)
                         if mode == "relu" else
                         (z > 0 if mode == "addrelu" else torch.ones_like(
                             x, dtype=torch.bool)), g, 0.0)
        xh = B._xhat(x, mean, invstd)
        scale_of = torch.stack([gm.abs().sum(0), (gm * xh).abs().sum(0)])
        assert ((got - want).abs() <= 1e-6 * scale_of).all()
    if mode == "addrelu":
        assert torch.equal(dr, want_dr)
    else:
        assert dr is None and want_dr is None


@pytest.mark.parametrize("mode,relu,residual", [
    ("plain", False, False), ("relu", True, False), ("addrelu", True, True)])
def test_bn_sums_plan_model_matches_the_jax_pallas_kernel(mode, relu,
                                                          residual):
    """The plan's model against the JAX package's ``_sums_kernel`` (the
    Pallas backward in interpret mode): Σg·x̂ is dscale, Σg dbias."""
    m, c = 4096, 64
    x, g, z, scale, bias, mean, invstd = _unit_inputs(m, c, 11, True)
    cfg = JB.make_cfg(relu=relu)
    out = JB._bwd_pallas(
        cfg, jnp.asarray(x.numpy()), jnp.asarray(scale.numpy()),
        jnp.asarray(bias.numpy()), jnp.asarray(mean.numpy()),
        jnp.asarray(invstd.numpy()), float(m), jnp.asarray(z.numpy()),
        jnp.asarray(g.numpy()), residual, jnp.float32,
        JB._bwd_row_block(m, c))
    dscale, dbias = np.asarray(out[-2]), np.asarray(out[-1])
    got, dr = _sums_model(x, g, z, scale, bias, mean, invstd, mode,
                          torch.float32, sms=132, vec=8)
    np.testing.assert_array_equal(got[0].numpy(), dbias)
    np.testing.assert_array_equal(got[1].numpy(), dscale)
    if residual:
        np.testing.assert_array_equal(dr.numpy(), np.asarray(out[1]))


def test_bn_sums_workspace_is_cached_and_grows():
    dev = torch.device("cpu")
    key = -1
    B._sums_buffers.pop(key, None)
    part, counters = B._sums_workspace(dev, -1, 100, 3)
    assert part.numel() == 100 and counters.tolist() == [0, 0, 0]
    again = B._sums_workspace(dev, -1, 50, 2)
    assert again[0] is part and again[1] is counters
    bigger = B._sums_workspace(dev, -1, 200, 5)
    assert bigger[0].numel() == 200 and bigger[1].tolist() == [0] * 5
    B._sums_buffers.pop(key)


@pytest.mark.parametrize("h", [300, 1000])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_ln_forward_at_ragged_widths_matches_jax(h, eps):
    """H = 300 (600-byte bf16 rows: the kernel's scalar path) and 1000 as
    the JAX kernel (interpret mode) computes them, N(0, 2) + 0.5 rows."""
    rng = np.random.RandomState(h)
    x = (rng.randn(6, h) * 2.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.2 * rng.randn(h)).astype(np.float32)
    b = (0.2 * rng.randn(h)).astype(np.float32)
    for jdt, tdt, atol in ((jnp.float32, torch.float32, 1e-5),
                           (jnp.bfloat16, torch.bfloat16, 2e-2)):
        jy = JL.fused_layer_norm_affine(jnp.asarray(x, jdt), jnp.asarray(w),
                                        jnp.asarray(b), eps)
        ty = L.ln_fwd_plain(torch.tensor(x).to(tdt), torch.tensor(w),
                            torch.tensor(b), eps)
        np.testing.assert_allclose(ty.float().numpy(),
                                   np.asarray(jy.astype(jnp.float32)),
                                   atol=atol, rtol=0)


def _profile_script():
    spec = importlib.util.spec_from_file_location(
        "torch_bert_profile", ROOT / "scripts" / "torch_bert_profile.py")
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    return prof


@pytest.mark.parametrize("kernel,category", [
    ("void (anonymous namespace)::ln_fwd_warp<__nv_bfloat16, 8, 4>("
     "(anonymous namespace)::LnArgs)", "layer_norm"),
    ("void (anonymous namespace)::ln_fwd_block<float, true>("
     "(anonymous namespace)::LnArgs)", "layer_norm"),
    ("void (anonymous namespace)::ln_bwd_warp<__nv_bfloat16, 8, 4>("
     "(anonymous namespace)::LnBwdArgs)", "layer_norm"),
    ("void (anonymous namespace)::bn_sums<(anonymous namespace)::Vec16<"
     "__nv_bfloat16>, 2>((anonymous namespace)::SumsArgs)", "bn_sums"),
    ("void (anonymous namespace)::bn_sums<(anonymous namespace)::Scalar, 0>("
     "(anonymous namespace)::SumsArgs)", "bn_sums"),
    ("_bn_dx_triton", "bn_dx"),
])
def test_profile_categories_name_the_cuda_kernels(kernel, category):
    assert _profile_script()._category(kernel) == category


@pytest.mark.parametrize("mangled,name", [
    ("_ZN50_GLOBAL__N__bad511d9_17_layer_norm_fwd_cu_1ce94e0711ln_fwd_warpI"
     "13__nv_bfloat16Li8ELi4EEEvNS_6LnArgsE", "ln_fwd_warp<bf16, CH=8, NC=4>"),
    ("_ZN50_GLOBAL__N__bad511d9_17_layer_norm_fwd_cu_1ce94e0712ln_fwd_blockI"
     "fLb1EEEvNS_6LnArgsE", "ln_fwd_block<f32, staged=1>"),
    ("_ZN43_GLOBAL__N__59a5b306_10_bn_sums_cu_60c800317bn_sumsINS_5Vec16I13"
     "__nv_bfloat16EELi2EEEvNS_8SumsArgsE", "bn_sums<bf16 x8, addrelu>"),
    ("_ZN43_GLOBAL__N__59a5b306_10_bn_sums_cu_60c800317bn_sumsINS_5Vec16IfEE"
     "Li1EEEvNS_8SumsArgsE", "bn_sums<f32 x4, relu>"),
    ("_ZN43_GLOBAL__N__59a5b306_10_bn_sums_cu_60c800317bn_sumsINS_6ScalarE"
     "Li0EEEvNS_8SumsArgsE", "bn_sums<scalar, plain>"),
    ("_ZN50_GLOBAL__N__214453cf_17_layer_norm_bwd_cu_1be0e6db11ln_bwd_warpI"
     "13__nv_bfloat16Li8ELi4EEEvNS_9LnBwdArgsE",
     "ln_bwd_warp<bf16, CH=8, NC=4>"),
    ("_ZN50_GLOBAL__N__214453cf_17_layer_norm_bwd_cu_1be0e6db12ln_bwd_blockI"
     "fLb0EEEvNS_9LnBwdArgsE", "ln_bwd_block<f32, staged=0>"),
    ("_ZN43_GLOBAL__N__cccf732f_10_mlp_fwd_cu_5fa31bb59mlp_fusedI13__nv_"
     "bfloat16EEvNS_9FusedArgsE", "mlp_fused<bf16>"),
    ("_ZN43_GLOBAL__N__cccf732f_10_mlp_fwd_cu_5fa31bb59mlp_layerI6__halfEEvNS_"
     "9LayerArgsE", "mlp_layer<fp16>"),
])
def test_ptxas_report_names_the_new_instances(mangled, name):
    assert chip_smoke._instance_name(mangled) == name


def _row_call(src, name):
    """The text of ``row("<name>", ...)`` in a function's source."""
    start = src.index(f'row("{name}"')
    depth, i = 0, src.index("(", start)
    while True:
        depth += {"(": 1, ")": -1}.get(src[i], 0)
        if depth == 0:
            return src[start:i + 1]
        i += 1


@pytest.mark.parametrize("fn,names", [
    ("check_kernels", ["layer_norm_fwd", "layer_norm_bwd", "xentropy_fwd",
                       "xentropy_bwd"]),
    ("time_bn_kernels", ["bn_sums", "bn_dx"]),
    ("time_mlp_kernel", ["mlp_fwd"]),
    ("time_arena_kernels", ["multi_tensor_l2norm"]),
    ("time_adam_kernel", ["adam"]),
])
def test_chip_smoke_rows_carry_device_time(fn, names):
    """Rows 1-4, 12-14, 15a and 15g (15d below) carry device_ms and
    library_device_ms."""
    src = inspect.getsource(getattr(chip_smoke, fn))
    for name in names:
        call = _row_call(src, name)
        assert "dev_ms=" in call and "lib_dev_ms=" in call, name


def test_chip_smoke_maxnorm_row_carries_device_time():
    """Rows 15d-f and 15i-j: every row of the loop carries device_ms, and
    library_device_ms where a library call exists (15d, 15e, 15i)."""
    src = inspect.getsource(chip_smoke.time_arena_remainder)
    assert "dev_ms=device_ms(kernel, flush=flush), lib_dev_ms=lib_dev" in src
    assert "None if lib is None else device_ms(lib, flush=flush)" in src
    assert "ada_lib_dev = device_ms(ada, flush=flush)" in src


@pytest.mark.parametrize("fn,names,lib", [
    ("time_arena_kernels", ["lamb_stage1", "lamb_stage2"], False),
    ("time_sgd_kernel", ["sgd"], True),
])
def test_chip_smoke_remaining_rows_carry_device_time(fn, names, lib):
    """Rows 15b-c (no library call) and 15h (``torch._fused_sgd_``)."""
    src = inspect.getsource(getattr(chip_smoke, fn))
    for name in names:
        call = _row_call(src, name)
        assert "dev_ms=device_ms(" in call, name
        assert ("lib_dev_ms=" in call) == lib, name


def test_chip_smoke_checks_the_new_kernels():
    assert chip_smoke.SOURCES["layer_norm_fwd"] == (
        "cuda", "apex_tpu_torch/csrc/layer_norm_fwd.cu")
    assert chip_smoke.SOURCES["bn_sums"] == (
        "cuda", "apex_tpu_torch/csrc/bn_sums.cu")
    # the checks are the compile check's cases, which chip_smoke's phase
    # compile_check runs; its kernel phase keeps the timings
    assert "compile_check.run(" in inspect.getsource(
        chip_smoke.compile_check_phase)
    cases = dict(compile_check.CASES)
    det = inspect.getsource(cases["kernels/norm-determinism"])
    assert det.count("torch.equal") == 3 and '"addrelu"' in det
    bn = inspect.getsource(cases["kernels/bn"])
    assert "_check_bn_masks(" in bn and "_check_bn_dx_faults(" in bn
    assert "time_bn_sums(" in inspect.getsource(chip_smoke.time_bn_kernels)
    masks = inspect.getsource(compile_check._check_bn_masks)
    assert "torch.equal(kdr, pdr)" in masks and "torch.ones_like(g)" in masks
    paths = inspect.getsource(cases["kernels/layer_norm-paths"])
    assert "(512, 300)" in paths and "[1:].view(n, h)" in paths


# --- the LayerNorm backward --------------------------------------------------

def test_ln_bwd_staged_bytes_are_the_sources():
    src = (CSRC / "layer_norm_bwd.cu").read_text()
    assert "kMaxStagedBwd = kMaxStaged - 8192;" in src
    assert L._BWD_MAX_STAGED == L._MAX_STAGED - 8192


def test_ln_bwd_has_no_float_atomics():
    """The atomics are the integer tickets of the in-launch sum of the
    partials (one a block, one a finisher); the last finisher sets both
    counters back to 0; the finishers wait with an acquire load and a
    watchdog."""
    src = re.sub(r"//.*", "", (CSRC / "layer_norm_bwd.cu").read_text())
    assert re.findall(r"atomicAdd\(([^,]+),", src) == [
        "&a.counters[0]", "&a.counters[1]"]
    assert "fence.acq_rel.gpu;" in src
    assert "a.counters[0] = 0;" in src and "a.counters[1] = 0;" in src
    assert "ld.acquire.gpu.global.b32" in src and "__trap()" in src
    assert "__ldcg(" in src


def test_the_ln_backward_is_cuda():
    src = inspect.getsource(L)
    assert not hasattr(L, "_ln_bwd_triton") and "_ln_bwd_triton" not in src
    assert "triton" not in src.lower()
    assert "part.sum(" not in inspect.getsource(L.ln_bwd_kernel)
    assert 'load("layer_norm_bwd")' in inspect.getsource(L._ln_bwd_lib)


LN_BWD_PLANS = [(n, h, itemsize, aligned)
                for n in (1, 5, 7, 8, 9, 300, 2049, 8192, 12293)
                for h in (1, 64, 300, 512, 1000, 1024, 2048, 4096, 70000)
                for itemsize in (2, 4) for aligned in (False, True)]


def test_ln_bwd_plan_covers_every_row_once():
    """Every row belongs to one (block, warp) of the plan; at most 256
    blocks (the finishers' 16 chunks of 16 partials); on the warp paths no
    more blocks than runs of 8 rows; a staged row holds x and g."""
    for n, h, itemsize, aligned in LN_BWD_PLANS:
        path, epl, rows, blocks = L._ln_bwd_plan(n, h, itemsize, aligned)
        assert (path, epl) == L._ln_plan(h, itemsize, aligned) or (
            path == L._STREAMED and L._ln_plan(h, itemsize, aligned)[0]
            == L._STAGED and 2 * h * itemsize > L._BWD_MAX_STAGED)
        if path == L._STAGED:
            assert 2 * h * itemsize <= L._BWD_MAX_STAGED
        assert 1 <= blocks <= L._BWD_BLOCKS <= 16 * 16
        assert (blocks - 1) * rows < n <= blocks * rows
        warps = L._WARPS if path in (L._SCALAR, L._VECTOR) else 1
        assert blocks <= -(-n // warps)
        seen = np.zeros(n, dtype=np.int64)
        for b in range(blocks):
            for w in range(warps):
                seen[b * rows + w:min(n, (b + 1) * rows):warps] += 1
        assert (seen == 1).all()


def test_ln_bwd_plan_at_bert_large():
    """(8192, 1024) bf16: 256 blocks of 32 rows (4 a warp)."""
    assert L._ln_bwd_plan(8192, 1024, 2, True) == (L._VECTOR, 32, 32, 256)
    assert L._ln_bwd_plan(300, 1000, 2, True) == (L._VECTOR, 32, 8, 38)
    assert L._ln_bwd_plan(5, 1024, 2, True)[2:] == (5, 1)


def _ln_bwd_model(g2, x2, w, eps, itemsize):
    """The kernel's dγ/dβ plan in PyTorch: each warp adds g·x̂ and g of its
    rows (every 8th of its block's run; every row on the block paths) in
    row order, the block adds its warps' sums in warp order, the finishers
    add each chunk of 16 block partials in block order and the chunks'
    sums in chunk order."""
    n, h = x2.shape
    path, _, rows, blocks = L._ln_bwd_plan(n, h, itemsize, True)
    x, g = x2.float(), g2.float()
    mean, var = L._moments(x)
    xhat = (x - mean) * torch.rsqrt(var + eps)
    terms = torch.cat([g * xhat, g], dim=1)
    warps = L._WARPS if path in (L._SCALAR, L._VECTOR) else 1

    def in_order(parts):
        acc = torch.zeros(2 * h)
        for p in parts:
            acc = acc + p
        return acc

    partials = [in_order(in_order(terms[r] for r in range(
        b * rows + w, min(n, (b + 1) * rows), warps)) for w in range(warps))
        for b in range(blocks)]
    out = in_order(in_order(partials[q:q + 16]) for q in range(0, blocks, 16))
    return out[:h], out[h:]


@pytest.mark.parametrize("n,h,itemsize", [(320, 1024, 2), (2100, 64, 2),
                                          (300, 1000, 2), (257, 512, 4),
                                          (9, 4096, 2)])
def test_ln_bwd_model_matches_the_plain_version_and_jax(n, h, itemsize):
    """BERT's width at a few hundred rows, 2100 narrow rows (234 blocks: 15
    chunks of partials), a ragged 300 x 1000, f32 rows of 512 and a block a
    row: the
    model's dγ and dβ within 1e-5 of each output's largest magnitude of
    ``ln_bwd_plain``'s and of the JAX ``_ln_backward``'s (interpret mode):
    f32 sums in another order."""
    rng = np.random.RandomState(n + h)
    x = (rng.randn(n, h) * 2.0 + 0.5).astype(np.float32)
    g = rng.randn(n, h).astype(np.float32)
    w = (1.0 + 0.2 * rng.randn(h)).astype(np.float32)
    got = _ln_bwd_model(torch.tensor(g), torch.tensor(x), torch.tensor(w),
                        1e-5, itemsize)
    _, pw, pb = L.ln_bwd_plain(torch.tensor(g), torch.tensor(x),
                               torch.tensor(w), 1e-5)
    _, jw, jb = JL._ln_backward(jnp.asarray(g), jnp.asarray(x),
                                jnp.asarray(w), 1e-5)
    for mine, refs in zip(got, ((pw, jw), (pb, jb))):
        for ref in refs:
            ref = np.asarray(ref, dtype=np.float32)
            np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max())
    if n == 2100:
        assert L._ln_bwd_plan(n, h, itemsize, True)[3] == 234


def test_chip_smoke_checks_the_ln_backward():
    assert chip_smoke.SOURCES["layer_norm_bwd"] == (
        "cuda", "apex_tpu_torch/csrc/layer_norm_bwd.cu")
    cases = dict(compile_check.CASES)
    paths = inspect.getsource(cases["kernels/layer_norm-bwd-paths"])
    for shape in ("(300, 1000)", "(9, 4096)", "(6, 8192)", "(3, 70000)",
                  "(5, 1024)", "[1:].view(n, h)"):
        assert shape in paths, shape
    assert "L._SCALAR, L._VECTOR, L._STAGED, L._STREAMED" in paths
    det = inspect.getsource(cases["kernels/layer_norm-bwd-determinism"])
    assert "torch.equal(a, b)" in det and '"dgamma", "dbeta"' in det
    assert chip_smoke.EXPECTED_PER_STEP["layer_norm_bwd"] == 49
