"""The generic flash kernels' tensor-core design, on the CPU.

``csrc/flash_attn_generic.cu`` takes every flash call the wgmma kernels
refuse (f32, and 16-bit at any D outside {32, 64, 128}) and runs its
products on warp-level ``mma.sync``: m16n8k16 at 16 bits, and at f32
three m16n8k8 TF32 products a product (3×TF32: x = hi + lo, hi·hi + hi·lo
+ lo·hi). The kernels build and run only on the card, where
``python -m apex_tpu_torch.ops`` (``kernels/flash-generic``) holds them
against their plain versions. Here: (a) the source issues those MMAs,
loads by ``cp.async``, has no atomics and no FFMA product loop, and keeps
the ABI the wrapper binds; (b) the 3×TF32 split, emulated in numpy with
the kernels' own rounding, keeps BERT-Large's f32 attention scores within
1e-6 of float64 (relative to Σ|q_i·k_i|) where a single TF32 product does
not; and the bounds the profiler and ``chip_smoke.py`` price f32 rows at.
The plain path against the JAX kernels in interpret mode, and
``attention.kernel_route``, are ``tests/test_torch_attention_generic.py``'s.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from apex_tpu_torch.ops import compile_check
from apex_tpu_torch.prof import cost, report
from apex_tpu_torch.prof.xplane import category

CSRC = Path(__file__).resolve().parents[1] / "apex_tpu_torch" / "csrc"
SRC = (CSRC / "flash_attn_generic.cu").read_text()
CODE = re.sub(r"//.*", "", SRC)         # the source without its comments


# --- (a) the source ----------------------------------------------------------

@pytest.mark.parametrize("ptx", [
    "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
    "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32",
    "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
    "ldmatrix.sync.aligned.m8n8.x4.shared.b16",
    "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
    "cp.async.cg.shared.global",
    "cp.async.ca.shared.global",
    "cp.async.commit_group",
    "cp.async.wait_group",
])
def test_generic_source_runs_on_mma_sync_and_cp_async(ptx):
    assert ptx in CODE, ptx


def test_generic_source_has_no_ffma_product_or_atomic():
    """No product loop on the CUDA cores is left (the old kernels'
    ``mm`` chained ``fmaf`` over shared-memory floats), and no atomics: dQ
    and dK/dV are two kernels, so two launches repeat bit for bit."""
    for gone in ("fmaf(", "atomicAdd", "atomic", "load_tile<", "mm<R",
                 "wmma"):
        assert gone not in CODE, gone
    # every product goes through the two MMA helpers
    assert CODE.count("mma16<T>(") >= 4 and CODE.count("mma3(") >= 4


def test_generic_source_splits_f32_into_three_tf32_products():
    """3×TF32: hi = tf32(x), lo = tf32(x − hi), each rounded to nearest
    with ties away from zero as cvt.rna.tf32.f32 rounds (half a TF32 ulp
    added, the 13 low bits cleared), and the products hi·lo, lo·hi, hi·hi
    on m16n8k8.tf32; a single TF32 product is never the result."""
    assert "(__float_as_uint(x) + 0x1000u) & 0xFFFFE000u" in CODE
    split = re.search(r"void split\(float x, uint32_t& hi, uint32_t& lo\)"
                      r" \{(.*?)\n\}", CODE, re.S).group(1)
    assert "hi = tf32_rna(x);" in split
    assert "lo = tf32_rna(x - __uint_as_float(hi));" in split
    mma3 = re.search(r"void mma3\(.*?\{(.*?)\n\}", CODE, re.S).group(1)
    assert mma3.count("mma_tf32(d, ") == 3
    assert "mma_tf32(d, al, bh0, bh1)" in mma3
    assert "mma_tf32(d, ah, bl0, bl1)" in mma3
    assert "mma_tf32(d, ah, bh0, bh1)" in mma3
    # outside mma3 no TF32 product runs
    assert CODE.count("mma_tf32(") == 4      # the definition and mma3's three


@pytest.mark.parametrize("entry", ["apex_flash_attn_generic_fwd",
                                   "apex_flash_attn_generic_bwd"])
def test_generic_source_keeps_its_abi(entry):
    """The C entry points the wrapper binds: (dtype, D, FlashArgs*,
    stream)."""
    assert re.search(rf'extern "C" int {entry}\(int dtype, int d,\s+'
                     r"const FlashArgs\* a,\s+void\* stream\)", SRC)


@pytest.mark.parametrize("kernel", ["flash_fwd_generic",
                                    "flash_bwd_dq_generic",
                                    "flash_bwd_dkv_generic"])
def test_generic_kernels_keep_their_names(kernel):
    """The kernels the profiler's categories and the ptxas report name."""
    assert re.search(rf"__global__ void __launch_bounds__\(kThreads, "
                     rf"Tiles<T, DP>::(FWD|DQ|DKV)_MINB\)\s+{kernel}\(", SRC)
    assert category(f"void (anonymous namespace)::{kernel}<float, 64>"
                    f"(apex_flash::FlashArgs, int, Vecs)") == "flash_attn"
    mangled = (f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}I13__nv_bfloat16"
               f"Li128EEEvN10apex_flash9FlashArgsEiNS_4VecsE")
    assert chip_smoke._instance_name(mangled) == f"{kernel}<bf16, DP=128>"
    mangled = mangled.replace("13__nv_bfloat16", "f").replace("128", "256")
    assert chip_smoke._instance_name(mangled) == f"{kernel}<f32, DP=256>"


def test_generic_source_documents_what_it_replaces_and_its_bound():
    head = SRC.split("#include")[0]
    for name in ("_fwd_kernel_nl", "_fwd_kernel", "_bwd_fused_kernel_nl",
                 "_bwd_dq_kernel_nl", "_bwd_dkv_kernel_nl", "_bwd_dq_kernel",
                 "_bwd_dkv_kernel", "What bounds it on an H100",
                 "494.7 TFLOP/s", "Design."):
        assert name in head, name


def test_generic_source_pads_d_only_to_the_mma_depth():
    """Three width classes; within one, the k steps and output n8 tiles
    follow the runtime D, and padding is zero-filled only up to the MMA's
    depth (16 at 16 bits, 8 at f32), so D = 80 reads no padding."""
    dispatch = re.search(r"int dispatch\(.*?\n\}", CODE, re.S).group(0)
    assert re.findall(r"<T, (\d+)>\(a, d, st\)", dispatch) == [
        "64", "64", "128", "128", "256", "256"]
    assert "static constexpr int KS = F32 ? 8 : 16;" in CODE
    assert "const int nk = (D + G::KS - 1) / G::KS, nd = (D + 7) / 8;" in CODE
    assert CODE.count("zero_pad<T, LDR, G::KS>(") == 3
    assert "static_assert(dkv_bytes <= 232448" in CODE
    assert "if (2 * (g0 + q) < nd)" in CODE and "if (g0 + q < nd)" in CODE


def test_generic_copies_narrow_for_unaligned_rows():
    """Copy widths come from each operand's base, strides and D: 16 bytes
    where all allow it, else 8 or 4 (2 at 16 bits, by plain loads), and
    the zero-fill form (source size 0) past S."""
    vec = re.search(r"int vec_of\(.*?\n\}", CODE, re.S).group(0)
    assert "for (int w = 16; w > e; w /= 2)" in vec
    for term in ("(uintptr_t)p % w == 0", "(bs * e) % w == 0",
                 "(rs * e) % w == 0", "(d * e) % w == 0"):
        assert term in vec, term
    assert "const int n = valid ? BYTES : 0;" in CODE


# --- (b) the 3×TF32 split, emulated ------------------------------------------

def _tf32_rna(x):
    """x rounded to TF32 as the kernels do: half a TF32 ulp added to the
    f32 bits, the 13 low bits cleared."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tf32_reference(x):
    """Round to nearest with ties away from zero at 10 mantissa bits, in
    float64 (f32's exponent range; subnormal TF32 spacing 2^-136)."""
    x = np.asarray(x, np.float32).astype(np.float64)
    mag = np.abs(x)
    e = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    ulp = np.exp2(np.maximum(e - 10, -136.0))
    r = np.floor(mag / ulp + 0.5) * ulp
    return np.where(mag > 0, np.sign(x) * r, x).astype(np.float32)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    u = lambda n, hi: rng.integers(0, hi, n).astype(np.uint32)  # noqa: E731
    # exact ties (bit 12 set, bits 0-11 clear): normal and subnormal
    # exponents, both signs
    ties = (u(4000, 2) << 31 | u(4000, 255) << 23 | u(4000, 1024) << 13
            | np.uint32(0x1000))
    x = np.concatenate([
        (rng.standard_normal(20000) * 10.0 ** rng.integers(-30, 30, 20000)
         ).astype(np.float32),
        ties.view(np.float32),
        np.float32([0.0, -0.0, 1.0, -1.0, 3.4e38, 1e-45, 1.17549435e-38]),
    ])
    got, want = _tf32_rna(x), _tf32_reference(x)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.isinf(_tf32_rna(np.float32([np.inf, -np.inf]))).all()


def test_split_parts_are_exact_and_small():
    """hi + lo = x to within lo's own rounding: x − hi is exact in f32,
    |lo| <= 2^-11 |x|, and lo's rounding error <= 2^-11 |lo|, so hi + lo
    is within 2^-22 |x| of x."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(50000) * 10.0 ** rng.integers(-20, 20, 50000)
         ).astype(np.float32)
    hi = _tf32_rna(x)
    rest = x - hi                                       # f32, exact
    assert np.array_equal(rest.astype(np.float64),
                          x.astype(np.float64) - hi.astype(np.float64))
    lo = _tf32_rna(rest)
    ax = np.abs(x.astype(np.float64))
    assert (np.abs(lo.astype(np.float64)) <= 2.0 ** -11 * ax + 1e-45).all()
    err = np.abs(hi.astype(np.float64) + lo - x)
    assert (err <= 2.0 ** -22 * ax).all()


def _mma_emulated(q, k, terms):
    """q·kᵀ as the kernels form it: for each k8 step an m16n8k8 product
    per term (its eight products exact, their sum rounded to f32), added
    to the f32 accumulator in the kernels' order."""
    qh, kh = _tf32_rna(q), _tf32_rna(k)
    ql, kl = _tf32_rna(q - qh), _tf32_rna(k - kh)
    parts = {"lo·hi": (ql, kh), "hi·lo": (qh, kl), "hi·hi": (qh, kh)}
    acc = np.zeros((q.shape[0], k.shape[0]), np.float32)
    for k0 in range(0, q.shape[1], 8):
        for term in terms:
            a, b = parts[term]
            step = a[:, k0:k0 + 8].astype(np.float64) @ \
                b[:, k0:k0 + 8].astype(np.float64).T
            acc = (acc + step.astype(np.float32)).astype(np.float32)
    return acc


def test_three_tf32_products_keep_bert_scores_at_f32_accuracy():
    """BERT-Large's f32 attention scores (D = 64): seeded q, k; each
    score's error against float64, relative to Σ|q_i·k_i| (so that
    cancellation does not blow it up). hi·lo + lo·hi + hi·hi stays within
    1e-6, as f32's own dot products do; a single TF32 product (hi·hi) is
    off by about 1e-4, another result."""
    rng = np.random.default_rng(512)
    q = rng.standard_normal((128, 64)).astype(np.float32)
    k = rng.standard_normal((256, 64)).astype(np.float32)
    exact = q.astype(np.float64) @ k.astype(np.float64).T
    scale = np.abs(q.astype(np.float64)) @ np.abs(k.astype(np.float64)).T
    three = _mma_emulated(q, k, ("lo·hi", "hi·lo", "hi·hi"))
    one = _mma_emulated(q, k, ("hi·hi",))
    f32 = (q @ k.T).astype(np.float32)
    err = lambda got: (np.abs(got - exact) / scale).max()  # noqa: E731
    assert err(three) <= 1e-6
    assert err(three) <= 4 * err(f32)
    assert err(one) > 1e-5
    # the probabilities times V (P in [0, 1], V ~ N(0, 1)) at S = 512
    p = rng.random((64, 512)).astype(np.float32)
    v = rng.standard_normal((512, 64)).astype(np.float32)
    exact = p.astype(np.float64) @ v.astype(np.float64)
    scale = np.abs(p.astype(np.float64)) @ np.abs(v.astype(np.float64))
    three = _mma_emulated(p, v.T, ("lo·hi", "hi·lo", "hi·hi"))
    assert (np.abs(three - exact) / scale).max() <= 1e-6


# --- the bounds f32 rows are priced at -----------------------------------------

def test_f32_flash_is_priced_at_three_tf32_products():
    """With 3×TF32 the least time of an f32 product is three TF32
    products at 494.7 TFLOP/s, not one FFMA at 67: BERT-Large's f32
    forward (16, 512, 16, 64) is bound at 3 × 17.18 GFLOP / 494.7 TFLOP/s
    = 0.104 ms, the backward at 0.260 ms."""
    kind = "NVIDIA H100 80GB HBM3"
    assert report.TF32_FLOPS == 494.7e12
    assert report.lookup_peak(report.PEAK_TF32_FLOPS, kind) == 494.7e12
    assert cost.peak_of("3xtf32", kind) == pytest.approx(494.7e12 / 3)
    q = torch.zeros(16, 512, 16, 64)
    lse = torch.zeros(256, 512)
    fwd = cost.kernel_cost("flash_generic_fwd", (q, q, q, 0.125), {},
                           (q, lse))
    bwd = cost.kernel_cost("flash_generic_bwd",
                           (q, q, q, q, lse, lse, 0.125), {}, (q, q, q))
    assert fwd.peak == bwd.peak == "3xtf32"
    assert fwd.flops == 4 * 16 * 16 * 512 * 512 * 64
    t_fwd = cost.bound_ms(fwd.bytes, fwd.flops, cost.peak_of("3xtf32", kind))
    t_bwd = cost.bound_ms(bwd.bytes, bwd.flops, cost.peak_of("3xtf32", kind))
    assert t_fwd == pytest.approx(3 * 17.179869184e9 / 494.7e12 * 1e3)
    assert round(t_fwd, 3) == 0.104 and round(t_bwd, 3) == 0.260
    # 16-bit calls keep the bf16 tensor-core rate
    h = q.to(torch.bfloat16)
    assert cost.kernel_cost("flash_generic_fwd", (h, h, h, 0.125), {},
                            (h, lse)).peak == "bf16"
    # chip_smoke's flash rows take the same rate for f32 q
    rows = inspect.getsource(chip_smoke._flash_rows)
    assert ("peak = TF32_FLOPS / 3 if q.dtype == torch.float32 else "
            "BF16_FLOPS") in rows


def test_roofline_reads_the_three_tf32_rate():
    from apex_tpu_torch.prof import roofline
    src = inspect.getsource(roofline.roofline_report)
    assert '"3xtf32": lookup_peak(PEAK_TABLES["3xtf32"], kind)' in src


# --- the card's cases --------------------------------------------------------

def test_compile_check_holds_the_new_generic_cases():
    """``kernels/flash-generic`` adds odd head dims (1, 33, 255) in fp16
    and bf16, f32 at D = 80 and 256 causal, operands cut from a larger
    tensor off 16-byte alignment, and bitwise determinism at BERT's f32
    shape with no options; every case kernel vs plain at TOL16/TOL32."""
    src = inspect.getsource(dict(compile_check.CASES)["kernels/flash-generic"])
    assert "for d in (1, 33, 48, 96, 160, 255, 256):" in src
    assert "for dt in (bf16, fp16):" in src
    assert "for d in (80, 256)]" in src
    assert "((64, f32, 1), (80, bf16, 1),\n" in src
    assert "(80, fp16, 4))]" in src
    assert "return rnd(n + off, dtype=dt)[off:].view(shape)" in src
    assert 'if row in ("", "_mask_dropout", "_d80"):' in src
    assert compile_check.TOL16 == 2e-2 and compile_check.TOL32 == 1e-3
