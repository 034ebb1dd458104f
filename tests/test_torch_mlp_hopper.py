"""The Hopper fused-MLP forward kernel (``csrc/mlp_fwd.cu``), on the CPU.

The kernel builds and runs only on the card, where chip_smoke.py holds it
against its plain version (within 1e-4), checks two launches bitwise equal
and times it. Here: the source exports the entry point its wrapper binds,
with the call struct the wrapper packs; its weights go to shared memory
by 16-byte ``cp.async``; its constants are the wrapper's; its thread tiles
cover every output of every layer once; its shared memory fits the 227 KB
opt-in up to ``FUSED_MAX_WIDTH`` and not past it; the wrapper's launch
counts; and a PyTorch model of the kernel's summation order (each output
summed by one thread in increasing k, one FMA a step, bias and activation
after the last slice) computes ``mlp_fused_reference``'s outputs and the
JAX package's Pallas kernel's (interpret mode) at the DLRM bottom MLP's
widths: within 1e-5 of the largest magnitude in f32, one bf16 ulp in
bf16.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from apex_tpu.ops import mlp as JM
from apex_tpu_torch.ops import mlp as P

SRC = (Path(__file__).resolve().parents[1] / "apex_tpu_torch" / "csrc"
       / "mlp_fwd.cu").read_text()
_ULP_BF16 = 2.0 ** -7
SMEM_OPT_IN = 232448          # bytes of shared memory a block may opt into


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _ks(w_itemsize):
    """Reduction rows of a weight stage (``Ring<TW>::kKs``): 32 KB a
    stage."""
    num = int(re.search(r"kKs = (\d+) / \(int\)sizeof\(TW\)", SRC).group(1))
    return num // w_itemsize


def _struct_fields(name):
    body = SRC[SRC.index(f"struct {name} {{"):]
    body = re.sub(r"//.*", "", body[body.index("{") + 1:body.index("};")])
    ctype, names = re.match(r"\s*(long long)\s+(.*)", body, re.S).groups()
    return [n.strip().rstrip(";") for n in names.split(",")]


def test_source_exports_the_entry_point_the_wrapper_packs():
    assert re.search(r'extern "C" int apex_mlp_fwd\(const MlpCall\* k, '
                     r"void\* stream\)", SRC)
    assert _struct_fields("MlpCall") == list(P.MLP_CALL_FIELDS)
    assert P._MLP_CALL.size == 8 * len(P.MLP_CALL_FIELDS)
    # the weights', biases' and widths' arrays follow the struct
    assert "reinterpret_cast<const long long*>(k + 1)" in SRC


def test_weights_are_staged_by_16_byte_cp_async():
    src = re.sub(r"//.*", "", SRC)
    assert "cp.async.cg.shared.global [%0], [%1], 16, %2;" in src
    assert "cp.async.commit_group;" in src
    assert r'cp.async.wait_group %0;\n" ::"n"(kStages - 2)' in src
    assert "atomic" not in src
    # f32 FMA on the CUDA cores: no tensor-core instruction
    assert "wgmma" not in src and "mma.sync" not in src


def test_constants_are_the_wrappers():
    assert _const("kMaxLd") == P.FUSED_MAX_WIDTH
    assert _const("kMaxLayers") == P.MAX_LAYERS
    assert (_const("kRows"), _const("kThreads"), _const("kStages"),
            _const("kCw")) == (16, 256, 2, 256)
    assert (_ks(2), _ks(4)) == (64, 32)


def _ldp(ld):
    """The fused kernel's row stride: >= ld and 4 mod 32 floats."""
    return 32 * ((ld - 4 + 31) // 32) + 4


def _smem(widest, w_itemsize):
    """Two 16-row activation buffers and two weight stages."""
    ld = -(-widest // 4) * 4
    return 4 * 2 * 16 * _ldp(ld) + w_itemsize * 2 * _ks(w_itemsize) * 256


def test_shared_memory_fits_up_to_the_fused_width():
    """Two 16-row f32 activation buffers and two 32 KB weight stages fit
    the 227 KB opt-in for every width the wrapper sends
    to the fused kernel, and not one 4-column step wider; every stride is
    4 mod 32 floats (the four row groups of a warp read distinct banks)."""
    for w in range(1, P.FUSED_MAX_WIDTH + 1):
        for itemsize in (2, 4):
            assert _smem(w, itemsize) <= SMEM_OPT_IN
        assert _ldp(-(-w // 4) * 4) % 32 == 4
    assert _smem(P.FUSED_MAX_WIDTH + 4, 4) > SMEM_OPT_IN
    # the path's: 130 KB with bf16 weights, one block an SM
    assert _smem(512, 2) == 2 * 16 * 516 * 4 + 2 * 64 * 256 * 2


def _tn(dout):
    """Columns a thread of a layer of width dout (``layer_tn``)."""
    return 4 if dout > 128 else 2 if dout > 64 else 1


@pytest.mark.parametrize("dout", [1, 10, 13, 57, 64, 65, 128, 129, 136,
                                  200, 256, 512, 1000, 1284])
def test_thread_tiles_cover_every_output_once(dout):
    """The kernel's tile plan: a warp is 4 row groups x 8 column groups,
    a thread rows rg + 4i and TN columns from warp·8·TN + cg·TN, the 8
    warps side by side in passes of 64·TN columns; every (row, column) of
    a layer's 16 x dout outputs belongs to one (pass, warp, lane, i, j),
    and the thread writing past dout writes only up to dout rounded up to
    4 (the zero padding the next layer reads)."""
    tn = _tn(dout)
    seen = np.zeros((16, dout), dtype=np.int64)
    padded = set()
    cw, rd = 64 * tn, -(-dout // 4) * 4
    for c0 in range(0, dout, cw):
        for warp in range(8):
            for lane in range(32):
                rg, cg = lane & 3, lane >> 2
                col = c0 + warp * 8 * tn + cg * tn
                if col >= rd:
                    continue
                assert col + tn <= rd
                for i in range(4):
                    for j in range(tn):
                        if col + j < dout:
                            seen[rg + 4 * i, col + j] += 1
                        else:
                            padded.add(col + j)
    assert (seen == 1).all()
    assert padded == set(range(dout, rd))


@pytest.mark.parametrize("name,dims,launches", [
    ("path", list(chip_smoke.MLP_BOTTOM), 1),
    ("edge", [1024, 1024, 1024], 1),
    ("ragged", [224, 200, 136, 10], 1),
    ("wide", [96, 4096, 48], 2),
    ("deep", [64] * 41, 2),
    ("mixed", [39, 128, 57], 1),
    ("widest fused", [P.FUSED_MAX_WIDTH, 8, P.FUSED_MAX_WIDTH], 1),
    ("past it", [P.FUSED_MAX_WIDTH + 1, 8, 4], 2),
    ("33 layers", [64] * 34, 2),
    ("65 layers", [64] * 66, 3),
])
def test_launch_counts(name, dims, launches):
    """The launches chip_smoke.py checks (path, edge and ragged 1; wide
    and deep 2) and the workspace their plan needs."""
    assert P._launches(dims) == launches
    assert (P._workspace_cols(dims) == 0) == (launches == 1)


def _fma32(acc, a, b):
    """f32 fmaf(a, b, acc) on tensors: the exact product and sum in f64,
    rounded once to f32."""
    return (acc.double() + a.double() * b.double()).float()


def _kernel_model(x, weights, biases, activation):
    """The kernel's arithmetic in PyTorch: per layer, each output's sum
    over k in increasing order from 0, one FMA a step, then the bias and
    the activation, in f32; one cast to x's dtype at the end."""
    act = {"relu": lambda v: torch.where(v < 0, torch.zeros_like(v), v),
           "sigmoid": lambda v: 1.0 / (1.0 + torch.exp(-v)),
           "none": lambda v: v}[activation]
    h = x.float()
    for li, w in enumerate(weights):
        w = w.float()
        acc = torch.zeros(h.shape[0], w.shape[1])
        for k in range(w.shape[0]):
            acc = _fma32(acc, h[:, k:k + 1], w[k:k + 1])
        if biases is not None:
            acc = acc + biases[li].float()
        h = act(acc)
    return h.to(x.dtype)


def _operands(seed, n, dims, xdt, wdt, bias=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, dims[0]).astype(np.float32)
    ws = [(rng.randn(a, b) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    bs = ([(rng.randn(b) * 0.1).astype(np.float32) for b in dims[1:]]
          if bias else None)
    t = lambda a, dt: torch.tensor(a).to(dt)  # noqa: E731
    j = lambda a, dt: jnp.asarray(a).astype(dt)  # noqa: E731
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    torch_in = (t(x, tdt[xdt]), [t(w, tdt[wdt]) for w in ws],
                None if bs is None else [t(b, tdt[wdt]) for b in bs])
    jax_in = (j(x, jdt[xdt]), tuple(j(w, jdt[wdt]) for w in ws),
              None if bs is None else tuple(j(b, jdt[wdt]) for b in bs))
    return torch_in, jax_in


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("xdt,wdt,activation,bias", [
    ("f32", "f32", "relu", True),
    ("f32", "f32", "sigmoid", False),
    ("bf16", "bf16", "relu", True),       # the path's dtypes under O2
    ("bf16", "f32", "none", True),
])
def test_summation_model_matches_the_plain_version_and_jax(xdt, wdt,
                                                           activation, bias):
    """At the DLRM bottom MLP's widths [13, 512, 256, 128], 6 rows."""
    dims = list(chip_smoke.MLP_BOTTOM)
    (tx, tw, tb), (jx, jw, jb) = _operands(3, 6, dims, xdt, wdt, bias)
    got = _f32(_kernel_model(tx, tw, tb, activation))
    plain = _f32(P.mlp_fused_reference(tx, tw, tb, activation))
    want = _f32(JM._fused_mlp_fwd_impl(jx, jw, jb, activation))
    for ref in (plain, want):
        if xdt == "f32":
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max())
        else:
            assert np.all(np.abs(got - ref) <= np.abs(ref) * _ULP_BF16)


def test_summation_model_at_a_ragged_shape():
    """compile_check's ragged widths [224, 200, 136, 10] (a last layer
    narrower than a 16-byte chunk of its weight rows, which the kernel
    copies element by element), f32, sigmoid, no bias, 5 rows."""
    dims = [224, 200, 136, 10]
    (tx, tw, _), (jx, jw, _) = _operands(5, 5, dims, "f32", "f32", False)
    got = _f32(_kernel_model(tx, tw, None, "sigmoid"))
    for ref in (_f32(P.mlp_fused_reference(tx, tw, None, "sigmoid")),
                _f32(JM._fused_mlp_fwd_impl(jx, jw, None, "sigmoid"))):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    assert (10 * 4) % 16 != 0 and (136 * 4) % 16 == 0


def test_chip_smoke_checks_the_mlp_kernel_bitwise_and_by_device_time():
    import inspect
    src = inspect.getsource(chip_smoke.check_mlp_kernel)
    assert "torch.equal(" in src and "two launches differ" in src
    assert 'row("mlp_fwd"' in src and "dev_ms=device_ms(" in src
    assert chip_smoke.SOURCES["mlp_fwd"] == ("cuda",
                                             "apex_tpu_torch/csrc/mlp_fwd.cu")
