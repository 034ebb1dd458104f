"""The BN kernels' e4m3 x̂ operand and ``xhat`` flag, and chip_smoke.py's
new ResNet phases, on the CPU.

The kernels build and run only on the card (chip_smoke.py holds them
against their plain versions there, rows ``bn_sums_fp8``/``bn_dx_fp8``).
Here: ``csrc/bn_sums.cu`` reads dtype code 3 as e4m3 and uses an x̂ operand
as it is; the C struct carries the flag the wrapper packs; the Triton dx
kernel takes an ``XHAT`` constexpr; the BN unit's backward and the conv
unit's sums reach the kernels through the ``bn_act`` module, where
chip_smoke's ``plain_versions()`` rebinds them; chip_smoke's launch counts
per step match the models' units, and its leaf map from the fused
baseline onto the ``dx_distribute`` models covers every leaf.
"""

import inspect
import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from apex_tpu_torch import models
from apex_tpu_torch.ops import bn_act as B
from apex_tpu_torch.ops import conv_bn as C
from apex_tpu_torch.ops.bn_act import FusedBNAct
from apex_tpu_torch.ops.conv_bn import ConvBNAct

ROOT = Path(__file__).resolve().parents[1]
SRC = re.sub(r"//.*", "", (ROOT / "apex_tpu_torch" / "csrc" /
                           "bn_sums.cu").read_text())


def test_bn_sums_reads_e4m3_as_code_3():
    assert "#include <cuda_fp8.h>" in SRC
    assert "kE4M3 = 3" in SRC
    assert B._DTYPES[torch.float8_e4m3fn] == 3 == B._DTYPES[B.XHAT_DTYPE]
    body = SRC[SRC.index("float load_any("):SRC.index("void store_any(")]
    assert "if (dt == kE4M3)" in body and "__nv_fp8_e4m3" in body
    # the vector path loads V bytes of x̂ beside 16 of g
    assert "struct Fp8Vec" in SRC
    for inst in ("Fp8Vec<8>, Vec16<__nv_bfloat16>, true",
                 "Fp8Vec<8>, Vec16<__half>, true",
                 "Fp8Vec<4>, Vec16<float>, true"):
        assert f"launch<{inst}>" in SRC


def test_bn_sums_uses_xhat_as_it_is_under_the_flag():
    assert ("XHAT ? L::get(rx[u], j)\n                 : __fmul_rn(__fsub_rn("
            "L::get(rx[u], j), mu[j]), is[j])") in SRC
    assert "template <typename L, typename G, int MODE, bool XHAT>" in SRC
    # an e4m3 operand is x̂ and only x may be one
    assert "if (xhat != (a.x_dt == kE4M3) || a.g_dt == kE4M3" in SRC
    assert B.SUMS_CALL_FIELDS[-1] == "xhat"
    assert B._SUMS_CALL.size == 8 * len(B.SUMS_CALL_FIELDS) == 8 * 21


def test_the_triton_dx_kernel_takes_an_xhat_constexpr():
    params = inspect.signature(B._bn_dx_triton).parameters
    assert params["XHAT"].annotation.strip("'") == "tl.constexpr"
    src = inspect.getsource(B._bn_dx_triton)
    assert "if XHAT:\n        xhat = tl.load(X + offs, mask=m)" in src
    assert "XHAT=bool(xhat)" in inspect.getsource(B.bn_dx_kernel)


@pytest.mark.parametrize("fn", [B.bn_sums_kernel, B.bn_dx_kernel,
                                B.bn_sums_plain, B.bn_dx_plain])
def test_wrappers_and_plain_versions_take_the_flag(fn):
    assert inspect.signature(fn).parameters["xhat"].default is False


def test_the_wrappers_refuse_cpu_tensors_with_the_flag():
    x8 = torch.zeros(8, 16).to(B.XHAT_DTYPE)
    g, v = torch.zeros(8, 16, dtype=torch.bfloat16), torch.ones(16)
    with pytest.raises(ValueError, match="CUDA"):
        B.bn_sums_kernel(x8, g, None, v, v, v, v, "relu", xhat=True)
    with pytest.raises(ValueError, match="CUDA"):
        B.bn_dx_kernel(x8, g, v, v, v, v, torch.zeros(2, 16), 8, True,
                       torch.bfloat16, xhat=True)


def test_the_backward_passes_the_flag_and_reads_the_module(monkeypatch):
    """``_bwd`` hands ``xhat=cfg.fp8`` to both passes; the conv unit's sums
    look ``bn_sums_plain``/``bn_sums_kernel`` up on ``bn_act`` when its
    backward runs (so ``plain_versions()`` reaches them)."""
    src = inspect.getsource(B._bwd)
    assert src.count("xhat=cfg.fp8") == 2
    assert "bn_act.bn_sums_kernel if x2.is_cuda else bn_act.bn_sums_plain" \
        in inspect.getsource(C._sums)
    seen = []
    plain = B.bn_sums_plain

    def spy(*args, **kw):
        seen.append(args[7])
        return plain(*args, **kw)

    monkeypatch.setattr(B, "bn_sums_plain", spy)
    a = torch.randn(2, 4, 4, 3, requires_grad=True)
    w = torch.randn(5, 3, 1, 1, requires_grad=True)
    s, b = torch.ones(5, requires_grad=True), torch.zeros(5,
                                                          requires_grad=True)
    for relu in (True, False):
        z = C.conv_bn_act_train(a, w, s, b, C.make_conv_cfg(relu=relu))[0]
        z.sum().backward()
    r = torch.randn(2, 4, 4, 5, requires_grad=True)
    z = C.conv_bn_add_act_train(a, w, r, s, b, C.make_conv_cfg(relu=True))[0]
    z.sum().backward()
    assert seen == ["relu", "plain", "addrelu"]


@pytest.mark.parametrize("kw,units,per_step", [
    (dict(), (53, 0), chip_smoke.RESNET_PER_STEP),
    (dict(dx_distribute="all"), (1, 52), chip_smoke.RESNET_ALL_PER_STEP),
    (dict(fused_bn=False), (0, 0), chip_smoke.RESNET_UNFUSED_PER_STEP),
])
def test_chip_smoke_launches_per_step_match_the_units(kw, units, per_step):
    """A FusedBNAct unit runs ``bn_sums`` and ``bn_dx`` once a backward, a
    ConvBNAct unit ``bn_sums`` only; an unfused model runs neither."""
    m = models.ResNet50(device="meta", **kw)
    fused = sum(isinstance(x, FusedBNAct) for x in m.modules())
    conv = sum(isinstance(x, ConvBNAct) for x in m.modules())
    assert (fused, conv) == units
    assert per_step.get("bn_sums", 0) == fused + conv
    assert per_step.get("bn_dx", 0) == fused
    assert per_step["xentropy_fwd"] == per_step["xentropy_bwd"] == 1


@pytest.mark.parametrize("mode", ["join", "all"])
@pytest.mark.parametrize("stages", [[1, 1, 1, 1], [3, 4, 6, 3]])
def test_chip_smoke_dist_name_covers_every_leaf(mode, stages):
    base = models.ResNet(stage_sizes=stages, device="meta")
    dist = models.ResNet(stage_sizes=stages, device="meta",
                         dx_distribute=mode)
    names = {chip_smoke.dist_name(base, n, mode)
             for n in base.state_dict()}
    assert names == set(dist.state_dict())
    shapes = {chip_smoke.dist_name(base, n, mode): v.shape
              for n, v in base.state_dict().items()}
    assert all(shapes[n] == v.shape for n, v in dist.state_dict().items())


def test_chip_smoke_extra_bn_rows():
    assert set(chip_smoke.EXTRA_BN_ROWS) == {
        "bn_sums_f32", "bn_dx_f32", "bn_sums_fp8", "bn_dx_fp8",
        "bn_dx_count"}
    rows = {n: {"launches": 0} for n in (*chip_smoke.EXTRA_ROWS,
                                         *chip_smoke.EXTRA_BN_ROWS)}
    rows.update(bn_sums={"launches": 265}, bn_dx={"launches": 264})
    chip_smoke.take_phase_launches("resnet50_o0", rows)
    assert rows["bn_sums_f32"]["launches"] == 265
    assert rows["bn_dx_f32"]["launches"] == 264
    assert rows["bn_sums_fp8"]["launches"] == 0
    assert rows["bn_dx_count"]["launches"] == 0
    chip_smoke.take_phase_launches("resnet50_syncbn", rows)
    assert rows["bn_dx_count"]["launches"] == 264
    for name, (kernel, where, _) in chip_smoke.EXTRA_BN_ROWS.items():
        assert where == chip_smoke.REPLACES[kernel], name
