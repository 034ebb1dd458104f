"""The port's kernel wrappers and chip_smoke.py's bookkeeping, on the CPU.

The kernels themselves run only on the card (chip_smoke.py holds them
against their plain versions there). Here: each wrapper refuses operands
it cannot launch on instead of falling back to its plain version, and
chip_smoke.py names, swaps and counts every kernel the package has.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from apex_tpu_torch import ops
from apex_tpu_torch.ops import attention as A
from apex_tpu_torch.ops import bn_act as B
from apex_tpu_torch.ops import layer_norm as L
from apex_tpu_torch.ops import mlp as P
from apex_tpu_torch.ops import multi_tensor as M
from apex_tpu_torch.ops import optim_kernels as K
from apex_tpu_torch.ops import xentropy as X

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("call", [
    lambda: L.ln_fwd_kernel(torch.ones(4, 8), torch.ones(8),
                            torch.zeros(8), 1e-5),
    lambda: L.ln_bwd_kernel(torch.ones(4, 8), torch.ones(4, 8),
                            torch.ones(8), 1e-5),
    lambda: X.xentropy_fwd_kernel(torch.ones(4, 10),
                                  torch.zeros(4, dtype=torch.int64), 0.0),
    lambda: X.xentropy_bwd_kernel(torch.ones(4, 10),
                                  torch.zeros(4, dtype=torch.int64),
                                  torch.zeros(4), torch.ones(4), 0.0),
    lambda: A.flash_fwd_kernel(*(torch.ones(1, 8, 2, 64,
                                            dtype=torch.bfloat16),) * 3, 0.125),
    lambda: B.bn_sums_kernel(*(torch.ones(16, 8),) * 3,
                             *(torch.ones(8),) * 4, "addrelu"),
    lambda: B.bn_dx_kernel(*(torch.ones(16, 8),) * 2, *(torch.ones(8),) * 4,
                           torch.ones(2, 8), 16.0, True, torch.float32),
    lambda: K.adam_kernel(*(torch.ones(65536),) * 4, torch.ones(8), False,
                          torch.bfloat16),
    lambda: M.maxnorm_kernel(torch.ones(65536)),
    lambda: M.scale_kernel(torch.ones(65536), torch.ones(1), torch.float16),
    lambda: M.axpby_kernel(*(torch.ones(65536),) * 2, torch.ones(2),
                           torch.float32),
    lambda: K.adagrad_kernel(*(torch.ones(65536),) * 3, torch.ones(4), True),
    lambda: K.novograd_kernel(*(torch.ones(65536),) * 4, torch.ones(7),
                              True),
    lambda: P.mlp_fwd_kernel(torch.ones(16, 13, dtype=torch.bfloat16),
                             [torch.ones(13, 8, dtype=torch.bfloat16)],
                             [torch.ones(8, dtype=torch.bfloat16)]),
], ids=["ln_fwd", "ln_bwd", "xent_fwd", "xent_bwd", "flash_fwd", "bn_sums",
        "bn_dx", "adam", "maxnorm", "scale", "axpby", "adagrad", "novograd",
        "mlp_fwd"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    before = ops.launch_counts()
    with pytest.raises(ValueError):
        call()
    assert ops.launch_counts() == before


def test_flash_wrapper_checks_layout_before_device():
    q = torch.ones(1, 8, 2, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16/fp16"):
        A.flash_fwd_kernel(q, q, q, 0.125)
    q = torch.ones(1, 8, 2, 48, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        A.flash_fwd_kernel(q, q, q, 0.125)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("opts", [
    {}, {"bias": torch.zeros(2, 1, 1, 24)}, {"causal": True},
    {"causal": True, "causal_off": torch.tensor([3], dtype=torch.int32)},
    {"rate": 0.1, "seed": torch.tensor([5], dtype=torch.int32)},
], ids=["plain", "bias", "causal", "causal_off", "dropout"])
def test_flash_wrappers_refuse_cpu_tensors_with_every_option(d, opts):
    """Each option and head dim the kernels take is refused on CPU
    tensors, forward and backward, before any launch."""
    q = torch.ones(2, 16, 3, d, dtype=torch.bfloat16)
    k = torch.ones(2, 24, 3, d, dtype=torch.bfloat16)
    lse = torch.zeros(6, 16)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        A.flash_fwd_kernel(q, k, k, 0.125, **opts)
    with pytest.raises(ValueError, match="CUDA device"):
        A.flash_bwd_kernel(q, k, k, q, lse, lse, 0.125, **opts)
    assert ops.launch_counts() == before


def test_flash_kernel_args_mirror_the_c_struct():
    """``_FlashArgs`` lists ``FlashArgs``'s fields in the header's order."""
    import re

    src = (ROOT / "apex_tpu_torch/csrc/flash_common.cuh").read_text()
    body = src[src.index("struct FlashArgs {"):]
    body = body[:body.index("};")]
    fields = []
    for line in body.splitlines()[1:]:
        line = re.sub(r"//.*", "", line).strip().rstrip(";")
        if line:
            fields += [n.strip().lstrip("*") for n in
                       re.sub(r"^(const |long )?\w+\*? ", "", line).split(",")]
    assert fields == [name for name, _ in A._FlashArgs._fields_]


def test_chip_smoke_extra_rows_name_attention_kernels():
    for name, (kernel, where, _) in chip_smoke.EXTRA_ROWS.items():
        assert kernel in ("flash_attn_fwd", "flash_attn_bwd"), name
        path, line = where.rsplit(":", 1)
        lines = (ROOT / path).read_text().splitlines()
        assert lines[int(line) - 1].startswith("def _"), name
    assert not set(chip_smoke.EXTRA_ROWS) & set(ops.KERNELS)


def test_chip_smoke_extra_rows_take_only_their_phase_launches():
    """The padding + dropout rows take bert_large_dropout's attention
    counts; the H = 15 rows, a geometry no path runs, keep 0."""
    rows = {name: {"launches": 0}
            for name in (*ops.KERNELS, *chip_smoke.EXTRA_ROWS)}
    rows["flash_attn_fwd"]["launches"] = 120
    rows["flash_attn_bwd"]["launches"] = 121
    chip_smoke.take_phase_launches("bert_large", rows)
    assert all(rows[n]["launches"] == 0 for n in chip_smoke.EXTRA_ROWS)
    chip_smoke.take_phase_launches("bert_large_dropout", rows)
    assert {n: rows[n]["launches"] for n in chip_smoke.EXTRA_ROWS} == {
        "flash_attn_fwd_mask_dropout": 120,
        "flash_attn_bwd_mask_dropout": 121,
        "flash_attn_fwd_h15": 0, "flash_attn_bwd_h15": 0}


def test_chip_smoke_names_every_kernel():
    names = set(ops.KERNELS)
    assert len(names) == 19
    per_step = set(chip_smoke.EXPECTED_PER_STEP)
    assert per_step | set(chip_smoke.ARENA_PER_STEP) \
        | set(chip_smoke.RESNET_PER_STEP) | set(chip_smoke.SGD_PER_STEP) \
        | set(chip_smoke.DCGAN_PER_STEP) | set(chip_smoke.NOVOGRAD_PER_STEP) \
        | set(chip_smoke.ADAGRAD_PER_STEP) \
        | set(chip_smoke.MULTI_TENSOR_OPS) \
        | set(chip_smoke.MLP_PER_STEP) == names
    assert chip_smoke.NOVOGRAD_PER_STEP == {"novograd": 1}
    assert chip_smoke.ADAGRAD_PER_STEP == {"adagrad": 1}
    assert not set(chip_smoke.MULTI_TENSOR_OPS) & (
        per_step | set(chip_smoke.ARENA_PER_STEP))
    assert not per_step & set(chip_smoke.ARENA_PER_STEP)
    assert not set(chip_smoke.RESNET_PER_STEP) & set(chip_smoke.SGD_PER_STEP)
    assert chip_smoke.DCGAN_PER_STEP == {"adam": 3}
    assert chip_smoke.MLP_PER_STEP == {"mlp_fwd": 1, "adam": 1}
    for table in (chip_smoke.REPLACES, chip_smoke.SOURCES):
        assert set(table) == names
    for name, (route, src) in chip_smoke.SOURCES.items():
        assert route in ("cuda", "triton") and (ROOT / src).is_file(), name
    for name, where in chip_smoke.REPLACES.items():
        path, line = where.rsplit(":", 1)
        lines = (ROOT / path).read_text().splitlines()
        assert lines[int(line) - 1].startswith("def _"), name


def test_plain_versions_swaps_every_wrapper_and_restores():
    modules = (A, B, L, M, K, P, X)
    wrappers = {n: fn for n, fn in ops.KERNELS.items()}

    def bound():
        return {fn for m in modules for fn in vars(m).values()
                if callable(fn) and fn in wrappers.values()}

    assert bound() == set(wrappers.values())
    with chip_smoke.plain_versions():
        assert bound() == set()
    assert bound() == set(wrappers.values())


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU refusal")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=str(ROOT))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_mlp_widths_sit_on_each_side_of_the_budget():
    """The path's MLP (DLRM's bottom) takes the kernel; the reference Apex
    test's widths are 4.7% over the 8 MiB budget and take none."""
    def weights(sizes):
        return [torch.empty(a, b, device="meta")
                for a, b in zip(sizes, sizes[1:])]

    assert P.weights_fit(weights(chip_smoke.MLP_BOTTOM))
    assert not P.weights_fit(weights(chip_smoke.MLP_OVER_BUDGET))
    n = sum(w.numel() for w in weights(chip_smoke.MLP_OVER_BUDGET)) * 4
    assert n == 8_782_848 and n > P.WEIGHT_BUDGET
