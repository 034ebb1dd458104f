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
from apex_tpu_torch.ops import layer_norm as L
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
], ids=["ln_fwd", "ln_bwd", "xent_fwd", "xent_bwd", "flash_fwd"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    before = ops.launch_counts()
    with pytest.raises(ValueError):
        call()
    assert ops.launch_counts() == before


def test_flash_wrapper_checks_layout_before_device():
    q = torch.ones(1, 8, 2, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16/fp16"):
        A.flash_fwd_kernel(q, q, q, 0.125)
    q = torch.ones(1, 8, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        A.flash_fwd_kernel(q, q, q, 0.125)


def test_chip_smoke_names_every_kernel():
    names = set(ops.KERNELS)
    per_step = set(chip_smoke.EXPECTED_PER_STEP)
    assert per_step | set(chip_smoke.ARENA_PER_STEP) == names
    assert not per_step & set(chip_smoke.ARENA_PER_STEP)
    for table in (chip_smoke.REPLACES, chip_smoke.SOURCES):
        assert set(table) == names
    for name, (route, src) in chip_smoke.SOURCES.items():
        assert route in ("cuda", "triton") and (ROOT / src).is_file(), name
    for name, where in chip_smoke.REPLACES.items():
        path, line = where.rsplit(":", 1)
        lines = (ROOT / path).read_text().splitlines()
        assert lines[int(line) - 1].startswith("def _"), name


def test_plain_versions_swaps_every_wrapper_and_restores():
    modules = (A, L, M, K, X)
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
