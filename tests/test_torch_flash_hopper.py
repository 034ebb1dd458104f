"""The Hopper flash-attention kernels' sources and chip_smoke.py's checks of
them, on the CPU.

The kernels build and run only on the card, where chip_smoke.py holds
them against their plain versions, checks two launches bitwise equal and
times them by device time. Here: each
translation unit runs its products on wgmma and loads its tiles by TMA
behind mbarriers, with no WMMA left; the ABI the wrapper binds to stays;
the ring and the ping-pong turns pair up; and chip_smoke.py's ptxas
report, determinism check and device-time fields.
(tests/test_torch_kernel_wrappers.py holds FlashArgs against _FlashArgs.)
"""

import inspect
import re
from pathlib import Path

import pytest

import chip_smoke
from apex_tpu_torch.ops import _build

CSRC = Path(__file__).resolve().parents[1] / "apex_tpu_torch" / "csrc"
SOURCES = ("flash_attn_fwd.cu", "flash_attn_bwd.cu")


def _unit(name):
    """A source with the local headers it includes, as one text."""
    text = (CSRC / name).read_text()
    for inc in re.findall(r'#include "([^"]+)"', text):
        text += (CSRC / inc).read_text()
    return text


@pytest.mark.parametrize("name", SOURCES)
def test_flash_sources_run_on_wgmma_and_tma(name):
    unit, own = _unit(name), (CSRC / name).read_text()
    for ptx in ("wgmma.mma_async", "wgmma.fence", "wgmma.commit_group",
                "wgmma.wait_group", "cp.async.bulk.tensor",
                "mbarrier.arrive.expect_tx", "mbarrier.try_wait"):
        assert ptx in unit, ptx
    for gone in ("nvcuda::wmma", "<mma.h>", "mma_sync", "load_matrix_sync",
                 "load_tile<"):
        assert gone not in unit, gone
    # the products and loads are the source's own, not only the header's
    for call in ("::ss(", "::rs(", "tma_tile<", "mbar_wait(",
                 "__grid_constant__ CUtensorMap"):
        assert call in own, call


@pytest.mark.parametrize("name,entry,kernels", [
    ("flash_attn_fwd.cu", "apex_flash_attn_fwd", ("flash_fwd",)),
    ("flash_attn_bwd.cu", "apex_flash_attn_bwd",
     ("flash_bwd_dkv", "flash_bwd_dq")),
])
def test_flash_sources_keep_their_abi(name, entry, kernels):
    """The C entry point the wrapper binds (dtype, D, FlashArgs*, stream),
    and kernel names the profiler script sorts by."""
    own = (CSRC / name).read_text()
    assert re.search(rf'extern "C" int {entry}\(int dtype, int d, '
                     r"const FlashArgs\* a,\s+void\* stream\)", own)
    for k in kernels:
        assert re.search(rf"__global__ void __launch_bounds__\(NTHREADS, 1\)"
                         rf"\s+{k}\(", own), k
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_bert_profile", CSRC.parents[1] / "scripts" /
        "torch_bert_profile.py")
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    for k in kernels:
        assert prof._category(f"void (anonymous namespace)::{k}<"
                              f"__nv_bfloat16, 64, false>(...)") \
            == "flash_attn", k


def test_flash_ring_and_turns_pair_up():
    """The streamed ring has a stage for the producer beside the two the
    pipelined forward holds; every consumer warp empties a stage and the
    producer warp's 32 lanes fill one; each kernel's ping-pong turns open
    with warpgroup 1's pass and close with warpgroup 0's wait, and no
    kernel asks setmaxnreg for registers (ptxas kept the consumers at 168
    whatever it asked, and a lone producer warp cannot run it)."""
    common = (CSRC / "flash_common.cuh").read_text()
    ns = int(re.search(r"constexpr int NS = (\d+);", common).group(1))
    assert ns >= 3
    assert "constexpr int NTHREADS = NCONS * 128 + 32;" in common
    assert "mbar_init(bar_full(bars, s), 32);" in common
    assert "mbar_init(bar_empty(bars, s), NCONS * 4);" in common
    assert "setmaxnreg" not in re.sub(r"//.*", "", common)
    fwd = (CSRC / "flash_attn_fwd.cu").read_text()
    assert "wgmma_wait1();" in fwd
    for name, kernels in (("flash_attn_fwd.cu", 1), ("flash_attn_bwd.cu", 2)):
        src = (CSRC / name).read_text()
        assert "setmaxnreg" not in re.sub(r"//.*", "", src)
        opens = re.findall(r"if \(wg == 1[^)]*\) turn_pass\(wg\);", src)
        closes = re.findall(r"if \(wg == 0[^)]*\) turn_wait\(wg\);", src)
        assert len(opens) == len(closes) == kernels
        assert src.count("turn_wait(wg);") == src.count("turn_pass(wg);")


def test_flash_tensor_maps_need_no_driver_library():
    """The tensor-map encoder comes through the runtime's driver entry
    point, so the build links nothing beyond what nvcc links."""
    common = (CSRC / "flash_common.cuh").read_text()
    assert "cudaGetDriverEntryPoint" in common
    assert "cuTensorMapEncodeTiled" in common
    assert not any(f.startswith("-l") for f in _build.NVCC_FLAGS)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19flash_fwdI13\
__nv_bfloat16Li64ELb0EEEvN10apex_flash9FlashArgsE14CUtensorMap_stS4_S4_' \
for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19flash_fwdI13\
__nv_bfloat16Li64ELb0EEEvN10apex_flash9FlashArgsE14CUtensorMap_stS4_S4_
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1088 bytes cmem[0]
ptxas warning : example warning line
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113flash_bwd_dkvI6\
__halfLi128ELb1EEEvN10apex_flash9FlashArgsE14CUtensorMap_stS4_S4_S4_' for \
'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 224 registers
ptxas info    : Compiling entry function '_Z6kernelPf' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 10 registers
"""


def test_ptxas_report_names_each_flash_instance():
    entries, warnings = chip_smoke.ptxas_entries(PTXAS_LOG)
    assert entries == [
        ("flash_fwd<bf16, D=64, opts=0>", 168, 8, 12),
        ("flash_bwd_dkv<fp16, D=128, opts=1>", 224, 0, 0),
        ("_Z6kernelPf", 10, 0, 0)]
    assert warnings == ["ptxas warning : example warning line"]


def test_chip_smoke_checks_flash_determinism_and_device_time():
    # the checks are the compile check's cases (chip_smoke's phase
    # compile_check runs them); the kernel phase times the rows
    from apex_tpu_torch.ops import compile_check
    cases = dict(compile_check.CASES)
    assert {"kernels/flash-bert", "kernels/flash-options",
            "kernels/flash-mask-probe", "kernels/flash-determinism"} <= set(
        cases)
    det = inspect.getsource(cases["kernels/flash-determinism"])
    assert det.count("torch.equal") == 2
    assert "flash_fwd_kernel" in det and "flash_bwd_kernel" in det
    assert "padding_bias" in det and "rate=0.1" in det
    tools = inspect.getsource(chip_smoke.bench_tools)
    assert '"device_ms": dev_ms' in tools
    assert '"library_device_ms": lib_dev_ms' in tools
    # every flash row gets both device times: BERT's and the extra rows,
    # each pair from one _flash_rows call
    timed_rows = inspect.getsource(chip_smoke._flash_rows)
    assert len(re.findall(r"\bdev_ms=device_ms\(", timed_rows)) == 2
    assert len(re.findall(r"\blib_dev_ms=device_ms\(", timed_rows)) == 2
    flash = inspect.getsource(chip_smoke.time_flash)
    for suffix in ('("",', '("_mask_dropout",', '("_h15",', '("_s64",'):
        assert suffix in flash, suffix
    assert "time_flash(" in inspect.getsource(chip_smoke.check_kernels)


def test_device_ms_leaves_the_flush_out():
    """The flush's kernels (and the spins that open and close each
    session) are told apart by name and left out, and a session that lost
    its first spins, its last, or any of the measured calls' flushes is
    taken again with more short spins ahead of the work. The smoke's
    ``device_ms`` is ``apex_tpu_torch.prof``'s, whose guarded session
    ``profile_step`` shares."""
    from apex_tpu_torch.prof import report
    assert chip_smoke.device_ms is report.device_ms
    assert chip_smoke._LEAD is report._LEAD
    src = "".join(inspect.getsource(f) for f in (
        report.device_ms, report.guarded_session, report._session,
        report.bracketed))
    assert "flush_names = {e.name for e in guarded_session(" in src
    assert "} - _SPIN_NAMES" in src
    assert "for _ in range(_LEAD[0]):" in src
    assert "torch.cuda._sleep(PAD_CYCLES)" in src
    assert src.count("torch.cuda._sleep(SHORT_CYCLES)") == 2
    assert "skip = _SPIN_NAMES | flush_names" in src
    assert "e.name not in skip" in src
    assert "sum(e.name in flush_names for e in ks) == iters" in src
    assert "sum(e.name in _SPIN_NAMES for e in kernels) >= 3" in src
    assert "_LEAD[0] *= 2" in src
    assert chip_smoke.MAX_LEAD > chip_smoke._LEAD[0] > 0


def test_profiler_window_script_needs_a_card(capsys):
    """The profiler-loss probe refuses to run without a CUDA card."""
    import importlib.util
    path = Path(chip_smoke.__file__).parent / "scripts" / \
        "torch_profiler_window.py"
    spec = importlib.util.spec_from_file_location("torch_profiler_window",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--rounds", "1", "--burst", "1", "--idle", "0"]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err
