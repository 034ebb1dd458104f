"""Build and load the port's hand-written kernels at first use.

CUDA C++: every ``*.cu`` under ``apex_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
(one library per source, all sources compiled in parallel), under
``build/apex_tpu_torch/`` at the repository root, and loaded with
``ctypes``. A library's file name carries a digest of its source, the
shared headers and the flags, so an edited source is rebuilt and a stale
build is never loaded. ``ptxas -v`` output (registers, shared memory,
spills) is kept beside each library as ``<name>.ptxas.txt``.

Host C++: every ``*.cpp`` under ``csrc/`` (the JPEG codec's library) is
compiled by the host compiler (``$CXX``, else ``g++``) with
``-O3 -ffp-contract=off -shared -fPIC`` into the same directory under the same digest rule,
at first use and on the CPU too (:func:`load_host`); ``build_all`` does
not build these.

Triton: kernels are plain functions in their op modules; :func:`triton_jit`
imports Triton and compiles them at their first launch, so importing the
port never needs Triton or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "apex_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

HOST_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}   # loaded libraries, by source stem
#: builds run by this process (``prof.compile_watch`` reads them): nvcc
#: and host-compiler runs, and the seconds they took
BUILDS = {"nvcc": 0, "host": 0, "secs": 0.0}
#: every Triton kernel ``triton_jit`` made, for the compile watcher
JITTED: list = []
_HOST_LOCK = threading.Lock()        # one build per process (decode threads)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build apex_tpu_torch's CUDA kernels")


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every CUDA source that has no current build; return
    ``{source stem: library path}``. One ``nvcc`` per source, all started
    together; raises with the compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, []
    for src in sorted(CSRC.glob("*.cu")):
        lib = out[src.stem] = _target(src)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    t0 = time.perf_counter()
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name}:\n{log}")
            continue
        lib.with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, lib)
    if procs:
        BUILDS["nvcc"] += len(procs)
        BUILDS["secs"] += time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_all()[name]))
    return _LIBS[name]


def _cxx() -> str:
    for cand in (os.environ.get("CXX", ""), shutil.which("g++") or "",
                 shutil.which("c++") or ""):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no C++ compiler found: set CXX or put g++ on PATH "
                       "to build apex_tpu_torch's host libraries")


def build_host(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` for the host unless a current build
    exists; return the library's path. Raises with the compiler's output
    if it fails."""
    src = CSRC / f"{name}.cpp"
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(src.read_bytes())
    lib = BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_cxx(), *HOST_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the host compiler failed on {src.name}:\n"
                           f"{proc.stdout}")
    os.replace(tmp, lib)
    BUILDS["host"] += 1
    BUILDS["secs"] += time.perf_counter() - t0
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library built from ``csrc/<name>.cpp``."""
    key = f"host:{name}"
    if key not in _LIBS:
        with _HOST_LOCK:
            if key not in _LIBS:
                _LIBS[key] = ctypes.CDLL(str(build_host(name)))
    return _LIBS[key]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(t) -> int:
    """The raw handle of the current stream on ``t``'s device."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.device.index)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The SM count of a CUDA device, read once a device."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def triton_jit(fn):
    """``triton.jit(fn)``, importing Triton at the first launch.

    The kernel bodies name ``tl``; it is bound in the kernel's module here,
    since that module cannot import Triton at import time.
    """
    import triton
    import triton.language as tl

    fn.__globals__["tl"] = tl
    jf = triton.jit(fn)
    JITTED.append(jf)
    return jf


def workspace(cache, device, stream, n_part, n_counters):
    """A kernel's f32 partials (>= ``n_part``) and int32 counters (>=
    ``n_counters``, all 0), kept in ``cache`` for one stream (a raw stream
    handle, on ``device``) and grown when a call needs more. Sharing them
    between calls is safe for a kernel whose last block reads every partial
    and sets its counters back to 0: a stream runs its launches in order."""
    import torch
    part, counters = cache.get(stream, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32, device=device)
    cache[stream] = (part, counters)
    return part, counters


def check_operands(*tensors, dtypes=None) -> None:
    """Kernel operands: contiguous tensors on one CUDA device, and (with
    ``dtypes``) each of one of those dtypes."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"kernel operands must share one CUDA device; "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
        if dtypes is not None and t.dtype not in dtypes:
            raise ValueError(f"kernel operand dtype {t.dtype} not in "
                             f"{dtypes}")
