"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``; ``csrc/*.cuh`` are headers
they share.  The build runs at first
use, into ``build/kernels/<hash>/`` at the repository root, where ``<hash>``
covers every source under ``csrc/`` and the compiler flags: a changed source
gets a fresh build, an unchanged one loads the cached library.

Every launcher returns its ``cudaError_t``; :func:`check` raises on a
non-zero one.  Each wrapper counts its launches in the port's counter
table, ``trcnn_torch.utils.profiling.counters["launch.<counter>"]`` (one of
``COUNTERS``), so a run can show that the main path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
KERNELS = ("nms", "roi_pool", "roi_pool_bwd", "stem", "roi_align", "roi_align_bwd",
           "frozen_bn")
# the launch counters' names: one per kernel, K4's large-map variant apart
# (it lives in libroi_pool_bwd.so)
COUNTERS = KERNELS + ("roi_pool_bwd_large",)
# no --use_fast_math: it makes '/' inexact, and RoI bin bounds need the IEEE
# quotient (csrc/roi_pool.cu)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from trcnn_torch/csrc at first use")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every missing library in parallel; returns each new build's
    compiler output (ptxas register and shared-memory report)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        so = out_dir / f"lib{name}.so"
        if so.exists():
            continue
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    logs = {}
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def timed_build() -> Tuple[float, Dict[str, str]]:
    """Build every missing kernel in parallel and load them all; returns the
    seconds taken and the compiler output of each new build."""
    t0 = time.perf_counter()
    with _lock:
        logs = build_all()
    for name in KERNELS:
        library(name)
    return time.perf_counter() - t0, logs


def library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = build_dir() / f"lib{name}.so"
            if not so.exists():
                build_all([name])
            lib = ctypes.CDLL(str(so))
            _libs[name] = lib
        return lib


def function(lib_name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """A launcher from ``lib<lib_name>.so`` with its C signature declared."""
    fn = getattr(library(lib_name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
