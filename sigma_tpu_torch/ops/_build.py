"""Build and bind the port's CUDA kernels.

The sources under ``sigma_tpu_torch/csrc/`` are compiled by ``nvcc`` into a
shared library with a plain C interface at first use, and loaded with
``ctypes``.  The library lands in ``build/sigma_tpu_torch/`` at the root of
the checkout, named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused.  Nothing here runs at
import time: the CPU-only machines that run the tests have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

__all__ = ["Build", "build", "library"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "dia_spmv.cu"
BUILD_DIR = _PKG.parent / "build" / "sigma_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # compile time of this call; 0.0 when reused
    log: str  # nvcc's output (ptxas register/shared-memory report)


def _nvcc() -> str:
    """nvcc from CUDA_HOME/CUDA_PATH, else PATH, else /usr/local/cuda (the
    search of ``torch.utils.cpp_extension.CUDA_HOME``)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME or put nvcc on PATH to build "
            f"{SOURCE.name}"
        )
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def build() -> Build:
    """Compile the kernels unless a library of this source and these flags
    is already built; raise with the compiler's output on failure."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libdia_spmv-{key}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return Build(out, 0.0, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
        )
    log_path.write_text(log)
    os.replace(tmp, out)  # atomic: another process never loads a partial file
    return Build(out, seconds, log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every entry
    point's argument types declared: pointers and the stream as c_void_p,
    sizes as c_int64."""
    lib = ctypes.CDLL(str(build().path))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sigma_dia_spmv.argtypes = [
        i32, i32, i32, ptr, ptr, ptr, ptr, i64, i64, i64, i64, ptr,
    ]
    lib.sigma_dia_spmv.restype = i32
    lib.sigma_dia_sym_spmv.argtypes = [
        i32, i32, i32, ptr, ptr, ptr, ptr, i64, i64, i64, ptr,
    ]
    lib.sigma_dia_sym_spmv.restype = i32
    return lib
