"""Build and bind the port's CUDA kernels.

Every source ``sigma_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` (one
process per source, all started together) and the objects are linked into
one shared library with a plain C interface at first use, loaded with
``ctypes``.  The library lands in ``build/sigma_tpu_torch/`` at the root of
the checkout, named by a hash of every source and header and the flags, so
an edited source is rebuilt and an unchanged one is reused.  Nothing here
runs at import time: the CPU-only machines that run the tests have no
``nvcc``.
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
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "sigma_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # compile time of this call; 0.0 when reused
    log: str  # nvcc's output (ptxas register, shared-memory and spill report)


def _nvcc() -> str:
    """nvcc from CUDA_HOME/CUDA_PATH, else PATH, else /usr/local/cuda (the
    search of ``torch.utils.cpp_extension.CUDA_HOME``)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME or put nvcc on PATH to build "
            f"the kernels in {CSRC}"
        )
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def sources() -> list[Path]:
    """The kernel sources compiled into the library, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def _run_all(cmds) -> str:
    """Run the commands concurrently; return their joined output, or raise
    with the output of the first that failed."""
    cmds = list(cmds)
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    logs = [p.communicate()[0] for p in procs]
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}\n{log}")
    return "".join(logs)


def build() -> Build:
    """Compile the kernels unless a library of these sources and these
    flags is already built; raise with the compiler's output on failure."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):  # sources and headers
        h.update(f.name.encode() + f.read_bytes())
    key = h.hexdigest()[:16]
    out = BUILD_DIR / f"libsigma_kernels-{key}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return Build(out, 0.0, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{key}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}-{tag}.o" for src in sources()]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    log = _run_all(
        [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(o), str(s)]
        for s, o in zip(sources(), objs)
    )
    log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink()
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
    lib.sigma_dia_spmm.argtypes = [
        i32, i32, i32, ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, i64, i64, ptr,
    ]
    lib.sigma_dia_spmm.restype = i32
    lib.sigma_dia_spmm_config.argtypes = [i32, i32, i64, ptr]
    lib.sigma_dia_spmm_config.restype = i32
    lib.sigma_dia_spmm_grouped.argtypes = lib.sigma_dia_spmm.argtypes
    lib.sigma_dia_spmm_grouped.restype = i32
    lib.sigma_dia_spmm_grouped_config.argtypes = [i32, i32, ptr]
    lib.sigma_dia_spmm_grouped_config.restype = i32
    # (..., D, stride, n, m, least offset, greatest offset, stream)
    lib.sigma_dia_spmv_resident.argtypes = [
        i32, i32, i32, ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, i64, ptr,
    ]
    lib.sigma_dia_spmv_resident.restype = i32
    # (..., D, stride, n, m, plan, pieces, tile_rows, length, stream)
    lib.sigma_dia_spmv_window.argtypes = [
        i32, i32, i32, ptr, ptr, ptr, ptr, i64, i64, i64, i64, ptr, i64, i64, i64, ptr,
    ]
    lib.sigma_dia_spmv_window.restype = i32
    lib.sigma_dia_sym_spmm.argtypes = [
        i32, i32, i32, ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, ptr,
    ]
    lib.sigma_dia_sym_spmm.restype = i32
    # pruned entries: (device, vtype, xtype, data, x, offsets, tile_ptr,
    # [tile_end,] outputs..., tile_rows, n_tiles, sizes..., stream)
    pruned = {
        "sigma_pruned_spmv": (2, 2),  # tile_end, y; sizes n, m
        "sigma_pruned_spmm": (2, 5),  # tile_end, y; n, m, k, bx, by
        "sigma_pruned_sym_spmv": (3, 5),  # tile_end, y, spill; n, m, sym_shift, spill_rows, rows_out
        "sigma_pruned_sym_spmm": (3, 9),  # tile_end, y, spill; n, m, k, bx, by, bs, sym_shift, spill_rows, rows_out
    }
    for name, (n_ptr, n_sizes) in pruned.items():
        fn = getattr(lib, name)
        fn.argtypes = [i32, i32, i32, ptr, ptr, ptr, ptr, *[ptr] * n_ptr, i64, i64,
                       *[i64] * n_sizes, ptr]
        fn.restype = i32
    # (device, vtype, xtype, gdata, gcols, gptr, x, y, nb_rows, bh, bw, B, k,
    # form, stream)
    lib.sigma_bsr_grouped_spmv.argtypes = [
        i32, i32, i32, ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, i64, ptr,
    ]
    lib.sigma_bsr_grouped_spmv.restype = i32
    return lib
