"""ctypes binding of the port's host library (``csrc/host/pruned_host.cpp``).

The library holds the host set-up of the unstructured pruned path:
adjacency, the breadth-first and reverse Cuthill-McKee orderings, the
pruned block-DIA pack and the multigrid's 1-D pair coarsening.  It is the port's own copy of those
functions of the JAX package's host core, so the port never loads that
package.

The host C++ compiler (``g++``, or ``$CXX``) builds it at first use into
``build/sigma_tpu_torch/`` at the root of the checkout, named by a hash of
the source and the flags.  A build writes a temporary file and renames it
into place under a file lock, so processes that start together (test
workers) build it once and never load a partial file.  Without a compiler
the first call raises: there is no silent fallback (the numpy forms are
the tests' plain versions).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "adjacency_from_coo",
    "bfs_order",
    "coarsen_pair",
    "library",
    "pack_pruned",
    "rcm_order",
]

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host" / "pruned_host.cpp"
BUILD_DIR = _PKG.parent / "build" / "sigma_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

# the pack and the coarsening are two-call protocols over static C++
# buffers, and ctypes releases the GIL during each call
_TWO_CALL_LOCK = threading.Lock()

_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(
            f"no host C++ compiler (g++ or $CXX) to build {SOURCE.name}; the "
            "unstructured set-up needs it"
        )
    return cxx


def build() -> Path:
    """The built library, compiled unless one of this source and these
    flags exists; raises with the compiler's output on failure."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    out = BUILD_DIR / f"libsigma_torch_host-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            p = subprocess.run(
                [_compiler(), *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                capture_output=True, text=True,
            )
            if p.returncode != 0:
                raise RuntimeError(
                    f"building {SOURCE.name} failed ({p.returncode}):\n{p.stdout}{p.stderr}"
                )
            os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded host library (built on first call), argument types set."""
    lib = ctypes.CDLL(str(build()))
    i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.adjacency_from_coo.restype = None
    lib.adjacency_from_coo.argtypes = [i64, i64, _i64p, _i64p, _i64p, _i64p]
    lib.bfs_order.restype = None
    lib.bfs_order.argtypes = [i64, _i64p, _i64p, i64, _i64p]
    lib.rcm_order.restype = None
    lib.rcm_order.argtypes = [i64, _i64p, _i64p, _i64p]
    lib.pack_pruned_count.restype = i64
    lib.pack_pruned_count.argtypes = [i64, _i64p, _i64p, _f64p, i64, i64, i64, i64]
    lib.pack_pruned_active.restype = i64
    lib.pack_pruned_active.argtypes = []
    lib.pack_pruned_fill.restype = None
    lib.pack_pruned_fill.argtypes = [i64, i64, i64, i32, ptr, _i64p, _i64p]
    lib.coarsen_pair_count.restype = i64
    lib.coarsen_pair_count.argtypes = [i64, _i64p, _i64p, _f64p, i64]
    lib.coarsen_pair_fetch.restype = None
    lib.coarsen_pair_fetch.argtypes = [i64, i64, _i64p, _i64p, _f64p]
    return lib


def _c64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def _cf64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


def adjacency_from_coo(n: int, rows, cols):
    """Row-grouped adjacency ``(cols, indptr)`` of duplicate-free COO
    edges: a counting sort by row only (no dedup, no column sort), which
    is all an ordering needs."""
    rows, cols = _c64(rows), _c64(cols)
    out_c = np.empty(rows.size, dtype=np.int64)
    indptr = np.empty(int(n) + 1, dtype=np.int64)
    library().adjacency_from_coo(int(n), rows.size, rows, cols, out_c, indptr)
    return out_c, indptr


def bfs_order(indptr, indices, start: int = 0) -> np.ndarray:
    """Breadth-first visit ranks of a CSR adjacency from ``start``,
    restarting at the lowest unvisited vertex (``p[v]`` is the visit rank
    of v)."""
    indptr, indices = _c64(indptr), _c64(indices)
    n = indptr.size - 1
    if n and not 0 <= int(start) < n:
        raise ValueError(f"start vertex {start} out of range for {n} vertices")
    perm = np.empty(n, dtype=np.int64)
    library().bfs_order(n, indptr, indices, int(start), perm)
    return perm


def rcm_order(indptr, indices) -> np.ndarray:
    """Reverse Cuthill-McKee permutation of a CSR adjacency, scatter form
    (``p[v]`` is the new label of v)."""
    indptr, indices = _c64(indptr), _c64(indices)
    perm = np.empty(indptr.size - 1, dtype=np.int64)
    library().rcm_order(indptr.size - 1, indptr, indices, perm)
    return perm


def pack_pruned(rows, cols, vals, *, tile_rows: int, group: int, reach: int,
                n_tiles: int, dtype):
    """The pruned pack: entries sorted by (tile, offset) and written into
    ``(data, offsets, tile_ptr, n_active)``: data ``(L * group,
    tile_rows)`` of ``dtype`` (float32 or float64), one signed column
    offset per slot, the first slot of each of ``n_tiles`` tiles (and the
    slot count at the end), and the number of active (tile, offset)
    pairs.  Duplicate entries: the last value wins."""
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.float64):
        raise TypeError(f"the pack writes float32 or float64, not {dtype}")
    rows, cols, vals = _c64(rows), _c64(cols), _cf64(vals)
    lib = library()
    with _TWO_CALL_LOCK:
        L = int(lib.pack_pruned_count(
            rows.size, rows, cols, vals, tile_rows, group, reach, n_tiles
        ))
        n_active = int(lib.pack_pruned_active())
        data = np.zeros((L * group, tile_rows), dtype=dtype)
        offsets = np.zeros(L * group, dtype=np.int64)
        tile_ptr = np.empty(n_tiles + 1, dtype=np.int64)
        lib.pack_pruned_fill(
            rows.size, tile_rows, group, int(dtype == np.float64),
            data.ctypes.data, offsets, tile_ptr,
        )
    return data, offsets, tile_ptr, n_active


def coarsen_pair(rows, cols, vals, nc: int):
    """1-D pair-aggregation Galerkin coarsening ``C[r//2, c//2] += v/2``
    with duplicates summed in input order and exact cancellations
    dropped; returns canonical ``(rows, cols, vals)`` (vals float64)."""
    rows, cols, vals = _c64(rows), _c64(cols), _cf64(vals)
    lib = library()
    with _TWO_CALL_LOCK:
        n_out = int(lib.coarsen_pair_count(rows.size, rows, cols, vals, int(nc)))
        out_r = np.empty(n_out, dtype=np.int64)
        out_c = np.empty(n_out, dtype=np.int64)
        out_v = np.empty(n_out, dtype=np.float64)
        lib.coarsen_pair_fetch(n_out, int(nc), out_r, out_c, out_v)
    return out_r, out_c, out_v
