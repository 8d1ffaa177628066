"""ctypes binding of the port's host library (``csrc/host/pruned_host.cpp``
and ``csrc/host/sparse_host.cpp``).

The library holds the host set-up of the unstructured pruned path
(adjacency, the breadth-first, reverse Cuthill-McKee and Sloan orderings, the
pruned block-DIA pack and the multigrid's 1-D pair coarsening) and of the
generic sparse paths (the sorted CSR of COO edges; greedy colouring; the dependency levels, ILU(0) and
ILU(k) factorizations and level pack of the ILDU preconditioner; the two
AMG aggregations; the one-shot CSR SpGEMM, sum and transpose).  It is the
port's own copy of those functions of the JAX package's host core, so the
port never loads that package.

The host C++ compiler (``g++``, or ``$CXX``) builds both sources into one
library at first use, into ``build/sigma_tpu_torch/`` at the root of the
checkout, named by a hash of the sources and the flags.  A build writes a
temporary file and renames it into place under a file lock, so processes
that start together (test workers) build it once and never load a
partial file.  Without a compiler the first call raises: there is no
silent fallback (the numpy forms are the tests' plain versions).
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
    "available",
    "bfs_order",
    "coarsen_pair",
    "csr_add",
    "csr_from_coo",
    "csr_transpose",
    "greedy_aggregate",
    "greedy_coloring",
    "ilu0_factorize",
    "iluk_symbolic",
    "library",
    "pack_levels",
    "pack_pruned",
    "rcm_order",
    "sloan_order",
    "spgemm",
    "triangular_levels",
    "vmb_aggregate",
]

_PKG = Path(__file__).resolve().parent
SOURCES = tuple(_PKG / "csrc" / "host" / f for f in ("pruned_host.cpp", "sparse_host.cpp"))
BUILD_DIR = _PKG.parent / "build" / "sigma_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

# the pruned pack, the coarsening and the fused SpGEMM are two-call
# protocols over static C++ buffers, and ctypes releases the GIL during
# each call
_TWO_CALL_LOCK = threading.Lock()

_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(
            "no host C++ compiler (g++ or $CXX) to build the host library "
            f"({', '.join(s.name for s in SOURCES)}); the host set-up needs it"
        )
    return cxx


def build() -> Path:
    """The built library, compiled unless one of these sources and these
    flags exists; raises with the compiler's output on failure."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libsigma_torch_host-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            p = subprocess.run(
                [_compiler(), *CXX_FLAGS, *map(str, SOURCES), "-o", str(tmp)],
                capture_output=True, text=True,
            )
            if p.returncode != 0:
                raise RuntimeError(
                    f"building the host library failed ({p.returncode}):\n{p.stdout}{p.stderr}"
                )
            os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded host library (built on first call), argument types set."""
    lib = ctypes.CDLL(str(build()))
    i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.csr_from_coo.restype = i64
    lib.csr_from_coo.argtypes = [i64, i64, i64, _i64p, _i64p, _i64p, _i64p, _i64p]
    lib.adjacency_from_coo.restype = None
    lib.adjacency_from_coo.argtypes = [i64, i64, _i64p, _i64p, _i64p, _i64p]
    lib.bfs_order.restype = None
    lib.bfs_order.argtypes = [i64, _i64p, _i64p, i64, _i64p]
    lib.rcm_order.restype = None
    lib.rcm_order.argtypes = [i64, _i64p, _i64p, _i64p]
    lib.sloan_order.restype = None
    lib.sloan_order.argtypes = [i64, _i64p, _i64p, _i64p]
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
    lib.greedy_coloring.restype = i64
    lib.greedy_coloring.argtypes = [i64, _i64p, _i64p, _i64p]
    lib.triangular_levels.restype = i64
    lib.triangular_levels.argtypes = [i64, _i64p, _i64p, i64, _i64p]
    lib.ilu0_factorize.restype = i64
    lib.ilu0_factorize.argtypes = [i64, _i64p, _i64p, _f64p, _f64p]
    lib.pack_levels.restype = None
    lib.pack_levels.argtypes = [i64, _i64p, _i64p, _f64p, _i64p, i64, _i64p, i64, _i64p,
                                _i64p, _f64p]
    lib.greedy_aggregate.restype = i64
    lib.greedy_aggregate.argtypes = [i64, _i64p, _i64p, _i64p]
    lib.vmb_aggregate.restype = i64
    lib.vmb_aggregate.argtypes = [i64, _i64p, _i64p, _i64p]
    lib.iluk_symbolic.restype = i64
    lib.iluk_symbolic.argtypes = [i64, _i64p, _i64p, i64, i64, _i64p, _i64p]
    lib.spgemm_fused.restype = i64
    lib.spgemm_fused.argtypes = [i64, i64, _i64p, _i64p, _f64p, _i64p, _i64p, _f64p, _i64p]
    lib.spgemm_fetch.restype = None
    lib.spgemm_fetch.argtypes = [i64, _i64p, _f64p]
    lib.csr_add_symbolic.restype = i64
    lib.csr_add_symbolic.argtypes = [i64, _i64p, _i64p, _i64p, _i64p, _i64p]
    lib.csr_add_numeric.restype = None
    lib.csr_add_numeric.argtypes = [i64, ctypes.c_double, ctypes.c_double, _i64p, _i64p, _f64p,
                                    _i64p, _i64p, _f64p, _i64p, _i64p, _f64p]
    lib.csr_transpose.restype = None
    lib.csr_transpose.argtypes = [i64, i64, _i64p, _i64p, _f64p, _i64p, _i64p, _f64p]
    return lib


def available() -> bool:
    """Whether the host library builds (at the first call) and loads."""
    try:
        library()
    except (OSError, RuntimeError):
        return False
    return True


def _c64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def _cf64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


def csr_from_coo(n: int, m: int, rows, cols):
    """Sorted, deduplicated ``(rows, cols, indptr)`` of COO edges in an
    (n, m) pattern: a radix sort of the keys ``row * m + col``.  The graph
    formats sort with numpy instead, which is faster; this is the JAX
    package's native counterpart, kept for callers of that name."""
    n, m = int(n), int(m)
    rows, cols = _c64(rows), _c64(cols)
    if rows.size != cols.size:
        raise ValueError(f"rows ({rows.size}) and cols ({cols.size}) differ in length")
    if rows.size and (rows.min() < 0 or rows.max() >= n or cols.min() < 0 or cols.max() >= m):
        raise ValueError(f"COO index out of range for shape ({n}, {m})")
    out_r = np.empty(rows.size, dtype=np.int64)
    out_c = np.empty(rows.size, dtype=np.int64)
    indptr = np.empty(n + 1, dtype=np.int64)
    w = library().csr_from_coo(n, m, rows.size, rows, cols, out_r, out_c, indptr)
    return out_r[:w], out_c[:w], indptr


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


def sloan_order(indptr, indices) -> np.ndarray:
    """Sloan wavefront-minimizing permutation of a CSR adjacency, scatter
    form (``p[v]`` is the new label of v).  The wavefront is a row's local
    bandwidth, which is what sets the pruned layout's active diagonals a
    row tile."""
    indptr, indices = _c64(indptr), _c64(indices)
    perm = np.empty(indptr.size - 1, dtype=np.int64)
    library().sloan_order(indptr.size - 1, indptr, indices, perm)
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


# -- the generic sparse paths ------------------------------------------------
def greedy_coloring(indptr, indices):
    """First-fit colouring of a CSR adjacency in vertex order: ``(colors,
    number of colours)``."""
    indptr, indices = _c64(indptr), _c64(indices)
    n = indptr.size - 1
    colors = np.empty(n, dtype=np.int64)
    nc = library().greedy_coloring(n, indptr, indices, colors)
    return colors, int(nc)


def triangular_levels(indptr, indices, reverse: bool = False):
    """Dependency levels of a strict lower (``reverse=False``) or upper
    triangular CSR pattern: ``(level of each row, number of levels)``."""
    indptr, indices = _c64(indptr), _c64(indices)
    n = indptr.size - 1
    lvl = np.empty(n, dtype=np.int64)
    nl = library().triangular_levels(n, indptr, indices, int(bool(reverse)), lvl)
    return lvl, int(nl)


def ilu0_factorize(indptr, indices, data):
    """ILU(0) of a sorted CSR matrix on its own pattern: ``(lu, diag)``, lu
    holding L left of the diagonal, D on it and the rows of D U right of it.
    Raises ZeroDivisionError on a zero or missing pivot."""
    indptr, indices = _c64(indptr), _c64(indices)
    n = indptr.size - 1
    lu = _cf64(data).copy()
    diag = np.empty(n, dtype=np.float64)
    bad = library().ilu0_factorize(n, indptr, indices, lu, diag)
    if bad:
        raise ZeroDivisionError(
            f"zero or missing pivot at row {int(bad) - 1} in ILDU(0) factorization")
    return lu, diag


def pack_levels(indptr, indices, data, level, nlev: int, width: int):
    """A strict triangular CSR system packed by dependency level: ``(rows,
    cols, vals, level_ptr)``, level l's rows at ``rows[level_ptr[l] :
    level_ptr[l + 1]]`` in ascending order, each row's entries in its
    ``width`` slots of ``cols`` / ``vals`` (n, width), padded with the row's
    own index and 0."""
    indptr, indices, level = _c64(indptr), _c64(indices), _c64(level)
    n = indptr.size - 1
    level_ptr = np.zeros(int(nlev) + 1, dtype=np.int64)
    np.cumsum(np.bincount(level, minlength=int(nlev)), out=level_ptr[1:])
    rows = np.empty(n, dtype=np.int64)
    cols = np.empty((n, int(width)), dtype=np.int64)
    vals = np.empty((n, int(width)), dtype=np.float64)
    library().pack_levels(n, indptr, indices, _cf64(data), level, int(nlev), level_ptr,
                          int(width), rows, cols.reshape(-1), vals.reshape(-1))
    return rows, cols, vals, level_ptr


def greedy_aggregate(indptr, indices):
    """Greedy AMG aggregation of a CSR adjacency: ``(aggregate ids,
    number of aggregates)``."""
    indptr, indices = _c64(indptr), _c64(indices)
    agg = np.empty(indptr.size - 1, dtype=np.int64)
    na = library().greedy_aggregate(agg.size, indptr, indices, agg)
    return agg, int(na)


def vmb_aggregate(indptr, indices):
    """VMB three-phase aggregation of a CSR adjacency: ``(aggregate ids,
    number of aggregates)``."""
    indptr, indices = _c64(indptr), _c64(indices)
    agg = np.empty(indptr.size - 1, dtype=np.int64)
    na = library().vmb_aggregate(agg.size, indptr, indices, agg)
    return agg, int(na)


def iluk_symbolic(indptr, indices, k: int):
    """Level-of-fill ILU(k) pattern (L + diag + U, sorted CSR) of a sorted
    CSR pattern: ``(indptr, cols)``.  A first guess of the capacity, and one
    retry at the exact size the library reports when it is too small."""
    indptr, indices = _c64(indptr), _c64(indices)
    n = indptr.size - 1
    cap = max(int(indptr[-1]) * (int(k) + 2), 16)
    for _ in range(2):
        fptr = np.empty(n + 1, dtype=np.int64)
        fcol = np.empty(cap, dtype=np.int64)
        got = library().iluk_symbolic(n, indptr, indices, int(k), cap, fptr, fcol)
        if got >= 0:
            return fptr, fcol[:got]
        cap = -got
    raise AssertionError("iluk_symbolic capacity retry failed")


def spgemm(aptr, acol, aval, bptr, bcol, bval, m: int):
    """C = A @ B of row-sorted host CSR operands in O(nnz(C)) memory
    (Gustavson): ``(indptr, cols, vals)`` of C, rows sorted, vals float64."""
    aptr, acol, aval = _c64(aptr), _c64(acol), _cf64(aval)
    bptr, bcol, bval = _c64(bptr), _c64(bcol), _cf64(bval)
    n = aptr.size - 1
    cptr = np.empty(n + 1, dtype=np.int64)
    lib = library()
    with _TWO_CALL_LOCK:
        nnz = lib.spgemm_fused(n, int(m), aptr, acol, aval, bptr, bcol, bval, cptr)
        ccol = np.empty(nnz, dtype=np.int64)
        cval = np.empty(nnz, dtype=np.float64)
        lib.spgemm_fetch(nnz, ccol, cval)
    return cptr, ccol, cval


def csr_add(aptr, acol, aval, bptr, bcol, bval, alpha: float = 1.0, beta: float = 1.0):
    """C = alpha A + beta B on the union sparsity of row-sorted host CSR
    operands: ``(indptr, cols, vals)``."""
    aptr, acol, aval = _c64(aptr), _c64(acol), _cf64(aval)
    bptr, bcol, bval = _c64(bptr), _c64(bcol), _cf64(bval)
    n = aptr.size - 1
    cptr = np.empty(n + 1, dtype=np.int64)
    lib = library()
    nnz = lib.csr_add_symbolic(n, aptr, acol, bptr, bcol, cptr)
    ccol = np.empty(nnz, dtype=np.int64)
    cval = np.empty(nnz, dtype=np.float64)
    lib.csr_add_numeric(n, float(alpha), float(beta), aptr, acol, aval, bptr, bcol, bval,
                        cptr, ccol, cval)
    return cptr, ccol, cval


def csr_transpose(aptr, acol, aval, m: int):
    """T = A^T of an (n x m) row-sorted host CSR: ``(indptr, cols, vals)``
    of T, rows sorted."""
    aptr, acol, aval = _c64(aptr), _c64(acol), _cf64(aval)
    n = aptr.size - 1
    ne = int(aptr[-1])
    tptr = np.empty(int(m) + 1, dtype=np.int64)
    tcol = np.empty(ne, dtype=np.int64)
    tval = np.empty(ne, dtype=np.float64)
    library().csr_transpose(n, int(m), aptr, acol, aval, tptr, tcol, tval)
    return tptr, tcol, tval
