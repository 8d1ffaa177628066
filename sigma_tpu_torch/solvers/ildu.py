"""Incomplete LDU(0) / ILU(k) / IC(0) factorization and level-scheduled
triangular sweeps.

Port of :mod:`sigma_tpu.solvers.ildu`.  A ~= L D U with L and U unit
triangular, stored as their strict parts (the reference's L - I, U - I)
and D as a vector; ``ldu(level=k)`` goes beyond the reference's zero fill
with level-of-fill ILU(k), and for SPD A zero fill is incomplete Cholesky.

* **Factorization** (host, float64): the ILU(0) sweep on A's pattern, or
  on the level-k pattern of the symbolic pass, in the port's host library
  (``native.ilu0_factorize``, ``native.iluk_symbolic``); the factors are
  cast to A's dtype once.
* **Sweeps** (A's device): the rows of each triangular factor are grouped
  into the dependency levels of its DAG (``native.triangular_levels``)
  and packed level by level (``native.pack_levels``): level l's rows sit
  at ``rows[level_ptr[l] : level_ptr[l + 1]]`` with their entries in
  ``width`` slots of ``cols`` / ``vals``, a row's unused slots pointing at
  the row itself with value 0.  ``solve`` is one gather, multiply, row
  sum and write a level (gather-only, so fixed order by construction);
  ``solve_t`` walks the same levels in reverse and scatters, with one
  fixed-order sum plan a level built at set-up off the CPU.  The JAX
  package pads every level to the widest with sentinel rows = n whose
  scatter XLA drops; torch has no dropping scatter, so the port packs the
  levels without sentinels (no discard slot, and no work on pad rows).

On the card ``solve`` is one launch of the level-sweep kernel
(:func:`~sigma_tpu_torch.ops.ildu_sweep.level_sweep`,
``csrc/ildu_sweep.cu``), the counterpart of the JAX package's
``fori_loop`` over the levels: a persistent grid walks the packed slots
with no barrier between levels, each row waiting on its own
dependencies' ready flags with its indices and values already loaded,
reading nothing back; so an ILDU apply is two launches, the memsets of
their flags and the scale by ``dinv``, and it runs under a captured
graph (:func:`~sigma_tpu_torch.solvers.graphed.graphed`).  On the CPU it
runs the kernel's plain version, the loop of one batched update a level.
The 7-point 3-D Laplacian at nx=100 has 298 levels a sweep in natural
order, a chain of 297 dependent steps on the card; a colour ordering
(:func:`~sigma_tpu_torch.graph.permutations.greedy_color_ordering`)
collapses the levels to at most the colours (2 + 2 on that stencil).
``solve_t`` (the rmatvec's scatter sweep) is still a Python loop of
launches a level.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from sigma_tpu_torch import native
from sigma_tpu_torch.graph.graph import host_csr
from sigma_tpu_torch.operators.linear_operator import LinearOperator, MatvecOperator
from sigma_tpu_torch.ops.ildu_sweep import level_sweep
from sigma_tpu_torch.solvers.base import LinearSolver
from sigma_tpu_torch.solvers.krylov import SolveInfo
from sigma_tpu_torch.utils import ordered_sum
from sigma_tpu_torch.utils.device import resolve_device
from sigma_tpu_torch.utils.dtypes import torch_dtype

__all__ = [
    "ILDUPreconditioner",
    "LDUSolver",
    "TriangularLevels",
    "ildu0_factorize",
    "ilu0_factorize_reference",
    "iluk_factorize",
    "iluk_symbolic_reference",
    "incomplete_cholesky",
    "ldu",
    "pack_levels_reference",
    "triangular_levels_reference",
]


def _csr_arrays(A) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr, indices, data in float64) host CSR of any SparseMatrix."""
    rows, cols, vals = A.entries()
    indptr, indices, data = host_csr(rows, cols, A.shape[0], vals)
    return indptr, indices, np.asarray(data, dtype=np.float64)


def ilu0_factorize_reference(indptr, indices, data, n):
    """Plain numpy version of ``native.ilu0_factorize``: SPARSKIT's ikj
    ILU(0) with a position-marker work array, the update over row k's
    upper entries vectorised.  Returns (lu, diag)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    lu = np.asarray(data, dtype=np.float64).copy()
    diag = np.zeros(n, dtype=np.float64)
    ipos = np.full(n, -1, dtype=np.int64)  # column -> position in the current row
    diag_pos = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols_i = indices[s:e]
        ipos[cols_i] = np.arange(s, e)
        for p in range(s, e):
            k = indices[p]
            if k >= i:
                break
            lik = lu[p] / diag[k]  # l_ik = a_ik / u_kk
            lu[p] = lik
            # a_ij -= l_ik u_kj for j > k in row k's pattern and row i's
            ks, ke = diag_pos[k] + 1, indptr[k + 1]
            pos = ipos[indices[ks:ke]]
            valid = pos >= 0
            if valid.any():
                lu[pos[valid]] -= lik * lu[ks:ke][valid]
        dp = np.searchsorted(cols_i, i) + s
        if dp >= e or indices[dp] != i or lu[dp] == 0.0:
            raise ZeroDivisionError(f"zero or missing pivot at row {i} in ILDU(0) factorization")
        diag_pos[i] = dp
        diag[i] = lu[dp]
        ipos[cols_i] = -1
    return lu, diag


def ildu0_factorize(A):
    """Zero-fill LDU factorization A ~= L D U (L, U unit triangular):
    ``(L_csr, d, U_csr)``, L and U as (indptr, indices, data) holding the
    strict parts only.  Runs in the host library in float64."""
    if A.shape[0] != A.shape[1]:
        raise ValueError("ILDU requires a square matrix")
    indptr, indices, data = _csr_arrays(A)
    lu, diag = native.ilu0_factorize(indptr, indices, data)
    return _split_ldu(indptr, indices, lu, diag, A.shape[0])


def iluk_symbolic_reference(indptr, indices, n, k):
    """Plain Python version of ``native.iluk_symbolic`` (the same
    recurrence: lev(fill l via j) = lev(i, j) + lev(j, l) + 1, kept when
    <= k), a per-row dict merge: for small matrices and tests.  Returns
    (indptr, cols) of the factor's pattern."""
    import heapq

    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    INF = 1 << 60
    urows = []  # per row: sorted [(col, lev)] of the strict upper factor
    fptr = np.zeros(n + 1, dtype=np.int64)
    fcols = []
    for i in range(n):
        lev = {int(c): 0 for c in indices[indptr[i] : indptr[i + 1]]}
        # ascending traversal over kept columns j < i, with insertions
        heap = [c for c in lev if c < i]
        heapq.heapify(heap)
        seen = set(heap)
        while heap:
            j = heapq.heappop(heap)
            levij = lev[j]
            if levij > k:
                continue
            for l, lvl_jl in urows[j]:
                nl = levij + lvl_jl + 1
                if nl < lev.get(l, INF):
                    lev[l] = nl
                    if nl <= k and l < i and l not in seen:
                        heapq.heappush(heap, l)
                        seen.add(l)
        kept = sorted(c for c, v in lev.items() if v <= k)
        fcols.extend(kept)
        fptr[i + 1] = len(fcols)
        urows.append([(c, lev[c]) for c in kept if c > i])
    return fptr, np.asarray(fcols, dtype=np.int64)


def iluk_factorize(A, k: int):
    """Level-of-fill ILU(k) factorization A ~= L D U: the symbolic pattern
    expansion (Saad, 10.3.3) in the host library, then the ILU(0) sweep on
    the expanded pattern with value-0 fill slots (ILU(k) is ILU(0) on the
    level-k pattern).  Returns the triple of :func:`ildu0_factorize`."""
    if A.shape[0] != A.shape[1]:
        raise ValueError("ILDU requires a square matrix")
    if k == 0:
        return ildu0_factorize(A)
    n = A.shape[0]
    indptr, indices, data = _csr_arrays(A)
    fptr, fcol = native.iluk_symbolic(indptr, indices, k)
    # A's values into the expanded pattern (fill slots stay 0): F's rows
    # are sorted supersets of A's
    fdata = np.zeros(fcol.size, dtype=np.float64)
    keys_f = np.repeat(np.arange(n), np.diff(fptr)) * n + fcol
    keys_a = np.repeat(np.arange(n), np.diff(indptr)) * n + indices
    fdata[np.searchsorted(keys_f, keys_a)] = data
    lu, diag = native.ilu0_factorize(fptr, fcol, fdata)
    return _split_ldu(fptr, fcol, lu, diag, n)


def _split_ldu(indptr, indices, lu, diag, n):
    """A factorized pattern split into strict unit L, D and strict unit U
    (u_ij / d_i) CSR triples."""
    rows_all = np.repeat(np.arange(n), np.diff(indptr))
    lower = indices < rows_all
    upper = indices > rows_all
    Lp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows_all[lower], minlength=n), out=Lp[1:])
    Up = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows_all[upper], minlength=n), out=Up[1:])
    Uvals = lu[upper] / diag[rows_all[upper]]
    return (Lp, indices[lower], lu[lower]), diag, (Up, indices[upper], Uvals)


def triangular_levels_reference(indptr, indices, n, reverse: bool) -> np.ndarray:
    """Plain numpy version of ``native.triangular_levels``: the dependency
    level of each row of a strict lower (rows i depend on j < i) or, with
    ``reverse``, upper triangular pattern (j > i, rows taken n-1..0)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    level = np.zeros(n, dtype=np.int64)
    for i in range(n - 1, -1, -1) if reverse else range(n):
        js = indices[indptr[i] : indptr[i + 1]]
        js = js[js > i] if reverse else js[js < i]
        if js.size:
            level[i] = level[js].max() + 1
    return level


def pack_levels_reference(indptr, indices, data, level, nlev: int, width: int):
    """Plain numpy version of ``native.pack_levels``: ``(rows, cols, vals,
    level_ptr)``, each level's rows in ascending order, a row's unused
    slots holding its own index and 0."""
    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.size - 1
    level_ptr = np.zeros(nlev + 1, dtype=np.int64)
    np.cumsum(np.bincount(level, minlength=nlev), out=level_ptr[1:])
    rows = np.empty(n, dtype=np.int64)
    cols = np.repeat(np.arange(n, dtype=np.int64)[:, None], width, axis=1)
    vals = np.zeros((n, width), dtype=np.float64)
    slot = level_ptr[:-1].copy()
    for i in range(n):
        s = slot[level[i]]
        slot[level[i]] += 1
        rows[s] = i
        d = indptr[i + 1] - indptr[i]
        cols[s] = i
        cols[s, :d] = indices[indptr[i] : indptr[i + 1]]
        vals[s, :d] = data[indptr[i] : indptr[i + 1]]
    return rows, cols, vals, level_ptr


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class TriangularLevels:
    """A strict unit triangular system packed by dependency level:
    ``rows[level_ptr[l] : level_ptr[l + 1]]`` are the rows solvable at
    level l and ``cols`` / ``vals`` (n, width) their strict entries, a
    row's unused slots pointing at the row itself with value 0."""

    rows: torch.Tensor  # (n,) int64, level by level
    cols: torch.Tensor  # (n, width) int64
    vals: torch.Tensor  # (n, width)
    level_ptr: Tuple[int, ...]  # (nlev + 1,) host ints
    n: int
    # solve_t's fixed-order sum plan of each level's scatter targets, built
    # once off the CPU (None on the CPU, which adds with index_add_)
    _plans: Optional[tuple] = dataclasses.field(init=False, repr=False)
    # level_ptr on the device, for the sweep kernel
    _ptr: torch.Tensor = dataclasses.field(init=False, repr=False)
    # the rows of the widest level, which size the sweep kernel's grid
    _max_rows: int = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        plans = None
        if ordered_sum.fixed_order(self.cols.device):
            plans = tuple(ordered_sum.sum_plan(self.cols[lo:hi].reshape(-1), self.cols.device)
                          for lo, hi in self._bounds())
        object.__setattr__(self, "_plans", plans)
        object.__setattr__(self, "_ptr", torch.tensor(self.level_ptr, dtype=torch.int64,
                                                      device=self.cols.device))
        object.__setattr__(self, "_max_rows", max((hi - lo for lo, hi in self._bounds()),
                                                  default=0))

    @classmethod
    def from_csr(cls, indptr, indices, data, n, reverse: bool, dtype, device=None):
        """Level the strict lower (``reverse=False``) or upper triangular
        CSR system in the host library and pack it on ``device`` (None:
        CUDA) with values in ``dtype``."""
        device = resolve_device(device)
        level = native.triangular_levels(indptr, indices, reverse=reverse)[0]
        nlev = int(level.max()) + 1 if n else 1
        deg = np.diff(np.asarray(indptr))
        width = max(int(deg.max()) if n else 0, 1)
        rows, cols, vals, level_ptr = native.pack_levels(indptr, indices, data, level, nlev,
                                                         width)
        return cls(
            rows=torch.from_numpy(rows).to(device),
            cols=torch.from_numpy(cols).to(device),
            vals=torch.from_numpy(vals).to(device=device, dtype=torch_dtype(dtype)),
            level_ptr=tuple(int(p) for p in level_ptr),
            n=int(n),
        )

    @property
    def nlev(self) -> int:
        return len(self.level_ptr) - 1

    def _bounds(self):
        return zip(self.level_ptr[:-1], self.level_ptr[1:])

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x solving (I + T) x = b: one launch of the level-sweep kernel on
        the card, one batched update a level on the CPU."""
        return level_sweep(self.rows, self.cols, self.vals, self._ptr, b, self._max_rows)

    def solve_t(self, b: torch.Tensor) -> torch.Tensor:
        """x solving (I + T)^T x = b on the same packed levels, walked in
        reverse with a scatter: a row at level l is final once every level
        above has scattered (an entry T_jr lives in a row j of a higher
        level), so no transpose pattern is built."""
        x = b.clone()
        bounds = list(self._bounds())
        for l in range(self.nlev - 1, -1, -1):
            lo, hi = bounds[l]
            xi = x[self.rows[lo:hi]]  # final at this level
            contrib = (-self.vals[lo:hi] * xi[:, None]).to(x.dtype)
            ordered_sum.scatter_add_(x, self.cols[lo:hi].reshape(-1), contrib.reshape(-1),
                                     None if self._plans is None else self._plans[l])
        return x


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class ILDUPreconditioner(LinearOperator):
    """Applies z = (L D U)^{-1} r: the forward sweep, D^{-1}, the backward
    sweep (the reference's ``ldu_solve``); on the card two launches of the
    level-sweep kernel and the scale."""

    lower: TriangularLevels
    dinv: torch.Tensor
    upper: TriangularLevels

    @property
    def shape(self):
        return (self.dinv.shape[0], self.dinv.shape[0])

    def matvec(self, r):
        return self.upper.solve(self.dinv * self.lower.solve(r))

    def rmatvec(self, r):
        """z = (L D U)^{-T} r = L^{-T} D^{-1} U^{-T} r through the reverse
        scatter sweeps, so an ILDU-preconditioned adjoint solve composes
        like any other operator."""
        return self.lower.solve_t(self.dinv * self.upper.solve_t(r))


def _lu_solve(lu_piv, b):
    lu, piv = lu_piv
    dt = torch.promote_types(lu.dtype, b.dtype)
    return torch.linalg.lu_solve(lu.to(dt), piv, b.to(dt)[:, None])[:, 0]


@dataclasses.dataclass(frozen=True)
class LDUSolver(LinearSolver):
    """The reference's ``ldu(incomplete, level)``: incomplete=True, level 0
    is ILDU(0) / IC(0); level > 0 level-of-fill ILU(k); incomplete=False a
    dense LU on A's device (the reference's unimplemented direct solve)."""

    incomplete: bool = True
    level: int = 0

    def setup(self, A) -> LinearOperator:
        if not self.incomplete:
            dense = torch.as_tensor(A.to_dense(), device=A.device)
            return MatvecOperator(params=torch.linalg.lu_factor(dense), mv=_lu_solve, rmv=None,
                                  shape=A.shape)
        if self.level < 0:
            raise ValueError(f"fill level must be >= 0, got {self.level}")
        (Lp, Li, Lx), d, (Up, Ui, Ux) = iluk_factorize(A, self.level)
        n = A.shape[0]
        dtype, dev = A.data.dtype, A.device
        return ILDUPreconditioner(
            lower=TriangularLevels.from_csr(Lp, Li, Lx, n, reverse=False, dtype=dtype, device=dev),
            dinv=torch.from_numpy(1.0 / d).to(device=dev, dtype=dtype),
            upper=TriangularLevels.from_csr(Up, Ui, Ux, n, reverse=True, dtype=dtype, device=dev),
        )

    def solve_info(self, A, b, x0=None, M=None):
        x = self.setup(A).matvec(b)
        rn = torch.linalg.vector_norm(b - A.matvec(x))
        return x, SolveInfo(1, rn, bool(torch.isfinite(rn)))


def ldu(incomplete: bool = True, level: int = 0) -> LDUSolver:
    return LDUSolver(incomplete=incomplete, level=level)


def incomplete_cholesky() -> LDUSolver:
    """IC(0): for SPD A the zero-fill LDU factorization."""
    return LDUSolver(incomplete=True, level=0)
