"""Smoothed-aggregation algebraic multigrid (AMG) preconditioner.

Port of :mod:`sigma_tpu.solvers.amg`:

* **set-up** (host): aggregation over the matrix graph (the port's host
  library) -> tentative piecewise-constant prolongator -> one damped
  Jacobi pass ``P = (I - omega D^{-1} A) P_tent``, materialised with
  :func:`~sigma_tpu_torch.matrix.algebra.sparse_matmul` and
  :func:`~sigma_tpu_torch.matrix.algebra.sparse_add` -> Galerkin coarse
  operator ``A_c = P^T A P`` (:func:`~sigma_tpu_torch.matrix.algebra.ptap`)
  -> recurse; the coarsest level is a dense inverse.  Each level's
  diagonal is read to the host once.
* **apply** (device): one V-cycle, damped Jacobi pre- and post-smoothing,
  restriction by ``P.rmatvec`` and prolongation by ``P.matvec``, the
  dense coarse inverse as one matmul.  Level 0 keeps the caller's operator
  (a DIA fine level smooths through the DIA SpMV kernel); every coarser
  level and every P is CSR, whose products are a gather and a sum, the
  sum in fixed order off the CPU, so a V-cycle gives the same bits run
  after run.

For stencils on structured grids prefer
:func:`~sigma_tpu_torch.solvers.gmg.structured_pair_amg`, whose set-up is
closed-form and whose transfers are reshapes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from sigma_tpu_torch import native
from sigma_tpu_torch.graph.permutations import _adjacency
from sigma_tpu_torch.matrix.algebra import ptap, sparse_add, sparse_matmul
from sigma_tpu_torch.matrix.base import SparseMatrix
from sigma_tpu_torch.matrix.formats import CSRMatrix
from sigma_tpu_torch.operators.linear_operator import LinearOperator
from sigma_tpu_torch.solvers.krylov import SolveInfo
from sigma_tpu_torch.utils.dtypes import to_numpy
from sigma_tpu_torch.utils.sharded import dense_apply

__all__ = [
    "AMGPreconditioner",
    "amg_solve",
    "greedy_aggregate",
    "greedy_aggregate_reference",
    "smoothed_aggregation_amg",
    "vmb_aggregate",
    "vmb_aggregate_reference",
]


def vmb_aggregate(A: SparseMatrix) -> np.ndarray:
    """VMB (Vanek-Mandel-Brezina) three-phase aggregation of A's graph:
    phase 1 seeds an aggregate only where the whole neighbourhood is
    unaggregated (compact ~3^d aggregates on stencils), phase 2 attaches
    leftovers to adjacent aggregates, phase 3 seeds the rest.  Returns
    (n,) aggregate ids; runs in the host library."""
    return native.vmb_aggregate(*_adjacency(A.graph))[0]


def vmb_aggregate_reference(indptr, indices) -> np.ndarray:
    """Plain numpy version of :func:`vmb_aggregate` on a CSR adjacency (a
    Python loop over the vertices: for small graphs and tests)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    cols = np.asarray(indices, dtype=np.int64)
    n = indptr.size - 1
    agg = -np.ones(n, dtype=np.int64)
    next_agg = 0
    for v in range(n):  # phase 1
        if agg[v] >= 0:
            continue
        nb = cols[indptr[v] : indptr[v + 1]]
        if np.any(agg[nb[nb != v]] >= 0):
            continue
        agg[v] = next_agg
        agg[nb] = next_agg
        next_agg += 1
    for v in range(n):  # phase 2
        if agg[v] >= 0:
            continue
        nb = agg[cols[indptr[v] : indptr[v + 1]]]
        hit = nb[nb >= 0]
        if hit.size:
            agg[v] = hit[0]
    for v in range(n):  # phase 3
        if agg[v] >= 0:
            continue
        agg[v] = next_agg
        nb = cols[indptr[v] : indptr[v + 1]]
        agg[nb[agg[nb] < 0]] = next_agg
        next_agg += 1
    return agg


def greedy_aggregate(A: SparseMatrix) -> np.ndarray:
    """Greedy aggregation of A's graph: each unaggregated vertex in order
    seeds an aggregate with its unaggregated neighbours.  Returns (n,)
    aggregate ids; runs in the host library."""
    return native.greedy_aggregate(*_adjacency(A.graph))[0]


def greedy_aggregate_reference(indptr, indices) -> np.ndarray:
    """Plain numpy version of :func:`greedy_aggregate` on a CSR adjacency
    (a Python loop over the vertices: for small graphs and tests)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    cols = np.asarray(indices, dtype=np.int64)
    n = indptr.size - 1
    agg = -np.ones(n, dtype=np.int64)
    next_agg = 0
    for v in range(n):
        if agg[v] >= 0:
            continue
        agg[v] = next_agg
        for u in cols[indptr[v] : indptr[v + 1]]:
            if agg[u] < 0:
                agg[u] = next_agg
        next_agg += 1
    return agg


def _tentative_prolongator(agg: np.ndarray, dtype, device) -> CSRMatrix:
    """Piecewise-constant P of the aggregates, columns scaled to unit norm
    (P^T P = I)."""
    n = agg.size
    nc = int(agg.max()) + 1
    counts = np.bincount(agg, minlength=nc).astype(np.float64)
    vals = 1.0 / np.sqrt(counts[agg])
    return CSRMatrix.from_coo(n, nc, np.arange(n), agg, vals, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class _Level:
    A: SparseMatrix
    P: SparseMatrix  # prolongator to this level from the next coarser one
    dinv: torch.Tensor  # 1 / diag(A), 0 where the diagonal is 0
    omega: float


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class AMGPreconditioner(LinearOperator):
    """Applies z = (one V-cycle of AMG) r.  Use as ``M=`` in any Krylov
    solver or in :func:`amg_solve`, the stationary iteration."""

    levels: Tuple[_Level, ...]
    # dense inverse of the coarsest operator, computed in f64 at set-up and
    # held in A's dtype: the coarse solve is one matmul
    coarse_inv: torch.Tensor
    n_smooth: int = 1

    @property
    def shape(self):
        if self.levels:
            n = self.levels[0].A.shape[0]
        else:  # the hierarchy collapsed to the dense coarse solve
            n = self.coarse_inv.shape[0]
        return (n, n)

    def _smooth(self, lvl: _Level, x, r, from_zero=False):
        """n_smooth damped Jacobi sweeps; ``from_zero=True`` states x == 0,
        so the first sweep skips its A @ 0 matvec (the same values)."""
        for k in range(self.n_smooth):
            if k == 0 and from_zero:
                x = lvl.omega * lvl.dinv * r
            else:
                x = x + lvl.omega * lvl.dinv * (r - lvl.A.matvec(x))
        return x

    def matvec(self, r):
        return self._cycle(0, r)

    rmatvec = matvec  # symmetric cycle

    def _cycle(self, i: int, r):
        if i == len(self.levels):
            return dense_apply(self.coarse_inv, r)
        lvl = self.levels[i]
        x = self._smooth(lvl, torch.zeros_like(r), r, from_zero=True)  # pre-smooth
        rc = lvl.P.rmatvec(r - lvl.A.matvec(x))  # restrict
        x = x + lvl.P.matvec(self._cycle(i + 1, rc))  # prolongate and correct
        return self._smooth(lvl, x, r)  # post-smooth


def _scale_rows_data(A: SparseMatrix, scale: np.ndarray) -> torch.Tensor:
    """Value array of diag(scale) @ A in A's own layout.  CSR scales in
    place in A's dtype (its layout has no pad slots); any other format
    scales its entries in float64 on the host and rounds them once to A's
    dtype, as the JAX package does."""
    if isinstance(A, CSRMatrix):
        s = torch.from_numpy(np.asarray(scale)).to(device=A.device, dtype=A.dtype)
        return A.data * s[A.rows_dev]
    rows, cols, vals = A.entries()
    flat = np.zeros(A.data.numel(), dtype=vals.dtype)
    flat[A.graph.edge_positions(rows, cols)] = vals * scale[rows]
    return torch.from_numpy(flat.reshape(tuple(A.data.shape))).to(A.device)


def _smoothed_prolongator(A: SparseMatrix, P: CSRMatrix, dvec: np.ndarray,
                          omega: float) -> CSRMatrix:
    """P <- (I - omega D^{-1} A) P, materialised sparsely in the host
    library."""
    d = np.where(dvec != 0, dvec, 1.0)
    AP = sparse_matmul(A.with_data(_scale_rows_data(A, 1.0 / d)), P, out_format=CSRMatrix)
    return sparse_add(P, AP, alpha=1.0, beta=-omega)


def _coarse_inverse(A: SparseMatrix, dtype) -> torch.Tensor:
    """Dense inverse of the coarsest operator, computed in f64 with a tiny
    ridge (aggregation can leave a singular coarsest Laplacian), in
    ``dtype`` on A's device."""
    coarse = np.asarray(A.to_dense(), dtype=np.float64)
    coarse = coarse + 1e-12 * np.eye(coarse.shape[0])
    return torch.from_numpy(np.linalg.inv(coarse)).to(device=A.device, dtype=dtype)


def smoothed_aggregation_amg(
    A: SparseMatrix,
    max_levels: int = 10,
    coarse_size: int = 64,
    omega: float = 2.0 / 3.0,
    smooth_prolongator: bool = True,
    n_smooth: int = 1,
    aggregate=None,
) -> AMGPreconditioner:
    """Build a smoothed-aggregation AMG hierarchy for SPD A.

    ``aggregate`` is the coarsening callback (matrix -> aggregate ids).
    The default :func:`greedy_aggregate` gives pair-like aggregates and
    gentle 2x coarsening, the best V-cycle; :func:`vmb_aggregate` gives
    ~3^d aggregates, a cheaper hierarchy and more iterations, and is the
    one to take on large 3-D problems, where pair aggregates and
    prolongator smoothing grow the first Galerkin operator's nnz ~4.7x.

    Coarse levels are CSR whatever A's format: Galerkin sparsity is
    scattered, and a DIA coarse operator would store one padded diagonal
    per distinct offset."""
    aggregate = greedy_aggregate if aggregate is None else aggregate
    levels = []
    Acur = A
    while Acur.shape[0] > coarse_size and len(levels) < max_levels - 1:
        agg = aggregate(Acur)
        P = _tentative_prolongator(agg, Acur.dtype, Acur.device)
        if P.shape[1] >= Acur.shape[0]:  # aggregation stalled
            break
        dvec = Acur.diagonal()
        dvec_np = to_numpy(dvec)  # the level's one read of its diagonal
        if smooth_prolongator:
            P = _smoothed_prolongator(Acur, P, dvec_np, omega)
        Ac = ptap(Acur, P, out_format=type(Acur) if isinstance(Acur, CSRMatrix) else CSRMatrix)
        nz = dvec != 0
        dinv = torch.where(nz, 1.0, 0.0).to(dvec.dtype) / torch.where(nz, dvec, 1.0)
        levels.append(_Level(A=Acur, P=P, dinv=dinv, omega=float(omega)))
        Acur = Ac
    return AMGPreconditioner(levels=tuple(levels), coarse_inv=_coarse_inverse(Acur, A.dtype),
                             n_smooth=n_smooth)


def amg_solve(A, b, M: AMGPreconditioner = None, *, tol=1e-10, maxiter=100):
    """Standalone AMG solver: the stationary V-cycle iteration
    ``x += M(b - A x)`` while ``||b - A x|| > tol`` and fewer than
    ``maxiter`` iterations were taken (the norm read once an iteration).
    Builds the hierarchy when ``M`` is not given."""
    if M is None:
        M = smoothed_aggregation_amg(A)
    tol = torch.as_tensor(tol, dtype=b.dtype, device=b.device)
    x = torch.zeros_like(b)
    r = b
    resn = torch.linalg.vector_norm(r)
    k = 0
    while k < int(maxiter) and bool(resn > tol):
        x = x + M.matvec(r)
        r = b - A.matvec(x)
        resn = torch.linalg.vector_norm(r)
        k += 1
    return x, SolveInfo(k, resn, bool(resn <= tol))
