"""Explicit (materialised) sparse matrix algebra: sum, SpGEMM, PtAP, RARt.

Port of :mod:`sigma_tpu.matrix.algebra`.  Both halves of the JAX design
stay:

* **one-shot products** (:func:`sparse_add`, :func:`sparse_matmul`,
  :func:`ptap`, :func:`rart`) run in the port's host library
  (``native.csr_add``, ``native.spgemm``, ``native.csr_transpose``: a
  Gustavson SpGEMM and a sorted-row merge in O(nnz(C)) memory) on host CSR
  views of the operands; the result comes back from the host in float64
  and is cast to the first operand's dtype once, on its device;
* **plans** (:func:`plan_sparse_add`, :func:`plan_sparse_matmul`,
  :func:`plan_ptap`, :func:`plan_rart`): the symbolic phase on the host
  (the result's sparsity and a flat contribution map: for every scalar
  product, the source positions in the operands' value arrays and the
  target position in the result's), the numeric phase on the operands'
  device, ``C.data = sum over targets of A.data[pa] * B.data[pb]``,
  reusable for new values on the same sparsity.  Its index tensors are
  made on the operands' device once, at plan time.  The sum is
  ``index_add_`` on the CPU and, on any other device, the fixed-order sum
  of :mod:`sigma_tpu_torch.utils.ordered_sum` with a plan built once per
  plan, so a re-evaluation gives the same bits run after run.

The JAX package guards its plan gathers against int32 positions past
2^31 (``_pos_array``), which only JAX without 64-bit mode needs; the
port's positions are int64 tensors, so the guard folds away.

Every operand is normalised to a host CSR view with one lexsort (free for
CSR), so the reference's row/column capability dispatch is not needed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Type

import numpy as np
import torch

from sigma_tpu_torch import native
from sigma_tpu_torch.graph.graph import BSRGraph, CSRGraph, host_csr
from sigma_tpu_torch.matrix.base import SparseMatrix
from sigma_tpu_torch.matrix.formats import CSRMatrix
from sigma_tpu_torch.utils import ordered_sum
from sigma_tpu_torch.utils.dtypes import to_numpy

__all__ = [
    "PtAPPlan",
    "SpGEMMPlan",
    "SparseSumPlan",
    "plan_ptap",
    "plan_rart",
    "plan_sparse_add",
    "plan_sparse_matmul",
    "ptap",
    "rart",
    "sparse_add",
    "sparse_matmul",
]


# ---------------------------------------------------------------------------
# host-side helpers
# ---------------------------------------------------------------------------

def _coo_of(A: SparseMatrix) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows, cols, flat value positions) of A's stored entries."""
    rows, cols = A.graph.edges_numpy()
    if type(A.graph) is CSRGraph:
        # the CSR layout is row-major sorted COO: position p holds edge p
        return rows, cols, np.arange(rows.size, dtype=np.int64)
    return rows, cols, A.graph.edge_positions(rows, cols)


def _host_csr_view(A: SparseMatrix) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr, cols, vals in float64) row-sorted host CSR view of A: its
    own arrays for CSR, one lexsort of its entries otherwise."""
    if isinstance(A, CSRMatrix):
        g = A.graph
        return g.indptr, g.indices, to_numpy(A.data).astype(np.float64)
    rows, cols, vals = A.entries()
    return host_csr(rows, cols, A.shape[0], vals)


def _from_host_csr(cls: Type[SparseMatrix], n, m, cptr, ccol, cval,
                   A: SparseMatrix) -> SparseMatrix:
    """A host-algebra result (sorted, duplicate-free CSR arrays, float64
    values) as ``cls`` in A's dtype on A's device; CSR takes the arrays as
    they are."""
    if cls is CSRMatrix:
        return CSRMatrix.from_csr_arrays(n, m, cptr, ccol, cval, dtype=A.dtype, device=A.device)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(cptr))
    kw = A._format_kwargs() if cls is type(A) else {}
    return cls.from_coo(n, m, rows, ccol, cval, dtype=A.dtype, sum_duplicates=False,
                        device=A.device, **kw)


def _result_type(A: SparseMatrix, out_format) -> Type[SparseMatrix]:
    if out_format is None:
        return type(A)
    if isinstance(out_format, str):
        from sigma_tpu_torch.matrix.factory import choose_matrix_type

        return choose_matrix_type(out_format)
    return out_format


def _freeze(cls, n, m, rows, cols, A: SparseMatrix) -> SparseMatrix:
    """A zero matrix of ``cls`` with sparsity {(rows, cols)} in A's dtype
    on A's device."""
    kw = A._format_kwargs() if cls is type(A) else {}
    if cls._graph_class() is BSRGraph:
        kw["device"] = A.device
    g = cls._graph_class().from_coo(n, m, rows, cols, **kw)
    return cls.from_graph(g, dtype=A.dtype, device=A.device)


def _index(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


def _sum_plan(seg: torch.Tensor) -> Optional[ordered_sum.SumPlan]:
    """The fixed-order sum's plan of a contribution map's targets, off the
    CPU; None on the CPU, which sums with ``index_add_``."""
    if not ordered_sum.fixed_order(seg.device):
        return None
    return ordered_sum.sum_plan(seg, seg.device)


def _segment_sum(prod, seg, plan, template: SparseMatrix) -> torch.Tensor:
    """The contributions summed into the template's flat value array."""
    return ordered_sum.scatter_sum(prod, seg, template.data.numel(), plan)


def _result(template: SparseMatrix, flat) -> SparseMatrix:
    return template.with_data(flat.reshape(template.data.shape).to(template.dtype))


# ---------------------------------------------------------------------------
# numeric-phase plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class SparseSumPlan:
    """Reusable numeric phase of C = alpha A + beta B on fixed sparsity."""

    template: SparseMatrix  # zero-valued result matrix (holds the graph)
    a_pos: torch.Tensor  # positions into A.data flat
    a_seg: torch.Tensor  # target positions into C.data flat
    b_pos: torch.Tensor
    b_seg: torch.Tensor
    _plans: tuple = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "_plans", (_sum_plan(self.a_seg), _sum_plan(self.b_seg)))

    def __call__(self, A: SparseMatrix, B: SparseMatrix, alpha=1.0, beta=1.0) -> SparseMatrix:
        a = A.data.reshape(-1)[self.a_pos] * alpha
        b = B.data.reshape(-1)[self.b_pos] * beta
        flat = _segment_sum(a, self.a_seg, self._plans[0], self.template)
        flat = flat + _segment_sum(b, self.b_seg, self._plans[1], self.template)
        return _result(self.template, flat)


@dataclasses.dataclass(frozen=True, eq=False)
class SpGEMMPlan:
    """Reusable numeric phase of C = A @ B on fixed sparsity patterns:
    ``C.data[seg] += A.data[a_pos] * B.data[b_pos]`` over every scalar
    product."""

    template: SparseMatrix
    a_pos: torch.Tensor  # (n_contrib,) into A.data flat
    b_pos: torch.Tensor  # (n_contrib,) into B.data flat
    seg: torch.Tensor  # (n_contrib,) into C.data flat
    _plan: Optional[ordered_sum.SumPlan] = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "_plan", _sum_plan(self.seg))

    def __call__(self, A: SparseMatrix, B: SparseMatrix) -> SparseMatrix:
        prod = A.data.reshape(-1)[self.a_pos] * B.data.reshape(-1)[self.b_pos]
        return _result(self.template, _segment_sum(prod, self.seg, self._plan, self.template))


@dataclasses.dataclass(frozen=True, eq=False)
class PtAPPlan:
    """Reusable numeric phase of B = P^T A P (or R A R^T) on fixed
    sparsity: the three-index contraction B_ij = sum_kl P_ki A_kl P_lj
    flattened into one contribution map."""

    template: SparseMatrix
    left_pos: torch.Tensor  # into P.data (or R.data) flat: the left factor
    a_pos: torch.Tensor  # into A.data flat
    right_pos: torch.Tensor  # into P.data (or R.data) flat: the right factor
    seg: torch.Tensor  # into B.data flat
    _plan: Optional[ordered_sum.SumPlan] = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "_plan", _sum_plan(self.seg))

    def __call__(self, A: SparseMatrix, P: SparseMatrix) -> SparseMatrix:
        p = P.data.reshape(-1)
        prod = p[self.left_pos] * A.data.reshape(-1)[self.a_pos] * p[self.right_pos]
        return _result(self.template, _segment_sum(prod, self.seg, self._plan, self.template))


# ---------------------------------------------------------------------------
# symbolic phases and the one-shot products
# ---------------------------------------------------------------------------

def plan_sparse_add(A: SparseMatrix, B: SparseMatrix, out_format=None) -> SparseSumPlan:
    """Symbolic phase of A + B: the union sparsity and its contribution
    map."""
    if A.shape != B.shape:
        raise ValueError(f"shape mismatch {A.shape} vs {B.shape}")
    n, m = A.shape
    ar, ac, apos = _coo_of(A)
    br, bc, bpos = _coo_of(B)
    ukeys = np.unique(np.concatenate([ar * m + ac, br * m + bc]))
    template = _freeze(_result_type(A, out_format), n, m, ukeys // m, ukeys % m, A)
    dev = A.device
    return SparseSumPlan(
        template=template,
        a_pos=_index(apos, dev),
        a_seg=_index(template.graph.edge_positions(ar, ac), dev),
        b_pos=_index(bpos, dev),
        b_seg=_index(template.graph.edge_positions(br, bc), dev),
    )


def sparse_add(A: SparseMatrix, B: SparseMatrix, alpha=1.0, beta=1.0,
               out_format=None) -> SparseMatrix:
    """Materialised C = alpha A + beta B.  With Python (or numpy) scalars
    the sum runs once in the host library; with a tensor ``alpha`` or
    ``beta`` (the counterpart of the JAX package's traced scalars) it runs
    through :func:`plan_sparse_add` on the operands' device, with no read
    of the scalar."""
    if A.shape != B.shape:
        raise ValueError(f"shape mismatch {A.shape} vs {B.shape}")
    if isinstance(alpha, torch.Tensor) or isinstance(beta, torch.Tensor):
        return plan_sparse_add(A, B, out_format)(A, B, alpha, beta)
    res = native.csr_add(*_host_csr_view(A), *_host_csr_view(B), float(alpha), float(beta))
    return _from_host_csr(_result_type(A, out_format), *A.shape, *res, A)


def plan_sparse_matmul(A: SparseMatrix, B: SparseMatrix, out_format=None) -> SpGEMMPlan:
    """Symbolic phase of C = A @ B: for every entry (i, k) of A, expand
    over row k of B (``np.repeat`` over B's row degrees)."""
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"inner dim mismatch {A.shape} @ {B.shape}")
    n, k_dim, m = A.shape[0], A.shape[1], B.shape[1]
    ar, ac, apos = _coo_of(A)
    br, bc, bpos = _coo_of(B)
    bptr, bcols, bposs = host_csr(br, bc, k_dim, bpos)

    # each A entry (i, k) contributes deg_B(k) products
    counts = (bptr[ac + 1] - bptr[ac]).astype(np.int64)
    total = int(counts.sum())
    expand = np.repeat(bptr[ac] + counts - np.cumsum(counts), counts) + np.arange(
        total, dtype=np.int64
    )
    out_rows = np.repeat(ar, counts)
    out_cols = bcols[expand]

    ukeys = np.unique(out_rows * m + out_cols)
    template = _freeze(_result_type(A, out_format), n, m, ukeys // m, ukeys % m, A)
    dev = A.device
    return SpGEMMPlan(
        template=template,
        a_pos=_index(np.repeat(apos, counts), dev),
        b_pos=_index(bposs[expand], dev),
        seg=_index(template.graph.edge_positions(out_rows, out_cols), dev),
    )


def sparse_matmul(A: SparseMatrix, B: SparseMatrix, out_format=None) -> SparseMatrix:
    """Materialised C = A @ B, once, in the host library (Gustavson,
    O(nnz(C)) memory: the plan's contribution map costs ~10x the
    result's bytes); :func:`plan_sparse_matmul` re-evaluates it on the
    device."""
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"inner dim mismatch {A.shape} @ {B.shape}")
    res = native.spgemm(*_host_csr_view(A), *_host_csr_view(B), B.shape[1])
    return _from_host_csr(_result_type(A, out_format), A.shape[0], B.shape[1], *res, A)


def _check_triple(A, P, transpose_left):
    if transpose_left:
        if A.shape[0] != P.shape[0] or A.shape[1] != P.shape[0]:
            raise ValueError(f"PtAP shape mismatch A={A.shape}, P={P.shape}")
    elif A.shape[0] != P.shape[1] or A.shape[1] != P.shape[1]:
        raise ValueError(f"RARt shape mismatch A={A.shape}, R={P.shape}")


def plan_ptap(A: SparseMatrix, P: SparseMatrix, out_format=None) -> PtAPPlan:
    """Symbolic phase of B = P^T A P (the Galerkin triple product)."""
    _check_triple(A, P, True)
    return _plan_triple(A, P, transpose_left=True, out_format=out_format)


def ptap(A: SparseMatrix, P: SparseMatrix, out_format=None) -> SparseMatrix:
    """Materialised B = P^T A P: two host SpGEMMs, P^T (A P)."""
    return _native_triple(A, P, transpose_left=True, out_format=out_format)


def plan_rart(A: SparseMatrix, R: SparseMatrix, out_format=None) -> PtAPPlan:
    """Symbolic phase of B = R A R^T."""
    _check_triple(A, R, False)
    return _plan_triple(A, R, transpose_left=False, out_format=out_format)


def rart(A: SparseMatrix, R: SparseMatrix, out_format=None) -> SparseMatrix:
    """Materialised B = R A R^T: two host SpGEMMs, (R A) R^T."""
    return _native_triple(A, R, transpose_left=False, out_format=out_format)


def _native_triple(A: SparseMatrix, P: SparseMatrix, transpose_left: bool,
                   out_format) -> SparseMatrix:
    """Host Galerkin triple product: PtAP = (P^T)(A P), RARt = (R A)(R^T),
    two Gustavson SpGEMMs and one counting-sort transpose."""
    _check_triple(A, P, transpose_left)
    a = _host_csr_view(A)
    p = _host_csr_view(P)
    tp = native.csr_transpose(*p, P.shape[1])
    if transpose_left:
        # (n_c, n_c) = P^T @ (A @ P)
        res = native.spgemm(*tp, *native.spgemm(*a, *p, P.shape[1]), P.shape[1])
        n_out = P.shape[1]
    else:
        # (n_c, n_c) = (R @ A) @ R^T
        res = native.spgemm(*native.spgemm(*p, *a, A.shape[1]), *tp, P.shape[0])
        n_out = P.shape[0]
    return _from_host_csr(_result_type(A, out_format), n_out, n_out, *res, A)


def _plan_triple(A: SparseMatrix, P: SparseMatrix, transpose_left: bool,
                 out_format) -> PtAPPlan:
    """Shared symbolic core of PtAP and RARt.  PtAP: B_ij = sum over
    (k, l) in A of P_ki A_kl P_lj, a contraction over P's rows; RARt:
    B_ij = sum of R_ik A_kl R_jl, over R's columns.  Both normalise to
    'for inner index t, the list of (outer index, position)': host CSR of
    P over its rows, or of R over its columns."""
    ar, ac, apos = _coo_of(A)
    pr, pc, ppos = _coo_of(P)
    if transpose_left:
        inner, outer = pr, pc
        n_out, inner_dim = P.shape[1], P.shape[0]
    else:
        inner, outer = pc, pr
        n_out, inner_dim = P.shape[0], P.shape[1]
    ptr, outs, poss = host_csr(inner, outer, inner_dim, ppos)

    # first expansion: A's entries (k, l) times the list at k
    c1 = (ptr[ar + 1] - ptr[ar]).astype(np.int64)
    t1 = int(c1.sum())
    e1 = np.repeat(ptr[ar] + c1 - np.cumsum(c1), c1) + np.arange(t1, dtype=np.int64)
    rows1 = outs[e1]  # B's row i
    left1 = poss[e1]  # position of P_ki (or R_ik)
    a1 = np.repeat(apos, c1)
    l1 = np.repeat(ac, c1)  # A's column l, carried forward

    # second expansion: times the list at l
    c2 = (ptr[l1 + 1] - ptr[l1]).astype(np.int64)
    t2 = int(c2.sum())
    e2 = np.repeat(ptr[l1] + c2 - np.cumsum(c2), c2) + np.arange(t2, dtype=np.int64)
    out_rows = np.repeat(rows1, c2)
    out_cols = outs[e2]

    ukeys = np.unique(out_rows * n_out + out_cols)
    template = _freeze(_result_type(A, out_format), n_out, n_out, ukeys // n_out,
                       ukeys % n_out, A)
    dev = A.device
    return PtAPPlan(
        template=template,
        left_pos=_index(np.repeat(left1, c2), dev),
        a_pos=_index(np.repeat(a1, c2), dev),
        right_pos=_index(poss[e2], dev),
        seg=_index(template.graph.edge_positions(out_rows, out_cols), dev),
    )
