"""Banded-DIA conversion: the general-sparsity recipe.

Port of :mod:`sigma_tpu.matrix.banded`: a general sparse matrix is
bandwidth-reduced by reverse Cuthill-McKee and re-frozen with every
diagonal of its band in a :class:`~sigma_tpu_torch.matrix.formats.DIAMatrix`
(:func:`to_banded_dia`), or with only its active (row tile x diagonal)
blocks in a pruned matrix (:func:`to_pruned_dia`);
:func:`reorder_triples_rcm` is the same reordering on raw COO triples.
The ordering (``method``: ``"rcm"``, the default, or ``"bfs"``, the plain
breadth-first level order) runs in the port's host library.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sigma_tpu_torch import native
from sigma_tpu_torch.graph.graph import CSRGraph, DIAGraph
from sigma_tpu_torch.graph.permutations import _rcm_arrays
from sigma_tpu_torch.matrix.formats import DIAMatrix

__all__ = [
    "band_occupancy",
    "bandwidth",
    "reorder_triples_rcm",
    "to_banded_dia",
    "to_pruned_dia",
]


_ORDERINGS = {"rcm": _rcm_arrays, "bfs": native.bfs_order}  # on CSR adjacency arrays


def _ordering(method: str):
    if method not in _ORDERINGS:
        raise ValueError(f"unknown reorder method {method!r}; want one of {sorted(_ORDERINGS)}")
    return _ORDERINGS[method]


def _dia_diagonals(g: DIAGraph):
    """The offsets of a DIA graph that hold at least one in-range slot."""
    n, m = g.shape
    return [o for o in g.offsets if max(0, -o) < min(n, m - o)]


def bandwidth(A) -> int:
    """max |i - j| over stored entries (of a matrix or a graph).  A DIA
    matrix answers from its offsets rather than enumerating its slots."""
    g = A.graph if hasattr(A, "graph") else A
    if isinstance(g, DIAGraph):
        return max((abs(o) for o in _dia_diagonals(g)), default=0)
    rows, cols = g.edges_numpy()
    return int(np.abs(rows - cols).max()) if rows.size else 0


def band_occupancy(A) -> float:
    """True (nonzero) entries / (n * number of distinct diagonals): the DIA
    fill ratio this matrix has or would have.  A DIA matrix counts its
    nonzero values on its device (out-of-range slots hold 0) rather than
    enumerating its slots; the result is the JAX package's."""
    if isinstance(A, DIAMatrix):
        true_nnz = int(torch.count_nonzero(A.data))
        n_diag = len(_dia_diagonals(A.graph))
    else:
        rows, cols, vals = A.entries()
        n_diag = _n_distinct(cols - rows)
        true_nnz = int(np.count_nonzero(vals))
    return true_nnz / (A.shape[0] * max(n_diag, 1))


def _n_distinct(d: np.ndarray) -> int:
    """Distinct count of integer offsets: a bincount over the value range
    when it is small (an RCM band: a few hundred values), ``np.unique``
    only for wide ranges (the shuffled input order)."""
    if d.size == 0:
        return 0
    lo, hi = int(d.min()), int(d.max())
    if hi - lo < 1 << 22:
        return int(np.count_nonzero(np.bincount(d - lo, minlength=hi - lo + 1)))
    return int(np.unique(d).size)


def _keep_better_order(rows, cols, vals, p):
    """Keep the better of the input and the reordered order, judged
    lexicographically on (distinct-diagonal count, band reach), ties to
    the reordering; returns ``(rows, cols, vals, p)`` with ``p`` the
    identity when the input order wins."""
    d_new = (p[cols] - p[rows]).astype(np.int32)
    d_in = (cols - rows).astype(np.int32)
    key_new = (_n_distinct(d_new), int(np.abs(d_new).max(initial=0)))
    key_in = (_n_distinct(d_in), int(np.abs(d_in).max(initial=0)))
    if key_new <= key_in:
        return p[rows], p[cols], vals, p
    return rows, cols, vals, np.arange(p.size, dtype=p.dtype)


def _reordered_triples(A, reorder: bool, method: str):
    """The shared reorder and keep-better-order rule of the banded and
    pruned conversions: ``(rows, cols, vals, p)`` of A's entries, with
    ``p`` in scatter form (the identity when the input order is kept,
    None when ``reorder=False``).  The ordering runs on the CSR adjacency
    of A's graph (a CSR matrix's own arrays, columns ascending)."""
    if A.shape[0] != A.shape[1]:
        raise ValueError("banded conversion expects a square matrix")
    order = _ordering(method) if reorder else None
    rows, cols, vals = A.entries()
    p = None
    if reorder:
        if isinstance(A.graph, CSRGraph):
            indptr, indices = A.graph.indptr, A.graph.indices
        else:
            g = CSRGraph.from_coo(A.shape[0], A.shape[1], rows, cols)
            indptr, indices = g.indptr, g.indices
        p = order(indptr, indices)
        rows, cols, vals, p = _keep_better_order(rows, cols, vals, p)
    return rows, cols, vals, p


def reorder_triples_rcm(n, rows, cols, vals, method: str = "rcm"):
    """RCM (or, with ``method="bfs"``, breadth-first) reordering of
    duplicate-free COO triples on the host: ``(pr, pc, vals, p)`` with
    ``p`` in scatter form (``A[i, j]`` lands at ``(p[i], p[j])``), the
    identity when the input order has the better (distinct-diagonal count,
    reach).  The adjacency is a counting sort by row (neighbours in input
    order) and the ordering runs on it, both in the port's host library.
    The triples are not re-sorted: the pruned pack sorts them itself."""
    order = _ordering(method)
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals = np.asarray(vals).ravel()
    n = int(n)
    # bounds check before the C++ counting sort, which scatters through
    # indptr[rows[e] + 1] unguarded
    if rows.size:
        lo = min(int(rows.min()), int(cols.min()))
        hi = max(int(rows.max()), int(cols.max()))
        if lo < 0 or hi >= n:
            raise ValueError(f"COO index out of range for n={n}: min {lo}, max {hi}")
    adj_cols, indptr = native.adjacency_from_coo(n, rows, cols)
    p = order(indptr, adj_cols)
    return _keep_better_order(rows, cols, vals, p)


def to_banded_dia(A, reorder: bool = True, method: str = "rcm") -> Tuple[DIAMatrix, Optional[np.ndarray]]:
    """Convert a square sparse matrix to DIA with every diagonal of its
    band stored, after a bandwidth-reducing reordering of rows and columns
    (``method``: ``"rcm"`` reverse Cuthill-McKee, the default, or ``"bfs"``
    the plain breadth-first level order) unless ``reorder=False``.  Returns ``(D, p)`` with ``p`` in scatter form
    (None without reordering): ``D[p[i], p[j]] == A[i, j]``.  To solve
    A x = b in the permuted frame: ``b_p[p] = b``, solve ``D x_p = b_p``,
    then ``x = x_p[p]``.  The better of the input and the reordered order
    is kept (see :func:`_keep_better_order`).  D is assembled on A's
    device (:meth:`DIAMatrix.from_coo`), in A's dtype."""
    rows, cols, vals, p = _reordered_triples(A, reorder, method)
    D = DIAMatrix.from_coo(A.shape[0], A.shape[1], rows, cols, vals, dtype=A.dtype,
                           device=A.device)
    return D, p


def to_pruned_dia(A, reorder: bool = True, method: str = "rcm", tile_rows: int = 16384,
                  group: int | None = None, symmetric: bool = False, validate: bool = True,
                  rtol: float = 1e-12):
    """Reorder A (RCM, or BFS with ``method="bfs"``) and pack it straight into the pruned block-DIA layout
    (``symmetric=True``: the upper triangle, in symmetric storage): the
    full band is never built.  Same ``(P, p)`` contract and order rule as
    :func:`to_banded_dia`; P lives on A's device."""
    from sigma_tpu_torch.matrix.pruned import PrunedDIAMatrix, SymmetricPrunedDIAMatrix

    rows, cols, vals, p = _reordered_triples(A, reorder, method)
    kw = dict(dtype=A.dtype, tile_rows=tile_rows, group=group, assume_unique=True,
              device=A.device)
    if symmetric:
        return SymmetricPrunedDIAMatrix.from_coo(A.shape[0], A.shape[1], rows, cols, vals,
                                                 validate=validate, rtol=rtol, **kw), p
    return PrunedDIAMatrix.from_coo(A.shape[0], A.shape[1], rows, cols, vals, **kw), p
