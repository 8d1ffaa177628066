"""RCM reordering of COO triples: the set-up step of the pruned path.

Port of ``reorder_triples_rcm``, ``_keep_better_order`` and
``_n_distinct`` of :mod:`sigma_tpu.matrix.banded`.  ``to_banded_dia`` and
``to_pruned_dia`` wait for the general formats (they read a CSR matrix's
``entries()``).
"""

from __future__ import annotations

import numpy as np

from sigma_tpu_torch import native

__all__ = ["reorder_triples_rcm"]


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


def reorder_triples_rcm(n, rows, cols, vals, method: str = "rcm"):
    """RCM reordering of duplicate-free COO triples on the host:
    ``(pr, pc, vals, p)`` with ``p`` in scatter form (``A[i, j]`` lands at
    ``(p[i], p[j])``), the identity when the input order has the better
    (distinct-diagonal count, reach).  The adjacency is a counting sort by
    row and RCM runs on it, both in the port's host library.  The triples
    are not re-sorted: the pruned pack sorts them itself.

    ``method`` is ``"rcm"``; the JAX package's ``"bfs"`` waits for the
    port of the graph orderings."""
    if method != "rcm":
        raise ValueError(f"unknown reorder method {method!r}; the port has 'rcm'")
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
    p = native.rcm_order(indptr, adj_cols)
    return _keep_better_order(rows, cols, vals, p)
