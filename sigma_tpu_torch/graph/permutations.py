"""Bandwidth-reducing vertex orderings (host, set-up time).

Port of ``reverse_cuthill_mckee`` of :mod:`sigma_tpu.graph.permutations`
on CSR adjacency arrays.  Every permutation is in scatter form: ``p[i]`` is
the new label of old vertex ``i``.  :func:`reverse_cuthill_mckee` runs in
the port's host library; :func:`reverse_cuthill_mckee_reference` is its
plain numpy version, which the tests hold it to.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from sigma_tpu_torch import native

__all__ = ["reverse_cuthill_mckee", "reverse_cuthill_mckee_reference"]


def reverse_cuthill_mckee(indptr, indices) -> np.ndarray:
    """Reverse Cuthill-McKee permutation of the square graph with CSR
    adjacency ``(indptr, indices)``: BFS from a minimum-degree vertex per
    component, neighbours in ascending-degree order (ties by vertex id),
    ranks reversed."""
    return native.rcm_order(indptr, indices)


def reverse_cuthill_mckee_reference(indptr, indices) -> np.ndarray:
    """Plain numpy version of :func:`reverse_cuthill_mckee` (a Python loop
    over the vertices: for small graphs and tests)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    n = indptr.size - 1
    deg = indptr[1:] - indptr[:-1]
    p = np.full(n, -1, dtype=np.int64)
    rank = 0
    # components in order of their minimum-degree vertex
    for s in np.lexsort((np.arange(n), deg)):
        if p[s] >= 0:
            continue
        q: deque[int] = deque([int(s)])
        p[s] = rank
        rank += 1
        while q:
            u = q.popleft()
            nbrs = indices[indptr[u] : indptr[u + 1]]
            nbrs = nbrs[p[nbrs] < 0]
            # ascending degree, ties by vertex id; a FIFO queue labels in
            # push order, which is the pop order the C++ labels in
            for v in nbrs[np.lexsort((nbrs, deg[nbrs]))]:
                if p[v] < 0:
                    p[v] = rank
                    rank += 1
                    q.append(int(v))
    return (n - 1) - p
