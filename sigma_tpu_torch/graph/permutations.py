"""Vertex orderings and colourings (host, set-up time).

Port of :mod:`sigma_tpu.graph.permutations`: ``breadth_first_search``,
``reverse_cuthill_mckee``, ``greedy_coloring`` and
``greedy_color_ordering``, each on any square graph of
:mod:`sigma_tpu_torch.graph.graph`, as the reference does.  Every
permutation is in scatter form: ``p[i]`` is the new label of old vertex
``i``.  The orderings and the colouring run in the port's host library on
CSR adjacency arrays (``native.bfs_order`` and :func:`_rcm_arrays`, which
the banded conversion calls directly, and ``native.greedy_coloring``);
:func:`breadth_first_search_reference`,
:func:`reverse_cuthill_mckee_reference` and
:func:`greedy_coloring_reference` are their plain numpy versions on the
same arrays, which the tests hold them to.

A colour ordering is the reference's remedy for the strictly sequential
triangular sweeps of incomplete factorization: after it, a sweep's
dependency levels are at most the colours (:mod:`sigma_tpu_torch.solvers.ildu`).
"""

from __future__ import annotations

from collections import deque
from typing import Tuple

import numpy as np

from sigma_tpu_torch import native
from sigma_tpu_torch.graph.graph import CSRGraph, Graph

__all__ = [
    "breadth_first_search",
    "breadth_first_search_reference",
    "greedy_color_ordering",
    "greedy_coloring",
    "greedy_coloring_reference",
    "reverse_cuthill_mckee",
    "reverse_cuthill_mckee_reference",
]


def _adjacency(g: Graph) -> Tuple[np.ndarray, np.ndarray]:
    """CSR ``(indptr, indices)`` of a square graph, as numpy: a CSR graph's
    own arrays, any other format's edges sorted by (row, column)."""
    n, m = g.shape
    if n != m:
        raise ValueError("reordering requires a square graph")
    if isinstance(g, CSRGraph):
        return g.indptr, g.indices[: g.nnz]
    rows, cols = (np.asarray(a, dtype=np.int64).ravel() for a in g.edges_numpy())
    order = np.lexsort((cols, rows))
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr, cols[order]


def breadth_first_search(g: Graph, start: int = 0) -> np.ndarray:
    """Breadth-first level ordering of the square graph ``g`` (any
    format): ``p[i]`` is the visit rank of vertex ``i``, visiting from
    ``start`` and restarting at the lowest unvisited vertex of each further
    component, neighbours in adjacency order (columns ascending)."""
    return native.bfs_order(*_adjacency(g), start)


def breadth_first_search_reference(indptr, indices, start: int = 0) -> np.ndarray:
    """Plain numpy version of :func:`breadth_first_search` (a Python loop
    over the vertices: for small graphs and tests)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    n = indptr.size - 1
    p = np.full(n, -1, dtype=np.int64)
    rank = 0
    # the first component from start, then the lowest unvisited vertex; a
    # FIFO queue labels in push order, which is the pop order the C++
    # labels in
    starts = [int(start), *range(n)] if n else []
    for s in starts:
        if p[s] >= 0:
            continue
        p[s] = rank
        rank += 1
        q: deque[int] = deque([s])
        while q:
            u = q.popleft()
            for v in indices[indptr[u] : indptr[u + 1]]:
                if p[v] < 0:
                    p[v] = rank
                    rank += 1
                    q.append(int(v))
    return p


def _rcm_arrays(indptr, indices) -> np.ndarray:
    """:func:`reverse_cuthill_mckee` on CSR adjacency arrays."""
    return native.rcm_order(indptr, indices)


def reverse_cuthill_mckee(g: Graph) -> np.ndarray:
    """Reverse Cuthill-McKee permutation of the square graph ``g`` (any
    format): BFS from a minimum-degree vertex per component, neighbours in
    ascending-degree order (ties by vertex id), ranks reversed."""
    return _rcm_arrays(*_adjacency(g))


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


def _symmetric_adjacency(g: Graph) -> Tuple[np.ndarray, np.ndarray]:
    """``(indptr, indices)`` of a square graph's stored pattern and its
    transpose together (an edge in either direction is a neighbour),
    grouped by row with a counting sort: within a row the neighbours stay
    in edge order, repeats included, which first-fit colouring does not
    depend on."""
    n, m = g.shape
    if n != m:
        raise ValueError("coloring requires a square graph")
    r, c = g.edges_numpy()
    indices, indptr = native.adjacency_from_coo(n, np.concatenate([r, c]), np.concatenate([c, r]))
    return indptr, indices


def greedy_coloring(g: Graph) -> Tuple[np.ndarray, int]:
    """Greedy first-fit vertex colouring of the square graph ``g`` (any
    format), in vertex order: ``(colors, num_colors)`` with colours in
    ``0 .. num_colors - 1`` such that no stored edge (i, j), i != j, joins
    two vertices of one colour.  The pattern is symmetrized first, so this
    holds in both directions for a nonsymmetric pattern too (a triangular
    factor, the multicolour-ILDU case)."""
    return native.greedy_coloring(*_symmetric_adjacency(g))


def greedy_coloring_reference(indptr, indices) -> Tuple[np.ndarray, int]:
    """Plain numpy version of :func:`greedy_coloring` on a (symmetrized)
    CSR adjacency (a Python loop over the vertices: for small graphs and
    tests)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    n = indptr.size - 1
    colors = np.full(n, -1, dtype=np.int64)
    for u in range(n):
        nbr_colors = set(colors[indices[indptr[u] : indptr[u + 1]]].tolist())
        c = 0
        while c in nbr_colors:
            c += 1
        colors[u] = c
    return colors, int(colors.max()) + 1 if n else 0


def greedy_color_ordering(g: Graph) -> Tuple[np.ndarray, np.ndarray]:
    """Colour-block permutation of :func:`greedy_coloring`: ``(p, ptr)``,
    ``p`` relabelling the vertices so that colour c holds the contiguous
    new labels ``ptr[c] .. ptr[c + 1] - 1`` (old order kept within a
    colour).  No two vertices of one colour are joined by an edge."""
    colors, nc = greedy_coloring(g)
    ptr = np.zeros(nc + 1, dtype=np.int64)
    np.cumsum(np.bincount(colors, minlength=nc), out=ptr[1:])
    order = np.argsort(colors, kind="stable")  # new -> old
    p = np.empty(g.shape[0], dtype=np.int64)
    p[order] = np.arange(g.shape[0])
    return p, ptr
