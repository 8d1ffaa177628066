"""Host-side mutable graph builder.

Port of :mod:`sigma_tpu.graph.builder`.  Sparsity is assembled on the host
with cheap amortised mutation and then frozen into one of the immutable
formats of :mod:`sigma_tpu_torch.graph.graph`.  ``GraphBuilder`` is that
mutable stage.  It is numpy-backed: bulk edge insertion is vectorised
(append a chunk, lazily sort and deduplicate), and single-edge mutation
goes through small python-set overlays, so interactive use stays O(1)
amortised.

Graphs are bipartite: ``n`` left vertices (rows), ``m`` right vertices
(columns); an edge (i, j) is a potential nonzero at (row i, col j).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np

__all__ = ["GraphBuilder"]


class GraphBuilder:
    """Mutable bipartite graph under construction.

    Parameters
    ----------
    n, m:
        Number of left (row) and right (column) vertices.  ``m`` defaults
        to ``n`` (square).
    """

    def __init__(self, n: int, m: Optional[int] = None):
        if m is None:
            m = n
        if n < 0 or m < 0:
            raise ValueError(f"invalid graph dimensions ({n}, {m})")
        self.n = int(n)
        self.m = int(m)
        # Consolidated, sorted (row-major), duplicate-free edge arrays.
        self._rows = np.empty(0, dtype=np.int64)
        self._cols = np.empty(0, dtype=np.int64)
        # Pending bulk chunks (may contain duplicates) + single-edge overlays.
        self._chunks: list[np.ndarray] = []  # each (2, k) int64
        self._added: set[tuple[int, int]] = set()
        self._deleted: set[tuple[int, int]] = set()

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    @classmethod
    def from_coo(cls, n: int, m: Optional[int], rows, cols) -> "GraphBuilder":
        """Bulk-build from coordinate arrays (duplicates tolerated)."""
        g = cls(n, m)
        g.add_edges(rows, cols)
        return g

    @classmethod
    def from_dense(cls, dense) -> "GraphBuilder":
        """Build from a dense 0/1 (or truthy) connectivity matrix."""
        dense = np.asarray(dense)
        rows, cols = np.nonzero(dense)
        return cls.from_coo(dense.shape[0], dense.shape[1], rows, cols)

    @classmethod
    def from_graph(cls, graph) -> "GraphBuilder":
        """Thaw a frozen graph (any format) back into a builder."""
        rows, cols = graph.edges_numpy()
        return cls.from_coo(graph.shape[0], graph.shape[1], rows, cols)

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------
    def add_edge(self, i: int, j: int) -> None:
        self._check(i, j)
        ij = (int(i), int(j))
        self._deleted.discard(ij)
        self._added.add(ij)

    def add_edges(self, rows, cols) -> None:
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        if rows.shape != cols.shape:
            raise ValueError("rows/cols length mismatch")
        if rows.size == 0:
            return
        if rows.min() < 0 or rows.max() >= self.n:
            raise IndexError("row index out of range")
        if cols.min() < 0 or cols.max() >= self.m:
            raise IndexError("column index out of range")
        if self._deleted:
            # edges re-added in bulk must not stay deleted
            self._deleted -= set(zip(rows.tolist(), cols.tolist()))
        self._chunks.append(np.stack([rows, cols]))

    def delete_edge(self, i: int, j: int) -> None:
        self._check(i, j)
        ij = (int(i), int(j))
        self._added.discard(ij)
        self._deleted.add(ij)

    # ------------------------------------------------------------------
    # queries (consolidate lazily)
    # ------------------------------------------------------------------
    def _check(self, i: int, j: int) -> None:
        if not (0 <= i < self.n and 0 <= j < self.m):
            raise IndexError(f"edge ({i}, {j}) out of range for ({self.n}, {self.m})")

    def _consolidate(self) -> None:
        if not (self._chunks or self._added or self._deleted):
            return
        parts = [np.stack([self._rows, self._cols])] + self._chunks
        if self._added:
            arr = np.array(sorted(self._added), dtype=np.int64).reshape(-1, 2).T
            parts.append(arr)
        allrc = np.concatenate(parts, axis=1)
        keys = allrc[0] * self.m + allrc[1]
        keys = np.unique(keys)
        if self._deleted:
            dkeys = np.fromiter(
                (i * self.m + j for (i, j) in self._deleted),
                dtype=np.int64,
                count=len(self._deleted),
            )
            keys = keys[~np.isin(keys, dkeys)]
        self._rows, self._cols = keys // self.m, keys % self.m
        self._chunks, self._added, self._deleted = [], set(), set()

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.m)

    @property
    def num_edges(self) -> int:
        self._consolidate()
        return int(self._rows.size)

    def degree(self, i: int) -> int:
        # O(log E) row-range lookup on the sorted rows, as has_edge below
        self._consolidate()
        lo = np.searchsorted(self._rows, i, "left")
        hi = np.searchsorted(self._rows, i, "right")
        return int(hi - lo)

    def degrees(self) -> np.ndarray:
        self._consolidate()
        return np.bincount(self._rows, minlength=self.n).astype(np.int64)

    @property
    def max_degree(self) -> int:
        d = self.degrees()
        return int(d.max()) if d.size else 0

    def neighbors(self, i: int) -> np.ndarray:
        self._consolidate()
        lo = np.searchsorted(self._rows, i, "left")
        hi = np.searchsorted(self._rows, i, "right")
        return self._cols[lo:hi].copy()

    def has_edge(self, i: int, j: int) -> bool:
        self._check(i, j)
        self._consolidate()
        lo = np.searchsorted(self._rows, i, "left")
        hi = np.searchsorted(self._rows, i, "right")
        return bool(np.isin(j, self._cols[lo:hi]))

    def edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """Sorted (row-major), duplicate-free coordinate arrays."""
        self._consolidate()
        return self._rows.copy(), self._cols.copy()

    def freeze(self, frmt="csr", **kwargs):
        """Freeze into the named immutable format; sugar for
        :func:`sigma_tpu_torch.graph.factory.build_graph`."""
        from sigma_tpu_torch.graph.factory import build_graph

        return build_graph(self, frmt, **kwargs)

    def to_dense(self) -> np.ndarray:
        self._consolidate()
        d = np.zeros(self.shape, dtype=np.int64)
        d[self._rows, self._cols] = 1
        return d

    def transpose(self) -> "GraphBuilder":
        rows, cols = self.edges()
        return GraphBuilder.from_coo(self.m, self.n, cols, rows)

    def __repr__(self) -> str:
        return f"GraphBuilder(shape={self.shape}, num_edges={self.num_edges})"
