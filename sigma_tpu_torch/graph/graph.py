"""Frozen graph (sparsity topology) formats.

Port of :mod:`sigma_tpu.graph.graph`: the :class:`Graph` query surface,
:class:`DIAGraph`, and the general formats the full-band path starts
from, :class:`CSRGraph` and :class:`COOGraph`.  A topology is host
metadata (shapes, offsets, numpy index arrays and edge exports); it holds
no tensors and so lives on no device.  The CSR and COO index arrays are
exactly ``nnz`` long: the JAX package pads them to a multiple of 8 for
the TPU's lanes (with sentinel row ``n``), which nothing here needs.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import numpy as np

from sigma_tpu_torch.utils.dtypes import round_up

__all__ = ["COOGraph", "CSRGraph", "DIAGraph", "Graph", "compress_coo"]


def compress_coo(rows, cols, n: int, m: int, dedup: bool = True):
    """Sort COO edges row-major (deduplicated unless ``dedup=False``):
    ``(rows, cols, indptr)`` with ``indptr`` the CSR row pointer.  Raises
    on an index out of ``[0, n) x [0, m)``, which the linearised key
    ``rows * m + cols`` would otherwise alias into another row."""
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    if rows.size:
        if int(rows.min()) < 0 or int(rows.max()) >= n:
            raise ValueError(
                f"row index out of range [0, {n}): [{int(rows.min())}, {int(rows.max())}]"
            )
        if int(cols.min()) < 0 or int(cols.max()) >= m:
            raise ValueError(
                f"column index out of range [0, {m}): [{int(cols.min())}, {int(cols.max())}]"
            )
    keys = rows * m + cols
    keys = np.unique(keys) if dedup else np.sort(keys)
    rows, cols = keys // m, keys % m
    return rows, cols, _indptr(rows, n)


def _indptr(rows: np.ndarray, n: int) -> np.ndarray:
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr


def _sorted_positions(keys: np.ndarray, q: np.ndarray, in_range) -> np.ndarray:
    """Positions of the query keys ``q`` in the ascending ``keys``; -1 for
    a key that is absent or out of range."""
    if keys.size == 0:
        return np.full(q.shape, -1, dtype=np.int64)
    q = np.where(in_range, q, -1)
    pos = np.clip(np.searchsorted(keys, q), 0, keys.size - 1)
    return np.where(in_range & (keys[pos] == q), pos, -1)


class Graph:
    """Common interface over frozen topology formats (the part the DIA
    path uses): queries are whole-array numpy exports, not cursors."""

    # concrete classes define: shape, nnz, edges_numpy(), edge_positions()
    shape: Tuple[int, int]
    nnz: int
    format: ClassVar[str] = "abstract"

    def edges_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, cols) of every edge, row-major sorted."""
        raise NotImplementedError

    def edge_positions(self, rows, cols) -> np.ndarray:
        """Positions of edges (i, j) in this format's flat value array; -1
        if absent."""
        raise NotImplementedError

    def degrees_numpy(self) -> np.ndarray:
        """Edges per row."""
        rows, _ = self.edges_numpy()
        return np.bincount(rows, minlength=self.shape[0])

    @classmethod
    def from_coo(cls, n: int, m: Optional[int], rows, cols) -> "Graph":
        raise NotImplementedError

    def _in_range(self, rows, cols):
        return (rows >= 0) & (rows < self.shape[0]) & (cols >= 0) & (cols < self.shape[1])

    def __repr__(self) -> str:
        return f"{type(self).__name__}(shape={self.shape}, nnz={self.nnz})"


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class CSRGraph(Graph):
    """Compressed sparse row topology: ``indptr`` (n + 1,) and ``indices``
    (nnz,), columns sorted within rows, no duplicates; ``row_ids`` (nnz,)
    is the COO expansion of ``indptr`` that the gather + ``index_add_``
    products scatter by.  All int64 numpy arrays."""

    indptr: np.ndarray
    indices: np.ndarray
    row_ids: np.ndarray
    shape: Tuple[int, int]
    nnz: int

    format: ClassVar[str] = "csr"

    @classmethod
    def from_coo(cls, n, m, rows, cols) -> "CSRGraph":
        n, m = int(n), int(m if m is not None else n)
        rows, cols, indptr = compress_coo(rows, cols, n, m)
        return cls(indptr=indptr, indices=cols, row_ids=rows, shape=(n, m), nnz=int(rows.size))

    @classmethod
    def from_sorted_coo(cls, n, m, rows, cols) -> "CSRGraph":
        """Trusted constructor from row-major sorted, duplicate-free edges
        (no validation, no re-sort)."""
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        n, m = int(n), int(m)
        return cls(indptr=_indptr(rows, n), indices=cols, row_ids=rows, shape=(n, m),
                   nnz=int(rows.size))

    @classmethod
    def from_csr(cls, n, m, indptr, indices) -> "CSRGraph":
        """Trusted constructor from host CSR arrays: rows sorted and
        duplicate-free (no validation, no re-sort)."""
        n, m = int(n), int(m)
        indptr = np.asarray(indptr, dtype=np.int64)
        indices = np.asarray(indices, dtype=np.int64).ravel()
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        return cls(indptr=indptr, indices=indices, row_ids=rows, shape=(n, m),
                   nnz=int(indices.size))

    def edges_numpy(self):
        return self.row_ids, self.indices

    def degrees_numpy(self) -> np.ndarray:
        return self.indptr[1:] - self.indptr[:-1]

    def edge_positions(self, rows, cols) -> np.ndarray:
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        m = self.shape[1]
        return _sorted_positions(self.row_ids * m + self.indices, rows * m + cols,
                                 self._in_range(rows, cols))


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class COOGraph(Graph):
    """Coordinate topology, sorted row-major and deduplicated at freeze
    time: ``rows`` and ``cols`` (nnz,) int64 numpy arrays."""

    rows: np.ndarray
    cols: np.ndarray
    shape: Tuple[int, int]
    nnz: int

    format: ClassVar[str] = "coo"

    @classmethod
    def from_coo(cls, n, m, rows, cols) -> "COOGraph":
        n, m = int(n), int(m if m is not None else n)
        rows, cols, _ = compress_coo(rows, cols, n, m)
        return cls(rows=rows, cols=cols, shape=(n, m), nnz=int(rows.size))

    def edges_numpy(self):
        return self.rows, self.cols

    def edge_positions(self, rows, cols) -> np.ndarray:
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        m = self.shape[1]
        return _sorted_positions(self.rows * m + self.cols, rows * m + cols,
                                 self._in_range(rows, cols))


@dataclasses.dataclass(frozen=True, repr=False)
class DIAGraph(Graph):
    """Diagonal (DIA) topology: the sparsity is a set of matrix diagonals.

    Entry (i, j) is present iff ``j - i`` is in ``offsets`` and in range.
    Value layout: ``(n_diags, stride)``; slot ``(d, i)`` holds
    A[i, i + offsets[d]], zero where i + offsets[d] is out of range.
    """

    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    nnz: int

    format: ClassVar[str] = "dia"

    @property
    def n_diags(self) -> int:
        return len(self.offsets)

    @property
    def stride(self) -> int:
        """Row stride of the value layout: n rounded up to a multiple of
        128.  Kept from the JAX package so flat value positions (and the
        state converter) are the same in both; the GPU kernels need no
        particular stride."""
        return round_up(self.shape[0], 128)

    @classmethod
    def from_offsets(cls, offsets, n, m) -> "DIAGraph":
        """The graph of the given sorted offsets: every in-range slot of
        each diagonal is an edge."""
        offsets = tuple(int(o) for o in offsets)
        nnz = sum(max(0, min(n, m - o) - max(0, -o)) for o in offsets)
        return cls(offsets=offsets, shape=(int(n), int(m)), nnz=int(nnz))

    @classmethod
    def from_coo(cls, n, m, rows, cols) -> "DIAGraph":
        n, m = int(n), int(m if m is not None else n)
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        return cls.from_offsets(np.unique(cols - rows), n, m)

    def _valid_range(self, o: int) -> Tuple[int, int]:
        n, m = self.shape
        return max(0, -o), min(n, m - o)

    def edges_numpy(self):
        rr, cc = [], []
        for o in self.offsets:
            lo, hi = self._valid_range(o)
            r = np.arange(lo, hi, dtype=np.int64)
            rr.append(r)
            cc.append(r + o)
        if not rr:
            return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
        rows = np.concatenate(rr)
        cols = np.concatenate(cc)
        order = np.lexsort((cols, rows))
        return rows[order], cols[order]

    def degrees_numpy(self) -> np.ndarray:
        deg = np.zeros(self.shape[0], dtype=np.int64)
        for o in self.offsets:
            lo, hi = self._valid_range(o)
            deg[lo:hi] += 1
        return deg

    def transpose(self) -> "DIAGraph":
        return DIAGraph(
            offsets=tuple(sorted(-o for o in self.offsets)),
            shape=(self.shape[1], self.shape[0]),
            nnz=self.nnz,
        )

    def edge_positions(self, rows, cols) -> np.ndarray:
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        offs = np.asarray(self.offsets, dtype=np.int64)
        n, m = self.shape
        diff = cols - rows
        d = np.searchsorted(offs, diff)
        d_ok = (d < offs.size) & (offs[np.clip(d, 0, offs.size - 1)] == diff)
        in_range = (rows >= 0) & (rows < n) & (cols >= 0) & (cols < m)
        return np.where(d_ok & in_range, d * self.stride + rows, -1)
