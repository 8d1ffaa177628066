"""Frozen graph (sparsity topology) formats.

Port of :mod:`sigma_tpu.graph.graph`, the part the DIA stencil path needs:
the :class:`Graph` query surface and :class:`DIAGraph`.  A topology is
host metadata (shapes, offsets, numpy edge exports); it holds no tensors
and so lives on no device.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import numpy as np

from sigma_tpu_torch.utils.dtypes import round_up

__all__ = ["Graph", "DIAGraph"]


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

    @classmethod
    def from_coo(cls, n: int, m: Optional[int], rows, cols) -> "Graph":
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}(shape={self.shape}, nnz={self.nnz})"


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
    def from_coo(cls, n, m, rows, cols) -> "DIAGraph":
        n, m = int(n), int(m if m is not None else n)
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        offsets = tuple(int(o) for o in np.unique(cols - rows))
        nnz = sum(max(0, min(n, m - o) - max(0, -o)) for o in offsets)
        return cls(offsets=offsets, shape=(n, m), nnz=int(nnz))

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
