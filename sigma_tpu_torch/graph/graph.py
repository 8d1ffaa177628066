"""Frozen graph (sparsity topology) formats.

Port of :mod:`sigma_tpu.graph.graph`: the :class:`Graph` query surface,
:class:`DIAGraph`, the general formats :class:`CSRGraph`,
:class:`CSCGraph`, :class:`COOGraph` and :class:`ELLGraph`, and the block
format :class:`BSRGraph`.  All but the last are host metadata (shapes,
offsets, numpy index arrays and edge exports): they hold no tensors and so
live on no device.  Their index arrays are exactly ``nnz`` long: the JAX
package pads them to a multiple of 8 for the TPU's lanes (with a sentinel
row or column), which nothing here needs.

:class:`BSRGraph` is the exception on both counts.  Its arrays are tensors
on a device, because the 10.1M-dof elasticity operator has 23.6M blocks
and a 212 MB slot mask that are assembled on the card from 211M edges and
never cross to the host; and it keeps the JAX package's padding
(``NNZ_PAD``, pad block rows = ``nb_rows``, pad indices = 0), because the
value array ``(nnzb_pad, bh, bw)`` is laid out by it.

Permutation convention: ``permute_rows(p)`` relabels row ``i`` as ``p[i]``
(scatter convention); the dense mirror satisfies ``new[p[i], j] ==
old[i, j]``.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import numpy as np
import torch

from sigma_tpu_torch.utils.device import resolve_device
from sigma_tpu_torch.utils.dtypes import round_up

__all__ = [
    "BSRGraph",
    "COOGraph",
    "CSCGraph",
    "CSRGraph",
    "DIAGraph",
    "ELLGraph",
    "Graph",
    "compress_coo",
]

# Padding granularity of the BSR block arrays (the JAX package's).
NNZ_PAD = 8


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

    @property
    def num_edges(self) -> int:
        return self.nnz

    @property
    def max_degree(self) -> int:
        d = self.degrees_numpy()
        return int(d.max()) if d.size else 0

    def degree(self, i: int) -> int:
        return int(self.degrees_numpy()[i])

    def neighbors(self, i: int) -> np.ndarray:
        rows, cols = self.edges_numpy()
        return cols[rows == i]

    def has_edge(self, i: int, j: int) -> bool:
        return bool(self.edge_positions([i], [j])[0] >= 0)

    def to_dense(self) -> np.ndarray:
        rows, cols = self.edges_numpy()
        d = np.zeros(self.shape, dtype=np.int64)
        d[rows, cols] = 1
        return d

    # -- structural transforms: re-freeze the moved edge set ----------------
    def _refreeze(self, n, m, rows, cols) -> "Graph":
        return type(self).from_coo(n, m, rows, cols)

    def transpose(self) -> "Graph":
        rows, cols = self.edges_numpy()
        return self._refreeze(self.shape[1], self.shape[0], cols, rows)

    def permute_rows(self, p) -> "Graph":
        rows, cols = self.edges_numpy()
        return self._refreeze(self.shape[0], self.shape[1], np.asarray(p)[rows], cols)

    def permute_cols(self, p) -> "Graph":
        rows, cols = self.edges_numpy()
        return self._refreeze(self.shape[0], self.shape[1], rows, np.asarray(p)[cols])

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_coo(cls, n: int, m: Optional[int], rows, cols) -> "Graph":
        raise NotImplementedError

    @classmethod
    def from_builder(cls, b, **kwargs) -> "Graph":
        rows, cols = b.edges()
        return cls.from_coo(b.n, b.m, rows, cols, **kwargs)

    @classmethod
    def from_dense(cls, dense, **kwargs) -> "Graph":
        dense = np.asarray(dense)
        rows, cols = np.nonzero(dense)
        return cls.from_coo(dense.shape[0], dense.shape[1], rows, cols, **kwargs)

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


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class CSCGraph(Graph):
    """Compressed sparse column topology, stored as the CSR compression of
    the transpose: ``indptr`` (m + 1,) per column, ``indices`` (nnz,) the
    row indices sorted within columns, ``col_ids`` (nnz,) the COO expansion
    of ``indptr``.  Values attached to this graph are ordered column-major,
    so a CSC matvec is the transpose product of the stored arrays.  All
    int64 numpy arrays."""

    indptr: np.ndarray
    indices: np.ndarray
    col_ids: np.ndarray
    shape: Tuple[int, int]
    nnz: int

    format: ClassVar[str] = "csc"

    @classmethod
    def from_coo(cls, n, m, rows, cols) -> "CSCGraph":
        n, m = int(n), int(m if m is not None else n)
        cols2, rows2, indptr = compress_coo(cols, rows, m, n)  # sort (col, row)
        return cls(indptr=indptr, indices=rows2, col_ids=cols2, shape=(n, m),
                   nnz=int(rows2.size))

    def edges_numpy(self):
        """(rows, cols) in the stored, column-major order."""
        return self.indices, self.col_ids

    def edge_positions(self, rows, cols) -> np.ndarray:
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        n = self.shape[0]
        return _sorted_positions(self.col_ids * n + self.indices, cols * n + rows,
                                 self._in_range(rows, cols))


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class ELLGraph(Graph):
    """ELLPACK topology: a dense ``(n, width)`` neighbour array ``cols``
    and ``degrees`` (n,), int64 numpy arrays.  Row i's slots past
    ``degrees[i]`` repeat its first real neighbour (0 for an empty row), so
    gathers read no garbage; matrices store value 0 there."""

    cols: np.ndarray
    degrees: np.ndarray
    shape: Tuple[int, int]
    nnz: int

    format: ClassVar[str] = "ell"

    @property
    def width(self) -> int:
        return self.cols.shape[1]

    @classmethod
    def from_coo(cls, n, m, rows, cols, min_width: int = 1) -> "ELLGraph":
        n, m = int(n), int(m if m is not None else n)
        rows, cols, indptr = compress_coo(rows, cols, n, m)
        nnz = rows.size
        deg = indptr[1:] - indptr[:-1]
        width = max(int(deg.max()) if n else 0, min_width)
        node = np.zeros((n, width), dtype=np.int64)
        if nnz:
            node[rows, np.arange(nnz) - indptr[rows]] = cols
            # pad each row's empty slots with its first neighbour
            first = np.zeros(n, dtype=np.int64)
            first[deg > 0] = node[deg > 0, 0]
            pad_mask = np.arange(width)[None, :] >= deg[:, None]
            node = np.where(pad_mask, first[:, None], node)
        return cls(cols=node, degrees=deg, shape=(n, m), nnz=int(nnz))

    def degrees_numpy(self) -> np.ndarray:
        return self.degrees

    def _valid(self) -> np.ndarray:
        return np.arange(self.width)[None, :] < self.degrees[:, None]

    def edges_numpy(self):
        mask = self._valid()
        rows = np.broadcast_to(np.arange(self.shape[0])[:, None], self.cols.shape)
        return rows[mask], self.cols[mask]

    def neighbors(self, i: int) -> np.ndarray:
        return self.cols[i, : int(self.degrees[i])]

    def edge_positions(self, rows, cols) -> np.ndarray:
        """Flat positions ``i * width + slot`` into the (n, width) value
        array, by a broadcast compare of each queried row's slots."""
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        if self.shape[0] == 0:
            return np.full(rows.shape, -1, dtype=np.int64)
        rows_c = np.clip(rows, 0, self.shape[0] - 1)
        valid = np.arange(self.width)[None, :] < self.degrees[rows_c][:, None]
        hit = (self.cols[rows_c] == cols[:, None]) & valid
        any_hit = hit.any(axis=1) & (rows >= 0) & (rows < self.shape[0])
        return np.where(any_hit, rows_c * self.width + hit.argmax(axis=1), -1)


def _index_tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(a).to(device=device, dtype=torch.int64).reshape(-1)


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class BSRGraph(Graph):
    """Block compressed sparse row topology.  Element edges are grouped
    into dense ``(bh, bw)`` blocks (block-CSR over block rows); ``mask``
    records which slots are true edges, so the element-level graph (degree,
    neighbours, exact sparsity) survives blocking.  Matrices built on it
    store explicit zeros at the other slots, which makes SpMV and SpMM
    dense block products.

    The arrays are int64 (``mask`` bool) tensors on one device, padded as
    the JAX package pads them: ``indices`` and ``block_rows`` to a multiple
    of ``NNZ_PAD`` blocks, pad indices 0, pad block rows ``nb_rows``."""

    indptr: torch.Tensor  # (nb_rows + 1,) over block rows
    indices: torch.Tensor  # (nnzb_pad,) block-column indices
    block_rows: torch.Tensor  # (nnzb_pad,) block-row ids, pad = nb_rows
    mask: torch.Tensor  # (nnzb_pad, bh, bw) bool, true-edge slots
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]
    nnz: int
    nnzb: int

    format: ClassVar[str] = "bsr"

    @property
    def nb_rows(self) -> int:
        return -(-self.shape[0] // self.block_shape[0])

    @property
    def nb_cols(self) -> int:
        return -(-self.shape[1] // self.block_shape[1])

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def to(self, device) -> "BSRGraph":
        return dataclasses.replace(
            self, indptr=self.indptr.to(device), indices=self.indices.to(device),
            block_rows=self.block_rows.to(device), mask=self.mask.to(device),
        )

    @classmethod
    def from_coo(cls, n, m, rows, cols, block_shape: Tuple[int, int] = (8, 8),
                 device=None) -> "BSRGraph":
        """Freeze COO edges (numpy arrays or tensors; duplicates tolerated)
        on ``device`` (None: CUDA)."""
        n, m = int(n), int(m if m is not None else n)
        keys = _element_keys(n, m, rows, cols, resolve_device(device))
        return cls._from_sorted_keys(n, m, torch.unique(keys), block_shape)[0]

    @classmethod
    def _from_sorted_keys(cls, n, m, keys, block_shape):
        """(graph, flat value position of each key) from the ascending,
        duplicate-free element keys ``row * m + col`` (an int64 tensor; its
        device is the graph's).  Everything is made on that device: block
        keys by ``torch.unique``, whose inverse is each element's block
        slot, the pointer by a bincount, the mask by one scatter."""
        bh, bw = (int(s) for s in block_shape)
        dev = keys.device
        rows, cols = keys // m, keys % m
        nbr, nbc = -(-n // bh), -(-m // bw)
        bkeys, slot = torch.unique((rows // bh) * nbc + cols // bw, return_inverse=True)
        nnzb = int(bkeys.numel())
        pad = round_up(max(nnzb, 1), NNZ_PAD)
        indices = torch.zeros(pad, dtype=torch.int64, device=dev)
        indices[:nnzb] = bkeys % nbc
        block_rows = torch.full((pad,), nbr, dtype=torch.int64, device=dev)
        block_rows[:nnzb] = bkeys // nbc
        indptr = torch.zeros(nbr + 1, dtype=torch.int64, device=dev)
        torch.cumsum(torch.bincount(block_rows[:nnzb], minlength=nbr), 0, out=indptr[1:])
        flat = slot * (bh * bw) + (rows % bh) * bw + cols % bw
        mask = torch.zeros(pad * bh * bw, dtype=torch.bool, device=dev)
        mask[flat] = True
        graph = cls(indptr=indptr, indices=indices, block_rows=block_rows,
                    mask=mask.view(pad, bh, bw), shape=(n, m), block_shape=(bh, bw),
                    nnz=int(keys.numel()), nnzb=nnzb)
        return graph, flat

    def edges_torch(self):
        """(rows, cols) of every edge, row-major sorted, as int64 tensors
        on the graph's device."""
        b, oi, oj = torch.nonzero(self.mask[: self.nnzb], as_tuple=True)
        rows = self.block_rows[b] * self.block_shape[0] + oi
        cols = self.indices[b] * self.block_shape[1] + oj
        keys = torch.sort(rows * self.shape[1] + cols).values
        return keys // self.shape[1], keys % self.shape[1]

    def edges_numpy(self):
        rows, cols = self.edges_torch()
        return rows.cpu().numpy(), cols.cpu().numpy()

    def _refreeze(self, n, m, rows, cols) -> "BSRGraph":
        return BSRGraph.from_coo(n, m, rows, cols, block_shape=self.block_shape,
                                 device=self.device)

    def transpose(self) -> "BSRGraph":
        rows, cols = self.edges_torch()
        bh, bw = self.block_shape
        return BSRGraph.from_coo(self.shape[1], self.shape[0], cols, rows,
                                 block_shape=(bw, bh), device=self.device)

    def positions_torch(self, rows, cols) -> torch.Tensor:
        """:meth:`edge_positions` on int64 tensors of the graph's device."""
        n, m = self.shape
        bh, bw = self.block_shape
        if self.nnzb == 0:
            return torch.full_like(rows, -1)
        in_range = (rows >= 0) & (rows < n) & (cols >= 0) & (cols < m)
        bkeys = self.block_rows[: self.nnzb] * self.nb_cols + self.indices[: self.nnzb]
        q = torch.where(in_range, (rows // bh) * self.nb_cols + cols // bw, -1)
        pos = torch.searchsorted(bkeys, q).clamp_(0, self.nnzb - 1)
        hit = in_range & (bkeys[pos] == q)
        flat = pos * (bh * bw) + (rows % bh) * bw + cols % bw
        # only slots that are true edges count as present
        present = hit & self.mask.view(-1)[flat.clamp(0, self.mask.numel() - 1)]
        return torch.where(present, flat, -1)

    def edge_positions(self, rows, cols) -> np.ndarray:
        """Flat positions into the (nnzb_pad, bh, bw) value array; -1 for
        an absent edge (a slot of a stored block that is no true edge
        counts as absent)."""
        shape = np.shape(rows)
        pos = self.positions_torch(_index_tensor(rows, self.device),
                                   _index_tensor(cols, self.device))
        return pos.cpu().numpy().reshape(shape)


def _element_keys(n, m, rows, cols, device) -> torch.Tensor:
    """Validated int64 keys ``row * m + col`` on ``device``, in the given
    order.  Raises on an index outside ``[0, n) x [0, m)``."""
    r, c = _index_tensor(rows, device), _index_tensor(cols, device)
    if r.shape != c.shape:
        raise ValueError("rows/cols length mismatch")
    if r.numel():
        lo = torch.stack([r.min(), c.min()]).tolist()
        hi = torch.stack([r.max(), c.max()]).tolist()
        if lo[0] < 0 or hi[0] >= n:
            raise ValueError(f"row index out of range [0, {n}): [{lo[0]}, {hi[0]}]")
        if lo[1] < 0 or hi[1] >= m:
            raise ValueError(f"column index out of range [0, {m}): [{lo[1]}, {hi[1]}]")
    return r * m + c


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
