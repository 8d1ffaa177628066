"""Sparse matrix = frozen graph + value tensor (the SiGMA premise).

Port of :mod:`sigma_tpu.matrix.base`: constructors from a graph, COO
triples or a dense array, whole-array entry export, row and column
access, the batched ``set_values``/``add_values``/``add_block`` mutators,
scaling, transpose and permutation, the diagonal, the dense mirror, and
dtype casts.  Matrices are immutable values: a mutator returns a new
matrix (a value update copies the value tensor and scatters into it on
its device), and setting an entry that the sparsity lacks rebuilds graph
and matrix on the host.  The value tensor lives on one device and every
constructor takes the ``device`` to build it on: CUDA when it is None
(raising without a card), another device only when the caller passes it;
a matrix derived from another stays on that one's device.

The capability flags ``is_get_row_fast`` / ``is_get_column_fast`` are
class attributes, AND-reduced over blocks by ``BlockMatrix``.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import numpy as np
import torch

from sigma_tpu_torch.graph.builder import GraphBuilder
from sigma_tpu_torch.graph.graph import Graph
from sigma_tpu_torch.operators.linear_operator import LinearOperator
from sigma_tpu_torch.utils.device import resolve_device
from sigma_tpu_torch.utils.dtypes import default_real_dtype, to_numpy, torch_dtype
from sigma_tpu_torch.utils import ordered_sum

__all__ = ["SparseMatrix"]


class SparseMatrix(LinearOperator):
    """Abstract sparse matrix over a frozen topology.

    Concrete formats define ``graph``, ``data`` (a value tensor whose flat
    layout matches ``graph.edge_positions``), ``matvec`` and ``rmatvec``.
    """

    graph: Graph
    data: torch.Tensor
    format: ClassVar[str] = "abstract"
    is_get_row_fast: ClassVar[bool] = False
    is_get_column_fast: ClassVar[bool] = False

    # -- shape/meta ------------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return self.graph.shape

    @property
    def nnz(self) -> int:
        return self.graph.nnz

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    # -- constructors ------------------------------------------------------------
    @classmethod
    def from_graph(cls, graph: Graph, data=None, dtype=None, device=None):
        """Attach a value tensor (zeros by default) to an existing
        topology; many matrices may share one graph object."""
        device = resolve_device(device)
        g = cls._coerce_graph(graph, device)
        if data is None:
            dt = torch_dtype(dtype) if dtype is not None else default_real_dtype()
            data = torch.zeros(cls._data_shape(g), dtype=dt, device=device)
        else:
            data = torch.as_tensor(data, device=device)
            if tuple(data.shape) != cls._data_shape(g):
                raise ValueError(
                    f"data shape {tuple(data.shape)} != expected {cls._data_shape(g)}"
                )
        return cls(graph=g, data=data)

    @classmethod
    def from_coo(
        cls, n, m, rows, cols, vals, dtype=None, sum_duplicates=True, device=None, **kw
    ):
        """Build from COO triples on the host and push the values once.
        Duplicates are summed in float64 (``sum_duplicates``); a format
        whose graph has ``from_sorted_coo`` (CSR) then takes the sorted
        unique edges as they are and its values in that order.  ``kw``
        goes to the graph's ``from_coo`` (``min_width`` for ELL)."""
        device = resolve_device(device)
        rows = np.asarray(rows).ravel()
        cols = np.asarray(cols).ravel()
        vals = np.asarray(vals).ravel()
        dt = torch_dtype(dtype) if dtype is not None else default_real_dtype()
        if sum_duplicates:
            keys = rows.astype(np.int64) * m + cols
            ukeys, inv = np.unique(keys, return_inverse=True)
            acc = np.bincount(
                inv, weights=vals.astype(np.float64), minlength=ukeys.size
            )
            rows, cols, vals = ukeys // m, ukeys % m, acc
            gcls = cls._graph_class()
            if not kw and hasattr(gcls, "from_sorted_coo"):
                g = gcls.from_sorted_coo(n, m, rows, cols)
                return cls(graph=g, data=torch.from_numpy(acc).to(device=device, dtype=dt))
        g = cls._graph_class().from_coo(n, m, rows, cols, **kw)
        shape = cls._data_shape(g)
        flat = np.zeros(int(np.prod(shape)), dtype=np.float64)
        flat[g.edge_positions(rows, cols)] = vals
        data = torch.from_numpy(flat.reshape(shape)).to(device=device, dtype=dt)
        return cls(graph=g, data=data)

    @classmethod
    def from_dense(cls, dense, tol: float = 0.0, device=None, **kw):
        dense = np.asarray(dense)
        rows, cols = np.nonzero(np.abs(dense) > tol)
        return cls.from_coo(
            dense.shape[0], dense.shape[1], rows, cols, dense[rows, cols],
            dtype=dense.dtype, device=device, **kw,
        )

    @classmethod
    def _graph_class(cls):
        raise NotImplementedError

    @classmethod
    def _coerce_graph(cls, graph: Graph, device=None) -> Graph:
        """``graph`` in this format's graph class (re-frozen when it is
        another's).  ``device`` matters only to a format whose graph holds
        tensors (BSR)."""
        want = cls._graph_class()
        if isinstance(graph, want):
            return graph
        rows, cols = graph.edges_numpy()
        return want.from_coo(graph.shape[0], graph.shape[1], rows, cols)

    @classmethod
    def _data_shape(cls, graph: Graph) -> Tuple[int, ...]:
        raise NotImplementedError

    # -- value access ------------------------------------------------------------
    def entries(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols, values) of the true edges, as host numpy arrays."""
        rows, cols = self.graph.edges_numpy()
        pos = self.graph.edge_positions(rows, cols)
        vals = to_numpy(self.data).reshape(-1)[pos]
        return rows, cols, vals

    def get_values(self, rows, cols) -> np.ndarray:
        """Batched entry read; absent entries read as 0."""
        pos = self.graph.edge_positions(rows, cols)
        flat = to_numpy(self.data).reshape(-1)
        return np.where(pos >= 0, flat[np.clip(pos, 0, flat.size - 1)], 0.0)

    def get_value(self, i: int, j: int) -> float:
        return float(self.get_values([i], [j])[0])

    def get_row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(column indices, values) of row i."""
        rows, cols, vals = self.entries()
        sel = rows == i
        return cols[sel], vals[sel]

    def get_column(self, j: int) -> Tuple[np.ndarray, np.ndarray]:
        """(row indices, values) of column j."""
        rows, cols, vals = self.entries()
        sel = cols == j
        return rows[sel], vals[sel]

    def row_degree(self, i: int) -> int:
        """Stored entries in row i."""
        return int(self.graph.degree(i))

    def diagonal(self) -> torch.Tensor:
        idx = np.arange(min(self.shape))
        return torch.as_tensor(
            self.get_values(idx, idx), dtype=self.dtype, device=self.device
        )

    # -- functional updates --------------------------------------------------------
    def _updated(self, data: torch.Tensor) -> "SparseMatrix":
        return dataclasses.replace(self, data=data)

    def with_data(self, data) -> "SparseMatrix":
        """The same topology with another value tensor of the same shape
        (moved to this matrix's device)."""
        data = torch.as_tensor(data, device=self.device)
        if data.shape != self.data.shape:
            raise ValueError(f"data shape {tuple(data.shape)} != {tuple(self.data.shape)}")
        return self._updated(data)

    def set_values(self, rows, cols, vals) -> "SparseMatrix":
        """Batched set, returning a new matrix; an entry absent from the
        sparsity triggers a host-side graph rebuild (fill-in)."""
        return self._scatter(rows, cols, vals, add=False)

    def add_values(self, rows, cols, vals) -> "SparseMatrix":
        """Batched accumulate (FEM-assembly style), returning a new
        matrix; duplicate (i, j) pairs in the batch accumulate."""
        return self._scatter(rows, cols, vals, add=True)

    def add_block(self, rows, cols, block) -> "SparseMatrix":
        """Dense-block accumulate ``A[np.ix_(rows, cols)] += block``."""
        rows = np.asarray(rows).ravel()
        cols = np.asarray(cols).ravel()
        block = np.asarray(block)
        return self.add_values(np.repeat(rows, cols.size), np.tile(cols, rows.size),
                               block.reshape(-1))

    def _scatter(self, rows, cols, vals, add: bool) -> "SparseMatrix":
        rows = np.asarray(rows).ravel()
        cols = np.asarray(cols).ravel()
        vals = torch.as_tensor(vals).reshape(-1).to(device=self.device, dtype=self.dtype)
        pos = self.graph.edge_positions(rows, cols)
        if (pos < 0).any():
            return self._with_fill_in(rows, cols, vals, add)
        pos = torch.from_numpy(pos.astype(np.int64)).to(self.device)
        flat = self.data.reshape(-1).clone()
        if add:
            # repeated (i, j) pairs add in batch order on every device
            ordered_sum.scatter_add_(flat, pos, vals)
        else:
            flat[pos] = vals
        return self._updated(flat.view(self.data.shape))

    def _kept_plan(self, name, index):
        """The fixed-order sum's plan (:mod:`sigma_tpu_torch.utils.ordered_sum`)
        of the index array ``index()``, built at the first product off the
        CPU and kept with the matrix; None on the CPU, which sums with
        ``index_add_``."""
        if not ordered_sum.fixed_order(self.data.device):
            return None
        plans = self.__dict__.setdefault("_sum_plans", {})
        if name not in plans:
            plans[name] = ordered_sum.sum_plan(index(), self.data.device)
        return plans[name]

    def _with_fill_in(self, rows, cols, vals, add: bool) -> "SparseMatrix":
        # host-side rebuild: thaw the graph, add the edges, refreeze, carry
        # the old values to their new positions
        b = GraphBuilder.from_graph(self.graph)
        b.add_edges(rows, cols)
        new_graph = self._coerce_graph_from_builder(b)
        new = type(self).from_graph(new_graph, dtype=self.dtype, device=self.device)
        orows, ocols, ovals = self.entries()
        opos = torch.from_numpy(new_graph.edge_positions(orows, ocols)).to(self.device)
        new.data.view(-1)[opos] = torch.from_numpy(ovals).to(device=self.device, dtype=self.dtype)
        return new._scatter(rows, cols, vals, add)

    def _coerce_graph_from_builder(self, b: GraphBuilder) -> Graph:
        rows, cols = b.edges()
        return type(self.graph).from_coo(b.n, b.m, rows, cols)

    # -- structure-preserving transforms ---------------------------------------
    def scale(self, alpha) -> "SparseMatrix":
        return self._updated(self.data * alpha)

    def _rebuilt(self, n, m, rows, cols, vals, **kw) -> "SparseMatrix":
        return type(self).from_coo(n, m, rows, cols, vals, dtype=self.dtype,
                                   device=self.device, **kw)

    def transpose_matrix(self) -> "SparseMatrix":
        """Materialised transpose in the same format (the lazy ``.T`` wraps
        without moving data)."""
        rows, cols, vals = self.entries()
        return self._rebuilt(self.shape[1], self.shape[0], cols, rows, vals,
                             **self._format_kwargs_transposed())

    def permute_rows(self, p) -> "SparseMatrix":
        rows, cols, vals = self.entries()
        return self._rebuilt(*self.shape, np.asarray(p)[rows], cols, vals,
                             **self._format_kwargs())

    def permute_cols(self, p) -> "SparseMatrix":
        rows, cols, vals = self.entries()
        return self._rebuilt(*self.shape, rows, np.asarray(p)[cols], vals,
                             **self._format_kwargs())

    def _format_kwargs(self) -> dict:
        return {}

    def _format_kwargs_transposed(self) -> dict:
        """Format kwargs for the transposed shape (BSR swaps block dims)."""
        return self._format_kwargs()

    def to_dense(self) -> np.ndarray:
        rows, cols, vals = self.entries()
        d = np.zeros(self.shape, dtype=vals.dtype)
        d[rows, cols] = vals
        return d

    # -- casts -------------------------------------------------------------------
    def astype(self, dtype) -> "SparseMatrix":
        return self._updated(self.data.to(torch_dtype(dtype)))

    def astype_exact(self, dtype) -> "SparseMatrix":
        """Cast values to a narrower dtype, raising unless every stored
        value round-trips exactly (stencil coefficients, small integers and
        dyadic rationals, are exact in bfloat16)."""
        cast = self.data.to(torch_dtype(dtype))
        if not torch.equal(cast.to(self.data.dtype), self.data):
            raise ValueError(
                f"matrix values are not exactly representable in {dtype}; "
                "use astype() to cast with rounding"
            )
        return self._updated(cast)

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(shape={self.shape}, nnz={self.nnz}, "
            f"dtype={self.data.dtype}, device={self.data.device})"
        )
