"""Sparse matrix = frozen graph + value tensor (the SiGMA premise).

Port of the core of :mod:`sigma_tpu.matrix.base`: constructors from a
graph, COO triples or a dense array, whole-array entry export, the
diagonal, the dense mirror, and dtype casts.  Matrices are immutable
values; the value tensor lives on one device and every constructor
takes the ``device`` to build it on: CUDA when it is None (raising
without a card), another device only when the caller passes it.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import numpy as np
import torch

from sigma_tpu_torch.graph.graph import Graph
from sigma_tpu_torch.operators.linear_operator import LinearOperator
from sigma_tpu_torch.utils.device import resolve_device
from sigma_tpu_torch.utils.dtypes import default_real_dtype, to_numpy, torch_dtype

__all__ = ["SparseMatrix"]


class SparseMatrix(LinearOperator):
    """Abstract sparse matrix over a frozen topology.

    Concrete formats define ``graph``, ``data`` (a value tensor whose flat
    layout matches ``graph.edge_positions``), ``matvec`` and ``rmatvec``.
    """

    graph: Graph
    data: torch.Tensor
    format: ClassVar[str] = "abstract"

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
        g = cls._coerce_graph(graph)
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
        cls, n, m, rows, cols, vals, dtype=None, sum_duplicates=True, device=None
    ):
        """Build from COO triples on the host and push the values once.
        Duplicates are summed in float64 (``sum_duplicates``); a format
        whose graph has ``from_sorted_coo`` (CSR) then takes the sorted
        unique edges as they are and its values in that order."""
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
            if hasattr(gcls, "from_sorted_coo"):
                g = gcls.from_sorted_coo(n, m, rows, cols)
                return cls(graph=g, data=torch.from_numpy(acc).to(device=device, dtype=dt))
        g = cls._graph_class().from_coo(n, m, rows, cols)
        shape = cls._data_shape(g)
        flat = np.zeros(int(np.prod(shape)), dtype=np.float64)
        flat[g.edge_positions(rows, cols)] = vals
        data = torch.from_numpy(flat.reshape(shape)).to(device=device, dtype=dt)
        return cls(graph=g, data=data)

    @classmethod
    def from_dense(cls, dense, tol: float = 0.0, device=None):
        dense = np.asarray(dense)
        rows, cols = np.nonzero(np.abs(dense) > tol)
        return cls.from_coo(
            dense.shape[0], dense.shape[1], rows, cols, dense[rows, cols],
            dtype=dense.dtype, device=device,
        )

    @classmethod
    def _graph_class(cls):
        raise NotImplementedError

    @classmethod
    def _coerce_graph(cls, graph: Graph) -> Graph:
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

    def diagonal(self) -> torch.Tensor:
        idx = np.arange(min(self.shape))
        return torch.as_tensor(
            self.get_values(idx, idx), dtype=self.dtype, device=self.device
        )

    def to_dense(self) -> np.ndarray:
        rows, cols, vals = self.entries()
        d = np.zeros(self.shape, dtype=vals.dtype)
        d[rows, cols] = vals
        return d

    # -- casts -------------------------------------------------------------------
    def astype(self, dtype) -> "SparseMatrix":
        return dataclasses.replace(self, data=self.data.to(torch_dtype(dtype)))

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
        return dataclasses.replace(self, data=cast)

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(shape={self.shape}, nnz={self.nnz}, "
            f"dtype={self.data.dtype}, device={self.data.device})"
        )
