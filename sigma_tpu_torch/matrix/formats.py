"""Sparse matrix formats on torch tensors: DIA, the general CSR, CSC, COO
and ELL, and the block format BSR.

Port of :mod:`sigma_tpu.matrix.formats`.  Every DIA matvec and rmatvec goes through
:func:`sigma_tpu_torch.ops.spmv_dia.dia_spmv`, and every multi-RHS product
(``matmat``, ``rmatmat``, ``matmat_rhs_major``, ``matmat_interleaved``)
through :func:`sigma_tpu_torch.ops.spmm_dia.dia_spmm` in passes of up to 16
columns or, for more columns on a wide band, one
:func:`~sigma_tpu_torch.ops.spmm_dia.dia_spmm_grouped`; each runs the CUDA
kernel for a CUDA operand and the plain PyTorch version for a CPU one.

CSR, CSC, COO and ELL products are a gather and a segment sum (ELL: a
row sum) in plain PyTorch on every device, as the JAX package computes
them with an XLA gather and a segment sum outside any Pallas kernel: CSR
is the input of :func:`~sigma_tpu_torch.matrix.banded.to_banded_dia` and
the gather floor the band is measured against.  So are the four products
of the ungrouped :class:`BSRMatrix` (gather, batched block product, sum
over block rows); its kernel path is :meth:`BSRMatrix.grouped`, the
:class:`~sigma_tpu_torch.ops.bsr_grouped.GroupedBSR` layout, every product
of which on a CUDA tensor is the hand-written grouped-BSR kernel.  Every
such sum, and the sum of repeated triples in ``from_coo``, is an
``index_add_`` on the CPU and elsewhere the fixed-order sum of
:mod:`sigma_tpu_torch.utils.ordered_sum` (each target's terms in stored
order, no atomics, its plan kept with the matrix), so a product gives the
same bits run after run, and the CPU's.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from sigma_tpu_torch.graph.graph import (
    BSRGraph,
    COOGraph,
    CSCGraph,
    CSRGraph,
    DIAGraph,
    ELLGraph,
    Graph,
    _element_keys,
)
from sigma_tpu_torch.matrix.base import SparseMatrix
from sigma_tpu_torch.ops.spmm_dia import (
    MAX_PANELS,
    deinterleave_panels,
    dia_spmm,
    dia_spmm_grouped,
    interleave_panels,
)
from sigma_tpu_torch.ops.spmv_dia import dia_spmv, dia_spmv_operator
from sigma_tpu_torch.utils.device import resolve_device
from sigma_tpu_torch.utils.ordered_sum import scatter_sum
from sigma_tpu_torch.utils.dtypes import (
    default_real_dtype,
    index_dtype,
    round_up,
    to_numpy,
    torch_dtype,
)

__all__ = ["BSRMatrix", "COOMatrix", "CSCMatrix", "CSRMatrix", "DIAMatrix", "ELLMatrix"]


def panel_apply(X, spmm, n, grouped=None):
    """A @ X for (m, k) panels X through ``spmm(panels, layout)``, in passes
    of at most 16 columns (the kernel's bound), concatenated; or, when
    ``grouped`` is given, through one ``grouped(panels, layout)`` for all k
    columns.  A column-major X (``X.T`` contiguous, as a QR factor or
    ``XT.T`` is) is read in place as RHS-major panels and its product comes
    back column-major; any other X goes in as (m, k) column-layout panels.
    No layout copy either way."""
    k = X.shape[1]
    if k == 0:
        return X.new_zeros((n, 0))
    if grouped is not None:
        if not X.is_contiguous() and X.T.is_contiguous():
            return grouped(X.T, "rhs_major").T
        return grouped(X.contiguous(), "cols")
    parts = []
    for j0 in range(0, k, MAX_PANELS):
        Xj = X[:, j0 : j0 + MAX_PANELS]
        if not Xj.is_contiguous() and Xj.T.is_contiguous():
            parts.append(spmm(Xj.T, "rhs_major").T)
        else:
            parts.append(spmm(Xj.contiguous(), "cols"))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def interleaved_apply(XI, spmm, matmat_rhs_major, n, m):
    """The product of (k * ceil(m/128), 128) interleaved panels, returned in
    the same layout ((k * ceil(n/128), 128)): one ``spmm(XI,
    "interleaved")`` for k <= 16; wider blocks go through RHS-major passes
    (de-interleaved once, re-interleaved once)."""
    k = XI.shape[0] // max(-(-m // 128), 1)
    if k <= MAX_PANELS:
        return spmm(XI.contiguous(), "interleaved")
    return interleave_panels(matmat_rhs_major(deinterleave_panels(XI, k, m)), n)


def grouped_profitable(k: int, n_diags: int, itemsize: int) -> bool:
    """The JAX package's rule for a k-column DIA product
    (``DIAMatrix._pallas_spmm_grouped``): one grouped product, each stored
    value read once for all k columns, instead of ceil(k/16) passes of up
    to 16, exactly when k > 16 and the value bytes the extra passes would
    re-read, ``(passes - 1) * n_diags * itemsize`` per row, exceed the
    ``16 * k`` the JAX grouped layout's transposes cost.  Wide bands (an
    RCM band of hundreds of diagonals) take it; the 7-point stencil never
    does.  The port keeps the rule as it is, without the JAX package's
    size, dtype and backend gates."""
    if k <= MAX_PANELS or n_diags == 0:
        return False
    passes = -(-k // MAX_PANELS)
    return (passes - 1) * n_diags * itemsize > MAX_PANELS * k


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class DIAMatrix(SparseMatrix):
    """Diagonal-format matrix: ``data[d, i]`` = A[i, i + offset_d].

    The stencil format: SpMV is gather-free, each diagonal contributing a
    shifted contiguous window ``data[d, i] * x[i + offset_d]``, and no index
    array is stored, so the memory traffic per nonzero is one value plus
    the x and y streams.  Out-of-range slots hold value 0.

    ``data`` is ``(n_diags, stride)`` contiguous.  The JAX package stores
    ``(n_diags, stride/128, 128)`` tiles because a 2-D jit argument cost a
    relayout inside every TPU solver iteration; a GPU kernel indexes the
    2-D array directly, so the tiles are gone.  So are the JAX package's
    backend, dtype and 65,536-row gates in front of its kernel: the
    operand's device alone picks the route, for every size.

    DTYPE CONVENTION: every DIA apply computes in the OPERAND's dtype
    (matrix values cast to x.dtype, inside the kernel) — the contract the
    bf16-value / f32-vector kernels are built on.  Apply an f64 operand if
    f64 accumulation is wanted.

    The multi-RHS products keep the JAX package's public layouts: (m, k)
    for ``matmat``, (k, m) for ``matmat_rhs_major`` and interleaved
    (k * ceil(m/128), 128) panels for ``matmat_interleaved``.  More than 16
    columns go to the grouped product when :meth:`grouped_profitable`
    says so, else to 16-column passes.  The JAX package's
    ``why_not_pallas`` audits TPU gates (backend, dtype, VMEM fit) that the
    port does not have: every CUDA operand runs a kernel, so it is left
    out.
    """

    graph: DIAGraph
    data: torch.Tensor  # (n_diags, stride)
    # the offsets as an int64 tensor on data's device, for the kernel
    offsets_dev: torch.Tensor = dataclasses.field(init=False, repr=False)
    # data and offsets_dev checked once for the kernel: contiguous on CUDA
    _kernel_ready: bool = dataclasses.field(init=False, repr=False)

    format: ClassVar[str] = "dia"
    is_get_row_fast: ClassVar[bool] = True
    is_get_column_fast: ClassVar[bool] = True

    def __post_init__(self):
        want = self._data_shape(self.graph)
        if tuple(self.data.shape) != want:
            raise ValueError(f"data shape {tuple(self.data.shape)} != expected {want}")
        object.__setattr__(
            self,
            "offsets_dev",
            torch.tensor(self.graph.offsets, dtype=index_dtype, device=self.data.device),
        )
        object.__setattr__(
            self, "_kernel_ready", self.data.device.type == "cuda" and self.data.is_contiguous()
        )

    @classmethod
    def _graph_class(cls):
        return DIAGraph

    @classmethod
    def _data_shape(cls, graph):
        return (graph.n_diags, graph.stride)

    @classmethod
    def from_coo(cls, n, m, rows, cols, vals, dtype=None, sum_duplicates=True, device=None):
        """Assemble from COO triples (numpy arrays or tensors) on the
        target device: the offsets are the distinct ``cols - rows``, each
        triple's slot ``d * stride + row`` is computed in int64 (a
        245-diagonal band of 10.1M rows has 2.47e9 slots, past 2^31), and
        the values are scattered into a zero value array there.  No host
        array of every slot is built.  ``sum_duplicates`` sums repeated
        (row, col) triples in float64 before the cast to ``dtype``, as the
        JAX package does; without it a repeated triple keeps one of its
        values."""
        device = resolve_device(device)
        dt = torch_dtype(dtype) if dtype is not None else default_real_dtype()
        n, m = int(n), int(m)
        r = torch.as_tensor(rows).to(device=device, dtype=torch.int64).reshape(-1)
        c = torch.as_tensor(cols).to(device=device, dtype=torch.int64).reshape(-1)
        v = torch.as_tensor(vals).to(device=device).reshape(-1)
        if r.numel():
            lo = torch.stack([r.min(), c.min()]).tolist()
            hi = torch.stack([r.max(), c.max()]).tolist()
            if min(lo) < 0 or hi[0] >= n or hi[1] >= m:
                raise ValueError(f"COO index out of range for shape ({n}, {m}): "
                                 f"rows [{lo[0]}, {hi[0]}], cols [{lo[1]}, {hi[1]}]")
        diag = c - r
        offs = torch.unique(diag)  # sorted
        graph = DIAGraph.from_offsets(offs.tolist(), n, m)
        pos = torch.searchsorted(offs, diag) * graph.stride + r
        del diag, c
        if sum_duplicates:
            pos, inv = torch.unique(pos, return_inverse=True)
            v = scatter_sum(v.to(torch.float64), inv, pos.numel())
            del inv
        data = torch.zeros(graph.n_diags * graph.stride, dtype=dt, device=device)
        data[pos] = v.to(dt)
        return cls(graph=graph, data=data.view(graph.n_diags, graph.stride))

    @property
    def offsets(self):
        return self.graph.offsets

    @property
    def data2d(self) -> torch.Tensor:
        """(n_diags, stride) view: ``data2d[d, i] = A[i, i + offsets[d]]``.
        The JAX package's layout-free accessor over its (D, S, 128) tiles;
        here ``data`` has that shape already, so it is ``data``."""
        return self.data

    def matvec(self, x):
        n, m = self.shape
        if not self.graph.offsets:
            return torch.zeros(n, dtype=x.dtype, device=x.device)
        return dia_spmv_operator(self.data, x, self.offsets_dev, n, m, self._kernel_ready)

    def _transposed_data(self):
        """(dataT, offsetsT) of A^T in DIA layout: A^T's diagonal -o holds
        ``data[o]`` shifted by o (``dataT[-o, j] = data[o, j - o]``), so the
        transpose layout is pure data movement and runs through the same
        kernel.  Built on every call (there is no loop-invariant hoisting
        in eager PyTorch; rmatvec is off the solvers' hot path)."""
        n, m = self.shape
        offs = self.graph.offsets
        stride = self.data.shape[1]
        sT = round_up(m, 128)
        order = sorted(range(len(offs)), key=lambda d: -offs[d])
        dataT = torch.zeros(
            (len(order), sT), dtype=self.data.dtype, device=self.data.device
        )
        for k, d in enumerate(order):
            o = offs[d]
            lo, hi = max(0, o), min(sT, stride + o)
            if hi > lo:
                dataT[k, lo:hi] = self.data[d, lo - o : hi - o]
        offsT = torch.tensor(
            [-offs[d] for d in order], dtype=index_dtype, device=self.data.device
        )
        return dataT, offsT

    def rmatvec(self, x):
        n, m = self.shape
        if not self.graph.offsets:
            return torch.zeros(m, dtype=x.dtype, device=x.device)
        dataT, offsT = self._transposed_data()
        return dia_spmv(dataT, x, offsT, m, n)

    # -- multi-RHS products ------------------------------------------------
    def _spmm(self, X, layout):
        n, m = self.shape
        return dia_spmm(self.data, X, self.offsets_dev, n, m, layout)

    def _spmm_grouped(self, X, layout):
        n, m = self.shape
        return dia_spmm_grouped(self.data, X, self.offsets_dev, n, m, layout)

    def grouped_profitable(self, k) -> bool:
        """True when a k-column product runs as one grouped product (each
        stored value read once for all k) rather than 16-column passes:
        the JAX package's rule, :func:`grouped_profitable`, on this
        band's diagonal count and value itemsize."""
        return grouped_profitable(k, self.graph.n_diags, self.data.element_size())

    def matmat(self, X):
        """A @ X for X (m, k) -> (n, k): one SpMM kernel launch per 16
        columns, each stored value read once for all of them; or one
        grouped launch for all k on a wide band."""
        n, m = self.shape
        if not self.graph.offsets:
            return X.new_zeros((n, X.shape[1]))
        grouped = self._spmm_grouped if self.grouped_profitable(X.shape[1]) else None
        return panel_apply(X, self._spmm, n, grouped)

    def rmatmat(self, X):
        """A^T @ X for X (n, k) -> (m, k), through the transposed layout and
        the 16-column SpMM (as :meth:`rmatvec`)."""
        n, m = self.shape
        if not self.graph.offsets:
            return X.new_zeros((m, X.shape[1]))
        dataT, offsT = self._transposed_data()
        return panel_apply(
            X, lambda Xp, layout: dia_spmm(dataT, Xp, offsT, m, n, layout), m
        )

    def matmat_rhs_major(self, XT):
        """RHS-major product XT (k, m) -> (k, n), read and written in that
        layout by the kernels: no transposes."""
        return self.matmat(XT.T).T

    def matmat_interleaved(self, XI):
        """Product of interleaved panels: XI is (k * ceil(m/128), 128) from
        :func:`~sigma_tpu_torch.ops.interleave_panels`; returns
        (k * ceil(n/128), 128) in the same layout, zero in the padding rows.
        The kernel reads and writes the layout directly."""
        n, m = self.shape
        if not self.graph.offsets:
            k = XI.shape[0] // max(-(-m // 128), 1)
            return XI.new_zeros((k * -(-n // 128), 128))
        return interleaved_apply(XI, self._spmm, self.matmat_rhs_major, n, m)

    def interleaved_profitable(self, k) -> bool:
        """True when block solvers should keep k panels interleaved for a
        whole loop: the matrix lies on a CUDA device, where
        :meth:`matmat_interleaved` runs the kernel on the layout as it
        stands, and 1 <= k <= 16.  On the CPU it is False, as the JAX
        package's is off the TPU."""
        return self.data.device.type == "cuda" and 1 <= k <= MAX_PANELS

    def diagonal(self) -> torch.Tensor:
        if 0 in self.graph.offsets:
            return self.data[self.graph.offsets.index(0), : min(self.shape)]
        return torch.zeros(min(self.shape), dtype=self.dtype, device=self.device)


def _gather_scatter(data, X, gather, scatter, length, plan=None):
    """out[scatter[e]] += data[e] * X[gather[e]] for 1-D or 2-D X; the
    product's dtype follows torch's promotion of data and X.  On the CPU
    an ``index_add_``; on any other device the fixed-order sum of
    ``plan`` (a :class:`~sigma_tpu_torch.utils.ordered_sum.SumPlan` of
    ``scatter``)."""
    prod = (data[:, None] if X.ndim == 2 else data) * X[gather]
    return scatter_sum(prod, scatter, length, plan)


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class _EdgeListMatrix(SparseMatrix):
    """Values on an explicit sorted edge list (CSR and COO row-major, CSC
    column-major): ``data[e]`` = A[rows[e], cols[e]].  The edge indices live beside the
    values on their device as int64 tensors."""

    graph: Graph
    data: torch.Tensor  # (nnz,)
    rows_dev: torch.Tensor = dataclasses.field(init=False, repr=False)
    cols_dev: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        if tuple(self.data.shape) != (self.graph.nnz,):
            raise ValueError(f"data shape {tuple(self.data.shape)} != ({self.graph.nnz},)")
        r, c = self.graph.edges_numpy()
        dev = self.data.device
        object.__setattr__(self, "rows_dev", torch.from_numpy(r).to(dev))
        object.__setattr__(self, "cols_dev", torch.from_numpy(c).to(dev))

    @classmethod
    def _data_shape(cls, graph):
        return (graph.nnz,)

    def _plan(self, side):
        """The fixed-order sum's plan into rows (side 0) or columns (1)."""
        return self._kept_plan(side, lambda: self.graph.edges_numpy()[side])

    def matvec(self, x):
        return _gather_scatter(self.data, x, self.cols_dev, self.rows_dev, self.shape[0],
                               self._plan(0))

    def rmatvec(self, x):
        return _gather_scatter(self.data, x, self.rows_dev, self.cols_dev, self.shape[1],
                               self._plan(1))

    matmat = matvec  # the gather and scatter take (m, k) blocks as they are
    rmatmat = rmatvec

    def entries(self):
        """(rows, cols, values) in the stored order."""
        r, c = self.graph.edges_numpy()
        return r, c, to_numpy(self.data)

    def diagonal(self) -> torch.Tensor:
        r, c = self.graph.edges_numpy()
        on = np.nonzero(r == c)[0]
        d = torch.zeros(min(self.shape), dtype=self.dtype, device=self.device)
        d[torch.from_numpy(r[on]).to(self.device)] = self.data[torch.from_numpy(on).to(self.device)]
        return d


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class CSRMatrix(_EdgeListMatrix):
    """Row-compressed matrix: matvec gathers x at the column indices,
    multiplies, and sums by row (``_gather_scatter``)."""

    graph: CSRGraph

    format: ClassVar[str] = "csr"
    is_get_row_fast: ClassVar[bool] = True

    @classmethod
    def _graph_class(cls):
        return CSRGraph

    @classmethod
    def from_csr_arrays(cls, n, m, indptr, cols, vals, dtype=None, device=None) -> "CSRMatrix":
        """Trusted constructor from host CSR arrays (rows sorted and
        duplicate-free; no re-sort)."""
        device = resolve_device(device)
        g = CSRGraph.from_csr(n, m, indptr, cols)
        dt = torch_dtype(dtype) if dtype is not None else default_real_dtype()
        vals = torch.tensor(np.asarray(vals).reshape(-1)[: g.nnz])
        return cls(graph=g, data=vals.to(device=device, dtype=dt))


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class COOMatrix(_EdgeListMatrix):
    """Coordinate matrix, sorted row-major at freeze time."""

    graph: COOGraph

    format: ClassVar[str] = "coo"

    @classmethod
    def _graph_class(cls):
        return COOGraph


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class CSCMatrix(_EdgeListMatrix):
    """Column-compressed matrix: the stored arrays are the CSR compression
    of A^T and the values are in column-major order, so matvec scatters by
    row and rmatvec sums by column: CSR's two products swapped."""

    graph: CSCGraph

    format: ClassVar[str] = "csc"
    is_get_column_fast: ClassVar[bool] = True

    @classmethod
    def _graph_class(cls):
        return CSCGraph


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class ELLMatrix(SparseMatrix):
    """ELLPACK matrix: values in a dense (n, width) tensor mirroring the
    topology's neighbour array (value 0 in the padding slots).  matvec is
    a fixed-trip-count gather, multiply and row sum."""

    graph: ELLGraph
    data: torch.Tensor  # (n, width)
    cols_dev: torch.Tensor = dataclasses.field(init=False, repr=False)

    format: ClassVar[str] = "ell"
    is_get_row_fast: ClassVar[bool] = True

    def __post_init__(self):
        want = self._data_shape(self.graph)
        if tuple(self.data.shape) != want:
            raise ValueError(f"data shape {tuple(self.data.shape)} != expected {want}")
        object.__setattr__(self, "cols_dev", torch.from_numpy(self.graph.cols).to(self.data.device))

    @classmethod
    def _graph_class(cls):
        return ELLGraph

    @classmethod
    def _data_shape(cls, graph):
        return tuple(graph.cols.shape)

    def matvec(self, x):
        return (self.data * x[self.cols_dev]).sum(dim=1)

    def _scatter_columns(self, prod):
        """Sum of the slot terms ``prod`` (n * width leading rows, in slot
        order) into their columns."""
        cols = self.cols_dev.reshape(-1)
        return scatter_sum(prod, cols, self.shape[1], self._kept_plan("cols", lambda: cols))

    def rmatvec(self, x):
        return self._scatter_columns((self.data * x[:, None]).reshape(-1))

    def matmat(self, X):
        return (self.data[:, :, None] * X[self.cols_dev]).sum(dim=1)

    def rmatmat(self, X):
        prod = self.data[:, :, None] * X[:, None, :]
        return self._scatter_columns(prod.reshape(-1, X.shape[1]))


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class BSRMatrix(SparseMatrix):
    """Block CSR matrix with dense (bh, bw) value blocks, ``data``
    (nnzb_pad, bh, bw), zero at slots that are no true edge and in the
    padding blocks.

    SpMV = gather of x blocks, batched block product, sum over block rows
    (``index_add_`` on the CPU, the fixed-order sum elsewhere); SpMM
    contracts each block against a (bw, k) slab.  Plain PyTorch on every
    device, as the JAX package computes them in XLA.  The kernel path is
    :meth:`grouped`.  Products are computed in the values' dtype (x is
    cast to it), as in the JAX package."""

    graph: BSRGraph
    data: torch.Tensor  # (nnzb_pad, bh, bw)

    format: ClassVar[str] = "bsr"
    is_get_row_fast: ClassVar[bool] = True

    def __post_init__(self):
        want = self._data_shape(self.graph)
        if tuple(self.data.shape) != want:
            raise ValueError(f"data shape {tuple(self.data.shape)} != expected {want}")
        if self.data.device != self.graph.device:
            raise ValueError(f"values on {self.data.device}, graph on {self.graph.device}")

    @classmethod
    def _graph_class(cls):
        return BSRGraph

    @classmethod
    def _data_shape(cls, graph):
        return (graph.indices.shape[0],) + tuple(graph.block_shape)

    def _format_kwargs(self):
        return dict(block_shape=self.graph.block_shape)

    def _format_kwargs_transposed(self):
        bh, bw = self.graph.block_shape
        return dict(block_shape=(bw, bh))

    @classmethod
    def _coerce_graph(cls, graph, device=None):
        device = resolve_device(device)
        if isinstance(graph, BSRGraph):
            return graph if graph.device == device else graph.to(device)
        rows, cols = graph.edges_numpy()
        return BSRGraph.from_coo(graph.shape[0], graph.shape[1], rows, cols, device=device)

    def _coerce_graph_from_builder(self, b):
        rows, cols = b.edges()
        return BSRGraph.from_coo(b.n, b.m, rows, cols, block_shape=self.graph.block_shape,
                                 device=self.device)

    @classmethod
    def from_coo(cls, n, m, rows, cols, vals, dtype=None, sum_duplicates=True, device=None,
                 block_shape=(8, 8)):
        """Assemble from COO triples (numpy arrays or tensors) on the
        target device: element keys ``row * m + col`` in int64, one
        ``torch.unique`` for the sorted edge set (repeated triples summed
        in float64 with ``sum_duplicates``, else one of them kept), one for
        the blocks, one scatter of the values into the zero block array.
        The arrays are those of the JAX package's host assembly, in the
        same order with the same padding."""
        device = resolve_device(device)
        dt = torch_dtype(dtype) if dtype is not None else default_real_dtype()
        n, m = int(n), int(m)
        keys, inv = torch.unique(_element_keys(n, m, rows, cols, device), return_inverse=True)
        v = torch.as_tensor(vals).to(device).reshape(-1)
        if sum_duplicates:
            v = scatter_sum(v.to(torch.float64), inv, keys.numel())
        else:
            v = torch.zeros(keys.numel(), dtype=v.dtype, device=device).index_copy_(0, inv, v)
        del inv
        graph, flat = BSRGraph._from_sorted_keys(n, m, keys, block_shape)
        del keys
        data = torch.zeros(cls._data_shape(graph), dtype=dt, device=device)
        data.view(-1)[flat] = v.to(dt)
        return cls(graph=graph, data=data)

    def entries(self):
        rows, cols = self.graph.edges_torch()
        vals = self.data.reshape(-1)[self.graph.positions_torch(rows, cols)]
        return rows.cpu().numpy(), cols.cpu().numpy(), to_numpy(vals)

    def _padded(self, x, length):
        if x.shape[0] != length:
            x = torch.cat([x, x.new_zeros((length - x.shape[0],) + tuple(x.shape[1:]))])
        return x

    def _padded_x(self, x):
        return self._padded(x, self.graph.nb_cols * self.graph.block_shape[1])

    def grouped(self, group: int = 8):
        """The kernel's grouped layout
        (:class:`sigma_tpu_torch.ops.bsr_grouped.GroupedBSR`), regrouped on
        this matrix's device: the production path for block matrices, one
        hand-written kernel launch per product on a CUDA tensor."""
        from sigma_tpu_torch.ops.bsr_grouped import GroupedBSR

        return GroupedBSR.from_bsr(self, group=group)

    def matvec(self, x):
        return self.matmat(x[:, None])[:, 0]

    def rmatvec(self, x):
        return self.rmatmat(x[:, None])[:, 0]

    def matmat(self, X):
        g = self.graph
        bh, bw = g.block_shape
        k = X.shape[1]
        Xb = self._padded_x(X).reshape(g.nb_cols, bw, k)
        Yb = torch.bmm(self.data, Xb[g.indices].to(self.dtype))  # (nnzb_pad, bh, k)
        # one more row takes the padding blocks' sentinel block row
        Y = scatter_sum(Yb, g.block_rows, g.nb_rows + 1,
                        self._kept_plan("rows", lambda: g.block_rows))
        return Y[: g.nb_rows].reshape(-1, k)[: g.shape[0]]

    def rmatmat(self, X):
        g = self.graph
        bh, bw = g.block_shape
        k = X.shape[1]
        Xp = self._padded(X, g.nb_rows * bh).reshape(g.nb_rows, bh, k)
        # the padding blocks' sentinel row is clamped; their values are 0
        gathered = Xp[g.block_rows.clamp(max=g.nb_rows - 1)].to(self.dtype)
        Yb = torch.bmm(self.data.transpose(1, 2), gathered)
        Y = scatter_sum(Yb, g.indices, g.nb_cols, self._kept_plan("cols", lambda: g.indices))
        return Y.reshape(-1, k)[: g.shape[1]]
