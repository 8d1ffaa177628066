"""DIA (diagonal) sparse matrix format on torch tensors.

Port of :class:`sigma_tpu.matrix.formats.DIAMatrix`.  Every matvec and
rmatvec goes through :func:`sigma_tpu_torch.ops.spmv_dia.dia_spmv`, and
every multi-RHS product (``matmat``, ``rmatmat``, ``matmat_rhs_major``,
``matmat_interleaved``) through :func:`sigma_tpu_torch.ops.spmm_dia.dia_spmm`;
both run the CUDA kernel for a CUDA operand and the plain PyTorch version
for a CPU one.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from sigma_tpu_torch.graph.graph import DIAGraph
from sigma_tpu_torch.matrix.base import SparseMatrix
from sigma_tpu_torch.ops.spmm_dia import (
    MAX_PANELS,
    deinterleave_panels,
    dia_spmm,
    interleave_panels,
)
from sigma_tpu_torch.ops.spmv_dia import dia_spmv
from sigma_tpu_torch.utils.dtypes import index_dtype, round_up

__all__ = ["DIAMatrix"]


def panel_apply(X, spmm, n):
    """A @ X for (m, k) panels X through ``spmm(panels, layout)``, in passes
    of at most 16 columns (the kernel's bound), concatenated.  A column-major
    X (``X.T`` contiguous, as a QR factor or ``XT.T`` is) is read in place
    as RHS-major panels and its product comes back column-major; any other
    X goes in as (m, k) column-layout panels.  No layout copy either way."""
    k = X.shape[1]
    if k == 0:
        return X.new_zeros((n, 0))
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
    (k * ceil(m/128), 128) panels for ``matmat_interleaved``.  The JAX
    package's ``why_not_pallas`` audits TPU gates (backend, dtype, VMEM
    fit) that the port does not have: every CUDA operand runs the kernel,
    so it is left out.
    """

    graph: DIAGraph
    data: torch.Tensor  # (n_diags, stride)
    # the offsets as an int64 tensor on data's device, for the kernel
    offsets_dev: torch.Tensor = dataclasses.field(init=False, repr=False)

    format: ClassVar[str] = "dia"

    def __post_init__(self):
        want = self._data_shape(self.graph)
        if tuple(self.data.shape) != want:
            raise ValueError(f"data shape {tuple(self.data.shape)} != expected {want}")
        object.__setattr__(
            self,
            "offsets_dev",
            torch.tensor(self.graph.offsets, dtype=index_dtype, device=self.data.device),
        )

    @classmethod
    def _graph_class(cls):
        return DIAGraph

    @classmethod
    def _data_shape(cls, graph):
        return (graph.n_diags, graph.stride)

    @property
    def offsets(self):
        return self.graph.offsets

    def matvec(self, x):
        n, m = self.shape
        if not self.graph.offsets:
            return torch.zeros(n, dtype=x.dtype, device=x.device)
        return dia_spmv(self.data, x, self.offsets_dev, n, m)

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

    def matmat(self, X):
        """A @ X for X (m, k) -> (n, k): one SpMM kernel launch per 16
        columns, each stored value read once for all of them."""
        n, m = self.shape
        if not self.graph.offsets:
            return X.new_zeros((n, X.shape[1]))
        return panel_apply(X, self._spmm, n)

    def rmatmat(self, X):
        """A^T @ X for X (n, k) -> (m, k), through the transposed layout and
        the same kernel (as :meth:`rmatvec`)."""
        n, m = self.shape
        if not self.graph.offsets:
            return X.new_zeros((m, X.shape[1]))
        dataT, offsT = self._transposed_data()
        return panel_apply(
            X, lambda Xp, layout: dia_spmm(dataT, Xp, offsT, m, n, layout), m
        )

    def matmat_rhs_major(self, XT):
        """RHS-major product XT (k, m) -> (k, n), read and written in that
        layout by the kernel: no transposes."""
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
