"""DIA (diagonal) sparse matrix format on torch tensors.

Port of :class:`sigma_tpu.matrix.formats.DIAMatrix`.  Every matvec and
rmatvec goes through :func:`sigma_tpu_torch.ops.spmv_dia.dia_spmv`, which
runs the CUDA kernel for a CUDA operand and the plain PyTorch version for
a CPU one.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from sigma_tpu_torch.graph.graph import DIAGraph
from sigma_tpu_torch.matrix.base import SparseMatrix
from sigma_tpu_torch.ops.spmv_dia import dia_spmv
from sigma_tpu_torch.utils.dtypes import index_dtype, round_up

__all__ = ["DIAMatrix"]


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

    def diagonal(self) -> torch.Tensor:
        if 0 in self.graph.offsets:
            return self.data[self.graph.offsets.index(0), : min(self.shape)]
        return torch.zeros(min(self.shape), dtype=self.dtype, device=self.device)
