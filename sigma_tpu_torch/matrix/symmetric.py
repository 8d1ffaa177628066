"""Symmetric DIA storage: upper diagonals only (half the value memory).

Port of :class:`sigma_tpu.matrix.symmetric.SymmetricDIAMatrix`.  Only the
diagonals with offset >= 0 are stored; the lower triangle is the mirror
``A[i, i-o] = data[o][i-o]``:

    y  =  sum_o  data[o] * win(x, +o)          (upper + main)
        + sum_{o>0}  win(data[o] * x, -o)      (mirror)

Every matvec goes through
:func:`sigma_tpu_torch.ops.spmv_dia.dia_sym_spmv_operator` (the operator's
arrays checked once, at construction) and every multi-RHS
product through :func:`sigma_tpu_torch.ops.spmm_dia.dia_sym_spmm` (the
CUDA kernel for a CUDA operand, the plain PyTorch version for a CPU
one).  This is a :class:`LinearOperator`, not a SparseMatrix: convert
with :meth:`from_dia` / :meth:`to_dia` for structural edits.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple

import numpy as np
import torch

from sigma_tpu_torch.graph.graph import DIAGraph
from sigma_tpu_torch.matrix.formats import DIAMatrix, interleaved_apply, panel_apply
from sigma_tpu_torch.operators.linear_operator import LinearOperator
from sigma_tpu_torch.ops.spmm_dia import MAX_PANELS, dia_sym_spmm
from sigma_tpu_torch.ops.spmv_dia import dia_sym_spmv_operator
from sigma_tpu_torch.utils.dtypes import index_dtype, round_up

__all__ = ["SymmetricDIAMatrix"]


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class SymmetricDIAMatrix(LinearOperator):
    """data[d, i] = A[i, i + offsets[d]] with offsets[d] >= 0 only."""

    data: torch.Tensor  # (n_upper_diags, stride), stride = n rounded up to 128
    offsets: Tuple[int, ...]
    n: int
    # the offsets as an int64 tensor on data's device, for the kernel
    offsets_dev: torch.Tensor = dataclasses.field(init=False, repr=False)
    # data and offsets_dev checked once for the kernel: contiguous on CUDA
    _kernel_ready: bool = dataclasses.field(init=False, repr=False)

    format: ClassVar[str] = "dia_sym"

    def __post_init__(self):
        if any(o < 0 for o in self.offsets):
            raise ValueError(
                f"symmetric DIA stores offsets >= 0 only, got {self.offsets}"
            )
        want = (len(self.offsets), round_up(self.n, 128))
        if tuple(self.data.shape) != want:
            raise ValueError(f"data shape {tuple(self.data.shape)} != expected {want}")
        object.__setattr__(
            self,
            "offsets_dev",
            torch.tensor(self.offsets, dtype=index_dtype, device=self.data.device),
        )
        object.__setattr__(
            self, "_kernel_ready", self.data.device.type == "cuda" and self.data.is_contiguous()
        )

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def data2d(self) -> torch.Tensor:
        """(n_upper_diags, stride) view: ``data2d[d, i] = A[i, i +
        offsets[d]]``; ``data`` itself, which has that shape already."""
        return self.data

    @property
    def nnz(self) -> int:
        n = self.n
        return sum((n - o) * (1 if o == 0 else 2) for o in self.offsets)

    # -- construction -----------------------------------------------------
    @classmethod
    def from_dia(cls, A: DIAMatrix, *, rtol: float = 1e-12):
        """Fold a full DIAMatrix into symmetric storage; raises if A is
        not numerically symmetric (per-diagonal mirror comparison)."""
        n, m = A.shape
        if n != m:
            raise ValueError("symmetric storage requires a square matrix")
        offs = A.graph.offsets
        rows = {o: A.data[d] for d, o in enumerate(offs)}
        for o in offs:
            if -o not in rows:
                raise ValueError(f"offset {o} present without mirror {-o}")
            if o > 0 and o < n:
                # A[i, i+o] = data[o][i]  must equal  A[i+o, i] = data[-o][i+o]
                upper = rows[o][: n - o].double()
                lower = rows[-o][o:n].double()
                scale = max(float(upper.abs().max()), 1e-300)
                if float((upper - lower).abs().max()) > rtol * scale:
                    raise ValueError(f"matrix is not symmetric on diagonal +-{o}")
        keep = sorted(o for o in offs if o >= 0)
        sel = [offs.index(o) for o in keep]
        return cls(data=A.data[sel], offsets=tuple(keep), n=int(n))

    @classmethod
    def from_coo(cls, n, m, rows, cols, vals, dtype=None, **kw):
        """Assemble both triangles' COO triples as a DIAMatrix
        (:meth:`DIAMatrix.from_coo`, which takes ``device`` and
        ``sum_duplicates``) and fold it."""
        return cls.from_dia(DIAMatrix.from_coo(n, m, rows, cols, vals, dtype=dtype, **kw))

    @classmethod
    def from_dense(cls, dense, *, device=None, **kw):
        """Fold a dense symmetric array; ``kw`` goes to :meth:`from_dia`."""
        return cls.from_dia(DIAMatrix.from_dense(dense, device=device), **kw)

    def to_dia(self) -> DIAMatrix:
        """Expand back to full (two-triangle) DIA storage."""
        n = self.n
        full = sorted(set(self.offsets) | {-o for o in self.offsets})
        g = DIAGraph(offsets=tuple(full), shape=(n, n), nnz=self.nnz)
        data = torch.zeros(
            (len(full), g.stride), dtype=self.data.dtype, device=self.data.device
        )
        for d, o in enumerate(full):
            src = self.data[self.offsets.index(abs(o))]
            if o >= 0:
                data[d] = src
            else:
                data[d, -o:n] = src[: n + o]
        return DIAMatrix(graph=g, data=data)

    # -- compute ----------------------------------------------------------
    def matvec(self, x):
        return dia_sym_spmv_operator(self.data, x, self.offsets_dev, self.n, self._kernel_ready)

    rmatvec = matvec  # symmetric

    # -- multi-RHS products (layouts as DIAMatrix's) ----------------------
    def _spmm(self, X, layout):
        return dia_sym_spmm(self.data, X, self.offsets_dev, self.n, layout)

    def matmat(self, X):
        """A @ X for X (n, k): one SpMM launch per 16 columns, each stored
        value read once (twice with the mirror term, from L2) for all."""
        return panel_apply(X, self._spmm, self.n)

    rmatmat = matmat  # symmetric

    def matmat_rhs_major(self, XT):
        """RHS-major product XT (k, n) -> (k, n), no transposes."""
        return self.matmat(XT.T).T

    def matmat_interleaved(self, XI):
        """Product of interleaved panels (k * ceil(n/128), 128), returned in
        the same layout (see :meth:`DIAMatrix.matmat_interleaved`)."""
        return interleaved_apply(XI, self._spmm, self.matmat_rhs_major, self.n, self.n)

    def interleaved_profitable(self, k) -> bool:
        """See :meth:`DIAMatrix.interleaved_profitable`."""
        return self.data.device.type == "cuda" and 1 <= k <= MAX_PANELS

    def diagonal(self) -> torch.Tensor:
        if 0 in self.offsets:
            return self.data[self.offsets.index(0), : self.n]
        return torch.zeros(self.n, dtype=self.dtype, device=self.device)

    def to_dense(self) -> np.ndarray:
        return self.to_dia().to_dense()

    def memory_bytes(self) -> int:
        """Bytes of the stored upper diagonals."""
        return self.data.numel() * self.data.element_size()

    def __repr__(self) -> str:
        return (
            f"SymmetricDIAMatrix(n={self.n}, offsets={self.offsets}, "
            f"dtype={self.dtype}, device={self.device})"
        )
