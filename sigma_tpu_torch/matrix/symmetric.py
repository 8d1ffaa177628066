"""Symmetric DIA storage: upper diagonals only (half the value memory).

Port of :class:`sigma_tpu.matrix.symmetric.SymmetricDIAMatrix`.  Only the
diagonals with offset >= 0 are stored; the lower triangle is the mirror
``A[i, i-o] = data[o][i-o]``:

    y  =  sum_o  data[o] * win(x, +o)          (upper + main)
        + sum_{o>0}  win(data[o] * x, -o)      (mirror)

Every matvec goes through
:func:`sigma_tpu_torch.ops.spmv_dia.dia_sym_spmv` (the CUDA kernel for a
CUDA operand, the plain PyTorch version for a CPU one).  This is a
:class:`LinearOperator`, not a SparseMatrix: convert with
:meth:`from_dia` / :meth:`to_dia` for structural edits.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple

import numpy as np
import torch

from sigma_tpu_torch.graph.graph import DIAGraph
from sigma_tpu_torch.matrix.formats import DIAMatrix
from sigma_tpu_torch.operators.linear_operator import LinearOperator
from sigma_tpu_torch.ops.spmv_dia import dia_sym_spmv
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
        return dia_sym_spmv(self.data, x, self.offsets_dev, self.n)

    rmatvec = matvec  # symmetric

    def diagonal(self) -> torch.Tensor:
        if 0 in self.offsets:
            return self.data[self.offsets.index(0), : self.n]
        return torch.zeros(self.n, dtype=self.dtype, device=self.device)

    def to_dense(self) -> np.ndarray:
        return self.to_dia().to_dense()

    def __repr__(self) -> str:
        return (
            f"SymmetricDIAMatrix(n={self.n}, offsets={self.offsets}, "
            f"dtype={self.dtype}, device={self.device})"
        )
