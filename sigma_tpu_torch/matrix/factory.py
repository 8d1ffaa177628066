"""Matrix construction and conversion by format name.

Port of :mod:`sigma_tpu.matrix.factory`.
"""

from __future__ import annotations

from typing import Type, Union

from sigma_tpu_torch.matrix.base import SparseMatrix
from sigma_tpu_torch.matrix.formats import (
    BSRMatrix,
    COOMatrix,
    CSCMatrix,
    CSRMatrix,
    DIAMatrix,
    ELLMatrix,
)

__all__ = [
    "MATRIX_FORMATS",
    "num_matrix_types",
    "choose_matrix_type",
    "convert_matrix",
]

MATRIX_FORMATS: dict[str, Type[SparseMatrix]] = {
    "coo": COOMatrix,
    "csr": CSRMatrix,
    "csc": CSCMatrix,
    "ell": ELLMatrix,
    "ellpack": ELLMatrix,
    "bsr": BSRMatrix,
    "dia": DIAMatrix,
}

num_matrix_types = 5
_BY_INT = ["coo", "csr", "csc", "ell", "bsr"]


def choose_matrix_type(frmt: Union[str, int]) -> Type[SparseMatrix]:
    if isinstance(frmt, int):
        if not 1 <= frmt <= num_matrix_types:
            raise ValueError(f"matrix format code {frmt} not in 1..{num_matrix_types}")
        frmt = _BY_INT[frmt - 1]
    cls = MATRIX_FORMATS.get(str(frmt).lower())
    if cls is None:
        raise ValueError(f"unknown matrix format {frmt!r}; choose from {sorted(MATRIX_FORMATS)}")
    return cls


def convert_matrix(A: SparseMatrix, frmt: Union[str, int], **kwargs) -> SparseMatrix:
    """Re-freeze a matrix in another format on its device, preserving
    sparsity and values.  ``kwargs`` go to the format's ``from_coo``
    (``block_shape`` for ``"bsr"``)."""
    cls = choose_matrix_type(frmt)
    rows, cols, vals = A.entries()
    return cls.from_coo(
        A.shape[0], A.shape[1], rows, cols, vals, dtype=A.dtype, device=A.device, **kwargs
    )
