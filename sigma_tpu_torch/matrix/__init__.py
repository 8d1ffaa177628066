from sigma_tpu_torch.matrix.banded import reorder_triples_rcm
from sigma_tpu_torch.matrix.base import SparseMatrix
from sigma_tpu_torch.matrix.formats import DIAMatrix
from sigma_tpu_torch.matrix.pruned import (
    PrunedDIAMatrix,
    SymmetricPrunedDIAMatrix,
    check_symmetric_triples,
)
from sigma_tpu_torch.matrix.symmetric import SymmetricDIAMatrix

__all__ = [
    "DIAMatrix",
    "PrunedDIAMatrix",
    "SparseMatrix",
    "SymmetricDIAMatrix",
    "SymmetricPrunedDIAMatrix",
    "check_symmetric_triples",
    "reorder_triples_rcm",
]
