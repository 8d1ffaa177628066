from sigma_tpu_torch.matrix.banded import (
    band_occupancy,
    bandwidth,
    reorder_triples_rcm,
    to_banded_dia,
    to_pruned_dia,
)
from sigma_tpu_torch.matrix.base import SparseMatrix
from sigma_tpu_torch.matrix.formats import COOMatrix, CSRMatrix, DIAMatrix
from sigma_tpu_torch.matrix.pruned import (
    PrunedDIAMatrix,
    SymmetricPrunedDIAMatrix,
    check_symmetric_triples,
)
from sigma_tpu_torch.matrix.symmetric import SymmetricDIAMatrix

__all__ = [
    "COOMatrix",
    "CSRMatrix",
    "DIAMatrix",
    "PrunedDIAMatrix",
    "SparseMatrix",
    "SymmetricDIAMatrix",
    "SymmetricPrunedDIAMatrix",
    "band_occupancy",
    "bandwidth",
    "check_symmetric_triples",
    "reorder_triples_rcm",
    "to_banded_dia",
    "to_pruned_dia",
]
