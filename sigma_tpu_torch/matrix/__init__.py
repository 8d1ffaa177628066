from sigma_tpu_torch.matrix.banded import (
    band_occupancy,
    bandwidth,
    reorder_triples_rcm,
    to_banded_dia,
    to_pruned_dia,
)
from sigma_tpu_torch.matrix.base import SparseMatrix
from sigma_tpu_torch.matrix.composite import BlockMatrix
from sigma_tpu_torch.matrix.factory import (
    MATRIX_FORMATS,
    choose_matrix_type,
    convert_matrix,
    num_matrix_types,
)
from sigma_tpu_torch.matrix.formats import (
    BSRMatrix,
    COOMatrix,
    CSCMatrix,
    CSRMatrix,
    DIAMatrix,
    ELLMatrix,
)
from sigma_tpu_torch.matrix.pruned import (
    PrunedDIAMatrix,
    SymmetricPrunedDIAMatrix,
    check_symmetric_triples,
)
from sigma_tpu_torch.matrix.symmetric import SymmetricDIAMatrix

__all__ = [
    "BSRMatrix",
    "BlockMatrix",
    "COOMatrix",
    "CSCMatrix",
    "CSRMatrix",
    "DIAMatrix",
    "ELLMatrix",
    "MATRIX_FORMATS",
    "PrunedDIAMatrix",
    "SparseMatrix",
    "SymmetricDIAMatrix",
    "SymmetricPrunedDIAMatrix",
    "band_occupancy",
    "bandwidth",
    "check_symmetric_triples",
    "choose_matrix_type",
    "convert_matrix",
    "num_matrix_types",
    "reorder_triples_rcm",
    "to_banded_dia",
    "to_pruned_dia",
]
