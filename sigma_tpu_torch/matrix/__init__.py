from sigma_tpu_torch.matrix.algebra import (
    PtAPPlan,
    SparseSumPlan,
    SpGEMMPlan,
    plan_ptap,
    plan_rart,
    plan_sparse_add,
    plan_sparse_matmul,
    ptap,
    rart,
    sparse_add,
    sparse_matmul,
)
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
    "PtAPPlan",
    "SpGEMMPlan",
    "SparseMatrix",
    "SparseSumPlan",
    "SymmetricDIAMatrix",
    "SymmetricPrunedDIAMatrix",
    "band_occupancy",
    "bandwidth",
    "check_symmetric_triples",
    "choose_matrix_type",
    "convert_matrix",
    "num_matrix_types",
    "plan_ptap",
    "plan_rart",
    "plan_sparse_add",
    "plan_sparse_matmul",
    "ptap",
    "rart",
    "reorder_triples_rcm",
    "sparse_add",
    "sparse_matmul",
    "to_banded_dia",
    "to_pruned_dia",
]
