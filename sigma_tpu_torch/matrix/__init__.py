from sigma_tpu_torch.matrix.base import SparseMatrix
from sigma_tpu_torch.matrix.formats import DIAMatrix
from sigma_tpu_torch.matrix.symmetric import SymmetricDIAMatrix

__all__ = ["DIAMatrix", "SparseMatrix", "SymmetricDIAMatrix"]
