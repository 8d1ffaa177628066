from sigma_tpu_torch.eigen.lanczos import (
    LanczosResult,
    eigensolve,
    generalized_eigensolve,
    generalized_lanczos,
    lanczos,
)
from sigma_tpu_torch.eigen.lobpcg import LOBPCGResult, lobpcg
from sigma_tpu_torch.eigen.refine import RefinedEigenpairs, refine_eigenpairs
from sigma_tpu_torch.eigen.shift_invert import ShiftInvertResult, shift_invert_lanczos

__all__ = [
    "LOBPCGResult",
    "LanczosResult",
    "RefinedEigenpairs",
    "ShiftInvertResult",
    "eigensolve",
    "generalized_eigensolve",
    "generalized_lanczos",
    "lanczos",
    "lobpcg",
    "refine_eigenpairs",
    "shift_invert_lanczos",
]
