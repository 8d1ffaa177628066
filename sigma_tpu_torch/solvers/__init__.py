from sigma_tpu_torch.solvers.gmg import (
    StructuredAMGPreconditioner,
    structured_pair_amg,
)
from sigma_tpu_torch.solvers.krylov import SolveInfo, cg_fused_solve, cg_solve

__all__ = [
    "SolveInfo",
    "StructuredAMGPreconditioner",
    "cg_fused_solve",
    "cg_solve",
    "structured_pair_amg",
]
