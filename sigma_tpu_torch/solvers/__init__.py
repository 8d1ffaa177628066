from sigma_tpu_torch.solvers.chebyshev import ChebyshevSmoother, chebyshev, estimate_lmax
from sigma_tpu_torch.solvers.gmg import (
    StructuredAMGPreconditioner,
    auto_pruned_preconditioner,
    pruned_pair_amg,
    skew_dominance,
    structured_pair_amg,
)
from sigma_tpu_torch.solvers.krylov import (
    SolveInfo,
    bicgstab_solve,
    block_cg_solve,
    cg_fused_solve,
    cg_solve,
)
from sigma_tpu_torch.solvers.refine import refined_solve_fixed

__all__ = [
    "ChebyshevSmoother",
    "SolveInfo",
    "StructuredAMGPreconditioner",
    "auto_pruned_preconditioner",
    "bicgstab_solve",
    "block_cg_solve",
    "cg_fused_solve",
    "cg_solve",
    "chebyshev",
    "estimate_lmax",
    "pruned_pair_amg",
    "refined_solve_fixed",
    "skew_dominance",
    "structured_pair_amg",
]
