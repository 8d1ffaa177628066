from sigma_tpu_torch.solvers.gmg import (
    StructuredAMGPreconditioner,
    auto_pruned_preconditioner,
    pruned_pair_amg,
    skew_dominance,
    structured_pair_amg,
)
from sigma_tpu_torch.solvers.krylov import (
    SolveInfo,
    block_cg_solve,
    cg_fused_solve,
    cg_solve,
)

__all__ = [
    "SolveInfo",
    "StructuredAMGPreconditioner",
    "auto_pruned_preconditioner",
    "block_cg_solve",
    "cg_fused_solve",
    "cg_solve",
    "pruned_pair_amg",
    "skew_dominance",
    "structured_pair_amg",
]
