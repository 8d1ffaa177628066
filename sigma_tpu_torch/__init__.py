"""sigma_tpu_torch — the PyTorch + CUDA port of sigma_tpu.

A second package beside the JAX one, held against it by the tests.  This
first slice is the stencil main path: DIA storage (full and symmetric),
the two hand-written DIA SpMV kernels for Hopper that every matvec runs on
a CUDA device, the operator algebra, CG and fused CG, and the structured
pair-aggregation multigrid preconditioner.

The package imports torch and numpy only (never JAX) and is importable on
a machine with no GPU; the kernels are compiled by nvcc at first use on a
CUDA tensor.  There is no global default device: every tensor is made on
the device of the operand it derives from.
"""

from sigma_tpu_torch.graph import DIAGraph, Graph
from sigma_tpu_torch.matrix import DIAMatrix, SparseMatrix, SymmetricDIAMatrix
from sigma_tpu_torch.operators import (
    AdjointOperator,
    DenseOperator,
    DiagonalOperator,
    IdentityOperator,
    LinearOperator,
    MatvecOperator,
    ProductOperator,
    ScaledOperator,
    SumOperator,
    aslinearoperator,
)
from sigma_tpu_torch.ops import cuda_available
from sigma_tpu_torch.problems import laplacian_3d_dia
from sigma_tpu_torch.solvers import (
    SolveInfo,
    StructuredAMGPreconditioner,
    cg_fused_solve,
    cg_solve,
    structured_pair_amg,
)

__version__ = "0.1.0"
