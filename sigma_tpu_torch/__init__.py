"""sigma_tpu_torch — the PyTorch + CUDA port of sigma_tpu.

A second package beside the JAX one, held against it by the tests.  It
holds the stencil main path: DIA storage (full and symmetric), the
hand-written DIA SpMV and SpMM kernels for Hopper that every matvec and
multi-RHS product runs on a CUDA device, the operator algebra, the Krylov
solvers (CG, fused CG, BiCG-stab, MINRES, GMRES, flexible GMRES, CGLS,
the stationary iteration, block CG), the solver objects and factories
(``cg()``, ``bicgstab()``, ``gmres()``, ``cgls()``, ``jacobi()``,
``structured_amg()``) with ``attach_solver`` and the ``solve`` facade,
iterative refinement, the structured pair-aggregation multigrid
preconditioner, and the LOBPCG eigensolver.  And the unstructured path:
the irregular-mesh generator, RCM and BFS reordering and the pruned
block-DIA pack (host C++ built by g++), pruned storage (full and
symmetric) on its four hand-written SpMV/SpMM kernels, and the pruned
pair multigrid.  And
the full-band path: CSR and COO matrices, ``to_banded_dia`` (every diagonal
of an RCM band in DIA storage, assembled on the device), the grouped SpMM
kernel for k > 16 columns, the staged-x SpMV entry ``dia_spmv_staged`` and
its two kernels, Chebyshev preconditioning and fixed-sweep refinement.
And the block / multi-DOF path: BSR matrices (assembled on the device) and
their grouped layout ``GroupedBSR`` on the hand-written grouped-BSR kernel,
``BlockMatrix`` (a matrix of matrices), the CSC and ELL formats, the graph
builder, the format factories and the ``set_values``/``add_values`` API.

The package imports torch and numpy only (never JAX) and is importable on
a machine with no GPU; the kernels are compiled by nvcc at first use on a
CUDA tensor.  Constructors that build from host data (COO triples, numpy
arrays, a grid size) build on CUDA unless given ``device=`` (the tests pass
``device="cpu"``, which runs the kernels' plain versions); everything
else makes its tensors on the device of the operand it derives from.
"""

from sigma_tpu_torch.apps import irregular_mesh_laplacian, irregular_mesh_laplacian_coo
from sigma_tpu_torch.eigen import LOBPCGResult, lobpcg
from sigma_tpu_torch.graph import (
    BSRGraph,
    COOGraph,
    CSCGraph,
    CSRGraph,
    DIAGraph,
    ELLGraph,
    Graph,
    GraphBuilder,
    breadth_first_search,
    build_graph,
    choose_graph_type,
    convert_graph,
    num_graph_types,
    reverse_cuthill_mckee,
)
from sigma_tpu_torch.matrix import (
    BlockMatrix,
    BSRMatrix,
    COOMatrix,
    CSCMatrix,
    CSRMatrix,
    DIAMatrix,
    ELLMatrix,
    PrunedDIAMatrix,
    SparseMatrix,
    SymmetricDIAMatrix,
    SymmetricPrunedDIAMatrix,
    band_occupancy,
    bandwidth,
    choose_matrix_type,
    convert_matrix,
    num_matrix_types,
    reorder_triples_rcm,
    to_banded_dia,
    to_pruned_dia,
)
from sigma_tpu_torch.operators import (
    AdjointOperator,
    DenseOperator,
    DiagonalOperator,
    IdentityOperator,
    LinearOperator,
    MatvecOperator,
    OperatorWithSolver,
    ProductOperator,
    ScaledOperator,
    SumOperator,
    aslinearoperator,
    attach_solver,
)
from sigma_tpu_torch.ops import GroupedBSR, cuda_available
from sigma_tpu_torch.problems import (
    advection_diffusion_dia,
    block_banded_grouped_bsr,
    elasticity_field_blocked,
    elasticity_jacobi,
    elasticity_node_major_bsr,
    elasticity_node_major_dia,
    elasticity_permutation,
    laplacian_3d_dia,
    skewed_mesh_coo,
)
from sigma_tpu_torch.solvers import (
    BiCGStabSolver,
    CGLSSolver,
    CGSolver,
    ChebyshevSmoother,
    GMRESSolver,
    JacobiSolver,
    LinearSolver,
    SolveInfo,
    StructuredAMGFactory,
    StructuredAMGPreconditioner,
    auto_pruned_preconditioner,
    bicgstab,
    bicgstab_solve,
    block_cg_solve,
    cg,
    cg_fused_solve,
    cg_solve,
    cgls,
    cgls_solve,
    chebyshev,
    estimate_lmax,
    fgmres_solve,
    gmres,
    gmres_solve,
    jacobi,
    minres_solve,
    prepare_preconditioner,
    pruned_pair_amg,
    refined_solve,
    refined_solve_fixed,
    skew_dominance,
    stationary_solve,
    structured_amg,
    structured_pair_amg,
)

__version__ = "0.1.0"
