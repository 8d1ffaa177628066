"""sigma_tpu_torch — the PyTorch + CUDA port of sigma_tpu.

A second package beside the JAX one, held against it by the tests.  It
holds the stencil main path: DIA storage (full and symmetric), the
hand-written DIA SpMV and SpMM kernels for Hopper that every matvec and
multi-RHS product runs on a CUDA device, the operator algebra, the Krylov
solvers (CG, fused CG, BiCG-stab, MINRES, GMRES, flexible GMRES, CGLS, the
stationary iteration, block CG; CG, fused CG, BiCG-stab and GMRES also
as ``graphed`` solves, one CUDA graph a block of iterations, or a GMRES
restart cycle, under device-side if-nodes, the counterpart of
``jax.jit``), the solver objects and factories
(``cg()``, ``bicgstab()``, ``gmres()``, ``cgls()``, ``jacobi()``,
``structured_amg()``) with ``attach_solver`` and the ``solve`` facade,
iterative refinement, the structured pair-aggregation multigrid
preconditioner, and the eigensolvers: LOBPCG, Lanczos and generalized
Lanczos (the ``eigen`` subpackage also holds shift-invert Lanczos and
eigenpair refinement), with the 3-D Q1 FEM pencil in ``fem``.  And the
unstructured path: the irregular-mesh generator, RCM and BFS reordering
and the pruned block-DIA pack (host C++ built by g++), pruned storage
(full and symmetric) on its four hand-written SpMV/SpMM kernels, and the
pruned pair multigrid.  And the full-band path: CSR and COO matrices,
``to_banded_dia`` (every diagonal of an RCM band in DIA storage, assembled
on the device), the grouped SpMM kernel for k > 16 columns, the staged-x
SpMV entry ``dia_spmv_staged`` and its two kernels, Chebyshev
preconditioning and fixed-sweep refinement.  And the block / multi-DOF
path: BSR matrices (assembled on the device) and their grouped layout
``GroupedBSR`` on the hand-written grouped-BSR kernel, ``BlockMatrix`` (a
matrix of matrices), the CSC and ELL formats, the graph builder, the
format factories and the ``set_values``/``add_values`` API.  And the
apps and support modules: the graph generators, the multicolour Ising
model and batched self-avoiding walks (``apps``; their command-line
drivers in ``tools``), block vectors, the 2-D P1 finite elements in
``fem``, file I/O and checkpoints (``io``), NaN/Inf checks and matrix
validation, timers and the utilities of ``utils``.  And the distributed
layer (``parallel``): row-partitioned ELL, DIA and pruned operators on a
mesh of shards that share one device, their halo copies and per-shard
kernels, distributed AMG, structured and pruned pair multigrid, and
block-Jacobi ILDU.

The package imports torch and numpy (and scipy's dense ``eigh`` in
eigenpair refinement), never JAX, and is importable on a machine with no
GPU; the kernels are compiled by nvcc at first use on a CUDA tensor.
Constructors that build from host data (COO triples, numpy arrays, a grid
size) build on CUDA unless given ``device=`` (the tests pass
``device="cpu"``, which runs the kernels' plain versions); everything else
makes its tensors on the device of the operand it derives from.
"""

from sigma_tpu_torch.apps import irregular_mesh_laplacian, irregular_mesh_laplacian_coo
from sigma_tpu_torch import fem, io
from sigma_tpu_torch.eigen import (
    LOBPCGResult,
    LanczosResult,
    eigensolve,
    generalized_eigensolve,
    generalized_lanczos,
    lanczos,
    lobpcg,
)
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
    greedy_color_ordering,
    greedy_coloring,
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
    PtAPPlan,
    SparseMatrix,
    SparseSumPlan,
    SpGEMMPlan,
    SymmetricDIAMatrix,
    SymmetricPrunedDIAMatrix,
    band_occupancy,
    bandwidth,
    choose_matrix_type,
    convert_matrix,
    num_matrix_types,
    plan_ptap,
    plan_rart,
    plan_sparse_add,
    plan_sparse_matmul,
    ptap,
    rart,
    reorder_triples_rcm,
    sparse_add,
    sparse_matmul,
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
    AMGPreconditioner,
    BiCGStabSolver,
    CGLSSolver,
    CGSolver,
    ChebyshevSmoother,
    GMRESSolver,
    ILDUPreconditioner,
    JacobiSolver,
    LDUSolver,
    LinearSolver,
    SolveInfo,
    StructuredAMGFactory,
    StructuredAMGPreconditioner,
    TriangularLevels,
    amg_solve,
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
    graphed,
    ildu0_factorize,
    incomplete_cholesky,
    jacobi,
    ldu,
    minres_solve,
    prepare_preconditioner,
    pruned_pair_amg,
    refined_solve,
    refined_solve_fixed,
    skew_dominance,
    smoothed_aggregation_amg,
    stationary_solve,
    structured_amg,
    structured_pair_amg,
)
from sigma_tpu_torch.parallel import (
    DistributedMatrix,
    distribute_matrix,
    distribute_vector,
    make_mesh,
    undistribute_vector,
)
from sigma_tpu_torch.utils.checks import checked, checked_solve, debug_nans, validate_matrix
from sigma_tpu_torch.utils.util import determinant, init_seed, order
from sigma_tpu_torch.vectors import BlockVector

__version__ = "0.1.0"
