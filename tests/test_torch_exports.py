"""Public names and accessors of the port held against the JAX package:
``compress_coo`` from the graph subpackage, ``num_graph_types`` and
``num_matrix_types`` at the top level, every solver name, the algebra and
colouring names where the JAX package exports them, and the ``data2d``
view of full and symmetric DIA storage.  Inputs are made once in numpy and go to both
packages on the CPU in f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu
import sigma_tpu.graph
from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix as JaxSym
import sigma_tpu_torch as st
import sigma_tpu_torch.graph


@pytest.mark.parametrize("dedup", [True, False])
def test_compress_coo_matches_jax(dedup):
    rng = np.random.default_rng(11)
    n, m = 37, 53
    rows = rng.integers(0, n, 400)
    cols = rng.integers(0, m, 400)
    rows = np.concatenate([rows, rows[:60]])  # repeated edges
    cols = np.concatenate([cols, cols[:60]])
    got = sigma_tpu_torch.graph.compress_coo(rows, cols, n, m, dedup=dedup)
    want = sigma_tpu.graph.compress_coo(rows, cols, n, m, dedup=dedup)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].size == (np.unique(rows * m + cols).size if dedup else rows.size)


@pytest.mark.parametrize("name", ["num_graph_types", "num_matrix_types"])
def test_format_counts_at_the_top_level(name):
    assert name in st.__dict__
    assert getattr(st, name) == getattr(sigma_tpu, name)


def _dia_coo(rng, n, m, offsets):
    rows, cols = [], []
    for o in offsets:
        r = np.arange(max(0, -o), min(n, m - o))
        rows.append(r)
        cols.append(r + o)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return rows, cols, rng.standard_normal(rows.size)


@pytest.mark.parametrize(
    "n,m,offsets",
    [(300, 300, (-17, -1, 0, 1, 17)), (260, 190, (-40, 0, 3, 100)), (150, 333, (-5, 0, 2, 180))],
    ids=["square", "tall", "wide"],
)
def test_dia_data2d_matches_jax(n, m, offsets):
    rng = np.random.default_rng(n + m)
    r, c, v = _dia_coo(rng, n, m, offsets)
    Aj = sigma_tpu.DIAMatrix.from_coo(n, m, r, c, v, dtype=jnp.float64)
    At = st.DIAMatrix.from_coo(n, m, r, c, v, dtype=torch.float64, device="cpu")
    assert tuple(At.data2d.shape) == tuple(Aj.data2d.shape)
    np.testing.assert_array_equal(At.data2d.numpy(), np.asarray(Aj.data2d))
    assert At.data2d.data_ptr() == At.data.data_ptr()  # a view, not a copy


def test_symmetric_dia_data2d_matches_jax():
    rng = np.random.default_rng(5)
    n, offsets = 333, (0, 2, 7, 130)
    rows, cols, vals = [], [], []
    for o in offsets:
        i = np.arange(n - o)
        w = rng.standard_normal(n - o)
        rows += [i, i + o] if o else [i]
        cols += [i + o, i] if o else [i]
        vals += [w, w] if o else [w]
    r, c, v = (np.concatenate(a) for a in (rows, cols, vals))
    Sj = JaxSym.from_dia(sigma_tpu.DIAMatrix.from_coo(n, n, r, c, v, dtype=jnp.float64))
    St = st.SymmetricDIAMatrix.from_dia(
        st.DIAMatrix.from_coo(n, n, r, c, v, dtype=torch.float64, device="cpu"))
    assert tuple(St.data2d.shape) == tuple(Sj.data2d.shape)
    np.testing.assert_array_equal(St.data2d.numpy(), np.asarray(Sj.data2d))
    assert St.data2d.data_ptr() == St.data.data_ptr()


# the names of sigma_tpu.solvers that the generic AMG and ILDU brought
AMG_ILDU = (
    "AMGPreconditioner", "amg_solve", "smoothed_aggregation_amg",
    "ILDUPreconditioner", "LDUSolver", "TriangularLevels", "ildu0_factorize",
    "incomplete_cholesky", "ldu",
)
ALGEBRA = (
    "sparse_add", "sparse_matmul", "ptap", "rart", "plan_sparse_add", "plan_sparse_matmul",
    "plan_ptap", "plan_rart", "SparseSumPlan", "SpGEMMPlan", "PtAPPlan",
)
SOLVER_LAYER = (
    "minres_solve", "gmres_solve", "fgmres_solve", "cgls_solve", "stationary_solve",
    "LinearSolver", "CGSolver", "BiCGStabSolver", "GMRESSolver", "CGLSSolver", "JacobiSolver",
    "cg", "bicgstab", "gmres", "cgls", "jacobi", "prepare_preconditioner", "refined_solve",
    "structured_amg",
)


@pytest.mark.parametrize("name", SOLVER_LAYER)
def test_solver_layer_exported_where_jax_exports_it(name):
    import sigma_tpu.solvers
    import sigma_tpu_torch.solvers

    assert name in sigma_tpu.solvers.__all__
    assert name in sigma_tpu_torch.solvers.__all__
    assert getattr(st.solvers, name) is getattr(st, name)
    if hasattr(sigma_tpu, name):
        assert getattr(st, name) is getattr(st.solvers, name)


@pytest.mark.parametrize("name", ["OperatorWithSolver", "attach_solver"])
def test_attach_solver_exported_where_jax_exports_it(name):
    import sigma_tpu.operators
    import sigma_tpu_torch.operators

    assert name in sigma_tpu.operators.__all__ and hasattr(sigma_tpu, name)
    assert name in sigma_tpu_torch.operators.__all__
    assert getattr(st, name) is getattr(sigma_tpu_torch.operators, name)


def test_every_operator_name_is_exported():
    import sigma_tpu.operators
    import sigma_tpu_torch.operators

    assert set(sigma_tpu.operators.__all__) <= set(sigma_tpu_torch.operators.__all__)
    for name in sigma_tpu.operators.__all__:
        if hasattr(sigma_tpu, name):
            assert hasattr(st, name), name


def test_missing_solver_names_are_the_amg_and_ildu_ones():
    """No solver name of the JAX package is missing any more."""
    import sigma_tpu.solvers
    import sigma_tpu_torch.solvers

    missing = set(sigma_tpu.solvers.__all__) - set(sigma_tpu_torch.solvers.__all__)
    assert missing == set()
    for name in sigma_tpu_torch.solvers.__all__:
        assert hasattr(sigma_tpu_torch.solvers, name), name


@pytest.mark.parametrize("name", AMG_ILDU)
def test_amg_and_ildu_exported_where_jax_exports_them(name):
    import sigma_tpu.solvers
    import sigma_tpu_torch.solvers

    assert name in sigma_tpu.solvers.__all__
    assert name in sigma_tpu_torch.solvers.__all__
    # the port exports its solvers at the top level too
    assert getattr(st, name) is getattr(sigma_tpu_torch.solvers, name)


@pytest.mark.parametrize("name", ALGEBRA)
def test_algebra_exported_where_jax_exports_it(name):
    import sigma_tpu.matrix
    import sigma_tpu.matrix.algebra
    import sigma_tpu_torch.matrix
    import sigma_tpu_torch.matrix.algebra

    assert name in sigma_tpu.matrix.__all__ and hasattr(sigma_tpu, name)
    assert name in sigma_tpu_torch.matrix.__all__
    assert name in sigma_tpu_torch.matrix.algebra.__all__
    assert getattr(st, name) is getattr(sigma_tpu_torch.matrix.algebra, name)
    assert getattr(sigma_tpu_torch.matrix, name) is getattr(st, name)


@pytest.mark.parametrize("name", ["greedy_coloring", "greedy_color_ordering"])
def test_coloring_exported_where_jax_exports_it(name):
    import sigma_tpu.graph
    import sigma_tpu_torch.graph.permutations

    assert name in sigma_tpu.graph.__all__ and hasattr(sigma_tpu, name)
    assert name in sigma_tpu_torch.graph.__all__
    assert getattr(st, name) is getattr(sigma_tpu_torch.graph, name)
    assert getattr(st, name) is getattr(sigma_tpu_torch.graph.permutations, name)


@pytest.mark.parametrize("cls", ["PrunedDIAMatrix", "SymmetricPrunedDIAMatrix"])
@pytest.mark.parametrize("flag", ["is_get_row_fast", "is_get_column_fast"])
def test_pruned_capability_flags_match_jax(cls, flag):
    import sigma_tpu.matrix.pruned

    want = getattr(getattr(sigma_tpu.matrix.pruned, cls), flag)
    assert want is False
    assert getattr(getattr(st, cls), flag) is want


def test_every_eigen_name_is_exported():
    import sigma_tpu.eigen
    import sigma_tpu_torch.eigen

    assert set(sigma_tpu_torch.eigen.__all__) == set(sigma_tpu.eigen.__all__)
    for name in sigma_tpu_torch.eigen.__all__:
        assert hasattr(sigma_tpu_torch.eigen, name), name


@pytest.mark.parametrize(
    "name", ["lanczos", "generalized_lanczos", "eigensolve", "generalized_eigensolve",
             "LanczosResult"])
def test_lanczos_names_at_the_top_level(name):
    import sigma_tpu_torch.eigen

    assert hasattr(sigma_tpu, name)
    assert getattr(st, name) is getattr(sigma_tpu_torch.eigen, name)


@pytest.mark.parametrize("name", ["fem3d_stiffness_mass_dia", "fem3d_generalized_spectrum"])
def test_fem_module_at_the_top_level(name):
    assert name in sigma_tpu.fem.__all__ and name in st.fem.__all__
    assert callable(getattr(st.fem, name))


def _top_level_names():
    """The JAX package's public names: what its ``__init__`` binds, and its
    subpackages and modules (listed from the package directory, so every
    test worker collects the same names whatever it imported first)."""
    import pkgutil
    import types

    bound = {n for n in dir(sigma_tpu)
             if not n.startswith("_") and not isinstance(getattr(sigma_tpu, n), types.ModuleType)}
    return sorted(bound | {m.name for m in pkgutil.iter_modules(sigma_tpu.__path__)})


@pytest.mark.parametrize("name", _top_level_names())
def test_every_top_level_name_is_in_the_port(name):
    import importlib

    if not hasattr(sigma_tpu, name) or isinstance(getattr(sigma_tpu, name), type(sigma_tpu)):
        importlib.import_module(f"sigma_tpu_torch.{name}")
    assert hasattr(st, name), name


@pytest.mark.parametrize("module", ["apps", "fem"])
def test_every_apps_and_fem_name_is_in_the_port(module):
    import importlib

    jmod = importlib.import_module(f"sigma_tpu.{module}")
    tmod = importlib.import_module(f"sigma_tpu_torch.{module}")
    missing = [n for n in jmod.__all__ if not hasattr(tmod, n)]
    assert missing == []
    assert set(jmod.__all__) <= set(tmod.__all__)


def test_parallel_names_are_the_jax_packages():
    import sigma_tpu.parallel
    import sigma_tpu_torch.parallel

    assert sigma_tpu_torch.parallel.__all__ == sigma_tpu.parallel.__all__
    assert all(hasattr(sigma_tpu_torch.parallel, n) for n in sigma_tpu.parallel.__all__)


@pytest.mark.parametrize("name,where", [
    ("BlockVector", "vectors"), ("order", "utils.util"), ("determinant", "utils.util"),
    ("init_seed", "utils.util"), ("checked", "utils.checks"), ("checked_solve", "utils.checks"),
    ("debug_nans", "utils.checks"), ("validate_matrix", "utils.checks"),
])
def test_support_names_at_the_same_place_as_in_jax(name, where):
    import importlib

    assert getattr(importlib.import_module(f"sigma_tpu.{where}"), name) is getattr(sigma_tpu, name)
    assert getattr(importlib.import_module(f"sigma_tpu_torch.{where}"), name) is getattr(st, name)


@pytest.mark.parametrize("module", ["io", "utils.profiling", "vectors", "utils.checks",
                                    "utils.util"])
def test_support_module_names_match_jax(module):
    import importlib

    jmod = importlib.import_module(f"sigma_tpu.{module}")
    tmod = importlib.import_module(f"sigma_tpu_torch.{module}")
    assert set(jmod.__all__) == set(tmod.__all__)


# the JAX package's host names the port leaves out on purpose (ROADMAP §3):
# the graphs' own edge_positions serves every lookup in the port
NATIVE_LEFT_OUT = {"edge_positions"}


def test_native_names_cover_the_jax_packages():
    import sigma_tpu.native
    import sigma_tpu_torch.native

    missing = set(sigma_tpu.native.__all__) - set(sigma_tpu_torch.native.__all__)
    assert missing == NATIVE_LEFT_OUT
    assert all(hasattr(sigma_tpu_torch.native, n) for n in sigma_tpu_torch.native.__all__)
