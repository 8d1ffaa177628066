"""The port's full-band path held against the JAX package in f64 on the CPU:
the CSR and COO graphs and matrices, the irregular-mesh generator (bitwise),
``to_banded_dia`` (offsets, values and permutation equal) and
``to_pruned_dia``, device-side DIA assembly, Chebyshev and fixed-sweep
refinement, the banded pair multigrid, and CG, Chebyshev-CG, banded-GMG CG
and LOBPCG on the band with equal iteration counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.apps.generators import irregular_mesh_laplacian as jax_mesh
from sigma_tpu.eigen import lobpcg as jax_lobpcg
from sigma_tpu.graph.graph import COOGraph as JaxCOOGraph
from sigma_tpu.graph.graph import CSRGraph as JaxCSRGraph
from sigma_tpu.matrix import banded as jax_banded
from sigma_tpu.matrix.formats import COOMatrix as JaxCOO
from sigma_tpu.matrix.formats import CSRMatrix as JaxCSR
from sigma_tpu.matrix.formats import DIAMatrix as JaxDIA
from sigma_tpu.solvers import cg_solve as jax_cg
from sigma_tpu.solvers import chebyshev as jax_chebyshev
from sigma_tpu.solvers import structured_pair_amg as jax_amg
from sigma_tpu.solvers.refine import refined_solve_fixed as jax_refined
import sigma_tpu_torch as st
from sigma_tpu_torch import convert


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _shuffled_mesh(H, W, shift):
    """The JAX package's and the port's shuffled mesh CSR matrices, built as
    benchmarks/unstructured.py builds them (f64)."""
    rng = np.random.default_rng(0)
    Aj = jax_mesh(H, W, rng=rng, shift=shift, dtype=np.float64)
    r, c, v = Aj.entries()
    n = Aj.shape[0]
    sh = rng.permutation(n)
    Aj = JaxCSR.from_coo(n, n, sh[r], sh[c], v, dtype=np.float64)
    rng = np.random.default_rng(0)
    At = st.irregular_mesh_laplacian(H, W, rng=rng, shift=shift, dtype=torch.float64,
                                     device="cpu")
    r, c, v = At.entries()
    sh = rng.permutation(n)
    At = st.CSRMatrix.from_coo(n, n, sh[r], sh[c], v, dtype=torch.float64, device="cpu")
    return Aj, At


@pytest.fixture(scope="module")
def band():
    """(JAX CSR, port CSR, JAX band, port band, JAX p, port p) of the
    shuffled 256 x 32 mesh at shift 1e-3 (127 diagonals after RCM)."""
    Aj, At = _shuffled_mesh(256, 32, 1e-3)
    Dj, pj = jax_banded.to_banded_dia(Aj)
    Dt, pt = st.to_banded_dia(At)
    return Aj, At, Dj, Dt, pj, pt


def _graph_inputs(rng, n=300, m=200, e=1500):
    rows = rng.integers(0, n, e)
    cols = rng.integers(0, m, e)
    return n, m, rows, cols


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_graphs_match_the_jax_package(fmt):
    rng = np.random.default_rng(1)
    n, m, rows, cols = _graph_inputs(rng)
    cls, jcls = (st.CSRGraph, JaxCSRGraph) if fmt == "csr" else (st.COOGraph, JaxCOOGraph)
    g, gj = cls.from_coo(n, m, rows, cols), jcls.from_coo(n, m, rows, cols)
    assert g.nnz == gj.nnz < rows.size and g.shape == gj.shape
    for a, b in zip(g.edges_numpy(), gj.edges_numpy()):
        assert np.array_equal(a, b)
    assert np.array_equal(g.degrees_numpy(), gj.degrees_numpy())
    q_rows = np.r_[rows[:50], 0, n, -1, 5]
    q_cols = np.r_[cols[:50], m, 0, 3, -1]
    q_rows, q_cols = np.r_[q_rows, rng.integers(0, n, 50)], np.r_[q_cols, rng.integers(0, m, 50)]
    assert np.array_equal(g.edge_positions(q_rows, q_cols), gj.edge_positions(q_rows, q_cols))
    if fmt == "csr":
        assert np.array_equal(g.indptr, np.asarray(gj.indptr))
        assert np.array_equal(g.indices, np.asarray(gj.indices)[: gj.nnz])
        assert np.array_equal(g.row_ids, np.asarray(gj.row_ids)[: gj.nnz])
        h = st.CSRGraph.from_csr(n, m, g.indptr, g.indices)
        assert np.array_equal(h.row_ids, g.row_ids) and h.nnz == g.nnz
    with pytest.raises(ValueError, match="out of range"):
        cls.from_coo(n, m, [0, n], [0, 0])


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_csr_coo_products_match_the_jax_package(fmt):
    rng = np.random.default_rng(2)
    n, m, rows, cols = _graph_inputs(rng)
    vals = rng.standard_normal(rows.size)  # duplicates are summed
    cls, jcls = (st.CSRMatrix, JaxCSR) if fmt == "csr" else (st.COOMatrix, JaxCOO)
    A = cls.from_coo(n, m, rows, cols, vals, dtype=torch.float64, device="cpu")
    Aj = jcls.from_coo(n, m, rows, cols, vals, dtype=np.float64)
    x, y = rng.standard_normal(m), rng.standard_normal(n)
    X, Y = rng.standard_normal((m, 5)), rng.standard_normal((n, 3))
    assert rel(A.matvec(torch.from_numpy(x)), Aj.matvec(jnp.asarray(x))) <= 1e-12
    assert rel(A.rmatvec(torch.from_numpy(y)), Aj.rmatvec(jnp.asarray(y))) <= 1e-12
    assert rel(A.matmat(torch.from_numpy(X)), Aj.matmat(jnp.asarray(X))) <= 1e-12
    assert rel(A.rmatmat(torch.from_numpy(Y)), Aj.rmatmat(jnp.asarray(Y))) <= 1e-12
    for a, b in zip(A.entries(), Aj.entries()):
        assert np.array_equal(a, np.asarray(b))
    assert np.array_equal(A.diagonal().numpy(), np.asarray(Aj.diagonal()))
    assert np.array_equal(A.to_dense(), Aj.to_dense())
    # the JAX package's padded arrays carried across
    g = Aj.graph
    if fmt == "csr":
        C = convert.csr_from_arrays(g.indptr, g.indices, Aj.data, Aj.shape, device="cpu")
    else:
        C = convert.coo_from_arrays(g.rows, g.cols, Aj.data, Aj.shape, g.nnz, device="cpu")
    assert type(C) is cls and torch.equal(C.data, A.data)
    assert rel(C.matvec(torch.from_numpy(x)), Aj.matvec(jnp.asarray(x))) <= 1e-12


def test_irregular_mesh_laplacian_is_bitwise_the_jax_packages():
    Aj = jax_mesh(40, 23, rng=np.random.default_rng(3), shift=0.5, dtype=np.float64)
    At = st.irregular_mesh_laplacian(40, 23, rng=np.random.default_rng(3), shift=0.5,
                                     dtype=torch.float64, device="cpu")
    assert isinstance(At, st.CSRMatrix) and At.shape == Aj.shape
    assert np.array_equal(At.graph.indptr, np.asarray(Aj.graph.indptr))
    assert np.array_equal(At.graph.indices, np.asarray(Aj.graph.indices)[: Aj.graph.nnz])
    assert np.array_equal(At.data.numpy(), np.asarray(Aj.data)[: Aj.graph.nnz])


def test_to_banded_dia_matches_the_jax_package(band):
    Aj, At, Dj, Dt, pj, pt = band
    assert isinstance(Dt, st.DIAMatrix) and Dt.device.type == "cpu"
    assert Dt.offsets == Dj.graph.offsets and len(Dt.offsets) == 127
    assert np.array_equal(pt, pj)
    assert np.array_equal(Dt.data.numpy(), np.asarray(Dj.data).reshape(Dt.data.shape))
    assert Dt.nnz == Dj.graph.nnz
    assert st.bandwidth(At) == jax_banded.bandwidth(Aj) > 1000
    assert st.bandwidth(Dt) == jax_banded.bandwidth(Dj) == 63
    assert st.band_occupancy(At) == jax_banded.band_occupancy(Aj)
    assert st.band_occupancy(Dt) == jax_banded.band_occupancy(Dj)
    small = st.irregular_mesh_laplacian(8, 5, rng=np.random.default_rng(0), device="cpu")
    D0, p0 = st.to_banded_dia(small, reorder=False)
    assert p0 is None and D0.offsets == (-6, -5, -4, -1, 0, 1, 4, 5, 6)
    with pytest.raises(ValueError, match="unknown reorder method"):
        st.to_banded_dia(At, method="nope")


def test_bfs_banded_and_pruned_dia_match_the_jax_package(band):
    """``method="bfs"``: the breadth-first order, the permutation and the
    stored values equal to the JAX package's in the band, the pruned pack
    and the triples route."""
    Aj, At, *_ = band
    Dj, pj = jax_banded.to_banded_dia(Aj, method="bfs")
    Dt, pt = st.to_banded_dia(At, method="bfs")
    assert np.array_equal(pt, pj) and not np.array_equal(pt, np.arange(pt.size))
    assert Dt.offsets == Dj.graph.offsets
    assert np.array_equal(Dt.data.numpy(), np.asarray(Dj.data).reshape(Dt.data.shape))
    assert st.bandwidth(Dt) == jax_banded.bandwidth(Dj) < st.bandwidth(At)
    for symmetric in (False, True):
        Pj, qj = jax_banded.to_pruned_dia(Aj, method="bfs", tile_rows=1024,
                                          symmetric=symmetric)
        Pt, qt = st.to_pruned_dia(At, method="bfs", tile_rows=1024, symmetric=symmetric)
        assert np.array_equal(qt, pj) and np.array_equal(qj, pj)
        assert Pt.stored_slots == Pj.stored_slots and Pt.nnz == Pj.nnz
        assert np.array_equal(Pt.data.numpy().reshape(-1), np.asarray(Pj.data).reshape(-1))
    n = At.shape[0]
    r, c, v = At.entries()
    got = st.reorder_triples_rcm(n, r, c, v, method="bfs")
    want = jax_banded.reorder_triples_rcm(n, r, c, v, method="bfs")
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("symmetric", [False, True], ids=["full", "symmetric"])
def test_to_pruned_dia_matches_the_jax_package(band, symmetric):
    Aj, At, *_ = band
    Pj, pj = jax_banded.to_pruned_dia(Aj, tile_rows=1024, symmetric=symmetric)
    Pt, pt = st.to_pruned_dia(At, tile_rows=1024, symmetric=symmetric)
    assert np.array_equal(pt, pj) and type(Pt).__name__ == type(Pj).__name__
    assert Pt.stored_slots == Pj.stored_slots and Pt.nnz == Pj.nnz
    assert np.array_equal(Pt.data.numpy().reshape(-1), np.asarray(Pj.data).reshape(-1))


def test_dia_from_coo_matches_the_jax_package():
    """Assembly on the target device: duplicates summed in f64 as the JAX
    package sums them, a rectangular shape, an int64 slot index, and the
    range check."""
    rng = np.random.default_rng(4)
    n, m = 500, 430
    rows = rng.integers(0, n, 4000)
    cols = np.clip(rows + rng.integers(-40, 41, rows.size), 0, m - 1)
    vals = rng.standard_normal(rows.size)
    for dtype, jdt in ((torch.float64, np.float64), (torch.float32, np.float32)):
        D = st.DIAMatrix.from_coo(n, m, rows, cols, vals, dtype=dtype, device="cpu")
        Dj = JaxDIA.from_coo(n, m, rows, cols, vals, dtype=jdt)
        assert D.offsets == Dj.graph.offsets and D.nnz == Dj.graph.nnz
        assert np.array_equal(D.data.numpy(), np.asarray(Dj.data).reshape(D.data.shape))
    # tensors in, duplicate-free triples without the sum
    key = np.unique(rows * m + cols)
    ur, uc = key // m, key % m
    uv = rng.standard_normal(ur.size)
    D = st.DIAMatrix.from_coo(n, m, torch.from_numpy(ur), torch.from_numpy(uc),
                              torch.from_numpy(uv), dtype=torch.float64,
                              sum_duplicates=False, device="cpu")
    Dj = JaxDIA.from_coo(n, m, ur, uc, uv, dtype=np.float64)
    assert np.array_equal(D.data.numpy(), np.asarray(Dj.data).reshape(D.data.shape))
    with pytest.raises(ValueError, match="out of range"):
        st.DIAMatrix.from_coo(n, m, [0, 1], [0, m], [1.0, 1.0], device="cpu")


def _rhs(band):
    """b_p of benchmarks/unstructured.py: b = A xstar in the input frame
    (the CSR gather), permuted to the band's frame."""
    Aj, _, _, _, pj, _ = band
    xstar = np.sin(np.arange(Aj.shape[0]) * 0.001)
    b = np.asarray(Aj.matvec(jnp.asarray(xstar)))
    bp = np.empty_like(b)
    bp[pj] = b
    return bp


def test_cg_chebyshev_and_banded_gmg_cg_match_the_jax_package(band):
    """Plain CG, Chebyshev(4)-CG (flexible, lmax from the value rows'
    absolute sums) and CG with the banded pair multigrid (Jacobi and
    Chebyshev smoothers), as benchmarks/unstructured.py --gmg runs them:
    equal iteration counts; the preconditioned solutions agree to 1e-10."""
    _, _, Dj, Dt, *_ = band
    bp = _rhs(band)
    kw = dict(tol=0.0, rtol=1e-6, maxiter=1000)
    xj, ij = jax_cg(Dj, jnp.asarray(bp), **kw)
    xt, it = st.cg_solve(Dt, torch.from_numpy(bp), **kw)
    assert it.converged and it.iterations == int(ij.iterations) > 200
    # 288 unpreconditioned iterations at condition number ~1e4 magnify the
    # f64 rounding of differently fused products (measured 6.9e-6)
    assert rel(xt, xj) <= 1e-4
    lmax = float(Dt.data.abs().sum(0).max())
    assert lmax == float(np.abs(np.asarray(Dj.data2d)).sum(axis=0).max())
    Mj = jax_chebyshev(Dj, degree=4, lmax=lmax, lmin=lmax / 30)
    Mt = st.chebyshev(Dt, degree=4, lmax=lmax, lmin=lmax / 30)
    xj, ij = jax_cg(Dj, jnp.asarray(bp), M=Mj, flexible=True, **kw)
    xt, it = st.cg_solve(Dt, torch.from_numpy(bp), M=Mt, flexible=True, **kw)
    assert it.converged and it.iterations == int(ij.iterations) < 150
    assert rel(xt, xj) <= 1e-10
    for smoother in ("jacobi", "chebyshev"):
        Gj = jax_amg(Dj, (Dj.shape[0],), coarse_size=64, smoother=smoother)
        Gt = st.structured_pair_amg(Dt, (Dt.shape[0],), coarse_size=64, smoother=smoother)
        xj, ij = jax_cg(Dj, jnp.asarray(bp), M=Gj, **kw)
        xt, it = st.cg_solve(Dt, torch.from_numpy(bp), M=Gt, **kw)
        assert it.converged and it.iterations == int(ij.iterations) < 50
        assert rel(xt, xj) <= 1e-10


def test_banded_gmg_builds_the_jax_hierarchy(band):
    """structured_pair_amg(D, (n,)) on the 127-diagonal band: the closed-
    form 1-D Galerkin gives the JAX package's levels (offsets, values, the
    smoother's diagonal and Gershgorin bound) and coarse inverse."""
    _, _, Dj, Dt, *_ = band
    n = Dt.shape[0]
    Gj = jax_amg(Dj, (n,), coarse_size=64, smoother="chebyshev")
    Gt = st.structured_pair_amg(Dt, (n,), coarse_size=64, smoother="chebyshev")
    assert len(Gt.levels) == len(Gj.levels) == 7
    assert len(Gt.levels[1].A.offsets) == 63  # the band halves with each pairing
    for lj, lt in zip(Gj.levels, Gt.levels):
        assert lt.A.offsets == lj.A.graph.offsets and (lt.dims, lt.axes) == (lj.dims, lj.axes)
        assert np.array_equal(lt.A.data.numpy(), np.asarray(lj.A.data).reshape(lt.A.data.shape))
        assert np.array_equal(lt.dinv.numpy(), np.asarray(lj.dinv))
        assert lt.lmax == float(lj.lmax)
    assert rel(Gt.coarse_inv, Gj.coarse_inv) <= 1e-12


def test_chebyshev_matches_the_jax_package(band):
    """The default Gershgorin lmax from a CSR matrix's entries, the
    smoother's application and its adjoint, and the power-iteration
    estimate."""
    Aj, At, *_ = band
    Mj, Mt = jax_chebyshev(Aj, degree=3), st.chebyshev(At, degree=3)
    assert Mt.lmax == float(Mj.lmax) and Mt.lmin == float(Mj.lmin)
    r = np.random.default_rng(5).standard_normal(At.shape[0])
    assert rel(Mt.matvec(torch.from_numpy(r)), Mj.matvec(jnp.asarray(r))) <= 1e-12
    assert rel(Mt.rmatvec(torch.from_numpy(r)), Mj.rmatvec(jnp.asarray(r))) <= 1e-12
    lam = float(st.estimate_lmax(At, iters=50, safety=1.0))
    assert 0.9 * Mt.lmax / 2 < lam <= Mt.lmax  # Gershgorin bounds it; a mesh
    # Laplacian's top eigenvalue lies above half its largest row sum


def test_refined_solve_fixed_matches_the_jax_package(band):
    """Three sweeps with an f32-valued inner operator and f64 vectors, and
    with f32 inner vectors and a dtype-pinned multigrid M."""
    _, _, Dj, Dt, *_ = band
    bp = _rhs(band)
    kw = dict(sweeps=3, inner_rtol=1e-3, inner_maxiter=400)
    xj = jax_refined(Dj, jnp.asarray(bp), A_lo=Dj.astype(jnp.float32), **kw)
    xt = st.refined_solve_fixed(Dt, torch.from_numpy(bp), A_lo=Dt.astype(torch.float32), **kw)
    # three inner plain CG solves amplify rounding as plain CG does above
    assert xt.dtype == torch.float64 and rel(xt, xj) <= 1e-6
    n = Dt.shape[0]
    Gj = jax_amg(Dj.astype(jnp.float32), (n,), coarse_size=64)
    Gt = st.structured_pair_amg(Dt.astype(torch.float32), (n,), coarse_size=64)
    xj = jax_refined(Dj, jnp.asarray(bp), M=Gj, inner_dtype=jnp.float32, **kw)
    xt = st.refined_solve_fixed(Dt, torch.from_numpy(bp), M=Gt, inner_dtype=torch.float32, **kw)
    assert rel(xt, xj) <= 1e-5  # f32 inner vectors: rounding differs by operation order
    res = float(torch.linalg.vector_norm(torch.from_numpy(bp) - Dt.matvec(xt)) / np.linalg.norm(bp))
    assert res <= 1e-6


def test_lobpcg_m8_on_the_band_matches_the_jax_package():
    """LOBPCG for 8 eigenpairs with the banded multigrid (Chebyshev
    smoother) on the 128 x 32 mesh's band (117 diagonals): the Rayleigh-
    Ritz basis has k = 24 columns, the grouped route's width."""
    Aj, At = _shuffled_mesh(128, 32, 1e-3)
    Dj, _ = jax_banded.to_banded_dia(Aj)
    Dt, _ = st.to_banded_dia(At)
    assert Dt.grouped_profitable(24)
    n = Dt.shape[0]
    Gj = jax_amg(Dj, (n,), coarse_size=64, smoother="chebyshev")
    Gt = st.structured_pair_amg(Dt, (n,), coarse_size=64, smoother="chebyshev")
    X0 = np.random.default_rng(6).standard_normal((n, 8))
    rj = jax_lobpcg(Dj, jnp.asarray(X0), M=Gj, tol=1e-6, maxiter=60)
    rt = st.lobpcg(Dt, torch.from_numpy(X0), M=Gt, tol=1e-6, maxiter=60)
    assert rt.converged and rt.iterations == int(rj.iterations)
    assert rel(rt.eigenvalues, rj.eigenvalues) <= 1e-10
    assert abs(float(rt.eigenvalues[0]) - 1e-3) <= 1e-9  # the shift: A 1 = 1e-3 * 1


def test_new_entry_points_build_on_the_card_unless_asked():
    """Without ``device=`` the new constructors build on CUDA, and raise
    here, where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present (tests/test_torch_cuda.py covers it)")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.irregular_mesh_laplacian(8, 4, rng=np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.CSRMatrix.from_coo(3, 3, [0, 1], [1, 2], [1.0, 2.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.csr_from_arrays([0, 1, 1], [1], [2.0], (2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.estimate_lmax(st.MatvecOperator(params=(), mv=lambda _, x: 2 * x, rmv=None,
                                           shape=(3, 3)))
    A = st.irregular_mesh_laplacian(8, 4, rng=np.random.default_rng(0), device="cpu")
    assert st.to_banded_dia(A)[0].device.type == "cpu"
