"""The port's MINRES, GMRES, FGMRES, CGLS and stationary solves, the solver
objects and factories, the ``solve`` facade and ``attach_solver``,
``refined_solve`` and ``structured_amg`` held against the JAX package on
the CPU in f64: inputs made once in numpy, equal iteration counts, and
solutions within 1e-10 relative (1e-12 where ``test_torch_krylov.py`` holds
the same solver to it).  The problems follow the JAX package's own tests
(``tests/test_solvers.py``, ``tests/test_gmg.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu
import sigma_tpu.solvers as js
from sigma_tpu.operators import DiagonalOperator as JaxDiag
from sigma_tpu.operators import attach_solver as jax_attach
import sigma_tpu_torch as st


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def laplacian_1d(n, c=0.0):
    """tridiag(-1 - c dx/2, 2, -1 + c dx/2), as the reference tests."""
    dx = 1.0 / (n + 1)
    dense = (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0 + c * dx / 2), 1)
             + np.diag(np.full(n - 1, -1.0 - c * dx / 2), -1))
    return dense, dx


def random_spd_laplacian(rng, n):
    """ER graph Laplacian + I (reference solver_test_jacobi)."""
    mask = np.triu(rng.random((n, n)) < np.log2(n) / n, k=1)
    z = np.where(mask, rng.random((n, n)), 0.0)
    off = z + z.T
    return np.diag(1.0 + off.sum(axis=1)) - off


def smoothed_manufactured_solution(rng, dense):
    v0 = rng.random(dense.shape[0])
    return v0 + (v0 - dense @ v0) / np.diag(dense)


def nonsym_banded(rng, n, beta=0.3, shift=0.6):
    """The banded nonsymmetric operator of the JAX package's FGMRES tests."""
    dense = np.zeros((n, n))
    i = np.arange(n)
    for o in (1, 3, 9):
        v = -np.abs(rng.random(n - o)) * 0.3
        dense[i[:-o], i[:-o] + o] = v * (1 + beta)
        dense[i[:-o] + o, i[:-o]] = v * (1 - beta)
    dense[i, i] = np.abs(dense).sum(1) + shift
    return dense


def csr_both(dense):
    n, m = dense.shape
    r, c = np.nonzero(dense)
    Aj = sigma_tpu.CSRMatrix.from_coo(n, m, r, c, dense[r, c], dtype=jnp.float64)
    At = st.CSRMatrix.from_coo(n, m, r, c, dense[r, c], dtype=torch.float64, device="cpu")
    return Aj, At


def dia_both(dense):
    n = dense.shape[0]
    r, c = np.nonzero(dense)
    Aj = sigma_tpu.DIAMatrix.from_coo(n, n, r, c, dense[r, c], dtype=jnp.float64)
    At = st.DIAMatrix.from_coo(n, n, r, c, dense[r, c], dtype=torch.float64, device="cpu")
    return Aj, At


def diag_both(d):
    return JaxDiag(jnp.asarray(d)), st.DiagonalOperator(torch.from_numpy(d))


def same(xj, ij, xt, it, tol=1e-10, converged=True):
    """Equal iteration counts and convergence flags, x within ``tol``."""
    assert it.iterations == int(ij.iterations)
    assert it.converged == bool(ij.converged) == converged
    assert rel(xt.numpy(), np.asarray(xj)) <= tol
    return xt.numpy()


# -- GMRES ---------------------------------------------------------------------


@pytest.mark.parametrize("restart", [48, 8])
@pytest.mark.parametrize("entry", ["function", "factory"])
def test_gmres_matches_jax_and_dense_solve(rng, entry, restart):
    """tests/test_solvers.py:254, and with restart 8 (several cycles)."""
    n = 96
    dense = random_spd_laplacian(rng, n)
    skew = np.where(dense != 0, 0.2 * rng.standard_normal((n, n)), 0.0)
    dense = dense + skew - skew.T
    Aj, At = csr_both(dense)
    b = rng.standard_normal(n)
    if entry == "function":
        xj, ij = js.gmres_solve(Aj, jnp.asarray(b), tol=1e-12, restart=restart)
        xt, it = st.gmres_solve(At, torch.from_numpy(b), tol=1e-12, restart=restart)
    else:
        xj, ij = js.gmres(1e-12, restart=restart).solve_info(Aj, jnp.asarray(b))
        xt, it = st.gmres(1e-12, restart=restart).solve_info(At, torch.from_numpy(b))
        assert isinstance(st.gmres(), st.GMRESSolver)
    x = same(xj, ij, xt, it)
    assert it.iterations > (restart if restart < 48 else 0)
    np.testing.assert_allclose(x, np.linalg.solve(dense, b), atol=1e-9)


def test_gmres_advection_diffusion_with_jacobi():
    """The operator of tests/test_solvers.py:102 at n = 128 (where Jacobi-
    preconditioned GMRES(64) converges) with jacobi(); the ldu() case
    follows."""
    n, c = 128, 0.5
    dense, dx = laplacian_1d(n, c)
    Aj, At = csr_both(dense)
    f = np.full(n, 2.0 * dx**2)
    xj, ij = js.gmres(1e-12, restart=64).solve_info(Aj, jnp.asarray(f), M=js.jacobi())
    xt, it = st.gmres(1e-12, restart=64).solve_info(At, torch.from_numpy(f), M=st.jacobi())
    x = same(xj, ij, xt, it)
    grid = np.arange(1, n + 1) * dx
    exact = 2.0 * (grid - (np.exp(c * grid) - 1) / (np.exp(c) - 1)) / c
    assert np.abs(x - exact).max() < 1e-4  # the discretisation error at n = 128


def test_gmres_advection_diffusion_with_ldu():
    """tests/test_solvers.py:102: GMRES(64) + ldu() at n = 1024; ILDU(0) is
    exact for the tridiagonal operator, so a couple of Arnoldi steps
    solve it."""
    n, c = 1024, 0.5
    dense, dx = laplacian_1d(n, c)
    Aj, At = csr_both(dense)
    f = np.full(n, 2.0 * dx**2)
    xj, ij = js.gmres(1e-12, restart=64).solve_info(Aj, jnp.asarray(f), M=js.ldu())
    xt, it = st.gmres(1e-12, restart=64).solve_info(At, torch.from_numpy(f), M=st.ldu())
    x = same(xj, ij, xt, it)
    assert it.iterations <= 3
    grid = np.arange(1, n + 1) * dx
    exact = 2.0 * (grid - (np.exp(c * grid) - 1) / (np.exp(c) - 1)) / c
    assert np.abs(x - exact).max() < 1e-8


def test_gmres_stops_at_maxiter_and_on_zero_rhs():
    rng = np.random.default_rng(4)
    dense = nonsym_banded(rng, 200)
    Aj, At = dia_both(dense)
    b = rng.standard_normal(200)
    xj, ij = js.gmres_solve(Aj, jnp.asarray(b), tol=0.0, rtol=1e-14, restart=5, maxiter=7)
    xt, it = st.gmres_solve(At, torch.from_numpy(b), tol=0.0, rtol=1e-14, restart=5, maxiter=7)
    same(xj, ij, xt, it, converged=False)
    assert it.iterations == 7
    x0, i0 = st.gmres_solve(At, torch.zeros(200, dtype=torch.float64))
    assert i0.iterations == 0 and i0.converged and not x0.any()


# -- MINRES --------------------------------------------------------------------


def test_minres_indefinite_matches_jax(rng):
    """tests/test_solvers.py:510: a shifted 1-D Laplacian, indefinite.  At
    its tolerance 1e-12 the solve runs past n = 200 steps, where the
    Krylov space is exhausted and the last estimates are rounding (the
    packages' part from 1e-7 on: 4.0e-10 against 1.1e-10 two steps before
    the end), so the counts are held equal at tol 1e-6 and the 1e-12
    solves each to xstar."""
    n = 200
    dense, dx = laplacian_1d(n)
    dense = dense - 1.001 * 4 * np.sin(3 * np.pi * dx / 2) ** 2 * np.eye(n)
    ev = np.linalg.eigvalsh(dense)
    assert ev[0] < 0 < ev[-1]
    Aj, At = csr_both(dense)
    xstar = rng.standard_normal(n)
    b = dense @ xstar
    xj, ij = js.minres_solve(Aj, jnp.asarray(b), tol=1e-6, maxiter=5 * n)
    xt, it = st.minres_solve(At, torch.from_numpy(b), tol=1e-6, maxiter=5 * n)
    same(xj, ij, xt, it)
    assert it.iterations > n // 2
    assert abs(float(it.residual_norm) - float(ij.residual_norm)) <= 1e-8 * float(ij.residual_norm)
    xj, ij = js.minres_solve(Aj, jnp.asarray(b), tol=1e-12, maxiter=5 * n)
    xt, it = st.minres_solve(At, torch.from_numpy(b), tol=1e-12, maxiter=5 * n)
    assert it.converged and bool(ij.converged)
    assert np.abs(xt.numpy() - xstar).max() < 1e-7
    assert np.abs(np.asarray(xj) - xstar).max() < 1e-7


@pytest.mark.parametrize("precond", [False, True])
def test_minres_spd_history_and_preconditioner(rng, precond):
    """tests/test_solvers.py:531: SPD with a skewed diagonal, history, and
    an SPD Jacobi M cutting the count."""
    n = 160
    dense = random_spd_laplacian(rng, n)
    dense[np.diag_indices(n)] += np.linspace(1, 50, n)
    Aj, At = csr_both(dense)
    xstar = smoothed_manufactured_solution(rng, dense)
    b = dense @ xstar
    Mj, Mt = diag_both(1.0 / np.diag(dense)) if precond else (None, None)
    xj, ij = js.minres_solve(Aj, jnp.asarray(b), tol=1e-13, history=True, M=Mj)
    xt, it = st.minres_solve(At, torch.from_numpy(b), tol=1e-13, history=True, M=Mt)
    x = same(xj, ij, xt, it)
    assert np.abs(x - xstar).max() < 1e-9
    k = it.iterations
    hj, ht = np.asarray(ij.history), it.history.numpy()
    assert ht.shape == hj.shape == (10 * n,)
    assert np.isfinite(ht[:k]).all() and np.isnan(ht[k:]).all() and np.isnan(hj[k:]).all()
    assert rel(ht[:k], hj[:k]) <= 1e-8
    assert float(it.residual_norm) == ht[k - 1]
    if precond:
        _, plain = st.minres_solve(At, torch.from_numpy(b), tol=1e-13)
        assert k < plain.iterations


# -- CGLS ------------------------------------------------------------------------


def test_cgls_overdetermined_least_squares(rng):
    """tests/test_solvers.py:652."""
    n, m = 60, 24
    dense = np.where(rng.random((n, m)) < 0.3, rng.standard_normal((n, m)), 0.0)
    dense[np.arange(m), np.arange(m)] += 3.0
    Aj, At = csr_both(dense)
    b = rng.standard_normal(n)
    xj, ij = js.cgls_solve(Aj, jnp.asarray(b), tol=1e-13, history=True)
    xt, it = st.cgls_solve(At, torch.from_numpy(b), tol=1e-13, history=True)
    x = same(xj, ij, xt, it)
    np.testing.assert_allclose(x, np.linalg.lstsq(dense, b, rcond=None)[0], atol=1e-9)
    assert np.linalg.norm(dense.T @ (b - dense @ x)) < 1e-10
    k = it.iterations
    assert it.history.shape == (10 * m,) and np.isnan(it.history[k:].numpy()).all()
    assert rel(it.history[:k].numpy(), np.asarray(ij.history)[:k]) <= 1e-8


def test_cgls_minimum_norm_underdetermined(rng):
    """tests/test_solvers.py:670."""
    n, m = 20, 50
    dense = rng.standard_normal((n, m))
    Aj, At = csr_both(dense)
    b = dense @ (dense.T @ rng.standard_normal(n))
    xj, ij = js.cgls_solve(Aj, jnp.asarray(b), tol=1e-12)
    xt, it = st.cgls_solve(At, torch.from_numpy(b), tol=1e-12)
    x = same(xj, ij, xt, it)
    np.testing.assert_allclose(x, np.linalg.lstsq(dense, b, rcond=None)[0], atol=1e-8)


def test_cgls_square_spd_matches_cg(rng):
    """tests/test_solvers.py:684, on DIA storage: rmatvec runs through the
    transposed layout."""
    dense = random_spd_laplacian(rng, 48)
    Aj, At = dia_both(dense)
    b = rng.standard_normal(48)
    xj, ij = js.cgls_solve(Aj, jnp.asarray(b), tol=1e-12)
    xt, it = st.cgls_solve(At, torch.from_numpy(b), tol=1e-12)
    x = same(xj, ij, xt, it)
    x_cg, _ = st.cg_solve(At, torch.from_numpy(b), tol=1e-14)
    np.testing.assert_allclose(x, x_cg.numpy(), atol=1e-8)


def test_cgls_preconditioned_and_solver_protocol(rng):
    """tests/test_solvers.py:694: a column-space diagonal M cuts the count;
    ``cgls()`` runs through the solver protocol."""
    n, m = 80, 30
    dense = np.where(rng.random((n, m)) < 0.25, rng.standard_normal((n, m)), 0.0)
    dense *= 10.0 ** rng.uniform(-2, 2, size=m)
    dense[np.arange(m), np.arange(m)] += 1.0
    Aj, At = csr_both(dense)
    b = rng.standard_normal(n)
    Mj, Mt = diag_both(1.0 / (dense * dense).sum(axis=0))
    kw = dict(tol=1e-11, maxiter=2000)
    xj, ij = js.cgls_solve(Aj, jnp.asarray(b), M=Mj, **kw)
    xt, it = st.cgls_solve(At, torch.from_numpy(b), M=Mt, **kw)
    x = same(xj, ij, xt, it)
    x_ref = np.linalg.lstsq(dense, b, rcond=None)[0]
    np.testing.assert_allclose(x, x_ref, atol=1e-6)
    # unpreconditioned, the normal equations' condition number (~3e5)
    # parts the two packages' iterates from iteration 11 on (163 and 167
    # iterations to the tolerance): that solve is held to x_ref only
    xu, iu = st.cgls_solve(At, torch.from_numpy(b), **kw)
    assert it.iterations <= iu.iterations and iu.converged
    np.testing.assert_allclose(xu.numpy(), x_ref, atol=1e-6)
    xj, ij = js.cgls(tolerance=1e-11, maxiter=2000).solve_info(Aj, jnp.asarray(b), M=Mj)
    xt, it = st.cgls(tolerance=1e-11, maxiter=2000).solve_info(At, torch.from_numpy(b), M=Mt)
    x = same(xj, ij, xt, it)
    np.testing.assert_allclose(x, x_ref, atol=1e-6)
    x = st.cgls(tolerance=1e-11, maxiter=2000).solve(At, torch.from_numpy(b))
    np.testing.assert_allclose(x.numpy(), x_ref, atol=1e-6)


# -- FGMRES ----------------------------------------------------------------------


def test_fgmres_fixed_m_matches_gmres(rng):
    """tests/test_solvers.py:738: with a fixed linear M, FGMRES and GMRES
    take the same count, in both packages."""
    n = 600
    dense = nonsym_banded(rng, n)
    Aj, At = dia_both(dense)
    b = dense @ rng.standard_normal(n)
    Mj, Mt = diag_both(1.0 / np.diag(dense))
    kw = dict(tol=0.0, rtol=1e-12, restart=30, maxiter=300)
    xgj, igj = js.gmres_solve(Aj, jnp.asarray(b), M=Mj, **kw)
    xgt, igt = st.gmres_solve(At, torch.from_numpy(b), M=Mt, **kw)
    xfj, ifj = js.fgmres_solve(Aj, jnp.asarray(b), M=Mj, **kw)
    xft, ift = st.fgmres_solve(At, torch.from_numpy(b), M=Mt, **kw)
    same(xgj, igj, xgt, igt)
    xf = same(xfj, ifj, xft, ift)
    assert ift.iterations == igt.iterations
    assert np.abs(xgt.numpy() - xf).max() < 1e-8
    assert np.linalg.norm(dense @ xf - b) < 1e-9 * np.linalg.norm(b)


def test_fgmres_inner_krylov_and_attached_solver(rng):
    """tests/test_solvers.py:760 and :850: an inner fixed-count BiCG-stab
    as M, given as a lambda and as ``attach_solver(A, bicgstab(0, 4))``,
    whose ``solve`` (not ``matvec``) must be the application: both take
    the same count as each other and as the JAX package, fewer than
    unpreconditioned FGMRES."""
    n = 600
    dense = nonsym_banded(rng, n)
    Aj, At = dia_both(dense)
    b = dense @ rng.standard_normal(n)
    kw = dict(tol=0.0, rtol=1e-10, restart=30, maxiter=300)
    xpj, ipj = js.fgmres_solve(Aj, jnp.asarray(b), **kw)
    xpt, ipt = st.fgmres_solve(At, torch.from_numpy(b), **kw)
    same(xpj, ipj, xpt, ipt)
    xlj, ilj = js.fgmres_solve(
        Aj, jnp.asarray(b),
        M=lambda v: js.bicgstab_solve(Aj, v, tol=0.0, rtol=0.0, maxiter=4)[0], **kw)
    xlt, ilt = st.fgmres_solve(
        At, torch.from_numpy(b),
        M=lambda v: st.bicgstab_solve(At, v, tol=0.0, rtol=0.0, maxiter=4)[0], **kw)
    x = same(xlj, ilj, xlt, ilt)
    assert ilt.iterations < ipt.iterations
    assert np.linalg.norm(dense @ x - b) < 1e-8 * np.linalg.norm(b)
    Msj = jax_attach(Aj, js.bicgstab(tolerance=0.0, maxiter=4))
    Mst = st.attach_solver(At, st.bicgstab(tolerance=0.0, maxiter=4))
    xaj, iaj = js.fgmres_solve(Aj, jnp.asarray(b), M=Msj, **kw)
    xat, iat = st.fgmres_solve(At, torch.from_numpy(b), M=Mst, **kw)
    same(xaj, iaj, xat, iat)
    assert iat.iterations == ilt.iterations
    assert torch.equal(xat, xlt)


# -- stationary iteration, Jacobi, the solver objects --------------------------


def test_jacobi_as_solver_and_preconditioner(rng):
    """tests/test_solvers.py:121: Richardson with Jacobi for 10 n steps,
    Jacobi-preconditioned CG through ``cg()``, and ``jacobi()`` as a
    one-scaling solver."""
    n = 128
    dense = random_spd_laplacian(rng, n)
    Aj, At = csr_both(dense)
    v = smoothed_manufactured_solution(rng, dense)
    f = dense @ v
    Mj, Mt = js.jacobi().setup(Aj), st.jacobi().setup(At)
    assert isinstance(Mt, st.DiagonalOperator)
    assert rel(Mt.diag.numpy(), np.asarray(Mj.diag)) == 0.0
    xj, ij = js.stationary_solve(Aj, jnp.asarray(f), Mj, steps=10 * n)
    xt, it = st.stationary_solve(At, torch.from_numpy(f), Mt, steps=10 * n)
    x = same(xj, ij, xt, it)
    assert it.iterations == 10 * n and np.abs(x - v).max() < 1e-14
    xj, ij = js.cg(1e-16).solve_info(Aj, jnp.asarray(f), M=js.jacobi())
    xt, it = st.cg(1e-16).solve_info(At, torch.from_numpy(f), M=st.jacobi())
    x = same(xj, ij, xt, it)
    assert np.abs(x - v).max() < 1e-15
    xj, ij = js.jacobi().solve_info(Aj, jnp.asarray(f))
    xt, it = st.jacobi().solve_info(At, torch.from_numpy(f))
    same(xj, ij, xt, it, tol=0.0)
    assert it.iterations == 1
    np.testing.assert_allclose(float(it.residual_norm), float(ij.residual_norm), rtol=1e-12)


def test_stationary_diverges_to_not_finite():
    """converged only says that the residual is finite."""
    dense = np.array([[1.0, 0.0], [0.0, 1.0]])
    Aj, At = csr_both(dense)
    Mj, Mt = diag_both(np.full(2, 1e200))
    b = np.ones(2)
    xj, ij = js.stationary_solve(Aj, jnp.asarray(b), Mj, steps=3)
    xt, it = st.stationary_solve(At, torch.from_numpy(b), Mt, steps=3)
    assert it.iterations == int(ij.iterations) == 3
    assert it.converged is bool(ij.converged) is False


def test_jacobi_skew_perturbation_bicgstab(rng):
    """tests/test_solvers.py:137: a skew perturbation, BiCG-stab +
    jacobi() through ``bicgstab()``."""
    n = 128
    dense = random_spd_laplacian(rng, n)
    skew = np.where(dense != 0, np.triu(rng.standard_normal((n, n)), 1) * 0.1, 0.0)
    dense = dense + skew - skew.T
    Aj, At = csr_both(dense)
    v = rng.random(n)
    f = dense @ v
    xj, ij = js.bicgstab(1e-14).solve_info(Aj, jnp.asarray(f), M=js.jacobi())
    xt, it = st.bicgstab(1e-14).solve_info(At, torch.from_numpy(f), M=st.jacobi())
    x = same(xj, ij, xt, it, tol=1e-12)
    assert np.abs(x - v).max() < 1e-10


def test_jacobi_zero_diagonal_passes_through():
    d = np.array([2.0, 0.0, 4.0])
    Aj, At = csr_both(np.diag(d) + np.eye(3, k=1))
    Mj, Mt = js.jacobi().setup(Aj), st.jacobi().setup(At)
    np.testing.assert_array_equal(Mt.diag.numpy(), np.asarray(Mj.diag))
    np.testing.assert_array_equal(Mt.diag.numpy(), [0.5, 1.0, 0.25])


def test_solver_objects_defaults_and_preconditioner_contract():
    """The factories' differing default tolerances; prepare_preconditioner
    takes an operator, a solver-like object or None, else raises."""
    for name, tol in (("cg", 1e-15), ("bicgstab", 1e-12), ("gmres", 1e-12), ("cgls", 1e-12)):
        got, want = getattr(st, name)(), getattr(js, name)()
        assert type(got).__name__ == type(want).__name__
        assert got.tolerance == want.tolerance == tol
        assert got == getattr(st, name)()  # frozen, hashable configs
        hash(got)
    assert st.gmres().restart == js.gmres().restart == 32
    D = st.DiagonalOperator(torch.ones(3, dtype=torch.float64))
    assert st.prepare_preconditioner(None, D) is None
    assert st.prepare_preconditioner(D, D) is D
    with pytest.raises(TypeError):
        st.prepare_preconditioner(object(), D)
    with pytest.raises(NotImplementedError):
        st.LinearSolver().solve(D, torch.ones(3, dtype=torch.float64))


@pytest.mark.parametrize("solver", ["cg", "bicgstab", "gmres"])
def test_solver_as_nested_preconditioner(rng, solver):
    """tests/test_solvers.py:265: a fixed-count inner solver's ``setup(A)``
    preconditions an outer flexible CG, with the right-hand side normalised
    before the inner solve; its rmatvec solves against A^T."""
    n = 120
    d = 3 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    Aj, At = csr_both(d)
    cfg = {"cg": "CGSolver", "bicgstab": "BiCGStabSolver", "gmres": "GMRESSolver"}[solver]
    kw = dict(tolerance=0.0, maxiter=8) if solver != "gmres" else dict(tolerance=0.0, maxiter=4)
    Mj = getattr(js, cfg)(**kw).setup(Aj)
    Mt = getattr(st, cfg)(**kw).setup(At)
    xstar = rng.standard_normal(n)
    b = d @ xstar
    xj, ij = js.cg_solve(Aj, jnp.asarray(b), tol=1e-12, M=Mj, flexible=True)
    xt, it = st.cg_solve(At, torch.from_numpy(b), tol=1e-12, M=Mt, flexible=True)
    x = same(xj, ij, xt, it)
    assert np.abs(x - xstar).max() < 1e-8
    _, plain = st.cg_solve(At, torch.from_numpy(b), tol=1e-12)
    assert it.iterations < plain.iterations
    r = rng.standard_normal(n)
    np.testing.assert_allclose(Mt.rmatvec(torch.from_numpy(r)).numpy(),
                               np.asarray(Mj.rmatvec(jnp.asarray(r))), rtol=1e-10, atol=1e-13)
    assert not Mt.matvec(torch.zeros(n, dtype=torch.float64)).any()


# -- the solve facade and attach_solver ----------------------------------------


def test_solve_facade_and_attached_solver(rng):
    """tests/test_solvers.py:241: ``A.solve(b, solver=cg(...))`` and
    ``attach_solver(A, cg(...), preconditioner=jacobi())``."""
    n = 64
    dense = random_spd_laplacian(rng, n)
    Aj, At = csr_both(dense)
    b = rng.standard_normal(n)
    want = np.linalg.solve(dense, b)
    xj = Aj.solve(jnp.asarray(b), solver=js.cg(1e-14))
    xt = At.solve(torch.from_numpy(b), solver=st.cg(1e-14))
    assert rel(xt.numpy(), np.asarray(xj)) <= 1e-10
    np.testing.assert_allclose(xt.numpy(), want, atol=1e-10)
    # **kw configures the default CG
    xj = Aj.solve(jnp.asarray(b), tolerance=1e-14)
    xt = At.solve(torch.from_numpy(b), tolerance=1e-14)
    assert rel(xt.numpy(), np.asarray(xj)) <= 1e-10
    Bj = jax_attach(Aj, js.cg(1e-14), preconditioner=js.jacobi())
    Bt = st.attach_solver(At, st.cg(1e-14), preconditioner=st.jacobi())
    assert isinstance(Bt, st.OperatorWithSolver) and Bt.shape == At.shape
    assert torch.equal(Bt.matvec(torch.from_numpy(b)), At.matvec(torch.from_numpy(b)))
    xj, xt = Bj.solve(jnp.asarray(b)), Bt.solve(torch.from_numpy(b))
    assert rel(xt.numpy(), np.asarray(xj)) <= 1e-10
    np.testing.assert_allclose(xt.numpy(), want, atol=1e-10)
    # the attached solver's counts, with the attached M, with M disabled
    # (None: unpreconditioned, not the attached one) and with another solver
    for case in ("attached", "preconditioner=None", "solver=bicgstab"):
        other = case == "solver=bicgstab"
        sj = js.bicgstab(1e-13) if other else Bj.solver
        stt = st.bicgstab(1e-13) if other else Bt.solver
        pj = None if case == "preconditioner=None" else Bj.preconditioner
        pt = None if case == "preconditioner=None" else Bt.preconditioner
        kwj = {"solver": sj} if other else {"preconditioner": None} if pj is None else {}
        kwt = {"solver": stt} if other else {"preconditioner": None} if pt is None else {}
        xj, ij = sj.solve_info(Aj, jnp.asarray(b), M=pj)
        xt, it = stt.solve_info(At, torch.from_numpy(b), M=pt)
        same(xj, ij, xt, it)
        assert torch.equal(Bt.solve(torch.from_numpy(b), **kwt), xt)
        assert rel(np.asarray(Bj.solve(jnp.asarray(b), **kwj)), np.asarray(xj)) == 0.0
    _, i_pc = st.cg(1e-14).solve_info(At, torch.from_numpy(b), M=st.jacobi())
    _, i_none = st.cg(1e-14).solve_info(At, torch.from_numpy(b))
    assert i_pc.iterations != i_none.iterations  # the two cases above differ


def test_solve_facade_rejects_kw_with_a_solver():
    """sigma_tpu/operators/linear_operator.py:120-128: solver parameters
    with an explicit solver raise TypeError in both packages."""
    dense = np.diag([2.0, 3.0, 4.0])
    Aj, At = csr_both(dense)
    with pytest.raises(TypeError):
        Aj.solve(jnp.ones(3), solver=js.cg(), tolerance=1e-3)
    with pytest.raises(TypeError, match="tolerance"):
        At.solve(torch.ones(3, dtype=torch.float64), solver=st.cg(), tolerance=1e-3)
    with pytest.raises(TypeError):
        st.attach_solver(At, st.cg()).solve(torch.ones(3, dtype=torch.float64), tolerance=1e-3)


# -- refined_solve ----------------------------------------------------------------


def test_refined_solve_f64_from_f32_inner(rng):
    """tests/test_solvers.py:418: an f32 inner CG reaches the f64 1e-12
    tolerance in a few sweeps.  The f32 inner solves of the two packages
    round differently, so x agrees to the accuracy of the f64 solve (both
    within 1e-9 of xstar), the sweep counts exactly."""
    n = 256
    dense, _ = laplacian_1d(n)
    Aj, At = csr_both(dense)
    xstar = rng.standard_normal(n)
    b = dense @ xstar
    xj, ij = js.refined_solve(Aj, jnp.asarray(b), tol=1e-12)
    xt, it = st.refined_solve(At, torch.from_numpy(b), tol=1e-12)
    assert it.iterations == int(ij.iterations) <= 10
    assert it.converged and bool(ij.converged)
    assert np.abs(xt.numpy() - xstar).max() < 1e-9
    assert np.abs(np.asarray(xj) - xstar).max() < 1e-9
    assert float(it.residual_norm) <= 1e-12 and it.residual_norm.dtype == torch.float64


def test_refined_solve_f64_inner_matches_jax(rng):
    """With an f64 inner solve the two packages' sweeps are the same
    arithmetic: equal counts and x to 1e-10."""
    n = 200
    dense, _ = laplacian_1d(n)
    dense = dense + np.diag(1.0 + 0.05 * rng.standard_normal(n))
    Aj, At = csr_both(dense)
    b = dense @ rng.standard_normal(n)
    kw = dict(tol=1e-12, inner_tol=1e-3, inner_maxiter=50)
    xj, ij = js.refined_solve(Aj, jnp.asarray(b), inner_dtype=jnp.float64, **kw)
    xt, it = st.refined_solve(At, torch.from_numpy(b), inner_dtype=torch.float64, **kw)
    same(xj, ij, xt, it)
    assert it.iterations > 2


@pytest.mark.parametrize("case", ["bf16_operator", "nonsymmetric_bicgstab"])
def test_refined_solve_low_precision_operator(rng, case):
    """tests/test_solvers.py:438 and :485: a bf16-valued A_lo with f32
    inner vectors, and a nonsymmetric system refined through inner
    BiCG-stab on a bf16 A_lo with f64 vectors."""
    if case == "bf16_operator":
        n = 256
        dense, _ = laplacian_1d(n)
        dense = dense + np.diag(1.0 + 0.1 * rng.standard_normal(n))
        kwj = dict(tol=1e-10, inner_dtype=jnp.float32, inner_tol=1e-3, inner_maxiter=600)
        kwt = dict(tol=1e-10, inner_dtype=torch.float32, inner_tol=1e-3, inner_maxiter=600)
        err = 1e-7
    else:
        n = 200
        dense, _ = laplacian_1d(n)
        dense = (dense + 0.4 * (np.eye(n, k=1) - np.eye(n, k=-1))
                 + np.diag(1.0 + 0.05 * rng.standard_normal(n)))
        kwj = dict(tol=1e-11, inner_dtype=jnp.float64, inner_tol=1e-4, inner_maxiter=2000,
                   inner_solver=js.bicgstab_solve)
        kwt = dict(tol=1e-11, inner_dtype=torch.float64, inner_tol=1e-4, inner_maxiter=2000,
                   inner_solver=st.bicgstab_solve)
        err = 1e-8
    Aj, At = csr_both(dense)
    A_lo = At.astype(torch.bfloat16)
    assert not torch.equal(A_lo.data.double(), At.data)  # the cast rounds
    xstar = rng.standard_normal(n)
    b = dense @ xstar
    xj, ij = js.refined_solve(Aj, jnp.asarray(b), A_lo=Aj.astype(jnp.bfloat16), **kwj)
    xt, it = st.refined_solve(At, torch.from_numpy(b), A_lo=A_lo, **kwt)
    assert it.iterations == int(ij.iterations)
    assert it.converged and bool(ij.converged)
    assert np.abs(xt.numpy() - xstar).max() < err
    assert np.abs(np.asarray(xj) - xstar).max() < err
    if case != "bf16_operator":  # f64 vectors: the same arithmetic
        assert rel(xt.numpy(), np.asarray(xj)) <= 1e-10


def _poisson_coo(dims):
    n = int(np.prod(dims))
    coords = np.unravel_index(np.arange(n), dims)
    strides = [int(np.prod(dims[ax + 1:])) for ax in range(len(dims))]
    idx = np.arange(n)
    rows, cols, vals = [idx], [idx], [np.full(n, 2.0 * len(dims))]
    for ax in range(len(dims)):
        for s in (1, -1):
            mk = (coords[ax] + s >= 0) & (coords[ax] + s < dims[ax])
            rows.append(idx[mk])
            cols.append(idx[mk] + s * strides[ax])
            vals.append(np.full(mk.sum(), -1.0))
    return n, np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def test_refined_solve_gmg_scale_invariant():
    """tests/test_gmg.py:315-356: f64 refinement with an f32 GMG-CG inner
    solve; a 1e-10-scaled right-hand side takes the same sweeps (the
    residual is scaled to unit norm before the low-precision solve)."""
    dims = (16, 16, 16)
    n, r, c, v = _poisson_coo(dims)
    Aj = sigma_tpu.DIAMatrix.from_coo(n, n, r, c, v, dtype=jnp.float64)
    At = st.DIAMatrix.from_coo(n, n, r, c, v, dtype=torch.float64, device="cpu")
    Mj = js.structured_pair_amg(Aj.astype(jnp.float32), dims, pairs_per_level=3)
    Mt = st.structured_pair_amg(At.astype(torch.float32), dims, pairs_per_level=3)
    b = At.to_dense() @ np.random.default_rng(3).standard_normal(n)
    out = {}
    for scale in (1.0, 1e-10):
        xj, ij = js.refined_solve(Aj, jnp.asarray(b * scale), tol=0.0, rtol=1e-12, M_lo=Mj)
        xt, it = st.refined_solve(At, torch.from_numpy(b * scale), tol=0.0, rtol=1e-12, M_lo=Mt)
        assert it.converged and bool(ij.converged)
        assert it.iterations == int(ij.iterations)
        out[scale] = (xt.numpy(), it.iterations)
    assert out[1.0][1] == out[1e-10][1]
    assert rel(out[1e-10][0] * 1e10, out[1.0][0]) < 1e-9


def test_refined_solve_stops_on_max_outer_and_takes_an_inner_solve():
    dense, _ = laplacian_1d(64)
    Aj, At = csr_both(dense)
    b = np.random.default_rng(5).standard_normal(64)
    kw = dict(tol=0.0, max_outer=2, inner_tol=1e-1, inner_maxiter=3)
    xj, ij = js.refined_solve(Aj, jnp.asarray(b), inner_dtype=jnp.float64, **kw)
    xt, it = st.refined_solve(At, torch.from_numpy(b), inner_dtype=torch.float64, **kw)
    same(xj, ij, xt, it, converged=False)
    assert it.iterations == 2
    # a ready inner solve (here the exact dense one) ends after one sweep
    inv = np.linalg.inv(dense)
    x, info = st.refined_solve(At, torch.from_numpy(b), tol=1e-12, inner_dtype=torch.float64,
                               inner_solve=lambda r: torch.from_numpy(inv @ r.numpy()))
    assert info.converged and info.iterations == 2
    np.testing.assert_allclose(x.numpy(), inv @ b, rtol=1e-12)


# -- structured_amg and the nonsymmetric stencil ---------------------------------


def test_structured_amg_factory_matches_jax():
    """tests/test_gmg.py:393: ``structured_amg(dims, ...).setup(A)``."""
    dims = (10, 8, 6)
    n, r, c, v = _poisson_coo(dims)
    Aj = sigma_tpu.DIAMatrix.from_coo(n, n, r, c, v, dtype=jnp.float64)
    At = st.DIAMatrix.from_coo(n, n, r, c, v, dtype=torch.float64, device="cpu")
    Fj = js.structured_amg(dims, pairs_per_level=3, coarse_size=16)
    Ft = st.structured_amg(dims, pairs_per_level=3, coarse_size=16)
    assert isinstance(Ft, st.StructuredAMGFactory) and Ft.dims == Fj.dims
    Mj, Mt = Fj.setup(Aj), Ft.setup(At)
    assert len(Mt.levels) == len(Mj.levels)
    b = np.random.default_rng(31).standard_normal(n)
    xj, ij = js.cg_solve(Aj, jnp.asarray(b), tol=1e-10, M=Mj, maxiter=1000)
    xt, it = st.cg_solve(At, torch.from_numpy(b), tol=1e-10, M=Mt, maxiter=1000)
    x = same(xj, ij, xt, it)
    assert np.linalg.norm(b - At.to_dense() @ x) < 1e-8
    # as a preconditioner object handed to a solver's M
    xj, ij = js.cg(1e-10).solve_info(Aj, jnp.asarray(b), M=Fj)
    xt, it = st.cg(1e-10).solve_info(At, torch.from_numpy(b), M=Ft)
    same(xj, ij, xt, it)


def test_gmg_bicgstab_on_the_upwinded_stencil():
    """tests/test_gmg.py:527: the upwinded stencil (the port's
    ``advection_diffusion_dia`` at nx = 16, beta = 10) with GMG-BiCG-stab
    and plain BiCG-stab, GMRES(32) and GMRES + GMG, counts equal to the
    JAX package's."""
    nx, bh = 16, 10.0 / 17.0
    n = nx**3
    idx = np.arange(n)
    iz, iy, ix = idx % nx, (idx // nx) % nx, idx // (nx * nx)
    rows, cols, vals = [idx], [idx], [np.full(n, 6.0 + 3 * bh)]
    for coord, stride in ((iz, 1), (iy, nx), (ix, nx * nx)):
        for s, c in ((1, 1.0), (-1, 1.0 + bh)):
            ok = (coord + s >= 0) & (coord + s < nx)
            rows.append(idx[ok])
            cols.append(idx[ok] + s * stride)
            vals.append(np.full(ok.sum(), -c))
    Aj = sigma_tpu.DIAMatrix.from_coo(n, n, np.concatenate(rows), np.concatenate(cols),
                                      np.concatenate(vals), dtype=jnp.float64)
    At = st.advection_diffusion_dia(nx, 10.0, torch.float64, device="cpu")
    np.testing.assert_array_equal(At.to_dense(), np.asarray(Aj.to_dense()))
    xstar = np.random.default_rng(6).standard_normal(n)
    b = At.to_dense() @ xstar
    dims = (nx, nx, nx)
    Mj, Mt = js.structured_pair_amg(Aj, dims), st.structured_amg(dims).setup(At)
    counts = {}
    for label, fj, ft, kw in (
        ("bicgstab", js.bicgstab_solve, st.bicgstab_solve, dict(tol=1e-9, maxiter=1000)),
        ("bicgstab_gmg", js.bicgstab_solve, st.bicgstab_solve, dict(tol=1e-9, maxiter=1000)),
        ("gmres", js.gmres_solve, st.gmres_solve, dict(tol=1e-9, restart=32, maxiter=1000)),
        ("gmres_gmg", js.gmres_solve, st.gmres_solve, dict(tol=1e-9, restart=32, maxiter=1000)),
    ):
        gmg = label.endswith("gmg")
        xj, ij = fj(Aj, jnp.asarray(b), M=Mj if gmg else None, **kw)
        xt, it = ft(At, torch.from_numpy(b), M=Mt if gmg else None, **kw)
        x = same(xj, ij, xt, it)
        assert np.abs(x - xstar).max() < 1e-7
        counts[label] = it.iterations
    assert counts["bicgstab_gmg"] * 3 <= counts["bicgstab"]
    assert counts["gmres_gmg"] * 3 <= counts["gmres"]
