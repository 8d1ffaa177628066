"""The port's CG, fused CG and BiCG-stab held against the JAX package in
f64: equal iteration counts, solutions within 1e-10 relative (BiCG-stab:
1e-12), the 1-D diffusion and advection-diffusion oracles of the
reference test suite, and BiCG-stab on the unstructured operator that
``auto_pruned_preconditioner`` routes to "plain"."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu
from sigma_tpu.operators import DiagonalOperator as JaxDiag
from sigma_tpu.matrix.banded import reorder_triples_rcm as jax_reorder
from sigma_tpu.matrix.pruned import PrunedDIAMatrix as JaxPruned
from sigma_tpu.solvers import auto_pruned_preconditioner as jax_auto_pruned
from sigma_tpu.solvers import bicgstab_solve as jax_bicgstab
from sigma_tpu.solvers import cg_fused_solve as jax_cg_fused
from sigma_tpu.solvers import cg_solve as jax_cg
import sigma_tpu_torch as st


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def diffusion_1d(n):
    """tridiag(-1, 2, -1) and the RHS whose exact discrete solution is the
    parabola x (1 - x) (reference test solver_test_diffusion_1d)."""
    dx = 1.0 / (n + 1)
    i = np.arange(n)
    rows = np.concatenate([i, i[:-1], i[1:]])
    cols = np.concatenate([i, i[1:], i[:-1]])
    vals = np.concatenate([np.full(n, 2.0), np.full(n - 1, -1.0), np.full(n - 1, -1.0)])
    f = np.full(n, 2.0 * dx**2)
    grid = np.arange(1, n + 1) * dx
    return (rows, cols, vals), f, grid * (1.0 - grid)


def both(coo, n):
    Aj = sigma_tpu.DIAMatrix.from_coo(n, n, *coo, dtype=jnp.float64)
    At = st.DIAMatrix.from_coo(n, n, *coo, dtype=torch.float64, device="cpu")
    return Aj, At


def _lap3d(nx):
    A = st.laplacian_3d_dia(nx, torch.float64, device="cpu")
    r, c, v = A.entries()
    return (r, c, v), A.shape[0]


SOLVERS = {
    "cg": (jax_cg, st.cg_solve, {}),
    "cg_flexible": (jax_cg, st.cg_solve, {"flexible": True}),
    "cg_fused": (jax_cg_fused, st.cg_fused_solve, {}),
}


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_diffusion_1d_matches_jax_and_oracle(solver):
    fj, ft, kw = SOLVERS[solver]
    n = 127
    coo, f, exact = diffusion_1d(n)
    Aj, At = both(coo, n)
    xj, ij = fj(Aj, jnp.asarray(f), tol=1e-16, **kw)
    xt, it = ft(At, torch.from_numpy(f), tol=1e-16, **kw)
    assert it.converged and bool(ij.converged)
    assert it.iterations == int(ij.iterations)
    assert np.abs(xt.numpy() - exact).max() < 1e-14
    assert rel(xt, xj) <= 1e-10


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_laplacian_3d_matches_jax(solver, precond):
    fj, ft, kw = SOLVERS[solver]
    coo, n = _lap3d(7)
    Aj, At = both(coo, n)
    xstar = np.sin(0.1 * np.arange(n))
    b = At.to_dense() @ xstar
    Mj = Mt = None
    if precond:  # Jacobi: z = D^-1 r
        dinv = 1.0 / At.diagonal().numpy()
        Mj, Mt = JaxDiag(jnp.asarray(dinv)), st.DiagonalOperator(torch.from_numpy(dinv))
    xj, ij = fj(Aj, jnp.asarray(b), tol=0.0, rtol=1e-10, M=Mj, history=True, **kw)
    xt, it = ft(At, torch.from_numpy(b), tol=0.0, rtol=1e-10, M=Mt, history=True, **kw)
    assert it.converged and bool(ij.converged)
    assert it.iterations == int(ij.iterations)
    assert rel(xt, xj) <= 1e-10
    hj, ht = np.asarray(ij.history), it.history.numpy()
    k = it.iterations
    assert ht.shape == hj.shape == (10 * n,)
    assert np.isnan(ht[k:]).all() and np.isnan(hj[k:]).all()
    assert rel(ht[:k], hj[:k]) <= 1e-8
    assert abs(float(it.residual_norm) - float(ij.residual_norm)) <= 1e-8 * ht[0]


def test_maxiter_stops_unconverged():
    coo, n = _lap3d(5)
    Aj, At = both(coo, n)
    b = np.ones(n)
    xj, ij = jax_cg(Aj, jnp.asarray(b), tol=0.0, rtol=1e-14, maxiter=3)
    xt, it = st.cg_solve(At, torch.from_numpy(b), tol=0.0, rtol=1e-14, maxiter=3)
    assert it.iterations == int(ij.iterations) == 3
    assert not it.converged and not bool(ij.converged)
    assert rel(xt, xj) <= 1e-12
    assert it.history is None


def advection_diffusion_1d(n, c):
    """tridiag(-1 - c dx/2, 2, -1 + c dx/2), the RHS 2 dx^2 and the exact
    solution of the continuous problem (reference test
    solver_test_advection_diffusion_1d)."""
    dx = 1.0 / (n + 1)
    i = np.arange(n)
    rows = np.concatenate([i, i[:-1], i[1:]])
    cols = np.concatenate([i, i[1:], i[:-1]])
    vals = np.concatenate([
        np.full(n, 2.0), np.full(n - 1, -1.0 + c * dx / 2), np.full(n - 1, -1.0 - c * dx / 2)
    ])
    grid = np.arange(1, n + 1) * dx
    exact = 2.0 * (grid - (np.exp(c * grid) - 1) / (np.exp(c) - 1)) / c
    return (rows, cols, vals), np.full(n, 2.0 * dx**2), exact


def check_bicgstab(Aj, At, b, Mj=None, Mt=None, **kw):
    """Both BiCG-stab solves with history: equal iteration counts, results
    within 1e-12 relative, equal residual histories; returns the port's x."""
    xj, ij = jax_bicgstab(Aj, jnp.asarray(b), M=Mj, history=True, **kw)
    xt, it = st.bicgstab_solve(At, torch.from_numpy(b), M=Mt, history=True, **kw)
    assert it.converged and bool(ij.converged)
    assert it.iterations == int(ij.iterations) > 0
    assert rel(xt, xj) <= 1e-12
    hj, ht = np.asarray(ij.history), it.history.numpy()
    k = it.iterations
    assert ht.shape == hj.shape and np.isnan(ht[k:]).all() and np.isnan(hj[k:]).all()
    assert rel(ht[:k], hj[:k]) <= 1e-8
    assert float(it.residual_norm) == ht[k - 1]
    return xt.numpy()


def test_bicgstab_advection_diffusion_1d_matches_jax_and_oracle():
    """The reference's n = 1024 case.  Unpreconditioned, the method
    amplifies rounding on it: the two packages' iterates, equal to 1e-14
    after one iteration, part by 3e-13 after 5 and 7e-12 after 8, as any
    two summation orders would, and the full solves end after different
    counts (about 1100 and 1060).  So the iterates are held equal over the
    first 5 iterations, and the full solve to the oracle in both
    packages."""
    n = 1024
    coo, f, exact = advection_diffusion_1d(n, 0.5)
    Aj, At = both(coo, n)
    kw = dict(tol=0.0, maxiter=5)
    xj, ij = jax_bicgstab(Aj, jnp.asarray(f), history=True, **kw)
    xt, it = st.bicgstab_solve(At, torch.from_numpy(f), history=True, **kw)
    assert it.iterations == int(ij.iterations) == 5 and not it.converged
    assert rel(xt, xj) <= 1e-12
    assert rel(it.history.numpy(), np.asarray(ij.history)) <= 1e-12
    xj, ij = jax_bicgstab(Aj, jnp.asarray(f), tol=1e-12)
    xt, it = st.bicgstab_solve(At, torch.from_numpy(f), tol=1e-12)
    assert it.converged and bool(ij.converged)
    assert np.abs(xt.numpy() - exact).max() < 1e-8
    assert np.abs(np.asarray(xj) - exact).max() < 1e-8


def test_bicgstab_skew_perturbation_with_jacobi_matches_jax():
    """An ER-graph Laplacian + I with a skew perturbation on its pattern,
    Jacobi-preconditioned (reference test solver_test_jacobi's follow-up)."""
    rng = np.random.default_rng(0)
    n = 128
    mask = np.triu(rng.random((n, n)) < np.log2(n) / n, k=1)
    z = np.where(mask, rng.random((n, n)), 0.0)
    off = z + z.T
    dense = np.diag(1.0 + off.sum(axis=1)) - off
    skew = np.where(dense != 0, np.triu(rng.standard_normal((n, n)), 1) * 0.1, 0.0)
    dense = dense + skew - skew.T
    rows, cols = np.nonzero(dense)
    Aj, At = both((rows, cols, dense[rows, cols]), n)
    v = rng.random(n)
    dinv = 1.0 / np.diag(dense)
    Mj, Mt = JaxDiag(jnp.asarray(dinv)), st.DiagonalOperator(torch.from_numpy(dinv))
    x = check_bicgstab(Aj, At, dense @ v, Mj, Mt, tol=1e-14)
    assert np.abs(x - v).max() < 1e-10


def test_bicgstab_on_the_plain_route_matches_jax():
    """The unstructured operator whose skew part dominates: both packages
    route it to "plain" (no preconditioner) and BiCG-stab solves it on
    pruned storage in the same number of iterations."""
    n, r, c, v = st.irregular_mesh_laplacian_coo(64, 16, rng=np.random.default_rng(0),
                                                 shift=1e-3, shuffle=True)
    r, c, v, _ = jax_reorder(n, r, c, v)
    v = v * np.sign(c - r + 0.5)  # the off-diagonal part skew
    kw = dict(coarse_size=64, tile_rows=1024)
    Mt, info = st.auto_pruned_preconditioner(n, r, c, v, device="cpu", **kw)
    Mj, jinfo = jax_auto_pruned(n, r, c, v, **kw)
    assert Mt is None and Mj is None and info == jinfo and info["route"] == "plain"
    Aj = JaxPruned.from_coo(n, n, r, c, v, tile_rows=1024, assume_unique=True)
    At = st.PrunedDIAMatrix.from_coo(n, n, r, c, v, tile_rows=1024, assume_unique=True,
                                     device="cpu")
    b = np.random.default_rng(1).standard_normal(n)
    x = check_bicgstab(Aj, At, b, tol=0.0, rtol=1e-10, maxiter=500)
    dense = np.zeros((n, n))
    dense[r, c] = v
    assert np.linalg.norm(dense @ x - b) <= 1e-10 * np.linalg.norm(b)


def test_bicgstab_maxiter_and_breakdown():
    """maxiter stops an unconverged solve as the JAX package's does; a zero
    right-hand side takes no iteration; the non-finite-omega guard keeps
    x finite when t = A s vanishes."""
    coo, f, _ = advection_diffusion_1d(64, 0.5)
    Aj, At = both(coo, 64)
    xj, ij = jax_bicgstab(Aj, jnp.asarray(f), tol=0.0, rtol=1e-14, maxiter=3)
    xt, it = st.bicgstab_solve(At, torch.from_numpy(f), tol=0.0, rtol=1e-14, maxiter=3)
    assert it.iterations == int(ij.iterations) == 3 and not it.converged
    assert rel(xt, xj) <= 1e-12 and it.history is None
    x0, i0 = st.bicgstab_solve(At, torch.zeros(64, dtype=torch.float64))
    assert i0.iterations == 0 and i0.converged and not x0.any()
    # A = I, b = e_0: s = 0 after the first half step, so t = 0, omega is
    # 0 / 0 and the guard makes it 0; x is the exact solution
    I = st.DIAMatrix.from_coo(4, 4, np.arange(4), np.arange(4), np.ones(4),
                              dtype=torch.float64, device="cpu")
    Ij = sigma_tpu.DIAMatrix.from_coo(4, 4, np.arange(4), np.arange(4), np.ones(4),
                                      dtype=jnp.float64)
    e0 = np.eye(4)[0]
    xt, it = st.bicgstab_solve(I, torch.from_numpy(e0), tol=0.0, maxiter=2)
    xj, ij = jax_bicgstab(Ij, jnp.asarray(e0), tol=0.0, maxiter=2)
    assert np.array_equal(xt.numpy(), e0) and np.array_equal(np.asarray(xj), e0)
    assert it.iterations == int(ij.iterations)
