"""The port's CG and fused CG held against the JAX package in f64: equal
iteration counts, solutions within 1e-10 relative, and the 1-D diffusion
oracle of the reference test suite (max error < 1e-14)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu
from sigma_tpu.operators import DiagonalOperator as JaxDiag
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
    At = st.DIAMatrix.from_coo(n, n, *coo, dtype=torch.float64)
    return Aj, At


def _lap3d(nx):
    A = st.laplacian_3d_dia(nx, torch.float64)
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
