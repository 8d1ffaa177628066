"""The port's block CG held against the JAX package in f64: the column and
the interleaved panel layouts, the structured-multigrid preconditioner
(whose blockwise apply is one V-cycle per column in both packages), equal
iteration counts, and the single-RHS case against ``cg_solve``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu
from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix as JaxSym
from sigma_tpu.solvers import block_cg_solve as jax_block_cg
from sigma_tpu.solvers import structured_pair_amg as jax_amg
import sigma_tpu_torch as st


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


DIMS = (6, 7, 9)  # n = 378: unaligned to 128, so the interleaved layout pads


def poisson_pair(diag=6.0, symmetric=False):
    """The 7-point Dirichlet Laplacian on DIMS with ``diag`` on the main
    diagonal, in both packages (f64)."""
    n = int(np.prod(DIMS))
    coords = np.unravel_index(np.arange(n), DIMS)
    strides = (DIMS[1] * DIMS[2], DIMS[2], 1)
    idx = np.arange(n)
    rows, cols, vals = [idx], [idx], [np.full(n, diag)]
    for ax in range(3):
        for s in (1, -1):
            mk = (coords[ax] + s >= 0) & (coords[ax] + s < DIMS[ax])
            rows.append(idx[mk])
            cols.append(idx[mk] + s * strides[ax])
            vals.append(np.full(mk.sum(), -1.0))
    r, c, v = (np.concatenate(a) for a in (rows, cols, vals))
    Aj = sigma_tpu.DIAMatrix.from_coo(n, n, r, c, v, dtype=jnp.float64)
    At = st.DIAMatrix.from_coo(n, n, r, c, v, dtype=torch.float64, device="cpu")
    if symmetric:
        return JaxSym.from_dia(Aj), st.SymmetricDIAMatrix.from_dia(At)
    return Aj, At


@pytest.mark.parametrize("symmetric", [False, True], ids=["full", "symmetric"])
@pytest.mark.parametrize("panels", ["cols", "interleaved", "auto"])
def test_block_cg_matches_jax_f64(panels, symmetric):
    Aj, At = poisson_pair(diag=6.5, symmetric=symmetric)
    n, s = At.shape[0], 5
    B = np.random.default_rng(1).standard_normal((n, s))
    Xj, ij = jax_block_cg(Aj, jnp.asarray(B), tol=1e-10, panels=panels)
    Xt, it = st.block_cg_solve(At, torch.from_numpy(B), tol=1e-10, panels=panels)
    assert it.converged and bool(ij.converged)
    assert it.iterations == int(ij.iterations)
    assert Xt.shape == (n, s)
    assert np.abs(Xt.numpy() - np.asarray(Xj)).max() <= 1e-10
    assert abs(float(it.residual_norm) - float(ij.residual_norm)) <= 1e-12
    assert np.linalg.norm(B - At.to_dense() @ Xt.numpy()) <= 1e-10


def test_block_cg_layouts_take_the_same_iterations():
    """As the JAX package asserts for its layouts: the interleaved algebra
    is the same arithmetic as the column one."""
    _, At = poisson_pair(diag=6.5)
    B = torch.from_numpy(np.random.default_rng(2).standard_normal((At.shape[0], 4)))
    Xc, ic = st.block_cg_solve(At, B, tol=1e-10, panels="cols")
    Xi, ii = st.block_cg_solve(At, B, tol=1e-10, panels="interleaved")
    assert ic.iterations == ii.iterations
    assert rel(Xi, Xc) <= 1e-10


@pytest.mark.parametrize("panels", ["cols", "interleaved"])
def test_gmg_preconditioned_block_cg_matches_jax_f64(panels):
    Aj, At = poisson_pair(symmetric=True)
    Mj = jax_amg(Aj, DIMS, pairs_per_level=3)
    Mt = st.structured_pair_amg(At, DIMS, pairs_per_level=3)
    n, s = At.shape[0], 4
    B = np.random.default_rng(3).standard_normal((n, s))
    Xj, ij = jax_block_cg(Aj, jnp.asarray(B), tol=1e-10, M=Mj, panels=panels)
    Xt, it = st.block_cg_solve(At, torch.from_numpy(B), tol=1e-10, M=Mt, panels=panels)
    assert it.converged
    assert it.iterations == int(ij.iterations)
    assert np.abs(Xt.numpy() - np.asarray(Xj)).max() <= 1e-10
    # the preconditioner does its work: fewer iterations than without
    _, plain = st.block_cg_solve(At, torch.from_numpy(B), tol=1e-10, panels=panels)
    assert it.iterations < plain.iterations


def test_gmg_matmat_is_one_cycle_per_column_as_jax():
    Aj, At = poisson_pair(symmetric=True)
    Mj = jax_amg(Aj, DIMS, pairs_per_level=3, smoother="chebyshev", n_smooth=2)
    Mt = st.structured_pair_amg(At, DIMS, pairs_per_level=3, smoother="chebyshev", n_smooth=2)
    R = np.random.default_rng(4).standard_normal((At.shape[0], 3))
    Z = Mt.matmat(torch.from_numpy(R))
    assert rel(Z, Mj.matmat(jnp.asarray(R))) <= 1e-12
    assert rel(Mt.rmatmat(torch.from_numpy(R)), Z) == 0.0
    for j in range(3):
        assert rel(Z[:, j], Mt.matvec(torch.from_numpy(R[:, j].copy()))) == 0.0


def test_block_cg_single_rhs_matches_cg():
    _, At = poisson_pair(diag=6.5)
    b = torch.from_numpy(np.random.default_rng(5).standard_normal(At.shape[0]))
    x_cg, i_cg = st.cg_solve(At, b, tol=1e-12)
    X, info = st.block_cg_solve(At, b[:, None], tol=1e-12)
    assert info.converged and i_cg.converged
    assert info.iterations == i_cg.iterations
    assert np.abs(X[:, 0].numpy() - x_cg.numpy()).max() <= 1e-10


def test_block_cg_keeps_the_best_iterate_and_rejects_bad_panels():
    _, At = poisson_pair(diag=6.5)
    B = torch.from_numpy(np.random.default_rng(6).standard_normal((At.shape[0], 3)))
    X, info = st.block_cg_solve(At, B, tol=1e-10, maxiter=3)
    assert info.iterations == 3 and not info.converged
    assert float(info.residual_norm) == pytest.approx(
        float(torch.linalg.vector_norm(B - At.matmat(X))), rel=1e-10
    )
    with pytest.raises(ValueError, match="panels"):
        st.block_cg_solve(At, B, panels="rows")
