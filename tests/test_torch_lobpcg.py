"""The port's LOBPCG held against the JAX package in f64 on a small 3-D
Dirichlet Poisson grid, with and without the structured multigrid
preconditioner, from the same numpy starting block.  The grid is 6 x 7 x 9,
so the lowest eigenvalues are simple: on a cube the triple second
eigenvalue leaves the iteration's stopping point at the mercy of rounding.

``eigh`` may return eigenvector signs that differ between the packages;
the subspaces are the same, so the tests compare eigenvalues, iteration
counts and sign-free quantities (residual norms, eigenvectors up to
sign), not raw vectors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.eigen import lobpcg as jax_lobpcg
from sigma_tpu.solvers import structured_pair_amg as jax_amg
import sigma_tpu
import sigma_tpu_torch as st


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


DIMS = (6, 7, 9)  # n = 378


def analytic_lowest(dims, count):
    """Lowest eigenvalues of the Dirichlet Laplacian on ``dims``: sums of
    4 sin^2(pi q / (2 (e + 1))) over the axes."""
    w = [4.0 * np.sin(np.pi * np.arange(1, e + 1) / (2.0 * (e + 1))) ** 2 for e in dims]
    return np.sort((w[0][:, None, None] + w[1][None, :, None] + w[2][None, None, :]).ravel())[:count]


def poisson_pair():
    n = int(np.prod(DIMS))
    coords = np.unravel_index(np.arange(n), DIMS)
    strides = (DIMS[1] * DIMS[2], DIMS[2], 1)
    idx = np.arange(n)
    rows, cols, vals = [idx], [idx], [np.full(n, 6.0)]
    for ax in range(3):
        for s in (1, -1):
            mk = (coords[ax] + s >= 0) & (coords[ax] + s < DIMS[ax])
            rows.append(idx[mk])
            cols.append(idx[mk] + s * strides[ax])
            vals.append(np.full(mk.sum(), -1.0))
    r, c, v = (np.concatenate(a) for a in (rows, cols, vals))
    Aj = sigma_tpu.DIAMatrix.from_coo(n, n, r, c, v, dtype=jnp.float64)
    At = st.DIAMatrix.from_coo(n, n, r, c, v, dtype=torch.float64, device="cpu")
    return Aj, At


@pytest.mark.parametrize("gmg", [False, True], ids=["plain", "gmg"])
def test_lobpcg_matches_jax_f64(gmg):
    Aj, At = poisson_pair()
    n, m = At.shape[0], 3
    X0 = np.random.default_rng(0).standard_normal((n, m))
    Mj = Mt = None
    if gmg:
        Mj = jax_amg(Aj, DIMS, pairs_per_level=3)
        Mt = st.structured_pair_amg(At, DIMS, pairs_per_level=3)
    rj = jax_lobpcg(Aj, jnp.asarray(X0), M=Mj, tol=1e-8, maxiter=300)
    rt = st.lobpcg(At, X0, M=Mt, tol=1e-8, maxiter=300)
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    np.testing.assert_allclose(rt.eigenvalues.numpy(), np.asarray(rj.eigenvalues), rtol=0, atol=1e-8)
    np.testing.assert_allclose(rt.eigenvalues.numpy(), analytic_lowest(DIMS, m), rtol=0, atol=1e-8)
    assert rt.residual_norms.max() <= 1e-8
    np.testing.assert_allclose(
        rt.residual_norms.numpy(), np.asarray(rj.residual_norms), rtol=0, atol=1e-10
    )
    V, Vj = rt.eigenvectors.numpy(), np.asarray(rj.eigenvectors)
    np.testing.assert_allclose(V.T @ V, np.eye(m), atol=1e-12)
    # the same eigenvectors up to sign
    np.testing.assert_allclose(np.abs(np.sum(V * Vj, axis=0)), 1.0, atol=1e-10)


def test_preconditioner_cuts_iterations():
    _, At = poisson_pair()
    X0 = np.random.default_rng(1).standard_normal((At.shape[0], 3))
    M = st.structured_pair_amg(At, DIMS, pairs_per_level=3)
    plain = st.lobpcg(At, X0, tol=1e-8, maxiter=300)
    pc = st.lobpcg(At, X0, M=M, tol=1e-8, maxiter=300)
    assert pc.converged and plain.converged
    assert pc.iterations < plain.iterations


def test_lobpcg_default_block_from_generator():
    _, At = poisson_pair()
    a = st.lobpcg(At, m=2, tol=1e-8, maxiter=300)
    b = st.lobpcg(At, m=2, tol=1e-8, maxiter=300,
                  generator=torch.Generator().manual_seed(0))
    assert a.converged and a.iterations == b.iterations
    assert torch.equal(a.eigenvalues, b.eigenvalues)
    np.testing.assert_allclose(a.eigenvalues.numpy(), analytic_lowest(DIMS, 2), atol=1e-8)


def test_lobpcg_block_size_validation():
    A = st.DIAMatrix.from_dense(np.eye(10), device="cpu")
    with pytest.raises(ValueError, match="3m < n"):
        st.lobpcg(A, m=4)
    with pytest.raises(ValueError, match="3m < n"):
        st.lobpcg(A, np.ones((10, 4)))
