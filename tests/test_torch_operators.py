"""The port's operator algebra held against the JAX package's: the same
composite expressions over the same dense factors give the same
products, transposed products and dense mirrors (f64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu
import sigma_tpu_torch as st


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _factors(pkg, arr):
    rng = np.random.default_rng(2)
    A, B, C = (rng.standard_normal((6, 6)) for _ in range(3))
    R = rng.standard_normal((6, 4))
    d = rng.standard_normal(6)
    return {
        "A": pkg.aslinearoperator(arr(A)),
        "B": pkg.DenseOperator(arr(B)),
        "C": pkg.aslinearoperator(arr(C)),
        "R": pkg.DenseOperator(arr(R)),
        "D": pkg.DiagonalOperator(arr(d)),
        "I": pkg.IdentityOperator(6),
        "F": pkg.MatvecOperator(arr(B), lambda p, x: p @ x, lambda p, x: p.T @ x, (6, 6)),
    }


EXPRESSIONS = {
    "sum": lambda o: o["A"] + o["B"] + o["D"],
    "difference": lambda o: o["A"] - o["F"],
    "product": lambda o: o["A"] @ o["B"] @ o["R"],
    "scaled": lambda o: 2.5 * o["A"] + o["I"] * 0.5,
    "negated_adjoint": lambda o: -(o["A"] @ o["C"]).T,
    "mixed": lambda o: (o["A"] + o["D"]).T @ o["C"] - o["I"],
}


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
def test_algebra_matches_jax(name):
    expr = EXPRESSIONS[name]
    opj = expr(_factors(sigma_tpu, jnp.asarray))
    opt = expr(_factors(st, torch.from_numpy))
    assert opt.shape == opj.shape
    n, m = opt.shape
    rng = np.random.default_rng(9)
    x, y = rng.standard_normal(m), rng.standard_normal(n)
    X = rng.standard_normal((m, 3))
    np.testing.assert_allclose(opt.matvec(torch.from_numpy(x)), opj.matvec(jnp.asarray(x)), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(opt.rmatvec(torch.from_numpy(y)), opj.rmatvec(jnp.asarray(y)), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(opt @ torch.from_numpy(X), opj @ jnp.asarray(X), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(opt.to_dense(), opj.to_dense(), rtol=1e-12, atol=1e-12)
    assert opt.device == torch.device("cpu")
    moved = opt.to("cpu")
    assert type(moved) is type(opt)
    np.testing.assert_array_equal(moved.to_dense(), opt.to_dense())


def test_shape_mismatch_raises():
    o = _factors(st, torch.from_numpy)
    with pytest.raises(ValueError, match="shape mismatch"):
        o["A"] + o["R"]
    with pytest.raises(ValueError, match="dimension mismatch"):
        o["R"] @ o["A"]
    with pytest.raises(NotImplementedError):
        st.MatvecOperator(None, lambda p, x: x, None, (6, 6)).rmatvec(torch.ones(6))


@pytest.mark.parametrize("name", ["sum", "scaled", "product"])
def test_get_value_probes_like_the_jax_package(name):
    """An operator without a lookup of its own answers get_value by a
    basis-vector matvec, as the reference's LinearOperator does."""
    expr = EXPRESSIONS[name]
    opj = expr(_factors(sigma_tpu, jnp.asarray))
    opt = expr(_factors(st, torch.from_numpy))
    dense = opt.to_dense()
    for i, j in ((0, 0), (2, 3), (5, 1), (opt.shape[0] - 1, opt.shape[1] - 1)):
        got = opt.get_value(i, j)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, float(opj.get_value(i, j)), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got, dense[i, j], rtol=1e-12, atol=1e-12)


def test_matrix_get_value_keeps_its_lookup():
    """The matrix classes answer from their stored entries, not by a
    matvec."""
    rng = np.random.default_rng(4)
    dense = np.where(rng.random((7, 7)) < 0.4, rng.standard_normal((7, 7)), 0.0)
    A = st.CSRMatrix.from_dense(dense, device="cpu")
    assert type(A).get_value is not st.LinearOperator.get_value
    assert all(A.get_value(i, j) == dense[i, j] for i in range(7) for j in range(7))
