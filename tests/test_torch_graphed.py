"""``graphed(cg_solve)`` and ``graphed(cg_fused_solve)`` on the CPU: the
plain version of the captured loop (the same init / cond / body in the
same block schedule and buffers) held bit for bit against the eager
solvers (x, iteration count, residual norm, ``converged``, history) and
against the JAX package's jitted solves (equal counts, x within 1e-12
relative), on 3-D Poisson stencils in full and symmetric DIA storage, with
no preconditioner and with structured GMG (Jacobi and Chebyshev), in f64."""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu
from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix as JaxSym
from sigma_tpu.solvers import cg_fused_solve as jax_cg_fused
from sigma_tpu.solvers import cg_solve as jax_cg
from sigma_tpu.solvers import structured_pair_amg as jax_amg
import sigma_tpu_torch as st
from sigma_tpu_torch.solvers.graphed import BLOCK


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


SOLVERS = {"cg": (st.cg_solve, jax_cg), "cg_fused": (st.cg_fused_solve, jax_cg_fused)}
N_SMOOTH = {"jacobi": 1, "chebyshev": 4}


@functools.lru_cache(maxsize=None)
def operators(nx, symmetric, smoother):
    """The Dirichlet Poisson stencil on nx^3 in both packages, and their
    GMG hierarchies (None without a smoother)."""
    A = st.laplacian_3d_dia(nx, torch.float64, device="cpu", diag=6.0)
    n = A.shape[0]
    Aj = sigma_tpu.DIAMatrix.from_coo(n, n, *A.entries(), dtype=jnp.float64)
    if symmetric:
        A, Aj = st.SymmetricDIAMatrix.from_dia(A), JaxSym.from_dia(Aj)
    if smoother is None:
        return A, Aj, None, None
    kw = dict(smoother=smoother, n_smooth=N_SMOOTH[smoother], pairs_per_level=3)
    return A, Aj, st.structured_pair_amg(A, (nx,) * 3, **kw), jax_amg(Aj, (nx,) * 3, **kw)


# name: (solver, nx, symmetric, smoother, keywords, x0, zero b)
CASES = {
    "cg_dia": ("cg", 8, False, None, {}, False, False),
    "cg_sym": ("cg", 8, True, None, {}, False, False),
    "fused_dia": ("cg_fused", 8, False, None, {}, False, False),
    "fused_sym": ("cg_fused", 8, True, None, {}, False, False),
    "cg_sym_jacobi": ("cg", 8, True, "jacobi", {}, False, False),
    "cg_dia_chebyshev": ("cg", 8, False, "chebyshev", {}, False, False),
    "fused_sym_chebyshev": ("cg_fused", 8, True, "chebyshev", {}, False, False),
    "fused_dia_jacobi": ("cg_fused", 8, False, "jacobi", {}, False, False),
    "cg_flexible_sym_jacobi": ("cg", 6, True, "jacobi", {"flexible": True}, False, False),
    "cg_flexible_dia": ("cg", 6, False, None, {"flexible": True}, False, False),
    "cg_history_dia": ("cg", 6, False, None, {"history": True}, False, False),
    "fused_history_sym_jacobi": ("cg_fused", 6, True, "jacobi", {"history": True}, False, False),
    "cg_x0_sym": ("cg", 10, True, None, {}, True, False),
    "fused_x0_dia_chebyshev": ("cg_fused", 6, False, "chebyshev", {}, True, False),
    # maxiter below BLOCK: stops unconverged in the first block
    "cg_maxiter_below_block": ("cg", 8, True, None, {"maxiter": 5}, False, False),
    "fused_maxiter_below_block_jacobi": ("cg_fused", 8, False, "jacobi", {"maxiter": 3},
                                         False, False),
    # maxiter past one block and not a multiple of it: stops unconverged
    # in the second block
    "cg_unconverged_at_maxiter": ("cg", 10, False, None, {"maxiter": BLOCK + 5, "rtol": 1e-14},
                                  False, False),
    "fused_unconverged_at_maxiter": ("cg_fused", 10, True, None,
                                     {"maxiter": BLOCK + 5, "rtol": 1e-14}, False, False),
    # converges past the first block, maxiter not a multiple of it
    "cg_converges_past_one_block": ("cg", 10, True, None, {"maxiter": 1000, "rtol": 1e-14,
                                                           "history": True}, False, False),
    "fused_converges_past_one_block": ("cg_fused", 10, False, None,
                                       {"maxiter": 1000, "rtol": 1e-14}, False, False),
    # b = 0 meets the tolerance at iteration 0
    "cg_zero_rhs_jacobi": ("cg", 6, True, "jacobi", {}, False, True),
    "fused_zero_rhs": ("cg_fused", 6, False, None, {}, False, True),
}


def _assert_same(got, want):
    (x, info), (y, ref) = got, want
    assert torch.equal(x, y)
    assert info.iterations == ref.iterations
    assert torch.equal(info.residual_norm, ref.residual_norm)
    assert info.converged == ref.converged
    if ref.history is None:
        assert info.history is None
    else:
        assert torch.equal(info.history.nan_to_num(-1.0), ref.history.nan_to_num(-1.0))


@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_equals_eager_and_matches_jax(case):
    solver, nx, symmetric, smoother, kw, with_x0, zero_b = CASES[case]
    ft, fj = SOLVERS[solver]
    A, Aj, M, Mj = operators(nx, symmetric, smoother)
    n = A.shape[0]
    rng = np.random.default_rng(nx)
    b = np.zeros(n) if zero_b else rng.standard_normal(n)
    x0 = rng.standard_normal(n) if with_x0 else None
    kw = {"tol": 0.0, "rtol": 1e-10, **kw}
    bt = torch.from_numpy(b)
    x0t = None if x0 is None else torch.from_numpy(x0.copy())

    G = st.graphed(ft)
    got = G(A, bt, x0t, M=M, **kw)
    want = ft(A, bt, x0t, M=M, **kw)
    _assert_same(got, want)
    x, info = got
    assert G.host_reads == max(1, -(-info.iterations // BLOCK))
    assert not G.captured  # the CPU runs the plain version
    if x0 is not None:
        assert np.array_equal(x0t.numpy(), x0)  # the buffers are copies
    _assert_same(G(A, bt, x0t, M=M, **kw), want)  # a second call, the same bits

    jkw = {k: v for k, v in kw.items()}
    jx0 = None if x0 is None else jnp.asarray(x0)
    xj, ij = jax.jit(lambda b, x0: fj(Aj, b, x0, M=Mj, **jkw))(jnp.asarray(b), jx0)
    assert info.iterations == int(ij.iterations)
    assert info.converged == bool(ij.converged)
    assert rel(x, xj) <= 1e-12
    if zero_b:
        assert info.iterations == 0 and info.converged
    if kw.get("maxiter") not in (None, 1000):
        assert info.iterations == kw["maxiter"] and not info.converged
    if "past_one_block" in case:
        assert BLOCK < info.iterations < kw["maxiter"] and info.converged


GRAPHED = {"cg": st.cg_solve, "cg_fused": st.cg_fused_solve, "bicgstab": st.bicgstab_solve,
           "gmres": st.gmres_solve}


@pytest.mark.parametrize("solver", sorted(GRAPHED))
def test_graphed_keeps_the_solvers_signature(solver):
    ft = GRAPHED[solver]
    G = st.graphed(ft)
    assert inspect.signature(G) == inspect.signature(ft)
    assert G.__name__ == ft.__name__
    with pytest.raises(TypeError):
        G(*operators(6, False, None)[:1], torch.ones(216, dtype=torch.float64), bogus=1)


@pytest.mark.parametrize(
    "name", ["refined_solve", "refined_solve_fixed", "lobpcg", "lanczos", "generalized_lanczos"])
def test_graphed_refuses_other_solvers(name):
    with pytest.raises(TypeError, match="ROADMAP.md"):
        st.graphed(getattr(st, name))


def test_graphed_exported_at_both_levels():
    import sigma_tpu_torch.solvers

    assert "graphed" in sigma_tpu_torch.solvers.__all__
    assert st.graphed is sigma_tpu_torch.solvers.graphed
    assert BLOCK % 2 == 0  # a full block ends in the buffer set it began from
