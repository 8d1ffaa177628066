"""``graphed(minres_solve)``, ``graphed(cgls_solve)``,
``graphed(stationary_solve)``, ``graphed(block_cg_solve)`` and
``graphed(fgmres_solve)`` on the CPU: the plain version of the captured
loop (MINRES, CGLS, the stationary iteration and block CG in blocks of
iterations over two buffer sets, FGMRES one restart cycle a replay) held
bit for bit against the eager solvers (x, iteration count, residual norm,
``converged``, history), and the eager solvers against the JAX package's
jitted solves (equal counts, x within 1e-10 relative), in f64: the
Dirichlet Poisson and Laplacian + I stencils, the upwinded
advection-diffusion stencil and the indefinite shifted 1-D Laplacian of
``tests/test_torch_solvers.py``, with no preconditioner, Jacobi,
structured GMG, a plain callable and an attached inner solve as M.  Also
that ``graphed`` keeps every solver's signature."""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu
import sigma_tpu.solvers as js
from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix as JaxSym
from sigma_tpu.operators import attach_solver as jax_attach
import sigma_tpu_torch as st
from sigma_tpu_torch.solvers.graphed import BLOCK


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


class Counted:
    """``A`` with its matvecs counted: an FGMRES solve makes one a step,
    one a cycle and one at set-up, so the count gives the cycles."""

    def __init__(self, A):
        self.A, self.shape, self.calls = A, A.shape, 0

    def matvec(self, x):
        self.calls += 1
        return self.A.matvec(x)


def _richardson(A, Minv, v, sweeps=3):
    """``sweeps`` Jacobi-preconditioned Richardson sweeps on A z = v from
    z = 0: a preconditioner that is a plain callable with no host read,
    the same operations in both packages."""
    z = Minv.matvec(v)
    for _ in range(sweeps - 1):
        z = z + Minv.matvec(v - A.matvec(z))
    return z


@functools.lru_cache(maxsize=None)
def operators(kind, nx, precond):
    """An operator in both packages and a preconditioner in each (None
    for none): ``poisson`` (symmetric storage, diagonal 6), ``lap_i``
    (Laplacian + I, full storage), ``advdiff`` (beta 10) on nx^3, or
    ``indefinite``, the shifted 1-D Laplacian of n = nx rows (CSR)."""
    if kind == "indefinite":
        n, dx = nx, 1.0 / (nx + 1)
        dense = (np.diag(np.full(n, 2.0)) - np.eye(n, k=1) - np.eye(n, k=-1)
                 - 1.001 * 4 * np.sin(3 * np.pi * dx / 2) ** 2 * np.eye(n))
        r, c = np.nonzero(dense)
        return (st.CSRMatrix.from_coo(n, n, r, c, dense[r, c], dtype=torch.float64, device="cpu"),
                sigma_tpu.CSRMatrix.from_coo(n, n, r, c, dense[r, c], dtype=jnp.float64),
                None, None)
    if kind == "advdiff":
        A = st.advection_diffusion_dia(nx, 10.0, torch.float64, device="cpu")
    else:
        A = st.laplacian_3d_dia(nx, torch.float64, device="cpu",
                                diag=6.0 if kind == "poisson" else 7.0)
    n = A.shape[0]
    Aj = sigma_tpu.DIAMatrix.from_coo(n, n, *A.entries(), dtype=jnp.float64)
    if kind == "poisson":
        A, Aj = st.SymmetricDIAMatrix.from_dia(A), JaxSym.from_dia(Aj)
    dims = (nx,) * 3
    if precond is None:
        return A, Aj, None, None
    if precond == "jacobi":
        return A, Aj, st.jacobi().setup(A), js.jacobi().setup(Aj)
    if precond == "gmg":
        if kind == "advdiff":
            return (A, Aj, st.structured_amg(dims, pairs_per_level=3).setup(A),
                    js.structured_amg(dims, pairs_per_level=3).setup(Aj))
        return (A, Aj, st.structured_pair_amg(A, dims, pairs_per_level=3),
                js.structured_pair_amg(Aj, dims, pairs_per_level=3))
    Mt, Mj = st.jacobi().setup(A), js.jacobi().setup(Aj)
    if precond == "richardson":
        return (A, Aj, functools.partial(_richardson, A, Mt),
                functools.partial(_richardson, Aj, Mj))
    assert precond == "attached"  # a 4-step inner BiCG-stab
    return (A, Aj, st.attach_solver(A, st.bicgstab(tolerance=0.0, maxiter=4)),
            jax_attach(Aj, js.bicgstab(tolerance=0.0, maxiter=4)))


SOLVERS = {
    "minres": (st.minres_solve, js.minres_solve),
    "cgls": (st.cgls_solve, js.cgls_solve),
    "stationary": (st.stationary_solve, js.stationary_solve),
    "block_cg": (st.block_cg_solve, js.block_cg_solve),
    "fgmres": (st.fgmres_solve, js.fgmres_solve),
}

# name: (solver, operator, nx, preconditioner, keywords, x0, zero right-hand side)
CASES = {
    "minres_poisson_history": ("minres", "poisson", 8, None, {"history": True}, False, False),
    "minres_poisson_gmg": ("minres", "poisson", 8, "gmg", {}, False, False),
    "minres_x0_gmg": ("minres", "poisson", 6, "gmg", {"history": True}, True, False),
    # converges past the first block, maxiter not a multiple of it
    "minres_past_one_block": ("minres", "poisson", 10, None,
                              {"rtol": 1e-13, "maxiter": 1000, "history": True}, False, False),
    "minres_stopped_by_maxiter": ("minres", "poisson", 10, None,
                                  {"rtol": 1e-15, "maxiter": BLOCK + 5}, False, False),
    "minres_zero_rhs": ("minres", "poisson", 6, "gmg", {}, False, True),
    # ROADMAP.md's stated deviation: counts held equal at tol 1e-6
    "minres_indefinite": ("minres", "indefinite", 200, None,
                          {"tol": 1e-6, "rtol": 0.0, "maxiter": 1000}, False, False),
    "cgls_advdiff_history": ("cgls", "advdiff", 6, None, {"history": True}, False, False),
    "cgls_advdiff_jacobi": ("cgls", "advdiff", 6, "jacobi", {}, False, False),
    "cgls_x0": ("cgls", "advdiff", 6, None, {}, True, False),
    # stopped 138 iterations short of rtol 1e-10.  CGLS's iterates part
    # from the JAX package's by rounding that grows mid-solve and shrinks
    # again at convergence (at nx = 8 the same stop gives 9e-10, iteration
    # 45 4e-8, the converged x 4e-11); at nx = 10 iteration 39 precedes
    # that growth (1e-13)
    "cgls_stopped_by_maxiter": ("cgls", "advdiff", 10, None,
                                {"maxiter": BLOCK + 7, "history": True}, False, False),
    "cgls_zero_rhs": ("cgls", "advdiff", 6, "jacobi", {}, False, True),
    "stationary_jacobi_past_one_block": ("stationary", "advdiff", 8, "jacobi",
                                         {"steps": BLOCK + 13}, False, False),
    "stationary_jacobi_below_block": ("stationary", "poisson", 6, "jacobi", {"steps": 5},
                                      False, False),
    "stationary_two_whole_blocks_x0": ("stationary", "lap_i", 6, "jacobi",
                                       {"steps": 2 * BLOCK}, True, False),
    "stationary_gmg": ("stationary", "poisson", 8, "gmg", {"steps": 7}, False, False),
    "stationary_no_steps": ("stationary", "advdiff", 6, "jacobi", {"steps": 0}, False, False),
    "block_cg_cols": ("block_cg", "lap_i", 8, None, {"panels": "cols"}, False, False),
    # 343 rows: the interleaved layout pads its last 128-row block
    "block_cg_interleaved": ("block_cg", "lap_i", 7, None, {"panels": "interleaved"},
                             False, False),
    "block_cg_gmg_cols": ("block_cg", "poisson", 8, "gmg", {"panels": "cols"}, False, False),
    "block_cg_gmg_interleaved": ("block_cg", "poisson", 8, "gmg", {"panels": "interleaved"},
                                 False, False),
    "block_cg_x0_auto": ("block_cg", "lap_i", 6, None, {}, True, False),
    "block_cg_past_one_block": ("block_cg", "poisson", 10, None,
                                {"rtol": 1e-13, "maxiter": 1000, "panels": "interleaved"},
                                False, False),
    "block_cg_stopped_by_maxiter": ("block_cg", "poisson", 10, None,
                                    {"rtol": 1e-15, "maxiter": BLOCK + 5, "panels": "cols"},
                                    False, False),
    "block_cg_zero_rhs": ("block_cg", "poisson", 6, "gmg", {"panels": "cols"}, False, True),
    "fgmres8_jacobi_cycles": ("fgmres", "advdiff", 8, "jacobi", {"restart": 8}, False, False),
    "fgmres32_gmg": ("fgmres", "advdiff", 8, "gmg", {"restart": 32}, False, False),
    "fgmres8_callable_cycles": ("fgmres", "advdiff", 8, "richardson", {"restart": 8},
                                False, False),
    "fgmres8_attached_x0": ("fgmres", "advdiff", 6, "attached", {"restart": 8}, True, False),
    # stopped by maxiter in the middle of the second cycle
    "fgmres8_maxiter_mid_cycle": ("fgmres", "advdiff", 8, None,
                                  {"restart": 8, "rtol": 1e-14, "maxiter": 13}, False, False),
    "fgmres32_zero_rhs": ("fgmres", "advdiff", 6, "jacobi", {"restart": 32}, False, True),
}

RHS = {"block_cg": 4}  # right-hand sides a block


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


def _call(fn, A, b, x0, M, solver, kw):
    if solver == "stationary":
        return fn(A, b, M, x0, **kw)
    return fn(A, b, x0, M=M, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_krylov_equals_eager_and_matches_jax(case):
    solver, kind, nx, precond, kw, with_x0, zero_b = CASES[case]
    ft, fj = SOLVERS[solver]
    A, Aj, M, Mj = operators(kind, nx, precond)
    n = A.shape[0]
    rng = np.random.default_rng(nx)
    shape = (n, RHS[solver]) if solver in RHS else (n,)
    b = np.zeros(shape) if zero_b else rng.standard_normal(shape)
    x0 = rng.standard_normal(shape) if with_x0 else None
    if solver != "stationary":
        kw = {"tol": 0.0, "rtol": 1e-10, **kw}
    bt = torch.from_numpy(b)
    x0t = None if x0 is None else torch.from_numpy(x0.copy())

    G = st.graphed(ft)
    Ac = Counted(A)
    if solver == "fgmres":
        want = _call(ft, Ac, bt, x0t, M, solver, kw)
    else:
        want = _call(ft, A, bt, x0t, M, solver, kw)
    got = _call(G, A, bt, x0t, M, solver, kw)
    _assert_same(got, want)
    x, info = got
    if solver == "fgmres":
        cycles = Ac.calls - 1 - info.iterations
        assert cycles == (0 if zero_b else -(-info.iterations // kw["restart"]))
        assert G.host_reads == max(1, cycles)  # one read a restart cycle
    else:
        assert G.host_reads == max(1, -(-info.iterations // BLOCK))
    assert not G.captured  # the CPU runs the plain version
    if x0 is not None:
        assert np.array_equal(x0t.numpy(), x0)  # the buffers are copies
    _assert_same(_call(G, A, bt, x0t, M, solver, kw), want)  # a second call, the same bits

    jx0 = None if x0 is None else jnp.asarray(x0)
    if solver == "stationary":
        xj, ij = jax.jit(lambda b, x0: fj(Aj, b, Mj, x0, **kw))(jnp.asarray(b), jx0)
    else:
        xj, ij = jax.jit(lambda b, x0: fj(Aj, b, x0, M=Mj, **kw))(jnp.asarray(b), jx0)
    assert info.iterations == int(ij.iterations)
    assert info.converged == bool(ij.converged)
    assert rel(x, xj) <= 1e-10
    if zero_b:
        assert info.iterations == 0 and info.converged
    if "stopped_by_maxiter" in case or "mid_cycle" in case:
        assert info.iterations == kw["maxiter"] and not info.converged
    if "past_one_block" in case:
        assert info.iterations > BLOCK and info.converged
    if solver == "stationary":
        assert info.iterations == kw["steps"] and info.converged
    if "cycles" in case:
        assert info.iterations > kw["restart"]  # more than one cycle
    if case == "block_cg_past_one_block":
        assert info.iterations < kw["maxiter"]


ALL = ("cg_solve", "cg_fused_solve", "bicgstab_solve", "minres_solve", "gmres_solve",
       "fgmres_solve", "cgls_solve", "stationary_solve", "block_cg_solve")


@pytest.mark.parametrize("name", ALL)
def test_graphed_keeps_every_solvers_signature(name):
    ft = getattr(st, name)
    G = st.graphed(ft)
    assert inspect.signature(G) == inspect.signature(ft)
    assert G.__name__ == ft.__name__ == name
    with pytest.raises(TypeError):
        G(operators("poisson", 6, None)[0], torch.ones(216, dtype=torch.float64), bogus=1)
