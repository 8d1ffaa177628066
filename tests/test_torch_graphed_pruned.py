"""``graphed(cg_solve)``, ``graphed(bicgstab_solve)`` and
``graphed(block_cg_solve)`` with the pruned pair multigrid
(``pruned_pair_amg``) as M, on the CPU: the plain version of the captured
loop held bit for bit against the eager solve (x, iteration count,
residual norm, ``converged``, history, one host read a block) and against
the JAX package's jitted solves as ``benchmarks/unstructured_pruned.py``
and ``benchmarks/unstructured_nonsym.py`` jit them (equal counts, x within
1e-10 relative), in f64 on the small shuffled mesh of
``tests/test_torch_unstructured.py`` in full and symmetric pruned storage
and on the skewed mesh, both packages' hierarchies built from the same
numpy triples.  Also shift-invert Lanczos with a graphed inner solve,
against the eager inner solve (bitwise) and the JAX package's jitted one
(``benchmarks/eigen_unstructured.py``'s inner CG)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu.solvers as js
from sigma_tpu.eigen import shift_invert_lanczos as jax_shift_invert_lanczos
from sigma_tpu.matrix.pruned import PrunedDIAMatrix as JaxPruned
from sigma_tpu.matrix.pruned import SymmetricPrunedDIAMatrix as JaxSymPruned
from sigma_tpu.solvers import gmg as jax_gmg
import sigma_tpu_torch as st
from sigma_tpu_torch.eigen import shift_invert_lanczos
from sigma_tpu_torch.solvers.graphed import BLOCK
from test_torch_eigen import banded_spd

H, W, COARSE, TILE = 256, 16, 64, 1024  # n = 4096, 6 levels
N_SMOOTH = {"jacobi": 1, "chebyshev": 2}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@functools.lru_cache(maxsize=None)
def triples(kind, height):
    """RCM-reordered COO triples (n, rows, cols, vals): the shuffled
    irregular mesh (``"mesh"``) or the skew-perturbed one of
    ``benchmarks/unstructured_nonsym.py`` (``"skewed"``)."""
    if kind == "skewed":
        n, r, c, v = st.skewed_mesh_coo(height, W, seed=0)
    else:
        n, r, c, v = st.irregular_mesh_laplacian_coo(height, W, rng=np.random.default_rng(0),
                                                     shift=1e-3, shuffle=True)
    return (n, *st.reorder_triples_rcm(n, r, c, v)[:3])


@functools.lru_cache(maxsize=None)
def operators(kind, storage, smoother, height=H):
    """The operator in both packages' pruned storage (``"full"`` or
    ``"sym"``) and the pruned pair multigrid over it, level 0 the operator
    itself."""
    n, r, c, v = triples(kind, height)
    kw = dict(tile_rows=TILE, assume_unique=True)
    sym = storage == "sym"
    if sym:
        A = st.SymmetricPrunedDIAMatrix.from_coo(n, n, r, c, v, device="cpu", **kw)
        Aj = JaxSymPruned.from_coo(n, n, r, c, v, **kw)
    else:
        A = st.PrunedDIAMatrix.from_coo(n, n, r, c, v, device="cpu", **kw)
        Aj = JaxPruned.from_coo(n, n, r, c, v, **kw)
    amg = dict(coarse_size=COARSE, tile_rows=TILE, smoother=smoother,
               n_smooth=N_SMOOTH[smoother], symmetric=sym)
    M = st.pruned_pair_amg(n, r, c, v, fine_A=A, **amg)
    Mj = jax_gmg.pruned_pair_amg(n, r, c, v, fine_A=Aj, **amg)
    assert M.levels[0].A is A and len(M.levels) == len(Mj.levels)
    return A, Aj, M, Mj


SOLVERS = {"cg": (st.cg_solve, js.cg_solve), "bicgstab": (st.bicgstab_solve, js.bicgstab_solve),
           "block_cg": (st.block_cg_solve, js.block_cg_solve)}
RHS = {"block_cg": 4}  # right-hand sides a block

# name: (solver, mesh, storage, smoother, keywords, zero b, height)
CASES = {
    "cg_full_chebyshev_history": ("cg", "mesh", "full", "chebyshev", {"history": True}, False, H),
    "cg_full_jacobi": ("cg", "mesh", "full", "jacobi", {}, False, H),
    "cg_sym_chebyshev": ("cg", "mesh", "sym", "chebyshev", {}, False, H),
    "cg_sym_jacobi_history": ("cg", "mesh", "sym", "jacobi", {"history": True}, False, H),
    # 4,080 rows: the levels of 255 and 4,080 / 2^k rows pair an odd
    # extent's last row with the zero pad of the restriction
    "cg_full_odd_level_extents": ("cg", "mesh", "full", "chebyshev", {}, False, 255),
    # converges past the first block, maxiter not a multiple of it
    "cg_sym_past_one_block": ("cg", "mesh", "sym", "jacobi",
                              {"rtol": 1e-14, "maxiter": 1000, "history": True}, False, H),
    # stopped unconverged by maxiter in the second block
    "cg_full_stopped_by_maxiter": ("cg", "mesh", "full", "jacobi",
                                   {"rtol": 1e-16, "maxiter": BLOCK + 5}, False, H),
    # b = 0 meets the tolerance at iteration 0
    "cg_sym_zero_rhs": ("cg", "mesh", "sym", "chebyshev", {}, True, H),
    "bicgstab_skewed_jacobi": ("bicgstab", "skewed", "full", "jacobi", {}, False, 64),
    "bicgstab_skewed_chebyshev_history": ("bicgstab", "skewed", "full", "chebyshev",
                                          {"history": True}, False, 64),
    "block_cg_full_cols": ("block_cg", "mesh", "full", "chebyshev", {"panels": "cols"}, False,
                           H),
}


def _manufactured(kind, height, rhs=None):
    """b = A x* for the benchmarks' x*_i = sin(0.001 i) (a column j of a
    block: sin(0.001 (j + 1) i), as ``chip_smoke.py``'s phase 14)."""
    n, r, c, v = triples(kind, height)
    i = np.arange(n)
    X = np.sin(np.outer(i, np.arange(1, (rhs or 1) + 1)) * 0.001)
    B = np.zeros_like(X)
    np.add.at(B, r, v[:, None] * X[c])
    return B if rhs else B[:, 0]


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
def test_graphed_pruned_gmg_equals_eager_and_matches_jax(case):
    solver, kind, storage, smoother, kw, zero_b, height = CASES[case]
    ft, fj = SOLVERS[solver]
    A, Aj, M, Mj = operators(kind, storage, smoother, height)
    b = _manufactured(kind, height, RHS.get(solver))
    if zero_b:
        b = np.zeros_like(b)
    kw = {"tol": 0.0, "rtol": 1e-10, **kw}
    bt = torch.from_numpy(b)

    G = st.graphed(ft)
    got = G(A, bt, M=M, **kw)
    want = ft(A, bt, M=M, **kw)
    _assert_same(got, want)
    x, info = got
    assert G.host_reads == max(1, -(-info.iterations // BLOCK))
    assert not G.captured  # the CPU runs the plain version
    _assert_same(G(A, bt, M=M, **kw), want)  # a second call, the same bits

    xj, ij = jax.jit(lambda b: fj(Aj, b, M=Mj, **kw))(jnp.asarray(b))
    assert info.iterations == int(ij.iterations)
    assert info.converged == bool(ij.converged)
    assert rel(x, xj) <= 1e-10
    if zero_b:
        assert info.iterations == 0 and info.converged
    elif "stopped_by_maxiter" in case:
        assert info.iterations == kw["maxiter"] and not info.converged
    elif "past_one_block" in case:
        assert BLOCK < info.iterations < kw["maxiter"] and info.converged
    else:
        assert info.iterations > 0 and info.converged


def test_odd_level_extents_pad_the_restriction():
    """The 4,080-row hierarchy has levels of odd extent, whose restriction
    pads the last pair with a zero (``StructuredAMGPreconditioner._restrict``)."""
    A, _, M, _ = operators("mesh", "full", "chebyshev", 255)
    extents = [lv.dims[0] for lv in M.levels]
    assert any(e % 2 for e in extents), extents


def test_shift_invert_lanczos_with_a_graphed_inner_solve():
    """``tests/test_torch_eigen.py``'s shift-invert case with its inner
    pruned-multigrid CG run eagerly and through ``graphed(cg_solve)``
    (one graphed callable for every inner solve, as ``chip_smoke.py``'s
    phase 29): eigenvalues, residuals, steps and every inner solve's count
    and bits equal; against the JAX package's jitted inner solve within
    1e-10."""
    rng = np.random.default_rng(0)
    n = 2000
    dense, rows, cols, vals = banded_spd(rng, n, (1, 2, 7))
    sigma = 0.9 * np.linalg.eigvalsh(dense)[0]
    vs = vals.copy()
    vs[rows == cols] -= sigma
    vs = vs.astype(np.float32)
    pk = dict(tile_rows=1024, group=4)
    Ps = st.PrunedDIAMatrix.from_coo(n, n, rows, cols, vs, dtype=torch.float32, device="cpu",
                                     **pk)
    Mg = st.pruned_pair_amg(n, rows, cols, vs, coarse_size=512, device="cpu", **pk)
    kw = dict(tol=0.0, rtol=1e-6, maxiter=400)
    G = st.graphed(st.cg_solve)
    runs = {"eager": [], "graphed": []}

    def inner(label, solve):
        def apply(r32):
            x, info = solve(Ps, r32, M=Mg, **kw)
            runs[label].append((x, info.iterations, info.converged))
            if label == "graphed":
                assert G.host_reads == max(1, -(-info.iterations // BLOCK))
            return x
        return apply

    common = dict(sigma=sigma, m=3, k=24, device="cpu")
    eager = shift_invert_lanczos(n, rows, cols, vals, inner_solve=inner("eager", st.cg_solve),
                                 **common)
    graph = shift_invert_lanczos(n, rows, cols, vals, inner_solve=inner("graphed", G), **common)
    assert graph.steps == eager.steps == 24
    assert np.array_equal(graph.eigenvalues, eager.eigenvalues)
    assert np.array_equal(graph.residuals, eager.residuals)
    assert torch.equal(graph.eigenvectors, eager.eigenvectors)
    assert len(runs["graphed"]) == len(runs["eager"]) == 24 * 3
    for (x, k, c), (y, k2, c2) in zip(runs["graphed"], runs["eager"]):
        assert torch.equal(x, y) and k == k2 and c == c2 and c

    Psj = JaxPruned.from_coo(n, n, rows, cols, vs, dtype=np.float32, **pk)
    Mgj = js.pruned_pair_amg(n, rows, cols, vs, coarse_size=512, **pk)
    inner_j = jax.jit(lambda A_, M_, r_: js.cg_solve(A_, r_, M=M_, **kw)[0])
    res_j = jax_shift_invert_lanczos(
        n, rows, cols, vals, sigma=sigma, m=3, k=24,
        inner_solve=lambda r32: np.asarray(inner_j(Psj, Mgj, jnp.asarray(r32))))
    assert res_j.steps == graph.steps
    assert np.abs(graph.eigenvalues - res_j.eigenvalues).max() < 1e-10
    assert graph.residuals.max() < 1e-9 and res_j.residuals.max() < 1e-9
