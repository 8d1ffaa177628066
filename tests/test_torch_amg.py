"""The port's smoothed-aggregation AMG held against the JAX package on the
CPU in f64, after ``tests/test_amg.py``: aggregation (greedy and VMB,
host library and plain numpy version), the hierarchy, CG + AMG, the
V-cycle, the stationary iteration ``amg_solve``, the unsmoothed variant,
the hierarchy that collapses to its dense coarse solve, and a DIA fine
level.

The same numpy inputs go to both packages.  Aggregates equal exactly, and
so do the hierarchies' arrays (the same C++ on the same values); the
V-cycle agrees to 1e-12 relative, on each package's own set-up and on the
JAX hierarchy carried across by ``convert.amg_from_arrays``; solves take
equal iteration counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu as sj
import sigma_tpu.solvers as js
from sigma_tpu.solvers import amg as jamg
import sigma_tpu_torch as st
from sigma_tpu_torch import convert
from sigma_tpu_torch.graph.permutations import _adjacency
from sigma_tpu_torch.solvers import amg as tamg
from sigma_tpu_torch.utils import ordered_sum

from conftest import laplacian_2d
from test_torch_jax_host import jax_host_library

torch.set_num_threads(1)
jax_host_library()  # the bit-for-bit checks need the JAX host library, not its fallback

TOL = 1e-12
AGGREGATES = {"greedy": (tamg.greedy_aggregate, jamg.greedy_aggregate,
                         tamg.greedy_aggregate_reference),
              "vmb": (tamg.vmb_aggregate, jamg.vmb_aggregate, tamg.vmb_aggregate_reference)}


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def csr_both(dense):
    n = dense.shape[0]
    r, c = np.nonzero(dense)
    return (st.CSRMatrix.from_coo(n, n, r, c, dense[r, c], dtype=torch.float64, device="cpu"),
            sj.CSRMatrix.from_coo(n, n, r, c, dense[r, c], dtype=jnp.float64))


def hierarchies(A, Aj, kind=None, **kw):
    agg = {} if kind is None else dict(aggregate=AGGREGATES[kind][0])
    aggj = {} if kind is None else dict(aggregate=AGGREGATES[kind][1])
    return st.smoothed_aggregation_amg(A, **agg, **kw), js.smoothed_aggregation_amg(Aj, **aggj,
                                                                                     **kw)


def _csr_arrays(M):
    g = M.graph
    return g.indptr, np.asarray(g.indices)[: M.nnz], np.asarray(M.data)[: M.nnz], M.shape


@pytest.mark.parametrize("kind", ["greedy", "vmb"])
@pytest.mark.parametrize("fmt", ["csr", "coo", "dia"])
def test_aggregates_are_the_jax_packages(kind, fmt):
    dense = laplacian_2d(12) + 0.1 * np.eye(144)
    r, c = np.nonzero(dense)
    A = st.choose_matrix_type(fmt).from_coo(144, 144, r, c, dense[r, c], device="cpu")
    Aj = sj.choose_matrix_type(fmt).from_coo(144, 144, r, c, dense[r, c])
    port, jax_fn, reference = AGGREGATES[kind]
    agg = port(A)
    assert np.array_equal(agg, jax_fn(Aj))
    assert np.array_equal(agg, reference(*_adjacency(A.graph)))
    nc = agg.max() + 1
    assert agg.min() >= 0 and 1 < nc < 144  # every vertex, and actual coarsening
    assert (np.bincount(agg, minlength=nc) > 0).all()


@pytest.mark.parametrize("kind", ["greedy", "vmb"])
def test_aggregates_of_a_random_graph_match_the_reference(rng, kind):
    n = 90
    dense = np.triu(rng.random((n, n)) < 0.1, 1)
    dense = (dense | dense.T).astype(float) + np.eye(n)
    A, _ = csr_both(dense)
    port, _, reference = AGGREGATES[kind]
    assert np.array_equal(port(A), reference(A.graph.indptr, A.graph.indices))


@pytest.mark.parametrize("kind", ["greedy", "vmb"])
def test_hierarchy_is_the_jax_packages(kind):
    A, Aj = csr_both(laplacian_2d(24))
    M, Mj = hierarchies(A, Aj, kind, coarse_size=40)
    assert len(M.levels) == len(Mj.levels) >= 2
    n_prev = A.shape[0]
    for lvl, lj in zip(M.levels, Mj.levels):
        assert lvl.A.shape[0] == n_prev and lvl.P.shape[0] == n_prev
        assert lvl.P.shape[1] < n_prev  # strict coarsening
        n_prev = lvl.P.shape[1]
        for mine, theirs in ((lvl.A, lj.A), (lvl.P, lj.P)):
            assert mine.shape == tuple(theirs.shape)
            for a, b in zip(_csr_arrays(mine)[:3], _csr_arrays(theirs)[:3]):
                assert np.array_equal(a, b)
        assert np.array_equal(lvl.dinv.numpy(), np.asarray(lj.dinv))
    assert M.coarse_inv.shape == (n_prev, n_prev)
    assert np.array_equal(M.coarse_inv.numpy(), np.asarray(Mj.coarse_inv))


@pytest.mark.parametrize("state", ["own", "carried"])
@pytest.mark.parametrize("kind", ["greedy", "vmb"])
def test_vcycle_matches_jax(rng, kind, state):
    A, Aj = csr_both(laplacian_2d(16))
    M, Mj = hierarchies(A, Aj, kind, coarse_size=30)
    if state == "carried":
        M = convert.amg_from_arrays(
            [dict(A=_csr_arrays(l.A), P=_csr_arrays(l.P), dinv=np.asarray(l.dinv), omega=l.omega)
             for l in Mj.levels],
            np.asarray(Mj.coarse_inv), n_smooth=Mj.n_smooth, device="cpu")
    r = rng.standard_normal(256)
    z = M.matvec(torch.from_numpy(r))
    assert z.shape == (256,) and torch.isfinite(z).all()
    assert rel(z.numpy(), np.asarray(Mj.matvec(jnp.asarray(r)))) <= TOL
    assert torch.equal(M.rmatvec(torch.from_numpy(r)), z)


@pytest.mark.parametrize("kind", ["greedy", "vmb"])
def test_amg_cg_matches_jax_and_beats_plain_cg(rng, kind):
    """CG + AMG in the JAX package's count, a quarter of plain CG's or
    less (tests/test_amg.py:41)."""
    nx = 32
    d = laplacian_2d(nx)
    A, Aj = csr_both(d)
    M, Mj = hierarchies(A, Aj, kind)
    xstar = rng.standard_normal(nx * nx)
    b = d @ xstar
    x, info = st.cg_solve(A, torch.from_numpy(b), tol=1e-12, M=M)
    _, infoj = js.cg_solve(Aj, jnp.asarray(b), tol=1e-12, M=Mj)
    assert info.iterations == int(infoj.iterations) and info.converged
    assert np.abs(x.numpy() - xstar).max() < 1e-9
    _, plain = st.cg_solve(A, torch.from_numpy(b), tol=1e-12)
    assert info.iterations * 4 < plain.iterations


def test_amg_solve_matches_jax(rng):
    """The stationary V-cycle iteration (tests/test_amg.py:71): the error
    contracts every sweep, and amg_solve stops at the JAX package's count."""
    nx = 20
    d = laplacian_2d(nx)
    A, Aj = csr_both(d)
    M, Mj = hierarchies(A, Aj)
    xstar = rng.standard_normal(nx * nx)
    b = torch.from_numpy(d @ xstar)
    x, errs = torch.zeros_like(b), []
    for _ in range(6):
        x = x + M.matvec(b - A.matvec(x))
        errs.append(np.abs(x.numpy() - xstar).max())
    assert errs[-1] < errs[0] * 1e-2
    for kw in (dict(tol=1e-10), dict(tol=1e-10, maxiter=4)):
        x, info = st.amg_solve(A, b, M, **kw)
        xj, infoj = js.amg_solve(Aj, jnp.asarray(b.numpy()), Mj, **kw)
        assert info.iterations == int(infoj.iterations)
        assert info.converged == bool(infoj.converged) == (len(kw) == 1)
        assert rel(x.numpy(), np.asarray(xj)) <= 1e-10
    # the hierarchy is built when none is given
    _, info = st.amg_solve(A, b, tol=1e-10)
    assert info.iterations == int(js.amg_solve(Aj, jnp.asarray(b.numpy()), tol=1e-10)[1].iterations)


def test_amg_unsmoothed_variant(rng):
    nx = 24
    d = laplacian_2d(nx)
    A, Aj = csr_both(d)
    M, Mj = hierarchies(A, Aj, smooth_prolongator=False)
    xstar = rng.standard_normal(nx * nx)
    b = d @ xstar
    x, info = st.cg_solve(A, torch.from_numpy(b), tol=1e-11, M=M)
    _, infoj = js.cg_solve(Aj, jnp.asarray(b), tol=1e-11, M=Mj)
    assert info.iterations == int(infoj.iterations)
    assert np.abs(x.numpy() - xstar).max() < 1e-8


def test_amg_zero_level_hierarchy(rng):
    """A matrix at or below coarse_size collapses to the dense solve."""
    d = laplacian_2d(5) + np.eye(25)
    A, _ = csr_both(d)
    M = st.smoothed_aggregation_amg(A)
    assert M.levels == () and M.shape == (25, 25)
    r = rng.standard_normal(25)
    z = M.matvec(torch.from_numpy(r)).numpy()
    assert np.max(np.abs(d @ z - r)) < 1e-8


def test_vmb_hierarchy_is_coarser_and_converges(rng):
    """tests/test_amg.py:186: VMB coarsens well beyond greedy's ~2x and its
    hierarchy converges, in the JAX package's count."""
    nx = 24
    n = nx * nx
    dense = laplacian_2d(nx) + 0.1 * np.eye(n)
    A, Aj = csr_both(dense)
    assert tamg.vmb_aggregate(A).max() + 1 < (tamg.greedy_aggregate(A).max() + 1) * 0.6
    M, Mj = hierarchies(A, Aj, "vmb")
    b = rng.standard_normal(n)
    x, info = st.cg_solve(A, torch.from_numpy(b), tol=1e-12, M=M)
    _, infoj = js.cg_solve(Aj, jnp.asarray(b), tol=1e-12, M=Mj)
    assert info.converged and info.iterations == int(infoj.iterations)
    assert np.abs(x.numpy() - np.linalg.solve(dense, b)).max() < 1e-9


def test_dia_fine_level(rng):
    """A DIA operand stays the fine level (its smoother the DIA SpMV) and
    scales its rows in its own layout; coarse levels are CSR.  The same
    hierarchy and count as the JAX package's on its DIA matrix."""
    nx = 16
    n = nx * nx
    dense = laplacian_2d(nx) + 0.05 * np.eye(n)
    r, c = np.nonzero(dense)
    A = st.DIAMatrix.from_coo(n, n, r, c, dense[r, c], dtype=torch.float64, device="cpu")
    Aj = sj.DIAMatrix.from_coo(n, n, r, c, dense[r, c], dtype=jnp.float64)
    M, Mj = hierarchies(A, Aj, "vmb", coarse_size=20)
    assert M.levels[0].A is A and all(isinstance(l.A, st.CSRMatrix) for l in M.levels[1:])
    for lvl, lj in zip(M.levels, Mj.levels):
        assert np.array_equal(_csr_arrays(lvl.P)[2], _csr_arrays(lj.P)[2])
    b = rng.standard_normal(n)
    assert rel(M.matvec(torch.from_numpy(b)).numpy(), np.asarray(Mj.matvec(jnp.asarray(b)))) <= TOL
    _, info = st.cg_solve(A, torch.from_numpy(b), tol=1e-12, M=M)
    assert info.iterations == int(js.cg_solve(Aj, jnp.asarray(b), tol=1e-12, M=Mj)[1].iterations)


def test_vcycle_in_fixed_order_gives_the_cpu_bits(rng, monkeypatch):
    """Where the CSR products sum in fixed order (every device but the
    CPU), the V-cycle gives the CPU's bits, run after run."""
    A, _ = csr_both(laplacian_2d(16))
    M = st.smoothed_aggregation_amg(A, coarse_size=30)
    r = torch.from_numpy(rng.standard_normal(256))
    cpu = M.matvec(r)
    monkeypatch.setattr(ordered_sum, "fixed_order", lambda device: True)
    assert torch.equal(M.matvec(r), cpu)
    assert torch.equal(M.matvec(r), cpu)
