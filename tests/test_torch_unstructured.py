"""The port's unstructured pruned path as a whole, held against the JAX
package on a small shuffled irregular mesh in f64: the generator (bitwise),
RCM (the same permutation from C++ and numpy), the pair coarsening, the
pruned pair multigrid hierarchy, and CG, multigrid CG, block CG and LOBPCG
with equal iteration counts; also through ``convert``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.apps.generators import irregular_mesh_laplacian_coo as jax_mesh
from sigma_tpu.eigen import lobpcg as jax_lobpcg
from sigma_tpu.matrix.banded import reorder_triples_rcm as jax_rcm
from sigma_tpu.matrix.pruned import PrunedDIAMatrix as JaxPruned
from sigma_tpu.matrix.pruned import SymmetricPrunedDIAMatrix as JaxSymPruned
from sigma_tpu.solvers import block_cg_solve as jax_block_cg
from sigma_tpu.solvers import cg_solve as jax_cg
from sigma_tpu.solvers import gmg as jax_gmg
import sigma_tpu_torch as st
from sigma_tpu_torch import convert, native
from sigma_tpu.graph import graph as jax_graph
from sigma_tpu.graph.permutations import reverse_cuthill_mckee as jax_rcm_graph
from sigma_tpu_torch.graph.permutations import _rcm_arrays, reverse_cuthill_mckee_reference
from sigma_tpu_torch.matrix import banded
from sigma_tpu_torch.solvers import gmg

H, W, COARSE, TILE = 256, 16, 64, 1024  # n = 4096, 6 levels


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def mesh():
    """The shuffled mesh, RCM-reordered: (n, pr, pc, vals, p)."""
    n, r, c, v = st.irregular_mesh_laplacian_coo(H, W, rng=np.random.default_rng(0),
                                                 shift=1e-3, shuffle=True)
    return (n, *st.reorder_triples_rcm(n, r, c, v))


@pytest.mark.parametrize("shuffle", [False, True])
def test_generator_is_bitwise_the_jax_packages(shuffle):
    a = st.irregular_mesh_laplacian_coo(33, 17, rng=np.random.default_rng(5), shift=0.5,
                                        shuffle=shuffle)
    b = jax_mesh(33, 17, rng=np.random.default_rng(5), shift=0.5, shuffle=shuffle)
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_rcm_matches_the_jax_package_and_its_plain_version(mesh):
    n, r, c, v = st.irregular_mesh_laplacian_coo(H, W, rng=np.random.default_rng(0),
                                                 shift=1e-3, shuffle=True)
    pr, pc, pv, p = st.reorder_triples_rcm(n, r, c, v)
    jr, jc, jv, jp = jax_rcm(n, r, c, v)
    assert np.array_equal(p, jp) and np.array_equal(pr, jr) and np.array_equal(pc, jc)
    assert np.array_equal(pv, jv)
    adj, indptr = native.adjacency_from_coo(n, r, c)
    assert np.array_equal(_rcm_arrays(indptr, adj), reverse_cuthill_mckee_reference(indptr, adj))
    # the band after RCM is narrow: O(W), not O(n)
    assert int(np.abs(pc - pr).max()) < 4 * W < int(np.abs(c - r).max())
    # the input order is kept, with the identity, when it is the better one
    kr, kc, _, kp = banded._keep_better_order(pr, pc, pv, np.random.default_rng(1).permutation(n))
    assert np.array_equal(kp, np.arange(n)) and kr is pr and kc is pc
    with pytest.raises(ValueError, match="out of range"):
        st.reorder_triples_rcm(10, [0, 10], [0, 1], [1.0, 1.0])


@pytest.mark.parametrize("fmt", ["CSRGraph", "COOGraph", "CSCGraph", "ELLGraph"])
def test_rcm_of_a_graph_matches_the_jax_package(fmt):
    """reverse_cuthill_mckee takes a graph of any format, as the
    reference's does, and gives the reference's permutation."""
    rng = np.random.default_rng(3)
    n, k = 300, 1200
    r, c = rng.integers(0, n, k), rng.integers(0, n, k)
    rows, cols = np.r_[r, c, np.arange(n)], np.r_[c, r, np.arange(n)]
    g = getattr(st, fmt).from_coo(n, n, rows, cols)
    p = st.reverse_cuthill_mckee(g)
    assert np.array_equal(p, jax_rcm_graph(getattr(jax_graph, fmt).from_coo(n, n, rows, cols)))
    assert sorted(p.tolist()) == list(range(n))
    csr = st.CSRGraph.from_coo(n, n, rows, cols)
    assert np.array_equal(p, reverse_cuthill_mckee_reference(csr.indptr, csr.indices))
    with pytest.raises(ValueError, match="square"):
        st.reverse_cuthill_mckee(getattr(st, fmt).from_coo(n, n + 1, rows, cols))


def test_pair_coarsening_and_smoother_data_match_the_jax_package(mesh):
    n, r, c, v, _ = mesh
    for level in range(3):
        nc = (n + 1) // 2
        got = gmg._pair_coarsen_coo(r, c, v, nc, np.float64)
        want = jax_gmg._pair_coarsen_coo(r, c, v, nc, np.float64)
        plain = gmg._pair_coarsen_coo_reference(r, c, v, nc, np.float64)
        for a, b, q in zip(got, want, plain):
            assert np.array_equal(a, b) and np.array_equal(a, q)
        for want_lmax in (False, True):
            dt, lt = gmg._coo_dinv_lmax(n, r, c, v, np.float64, want_lmax)
            dj, lj = jax_gmg._coo_dinv_lmax(n, r, c, v, np.float64, want_lmax)
            assert np.array_equal(dt, dj) and lt == lj
        n, (r, c, v) = nc, got


CONFIGS = {
    "full_chebyshev": dict(smoother="chebyshev"),
    "full_jacobi": dict(smoother="jacobi", n_smooth=2),
    "sym_chebyshev": dict(smoother="chebyshev", symmetric=True, n_smooth=2),
    "sym_jacobi": dict(smoother="jacobi", symmetric=True),
}


def _hierarchies(mesh, **kw):
    n, r, c, v, _ = mesh
    common = dict(coarse_size=COARSE, tile_rows=TILE, **kw)
    return (jax_gmg.pruned_pair_amg(n, r, c, v, **common),
            st.pruned_pair_amg(n, r, c, v, device="cpu", **common))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_pruned_pair_amg_builds_the_jax_hierarchy(mesh, config):
    Mj, Mt = _hierarchies(mesh, **CONFIGS[config])
    assert len(Mt.levels) == len(Mj.levels) == 6
    assert (Mt.n_smooth, Mt.smoother) == (Mj.n_smooth, Mj.smoother)
    for lj, lt in zip(Mj.levels, Mt.levels):
        assert type(lt.A).__name__ == type(lj.A).__name__
        assert (lt.dims, lt.axes, lt.omega) == (lj.dims, lj.axes, lj.omega)
        assert lt.A.stored_slots == lj.A.stored_slots and lt.A.nnz == lj.A.nnz
        assert np.array_equal(lt.A.data.numpy().reshape(-1), np.asarray(lj.A.data).reshape(-1))
        assert np.array_equal(lt.dinv.numpy(), np.asarray(lj.dinv))
        assert (lt.lmax is None) == (lj.lmax is None)
        if lt.lmax is not None:
            assert lt.lmax == float(lj.lmax)
    assert np.array_equal(Mt.coarse_inv.numpy(), np.asarray(Mj.coarse_inv))


def _convert_amg(Mj):
    levels = [
        dict(data=np.asarray(lv.A.data), tile=np.asarray(lv.A.tile),
             first=np.asarray(lv.A.first), rowoff=np.asarray(lv.A.rowoff),
             laneoff=np.asarray(lv.A.laneoff), n=lv.A.n, m=lv.A.m, halo=lv.A.halo,
             nnz=lv.A.nnz, symmetric=isinstance(lv.A, JaxSymPruned),
             dinv=np.asarray(lv.dinv), omega=lv.omega,
             lmax=None if lv.lmax is None else float(lv.lmax))
        for lv in Mj.levels
    ]
    return convert.pruned_amg_from_arrays(levels, np.asarray(Mj.coarse_inv), Mj.n_smooth,
                                          Mj.smoother, device="cpu")


@pytest.mark.parametrize("symmetric", [False, True], ids=["full", "symmetric"])
def test_cg_and_multigrid_cg_match_the_jax_package(mesh, symmetric):
    n, r, c, v, _ = mesh
    if symmetric:
        Aj = JaxSymPruned.from_coo(n, n, r, c, v, tile_rows=TILE, assume_unique=True)
        At = st.SymmetricPrunedDIAMatrix.from_coo(n, n, r, c, v, tile_rows=TILE,
                                                  assume_unique=True, device="cpu")
    else:
        Aj = JaxPruned.from_coo(n, n, r, c, v, tile_rows=TILE, assume_unique=True)
        At = st.PrunedDIAMatrix.from_coo(n, n, r, c, v, tile_rows=TILE, assume_unique=True,
                                         device="cpu")
    xstar = np.sin(np.arange(n) * 0.001)
    b = np.asarray(Aj.matvec(jnp.asarray(xstar)))
    kw = dict(tol=0.0, rtol=1e-9, maxiter=1000)
    xj, ij = jax_cg(Aj, jnp.asarray(b), **kw)
    xt, it = st.cg_solve(At, torch.from_numpy(b), **kw)
    assert it.converged and it.iterations == int(ij.iterations)
    assert rel(xt, xj) <= 1e-10
    Mj = jax_gmg.pruned_pair_amg(n, r, c, v, coarse_size=COARSE, tile_rows=TILE,
                                 fine_A=Aj, symmetric=symmetric)
    Mt = st.pruned_pair_amg(n, r, c, v, coarse_size=COARSE, tile_rows=TILE, fine_A=At,
                            symmetric=symmetric)
    assert Mt.levels[0].A is At and Mt.levels[1].A.device.type == "cpu"
    xj, ij = jax_cg(Aj, jnp.asarray(b), M=Mj, **kw)
    xt, it = st.cg_solve(At, torch.from_numpy(b), M=Mt, **kw)
    assert it.converged and it.iterations == int(ij.iterations) < 60
    assert rel(xt, xj) <= 1e-10
    xc, ic = st.cg_solve(At, torch.from_numpy(b), M=_convert_amg(Mj), **kw)
    assert ic.iterations == it.iterations and rel(xc, xj) <= 1e-10


def test_block_cg_and_lobpcg_match_the_jax_package(mesh):
    n, r, c, v, _ = mesh
    Aj = JaxPruned.from_coo(n, n, r, c, v, tile_rows=TILE, assume_unique=True)
    At = st.PrunedDIAMatrix.from_coo(n, n, r, c, v, tile_rows=TILE, assume_unique=True,
                                     device="cpu")
    Mj = jax_gmg.pruned_pair_amg(n, r, c, v, coarse_size=COARSE, tile_rows=TILE, fine_A=Aj)
    Mt = st.pruned_pair_amg(n, r, c, v, coarse_size=COARSE, tile_rows=TILE, fine_A=At)
    B = np.random.default_rng(1).standard_normal((n, 8))
    kw = dict(tol=0.0, rtol=1e-9, maxiter=200, panels="cols")
    Xj, ij = jax_block_cg(Aj, jnp.asarray(B), M=Mj, **kw)
    Xt, it = st.block_cg_solve(At, torch.from_numpy(B), M=Mt, **kw)
    assert it.converged and it.iterations == int(ij.iterations)
    assert rel(Xt, Xj) <= 1e-10
    X0 = np.random.default_rng(2).standard_normal((n, 4))
    rj = jax_lobpcg(Aj, jnp.asarray(X0), M=Mj, tol=1e-7, maxiter=100)
    rt = st.lobpcg(At, torch.from_numpy(X0), M=Mt, tol=1e-7, maxiter=100)
    assert rt.converged and rt.iterations == int(rj.iterations)
    assert rel(rt.eigenvalues, rj.eigenvalues) <= 1e-10


def test_skew_dominance_and_routing_match_the_jax_package(mesh):
    n, r, c, v, _ = mesh
    skewed = v * np.where(c > r, 1.2, 1.0)  # an edge-skewed operator
    antisym = v * np.sign(c - r + 0.5)  # the off-diagonal part skew
    for vals, route in ((v, "pruned_gmg_sym"), (skewed, "pruned_gmg"), (antisym, "plain")):
        s = st.skew_dominance(r, c, vals)
        assert s == jax_gmg.skew_dominance(r, c, vals)
        kw = dict(coarse_size=COARSE, tile_rows=TILE)
        Mt, info = st.auto_pruned_preconditioner(n, r, c, vals, device="cpu", **kw)
        Mj, jinfo = jax_gmg.auto_pruned_preconditioner(n, r, c, vals, **kw)
        assert info == jinfo and info["route"] == route
        assert (Mt is None) == (Mj is None)
        if Mt is not None:
            assert type(Mt.levels[0].A).__name__ == type(Mj.levels[0].A).__name__
