"""The port's distributed layer held against the JAX package on the CPU in
f64, test by test after ``tests/test_parallel.py``, the distributed tests
of ``tests/test_pruned.py``, ``tests/test_amg.py``'s distributed Chebyshev,
``tests/test_eigensolver.py``'s distributed generalized Lanczos and
``tests/test_gmg.py``'s distributed Chebyshev-smoothed multigrid, at those
tests' shard counts (8 or 4: the JAX side runs on the virtual CPU devices
of ``tests/conftest.py``, the port's shards share the CPU).

The same numpy inputs go to both packages.  Layouts (ring offsets, terms,
ELL widths, block, n_pad, halo and the shard arrays) equal the JAX
package's; matvec, rmatvec and matmat agree with the JAX package's
distributed products to 1e-13 relative; distributed solves take the JAX
solve's iteration count with iterates within 1e-10 relative (1e-8 for
block CG, whose panel algebra amplifies rounding).  The JAX solves run on
its single-device operators, which its own tests hold equal to its
distributed ones; a distributed JAX solve costs a ``shard_map`` compile
each.  Block ILDU has no single-device twin: its apply is held against
the JAX package's and checked by its use in CG.  Last, the port's dry run
at 8 shards, and the ``convert`` carriers of the three layouts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu as sj
import sigma_tpu.parallel as jp
import sigma_tpu.solvers as js
from sigma_tpu.apps import barabasi_albert as jax_barabasi_albert
from sigma_tpu.eigen import generalized_lanczos as jax_generalized_lanczos
from sigma_tpu.eigen import lanczos as jax_lanczos
from sigma_tpu.matrix.pruned import PrunedDIAMatrix as JaxPruned
import sigma_tpu_torch as st
import sigma_tpu_torch.parallel as tp
from sigma_tpu_torch import convert
from sigma_tpu_torch.eigen import generalized_lanczos, lanczos
from sigma_tpu_torch.tools.dryrun_multichip import dryrun_multichip

from conftest import laplacian_2d

TOL = 1e-13  # products
STOL = 1e-10  # solver iterates
BTOL = 1e-8  # block CG iterates


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


_MESHES = {}


def meshes(D):
    """(JAX mesh of D virtual devices, the port's mesh of D CPU shards)."""
    if D not in _MESHES:
        assert len(jax.devices()) >= D, "conftest must provide 8 virtual devices"
        _MESHES[D] = (jp.make_mesh(D), tp.make_mesh(D, device="cpu"))
    return _MESHES[D]


def laplacian_1d(n, wrap=False):
    d = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    if wrap:
        d[0, n - 1] = d[n - 1, 0] = -1.0
    return d


def poisson(dims):
    """2 * nd on the diagonal, -1 to each in-grid axis neighbour."""
    n = int(np.prod(dims))
    idx = np.arange(n)
    coords = np.unravel_index(idx, dims)
    strides = np.cumprod((1,) + tuple(dims[::-1]))[:-1][::-1]
    dense = np.diag(np.full(n, 2.0 * len(dims)))
    for ax, e in enumerate(dims):
        ok = coords[ax] + 1 < e
        dense[idx[ok], idx[ok] + strides[ax]] = dense[idx[ok] + strides[ax], idx[ok]] = -1.0
    return dense


def poisson9(dims):
    """2-D 9-point Laplacian: 8 on the diagonal, -1 to all 8 in-grid
    neighbours (cross couplings alias on coarse grids)."""
    a, b = dims
    idx = np.arange(a * b)
    ia, ib = idx // b, idx % b
    dense = np.diag(np.full(a * b, 8.0))
    for da in (-1, 0, 1):
        for db in (-1, 0, 1):
            ok = (ia + da >= 0) & (ia + da < a) & (ib + db >= 0) & (ib + db < b)
            if da or db:
                dense[idx[ok], idx[ok] + da * b + db] = -1.0
    return dense


def both(cls_name, dense):
    """The JAX package's and the port's matrix of one dense array."""
    return (getattr(sj, cls_name).from_dense(dense),
            getattr(st, cls_name).from_dense(dense, device="cpu"))


def ell_layout_is_the_jax_packages(Aj, At):
    assert Aj.offsets == At.offsets
    assert (Aj.n, Aj.m, Aj.block, Aj.block_cols, Aj.n_pad) == (At.n, At.m, At.block,
                                                               At.block_cols, At.n_pad)
    D = At.n_shards
    for nj, vj, nt, vt in zip(Aj.nodes, Aj.vals, At.nodes, At.vals):
        assert np.array_equal(np.asarray(nj).reshape(nt.shape), nt.numpy())
        assert np.array_equal(np.asarray(vj).reshape(vt.shape), vt.numpy())
        assert nt.shape[:2] == (D, At.block)


def dia_layout_is_the_jax_packages(Aj, At):
    assert Aj.terms == At.terms and (Aj.n, Aj.block, Aj.n_pad) == (At.n, At.block, At.n_pad)
    for vj, vt in zip(Aj.vals, At.vals):
        assert np.array_equal(np.asarray(vj), vt.numpy())


def products_agree(Aj, At, x, *, rmatvec=True):
    """The port's distributed matvec (and rmatvec) against the JAX
    package's on the same padded x."""
    xj, xt = Aj.shard_vector(x), At.shard_vector(x)
    assert rel(At.matvec(xt).numpy(), np.asarray(Aj.matvec(xj))) < TOL
    if rmatvec:
        assert rel(At.rmatvec(xt).numpy(), np.asarray(Aj.rmatvec(xj))) < TOL


def solves_agree(xt, it, xj, itj, n, tol=STOL):
    assert int(it.iterations) == int(itj.iterations)
    assert rel(np.asarray(xt)[:n], np.asarray(xj)[:n]) < tol


# -- tests/test_parallel.py -------------------------------------------------------
def test_banded_offsets_are_sparse():
    jm, tm = meshes(8)
    n = 64
    Aj, At = both("CSRMatrix", laplacian_1d(n) + np.eye(n))
    Dj, Dt = jp.distribute_matrix(Aj, jm), tp.distribute_matrix(At, tm)
    ell_layout_is_the_jax_packages(Dj, Dt)
    assert set(Dt.offsets) <= {0, 1, 7}


def test_spmv_matches_dense_and_the_jax_package(rng):
    jm, tm = meshes(8)
    n = 200
    dense = laplacian_1d(n, wrap=True) + np.eye(n)
    Aj, At = both("CSRMatrix", dense)
    Dj, Dt = jp.distribute_matrix(Aj, jm), tp.distribute_matrix(At, tm)
    ell_layout_is_the_jax_packages(Dj, Dt)
    x = rng.standard_normal(n)
    assert rel(Dt.unshard_vector(Dt.matvec(Dt.shard_vector(x))), dense @ x) < TOL
    products_agree(Dj, Dt, x, rmatvec=False)


def test_spmv_and_rmatvec_general_sparsity(rng):
    jm, tm = meshes(8)
    n = 96
    dense = np.where(rng.random((n, n)) < 0.05, rng.standard_normal((n, n)), 0.0)
    dense += np.diag(np.full(n, 4.0))
    Aj, At = both("CSRMatrix", dense)
    Dj, Dt = jp.distribute_matrix(Aj, jm), tp.distribute_matrix(At, tm)
    ell_layout_is_the_jax_packages(Dj, Dt)
    assert len(Dt.offsets) > 3
    products_agree(Dj, Dt, rng.standard_normal(n))


def test_spmm_multivector(rng):
    jm, tm = meshes(8)
    n, k = 160, 6
    Aj, At = both("ELLMatrix", laplacian_1d(n) + np.eye(n))
    Dj, Dt = jp.distribute_matrix(Aj, jm), tp.distribute_matrix(At, tm)
    ell_layout_is_the_jax_packages(Dj, Dt)
    X = rng.standard_normal((n, k))
    Yj = np.asarray(Dj.matmat(jp.distribute_vector(X, jm, "rows", Dj.n_pad)))
    Yt = Dt.matmat(tp.distribute_vector(X, tm, "rows", Dt.n_pad)).numpy()
    assert Yt.shape == (Dt.n_pad, k) and rel(Yt, Yj) < TOL


@pytest.mark.parametrize("case", ["cg", "bicgstab", "jacobi_cg", "uneven_cg"])
def test_distributed_solves_match_the_jax_package(case, rng):
    jm, tm = meshes(8)
    n = {"cg": 500, "bicgstab": 300, "jacobi_cg": 250, "uneven_cg": 101}[case]
    dense = laplacian_1d(n) + np.eye(n)
    if case == "bicgstab":
        dense += 0.3 * (np.eye(n, k=1) - np.eye(n, k=-1))
    if case == "jacobi_cg":
        dense = laplacian_1d(n) + np.diag(1.0 + np.arange(n) % 7)
    Aj, At = both("CSRMatrix", dense)
    Dt = tp.distribute_matrix(At, tm)
    if case == "uneven_cg":
        assert Dt.n_pad == 104
        products_agree(jp.distribute_matrix(Aj, jm), Dt, rng.standard_normal(n), rmatvec=False)
    xstar = rng.standard_normal(n)
    b = dense @ xstar
    if case == "bicgstab":
        kw = dict(tol=1e-13, maxiter=600)
        x, it = st.bicgstab_solve(Dt, Dt.shard_vector(b), **kw)
        xj, itj = js.bicgstab_solve(Aj, jnp.asarray(b), **kw)
    else:
        kw = dict(tol=1e-13 if case == "jacobi_cg" else 1e-14)
        Mt = st.jacobi().setup(Dt) if case == "jacobi_cg" else None
        Mj = js.jacobi().setup(Aj) if case == "jacobi_cg" else None
        x, it = st.cg_solve(Dt, Dt.shard_vector(b), M=Mt, **kw)
        xj, itj = js.cg_solve(Aj, jnp.asarray(b), M=Mj, **kw)
    solves_agree(x, it, xj, itj, n)
    assert np.abs(Dt.unshard_vector(x) - xstar).max() < 1e-7


def test_matvec_is_deterministic_and_the_jax_packages_jitted(rng):
    jm, tm = meshes(8)
    n = 128
    Aj, At = both("CSRMatrix", laplacian_1d(n) + np.eye(n))
    Dj, Dt = jp.distribute_matrix(Aj, jm), tp.distribute_matrix(At, tm)
    x = rng.standard_normal(n)
    yj = np.asarray(jax.jit(lambda M, v: M.matvec(v))(Dj, Dj.shard_vector(x)))
    xt = Dt.shard_vector(x)
    assert torch.equal(Dt.matvec(xt), Dt.matvec(xt))
    assert rel(Dt.matvec(xt).numpy(), yj) < TOL
    # an operator is a value: ``to`` moves its tensors and its mesh
    moved = tp.distribute_matrix_dia(At, tm).to("meta")
    assert moved.device == moved.data.device == torch.device("meta")


def test_to_dense_roundtrip(rng):
    jm, tm = meshes(8)
    n = 40
    dense = np.where(rng.random((n, n)) < 0.1, rng.standard_normal((n, n)), 0.0)
    Aj, At = both("CSRMatrix", dense)
    Dj, Dt = jp.distribute_matrix(Aj, jm), tp.distribute_matrix(At, tm)
    assert np.array_equal(Dt.to_dense(), Dj.to_dense())
    assert np.abs(Dt.to_dense() - dense).max() == 0.0


def test_distributed_diagonal():
    jm, tm = meshes(8)
    n = 96
    Aj, At = both("CSRMatrix", laplacian_1d(n) + 3.0 * np.eye(n))
    Dj, Dt = jp.distribute_matrix(Aj, jm), tp.distribute_matrix(At, tm)
    assert np.array_equal(Dt.diagonal().numpy(), np.asarray(Dj.diagonal()))
    assert np.abs(Dt.unshard_vector(Dt.diagonal()) - 5.0).max() == 0.0


def test_distributed_lanczos(rng):
    jm, tm = meshes(8)
    n, k = 64, 12
    adj = np.triu(rng.random((n, n)) < 0.15, 1)
    adj = adj | adj.T
    dense = np.diag(adj.sum(1).astype(float)) - adj + np.eye(n)
    Aj, At = both("CSRMatrix", dense)
    Dj, Dt = jp.distribute_matrix(Aj, jm), tp.distribute_matrix(At, tm)
    v0 = rng.standard_normal(n)
    res = lanczos(Dt, k, v0=torch.from_numpy(v0))
    resj = jax_lanczos(Aj, k, v0=v0)
    assert rel(res.alpha.numpy(), np.asarray(resj.alpha)) < STOL
    assert rel(res.beta.numpy(), np.asarray(resj.beta)) < STOL
    V, T = res.V.numpy(), res.tridiagonal().numpy()
    R = dense @ V - V @ T
    R[:, -1] -= float(res.beta[-1]) * res.v_next.numpy()
    assert np.abs(R).max() < 1e-11
    assert np.linalg.norm(V.T @ V - np.eye(k)) < 1e-12


@pytest.mark.parametrize("case", ["stencil", "general"])
def test_distributed_dia_spmv(case, rng):
    jm, tm = meshes(8)
    if case == "stencil":
        n = 400
        dense = laplacian_1d(n, wrap=True) + np.eye(n)
    else:
        n = 64
        dense = np.zeros((n, n))
        for o in (-17, -3, 0, 5, 29):
            i = np.arange(max(0, -o), min(n, n - o))
            dense[i, i + o] = rng.standard_normal(i.size)
    Aj, At = both("DIAMatrix" if case == "stencil" else "CSRMatrix", dense)
    Dj, Dt = jp.distribute_matrix_dia(Aj, jm), tp.distribute_matrix_dia(At, tm)
    dia_layout_is_the_jax_packages(Dj, Dt)
    x = rng.standard_normal(n)
    assert rel(Dt.unshard_vector(Dt.matvec(Dt.shard_vector(x))), dense @ x) < TOL
    products_agree(Dj, Dt, x, rmatvec=False)


def test_distributed_dia_cg_jacobi(rng):
    jm, tm = meshes(8)
    n = 501  # uneven: padded rows have a zero diagonal
    dense = laplacian_1d(n) + np.diag(1.0 + np.arange(n) % 5)
    Aj, At = both("CSRMatrix", dense)
    Dt = tp.distribute_matrix_dia(At, tm)
    dia_layout_is_the_jax_packages(jp.distribute_matrix_dia(Aj, jm), Dt)
    b = dense @ rng.standard_normal(n)
    x, it = st.cg_solve(Dt, Dt.shard_vector(b), tol=1e-13, M=st.jacobi().setup(Dt))
    xj, itj = js.cg_solve(Aj, jnp.asarray(b), tol=1e-13, M=js.jacobi().setup(Aj))
    solves_agree(x, it, xj, itj, n)


def test_distributed_dia_rmatvec(rng):
    jm, tm = meshes(8)
    n = 192
    dense = np.zeros((n, n))
    for o in (0, 1, -1, 24, -24, 60):
        idx = np.arange(max(0, -o), min(n, n - o))
        dense[idx, idx + o] = rng.standard_normal(idx.size)
    Aj, At = both("CSRMatrix", dense)
    Dj, Dt = jp.distribute_matrix_dia(Aj, jm), tp.distribute_matrix_dia(At, tm)
    dia_layout_is_the_jax_packages(Dj, Dt)
    x = rng.standard_normal(n)
    assert rel(Dt.unshard_vector(Dt.rmatvec(Dt.shard_vector(x))), dense.T @ x) < TOL
    products_agree(Dj, Dt, x)


def test_distributed_wide_band_matvec(rng):
    jm, tm = meshes(8)
    n = 512
    dense = np.zeros((n, n))
    for o in sorted({0} | {int(v) for v in rng.integers(-40, 40, 35)}):
        lo, hi = max(0, -o), min(n, n - o)
        dense[np.arange(lo, hi), np.arange(lo, hi) + o] = rng.standard_normal(hi - lo)
    Aj, At = both("CSRMatrix", dense)
    Dj, Dt = jp.distribute_matrix_dia(Aj, jm), tp.distribute_matrix_dia(At, tm)
    dia_layout_is_the_jax_packages(Dj, Dt)
    assert sum(1 for k, _ in Dt.terms if k == 0) > 24
    x = rng.standard_normal(n)
    yj = np.asarray(jax.jit(lambda A, v: A.matvec(v))(Dj, Dj.shard_vector(x)))
    assert rel(Dt.matvec(Dt.shard_vector(x)).numpy(), yj) < TOL


def test_distributed_dia_bf16_values_refined(rng):
    jm, tm = meshes(8)
    n = 400
    dense = laplacian_1d(n) + np.diag(1.0 + 0.1 * rng.standard_normal(n))
    Aj, At = both("DIAMatrix", dense)
    Dj, Dt = jp.distribute_matrix_dia(Aj, jm), tp.distribute_matrix_dia(At, tm)
    Bj, Bt = Dj.astype(jnp.bfloat16), Dt.astype(torch.bfloat16)
    assert Bt.dtype == torch.bfloat16 and Bt.terms == Dt.terms
    x = rng.standard_normal(n)
    y = Bt.matvec(Bt.shard_vector(x)).numpy()
    assert rel(y, np.asarray(Bj.matvec(Bj.shard_vector(x)))) < TOL
    assert 1e-8 < rel(y[:n], dense @ x) < 2e-2  # the cast really rounded
    xstar = rng.standard_normal(n)
    xs = st.refined_solve_fixed(Dt, Dt.shard_vector(dense @ xstar), A_lo=Bt, sweeps=3,
                                inner_rtol=1e-3, inner_maxiter=800)
    assert np.abs(Dt.unshard_vector(xs) - xstar).max() < 1e-5


@pytest.mark.parametrize("n,D", [(256, 8), (13, 4)])
def test_balance_rows_is_the_jax_packages(n, D, rng):
    if n == 256:
        g = jax_barabasi_albert(n, 4, rng)
        dense = np.zeros((n, n))
        r, c = g.edges_numpy()
        dense[r, c] = 1.0
        dense += np.eye(n) * 5
    else:
        dense = np.eye(n) * 2 + np.diag(np.ones(n - 1), 1)
        dense = dense + dense.T
    Aj, At = both("CSRMatrix", dense)
    p = tp.balance_rows(At, D)
    assert np.array_equal(p, jp.balance_rows(Aj, D))
    assert np.array_equal(np.sort(p), np.arange(n))
    if n == 256:
        nb = -(-n // D)
        before = np.bincount(At.entries()[0] // nb, minlength=D)
        after = np.bincount(At.permute_rows(p).permute_cols(p).entries()[0] // nb, minlength=D)
        assert after.max() - after.min() <= before.max() - before.min()
        assert after.max() <= after.mean() * 1.3


@pytest.mark.parametrize("case", ["ildu0", "ildu0_uneven", "fill_levels"])
def test_distributed_block_ildu(case, rng):
    """The apply against the JAX package's, then its use in CG: it
    converges, and (banded) cuts the iterations; higher fill does not
    lose to ILDU(0)."""
    jm, tm = meshes(8)
    if case == "fill_levels":
        n, dense = 256, laplacian_2d(16)
    elif case == "ildu0_uneven":
        n = 333  # the padded last shard
        dense = laplacian_1d(n) + np.diag(1.0 + np.arange(n) % 3)
    else:
        n = 500
        dense = laplacian_1d(n) + 0.02 * np.eye(n)
    Aj, At = both("CSRMatrix", dense)
    Dt = tp.distribute_matrix(At, tm) if case == "ildu0_uneven" else tp.distribute_matrix_dia(At, tm)
    xstar = rng.standard_normal(n)
    b = Dt.shard_vector(dense @ xstar)
    r = Dt.shard_vector(rng.standard_normal(n))
    iters = []
    for level in ((0, 2) if case == "fill_levels" else (0,)):
        M = tp.distributed_block_ildu(At, tm, level=level)
        Mj = jp.distributed_block_ildu(Aj, jm, level=level)
        assert M.n_pad == Mj.n_pad and M.block == Mj.block
        z = M.matvec(r).numpy()
        assert rel(z, np.asarray(Mj.matvec(jnp.asarray(r.numpy())))) < 1e-12
        assert np.isfinite(z).all() and np.abs(z[n:]).max(initial=0.0) == 0.0
        x, info = st.cg_solve(Dt, b, tol=1e-12, M=M)
        assert np.abs(Dt.unshard_vector(x) - xstar).max() < 1e-8
        iters.append(int(info.iterations))
    if case == "ildu0":
        _, plain = st.cg_solve(Dt, b, tol=1e-12)
        assert iters[0] * 5 < int(plain.iterations)
    if case == "fill_levels":
        assert iters[1] <= iters[0], iters


def test_rectangular_distribute_matvec(rng):
    jm, tm = meshes(8)
    n, m = 120, 37
    dense = np.where(rng.random((n, m)) < 0.15, rng.standard_normal((n, m)), 0.0)
    r, c = np.nonzero(dense)
    Pj = jp.distribute_matrix(sj.CSRMatrix.from_coo(n, m, r, c, dense[r, c]), jm)
    Pt = tp.distribute_matrix(st.CSRMatrix.from_coo(n, m, r, c, dense[r, c], dtype=np.float64,
                                                    device="cpu"), tm)
    ell_layout_is_the_jax_packages(Pj, Pt)
    assert Pt.bcols != Pt.block and Pt.m_pad == Pj.m_pad
    xc, xf = rng.standard_normal(m), rng.standard_normal(n)
    Xc, Xf = rng.standard_normal((m, 3)), rng.standard_normal((n, 3))

    @jax.jit
    def all4(P, xc, xf, Xc, Xf):
        return P.matvec(xc), P.rmatvec(xf), P.matmat(Xc), P.rmatmat(Xf)

    want = all4(Pj, Pj.shard_domain_vector(xc), Pj.shard_vector(xf),
                Pj.shard_domain_vector(Xc), Pj.shard_vector(Xf))
    got = (Pt.matvec(Pt.shard_domain_vector(xc)), Pt.rmatvec(Pt.shard_vector(xf)),
           Pt.matmat(Pt.shard_domain_vector(Xc)), Pt.rmatmat(Pt.shard_vector(Xf)))
    for g, w in zip(got, want):
        assert g.shape == w.shape and rel(g.numpy(), np.asarray(w)) < TOL
    assert rel(got[0].numpy()[:n], dense @ xc) < TOL
    assert rel(got[1].numpy()[:m], dense.T @ xf) < TOL


@pytest.mark.parametrize("case", ["cg_parity", "vcycle"])
def test_distributed_amg_matches_single_device(case, rng):
    jm, tm = meshes(8)
    nx = 13 if case == "cg_parity" else 8
    n = nx * nx
    dense = laplacian_2d(nx) + 0.1 * np.eye(n)
    Aj, At = both("CSRMatrix", dense)
    coarse = 16 if case == "cg_parity" else 8
    Mj = js.amg.smoothed_aggregation_amg(Aj, coarse_size=coarse, max_levels=2)
    M = st.smoothed_aggregation_amg(At, coarse_size=coarse, max_levels=2)
    Dt = tp.distribute_matrix(At, tm)
    Md = tp.distribute_amg(M, tm)
    if case == "vcycle":
        r = rng.standard_normal(n)
        z = Dt.unshard_vector(Md.matvec(Dt.shard_vector(r)))
        assert rel(z, np.asarray(Mj.matvec(jnp.asarray(r)))) < 1e-11
        return
    b = rng.standard_normal(n)
    x, it = st.cg_solve(Dt, Dt.shard_vector(b), tol=1e-12, M=Md)
    xj, itj = js.cg_solve(Aj, jnp.asarray(b), tol=1e-12, M=Mj)
    assert bool(it.converged)
    solves_agree(x, it, xj, itj, n)


def _structured_pair(dims, dense, D=8, **kw):
    jm, tm = meshes(D)
    Aj, At = both("DIAMatrix", dense)
    Mj = js.structured_pair_amg(Aj, dims, freeze_axes=(0,), **kw)
    M = st.structured_pair_amg(At, dims, freeze_axes=(0,), **kw)
    assert all(0 not in lvl.axes for lvl in M.levels)
    Dt, Md = tp.distribute_matrix_dia(At, tm), tp.distribute_structured_amg(M, tm)
    Mjd = jp.distribute_structured_amg(Mj, jm)
    for lj, lt in zip(Mjd.levels, Md.levels):
        dia_layout_is_the_jax_packages(lj.A, lt.A)
    return Aj, Mj, Dt, Md


@pytest.mark.parametrize("case", ["vcycle", "cg_parity", "aliased_offsets", "chebyshev"])
def test_distributed_structured_gmg_matches(case, rng):
    """The V-cycle on the mesh against the JAX package's single-device one
    (1e-12), and CG + GMG with its iteration count (the Chebyshev-smoothed
    hierarchy of ``tests/test_gmg.py``, the aliased 9-point levels)."""
    if case == "aliased_offsets":
        dims = (16, 6)
        Aj, Mj, Dt, Md = _structured_pair(dims, poisson9(dims), coarse_size=16)
        assert min(min(lvl.dims) for lvl in Md.levels) <= 2
    elif case == "chebyshev":
        dims = (16, 8, 8)
        Aj, Mj, Dt, Md = _structured_pair(dims, poisson(dims), smoother="chebyshev", n_smooth=2)
    else:
        dims = (16, 12, 10)
        Aj, Mj, Dt, Md = _structured_pair(dims, poisson(dims), pairs_per_level=2,
                                          coarse_size=128)
    n = int(np.prod(dims))
    if case in ("vcycle", "aliased_offsets"):
        r = rng.standard_normal(n)
        z = Dt.unshard_vector(Md.matvec(Dt.shard_vector(r)))
        assert rel(z, np.asarray(Mj.matvec(jnp.asarray(r)))) < 1e-12
        return
    b = rng.standard_normal(n)
    kw = dict(tol=1e-11) if case == "cg_parity" else dict(tol=1e-10, maxiter=300)
    x, it = st.cg_solve(Dt, Dt.shard_vector(b), M=Md, **kw)
    xj, itj = js.cg_solve(Aj, jnp.asarray(b), M=Mj, **kw)
    assert bool(it.converged)
    solves_agree(x, it, xj, itj, n)


def test_distribute_structured_gmg_rejects_paired_shard_axis():
    dims = (16, 4, 4)
    Aj, At = both("DIAMatrix", poisson(dims))
    jm, tm = meshes(8)
    M = st.structured_pair_amg(At, dims, coarse_size=32)  # pairs axis 0
    with pytest.raises(ValueError, match="freeze_axes"):
        tp.distribute_structured_amg(M, tm)
    with pytest.raises(ValueError, match="freeze_axes"):
        jp.distribute_structured_amg(js.structured_pair_amg(Aj, dims, coarse_size=32), jm)
    M = st.structured_pair_amg(At, dims, freeze_axes=(0,), coarse_size=32)
    with pytest.raises(ValueError, match="divide evenly"):
        tp.distribute_structured_amg(M, tp.make_mesh(3, device="cpu"))


def test_distributed_cgls_rectangular(rng):
    jm, tm = meshes(8)
    n, m = 96, 40
    dense = np.where(rng.random((n, m)) < 0.2, rng.standard_normal((n, m)), 0.0)
    dense[np.arange(m), np.arange(m)] += 3.0
    r, c = np.nonzero(dense)
    Aj = sj.CSRMatrix.from_coo(n, m, r, c, dense[r, c])
    Pt = tp.distribute_matrix(st.CSRMatrix.from_coo(n, m, r, c, dense[r, c], dtype=np.float64,
                                                    device="cpu"), tm)
    b = rng.standard_normal(n)
    x, it = st.cgls_solve(Pt, Pt.shard_vector(b), tol=1e-12, maxiter=300)
    xj, itj = js.cgls_solve(Aj, jnp.asarray(b), tol=1e-12, maxiter=300)
    assert bool(it.converged) and x.shape == (Pt.m_pad,)
    solves_agree(x, it, xj, itj, m)
    np.testing.assert_allclose(x.numpy()[:m], np.linalg.lstsq(dense, b, rcond=None)[0], atol=1e-8)


# -- tests/test_pruned.py, test_amg.py, test_eigensolver.py --------------------------
def banded_spd(rng, n, offs=(1, 2, 5, 11), shift=0.01):
    dense = np.zeros((n, n))
    i = np.arange(n)
    for o in offs:
        v = -np.abs(rng.random(n - o)) * 0.4
        dense[i[:-o], i[:-o] + o] = v
        dense[i[:-o] + o, i[:-o]] = v
    dense[i, i] = np.abs(dense).sum(1) + shift
    rows, cols = np.nonzero(dense)
    return dense, rows, cols, dense[rows, cols]


def pruned_layout_is_the_jax_packages(Aj, At):
    """Block, n_pad, halo and every shard's plan: the JAX shard slice
    carried across equals the port's plan on its slots, and its padding
    steps up to the common step count are zero slots of offset 0."""
    assert (At.n, At.block, At.n_pad, At.halo_words, At.halo_E, At.nnz, At.symmetric) == (
        Aj.n, Aj.block, Aj.n_pad, Aj.halo_words, Aj.halo_E, Aj.nnz, Aj.symmetric)
    D, C = At.n_shards, Aj.data.shape[1]
    L = Aj.data.shape[0] // D
    arrays = [np.asarray(a) for a in (Aj.data, Aj.tile, Aj.first, Aj.rowoff, Aj.laneoff)]
    for d, s in enumerate(At.shards):
        data, tile, first, ro, lo = (a[d * L * (C if i > 2 else 1): (d + 1) * L * (C if i > 2 else 1)]
                                     for i, a in enumerate(arrays))
        carried = convert.pruned_from_arrays(data, tile, first, ro, lo, At.block,
                                             At.block + 2 * At.halo_words, Aj.halo_E, 0,
                                             device="cpu")
        S = s.data.shape[0]
        assert (s.tile_rows, s.group, s.halo) == (carried.tile_rows, C, Aj.halo_E)
        assert np.array_equal(carried.data[:S].numpy(), s.data.numpy())
        assert np.array_equal(carried.offsets[:S].numpy(), s.offsets.numpy())
        assert not carried.data[S:].any() and not carried.offsets[S:].any()
        assert np.array_equal(carried.tile_ptr[:-1].numpy(), s.tile_ptr[:-1].numpy())
        assert np.array_equal(carried.tile_end.numpy(), s.tile_end.numpy())


def test_distributed_pruned_matvec_and_cg_parity(rng):
    jm, tm = meshes(8)
    n = 6000
    dense, rows, cols, vals = banded_spd(rng, n)
    Aj = jp.distribute_pruned(n, rows, cols, vals, jm, tile_rows=1024, group=4)
    At = tp.distribute_pruned(n, rows, cols, vals, tm, tile_rows=1024, group=4)
    pruned_layout_is_the_jax_packages(Aj, At)
    P1 = st.PrunedDIAMatrix.from_coo(At.n_pad, At.n_pad, rows, cols, vals,
                                     tile_rows=min(1024, At.block), group=4, device="cpu")
    x = rng.standard_normal(n)
    y = At.matvec(At.shard_vector(x))
    assert torch.equal(y, P1.matvec(At.shard_vector(x)))  # the twin's bits
    assert rel(y.numpy()[:n], dense @ x) < 1e-10
    products_agree(Aj, At, x, rmatvec=False)
    b = dense @ rng.standard_normal(n)
    bp = np.zeros(At.n_pad)
    bp[:n] = b
    kw = dict(tol=0.0, rtol=1e-8, maxiter=40)
    x, it = st.cg_solve(At, At.shard_vector(b), **kw)
    xj, itj = js.cg_solve(JaxPruned.from_coo(Aj.n_pad, Aj.n_pad, rows, cols, vals, tile_rows=1024,
                                             group=4), jnp.asarray(bp), **kw)
    solves_agree(x, it, xj, itj, n)


@pytest.mark.parametrize("symmetric", [False, True])
def test_distributed_pruned_pair_amg_parity(symmetric, rng):
    """Distributed pruned multigrid CG against the JAX package's
    single-device hierarchy over the same padded index space, and (the
    symmetric levels) against the port's full-storage distributed one."""
    jm, tm = meshes(4)
    n = 6000
    dense, rows, cols, vals = banded_spd(rng, n)
    At = tp.distribute_pruned(n, rows, cols, vals, tm, tile_rows=1024, group=4,
                              symmetric=symmetric)
    pruned_layout_is_the_jax_packages(
        jp.distribute_pruned(n, rows, cols, vals, jm, tile_rows=1024, group=4,
                             symmetric=symmetric), At)
    kw = dict(coarse_size=2048, tile_rows=1024, group=4, symmetric=symmetric)
    Md = tp.distributed_pruned_pair_amg(n, rows, cols, vals, tm, fine_A=At, **kw)
    cls = sj.SymmetricPrunedDIAMatrix if symmetric else JaxPruned
    extra = dict(validate=False) if symmetric else {}
    P1 = cls.from_coo(At.n_pad, At.n_pad, rows, cols, vals, tile_rows=min(1024, At.block),
                      group=4, **extra)
    Mj = js.pruned_pair_amg(n, rows, cols, vals, pad_to=At.n_pad, fine_A=P1, **kw)
    assert len(Md.levels) == len(Mj.levels)
    b = dense @ rng.standard_normal(n)
    bp = np.zeros(At.n_pad)
    bp[:n] = b
    skw = dict(tol=0.0, rtol=1e-8, maxiter=60)
    x, it = st.cg_solve(At, At.shard_vector(b), M=Md, **skw)
    xj, itj = js.cg_solve(P1, jnp.asarray(bp), M=Mj, **skw)
    solves_agree(x, it, xj, itj, n)
    _, it0 = st.cg_solve(At, At.shard_vector(b), **skw)
    assert int(it.iterations) < int(it0.iterations)  # multigrid wins
    if symmetric:
        Af = tp.distribute_pruned(n, rows, cols, vals, tm, tile_rows=1024, group=4)
        Mf = tp.distributed_pruned_pair_amg(n, rows, cols, vals, tm, fine_A=Af,
                                            **dict(kw, symmetric=False))
        xf, itf = st.cg_solve(Af, Af.shard_vector(b), M=Mf, **skw)
        solves_agree(x, it, xf, itf, n)


def test_distributed_pruned_matmat_and_block_cg(rng):
    jm, tm = meshes(4)
    n = 4000
    dense, rows, cols, vals = banded_spd(rng, n, shift=0.5)
    Aj = jp.distribute_pruned(n, rows, cols, vals, jm, tile_rows=1024, group=4)
    At = tp.distribute_pruned(n, rows, cols, vals, tm, tile_rows=1024, group=4)
    X = rng.standard_normal((n, 3))
    Yj = np.asarray(Aj.matmat(jp.distribute_vector(X, jm, "rows", Aj.n_pad)))
    Yt = At.matmat(At.shard_vector(X)).numpy()
    assert rel(Yt, Yj) < TOL and rel(Yt[:n], dense @ X) < 1e-10
    B = dense @ rng.standard_normal((n, 3))
    Bp = np.zeros((At.n_pad, 3))
    Bp[:n] = B
    kw = dict(tol=0.0, rtol=1e-10, maxiter=200)
    Xs, it = st.block_cg_solve(At, At.shard_vector(B), **kw)
    Xj, itj = js.block_cg_solve(JaxPruned.from_coo(At.n_pad, At.n_pad, rows, cols, vals,
                                                   tile_rows=1024, group=4), jnp.asarray(Bp), **kw)
    solves_agree(Xs, it, Xj, itj, n, tol=BTOL)
    assert np.abs(Xs.numpy()[:n] - np.linalg.solve(dense, B)).max() < 1e-6


def test_distributed_pruned_rmatvec_and_cgls(rng):
    jm, tm = meshes(8)
    n = 6000
    dense = np.zeros((n, n))
    i = np.arange(n)
    for o in (1, 3, 9):
        dense[i[:-o], i[:-o] + o] = rng.standard_normal(n - o) * 0.2
        dense[i[:-o] + o, i[:-o]] = rng.standard_normal(n - o) * 0.2
    dense[i, i] = 3.0
    rows, cols = np.nonzero(dense)
    vals = dense[rows, cols]
    kw = dict(tile_rows=1024, group=4, with_transpose=True, assume_unique=True)
    Aj = jp.distribute_pruned(n, rows, cols, vals, jm, **kw)
    At = tp.distribute_pruned(n, rows, cols, vals, tm, **kw)
    pruned_layout_is_the_jax_packages(Aj, At)
    x = rng.standard_normal(n)
    yt = At.rmatvec(At.shard_vector(x)).numpy()
    assert rel(yt, np.asarray(jax.jit(lambda A, v: A.rmatvec(v))(Aj, Aj.shard_vector(x)))) < TOL
    assert rel(yt[:n], dense.T @ x) < 1e-10
    A0 = tp.distribute_pruned(n, rows, cols, vals, tm, tile_rows=1024, group=4,
                              assume_unique=True)
    with pytest.raises(NotImplementedError, match="with_transpose"):
        A0.rmatvec(A0.shard_vector(x))
    b = dense @ rng.standard_normal(n)
    bp = np.zeros(At.n_pad)
    bp[:n] = b
    skw = dict(tol=0.0, rtol=1e-10, maxiter=400)
    xs, it = st.cgls_solve(At, At.shard_vector(b), **skw)
    P1 = JaxPruned.from_coo(At.n_pad, At.n_pad, rows, cols, vals, tile_rows=1024, group=4)
    xj, itj = js.cgls_solve(P1.with_transpose(), jnp.asarray(bp), **skw)
    solves_agree(xs, it, xj, itj, n)


def test_distributed_pruned_guards(rng):
    jm, tm = meshes(4)
    with pytest.raises(ValueError, match="reach"):
        tp.distribute_pruned(4096, [0], [4000], [1.0], tm, block=1024)
    n = 6000
    _, rows, cols, vals = banded_spd(rng, n)
    _, tm8 = meshes(8)
    with pytest.raises(ValueError, match="transpose"):
        tp.distribute_pruned(n, rows, cols, vals, tm8, symmetric=True, with_transpose=True)
    v2 = vals.copy()
    v2[np.nonzero(cols > rows)[0][0]] += 1.0
    with pytest.raises(ValueError, match="not symmetric"):
        tp.distribute_pruned(n, rows, cols, v2, tm8, symmetric=True)
    with pytest.raises(ValueError, match="1024-row block floor"):
        tp.distributed_pruned_pair_amg(n, rows, cols, vals, tm8, coarse_size=512,
                                       tile_rows=1024, group=4)


def test_distributed_sym_pruned_parity(rng):
    jm, tm = meshes(8)
    n = 6000
    dense, rows, cols, vals = banded_spd(rng, n)
    Aj = jp.distribute_pruned(n, rows, cols, vals, jm, tile_rows=1024, group=4, symmetric=True)
    At = tp.distribute_pruned(n, rows, cols, vals, tm, tile_rows=1024, group=4, symmetric=True)
    pruned_layout_is_the_jax_packages(Aj, At)
    assert At.symmetric and At.nnz == np.count_nonzero(dense)
    S1 = st.SymmetricPrunedDIAMatrix.from_coo(At.n_pad, At.n_pad, rows, cols, vals,
                                              tile_rows=1024, group=4, validate=False,
                                              device="cpu")
    x = rng.standard_normal(n)
    xt = At.shard_vector(x)
    y = At.matvec(xt)
    assert rel(y.numpy()[:n], dense @ x) < 1e-10
    assert rel(y.numpy(), S1.matvec(xt).numpy()) < 1e-12
    assert torch.equal(At.rmatvec(xt), y)
    products_agree(Aj, At, x, rmatvec=False)
    X = rng.standard_normal((n, 3))
    Yj = np.asarray(Aj.matmat(jp.distribute_vector(X, jm, "rows", Aj.n_pad)))
    assert rel(At.matmat(At.shard_vector(X)).numpy(), Yj) < TOL
    Af = tp.distribute_pruned(n, rows, cols, vals, tm, tile_rows=1024, group=4)
    b = dense @ rng.standard_normal(n)
    kw = dict(tol=0.0, rtol=1e-8, maxiter=60)
    xs, its = st.cg_solve(At, At.shard_vector(b), **kw)
    xf, itf = st.cg_solve(Af, Af.shard_vector(b), **kw)
    solves_agree(xs, its, xf, itf, n, tol=1e-9)


def test_chebyshev_zero_collectives_distributed(rng):
    jm, tm = meshes(8)
    n = 256
    d = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1) + 0.05 * np.eye(n)
    Aj, At = both("CSRMatrix", d)
    Dt = tp.distribute_matrix(At, tm)
    ev = np.linalg.eigvalsh(d)
    kw = dict(degree=6, lmax=ev.max() * 1.05, lmin=ev.min())
    xstar = rng.standard_normal(n)
    b = d @ xstar
    x, it = st.cg_solve(Dt, Dt.shard_vector(b), tol=1e-11, M=st.chebyshev(Dt, **kw))
    xj, itj = js.cg_solve(Aj, jnp.asarray(b), tol=1e-11, M=js.chebyshev(Aj, **kw))
    solves_agree(x, it, xj, itj, n)
    assert np.abs(Dt.unshard_vector(x) - xstar).max() < 1e-7


def test_generalized_lanczos_distributed(rng):
    jm, tm = meshes(8)
    n, k = 64, 8
    adj = np.triu(rng.random((n, n)) < 0.1, 1)
    adj = adj | adj.T
    dA = np.diag(adj.sum(1).astype(float)) - adj + 0.5 * np.eye(n)
    dB = 0.1 * adj + np.diag(1.0 + adj.sum(1) * 0.1)
    dB = (dB + dB.T) / 2
    Aj, At = both("CSRMatrix", dA)
    Bj, Bt = both("CSRMatrix", dB)
    Ad, Bd = tp.distribute_matrix(At, tm), tp.distribute_matrix(Bt, tm)
    v0 = rng.standard_normal(n)
    res = generalized_lanczos(Ad, st.attach_solver(Bd, st.cg(tolerance=1e-14)), k,
                              v0=torch.from_numpy(v0))
    resj = jax_generalized_lanczos(Aj, sj.attach_solver(Bj, js.cg(tolerance=1e-14)), k, v0=v0)
    assert rel(res.alpha.numpy(), np.asarray(resj.alpha)) < 1e-9
    assert rel(res.beta.numpy(), np.asarray(resj.beta)) < 1e-9
    V = res.V.numpy()[:n]
    assert np.linalg.norm(V.T @ dB @ V - np.eye(k), "fro") < 1e-9


# -- the dry run and the carriers ---------------------------------------------------
def test_dryrun_multichip_at_8_shards():
    out = dryrun_multichip(8, device="cpu", verbose=False)
    assert len(out) == 20
    for name, row in out.items():
        it_d, it_1 = row["iterations"]
        assert it_1 is None or it_d == it_1, name
        assert row.get("err", 0.0) < (1e-8 if "block_cg" in name else 1e-10), name


@pytest.mark.parametrize("layout", ["ell", "dia", "pruned", "pruned_sym"])
def test_distributed_from_arrays_carries_the_jax_operator(layout, rng):
    """The JAX operator carried across by ``convert`` applies as the port's
    own and as the JAX package's."""
    jm, tm = meshes(8 if layout != "ell" else 4)
    if layout in ("ell", "dia"):
        n = 150
        dense = laplacian_1d(n) + np.eye(n)
        dense[5, 140] = dense[140, 5] = -0.25
        Aj, At = both("CSRMatrix", dense)
        if layout == "ell":
            Dj, Dt = jp.distribute_matrix(Aj, jm), tp.distribute_matrix(At, tm)
            C = convert.distributed_matrix_from_arrays(
                [np.asarray(a) for a in Dj.nodes], [np.asarray(a) for a in Dj.vals], Dj.offsets,
                Dj.n, Dj.m, Dj.block, Dj.block_cols, Dj.n_shards, device="cpu")
        else:
            Dj, Dt = jp.distribute_matrix_dia(Aj, jm), tp.distribute_matrix_dia(At, tm)
            C = convert.distributed_dia_from_arrays([np.asarray(a) for a in Dj.vals], Dj.terms,
                                                    Dj.n, Dj.block, Dj.n_shards, device="cpu")
    else:
        n = 6000
        dense, rows, cols, vals = banded_spd(rng, n)
        sym = layout == "pruned_sym"
        kw = dict(tile_rows=1024, group=4, symmetric=sym, with_transpose=not sym)
        Dj = jp.distribute_pruned(n, rows, cols, vals, jm, **kw)
        Dt = tp.distribute_pruned(n, rows, cols, vals, tm, **kw)
        names = ("data", "tile", "first", "rowoff", "laneoff")
        C = convert.distributed_pruned_from_arrays(
            {k: np.asarray(getattr(Dj, k)) for k in names}, Dj.n, Dj.block, Dj.halo_words,
            Dj.halo_E, Dj.nnz, Dj.n_shards, symmetric=sym,
            transpose=None if sym else {k: np.asarray(getattr(Dj, "t" + k)) for k in names},
            t_halo_E=Dj.t_halo_E, device="cpu")
    assert type(C) is type(Dt) and C.n_pad == Dt.n_pad
    x = rng.standard_normal(n)
    xj, xt = Dj.shard_vector(x), C.shard_vector(x)
    want = np.asarray(Dj.matvec(xj))
    assert rel(C.matvec(xt).numpy(), want) < TOL and rel(Dt.matvec(xt).numpy(), want) < TOL
    if layout != "dia":
        wt = np.asarray(Dj.rmatvec(xj))
        assert rel(C.rmatvec(xt).numpy(), wt) < TOL and rel(Dt.rmatvec(xt).numpy(), wt) < TOL
