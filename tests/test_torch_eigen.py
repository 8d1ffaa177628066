"""The port's eigensolvers (Lanczos, generalized Lanczos, eigenpair
refinement, shift-invert Lanczos) and 3-D FEM pencil held against the JAX
package on the CPU in f64, from the same numpy inputs; the JAX side runs
as ``tests/test_eigensolver.py`` runs it.

A Lanczos breakdown draws a fresh random direction: the JAX package folds
the step number into a fixed key, the port draws from a fixed
``torch.Generator`` in turn, so after a breakdown the two bases differ and
those cases are held to their invariants (an orthonormal basis with no
zero vector, the right Ritz values), not to each other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import sigma_tpu
import sigma_tpu.fem
from sigma_tpu.eigen import eigensolve as jax_eigensolve
from sigma_tpu.eigen import generalized_eigensolve as jax_generalized_eigensolve
from sigma_tpu.eigen import generalized_lanczos as jax_generalized_lanczos
from sigma_tpu.eigen import lanczos as jax_lanczos
from sigma_tpu.eigen import refine_eigenpairs as jax_refine_eigenpairs
from sigma_tpu.eigen import shift_invert_lanczos as jax_shift_invert_lanczos
from sigma_tpu.graph.graph import DIAGraph as JaxDIAGraph
from sigma_tpu.matrix.pruned import PrunedDIAMatrix as JaxPruned
from sigma_tpu.solvers import cg as jax_cg
from sigma_tpu.solvers import cg_solve as jax_cg_solve
from sigma_tpu.solvers import pruned_pair_amg as jax_pruned_pair_amg
from sigma_tpu.solvers import structured_pair_amg as jax_structured_pair_amg
import sigma_tpu_torch as st
from sigma_tpu_torch.eigen import refine_eigenpairs, shift_invert_lanczos
from sigma_tpu_torch.utils import to_numpy

CPU = "cpu"
F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def graph_laplacian(rng, n, p=None):
    p = p or np.log2(n) / n
    adj = np.triu(rng.random((n, n)) < p, 1)
    adj = adj | adj.T
    return np.diag(adj.sum(1).astype(float)) - adj.astype(float)


def csr_pair(dense):
    n = dense.shape[0]
    r, c = np.nonzero(dense)
    v = dense[r, c]
    return (sigma_tpu.CSRMatrix.from_coo(n, n, r, c, v),
            st.CSRMatrix.from_coo(n, n, r, c, v, dtype=F64, device=CPU))


def fem_torus(nx, ny):
    """COO triples of the P1 stiffness and mass on a triangulated periodic
    grid (``tests/test_eigensolver.py``'s ``fem_torus``)."""
    n = nx * ny

    def vid(i, j):
        return (i % nx) * ny + (j % ny)

    tris = []
    for i in range(nx):
        for j in range(ny):
            tris.append((vid(i, j), vid(i + 1, j), vid(i, j + 1)))
            tris.append((vid(i + 1, j + 1), vid(i, j + 1), vid(i + 1, j)))
    tris = np.array(tris)
    AE = 0.5 * np.array([[2.0, -1.0, -1.0], [-1.0, 1.0, 0.0], [-1.0, 0.0, 1.0]])
    ME = (0.5 / 12.0) * np.array([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]])
    rows = np.repeat(tris, 3, axis=1).ravel()
    cols = np.tile(tris, (1, 3)).ravel()
    return n, rows, cols, np.tile(AE.ravel(), len(tris)), np.tile(ME.ravel(), len(tris))


def torus_pencils(nx, ny):
    """((A_jax, B_jax), (A_port, B_port)) in f64 CSR, duplicates summed."""
    n, r, c, a, m = fem_torus(nx, ny)
    jax_pair = tuple(sigma_tpu.CSRMatrix.from_coo(n, n, r, c, v) for v in (a, m))
    port_pair = tuple(st.CSRMatrix.from_coo(n, n, r, c, v, dtype=F64, device=CPU)
                      for v in (a, m))
    return jax_pair, port_pair


def recurrence_residual(dA, dB, res):
    """max |A V - B V T - beta_last B v_next e_last^T| of a Lanczos result
    (dB None: the standard process)."""
    V, T = to_numpy(res.V), to_numpy(res.tridiagonal())
    BV = V if dB is None else dB @ V
    R = dA @ V - BV @ T
    v_next = to_numpy(res.v_next)
    R[:, -1] -= float(res.beta[-1]) * (v_next if dB is None else dB @ v_next)
    return np.abs(R).max()


def assert_same_recurrence(rt, rj, tol=1e-10):
    """alpha, beta and the Ritz values of T agree up to the first breakdown
    (the whole run when there is none): after a breakdown (beta = 0) each
    package continues from its own random restart direction, and after a
    near-breakdown (beta below 1e-8 of its largest, the invariant subspace
    found to rounding) from its own rounding noise.  Returns that prefix's
    length."""
    aj, bj = np.asarray(rj.alpha), np.asarray(rj.beta)
    at, bt = rt.alpha.numpy(), rt.beta.numpy()
    zeros = np.nonzero(bj <= 1e-8 * np.abs(bj).max())[0]
    p = int(zeros[0]) + 1 if zeros.size else bj.size
    assert np.abs(at[:p] - aj[:p]).max() <= tol * np.abs(aj[:p]).max()
    assert np.abs(bt[:p] - bj[:p]).max() <= tol * np.abs(bj[:p]).max()
    tt = np.linalg.eigvalsh(rt.tridiagonal().numpy()[:p, :p])
    tj = np.linalg.eigvalsh(np.asarray(rj.tridiagonal())[:p, :p])
    assert np.abs(tt - tj).max() <= tol * np.abs(tj).max()
    return p


# -- standard Lanczos -----------------------------------------------------------
@pytest.mark.parametrize("n,k", [(64, None), (80, 25)], ids=["full", "partial_k"])
def test_lanczos_matches_jax(rng, n, k):
    dA = graph_laplacian(rng, n)
    v0 = rng.standard_normal(n)
    Aj, At = csr_pair(dA)
    rj = jax_lanczos(Aj, k or n, v0=v0)
    rt = st.lanczos(At, k, v0=v0)
    k = k or n
    assert rt.V.shape == (n, k) and rt.alpha.shape == rt.beta.shape == (k,)
    assert rt.alpha.dtype == F64
    p = assert_same_recurrence(rt, rj)
    scale = max(1.0, np.abs(dA).max())
    assert recurrence_residual(dA, None, rt) / scale < 1e-12
    V = rt.V.numpy()
    assert np.linalg.norm(V.T @ V - np.eye(k), "fro") < k * 1e-14
    np.testing.assert_allclose(V[:, :p], np.asarray(rj.V)[:, :p], atol=1e-10)


def test_eigensolve_matches_jax_and_dense(rng):
    n = 48
    dA = graph_laplacian(rng, n) + np.eye(n)
    v0 = rng.standard_normal(n)
    Aj, At = csr_pair(dA)
    lam_j, _ = jax_eigensolve(Aj, v0=v0)
    lam, V = st.eigensolve(At, v0=v0)
    lam, V = lam.numpy(), V.numpy()
    assert np.abs(lam - np.asarray(lam_j)).max() < 1e-10
    assert np.abs(np.sort(lam) - np.linalg.eigvalsh(dA)).max() < 1e-10
    assert np.abs(dA @ V - V * lam).max() < 1e-10
    # the same sign normalization: largest-magnitude component positive
    assert np.all(V[np.argmax(np.abs(V), axis=0), np.arange(n)] > 0)


def test_lanczos_default_start_vector_and_validation():
    A = st.DenseOperator(torch.eye(5, dtype=F64))
    with pytest.raises(ValueError):
        st.lanczos(A, 9)
    with pytest.raises(ValueError):
        st.generalized_lanczos(A, st.DenseOperator(torch.eye(4, dtype=F64)), 3)
    with pytest.raises(ValueError):
        st.lanczos(st.DenseOperator(torch.zeros(3, 4, dtype=F64)), 2)
    # without v0 the start vector is drawn with the given generator
    dA = np.diag(np.arange(1.0, 6.0)) + 0.1
    A = st.DenseOperator(torch.from_numpy(dA))
    r1 = st.lanczos(A, 3, generator=torch.Generator().manual_seed(4))
    r2 = st.lanczos(A, 3, v0=torch.randn(5, generator=torch.Generator().manual_seed(4),
                                         dtype=F64))
    np.testing.assert_array_equal(r1.V.numpy(), r2.V.numpy())


def test_lanczos_breakdown_restart_invariants():
    """The identity breaks down at the first step and a matrix with
    repeated eigenvalues at its distinct count: every restart direction
    must be a unit vector orthogonal to the basis, so the Ritz values come
    out with full multiplicity and no spurious zero pairs.  The restart
    vectors come from the port's own generator, not the JAX key."""
    lam, V = st.eigensolve(st.DenseOperator(torch.eye(6, dtype=F64)))
    assert np.allclose(lam.numpy(), 1.0)
    lam_j, _ = jax_eigensolve(sigma_tpu.DenseOperator(jnp.eye(6)))
    assert np.abs(np.sort(lam.numpy()) - np.sort(np.asarray(lam_j))).max() < 1e-12
    d = np.diag([1.0, 1.0, 2.0, 2.0, 3.0, 3.0, 3.0])
    res = st.lanczos(st.DenseOperator(torch.from_numpy(d)))
    beta = res.beta.numpy()
    assert np.count_nonzero(beta[:-1] == 0.0) >= 2  # breakdowns did happen
    V = res.V.numpy()
    assert np.linalg.norm(V, axis=0).min() > 0.5  # no zero basis vector
    np.testing.assert_allclose(V.T @ V, np.eye(7), atol=1e-12)
    lam2, V2 = st.eigensolve(st.DenseOperator(torch.from_numpy(d)))
    lam2, V2 = lam2.numpy(), V2.numpy()
    assert np.allclose(np.sort(lam2), np.diag(d))
    assert np.max(np.abs(d @ V2 - V2 * lam2)) < 1e-12
    lam2_j, _ = jax_eigensolve(sigma_tpu.DenseOperator(jnp.asarray(d)))
    assert np.abs(np.sort(lam2) - np.sort(np.asarray(lam2_j))).max() < 1e-12


def test_lanczos_small_scaled_operator_f32(rng):
    """An operator scaled far below 1 (h^3-type FEM scales) in f32 must not
    trip the breakdown branch every step, and its extreme eigenvalue
    converges to f32-level relative accuracy (in f32 here; the JAX test's
    DenseOperator carries no dtype and runs in its default f64)."""
    n = 512
    d = np.sort(rng.random(n)).astype(np.float32)
    d[-1] = 2.0
    scale = 1e-5
    v0 = rng.standard_normal(n).astype(np.float32)
    A = st.aslinearoperator(torch.from_numpy(np.diag(scale * d).astype(np.float32)))
    res = st.lanczos(A, 25, v0=v0)
    assert res.alpha.dtype == torch.float32 and res.V.dtype == torch.float32
    beta = res.beta.numpy()
    assert np.count_nonzero(beta[:-1]) == beta.size - 1
    theta = np.linalg.eigvalsh(res.tridiagonal().double().numpy())
    assert abs(theta[-1] - scale * d[-1]) / (scale * d[-1]) < 1e-4
    rj = jax_lanczos(sigma_tpu.aslinearoperator(jnp.asarray(np.diag(scale * d), jnp.float32)),
                     25, v0=v0)
    theta_j = np.linalg.eigvalsh(np.asarray(rj.tridiagonal(), np.float64))
    assert abs(theta[-1] - theta_j[-1]) / theta_j[-1] < 1e-4


# -- generalized Lanczos ----------------------------------------------------------
def test_generalized_lanczos_matches_jax(rng):
    (Aj, Bj), (At, Bt) = torus_pencils(6, 6)
    n, k = At.shape[0], 20
    v0 = rng.standard_normal(n)
    rj = jax_generalized_lanczos(Aj, sigma_tpu.attach_solver(Bj, jax_cg(tolerance=1e-14)), k,
                                 v0=v0)
    rt = st.generalized_lanczos(At, st.attach_solver(Bt, st.cg(tolerance=1e-14)), k, v0=v0)
    p = assert_same_recurrence(rt, rj)
    dA, dB = At.to_dense(), Bt.to_dense()
    assert recurrence_residual(dA, dB, rt) < 1e-13
    V = rt.V.numpy()
    assert np.linalg.norm(V.T @ dB @ V - np.eye(k), "fro") < 1e-13
    np.testing.assert_allclose(V[:, :p], np.asarray(rj.V)[:, :p], atol=1e-9)


def test_generalized_eigensolve_matches_jax_and_dense(rng):
    (Aj, Bj), (At, Bt) = torus_pencils(4, 4)
    v0 = rng.standard_normal(At.shape[0])
    lam_j, _ = jax_generalized_eigensolve(
        Aj, sigma_tpu.attach_solver(Bj, jax_cg(tolerance=1e-14)), v0=v0)
    lam, V = st.generalized_eigensolve(At, st.attach_solver(Bt, st.cg(tolerance=1e-14)), v0=v0)
    lam = np.sort(lam.numpy())
    ref = scipy.linalg.eigh(At.to_dense(), Bt.to_dense(), eigvals_only=True)
    assert np.abs(lam - ref).max() < 1e-8
    assert np.abs(lam - np.sort(np.asarray(lam_j))).max() < 1e-10
    V = V.numpy()
    np.testing.assert_allclose(V.T @ Bt.to_dense() @ V, np.eye(V.shape[1]), atol=1e-8)


def test_generalized_default_solver(rng):
    """A bare B operand uses the default CG facade in both packages."""
    (Aj, Bj), (At, Bt) = torus_pencils(3, 3)
    v0 = rng.standard_normal(9)
    rt = st.generalized_lanczos(At, Bt, 5, v0=v0)
    rj = jax_generalized_lanczos(Aj, Bj, 5, v0=v0)
    V = rt.V.numpy()
    assert np.linalg.norm(V.T @ Bt.to_dense() @ V - np.eye(5), "fro") < 1e-10
    assert_same_recurrence(rt, rj, tol=1e-9)


# -- the 3-D FEM pencil -------------------------------------------------------------
@pytest.mark.parametrize("nx", [3, 4, 7])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fem3d_arrays_bit_for_bit(nx, dtype):
    got = st.fem.fem3d_stiffness_mass_dia(nx, dtype=dtype)
    want = sigma_tpu.fem.fem3d_stiffness_mass_dia(nx, dtype=dtype)
    assert got[0] == want[0] and got[1] == want[1]
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    for count in (1, 10, nx**3):
        np.testing.assert_array_equal(st.fem.fem3d_generalized_spectrum(nx, count),
                                      sigma_tpu.fem.fem3d_generalized_spectrum(nx, count))


def test_fem3d_rejects_bad_sizes():
    with pytest.raises(ValueError):
        st.fem.fem3d_stiffness_mass_dia(2)
    with pytest.raises(ValueError):
        st.fem.fem3d_generalized_spectrum(3, 28)


def jax_fem3d_pair(nx):
    """The JAX package's pencil as ``tests/test_eigensolver.py`` builds it."""
    n, offs, Kd, Md = sigma_tpu.fem.fem3d_stiffness_mass_dia(nx)

    def mk(data):
        g = JaxDIAGraph(offsets=offs, shape=(n, n), nnz=int(np.count_nonzero(data)))
        return sigma_tpu.DIAMatrix(graph=g, data=jnp.asarray(data.reshape(len(offs), -1, 128)))

    return mk(Kd), mk(Md)


def port_fem3d_pair(nx, dtype=F64):
    return st.fem.fem3d_pencil_dia(*st.fem.fem3d_stiffness_mass_dia(nx), dtype=dtype, device=CPU)


def test_fem3d_pencil_dia_matches_jax():
    Kj, Mj = jax_fem3d_pair(4)
    K, M = port_fem3d_pair(4)
    assert K.graph.offsets == tuple(Kj.graph.offsets) and K.graph.nnz == Kj.graph.nnz
    assert M.graph.nnz == Mj.graph.nnz
    np.testing.assert_array_equal(K.to_dense(), np.asarray(Kj.to_dense()))
    np.testing.assert_array_equal(M.to_dense(), np.asarray(Mj.to_dense()))
    K32, _ = port_fem3d_pair(4, torch.float32)
    assert K32.dtype == torch.float32 and K32.device.type == CPU
    lam = scipy.linalg.eigh(K.to_dense(), M.to_dense(), eigvals_only=True)
    assert rel(st.fem.fem3d_generalized_spectrum(4, 10), lam[:10]) < 1e-12


def test_fem3d_inverse_generalized_lanczos_lowest(rng):
    """The pencil (M, K) with a CG-solved K: the top Ritz values are the
    reciprocals of the lowest K x = mu M x eigenvalues, to 1e-9 of the
    analytic spectrum in both packages."""
    nx = 5
    n = nx**3
    v0 = rng.standard_normal(n)
    Kj, Mj = jax_fem3d_pair(nx)
    K, M = port_fem3d_pair(nx)
    rj = jax_generalized_lanczos(Mj, sigma_tpu.attach_solver(Kj, jax_cg(tolerance=1e-14)), 40,
                                 v0=v0)
    rt = st.generalized_lanczos(M, st.attach_solver(K, st.cg(tolerance=1e-14)), 40, v0=v0)
    mu = st.fem.fem3d_generalized_spectrum(nx, 3)
    got = []
    for res in (rt, rj):
        theta = np.sort(np.linalg.eigvalsh(np.asarray(res.tridiagonal())))[::-1]
        got.append(np.sort(1.0 / theta[:3]))
        assert np.max(np.abs(got[-1] - mu) / mu) < 1e-9
    assert np.max(np.abs(got[0] - got[1]) / mu) < 1e-9
    # the recurrences agree bit-near for the first 15 steps; once Ritz
    # values converge, Lanczos amplifies rounding differences (forward
    # instability), so only that prefix is compared
    np.testing.assert_allclose(rt.alpha.numpy()[:15], np.asarray(rj.alpha)[:15], rtol=1e-12)
    np.testing.assert_allclose(rt.beta.numpy()[:15], np.asarray(rj.beta)[:15], rtol=1e-12)


def test_structured_hierarchy_on_the_27_point_stiffness_matches_jax():
    """``structured_pair_amg`` on the 27-point Q1 stiffness (nx = 7) gives
    the JAX package's hierarchy level for level, and the same V-cycle."""
    nx = 7
    Kj, _ = jax_fem3d_pair(nx)
    K, _ = port_fem3d_pair(nx)
    Mj = jax_structured_pair_amg(Kj, (nx,) * 3, coarse_size=8)
    Mt = st.structured_pair_amg(K, (nx,) * 3, coarse_size=8)
    assert len(Mt.levels) == len(Mj.levels) >= 2
    for lj, lt in zip(Mj.levels, Mt.levels):
        assert lt.dims == lj.dims and lt.axes == lj.axes and lt.omega == lj.omega
        assert tuple(lt.A.graph.offsets) == tuple(lj.A.graph.offsets)
        assert rel(to_numpy(lt.A.data), np.asarray(lj.A.data2d)) <= 1e-12
        assert rel(lt.dinv.numpy(), np.asarray(lj.dinv)) <= 1e-12
    assert rel(Mt.coarse_inv.numpy(), np.asarray(Mj.coarse_inv)) <= 1e-12
    r = np.random.default_rng(5).standard_normal(nx**3)
    assert rel(Mt.matvec(torch.from_numpy(r)), jax.jit(type(Mj).matvec)(Mj, jnp.asarray(r))) <= 1e-12


# -- eigenpair refinement -------------------------------------------------------------
def banded_spd(rng, n, offsets):
    """A random SPD band whose low spectrum clusters just above 1e-3 (the
    operators of ``tests/test_eigensolver.py``'s refinement tests)."""
    dense = np.zeros((n, n))
    i = np.arange(n)
    for o in offsets:
        v = -np.abs(rng.random(n - o)) * 0.4
        dense[i[:-o], i[:-o] + o] = v
        dense[i[:-o] + o, i[:-o]] = v
    dense[i, i] = np.abs(dense).sum(1) + 1e-3
    rows, cols = np.nonzero(dense)
    return dense, rows, cols, dense[rows, cols]


def test_refine_eigenpairs_over_pruned_matches_jax(rng):
    n = 1500
    dense, rows, cols, vals = banded_spd(rng, n, (1, 3, 8))
    w_ref, V_ref = np.linalg.eigh(dense)
    V0 = V_ref[:, :3] + 1e-3 * rng.standard_normal((n, 3))
    kw = dict(steps=6, rtol=1e-12, inner_tol=1e-6, inner_maxiter=300)
    pk = dict(tile_rows=1024, group=4)
    P64j = JaxPruned.from_coo(n, n, rows, cols, vals, dtype=np.float64, **pk)
    P32j = JaxPruned.from_coo(n, n, rows, cols, vals.astype(np.float32), dtype=np.float32, **pk)
    Mgj = jax_pruned_pair_amg(n, rows, cols, vals.astype(np.float32), coarse_size=256, **pk)
    ref_j = jax_refine_eigenpairs(P64j, jnp.asarray(V0), A_lo=P32j, M_lo=Mgj, **kw)
    P64 = st.PrunedDIAMatrix.from_coo(n, n, rows, cols, vals, dtype=F64, device=CPU, **pk)
    P32 = st.PrunedDIAMatrix.from_coo(n, n, rows, cols, vals.astype(np.float32),
                                      dtype=torch.float32, device=CPU, **pk)
    Mg = st.pruned_pair_amg(n, rows, cols, vals.astype(np.float32), coarse_size=256,
                            device=CPU, **pk)
    ref = refine_eigenpairs(P64, V0, A_lo=P32, M_lo=Mg, **kw)
    assert isinstance(ref.eigenvalues, np.ndarray) and isinstance(ref.rayleigh_before, np.ndarray)
    assert ref.eigenvectors.dtype == F64 and ref.eigenvectors.device.type == CPU
    assert np.abs(ref.eigenvalues - w_ref[:3]).max() < 1e-10
    assert np.abs(ref_j.eigenvalues - w_ref[:3]).max() < 1e-10
    assert np.abs(ref.eigenvalues - ref_j.eigenvalues).max() < 1e-10
    np.testing.assert_allclose(ref.rayleigh_before, ref_j.rayleigh_before, rtol=1e-12)
    for j in range(3):
        v = ref.eigenvectors[:, j].numpy()
        r = dense @ v - ref.eigenvalues[j] * v
        v0 = V0[:, j] / np.linalg.norm(V0[:, j])
        r0 = dense @ v0 - float(v0 @ dense @ v0) * v0
        assert np.linalg.norm(r) < 2e-7
        assert np.linalg.norm(r) < 1e-2 * np.linalg.norm(r0)


@pytest.mark.parametrize("use_fixed", [True, False], ids=["fixed_sweeps", "host_loop"])
def test_refine_eigenpairs_one_step_matches_jax(rng, use_fixed):
    """One step (no QR) on a DIA operator: the fixed-sweep and the
    early-exit column solves, with A_lo cast from A."""
    n = 600
    dense, rows, cols, vals = banded_spd(rng, n, (1, 2, 5))
    w_ref, V_ref = np.linalg.eigh(dense)
    V0 = V_ref[:, :2] + 1e-4 * rng.standard_normal((n, 2))
    Aj = sigma_tpu.DIAMatrix.from_coo(n, n, rows, cols, vals, dtype=jnp.float64)
    At = st.DIAMatrix.from_coo(n, n, rows, cols, vals, dtype=F64, device=CPU)
    ref_j = jax_refine_eigenpairs(Aj, jnp.asarray(V0), use_fixed=use_fixed, inner_maxiter=2000)
    ref = refine_eigenpairs(At, torch.from_numpy(V0), use_fixed=use_fixed,
                               inner_maxiter=2000)
    np.testing.assert_allclose(ref.eigenvalues, ref_j.eigenvalues, rtol=1e-10)
    np.testing.assert_allclose(ref.rayleigh_before, ref_j.rayleigh_before, rtol=1e-12)
    assert np.all(np.abs(ref.eigenvalues - w_ref[:2]) <= np.abs(ref.rayleigh_before - w_ref[:2]))
    Vr = ref.eigenvectors.numpy()
    np.testing.assert_allclose(np.abs(np.sum(Vr * np.asarray(ref_j.eigenvectors), axis=0)), 1.0,
                               atol=1e-10)


# -- shift-invert Lanczos -------------------------------------------------------------
def test_shift_invert_lanczos_matches_jax_and_dense(rng):
    n = 2000
    dense, rows, cols, vals = banded_spd(rng, n, (1, 2, 7))
    w_ref = np.linalg.eigvalsh(dense)
    sigma = 0.9 * w_ref[0]
    vs = vals.copy()
    vs[rows == cols] -= sigma
    pk = dict(tile_rows=1024, group=4)
    Psj = JaxPruned.from_coo(n, n, rows, cols, vs.astype(np.float32), dtype=np.float32, **pk)
    Mgj = jax_pruned_pair_amg(n, rows, cols, vs.astype(np.float32), coarse_size=512, **pk)
    inner_j = jax.jit(lambda A_, M_, r_: jax_cg_solve(A_, r_, tol=0.0, rtol=1e-6, maxiter=400,
                                                      M=M_)[0])
    res_j = jax_shift_invert_lanczos(
        n, rows, cols, vals, sigma=sigma, m=3, k=24,
        inner_solve=lambda r32: np.asarray(inner_j(Psj, Mgj, jnp.asarray(r32))))
    Ps = st.PrunedDIAMatrix.from_coo(n, n, rows, cols, vs.astype(np.float32),
                                     dtype=torch.float32, device=CPU, **pk)
    Mg = st.pruned_pair_amg(n, rows, cols, vs.astype(np.float32), coarse_size=512,
                            device=CPU, **pk)
    seen = []

    def inner(r32):
        seen.append((r32.dtype, r32.device.type))
        return st.cg_solve(Ps, r32, tol=0.0, rtol=1e-6, maxiter=400, M=Mg)[0]

    res = shift_invert_lanczos(n, rows, cols, vals, sigma=sigma, m=3, k=24,
                                  inner_solve=inner, device=CPU)
    assert set(seen) == {(torch.float32, CPU)}
    assert res.steps == res_j.steps == 24
    assert res.eigenvectors.dtype == F64 and tuple(res.eigenvectors.shape) == (n, 3)
    assert np.abs(res.eigenvalues - res_j.eigenvalues).max() < 1e-10
    assert np.abs(res.eigenvalues - w_ref[:3]).max() < 1e-10
    assert res.residuals.max() < 1e-9 and res_j.residuals.max() < 1e-9
    W = res.eigenvectors.numpy()
    np.testing.assert_allclose(W.T @ W, np.eye(3), atol=1e-8)
    np.testing.assert_allclose(np.abs(np.sum(W * res_j.eigenvectors, axis=0)), 1.0, atol=1e-8)


def test_shift_invert_lanczos_breakdown_and_missing_diag(rng):
    """(a) a breakdown before m steps returns the pairs found; (b) rows
    with no stored diagonal still get the full sigma I shift; both
    packages."""
    n = 300
    i = np.arange(n)
    inner_j = jax.jit(lambda A_, r_: jax_cg_solve(A_, r_, tol=0.0, rtol=1e-7, maxiter=50)[0])

    def inner_t(A):
        return lambda r32: st.cg_solve(A, r32, tol=0.0, rtol=1e-7, maxiter=50)[0]

    dval = np.float32(2.0 - 0.9 * 2.0)
    res_j = jax_shift_invert_lanczos(
        n, i, i, np.full(n, 2.0), sigma=0.9 * 2.0, m=3, k=10,
        inner_solve=lambda r32: np.asarray(
            inner_j(sigma_tpu.DiagonalOperator(jnp.full((n,), dval)), jnp.asarray(r32))))
    res = shift_invert_lanczos(
        n, i, i, np.full(n, 2.0), sigma=0.9 * 2.0, m=3, k=10, device=CPU,
        inner_solve=inner_t(st.DiagonalOperator(torch.full((n,), float(dval)))))
    assert res.steps == res_j.steps < 3
    assert res.eigenvalues.size == res.steps and res.eigenvectors.shape[1] == res.steps
    assert np.allclose(res.eigenvalues, 2.0, atol=1e-10)

    nb = 100
    n2 = 2 * nb
    even = 2 * np.arange(nb)
    odd = even + 1
    dvals = 2.0 + rng.random(nb)
    bvals = 0.4 + 0.1 * rng.random(nb)
    r = np.concatenate([even, even, odd])
    c = np.concatenate([even, odd, even])
    v = np.concatenate([dvals, bvals, bvals])
    dense = np.zeros((n2, n2))
    dense[r, c] = v
    w_ref = np.linalg.eigvalsh(dense)
    sigma = 1.1 * w_ref[0]  # negative lowest: sigma < lambda_1 < 0
    dense_s = (dense - sigma * np.eye(n2)).astype(np.float32)
    res2_j = jax_shift_invert_lanczos(
        n2, r, c, v, sigma=sigma, m=3, k=40,
        inner_solve=lambda r32: np.asarray(
            inner_j(sigma_tpu.DenseOperator(jnp.asarray(dense_s)), jnp.asarray(r32))))
    res2 = shift_invert_lanczos(n2, r, c, v, sigma=sigma, m=3, k=40, device=CPU,
                                   inner_solve=inner_t(st.DenseOperator(torch.from_numpy(dense_s))))
    assert res2.steps == res2_j.steps
    assert np.abs(res2.eigenvalues - w_ref[:3]).max() < 1e-8
    assert np.abs(res2.eigenvalues - res2_j.eigenvalues).max() < 1e-8


def _matrix_free_laplacian(n):
    """The 1-D Dirichlet Laplacian as a MatvecOperator that holds no
    tensor: its device is None, so only the start vector can place it."""
    def mv(_, x):
        y = 2 * x
        y[1:] -= x[:-1]
        y[:-1] -= x[1:]
        return y

    return st.MatvecOperator(params=(), mv=mv, rmv=mv, shape=(n, n))


def _laplacian_1d_dia(n):
    i = np.arange(n)
    return st.DIAMatrix.from_coo(n, n, np.r_[i, i[:-1], i[1:]], np.r_[i, i[1:], i[:-1]],
                                 np.r_[np.full(n, 2.0), -np.ones(2 * (n - 1))], dtype=F64,
                                 device=CPU)


def test_matrix_free_lanczos_and_lobpcg_run_on_a_given_cpu_start():
    """A matrix-free operator with an explicit CPU start vector (block)
    runs on the CPU: Lanczos equal to the same recurrence on the DIA
    matrix, LOBPCG on the analytic spectrum."""
    n = 120
    op, A = _matrix_free_laplacian(n), _laplacian_1d_dia(n)
    assert op.device is None
    v0 = torch.from_numpy(np.random.default_rng(0).standard_normal(n))
    res, ref = st.lanczos(op, 30, v0=v0), st.lanczos(A, 30, v0=v0)
    assert res.V.device.type == CPU
    np.testing.assert_allclose(res.alpha.numpy(), ref.alpha.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(res.beta.numpy(), ref.beta.numpy(), rtol=1e-12, atol=1e-12)
    X0 = torch.from_numpy(np.random.default_rng(1).standard_normal((n, 3)))
    eig = st.lobpcg(op, X0, tol=1e-8, maxiter=500)
    exact = 2 - 2 * np.cos(np.pi * np.arange(1, 4) / (n + 1))
    assert eig.eigenvectors.device.type == CPU
    np.testing.assert_allclose(np.sort(eig.eigenvalues.numpy()), exact, rtol=1e-6)
    gen = torch.Generator().manual_seed(3)  # a CPU generator places the draw too
    assert st.lanczos(op, 10, generator=gen).V.device.type == CPU


@pytest.mark.parametrize("call", [lambda op: st.lanczos(op, 10), lambda op: st.eigensolve(op, 10),
                                  lambda op: st.lobpcg(op, m=2)],
                         ids=["lanczos", "eigensolve", "lobpcg"])
def test_matrix_free_default_start_asks_resolve_device(call, monkeypatch):
    """With no tensor, start vector or generator to place it, the start is
    drawn on the card (``resolve_device``), not on the CPU: without a card
    that raises resolve_device's error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(_matrix_free_laplacian(64))
