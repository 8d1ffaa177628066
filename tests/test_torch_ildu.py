"""The port's ILDU(0) / ILU(k) / IC(0) held against the JAX package on the
CPU in f64, after ``tests/test_solvers.py`` (IC(0) as solver and
preconditioner, exactness on a tridiagonal matrix, the transposed apply,
the factorization identity, the dense fallback, ILU(k), the multicolour
ordering, fused CG) and ``tests/test_native.py`` (the host routines
against their plain versions).

The same numpy inputs go to both packages.  Factors, dependency levels
and level packs equal the JAX package's exactly (the same C++ on the same
values; the JAX pack read without its sentinel rows); the sweeps agree to
1e-12 relative, on each package's own set-up and on the JAX factorization
carried across by ``convert.ildu_from_arrays``; solves take equal
iteration counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu as sj
import sigma_tpu.solvers as js
from sigma_tpu.native import iluk_symbolic as jax_iluk_symbolic
from sigma_tpu.solvers import ildu as jildu
import sigma_tpu_torch as st
from sigma_tpu_torch import convert, native
from sigma_tpu_torch.solvers import ildu as tildu
from sigma_tpu_torch.utils import ordered_sum

from conftest import laplacian_2d
from test_torch_jax_host import jax_host_library

torch.set_num_threads(1)
jax_host_library()  # the bit-for-bit checks need the JAX host library, not its fallback

TOL = 1e-12


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def laplacian_1d(n, c=0.0):
    dx = 1.0 / (n + 1)
    dense = (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0 + c * dx / 2), 1)
             + np.diag(np.full(n - 1, -1.0 - c * dx / 2), -1))
    return dense, dx


def random_spd_laplacian(rng, n):
    """ER graph Laplacian + I (reference solver_test_jacobi)."""
    mask = np.triu(rng.random((n, n)) < np.log2(n) / n, k=1)
    z = np.where(mask, rng.random((n, n)), 0.0)
    off = z + z.T
    return np.diag(1.0 + off.sum(axis=1)) - off


def smoothed_manufactured_solution(rng, dense):
    v0 = rng.random(dense.shape[0])
    return v0 + (v0 - dense @ v0) / np.diag(dense)


def csr_both(dense):
    n = dense.shape[0]
    r, c = np.nonzero(dense)
    return (st.CSRMatrix.from_coo(n, n, r, c, dense[r, c], dtype=torch.float64, device="cpu"),
            sj.CSRMatrix.from_coo(n, n, r, c, dense[r, c], dtype=jnp.float64))


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def dense_factors(L, d, U, n):
    (Lp, Li, Lx), (Up, Ui, Ux) = L, U
    Ld, Ud = np.eye(n), np.eye(n)
    for i in range(n):
        Ld[i, Li[Lp[i] : Lp[i + 1]]] = Lx[Lp[i] : Lp[i + 1]]
        Ud[i, Ui[Up[i] : Up[i + 1]]] = Ux[Up[i] : Up[i + 1]]
    return Ld @ np.diag(d) @ Ud


def nonsym_dense(rng, n):
    d = random_spd_laplacian(rng, n)
    return d + 0.3 * np.triu(d != 0, 1)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_factors_are_the_jax_packages_bit_for_bit(rng, k):
    dense = nonsym_dense(rng, 60)
    A, Aj = csr_both(dense)
    got, want = tildu.iluk_factorize(A, k), jildu.iluk_factorize(Aj, k)
    for part in (0, 2):
        for a, b in zip(got[part], want[part]):
            assert np.array_equal(a, b)
    assert np.array_equal(got[1], want[1])


def test_factorization_identity(rng):
    """L D U equals A on A's pattern."""
    n = 40
    dense = random_spd_laplacian(rng, n)
    A, _ = csr_both(dense)
    prod = dense_factors(*st.ildu0_factorize(A), n)
    mask = dense != 0
    np.testing.assert_allclose(prod[mask], dense[mask], atol=1e-12)


def test_iluk_full_fill_is_exact_lu(rng):
    n = 36
    dense = random_spd_laplacian(rng, n)
    A, _ = csr_both(dense)
    np.testing.assert_allclose(dense_factors(*tildu.iluk_factorize(A, n), n), dense, atol=1e-10)


@pytest.mark.parametrize("reverse", [False, True], ids=["lower", "upper"])
def test_levels_and_pack_are_the_jax_packages(rng, reverse):
    """tests/test_native.py:160: the host level pack against its plain
    version, and against the JAX package's pack read without sentinels."""
    n = 70
    tri = np.triu if reverse else np.tril
    strict = tri(rng.random((n, n)) < 0.15, 1 if reverse else -1) * rng.standard_normal((n, n))
    rows, cols = np.nonzero(strict)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=ptr[1:])
    data = strict[rows, cols]
    level, nlev = native.triangular_levels(ptr, cols, reverse=reverse)
    assert np.array_equal(level, tildu.triangular_levels_reference(ptr, cols, n, reverse))
    assert np.array_equal(level, jildu._levels(ptr, cols, n, reverse))
    assert nlev == level.max() + 1
    width = int(np.diff(ptr).max())
    packed = native.pack_levels(ptr, cols, data, level, nlev, width)
    for a, b in zip(packed, tildu.pack_levels_reference(ptr, cols, data, level, nlev, width)):
        assert np.array_equal(a, b)
    T = st.TriangularLevels.from_csr(ptr, cols, data, n, reverse=reverse, dtype=torch.float64,
                                     device="cpu")
    Tj = jildu.TriangularLevels.from_csr(ptr, cols, data, n, reverse=reverse, dtype=jnp.float64)
    C = convert._levels_from_arrays(np.asarray(Tj.rows), np.asarray(Tj.cols),
                                    np.asarray(Tj.vals), n, "cpu")
    assert T.nlev == Tj.nlev == nlev and T.level_ptr == C.level_ptr
    for a, b in ((T.rows, C.rows), (T.cols, C.cols), (T.vals, C.vals)):
        assert torch.equal(a, b)
    b = rng.standard_normal(n)
    assert rel(T.solve(t(b)).numpy(), np.asarray(Tj.solve(jnp.asarray(b)))) <= TOL
    assert rel(T.solve_t(t(b)).numpy(), np.asarray(Tj.solve_t(jnp.asarray(b)))) <= TOL


def test_ilu0_matches_its_plain_version(rng):
    """tests/test_native.py:137: the host ILU(0) and the numpy version give
    the same factors."""
    n = 80
    dense = np.triu(rng.random((n, n)) < 0.12, 1)
    dense = (dense | dense.T) * rng.standard_normal((n, n))
    dense = dense + np.diag(np.abs(dense).sum(1) + 1.0)
    A, _ = csr_both(dense)
    indptr, indices, data = tildu._csr_arrays(A)
    lu, diag = native.ilu0_factorize(indptr, indices, data)
    lu2, diag2 = tildu.ilu0_factorize_reference(indptr, indices, data, n)
    np.testing.assert_allclose(lu, lu2, rtol=1e-15)
    np.testing.assert_allclose(diag, diag2, rtol=1e-15)


@pytest.mark.parametrize("impl", ["native", "reference"])
def test_zero_pivot_raises(impl):
    A = st.CSRMatrix.from_dense(np.array([[0.0, 1.0], [1.0, 1.0]]), device="cpu")
    with pytest.raises(ZeroDivisionError):
        if impl == "native":
            st.ildu0_factorize(A)
        else:
            tildu.ilu0_factorize_reference(*tildu._csr_arrays(A), 2)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_iluk_symbolic_matches_numpy_and_jax(rng, k):
    n = 60
    A, _ = csr_both(random_spd_laplacian(rng, n))
    indptr, indices, _ = tildu._csr_arrays(A)
    got = native.iluk_symbolic(indptr, indices, k)
    for want in (tildu.iluk_symbolic_reference(indptr, indices, n, k),
                 jax_iluk_symbolic(indptr, indices, k)):
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_iluk_symbolic_retries_at_the_exact_capacity():
    """An arrow matrix fills completely at level 1, past the first capacity
    guess (nnz (k + 2)): the pattern is written on the retry."""
    n = 30
    dense = np.eye(n) * 4.0
    dense[0, :] = dense[:, 0] = 1.0
    A, _ = csr_both(dense)
    indptr, indices, _ = tildu._csr_arrays(A)
    assert n * n > indptr[-1] * 3
    fptr, fcol = native.iluk_symbolic(indptr, indices, 1)
    want = tildu.iluk_symbolic_reference(indptr, indices, n, 1)
    assert fcol.size == n * n
    assert np.array_equal(fptr, want[0]) and np.array_equal(fcol, want[1])


@pytest.mark.parametrize("state", ["own", "carried"])
@pytest.mark.parametrize("level", [0, 1])
def test_sweeps_match_jax(rng, level, state):
    n = 64
    A, Aj = csr_both(nonsym_dense(rng, n))
    M, Mj = st.ldu(level=level).setup(A), js.ldu(level=level).setup(Aj)
    if state == "carried":
        M = convert.ildu_from_arrays(
            {k: np.asarray(getattr(Mj.lower, k)) for k in ("rows", "cols", "vals")}
            | {"n": Mj.lower.n},
            np.asarray(Mj.dinv),
            {k: np.asarray(getattr(Mj.upper, k)) for k in ("rows", "cols", "vals")}
            | {"n": Mj.upper.n}, device="cpu")
    assert (M.lower.nlev, M.upper.nlev) == (Mj.lower.nlev, Mj.upper.nlev)
    b = rng.standard_normal(n)
    assert rel(M.matvec(t(b)).numpy(), np.asarray(Mj.matvec(jnp.asarray(b)))) <= TOL
    assert rel(M.rmatvec(t(b)).numpy(), np.asarray(Mj.rmatvec(jnp.asarray(b)))) <= TOL


def test_incomplete_cholesky_as_solver_and_preconditioner(rng):
    """tests/test_solvers.py:153, in the JAX package's counts."""
    n = 128
    dense = random_spd_laplacian(rng, n)
    A, Aj = csr_both(dense)
    v = smoothed_manufactured_solution(rng, dense)
    f = dense @ v
    M, Mj = st.incomplete_cholesky().setup(A), js.incomplete_cholesky().setup(Aj)
    u, _ = st.stationary_solve(A, t(f), M, steps=10 * n)
    assert np.abs(u.numpy() - v).max() < 1e-14
    u2, info = st.cg(1e-16).solve_info(A, t(f), M=st.incomplete_cholesky())
    _, infoj = js.cg(1e-16).solve_info(Aj, jnp.asarray(f), M=js.incomplete_cholesky())
    assert np.abs(u2.numpy() - v).max() < 1e-15
    assert info.converged and info.iterations == int(infoj.iterations)


def test_ildu_exact_for_tridiagonal():
    """Zero-fill LDU of a tridiagonal matrix is exact: one application
    solves, either way round."""
    n = 64
    dense, _ = laplacian_1d(n, c=0.7)
    A, _ = csr_both(dense)
    M = st.ldu().setup(A)
    b = np.random.default_rng(3).standard_normal(n)
    np.testing.assert_allclose(M.matvec(t(b)).numpy(), np.linalg.solve(dense, b), atol=1e-12)
    np.testing.assert_allclose(M.rmatvec(t(b)).numpy(), np.linalg.solve(dense.T, b), atol=1e-12)
    x, info = st.ldu().solve_info(A, t(b))
    assert info.iterations == 1 and info.converged and float(info.residual_norm) < 1e-12


def test_ildu_transpose_apply_is_the_adjoint(rng):
    dense = nonsym_dense(rng, 48)
    A, _ = csr_both(dense)
    M = st.ldu().setup(A)
    u, w = t(rng.standard_normal(48)), t(rng.standard_normal(48))
    lhs = float(torch.dot(M.matvec(u), w))
    rhs = float(torch.dot(u, M.rmatvec(w)))
    assert abs(lhs - rhs) < 1e-12 * max(1.0, abs(lhs))


def test_ldu_direct_fallback(rng):
    n = 32
    dense = random_spd_laplacian(rng, n)
    A, _ = csr_both(dense)
    b = rng.standard_normal(n)
    x = st.ldu(incomplete=False).solve(A, t(b))
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(dense, b), atol=1e-10)


def test_ldu_negative_level_rejected(rng):
    A, _ = csr_both(random_spd_laplacian(rng, 8))
    with pytest.raises(ValueError):
        st.ldu(level=-1).setup(A)


def test_iluk_monotone_preconditioner_quality(rng):
    """More fill, fewer CG iterations, in the JAX package's counts; k = 0
    is the zero-fill path."""
    nx = 14
    dense = laplacian_2d(nx)
    A, Aj = csr_both(dense)
    for a, b in zip(tildu.iluk_factorize(A, 0)[0], st.ildu0_factorize(A)[0]):
        assert np.array_equal(a, b)
    b = rng.standard_normal(nx * nx)
    iters = []
    for k in (0, 1, 2):
        _, info = st.cg(1e-12).solve_info(A, t(b), M=st.ldu(level=k).setup(A))
        _, infoj = js.cg(1e-12).solve_info(Aj, jnp.asarray(b), M=js.ldu(level=k).setup(Aj))
        assert info.converged and info.iterations == int(infoj.iterations)
        iters.append(info.iterations)
    assert iters[0] > iters[1] > iters[2], iters


def test_multicolor_ordering_reduces_ildu_levels(rng):
    """tests/test_solvers.py:382: after a greedy colour ordering the sweeps'
    levels are at most the colours, and the reordered preconditioner takes
    the JAX package's count."""
    n = 200
    dense = random_spd_laplacian(rng, n)
    A, Aj = csr_both(dense)
    p, ptr = st.greedy_color_ordering(A.graph)
    pj, ptrj = sj.greedy_color_ordering(Aj.graph)
    assert np.array_equal(p, pj) and np.array_equal(ptr, ptrj)
    inv = np.argsort(p)
    Ap, Apj = csr_both(dense[np.ix_(inv, inv)])
    M_nat, M_col = st.ldu().setup(A), st.ldu().setup(Ap)

    def depth(M):
        return M.lower.nlev + M.upper.nlev

    assert depth(M_col) <= depth(M_nat) and depth(M_col) <= 2 * (ptr.size - 1)
    f = dense[np.ix_(inv, inv)] @ rng.standard_normal(n)
    _, info = st.cg(1e-14).solve_info(Ap, t(f), M=M_col)
    _, infoj = js.cg(1e-14).solve_info(Apj, jnp.asarray(f), M=js.ldu().setup(Apj))
    assert info.converged and info.iterations == int(infoj.iterations)


def test_stencil_colours_collapse_the_levels():
    """The bipartite 7-point stencil takes 2 colours, and its colour-ordered
    ILDU(0) 2 + 2 levels (3 nx - 2 a sweep in natural order)."""
    nx = 6
    A = st.laplacian_3d_dia(nx, torch.float64, device="cpu")
    r, c, v = A.entries()
    keep = v != 0
    n = nx ** 3
    C = st.CSRMatrix.from_coo(n, n, r[keep], c[keep], v[keep], dtype=torch.float64, device="cpu")
    p, ptr = st.greedy_color_ordering(C.graph)
    assert ptr.size - 1 == 2
    M = st.ldu().setup(C)
    assert (M.lower.nlev, M.upper.nlev) == (3 * nx - 2, 3 * nx - 2)
    Cp = st.CSRMatrix.from_coo(n, n, p[r[keep]], p[c[keep]], v[keep], dtype=torch.float64,
                               device="cpu")
    Mp = st.ldu().setup(Cp)
    assert (Mp.lower.nlev, Mp.upper.nlev) == (2, 2)


@pytest.mark.parametrize("fused", [False, True], ids=["cg", "cg_fused"])
def test_ic0_pcg_counts_match_jax(rng, fused):
    """tests/test_solvers.py:561: IC(0) through prepare_preconditioner in
    classic and fused CG."""
    n = 196
    dense = random_spd_laplacian(rng, n)
    A, Aj = csr_both(dense)
    xstar = smoothed_manufactured_solution(rng, dense)
    b = dense @ xstar
    M = st.prepare_preconditioner(st.incomplete_cholesky(), A)
    Mj = js.prepare_preconditioner(js.incomplete_cholesky(), Aj)
    solve, solvej = (st.cg_fused_solve, js.cg_fused_solve) if fused else (st.cg_solve,
                                                                         js.cg_solve)
    x, info = solve(A, t(b), tol=1e-13, M=M)
    _, infoj = solvej(Aj, jnp.asarray(b), tol=1e-13, M=Mj)
    assert info.iterations == int(infoj.iterations)
    assert np.abs(x.numpy() - xstar).max() < 1e-9


@pytest.mark.parametrize("level", [0, 1])
def test_transposed_sweep_in_fixed_order_gives_the_cpu_bits(rng, level, monkeypatch):
    """Off the CPU each level of the transposed sweep adds in fixed order
    from a plan built at set-up; it gives the CPU's bits."""
    A, _ = csr_both(nonsym_dense(rng, 90))
    r = t(rng.standard_normal(90))
    cpu = st.ldu(level=level).setup(A)
    assert cpu.lower._plans is None
    monkeypatch.setattr(ordered_sum, "fixed_order", lambda device: True)
    M = st.ldu(level=level).setup(A)
    assert len(M.lower._plans) == M.lower.nlev and len(M.upper._plans) == M.upper.nlev
    want = cpu.rmatvec(r)
    assert torch.equal(M.rmatvec(r), want) and torch.equal(M.rmatvec(r), want)
    assert torch.equal(M.matvec(r), cpu.matvec(r))


def _level_factors(kind):
    """(lower, upper) packed level systems of this file's small operators:
    ILDU(0) and ILU(1) of a nonsymmetric ER Laplacian, ILDU(0) after a
    greedy colour ordering of an SPD one, and the block ILDU of a 4-shard
    mesh on the CPU."""
    rng = np.random.default_rng(28)
    if kind == "colored":
        dense = random_spd_laplacian(rng, 120)
        p, _ = st.greedy_color_ordering(csr_both(dense)[0].graph)
        inv = np.argsort(p)
        dense = dense[np.ix_(inv, inv)]
    else:
        dense = nonsym_dense(rng, 90)
    A, _ = csr_both(dense)
    if kind == "block":
        from sigma_tpu_torch.parallel import distributed_block_ildu, make_mesh

        M = distributed_block_ildu(A, make_mesh(4, device="cpu"))
    else:
        M = st.ldu(level=1 if kind == "ilu1" else 0).setup(A)
    return M.lower, M.upper


LEVEL_KINDS = ["ildu0", "ilu1", "colored", "block"]


@pytest.mark.parametrize("side", [0, 1], ids=["lower", "upper"])
@pytest.mark.parametrize("kind", LEVEL_KINDS)
def test_every_dependency_sits_at_a_lower_packed_position(kind, side):
    """What the sweep kernel's progress rests on: every real slot's column
    is a row packed at a strictly lower position than its own row (in a
    lower level), so the lowest unfinished slot can always proceed.
    Every row is packed once."""
    T = _level_factors(kind)[side]
    rows, cols = T.rows.numpy(), T.cols.numpy()
    assert np.array_equal(np.sort(rows), np.arange(T.n))
    pos = np.empty(T.n, dtype=np.int64)
    pos[rows] = np.arange(T.n)
    level = np.repeat(np.arange(T.nlev), np.diff(T.level_ptr))
    real = cols != rows[:, None]
    slot = np.broadcast_to(np.arange(T.n)[:, None], cols.shape)
    assert real.any()
    assert (pos[cols[real]] < slot[real]).all()
    assert (level[pos[cols[real]]] < level[slot[real]]).all()


@pytest.mark.parametrize("kind", LEVEL_KINDS)
def test_slot_order_evaluation_matches_the_plain_sweep(kind):
    """``level_sweep_slot_order`` (the kernel's own order of operations,
    which the card checks hold the kernel to bit for bit) agrees with the
    plain version within 1e-12 on both factors, f64 and f32 values with
    f64 vectors, and within 1e-5 in f32."""
    from sigma_tpu_torch.ops import level_sweep_reference, level_sweep_slot_order

    rng = np.random.default_rng(5)
    for T in _level_factors(kind):
        for vdt, xdt, tol in ((torch.float64, torch.float64, TOL),
                              (torch.float32, torch.float64, TOL),
                              (torch.float32, torch.float32, 1e-5)):
            vals = T.vals.to(vdt)
            b = t(rng.standard_normal(T.n)).to(xdt)
            x = level_sweep_slot_order(T.rows, T.cols, vals, T._ptr, b)
            assert x.dtype == xdt
            assert rel(x.numpy(), level_sweep_reference(T.rows, T.cols, vals, T._ptr,
                                                        b).numpy()) <= tol
