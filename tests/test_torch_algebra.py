"""The port's explicit sparse algebra (sum, SpGEMM, PtAP, RARt, their
plans) held against the JAX package on the CPU in f64, case by case after
``tests/test_algebra.py``: every format pair, the output formats (also by
name), plan reuse, PtAP, RARt and the Galerkin Laplacian.

The same numpy inputs go to both packages.  A one-shot result runs the
same C++ in both (the port's own copy), so its arrays equal the JAX
package's bit for bit; a plan sums its contributions in another order
than the host, and agrees with it and with the JAX plan to 1e-12
relative.  Both agree with the dense oracle to 1e-14, as the JAX tests
hold theirs.  The host routines are held against plain numpy versions
of the same products."""

import numpy as np
import pytest
import torch

import sigma_tpu as sj
import sigma_tpu.matrix.algebra as ja
import sigma_tpu_torch as st
from sigma_tpu_torch import native
from sigma_tpu_torch.utils import ordered_sum
from test_torch_jax_host import jax_host_library

torch.set_num_threads(1)
jax_host_library()  # the bit-for-bit checks need the JAX host library, not its fallback

FORMATS = ["csr", "csc", "coo", "ell", "bsr"]
JAX_CLS = {"csr": sj.CSRMatrix, "csc": sj.CSCMatrix, "coo": sj.COOMatrix, "ell": sj.ELLMatrix,
           "bsr": sj.BSRMatrix}
TOL = 1e-14
PLAN_TOL = 1e-12


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def random_dense(rng, n, m, p=0.1):
    dense = np.where(rng.random((n, m)) < p, rng.standard_normal((n, m)), 0.0)
    dense[rng.integers(n), rng.integers(m)] = rng.standard_normal() + 2.0
    return dense


def both(fmt, dense):
    """The port's and the JAX package's matrix of one dense array."""
    return (st.choose_matrix_type(fmt).from_dense(dense, device="cpu"),
            JAX_CLS[fmt].from_dense(dense))


def coarsening(rng, n_fine, n_coarse):
    """Random aggregation P (n_fine x n_coarse), as tests/test_algebra.py."""
    dense = np.zeros((n_fine, n_coarse))
    dense[np.arange(n_fine), rng.integers(0, n_coarse, size=n_fine)] = 1.0
    dense[rng.random((n_fine, n_coarse)) < 0.02] = 0.5
    return dense


def same_result(C, Cj, want, exact=True):
    """C in C's format, equal to the JAX result (bit for bit, or to
    PLAN_TOL) and to the dense oracle to TOL."""
    assert C.format == Cj.format
    assert C.shape == tuple(Cj.shape)
    d, dj = C.to_dense(), np.asarray(Cj.to_dense())
    if exact:
        assert np.array_equal(d, dj)
    else:
        assert rel(d, dj) <= PLAN_TOL
    assert np.abs(d - want).max() < TOL


@pytest.mark.parametrize("fa", FORMATS)
@pytest.mark.parametrize("fb", FORMATS)
def test_sum_format_pairs(rng, fa, fb):
    dA, dB = random_dense(rng, 24, 17), random_dense(rng, 24, 17)
    (A, Aj), (B, Bj) = both(fa, dA), both(fb, dB)
    same_result(st.sparse_add(A, B), ja.sparse_add(Aj, Bj), dA + dB)


@pytest.mark.parametrize("fa", FORMATS)
@pytest.mark.parametrize("fb", FORMATS)
def test_product_format_pairs(rng, fa, fb):
    dA, dB = random_dense(rng, 18, 25), random_dense(rng, 25, 13)
    (A, Aj), (B, Bj) = both(fa, dA), both(fb, dB)
    same_result(st.sparse_matmul(A, B), ja.sparse_matmul(Aj, Bj), dA @ dB)


def test_one_shot_csr_arrays_are_the_jax_packages_bit_for_bit(rng):
    dA, dB = random_dense(rng, 40, 40, 0.15), random_dense(rng, 40, 40, 0.15)
    (A, Aj), (B, Bj) = both("csr", dA), both("csr", dB)
    for C, Cj in ((st.sparse_add(A, B, 2.5, -0.5), ja.sparse_add(Aj, Bj, 2.5, -0.5)),
                  (st.sparse_matmul(A, B), ja.sparse_matmul(Aj, Bj)),
                  (st.ptap(A, B), ja.ptap(Aj, Bj)), (st.rart(A, B), ja.rart(Aj, Bj))):
        nnz = C.nnz
        assert nnz == Cj.nnz
        assert np.array_equal(C.graph.indptr, np.asarray(Cj.graph.indptr))
        assert np.array_equal(C.graph.indices, np.asarray(Cj.graph.indices)[:nnz])
        assert np.array_equal(C.data.numpy(), np.asarray(Cj.data)[:nnz])


def test_sum_scaled(rng):
    dA, dB = random_dense(rng, 30, 30), random_dense(rng, 30, 30)
    (A, Aj), (B, Bj) = both("csr", dA), both("csc", dB)
    same_result(st.sparse_add(A, B, alpha=2.5, beta=-0.5),
                ja.sparse_add(Aj, Bj, alpha=2.5, beta=-0.5), 2.5 * dA - 0.5 * dB)


def test_sum_with_tensor_scalars_runs_the_plan(rng, monkeypatch):
    """A tensor alpha or beta takes the device plan, as the JAX package's
    traced scalars do, and gives the host sum's values."""
    dA, dB = random_dense(rng, 30, 30), random_dense(rng, 30, 30)
    (A, _), (B, _) = both("csr", dA), both("ell", dB)
    host = st.sparse_add(A, B, alpha=2.5, beta=-0.5)
    monkeypatch.setattr(native, "csr_add", None)  # the host sum is not called
    C = st.sparse_add(A, B, alpha=torch.tensor(2.5, dtype=torch.float64), beta=-0.5)
    assert rel(C.to_dense(), host.to_dense()) <= PLAN_TOL
    assert np.abs(C.to_dense() - (2.5 * dA - 0.5 * dB)).max() < TOL


def test_sum_plan_reuse(rng):
    dA, dB = random_dense(rng, 20, 20), random_dense(rng, 20, 20)
    (A, Aj), (B, Bj) = both("csr", dA), both("ell", dB)
    plan, planj = st.plan_sparse_add(A, B), ja.plan_sparse_add(Aj, Bj)
    same_result(plan(A, B), planj(Aj, Bj), dA + dB, exact=False)
    A2, A2j = A.with_data(A.data * 3.0), Aj.with_data(Aj.data * 3.0)
    same_result(plan(A2, B), planj(A2j, Bj), 3.0 * dA + dB, exact=False)


@pytest.mark.parametrize("out", FORMATS)
def test_product_output_format(rng, out):
    dA, dB = random_dense(rng, 16, 16), random_dense(rng, 16, 16)
    (A, Aj), (B, Bj) = both("csr", dA), both("csr", dB)
    C = st.sparse_matmul(A, B, out_format=st.choose_matrix_type(out))
    assert isinstance(C, st.choose_matrix_type(out))
    same_result(C, ja.sparse_matmul(Aj, Bj, out_format=JAX_CLS[out]), dA @ dB)


def test_product_plan_reuse(rng):
    dA, dB = random_dense(rng, 20, 22), random_dense(rng, 22, 18)
    (A, Aj), (B, Bj) = both("csr", dA), both("csc", dB)
    plan, planj = st.plan_sparse_matmul(A, B), ja.plan_sparse_matmul(Aj, Bj)
    same_result(plan(A, B), planj(Aj, Bj), dA @ dB, exact=False)
    B2, B2j = B.with_data(B.data * -2.0), Bj.with_data(Bj.data * -2.0)
    same_result(plan(A, B2), planj(Aj, B2j), dA @ (-2.0 * dB), exact=False)


def test_product_empty_inner():
    A = st.CSRMatrix.from_coo(4, 5, [0, 3], [1, 4], [2.0, 3.0], device="cpu")
    B = st.CSRMatrix.from_coo(5, 3, [2], [0], [1.0], device="cpu")
    assert np.abs(st.sparse_matmul(A, B).to_dense()).max() == 0.0
    assert np.abs(st.plan_sparse_matmul(A, B)(A, B).to_dense()).max() == 0.0


@pytest.mark.parametrize("fmt", ["csr", "csc", "ell"])
def test_ptap(rng, fmt):
    dA = random_dense(rng, 64, 64, p=0.08)
    dP = coarsening(rng, 64, 32)
    (A, Aj), (P, Pj) = both(fmt, dA), both(fmt, dP)
    B = st.ptap(A, P)
    assert B.shape == (32, 32)
    same_result(B, ja.ptap(Aj, Pj), dP.T @ dA @ dP)
    same_result(st.plan_ptap(A, P)(A, P), ja.plan_ptap(Aj, Pj)(Aj, Pj), dP.T @ dA @ dP,
                exact=False)


def test_ptap_plan_reuse(rng):
    dA = random_dense(rng, 48, 48)
    dP = coarsening(rng, 48, 24)
    (A, Aj), (P, Pj) = both("csr", dA), both("csr", dP)
    plan, planj = st.plan_ptap(A, P), ja.plan_ptap(Aj, Pj)
    same_result(plan(A, P), planj(Aj, Pj), dP.T @ dA @ dP, exact=False)
    A2, A2j = A.with_data(A.data * 0.5), Aj.with_data(Aj.data * 0.5)
    same_result(plan(A2, P), planj(A2j, Pj), 0.5 * dP.T @ dA @ dP, exact=False)


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_rart(rng, fmt):
    dA = random_dense(rng, 54, 54)
    dR = coarsening(rng, 54, 27).T
    (A, Aj), (R, Rj) = both(fmt, dA), both(fmt, dR)
    B = st.rart(A, R)
    assert B.shape == (27, 27)
    same_result(B, ja.rart(Aj, Rj), dR @ dA @ dR.T)


def test_rart_plan_reuse(rng):
    dA = random_dense(rng, 40, 40)
    dR = coarsening(rng, 40, 20).T
    (A, Aj), (R, Rj) = both("csr", dA), both("csr", dR)
    plan, planj = st.plan_rart(A, R), ja.plan_rart(Aj, Rj)
    A2, A2j = A.with_data(A.data * 2.0), Aj.with_data(Aj.data * 2.0)
    same_result(plan(A2, R), planj(A2j, Rj), 2.0 * dR @ dA @ dR.T, exact=False)


def test_galerkin_laplacian():
    """PtAP of a 1-D Laplacian under linear interpolation is the coarse
    Laplacian, 0.5 [-1, 2, -1]."""
    n, nc = 33, 16
    dA = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    dP = np.zeros((n, nc))
    for j in range(nc):
        f = 2 * j + 1
        dP[f, j], dP[f - 1, j] = 1.0, 0.5
        if f + 1 < n:
            dP[f + 1, j] = 0.5
    (A, Aj), (P, Pj) = both("csr", dA), both("csr", dP)
    B = st.ptap(A, P)
    same_result(B, ja.ptap(Aj, Pj), dP.T @ dA @ dP)
    dB = B.to_dense()
    assert abs(dB[3, 3] - 1.0) < TOL and abs(dB[3, 4] + 0.5) < TOL


def test_string_out_format(rng):
    dA, dB = random_dense(rng, 12, 12), random_dense(rng, 12, 12)
    (A, Aj), (B, Bj) = both("csr", dA), both("csr", dB)
    C = st.sparse_add(A, B, out_format="ell")
    assert C.format == "ell"
    same_result(C, ja.sparse_add(Aj, Bj, out_format="ell"), dA + dB)
    D = st.sparse_matmul(A, B, out_format="csc")
    assert D.format == "csc"
    same_result(D, ja.sparse_matmul(Aj, Bj, out_format="csc"), dA @ dB)


def test_dia_operand_keeps_its_layout(rng):
    """A DIA operand's result is DIA in the same layout (its wrap slots
    stored as zeros), equal to the JAX package's."""
    n = 50
    dA = np.zeros((n, n))
    for o in (-3, 0, 1):
        i = np.arange(max(0, -o), min(n, n - o))
        dA[i, i + o] = rng.standard_normal(i.size)
    A = st.DIAMatrix.from_dense(dA, device="cpu")
    Aj = sj.DIAMatrix.from_dense(dA)
    C, Cj = st.sparse_matmul(A, A), ja.sparse_matmul(Aj, Aj)
    assert C.graph.offsets == tuple(Cj.graph.offsets)
    assert np.array_equal(C.data2d.numpy(), np.asarray(Cj.data2d))
    same_result(st.plan_sparse_matmul(A, A)(A, A), Cj, dA @ dA, exact=False)


@pytest.mark.parametrize("kind", ["sum", "product", "ptap"])
def test_fixed_order_plan_sum_gives_the_cpu_bits(rng, kind, monkeypatch):
    """A plan made where sums run in fixed order (every device but the
    CPU) keeps its sum plans and gives the bits of the CPU's
    ``index_add_``."""
    dA, dP = random_dense(rng, 60, 60, 0.12), coarsening(rng, 60, 30)
    (A, _), (P, _) = both("csr", dA), both("csr", dP)
    make = {"sum": lambda: st.plan_sparse_add(A, A.scale(0.5)),
            "product": lambda: st.plan_sparse_matmul(A, P),
            "ptap": lambda: st.plan_ptap(A, P)}[kind]
    run = {"sum": lambda pl: pl(A, A.scale(0.5), 2.0, -1.0), "product": lambda pl: pl(A, P),
           "ptap": lambda pl: pl(A, P)}[kind]
    cpu = run(make()).data
    monkeypatch.setattr(ordered_sum, "fixed_order", lambda device: True)
    plan = make()
    kept = plan._plans if kind == "sum" else (plan._plan,)
    assert all(isinstance(p, ordered_sum.SumPlan) for p in kept)
    assert torch.equal(run(plan).data, cpu)


def _dense_csr(d):
    r, c = np.nonzero(d)
    indptr = np.zeros(d.shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=d.shape[0]), out=indptr[1:])
    return indptr, c, d[r, c]


def _csr_dense(indptr, cols, vals, m):
    d = np.zeros((indptr.size - 1, m))
    d[np.repeat(np.arange(indptr.size - 1), np.diff(indptr)), cols] = vals
    return d


@pytest.mark.parametrize("routine", ["spgemm", "csr_add", "csr_transpose"])
def test_host_routines_against_numpy(rng, routine):
    """The host library's CSR products against dense numpy: sorted rows,
    and the values of a product of 0/1 and dyadic entries exact."""
    dA = np.round(random_dense(rng, 37, 29, 0.2) * 4) / 4
    dB = np.round(random_dense(rng, 29, 41, 0.2) * 4) / 4
    if routine == "spgemm":
        got, want, m = native.spgemm(*_dense_csr(dA), *_dense_csr(dB), 41), dA @ dB, 41
    elif routine == "csr_add":
        dC = np.round(random_dense(rng, 37, 29, 0.2) * 4) / 4
        got, want, m = native.csr_add(*_dense_csr(dA), *_dense_csr(dC), 2.0, -0.5), \
            2.0 * dA - 0.5 * dC, 29
    else:
        got, want, m = native.csr_transpose(*_dense_csr(dA), 29), dA.T, 37
    indptr, cols, vals = got
    for i in range(indptr.size - 1):
        assert np.all(np.diff(cols[indptr[i] : indptr[i + 1]]) > 0)
    assert np.array_equal(_csr_dense(indptr, cols, vals, m), want)
