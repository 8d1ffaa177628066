"""The port's DIA SpMM (plain versions, panel layouts, and the multi-RHS
methods of DIAMatrix and SymmetricDIAMatrix) held against the JAX package.

Inputs come from seeded numpy and go to both packages.  The plain SpMM
versions are checked against the JAX package's Pallas SpMM kernels run in
interpret mode, as ``tests/test_pallas.py`` runs them (small tiles forced
through the tile pick, f32, tolerance 1e-5: both sum in f32, in different
orders).  The matrix methods are checked against the JAX package's in f64
at 1e-12.  The CUDA kernels themselves are checked against the plain
versions on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu
import sigma_tpu.ops.spmv_pallas as sp
import sigma_tpu_torch as st
from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix as JaxSym
from sigma_tpu_torch.ops import (
    LAYOUTS,
    deinterleave_panels,
    dia_spmm,
    dia_spmm_reference,
    dia_sym_spmm,
    dia_sym_spmm_reference,
    interleave_panels,
)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _small_tiles(S, hrows, *args, **kw):
    # the JAX kernels' tile pick, forced to 64-row tiles so a few thousand
    # rows already take several grid steps and the ragged tail
    return 64, next(e for e in range(8, 65, 8) if e >= hrows and 64 % e == 0)


def full_data(rng, n, m, offsets, dtype=np.float32):
    data = np.zeros((len(offsets), -(-n // 128) * 128), dtype)
    for d, o in enumerate(offsets):
        lo, hi = max(0, -o), min(n, m - o)
        data[d, lo:hi] = rng.standard_normal(hi - lo)
    return data


def sym_data(rng, n, offsets, dtype=np.float32):
    data = np.zeros((len(offsets), -(-n // 128) * 128), dtype)
    for d, o in enumerate(offsets):
        data[d, : n - o] = rng.standard_normal(n - o)
    return data


def in_layout(XT, layout):
    """RHS-major (k, m) panels as a torch tensor in ``layout``."""
    XT = torch.from_numpy(np.ascontiguousarray(XT))
    if layout == "cols":
        return XT.T.contiguous()
    if layout == "interleaved":
        return interleave_panels(XT)
    return XT


def rhs_major(Y, layout, k, n):
    if layout == "cols":
        return Y.T.numpy()
    if layout == "interleaved":
        return deinterleave_panels(Y, k, n).numpy()
    return Y.numpy()


# -- the plain versions against the JAX kernels (interpret mode) ----------
FULL_OFFSETS = (0, 1, -1, 300, -300)
SYM_OFFSETS = (0, 1, 128, 300)
N_UNALIGNED = 9001
# (n, m, offsets) of the full SpMM: the stencil-like offsets, a band (a
# consecutive run with gaps) and a rectangular matrix
SPMM_CASES = {
    "stencil": (N_UNALIGNED, N_UNALIGNED, FULL_OFFSETS),
    "band": (N_UNALIGNED, N_UNALIGNED, tuple(sorted(set(range(-40, 41)) - {-3, 7}))),
    "rectangular": (7500, N_UNALIGNED, FULL_OFFSETS),
}
# k: one and two column groups of the CUDA kernel's register tile, whole
# and partial; the stencil case keeps its ids of one parameter pair
SPMM_PARAMS = [
    pytest.param(kernel, k, case, id=f"{kernel}-{k}" + ("" if case == "stencil" else f"-{case}"))
    for case in SPMM_CASES
    for k in (1, 3, 5, 8, 9, 12, 16)
    for kernel in ("rhs_major", "interleaved")
]


@pytest.mark.parametrize("kernel,k,case", SPMM_PARAMS)
def test_dia_spmm_plain_matches_jax_kernel(kernel, k, case, monkeypatch):
    n, m, offsets = SPMM_CASES[case]
    rng = np.random.default_rng(100 + k)
    data = full_data(rng, n, m, offsets)
    XT = rng.standard_normal((k, m)).astype(np.float32)
    monkeypatch.setattr(sp, "_spmm_tile_pick", _small_tiles)
    if kernel == "rhs_major":
        Yj = sp.dia_spmm_rhs_major(
            jnp.asarray(data), jnp.asarray(XT), offsets, n, m, interpret=True
        )
    else:
        YI = sp.dia_spmm_interleaved(
            jnp.asarray(data), sp.interleave_panels(jnp.asarray(XT), m),
            offsets, n, m, interpret=True,
        )
        Yj = sp.deinterleave_panels(YI, k, n)
    offs = torch.tensor(offsets)
    Y = dia_spmm(torch.from_numpy(data), in_layout(XT, kernel), offs, n, m, kernel)
    assert rel(rhs_major(Y, kernel, k, n), Yj) <= 1e-5


@pytest.mark.parametrize("k", [1, 3, 8, 16])
@pytest.mark.parametrize("kernel", ["rhs_major", "interleaved"])
def test_dia_sym_spmm_plain_matches_jax_kernel(kernel, k):
    n = N_UNALIGNED
    rng = np.random.default_rng(200 + k)
    data = sym_data(rng, n, SYM_OFFSETS)
    XT = rng.standard_normal((k, n)).astype(np.float32)
    with mock.patch.object(sp, "_sym_spmm_tile_pick", _small_tiles):
        if kernel == "rhs_major":
            Yj = sp.dia_sym_spmm_rhs_major(
                jnp.asarray(data), jnp.asarray(XT), SYM_OFFSETS, n, interpret=True
            )
        else:
            YI = sp.dia_sym_spmm_interleaved(
                jnp.asarray(data), sp.interleave_panels(jnp.asarray(XT), n),
                SYM_OFFSETS, n, interpret=True,
            )
            Yj = sp.deinterleave_panels(YI, k, n)
    offs = torch.tensor(SYM_OFFSETS)
    Y = dia_sym_spmm(torch.from_numpy(data), in_layout(XT, kernel), offs, n, kernel)
    assert rel(rhs_major(Y, kernel, k, n), Yj) <= 1e-5


@pytest.mark.parametrize("k,m", [(1, 640), (4, 1000), (3, 127), (16, 129)])
def test_interleave_panels_match_jax(k, m):
    XT = np.random.default_rng(k).standard_normal((k, m))
    XI = interleave_panels(torch.from_numpy(XT))
    np.testing.assert_array_equal(XI.numpy(), np.asarray(sp.interleave_panels(jnp.asarray(XT), m)))
    # padding to a longer vector, as for a wide matrix's x
    np.testing.assert_array_equal(
        interleave_panels(torch.from_numpy(XT), m + 300).numpy(),
        np.asarray(sp.interleave_panels(jnp.asarray(XT), m + 300)),
    )
    back = deinterleave_panels(XI, k, m)
    assert back.is_contiguous()
    np.testing.assert_array_equal(back.numpy(), XT)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_versions_agree_across_layouts(layout):
    """Each layout's plain product equals the RHS-major one (same sums),
    with zeros in the interleaved padding rows."""
    rng = np.random.default_rng(7)
    n, m, k = 300, 250, 5
    offs = torch.tensor([-100, 0, 3, 100])
    data = torch.from_numpy(full_data(rng, n, m, offs.tolist(), np.float64))
    XT = rng.standard_normal((k, m))
    ref = dia_spmm(data, torch.from_numpy(XT), offs, n, m, "rhs_major")
    Y = dia_spmm(data, in_layout(XT, layout), offs, n, m, layout)
    np.testing.assert_array_equal(rhs_major(Y, layout, k, n), ref.numpy())
    if layout == "interleaved":
        assert Y.shape == (k * 3, 128)
        assert not Y.reshape(3, k, 128)[-1, :, n - 256 :].any()
    soffs = torch.tensor([0, 2, 50])
    sdata = torch.from_numpy(sym_data(rng, n, soffs.tolist(), np.float64))
    XT = rng.standard_normal((k, n))
    sref = dia_sym_spmm_reference(sdata, torch.from_numpy(XT), soffs, n, "rhs_major")
    Ys = dia_sym_spmm(sdata, in_layout(XT, layout), soffs, n, layout)
    np.testing.assert_array_equal(rhs_major(Ys, layout, k, n), sref.numpy())


def test_wrappers_reject_what_they_do_not_take():
    data = torch.zeros(1, 128, dtype=torch.float64)
    offs = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="unknown panel layout"):
        dia_spmm(data, torch.zeros(2, 100), offs, 100, 100, "rows")
    with pytest.raises(ValueError, match="1 to 16"):
        dia_spmm(data, torch.zeros(17, 100), offs, 100, 100, "rhs_major")
    with pytest.raises(ValueError, match="not interleaved panels"):
        dia_sym_spmm(data, torch.zeros(3, 127), offs, 100, "interleaved")
    with pytest.raises(ValueError, match="not cols panels"):
        dia_spmm(data, torch.zeros(99, 2), offs, 100, 100, "cols")
    with pytest.raises(TypeError, match="int64"):
        dia_spmm(data, torch.zeros(100, 2), offs.int(), 100, 100, "cols")
    # the plain version on the CPU is not a kernel launch
    before = dia_spmm.launches, dict(dia_spmm.launches_by_layout)
    dia_spmm(data, torch.zeros(100, 2, dtype=torch.float64), offs, 100, 100, "cols")
    assert (dia_spmm.launches, dia_spmm.launches_by_layout) == before


# -- the matrix methods against the JAX package in f64 --------------------
def random_dia_coo(rng, n, m, offsets):
    rows, cols, vals = [], [], []
    for o in offsets:
        lo, hi = max(0, -o), min(n, m - o)
        r = np.arange(lo, hi)
        rows.append(r)
        cols.append(r + o)
        vals.append(rng.standard_normal(hi - lo))
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


FULL_CASES = {
    "square": (300, 300, [0, 1, -1, 17, -17, 130]),
    "tall": (400, 250, [-100, 0, 3, 100]),
    "wide": (250, 400, [-3, 0, 100, 200]),
    "unaligned": (333, 333, [0, 5, -7]),
}


@pytest.mark.parametrize("k", [1, 4, 20])
@pytest.mark.parametrize("case", sorted(FULL_CASES))
def test_dia_matrix_multi_rhs_matches_jax_f64(case, k):
    n, m, offsets = FULL_CASES[case]
    rng = np.random.default_rng(len(case) + k)
    r, c, v = random_dia_coo(rng, n, m, offsets)
    Aj = sigma_tpu.DIAMatrix.from_coo(n, m, r, c, v, dtype=jnp.float64)
    At = st.DIAMatrix.from_coo(n, m, r, c, v, dtype=torch.float64, device="cpu")
    X = rng.standard_normal((m, k))
    Xn = rng.standard_normal((n, k))
    Xt = torch.from_numpy(X)
    assert rel(At.matmat(Xt), Aj.matmat(jnp.asarray(X))) <= 1e-12
    # a column-major block (as a QR factor is) goes in as RHS-major panels
    assert rel(At.matmat(Xt.T.contiguous().T), Aj.matmat(jnp.asarray(X))) <= 1e-12
    assert rel(At.rmatmat(torch.from_numpy(Xn)), Aj.rmatmat(jnp.asarray(Xn))) <= 1e-12
    assert rel(
        At.matmat_rhs_major(torch.from_numpy(X.T.copy())),
        Aj.matmat_rhs_major(jnp.asarray(X.T)),
    ) <= 1e-12
    YI = At.matmat_interleaved(interleave_panels(torch.from_numpy(X.T.copy()), m))
    YIj = Aj.matmat_interleaved(sp.interleave_panels(jnp.asarray(X.T), m))
    assert YI.shape == YIj.shape
    assert rel(YI, YIj) <= 1e-12
    assert At.interleaved_profitable(k) is False
    assert Aj.interleaved_profitable(k) is False  # off the TPU, as the port off CUDA


@pytest.mark.parametrize("k", [1, 4, 20])
def test_symmetric_multi_rhs_matches_jax_f64(k):
    n, offsets = 333, [0, 1, 17, 130]
    rng = np.random.default_rng(50 + k)
    dA = np.zeros((n, n))
    for o in offsets:
        v = rng.standard_normal(n - o)
        dA += np.diag(v, o) + (np.diag(v, -o) if o else 0)
    Sj = JaxSym.from_dense(dA)
    St = st.SymmetricDIAMatrix.from_dia(st.DIAMatrix.from_dense(dA, device="cpu"))
    X = rng.standard_normal((n, k))
    Xj = jnp.asarray(X)
    assert rel(St.matmat(torch.from_numpy(X)), Sj.matmat(Xj)) <= 1e-12
    assert rel(St.rmatmat(torch.from_numpy(X)), Sj.rmatmat(Xj)) <= 1e-12
    assert rel(St.matmat(torch.from_numpy(X)), dA @ X) <= 1e-12
    assert rel(
        St.matmat_rhs_major(torch.from_numpy(X.T.copy())),
        Sj.matmat_rhs_major(jnp.asarray(X.T)),
    ) <= 1e-12
    YI = St.matmat_interleaved(interleave_panels(torch.from_numpy(X.T.copy())))
    YIj = Sj.matmat_interleaved(sp.interleave_panels(jnp.asarray(X.T), n))
    assert YI.shape == YIj.shape
    assert rel(YI, YIj) <= 1e-12
    assert St.interleaved_profitable(k) is False
    assert Sj.interleaved_profitable(k) is False


def test_zero_diagonal_matrix_multi_rhs():
    A = st.DIAMatrix.from_dense(np.zeros((200, 130)), device="cpu")
    assert not A.graph.offsets
    X = torch.ones(130, 3, dtype=torch.float64)
    assert A.matmat(X).shape == (200, 3) and not A.matmat(X).any()
    assert A.rmatmat(torch.ones(200, 3)).shape == (130, 3)
    YI = A.matmat_interleaved(interleave_panels(X.T.contiguous()))
    assert YI.shape == (3 * 2, 128) and not YI.any()
