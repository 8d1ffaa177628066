"""The port's CUDA kernels on the card: each against its plain version, and
CG / GMG-CG / block CG / LOBPCG on the card against the same solve on the
CPU, on the stencil and on the unstructured pruned path; and the
constructors' default device.

Marked ``cuda``; every test skips without a CUDA device.  The test
configuration imports JAX, which the GPU machine need not have, so run
this file there without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -m cuda -q
"""

import numpy as np
import pytest
import torch

import sigma_tpu_torch as st
from sigma_tpu_torch.ops import spmv_pruned as sp
from sigma_tpu_torch.ops import (
    KERNEL_DTYPES,
    LAYOUTS,
    dia_spmm,
    dia_spmm_reference,
    dia_sym_spmm,
    dia_sym_spmm_reference,
    interleave_panels,
    dia_spmv,
    dia_spmv_reference,
    dia_sym_spmv,
    dia_sym_spmv_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not st.cuda_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _tol(xdt):
    # accumulation is in x's dtype (values widen exactly); summation order
    # and FMA contraction differ from the plain version
    return 1e-12 if xdt == torch.float64 else 1e-5


@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
@pytest.mark.parametrize(
    "n,m,offsets",
    [
        (50_000, 50_000, [-2500, -300, -1, 0, 1, 300, 2500]),
        (60_000, 45_001, [-2500, -300, 0, 4, 2500]),
        (45_001, 60_000, [-4, -1, 0, 300, 2500]),
        (70_000, 70_000, [0]),
    ],
)
def test_dia_spmv_kernel(cuda, pair, n, m, offsets):
    vdt, xdt = pair
    g = torch.Generator(device=cuda).manual_seed(0)
    data = torch.randn(len(offsets), -(-n // 128) * 128, generator=g, device=cuda).to(vdt)
    x = torch.randn(m, generator=g, device=cuda).to(xdt)
    offs = torch.tensor(offsets, device=cuda)
    before = dia_spmv.launches
    y = dia_spmv(data, x, offs, n, m)
    torch.cuda.synchronize()
    assert dia_spmv.launches == before + 1
    assert y.dtype == xdt and y.shape == (n,)
    assert rel(y, dia_spmv_reference(data, x, offs, n, m)) <= _tol(xdt)


@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
@pytest.mark.parametrize(
    "n,offsets", [(50_000, [0, 1, 300, 2500]), (33_333, [1, 130, 259])]
)
def test_dia_sym_spmv_kernel(cuda, pair, n, offsets):
    vdt, xdt = pair
    g = torch.Generator(device=cuda).manual_seed(1)
    data = torch.randn(len(offsets), -(-n // 128) * 128, generator=g, device=cuda).to(vdt)
    x = torch.randn(n, generator=g, device=cuda).to(xdt)
    offs = torch.tensor(offsets, device=cuda)
    before = dia_sym_spmv.launches
    y = dia_sym_spmv(data, x, offs, n)
    torch.cuda.synchronize()
    assert dia_sym_spmv.launches == before + 1
    assert rel(y, dia_sym_spmv_reference(data, x, offs, n)) <= _tol(xdt)


def test_kernel_rejects_what_it_does_not_take(cuda):
    data = torch.zeros(1, 128, dtype=torch.float64, device=cuda)
    offs = torch.zeros(1, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="no DIA kernel"):
        dia_spmv(data, torch.zeros(100, device=cuda), offs, 100, 100)
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmv(data.float(), torch.zeros(200, device=cuda)[::2], offs, 100, 100)
    with pytest.raises(ValueError, match="different devices"):
        dia_spmv(data, torch.zeros(100, dtype=torch.float64), offs, 100, 100)


def test_gmg_cg_on_card_matches_cpu(cuda):
    nx = 24
    A = st.SymmetricDIAMatrix.from_dia(st.laplacian_3d_dia(nx, torch.float64, diag=6.0, device="cpu"))
    M = st.structured_pair_amg(A, (nx, nx, nx), pairs_per_level=3)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(A.shape[0]))
    x_cpu, i_cpu = st.cg_solve(A, b, tol=0.0, rtol=1e-10, M=M)
    x_gpu, i_gpu = st.cg_solve(A.to(cuda), b.to(cuda), tol=0.0, rtol=1e-10, M=M.to(cuda))
    assert i_gpu.converged and i_gpu.iterations == i_cpu.iterations
    assert rel(x_gpu, x_cpu) <= 1e-9


def _panels(XT, layout):
    if layout == "cols":
        return XT.T.contiguous()
    if layout == "interleaved":
        return interleave_panels(XT)
    return XT


@pytest.mark.parametrize("k", [1, 3, 8, 16])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
def test_dia_spmm_kernel(cuda, pair, layout, k):
    vdt, xdt = pair
    n, m, offsets = 45_001, 60_000, [-4, -1, 0, 300, 2500]  # wide, unaligned
    g = torch.Generator(device=cuda).manual_seed(2)
    data = torch.randn(len(offsets), -(-n // 128) * 128, generator=g, device=cuda).to(vdt)
    X = _panels(torch.randn(k, m, generator=g, device=cuda).to(xdt), layout)
    offs = torch.tensor(offsets, device=cuda)
    before = dia_spmm.launches, dia_spmm.launches_by_layout[layout]
    Y = dia_spmm(data, X, offs, n, m, layout)
    torch.cuda.synchronize()
    assert (dia_spmm.launches, dia_spmm.launches_by_layout[layout]) == (
        before[0] + 1, before[1] + 1
    )
    ref = dia_spmm_reference(data, X, offs, n, m, layout)
    assert Y.dtype == xdt and Y.shape == ref.shape
    # covers the interleaved padding rows, which must come back zero
    assert rel(Y, ref) <= _tol(xdt)


@pytest.mark.parametrize("k", [1, 3, 8, 16])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
def test_dia_sym_spmm_kernel(cuda, pair, layout, k):
    vdt, xdt = pair
    n, offsets = 33_333, [0, 1, 130, 2500]
    g = torch.Generator(device=cuda).manual_seed(3)
    data = torch.randn(len(offsets), -(-n // 128) * 128, generator=g, device=cuda).to(vdt)
    X = _panels(torch.randn(k, n, generator=g, device=cuda).to(xdt), layout)
    offs = torch.tensor(offsets, device=cuda)
    before = dia_sym_spmm.launches
    Y = dia_sym_spmm(data, X, offs, n, layout)
    torch.cuda.synchronize()
    assert dia_sym_spmm.launches == before + 1
    assert rel(Y, dia_sym_spmm_reference(data, X, offs, n, layout)) <= _tol(xdt)


def test_spmm_kernel_rejects_what_it_does_not_take(cuda):
    data = torch.zeros(1, 128, dtype=torch.float64, device=cuda)
    offs = torch.zeros(1, dtype=torch.int64, device=cuda)
    # f64 values with f32 panels: no such instantiation
    with pytest.raises(TypeError, match="no DIA kernel"):
        dia_spmm(data, torch.zeros(100, 2, device=cuda), offs, 100, 100, "cols")
    with pytest.raises(TypeError, match="no DIA kernel"):
        dia_sym_spmm(data, torch.zeros(2, 100, device=cuda), offs, 100, "rhs_major")
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmm(data.float(), torch.zeros(2, 200, device=cuda)[:, ::2], offs, 100, 100, "rhs_major")
    with pytest.raises(ValueError, match="1 to 16"):
        dia_spmm(data.float(), torch.zeros(100, 17, device=cuda), offs, 100, 100, "cols")


def test_multi_rhs_methods_on_card_match_cpu(cuda):
    rng = np.random.default_rng(4)
    n, m = 60_000, 45_001
    offsets = (-2500, -300, 0, 4, 2500)
    data = np.zeros((len(offsets), -(-n // 128) * 128))
    for d, o in enumerate(offsets):
        lo, hi = max(0, -o), min(n, m - o)
        data[d, lo:hi] = rng.standard_normal(hi - lo)
    nnz = int(np.count_nonzero(data))
    A = st.DIAMatrix(graph=st.DIAGraph(offsets=offsets, shape=(n, m), nnz=nnz),
                     data=torch.from_numpy(data))
    Ag = A.to(cuda)
    X = torch.from_numpy(rng.standard_normal((m, 20)))
    assert rel(Ag.matmat(X.to(cuda)), A.matmat(X)) <= 1e-12  # two passes: 16 + 4
    Xn = torch.from_numpy(rng.standard_normal((n, 5)))
    assert rel(Ag.rmatmat(Xn.to(cuda)), A.rmatmat(Xn)) <= 1e-12
    XI = interleave_panels(X[:, :8].T.contiguous(), m)
    assert rel(Ag.matmat_interleaved(XI.to(cuda)), A.matmat_interleaved(XI)) <= 1e-12
    assert Ag.interleaved_profitable(8) and not A.interleaved_profitable(8)


def test_block_cg_and_lobpcg_on_card_match_cpu(cuda):
    nx = 24
    A = st.SymmetricDIAMatrix.from_dia(st.laplacian_3d_dia(nx, torch.float64, diag=6.0, device="cpu"))
    M = st.structured_pair_amg(A, (nx, nx, nx), pairs_per_level=3)
    B = torch.from_numpy(np.random.default_rng(5).standard_normal((A.shape[0], 4)))
    Ag, Mg = A.to(cuda), M.to(cuda)
    X_cpu, i_cpu = st.block_cg_solve(A, B, tol=0.0, rtol=1e-10, M=M)
    X_gpu, i_gpu = st.block_cg_solve(Ag, B.to(cuda), tol=0.0, rtol=1e-10, M=Mg)
    assert i_gpu.converged and i_gpu.iterations == i_cpu.iterations
    assert rel(X_gpu, X_cpu) <= 1e-9
    # the interleaved layout on the card takes the column layout's iterations
    Af = st.laplacian_3d_dia(nx, torch.float64, cuda)
    Xi, ii = st.block_cg_solve(Af, B.to(cuda), tol=0.0, rtol=1e-10, panels="auto")
    Xc, ic = st.block_cg_solve(Af, B.to(cuda), tol=0.0, rtol=1e-10, panels="cols")
    assert ii.iterations == ic.iterations and rel(Xi, Xc) <= 1e-9
    X0 = np.random.default_rng(6).standard_normal((A.shape[0], 3))
    r_cpu = st.lobpcg(A, X0, M=M, tol=1e-7, maxiter=200)
    r_gpu = st.lobpcg(Ag, X0, M=Mg, tol=1e-7, maxiter=200)
    assert r_gpu.converged
    assert rel(r_gpu.eigenvalues, r_cpu.eigenvalues) <= 1e-10


def test_constructors_default_to_the_card(cuda):
    assert st.laplacian_3d_dia(4).data.device.type == "cuda"
    n, r, c, v = st.irregular_mesh_laplacian_coo(8, 4, rng=np.random.default_rng(0))
    assert st.DIAMatrix.from_coo(n, n, r, c, v).data.device.type == "cuda"
    P = st.PrunedDIAMatrix.from_coo(n, n, r, c, v, tile_rows=1024)
    assert P.data.device.type == P.offsets.device.type == P.tile_ptr.device.type == "cuda"


def _random_plan(rng, n, m, band, lo=None, sym_shift=0):
    rows = rng.integers(0, n, 4 * n)
    cols = rows + rng.integers(-band if lo is None else lo, band + 1, rows.size)
    ok = (cols >= 0) & (cols < m)
    return sp.build_pruned_plan(n, m, rows[ok], cols[ok], rng.standard_normal(ok.sum()),
                                tile_rows=1024, group=3, dtype=np.float64)


def _on(cuda, P, vdt):
    return (torch.from_numpy(P.data).to(cuda, vdt), torch.from_numpy(P.offsets).to(cuda),
            torch.from_numpy(P.tile_ptr).to(cuda))


@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
@pytest.mark.parametrize("n,m", [(5000, 5000), (4096, 4500), (3000, 2900)])
def test_pruned_spmv_and_spmm_kernels(cuda, pair, n, m):
    vdt, xdt = pair
    rng = np.random.default_rng(10)
    P = _random_plan(rng, n, m, 900)
    d, o, tp = _on(cuda, P, vdt)
    x = torch.from_numpy(rng.standard_normal(m)).to(cuda, xdt)
    before = sp.pruned_spmv.launches, sp.pruned_spmm.launches
    by_layout = dict(sp.pruned_spmm.launches_by_layout)
    assert rel(sp.pruned_spmv(d, x, o, tp, n, m), sp.pruned_matvec_reference(d, x, o, tp, n, m)) <= _tol(xdt)
    for layout in sp.PRUNED_LAYOUTS:
        for k in (1, 3, 8, 16):
            XT = torch.from_numpy(rng.standard_normal((k, m))).to(cuda, xdt)
            X = XT if layout == "rhs_major" else XT.T.contiguous()
            Y = sp.pruned_spmm(d, X, o, tp, n, m, layout)
            assert rel(Y, sp.pruned_spmm_reference(d, X, o, tp, n, m, layout)) <= _tol(xdt)
    torch.cuda.synchronize()
    assert (sp.pruned_spmv.launches, sp.pruned_spmm.launches) == (before[0] + 1, before[1] + 8)
    assert {k: sp.pruned_spmm.launches_by_layout[k] - v for k, v in by_layout.items()} == {
        "rhs_major": 4, "cols": 4}


@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
@pytest.mark.parametrize("n,m,shift", [(5000, 5000, 0), (3072, 3072, 0), (2048, 2560, 128)])
def test_pruned_sym_kernels_with_spill(cuda, pair, n, m, shift):
    vdt, xdt = pair
    rng = np.random.default_rng(11)
    P = _random_plan(rng, n, m, 300 + shift, lo=shift)
    d, o, tp = _on(cuda, P, vdt)
    kw = dict(halo=P.halo, sym_shift=shift, with_spill=True)
    x = torch.from_numpy(rng.standard_normal(m)).to(cuda, xdt)
    y, s = sp.pruned_sym_spmv(d, x, o, tp, n, m, **kw)
    yr, sr = sp.pruned_sym_matvec_reference(d, x, o, tp, n, m, **kw)
    assert rel(y, yr) <= _tol(xdt) and float((s - sr).abs().max()) <= _tol(xdt) * float(yr.abs().max())
    assert (shift > 0) == bool(sr.abs().max() > 0)
    for layout in sp.PRUNED_LAYOUTS:
        for k in (1, 3, 8, 16):
            XT = torch.from_numpy(rng.standard_normal((k, m))).to(cuda, xdt)
            X = XT if layout == "rhs_major" else XT.T.contiguous()
            Y, S = sp.pruned_sym_spmm(d, X, o, tp, n, m, layout, **kw)
            Yr, Sr = sp.pruned_sym_spmm_reference(d, X, o, tp, n, m, layout, **kw)
            assert rel(Y, Yr) <= _tol(xdt)
            assert float((S - Sr).abs().max()) <= _tol(xdt) * float(Yr.abs().max())


def test_pruned_kernels_reject_what_they_do_not_take(cuda):
    rng = np.random.default_rng(12)
    P = _random_plan(rng, 2048, 2048, 100)
    d, o, tp = _on(cuda, P, torch.float64)
    with pytest.raises(TypeError, match="no pruned kernel"):
        sp.pruned_spmv(d, torch.zeros(2048, device=cuda), o, tp, 2048, 2048)
    with pytest.raises(ValueError, match="1 to 16"):
        sp.pruned_spmm(d, torch.zeros(2048, 17, dtype=torch.float64, device=cuda), o, tp, 2048, 2048, "cols")
    with pytest.raises(ValueError, match="different devices"):
        sp.pruned_spmv(d, torch.zeros(2048, dtype=torch.float64), o, tp, 2048, 2048)


def test_unstructured_path_on_card_matches_cpu(cuda):
    n, r, c, v = st.irregular_mesh_laplacian_coo(512, 16, rng=np.random.default_rng(0),
                                                 shift=1e-3, shuffle=True)
    pr, pc, v, _ = st.reorder_triples_rcm(n, r, c, v)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n))
    for sym in (False, True):
        cls = st.SymmetricPrunedDIAMatrix if sym else st.PrunedDIAMatrix
        A = cls.from_coo(n, n, pr, pc, v, tile_rows=1024, assume_unique=True, device="cpu")
        M = st.pruned_pair_amg(n, pr, pc, v, coarse_size=128, tile_rows=1024, fine_A=A,
                               symmetric=sym)
        x_cpu, i_cpu = st.cg_solve(A, b, tol=0.0, rtol=1e-10, M=M)
        x_gpu, i_gpu = st.cg_solve(A.to(cuda), b.to(cuda), tol=0.0, rtol=1e-10, M=M.to(cuda))
        assert i_gpu.converged and abs(i_gpu.iterations - i_cpu.iterations) <= 1
        assert rel(x_gpu, x_cpu) <= 1e-8
        B = torch.from_numpy(np.random.default_rng(2).standard_normal((n, 4)))
        X_gpu, ib = st.block_cg_solve(A.to(cuda), B.to(cuda), tol=0.0, rtol=1e-10, M=M.to(cuda))
        X_cpu, ibc = st.block_cg_solve(A, B, tol=0.0, rtol=1e-10, M=M)
        assert ib.converged and abs(ib.iterations - ibc.iterations) <= 1
        assert rel(X_gpu, X_cpu) <= 1e-8


# -- the full-band path: grouped SpMM (#9) and staged-x SpMV (#5, #6) --------
def _band(cuda, rng, n, m, offsets, vdt):
    data = np.zeros((len(offsets), -(-n // 128) * 128))
    for d, o in enumerate(offsets):
        lo, hi = max(0, -o), min(n, m - o)
        data[d, lo:hi] = rng.standard_normal(max(hi - lo, 0))
    return torch.from_numpy(data).to(cuda, vdt), torch.tensor(offsets, device=cuda)


# the grouped kernel's two routes for x: 100 scattered diagonals (several
# value slabs in every dtype, each spread too wide for the shared-memory x
# window) and a band of 117 with gaps (the window, with and without the
# register carry between consecutive offsets)
_WIDE = sorted(int(o) for o in np.random.default_rng(20).choice(np.arange(-3000, 3001), 100,
                                                                replace=False))
_GAPPED = sorted(set(range(-60, 61)) - {-7, 3, 4, 30})


@pytest.mark.parametrize("k", [17, 24, 32, 48])
@pytest.mark.parametrize("layout", st.ops.GROUPED_LAYOUTS)
@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
@pytest.mark.parametrize("offsets", [_WIDE, _GAPPED], ids=["scattered", "band_with_gaps"])
def test_dia_spmm_grouped_kernel(cuda, pair, layout, k, offsets):
    vdt, xdt = pair
    rng = np.random.default_rng(21)
    n, m = 20_001, 25_000  # rectangular, unaligned, an odd row count
    data, offs = _band(cuda, rng, n, m, offsets, vdt)
    XT = torch.from_numpy(rng.standard_normal((k, m))).to(cuda, xdt)
    X = XT if layout == "rhs_major" else XT.T.contiguous()
    before = st.ops.dia_spmm_grouped.launches_by_layout[layout]
    Y = st.ops.dia_spmm_grouped(data, X, offs, n, m, layout)
    torch.cuda.synchronize()
    assert st.ops.dia_spmm_grouped.launches_by_layout[layout] == before + 1
    ref = st.ops.dia_spmm_grouped_reference(data, X, offs, n, m, layout)
    assert Y.dtype == xdt and Y.shape == ref.shape
    assert rel(Y, ref) <= _tol(xdt)


@pytest.mark.parametrize("tile_rows", [128, 256])
@pytest.mark.parametrize("offsets", [[-3000, -300, -1, 0, 1, 300, 3000], list(range(-122, 123))],
                         ids=["reach_past_a_tile", "band"])
@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
def test_staged_spmv_kernels(cuda, pair, offsets, tile_rows):
    vdt, xdt = pair
    rng = np.random.default_rng(22)
    n = m = 20_001  # unaligned; x fits shared memory in f32 and f64
    data, offs = _band(cuda, rng, n, m, offsets, vdt)
    x = torch.from_numpy(rng.standard_normal(m)).to(cuda, xdt)
    ref = dia_spmv_reference(data, x, offs, n, m)
    before = st.ops.dia_spmv_resident.launches, st.ops.dia_spmv_window.launches
    y_res = st.ops.dia_spmv_staged(data, x, offsets, n, m)
    y_win = st.ops.dia_spmv_window(data, x, offsets, n, m, tile_rows=tile_rows)
    torch.cuda.synchronize()
    assert (st.ops.dia_spmv_resident.launches, st.ops.dia_spmv_window.launches) == (
        before[0] + 1, before[1] + 1)
    assert rel(y_res, ref) <= _tol(xdt) and rel(y_win, ref) <= _tol(xdt)


def test_staged_routes_and_raises_where_x_does_not_fit(cuda):
    rng = np.random.default_rng(23)
    n = m = 60_000  # 240,000 bytes of f32 x: past one block's shared memory
    offsets = [-5000, 0, 7]
    data, offs = _band(cuda, rng, n, m, offsets, torch.float32)
    x = torch.from_numpy(rng.standard_normal(m)).to(cuda, torch.float32)
    ref = dia_spmv_reference(data, x, offs, n, m)
    with pytest.raises(ValueError, match="does not fit"):
        st.ops.dia_spmv_resident(data, x, offsets, n, m)
    before = dia_spmv.launches, st.ops.dia_spmv_window.launches
    assert rel(st.ops.dia_spmv_staged(data, x, offsets, n, m), ref) <= 1e-5  # -> dia_spmv
    assert rel(st.ops.dia_spmv_staged(data, x, offsets, n, m, allow_dma_path=True), ref) <= 1e-5
    assert (dia_spmv.launches, st.ops.dia_spmv_window.launches) == (before[0] + 1, before[1] + 1)
    # 31 disjoint windows of 1024 f64 values: 253,952 bytes
    far = [3_000 * j for j in range(-15, 16)]
    dataf, _ = _band(cuda, rng, 100_000, 100_000, far, torch.float64)
    xf = torch.zeros(100_000, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        st.ops.dia_spmv_window(dataf, xf, far, 100_000, 100_000, tile_rows=1024)
    with pytest.raises(ValueError, match="multiple of 32"):
        st.ops.dia_spmv_window(dataf, xf, far, 100_000, 100_000, tile_rows=100)


def test_full_band_path_on_card_matches_cpu(cuda):
    """CSR -> to_banded_dia assembled on the card equals the CPU band;
    CG, k = 24 and k = 32 products (the grouped route) and banded
    multigrid CG agree with the CPU."""
    n, r, c, v = st.irregular_mesh_laplacian_coo(128, 32, rng=np.random.default_rng(0),
                                                 shift=1e-3, shuffle=True)
    A = st.CSRMatrix.from_coo(n, n, r, c, v, dtype=torch.float64, device="cpu")
    D, p = st.to_banded_dia(A)  # RCM: 117 diagonals
    Dg, pg = st.to_banded_dia(A.to(cuda))
    assert Dg.data.device.type == "cuda" and np.array_equal(p, pg)
    assert Dg.offsets == D.offsets and torch.equal(Dg.data.cpu(), D.data)
    assert D.grouped_profitable(24) and D.grouped_profitable(32)
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.standard_normal((D.shape[0], 24)))
    before = dict(st.ops.dia_spmm_grouped.launches_by_layout)
    assert rel(Dg.matmat(X.to(cuda)), D.matmat(X)) <= 1e-12
    XT = torch.from_numpy(rng.standard_normal((32, D.shape[0])))
    assert rel(Dg.matmat_rhs_major(XT.to(cuda)), D.matmat_rhs_major(XT)) <= 1e-12
    after = st.ops.dia_spmm_grouped.launches_by_layout
    assert (after["cols"] - before["cols"], after["rhs_major"] - before["rhs_major"]) == (1, 1)
    b = torch.from_numpy(rng.standard_normal(D.shape[0]))
    M = st.structured_pair_amg(D, (D.shape[0],), coarse_size=256)
    x_cpu, i_cpu = st.cg_solve(D, b, tol=0.0, rtol=1e-10, M=M)
    x_gpu, i_gpu = st.cg_solve(Dg, b.to(cuda), tol=0.0, rtol=1e-10, M=M.to(cuda))
    assert i_gpu.converged and abs(i_gpu.iterations - i_cpu.iterations) <= 1
    assert rel(x_gpu, x_cpu) <= 1e-8


# -- the block / multi-DOF path: grouped BSR, BlockMatrix ----------------------

_BSR_TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def _block_dense(rng, n, m, bh):
    d = np.where(rng.random((n, m)) < 0.04, rng.standard_normal((n, m)), 0.0)
    d[: 4 * bh] = np.where(rng.random((4 * bh, m)) < 0.3, rng.standard_normal((4 * bh, m)), 0.0)
    d[n // 2 : n // 2 + 3 * bh] = 0.0  # empty block rows
    return d


@pytest.mark.parametrize("k", [1, 3, 4, 8, 11])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("pair", sorted(st.ops.BSR_KERNEL_DTYPES, key=str), ids=str)
@pytest.mark.parametrize("shape,blk", [((500, 460), (8, 16)), ((260, 260), (4, 4)),
                                       ((301, 305), (3, 3)), ((520, 1000), (8, 128))])
def test_bsr_grouped_kernel(cuda, shape, blk, pair, group, k):
    """The grouped-BSR kernel against its plain version on the card, and
    the matrix assembled on the card against the one assembled on the CPU:
    shapes the blocks do not divide, empty block rows, rows of several
    groups, k past the 8 columns of one pass.  f64 and f32 accumulate in
    x's dtype; bf16 vectors in f32 with one rounding, so kernel and plain
    version may land one bf16 step (2^-7) apart."""
    vdt, xdt = pair
    n, m = shape
    rng = np.random.default_rng(14)
    dense = _block_dense(rng, n, m, blk[0])
    r, c = np.nonzero(dense)
    A = st.BSRMatrix.from_coo(n, m, r, c, dense[r, c], dtype=vdt, block_shape=blk)
    assert A.device.type == "cuda" and A.graph.device.type == "cuda"
    Ac = st.BSRMatrix.from_coo(n, m, r, c, dense[r, c], dtype=vdt, block_shape=blk, device="cpu")
    assert torch.equal(A.data.cpu(), Ac.data) and torch.equal(A.graph.mask.cpu(), Ac.graph.mask)
    G, Gc = A.grouped(group), Ac.grouped(group)
    for name in ("gdata", "gcols", "grow", "gptr"):
        assert torch.equal(getattr(G, name).cpu(), getattr(Gc, name)), name
    X = torch.from_numpy(rng.standard_normal((m, k))).to(cuda, xdt)
    before = st.ops.bsr_grouped_spmv.launches
    Y = G.matmat(X)
    torch.cuda.synchronize()
    assert st.ops.bsr_grouped_spmv.launches == before + 1
    Xp = G._pad_x(X).contiguous()
    ref = st.ops.bsr_grouped_spmv_reference(G.gdata, G.gcols, G.grow, Xp, G.nb_rows, G.nb_cols,
                                            G.block_shape, G.group)[:n]
    assert Y.dtype == xdt and rel(Y, ref) <= _BSR_TOL[xdt]
    assert rel(Y, Gc.matmat(X.cpu())) <= _BSR_TOL[xdt]
    if k == 1:
        assert rel(G.matvec(X[:, 0].contiguous()), ref[:, 0]) <= _BSR_TOL[xdt]


def test_bsr_grouped_kernel_rejects_what_it_does_not_take(cuda):
    dense = _block_dense(np.random.default_rng(15), 64, 64, 4)
    r, c = np.nonzero(dense)
    G = st.BSRMatrix.from_coo(64, 64, r, c, dense[r, c], dtype=torch.float64,
                              block_shape=(4, 4)).grouped(4)
    with pytest.raises(TypeError, match="no grouped-BSR kernel"):
        G.matvec(torch.zeros(64, dtype=torch.float32, device=cuda))  # f64 values, f32 vector
    with pytest.raises(TypeError, match="no grouped-BSR kernel"):
        G.matvec(torch.zeros(64, dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError, match="different devices"):
        G.matvec(torch.zeros(64, dtype=torch.float64))
    X = torch.zeros((64, 2), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        st.ops.bsr_grouped_spmv(G.gdata, G.gcols, G.grow, X.T.contiguous().T, G.nb_rows,
                                G.nb_cols, G.block_shape, G.group)
    with pytest.raises(RuntimeError, match="CUDA error"):
        st.ops.bsr_grouped_spmv(G.gdata, G.gcols, G.grow, X, G.nb_rows, G.nb_cols,
                                G.block_shape, G.group, lanes=3)


def test_block_path_on_card_matches_cpu(cuda):
    """The elasticity operator at nx = 12 in its three layouts, built on the
    card: equal arrays to the CPU build, A x agreeing across the layouts,
    a BlockMatrix matvec of 9 DIA launches, and Jacobi-CG with the CPU's
    iteration count (+-1: f32 sums in another order)."""
    nx = 12
    n = nx ** 3
    perm = torch.from_numpy(st.elasticity_permutation(n)).to(cuda)
    A = st.elasticity_field_blocked(nx)
    D = st.elasticity_node_major_dia(nx)
    S = st.elasticity_node_major_dia(nx, symmetric=True)
    B = st.elasticity_node_major_bsr(nx)
    G = B.grouped(8)
    assert {op.device.type for op in (A, D, S, B, G)} == {"cuda"}
    Gc = st.elasticity_node_major_bsr(nx, device="cpu").grouped(8)
    for name in ("gdata", "gcols", "grow"):
        assert torch.equal(getattr(G, name).cpu(), getattr(Gc, name)), name
    g = torch.Generator(device=cuda).manual_seed(0)
    xv = torch.randn(3 * n, generator=g, device=cuda)
    xn = torch.empty_like(xv)
    xn[perm] = xv
    before = st.ops.dia_spmv.launches
    y = A.matvec(xv)
    assert st.ops.dia_spmv.launches == before + 9
    for op in (D, S, G, B):
        assert rel(op.matvec(xn)[perm], y) <= 1e-5
        assert rel(op.matmat(torch.stack([xn, 2 * xn], 1))[perm], torch.stack([y, 2 * y], 1)) <= 1e-5
    xstar = torch.sin(torch.arange(n, dtype=torch.float32, device=cuda) * 0.001).repeat(3)
    b = A.matvec(xstar)
    bn = torch.empty_like(b)
    bn[perm] = b
    Ac, Mc = st.elasticity_field_blocked(nx, device="cpu"), st.elasticity_jacobi(nx, device="cpu")
    _, i_cpu = st.cg_solve(Ac, b.cpu(), tol=0.0, rtol=1e-6, maxiter=150, M=Mc)
    for op, rhs, node in ((A, b, False), (D, bn, True), (S, bn, True), (G, bn, True)):
        M = st.elasticity_jacobi(nx, node_major=node)
        x, info = st.cg_solve(op, rhs, tol=0.0, rtol=1e-6, maxiter=150, M=M)
        assert info.converged and abs(info.iterations - i_cpu.iterations) <= 1
        assert float(((x[perm] if node else x) - xstar).abs().max()) < 1e-4
