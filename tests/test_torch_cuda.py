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


def _offset_view(t, k):
    """A contiguous copy of t that starts k elements into a larger store
    (off a 16-byte boundary for k = 1)."""
    store = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    v = store[k:].view(t.shape)
    v.copy_(t)
    return v


# dia_spmv's load forms: 16-byte value pieces (stride a multiple of 128) or
# one value a load (an odd stride, values or x off a 16-byte boundary); n
# not a whole number of a thread's rows, n smaller than one block, offsets
# past +-n, and more diagonals than one staged chunk of 128
_MANY = sorted(int(o) for o in np.random.default_rng(24).choice(np.arange(-3000, 3001), 300,
                                                                replace=False))


@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
@pytest.mark.parametrize(
    "n,m,offsets,form",
    [
        (50_000, 50_000, [-2500, -300, -1, 0, 1, 300, 2500], "aligned"),
        (60_000, 45_001, [-2500, -300, 0, 4, 2500], "aligned"),
        (45_001, 60_000, [-4, -1, 0, 300, 2500], "aligned"),
        (70_000, 70_000, [0], "aligned"),
        (33_333, 33_333, [-300, -1, 0, 1, 2, 3, 300], "odd_stride"),
        (50_003, 49_999, [-2500, -3, -1, 0, 1, 7, 2500], "aligned"),
        (100, 90, [-7, -1, 0, 1, 2, 50], "aligned"),
        (37, 41, [-5, 0, 3], "odd_stride"),
        (20_000, 20_000, [-20_005, -20_000, -1, 0, 1, 20_000, 20_003], "aligned"),
        (20_001, 25_000, _MANY, "aligned"),
        (20_001, 25_000, _MANY, "odd_stride"),
        (30_000, 30_000, [-300, -1, 0, 1, 300], "values_off_16"),
        (30_000, 30_000, [-300, -1, 0, 1, 300], "x_off_16"),
    ],
)
def test_dia_spmv_kernel(cuda, pair, n, m, offsets, form):
    vdt, xdt = pair
    g = torch.Generator(device=cuda).manual_seed(0)
    if form == "odd_stride":
        stride = n + 1 + n % 2
    else:
        stride = -(-n // 128) * 128
    # NaN in every slot outside the matrix: an out-of-range term must be
    # skipped, never multiplied by zero
    data = torch.randn(len(offsets), stride, generator=g, device=cuda, dtype=torch.float64)
    rows = torch.arange(stride, device=cuda)
    cols = rows[None, :] + torch.tensor(offsets, device=cuda)[:, None]
    data[~((rows[None, :] < n) & (cols >= 0) & (cols < m))] = float("nan")
    data = data.to(vdt)
    x = torch.randn(m, generator=g, device=cuda).to(xdt)
    if form == "values_off_16":
        data = _offset_view(data, 1)
    if form == "x_off_16":
        x = _offset_view(x, 1)
    offs = torch.tensor(offsets, device=cuda)
    before = dia_spmv.launches
    y = dia_spmv(data, x, offs, n, m)
    torch.cuda.synchronize()
    assert dia_spmv.launches == before + 1
    assert y.dtype == xdt and y.shape == (n,)
    assert rel(y, dia_spmv_reference(data, x, offs, n, m)) <= _tol(xdt)


# dia_sym_spmv's load forms (NaN in every slot outside the matrix): 16-byte
# value pieces, one value a load (an odd stride, values off a 16-byte
# boundary), x off a 16-byte boundary, n not a whole number of a thread's
# rows, n below one block, offsets at and past n, no main diagonal, more
# diagonals than one staged chunk; mirror offsets that are and are not
# multiples of a thread's rows
_MANY_UPPER = sorted(int(o) for o in np.random.default_rng(25).choice(np.arange(0, 3001), 300,
                                                                     replace=False))


@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
@pytest.mark.parametrize(
    "n,offsets,form",
    [
        (50_000, [0, 1, 300, 2500], "aligned"),
        (33_333, [1, 130, 259], "aligned"),
        (40_001, [0, 1, 2, 3, 5, 7, 122], "aligned"),
        (33_333, [0, 1, 30, 259], "odd_stride"),
        (30_000, [0, 1, 3, 300], "values_off_16"),
        (30_000, [0, 1, 3, 300], "x_off_16"),
        (50_003, [0, 1, 5, 250], "aligned"),
        (37, [0, 1, 2, 5], "aligned"),
        (37, [0, 3, 36], "odd_stride"),
        (20_000, [0, 1, 19_999, 20_000, 20_003], "aligned"),
        (20_001, _MANY_UPPER, "aligned"),
        (20_001, _MANY_UPPER, "odd_stride"),
    ],
)
def test_dia_sym_spmv_kernel(cuda, pair, n, offsets, form):
    vdt, xdt = pair
    g = torch.Generator(device=cuda).manual_seed(1)
    stride = n + 1 + n % 2 if form == "odd_stride" else -(-n // 128) * 128
    # NaN in every slot outside the matrix (slot (d, i) holds A[i, i + o]
    # for i < n - o): a mirror term before row 0 is skipped, never
    # multiplied by zero
    data = torch.randn(len(offsets), stride, generator=g, device=cuda, dtype=torch.float64)
    rows = torch.arange(stride, device=cuda)
    data[~(rows[None, :] + torch.tensor(offsets, device=cuda)[:, None] < n)] = float("nan")
    data = data.to(vdt)
    x = torch.randn(n, generator=g, device=cuda).to(xdt)
    if form == "values_off_16":
        data = _offset_view(data, 1)
    if form == "x_off_16":
        x = _offset_view(x, 1)
    offs = torch.tensor(offsets, device=cuda)
    before = dia_sym_spmv.launches
    y = dia_sym_spmv(data, x, offs, n)
    y2 = dia_sym_spmv(data, x, offs, n)
    torch.cuda.synchronize()
    assert dia_sym_spmv.launches == before + 2
    assert torch.equal(y, y2)  # the same bits on every launch
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


# dia_spmm's offset sets at 20,001 x 25,000 (n != m, n not a multiple of a
# block's rows) over the port's value stride (n padded to a multiple of 128:
# value rows in 16-byte pieces, NaN padding rows from n on): a stencil's far
# offsets (runs of one diagonal), a band, a band with gaps, a band wider
# than one window (several runs), offsets wholly outside [-n, m], none; and
# the stencil's offsets over an odd stride (one value a copy) and over a
# stride of 2 mod 4 just past n (f64 rows in 16-byte pieces, whose last row
# group's piece would run past the row).  Slots outside the matrix hold NaN:
# an out-of-range term must be selected away.
_SPMM_N, _SPMM_M = 20_001, 25_000
_SPMM_STRIDE = -(-_SPMM_N // 128) * 128
_STENCIL = [-4900, -70, -1, 0, 1, 70, 4900]
_SPMM_OFFSETS = {
    "stencil": (_STENCIL, _SPMM_STRIDE),
    "band": (list(range(-122, 123)), _SPMM_STRIDE),
    "band_with_gaps": (sorted(set(range(-60, 61)) - {-7, 3, 4, 30}), _SPMM_STRIDE),
    "past_the_window": (list(range(-600, 601)), _SPMM_STRIDE),
    "outside": ([-_SPMM_N - 7, -_SPMM_N, _SPMM_M, _SPMM_M + 5, 3 * _SPMM_M], _SPMM_STRIDE),
    "none": ([], _SPMM_STRIDE),
    "odd_stride": (_STENCIL, _SPMM_N + 2),
    "stride_2_mod_4": (_STENCIL, _SPMM_N + 1),
}


# k: one and two column groups of the register tile (four with f64
# vectors), whole and partial tiles
@pytest.mark.parametrize("k", [1, 3, 4, 5, 8, 9, 12, 16])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
@pytest.mark.parametrize("offsets", sorted(_SPMM_OFFSETS))
def test_dia_spmm_kernel_offset_sets(cuda, pair, layout, k, offsets):
    vdt, xdt = pair
    offs, stride = _SPMM_OFFSETS[offsets]
    n, m = _SPMM_N, _SPMM_M
    g = torch.Generator(device=cuda).manual_seed(5)
    off_t = torch.tensor(offs, dtype=torch.int64, device=cuda)
    data = torch.randn((len(offs), stride), generator=g, device=cuda, dtype=torch.float64)
    rows = torch.arange(stride, device=cuda)
    cols = rows[None, :] + off_t[:, None]
    data[~((rows[None, :] < n) & (cols >= 0) & (cols < m))] = float("nan")
    data = data.to(vdt)
    X = _panels(torch.randn((k, m), generator=g, device=cuda, dtype=xdt), layout)
    Y = dia_spmm(data, X, off_t, n, m, layout)
    torch.cuda.synchronize()
    ref = dia_spmm_reference(data, X, off_t, n, m, layout)
    assert Y.dtype == xdt and Y.shape == ref.shape
    # every row, the interleaved layout's zero padding included (y comes
    # from torch.empty)
    assert rel(Y, ref) <= _tol(xdt)


# k: the edges of a 4- and an 8-column register tile; value forms: the
# port's storage (16-byte pieces), a value view off a 16-byte boundary and
# an odd stride (one value a load).  Slots the matrix does not hold (rows n
# - o and past of each diagonal) are NaN: a term there must be selected
# away, never multiplied by zero.
@pytest.mark.parametrize("form", ["aligned", "unaligned_view", "odd_stride"])
@pytest.mark.parametrize("k", [1, 3, 4, 5, 8, 9, 12, 16])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
def test_dia_sym_spmm_kernel(cuda, pair, layout, k, form):
    vdt, xdt = pair
    n, offsets = 33_333, [0, 1, 130, 2500]
    g = torch.Generator(device=cuda).manual_seed(3)
    stride = n + 2 if form == "odd_stride" else -(-n // 128) * 128
    offs = torch.tensor(offsets, device=cuda)
    vals = torch.randn(len(offsets), stride, generator=g, device=cuda, dtype=torch.float64)
    rows = torch.arange(stride, device=cuda)
    vals[rows[None, :] + offs[:, None] >= n] = float("nan")
    data = _offset_view(vals.to(vdt), 1) if form == "unaligned_view" else vals.to(vdt)
    X = _panels(torch.randn(k, n, generator=g, device=cuda).to(xdt), layout)
    before = dia_sym_spmm.launches
    Y = dia_sym_spmm(data, X, offs, n, layout)
    Y2 = dia_sym_spmm(data, X, offs, n, layout)
    torch.cuda.synchronize()
    assert dia_sym_spmm.launches == before + 2
    assert torch.equal(Y, Y2)  # two launches, the same bits
    ref = dia_sym_spmm_reference(data, X, offs, n, layout)
    assert Y.dtype == xdt and Y.shape == ref.shape
    # every row, the interleaved layout's zero padding included
    assert rel(Y, ref) <= _tol(xdt)


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


# edge cases of the SpMV kernels (1024-row blocks, a TMA value ring and a
# staged x window where the tile's reach allows, plain loads beyond it):
# (n, m, tile_rows, reach, sym_shift, empty tile)
_SPMV_EDGES = {
    "n_not_a_multiple_of_the_block": (5000, 5000, 1024, 300, 0, None),
    "tile_of_padding_only": (6000, 6000, 1024, 200, 0, 2),
    "reach_at_the_halo": (4096, 4096, 1024, 895, 0, None),
    "window_at_its_cap": (4096, 4096, 1024, 508, 0, None),
    "t_minus_1_beyond_the_first_block": (6144, 6144, 2048, 1500, 0, None),
    "sym_shift_spill": (2048, 2560, 1024, 300, 128, None),
}


def _edge_plan(rng, n, m, tile_rows, reach, shift, empty):
    """Banded triples whose reach is exactly ``reach`` (columns >= rows +
    shift for a symmetric block), without the rows of tile ``empty``."""
    rows = rng.integers(0, n, 4 * n)
    lo = shift if shift else -reach
    cols = rows + rng.integers(lo, reach + 1, rows.size)
    rows = np.r_[rows, n // 2, n // 3]
    cols = np.r_[cols, n // 2 + reach, n // 3 + (shift if shift else -reach)]
    keep = (cols >= 0) & (cols < m)
    if empty is not None:
        keep &= rows // tile_rows != empty
    return sp.build_pruned_plan(n, m, rows[keep], cols[keep], rng.standard_normal(keep.sum()),
                                tile_rows=tile_rows, group=3, dtype=np.float64)


@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
@pytest.mark.parametrize("case", sorted(_SPMV_EDGES))
def test_pruned_spmv_kernels_edge_cases(cuda, pair, case):
    vdt, xdt = pair
    n, m, tile_rows, reach, shift, empty = _SPMV_EDGES[case]
    P = _edge_plan(np.random.default_rng(14), n, m, tile_rows, reach, shift, empty)
    assert P.tile_rows == tile_rows
    if empty is not None:
        assert P.tile_end[empty] == P.tile_ptr[empty] < P.tile_ptr[empty + 1]
    d, o, tp = _on(cuda, P, vdt)
    te = torch.from_numpy(P.tile_end).to(cuda)
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(m)).to(cuda, xdt)
    kw = dict(halo=P.halo, sym_shift=shift, with_spill=True)
    yr, sr = sp.pruned_sym_matvec_reference(d, x, o, tp, n, m, **kw)
    for ends in (te, None):
        if not shift:
            y = sp.pruned_spmv(d, x, o, tp, n, m, tile_end=ends)
            assert rel(y, sp.pruned_matvec_reference(d, x, o, tp, n, m)) <= _tol(xdt)
        y, s = sp.pruned_sym_spmv(d, x, o, tp, n, m, tile_end=ends, **kw)
        assert rel(y, yr) <= _tol(xdt)
        assert float((s - sr).abs().max()) <= _tol(xdt) * float(yr.abs().max())
    assert (shift > 0) == bool(sr.abs().max() > 0)
    torch.cuda.synchronize()


# the SpMMs' edge cases: the SpMVs', a band whose x window does not fit
# shared memory at k = 16 with f64 vectors (256-row blocks: the in-kernel
# plain-load route) but does at k <= 4, and an operand of more blocks than
# half an H100's SMs (the fewest column groups; the smaller ones take twice
# as many)
_SPMM_EDGES = {**_SPMV_EDGES, "window_past_its_cap_at_k16_f64": (4096, 4096, 1024, 300, 0, None),
               "more_blocks_than_half_the_sms": (70_000, 70_000, 2048, 300, 0, None)}


@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
@pytest.mark.parametrize("case", sorted(_SPMM_EDGES))
def test_pruned_spmm_kernels_edge_cases(cuda, pair, case):
    """#11 and #13 on the edge cases, both layouts, k in {1, 3, 8, 16},
    with the plan's active tile ends and without (every slot walked),
    spill included; two launches give the same bits."""
    vdt, xdt = pair
    n, m, tile_rows, reach, shift, empty = _SPMM_EDGES[case]
    rng = np.random.default_rng(16)
    P = _edge_plan(rng, n, m, tile_rows, reach, shift, empty)
    assert P.tile_rows == tile_rows
    d, o, tp = _on(cuda, P, vdt)
    te = torch.from_numpy(P.tile_end).to(cuda)
    kw = dict(halo=P.halo, sym_shift=shift, with_spill=True)
    for layout in sp.PRUNED_LAYOUTS:
        for k in (1, 3, 8, 16):
            XT = torch.from_numpy(rng.standard_normal((k, m))).to(cuda, xdt)
            X = XT if layout == "rhs_major" else XT.T.contiguous()
            Yr, Sr = sp.pruned_sym_spmm_reference(d, X, o, tp, n, m, layout, **kw)
            Fr = None if shift else sp.pruned_spmm_reference(d, X, o, tp, n, m, layout)
            for ends in (te, None):
                Y, S = sp.pruned_sym_spmm(d, X, o, tp, n, m, layout, tile_end=ends, **kw)
                assert rel(Y, Yr) <= _tol(xdt), (layout, k)
                assert float((S - Sr).abs().max()) <= _tol(xdt) * float(Yr.abs().max())
                Y2, S2 = sp.pruned_sym_spmm(d, X, o, tp, n, m, layout, tile_end=ends, **kw)
                assert torch.equal(Y, Y2) and torch.equal(S, S2)
                if Fr is not None:
                    F = sp.pruned_spmm(d, X, o, tp, n, m, layout, tile_end=ends)
                    assert rel(F, Fr) <= _tol(xdt), (layout, k)
                    assert torch.equal(F, sp.pruned_spmm(d, X, o, tp, n, m, layout, tile_end=ends))
    assert (shift > 0) == bool(Sr.abs().max() > 0)
    torch.cuda.synchronize()


def test_edge_list_products_repeat_bit_for_bit(cuda):
    """CSR, COO and CSC products on a shuffled mesh operator (rows of up to
    a dozen terms in random order) give the same bits on every call, and
    the CPU's: each target's terms are added in stored edge order."""
    n, r, c, v = st.irregular_mesh_laplacian_coo(128, 32, rng=np.random.default_rng(0),
                                                 shift=1e-3, shuffle=True)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((n, 5)).astype(np.float32))
    for cls in (st.CSRMatrix, st.COOMatrix, st.CSCMatrix):
        A = cls.from_coo(n, n, r, c, v, dtype=torch.float32, device="cpu")
        Ag = cls.from_coo(n, n, r, c, v, dtype=torch.float32, device=cuda)
        for op, arg in (("matvec", x), ("matmat", X), ("rmatvec", x), ("rmatmat", X)):
            ys = [getattr(Ag, op)(arg.to(cuda)) for _ in range(3)]
            assert all(torch.equal(ys[0], y) for y in ys[1:]), (cls.__name__, op)
            assert torch.equal(ys[0].cpu(), getattr(A, op)(arg)), (cls.__name__, op)


def _sum_site(name, device):
    """The result of one site that sums with index_add_ on the CPU and the
    fixed-order sum elsewhere, on ``device``, from the same seeded inputs
    (f32 values and vectors; the COO assemblies sum in f64)."""
    from sigma_tpu_torch.ops import bsr_grouped_spmv_reference
    from sigma_tpu_torch.matrix import factory as tmf

    n, r, c, v = st.irregular_mesh_laplacian_coo(64, 32, rng=np.random.default_rng(0),
                                                 shift=1e-3, shuffle=True)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)
    X = torch.from_numpy(rng.standard_normal((n, 5)).astype(np.float32)).to(device)
    dense = np.zeros((n, n), dtype=np.float32)
    dense[r, c] = v
    if name.startswith(("ell_", "bsr_")) and not name.endswith("from_coo"):
        fmt, product = name.split("_", 1)
        kw = dict(block_shape=(4, 4)) if fmt == "bsr" else {}
        A = tmf.choose_matrix_type(fmt).from_dense(dense, device=device, **kw)
        return getattr(A, product)(X if product.endswith("mat") else x)
    if name in ("dia_from_coo", "bsr_from_coo"):
        # each triple three times, shuffled
        rr, cc = np.tile(r, 3), np.tile(c, 3)
        vv = rng.standard_normal(rr.size)
        p = rng.permutation(rr.size)
        cls = st.DIAMatrix if name == "dia_from_coo" else st.BSRMatrix
        return cls.from_coo(n, n, rr[p], cc[p], vv[p], dtype=torch.float32, device=device).data
    if name == "add_values":
        A = st.CSRMatrix.from_coo(n, n, r, c, v, dtype=torch.float32, device=device)
        pick = rng.integers(0, r.size, 3 * r.size)
        for _ in range(3):
            A = A.add_values(r[pick], c[pick], rng.standard_normal(pick.size))
        return A.data
    if name == "grouped_bsr":
        G = tmf.choose_matrix_type("bsr").from_dense(dense, device=device,
                                                     block_shape=(4, 4)).grouped(2)
        return bsr_grouped_spmv_reference(G.gdata, G.gcols, G.grow, G._pad_x(X), G.nb_rows,
                                          G.nb_cols, G.block_shape, G.group)
    S = st.SymmetricPrunedDIAMatrix.from_coo(n, n, r, c, v, tile_rows=1024, device=device,
                                             dtype=torch.float32)
    if name == "pruned":
        return sp.pruned_matvec_reference(S.data, x, S.offsets, S.tile_ptr, n, n, group=S.group)
    return sp.pruned_sym_matvec_reference(S.data, x, S.offsets, S.tile_ptr, n, n, halo=S.halo,
                                          group=S.group)


def _card_block_terms(name, device):
    """The block products that a BSR or grouped-BSR site sums, computed on
    the card as the site computes them, with their targets and the number
    of target rows."""
    from sigma_tpu_torch.matrix import factory as tmf

    n, r, c, v = st.irregular_mesh_laplacian_coo(64, 32, rng=np.random.default_rng(0),
                                                 shift=1e-3, shuffle=True)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)
    X = torch.from_numpy(rng.standard_normal((n, 5)).astype(np.float32)).to(device)
    dense = np.zeros((n, n), dtype=np.float32)
    dense[r, c] = v
    A = tmf.choose_matrix_type("bsr").from_dense(dense, device=device, block_shape=(4, 4))
    g = A.graph
    if name == "grouped_bsr":
        G = A.grouped(2)
        bw, k = G.block_shape[1], X.shape[1]
        gath = G._pad_x(X).reshape(G.nb_cols, bw, k)[G.gcols.long()]
        terms = torch.einsum("ghc,gck->ghk", G.gdata,
                             gath.reshape(G.gdata.shape[0], G.group * bw, k))
        return terms, G.grow.long(), G.nb_rows
    Xk = X if name.endswith("mat") else x[:, None]
    if name.startswith("bsr_r"):
        Xp = A._padded(Xk, g.nb_rows * 4).reshape(g.nb_rows, 4, -1)
        terms = torch.bmm(A.data.transpose(1, 2), Xp[g.block_rows.clamp(max=g.nb_rows - 1)])
        return terms, g.indices, g.nb_cols
    terms = torch.bmm(A.data, A._padded_x(Xk).reshape(g.nb_cols, 4, -1)[g.indices])
    return terms, g.block_rows, g.nb_rows + 1


@pytest.mark.parametrize("site", ["ell_rmatvec", "ell_rmatmat", "bsr_matvec", "bsr_matmat",
                                  "bsr_rmatvec", "bsr_rmatmat", "dia_from_coo", "bsr_from_coo",
                                  "add_values", "grouped_bsr", "pruned", "pruned_sym"])
def test_fixed_order_sums_repeat_bit_for_bit(cuda, site):
    """Each site that summed with index_add_ gives the same bits on two
    calls on the card, and the CPU's sum.  The BSR products' block terms
    come from cuBLAS (bmm, einsum), whose last bits differ from the CPU's
    matrix products, so there the sum is held to the CPU ``index_add_`` of
    the card's own terms."""
    a, b = _sum_site(site, cuda), _sum_site(site, cuda)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    if site.startswith(("bsr_m", "bsr_r", "grouped")):
        terms, index, rows = _card_block_terms(site, cuda)
        want = torch.zeros((rows,) + tuple(terms.shape[1:])).index_add_(
            0, index.cpu(), terms.cpu())
        n = a.shape[0]
        want = want.reshape(-1, terms.shape[-1])[:n]
        assert torch.equal(a.cpu(), want if a.ndim == 2 else want[:, 0])
    else:
        assert torch.equal(a.cpu(), _sum_site(site, "cpu"))


def test_pruned_kernels_reject_what_they_do_not_take(cuda):
    rng = np.random.default_rng(12)
    P = _random_plan(rng, 2048, 2048, 100)
    d, o, tp = _on(cuda, P, torch.float64)
    with pytest.raises(TypeError, match="no pruned kernel"):
        sp.pruned_spmv(d, torch.zeros(2048, device=cuda), o, tp, 2048, 2048)
    with pytest.raises(ValueError, match="1 to 16"):
        sp.pruned_spmm(d, torch.zeros(2048, 17, dtype=torch.float64, device=cuda), o, tp, 2048, 2048, "cols")
    with pytest.raises(ValueError, match="tile_end"):
        sp.pruned_spmm(d, torch.zeros(2048, 4, dtype=torch.float64, device=cuda), o, tp, 2048,
                       2048, "cols", tile_end=tp[1:].cpu())
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
        v = rng.standard_normal(max(hi - lo, 0))
        if hi > lo:  # a diagonal past the matrix (|o| >= n) has no slots
            data[d, lo:hi] = v
    return torch.from_numpy(data).to(cuda, vdt), torch.tensor(offsets, device=cuda)


# the grouped kernel's routes for x: 100 scattered diagonals (each spread
# too wide for one shared-memory x window: the runs route), a band of 117
# with gaps (one window, with and without the register carry between
# consecutive offsets), bands of all-positive and of all-negative offsets,
# and a band of 301 (a span of 300 rows past the 296 the window holds
# beside a block's 256 rows, so it takes the runs route)
_WIDE = sorted(int(o) for o in np.random.default_rng(20).choice(np.arange(-3000, 3001), 100,
                                                                replace=False))
_GAPPED = sorted(set(range(-60, 61)) - {-7, 3, 4, 30})
_GROUPED_OFFSETS = {
    "scattered": _WIDE,
    "band_with_gaps": _GAPPED,
    "all_positive": list(range(1, 90)),
    "all_negative": list(range(-89, 0)),
    "past_the_window": list(range(-150, 151)),
}


# k: one column through the grouped entry, whole and partial register tiles
# (8 columns a thread in f32, 4 in f64) and one or more column groups
@pytest.mark.parametrize("k", [1, 17, 24, 32, 33, 48])
@pytest.mark.parametrize("layout", st.ops.GROUPED_LAYOUTS)
@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
@pytest.mark.parametrize("offsets", sorted(_GROUPED_OFFSETS))
def test_dia_spmm_grouped_kernel(cuda, pair, layout, k, offsets):
    vdt, xdt = pair
    rng = np.random.default_rng(21)
    n, m = 20_001, 25_000  # rectangular, not a multiple of a block's 256 rows
    data, offs = _band(cuda, rng, n, m, _GROUPED_OFFSETS[offsets], vdt)
    XT = torch.from_numpy(rng.standard_normal((k, m))).to(cuda, xdt)
    X = XT if layout == "rhs_major" else XT.T.contiguous()
    before = st.ops.dia_spmm_grouped.launches_by_layout[layout]
    Y = st.ops.dia_spmm_grouped(data, X, offs, n, m, layout)
    torch.cuda.synchronize()
    assert st.ops.dia_spmm_grouped.launches_by_layout[layout] == before + 1
    ref = st.ops.dia_spmm_grouped_reference(data, X, offs, n, m, layout)
    assert Y.dtype == xdt and Y.shape == ref.shape
    assert rel(Y, ref) <= _tol(xdt)


@pytest.mark.parametrize("layout", st.ops.GROUPED_LAYOUTS)
@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
def test_dia_spmm_grouped_kernel_without_diagonals(cuda, pair, layout):
    """D = 0: the kernel writes zeros over y (torch.empty), in both layouts
    and with a partial last block (n = 1,000)."""
    vdt, xdt = pair
    n, m, k = 1_000, 700, 40
    data = torch.empty((0, 1024), dtype=vdt, device=cuda)
    offs = torch.empty(0, dtype=torch.int64, device=cuda)
    X = torch.ones((k, m) if layout == "rhs_major" else (m, k), dtype=xdt, device=cuda)
    Y = st.ops.dia_spmm_grouped(data, X, offs, n, m, layout)
    torch.cuda.synchronize()
    assert Y.shape == ((k, n) if layout == "rhs_major" else (n, k))
    assert not Y.any()


# n = m: 20,001 (unaligned; x fits shared memory in f32 and f64), a
# multigrid level's 16,384 and 28,800 (the most f64 values the resident
# route takes), and fewer rows than one resident tile
@pytest.mark.parametrize("n", [20_001, 16_384, 28_800, 100])
@pytest.mark.parametrize("tile_rows", [32, 128, 256, 1024])
@pytest.mark.parametrize("offsets", [[-3000, -300, -1, 0, 1, 300, 3000], list(range(-122, 123)),
                                     [-9, -4, -1, 0, 1, 4, 9], [-301, -3, 0, 2, 5, 299]],
                         ids=["reach_past_a_tile", "band", "narrow_band", "misaligned_piece"])
@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
def test_staged_spmv_kernels(cuda, pair, offsets, tile_rows, n):
    """The resident and windowed kernels against the plain version; the
    windowed kernel (#1's row-tile body on its staged pieces, whose first
    columns lie off a 16-byte boundary for misaligned_piece) also bit for
    bit against dia_spmv (#1) on the same operands."""
    vdt, xdt = pair
    rng = np.random.default_rng(22)
    m = n
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
    assert torch.equal(y_win, dia_spmv(data, x, offs, n, m))


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


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 9, 11, 16])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("pair", sorted(st.ops.BSR_KERNEL_DTYPES, key=str), ids=str)
@pytest.mark.parametrize("shape,blk", [((500, 460), (8, 16)), ((260, 260), (4, 4)),
                                       ((301, 305), (3, 3)), ((520, 1000), (8, 128)),
                                       ((400, 700), (12, 64)), ((300, 330), (4, 33))])
def test_bsr_grouped_kernel(cuda, shape, blk, pair, group, k):
    """The grouped-BSR kernel against its plain version on the card, and
    the matrix assembled on the card against the one assembled on the CPU:
    shapes the blocks do not divide, empty block rows, rows of several
    groups, k past the 8 columns of one pass, and every form of the kernel
    in every dtype pair (bsr_grouped_form: wide groups, including 12-row
    blocks in two register passes; narrow ones in 16-byte pieces; group
    rows that are not 16-byte multiples, as (3, 3) blocks in groups of 1,
    (4, 4) bf16 blocks in groups of 1 and the odd bw of (4, 33)).  f64 and
    f32 accumulate in x's dtype; bf16 vectors in f32 with one rounding, so
    kernel and plain version may land one bf16 step (2^-7) apart."""
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
    # the C entry refuses a form whose loads the arrays do not allow (16-byte
    # pieces, narrow or wide, from gdata off a 16-byte boundary) and a form
    # code it does not know
    lib = st.ops._build.library()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    y = torch.empty((64, 2), dtype=torch.float64, device=cuda)
    store = torch.zeros(G.gdata.numel() + 1, dtype=torch.float64, device=cuda)
    for gdata, form in ((store[1:], 1), (store[1:], 2), (G.gdata, 3), (G.gdata, -1)):
        rc = lib.sigma_bsr_grouped_spmv(cuda.index or 0, 1, 1, gdata.data_ptr(),
                                        G.gcols.data_ptr(), G.gptr.data_ptr(), X.data_ptr(),
                                        y.data_ptr(), G.nb_rows, 4, 4, 4, 2, form, stream)
        assert rc != 0, form


@pytest.mark.parametrize("pair", sorted(st.ops.BSR_KERNEL_DTYPES, key=str), ids=str)
@pytest.mark.parametrize("blk,group", [((8, 128), 8), ((3, 3), 8), ((4, 4), 4)])
def test_bsr_grouped_kernel_unaligned_operands(cuda, blk, group, pair):
    """gdata and x off a 16-byte boundary (contiguous views one value into
    a larger store): the operator takes the one-value-a-load form, x is
    loaded value by value, and the products equal the aligned operator's
    within the dtype's tolerance."""
    vdt, xdt = pair
    rng = np.random.default_rng(16)
    n, m = 260, 1024
    dense = _block_dense(rng, n, m, blk[0])
    r, c = np.nonzero(dense)
    G = st.BSRMatrix.from_coo(n, m, r, c, dense[r, c], dtype=vdt, block_shape=blk).grouped(group)
    store = torch.zeros(G.gdata.numel() + 1, dtype=vdt, device=cuda)
    store[1:] = G.gdata.reshape(-1)
    off = st.GroupedBSR(store[1:].view(G.gdata.shape), G.gcols, G.grow, G.shape, G.block_shape,
                        G.group)
    assert off.form == "narrow_unaligned"
    for k in (1, 4, 8):
        X = torch.from_numpy(rng.standard_normal((m, k))).to(cuda, xdt)
        xs = torch.zeros(X.numel() + 1, dtype=xdt, device=cuda)
        xs[1:] = X.reshape(-1)
        Xo = xs[1:].view(m, k)
        ref = G.matmat(X)
        assert rel(off.matmat(Xo), ref) <= _BSR_TOL[xdt]
        assert rel(G.matmat(Xo), ref) <= _BSR_TOL[xdt]


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


def _dominant_dia(rng, n, offsets, shift=0.5):
    """A nonsymmetric, row-wise diagonally dominant DIA operator (f64)."""
    data = np.zeros((len(offsets), -(-n // 128) * 128))
    for d, o in enumerate(offsets):
        if o != 0:
            lo, hi = max(0, -o), min(n, n - o)
            data[d, lo:hi] = -rng.random(hi - lo)
    data[offsets.index(0), :n] = np.abs(data).sum(0)[:n] + shift
    nnz = int(np.count_nonzero(data))
    return st.DIAMatrix(graph=st.DIAGraph(offsets=tuple(offsets), shape=(n, n), nnz=nnz),
                        data=torch.from_numpy(data))


def _twice_on_card(run):
    """Two runs on the card: the same count and the same bits."""
    (x1, i1), (x2, i2) = run(), run()
    assert i1.iterations == i2.iterations and torch.equal(x1, x2)
    return x1, i1


def test_nonsymmetric_solvers_on_card_match_cpu(cuda):
    """GMRES(32) plain and with jacobi(), FGMRES with an inner 4-step
    BiCG-stab, and CGLS (rmatvec through the transposed layout) on a
    nonsymmetric DIA operator: equal iteration counts on the card and the
    CPU in f64, two card runs bit for bit equal."""
    A = st.advection_diffusion_dia(20, 10.0, torch.float64, device="cpu")
    Ag = A.to(cuda)
    b = torch.from_numpy(np.random.default_rng(7).standard_normal(A.shape[0]))
    bg = b.to(cuda)
    kw = dict(tol=0.0, rtol=1e-10, restart=32, maxiter=2000)
    for M, Mg in ((None, None), (st.jacobi().setup(A), st.jacobi().setup(Ag))):
        x_cpu, i_cpu = st.gmres_solve(A, b, M=M, **kw)
        x_gpu, i_gpu = _twice_on_card(lambda: st.gmres_solve(Ag, bg, M=Mg, **kw))
        assert i_gpu.converged and i_gpu.iterations == i_cpu.iterations > 32
        assert rel(x_gpu, x_cpu) <= 1e-9
    x_cpu, i_cpu = st.fgmres_solve(
        A, b, M=lambda v: st.bicgstab_solve(A, v, tol=0.0, rtol=0.0, maxiter=4)[0], **kw)
    x_gpu, i_gpu = _twice_on_card(lambda: st.fgmres_solve(
        Ag, bg, M=st.attach_solver(Ag, st.bicgstab(tolerance=0.0, maxiter=4)), **kw))
    assert i_gpu.converged and i_gpu.iterations == i_cpu.iterations
    assert rel(x_gpu, x_cpu) <= 1e-9
    C = _dominant_dia(np.random.default_rng(8), 50_000, [-300, -1, 0, 1, 300])
    Cg = C.to(cuda)
    c = torch.from_numpy(np.random.default_rng(9).standard_normal(50_000))
    x_cpu, i_cpu = st.cgls_solve(C, c, tol=0.0, rtol=1e-10)
    x_gpu, i_gpu = _twice_on_card(lambda: st.cgls_solve(Cg, c.to(cuda), tol=0.0, rtol=1e-10))
    assert i_gpu.converged and i_gpu.iterations == i_cpu.iterations
    assert rel(x_gpu, x_cpu) <= 1e-9


def test_minres_and_refinement_on_card_match_cpu(cuda):
    """MINRES + GMG on the Dirichlet Poisson stencil in symmetric storage
    and refined_solve with an f64 inner GMG-CG: equal counts on the card
    and the CPU in f64, two card runs bit for bit equal."""
    nx = 24
    A = st.SymmetricDIAMatrix.from_dia(st.laplacian_3d_dia(nx, torch.float64, diag=6.0, device="cpu"))
    M = st.structured_pair_amg(A, (nx, nx, nx), pairs_per_level=3, smoother="chebyshev",
                               n_smooth=4)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(A.shape[0]))
    Ag, Mg, bg = A.to(cuda), M.to(cuda), b.to(cuda)
    x_cpu, i_cpu = st.minres_solve(A, b, tol=0.0, rtol=1e-10, M=M)
    x_gpu, i_gpu = _twice_on_card(lambda: st.minres_solve(Ag, bg, tol=0.0, rtol=1e-10, M=Mg))
    assert i_gpu.converged and i_gpu.iterations == i_cpu.iterations
    assert rel(x_gpu, x_cpu) <= 1e-9
    kw = dict(tol=0.0, rtol=1e-12, inner_dtype=torch.float64, inner_tol=1e-4)
    x_cpu, i_cpu = st.refined_solve(A, b, A_lo=A, M_lo=M, **kw)
    x_gpu, i_gpu = _twice_on_card(lambda: st.refined_solve(Ag, bg, A_lo=Ag, M_lo=Mg, **kw))
    assert i_gpu.converged and i_gpu.iterations == i_cpu.iterations
    assert rel(x_gpu, x_cpu) <= 1e-9
