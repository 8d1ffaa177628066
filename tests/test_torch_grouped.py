"""The grouped wide-RHS SpMM (#9) and the staged-x SpMV entry (#5, #6) on
the CPU: their plain versions against the JAX package's Pallas kernels in
interpret mode, ``DIAMatrix``'s k > 16 routing against the JAX rule, the
products against JAX ``DIAMatrix.matmat``, and the routing of device
tensors to the kernels (stubbed: no card here)."""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu.ops.spmv_pallas as sp
from sigma_tpu.graph.graph import DIAGraph as JaxDIAGraph
from sigma_tpu.matrix.formats import DIAMatrix as JaxDIA
import sigma_tpu_torch as st
from sigma_tpu_torch import convert
from sigma_tpu_torch.matrix import formats
from sigma_tpu_torch.ops import spmm_dia, spmv_dia


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _band_data(rng, n, m, diags, dtype=np.float64):
    data = np.zeros((len(diags), -(-n // 128) * 128), dtype)
    for d, o in enumerate(diags):
        lo, hi = max(0, -o), min(n, m - o)
        data[d, lo:hi] = rng.standard_normal(max(hi - lo, 0))
    return data


def _wide_diags(rng, reach=300, count=60):
    return sorted({0} | {int(o) for o in rng.integers(1, reach, count)}
                  | {-int(o) for o in rng.integers(1, reach, count)})


def _tile_pick(S, hrows, D, isz, k=1):
    """The JAX tests' small tile pick, so a few thousand rows span tiles."""
    return 64, next(e for e in range(8, 65, 8) if e >= hrows and 64 % e == 0)


@pytest.mark.parametrize("n,diags,k,kb", [
    (6_000, [0, 1, -1, 300, -300], 40, 16),
    (5_999, [0, 5, -7, 999], 20, 8),
])
def test_grouped_plain_version_matches_the_jax_kernel(n, diags, k, kb, monkeypatch):
    """dia_spmm_grouped's plain version against the JAX package's
    ``dia_spmm_grouped`` in interpret mode (grouped-interleaved panels),
    f32 inputs, both port layouts."""
    monkeypatch.setattr(sp, "_spmm_tile_pick", _tile_pick)
    rng = np.random.default_rng(41)
    data = _band_data(rng, n, n, diags, np.float32)
    XT = rng.standard_normal((k, n)).astype(np.float32)
    XG = sp.interleave_panels_grouped(jnp.asarray(XT), kb, n)
    YG = sp.dia_spmm_grouped(jnp.asarray(data), XG, tuple(diags), n, n, interpret=True)
    want = np.asarray(sp.deinterleave_panels_grouped(YG, kb, k, n))
    offs = torch.tensor(diags)
    d, xt = torch.from_numpy(data), torch.from_numpy(XT)
    got = st.ops.dia_spmm_grouped(d, xt, offs, n, n, "rhs_major")
    assert rel(got, want) <= 1e-5  # f32 sums in another order
    got = st.ops.dia_spmm_grouped(d, xt.T.contiguous(), offs, n, n, "cols")
    assert rel(got.T, want) <= 1e-5


def test_grouped_plain_version_matches_the_jax_chunked_kernel(monkeypatch):
    """Against ``dia_spmm_grouped_chunked``: a band split into diagonal
    slabs, each slab's values streamed once for all k = KO * kb panels."""
    monkeypatch.setattr(sp, "_spmm_tile_pick",
                        lambda S, hrows, D, isz, k=1: _tile_pick(S, hrows, D, isz) if D <= 4 else None)
    rng = np.random.default_rng(43)
    n, k, kb = 6_000, 24, 8
    diags = sorted({0, 1, -1, 2, -2, 64, -64, 129, -129, 300, -300, 511})
    data = _band_data(rng, n, n, diags, np.float32)
    XT = rng.standard_normal((k, n)).astype(np.float32)
    assert len(sp.chunk_plan(tuple(diags), data.shape[1] // 128, 4, k=kb)) > 1
    XG = sp.interleave_panels_grouped(jnp.asarray(XT), kb, n)
    YG = sp.dia_spmm_grouped_chunked(jnp.asarray(data), XG, tuple(diags), n, n, interpret=True)
    want = np.asarray(sp.deinterleave_panels_grouped(YG, kb, k, n))
    got = st.ops.dia_spmm_grouped(torch.from_numpy(data), torch.from_numpy(XT),
                                  torch.tensor(diags), n, n, "rhs_major")
    assert rel(got, want) <= 1e-5


@pytest.mark.parametrize("k", [17, 24, 32, 40])
def test_wide_matmat_matches_the_jax_package(k):
    """DIAMatrix.matmat, rmatmat and matmat_rhs_major for k > 16 on a wide
    band (grouped route) and a narrow one (16-column passes), f64, against
    the JAX package's DIAMatrix (its XLA path on the CPU)."""
    rng = np.random.default_rng(45)
    n, m = 3_000, 2_900
    for diags in (_wide_diags(rng), [-40, -1, 0, 1, 40]):
        data = _band_data(rng, n, m, diags)
        A = convert.dia_from_arrays(diags, data, (n, m), device="cpu")
        nnz = A.nnz
        Aj = JaxDIA(graph=JaxDIAGraph(offsets=tuple(diags), shape=(n, m), nnz=nnz),
                    data=jnp.asarray(data.reshape(len(diags), -1, 128)))
        assert A.grouped_profitable(k) == (len(diags) > 10)
        X, Y = rng.standard_normal((m, k)), rng.standard_normal((n, k))
        assert rel(A.matmat(torch.from_numpy(X)), Aj.matmat(jnp.asarray(X))) <= 1e-12
        assert rel(A.rmatmat(torch.from_numpy(Y)), Aj.rmatmat(jnp.asarray(Y))) <= 1e-12
        XT = np.ascontiguousarray(X.T)
        assert rel(A.matmat_rhs_major(torch.from_numpy(XT)),
                   Aj.matmat_rhs_major(jnp.asarray(XT))) <= 1e-12


def _jax_takes_grouped(D, dtype, k):
    """Whether the JAX package's DIAMatrix routes a k-column product to its
    grouped kernel on a TPU (the backend mocked, the kernels stubbed)."""
    n = 70_000  # above the JAX package's 65,536-row gate
    offsets = tuple(range(-(D // 2), D - D // 2))
    A = JaxDIA.from_graph(
        JaxDIAGraph(offsets=offsets, shape=(n, n), nnz=n * D),
        jnp.zeros((D, -(-n // 128), 128), dtype),
    )
    stub = lambda data, XG, *a, **kw: XG  # noqa: E731
    with mock.patch.object(jax, "default_backend", lambda: "tpu"), \
            mock.patch.object(sp, "dia_spmm_grouped", stub), \
            mock.patch.object(sp, "dia_spmm_grouped_chunked", stub):
        return A._pallas_spmm_grouped(jnp.zeros((k, n), jnp.float32)) is not None


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_grouped_routing_matches_the_jax_rule(dtype):
    """The k > 16 routing decision equals the JAX package's on both sides
    of its boundary (passes - 1) * D * itemsize > 16 * k: 68-70
    diagonals at k = 17 in f32, 135-137 in bf16, and the 7-point stencil's
    7 diagonals at k = 32, never."""
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    isz = 4 if dtype == jnp.float32 else 2
    cases = [(D, k) for D in (7, 68 * 4 // isz, 68 * 4 // isz + 1, 70 * 4 // isz)
             for k in (16, 17, 32, 33)]
    for D, k in cases:
        want = _jax_takes_grouped(D, dtype, k)
        assert formats.grouped_profitable(k, D, isz) == want, (D, k)
        A = st.DIAMatrix(graph=st.DIAGraph.from_offsets(range(D), 1000, 1000),
                         data=torch.zeros((D, 1024), dtype=tdt))
        assert A.grouped_profitable(k) == want
    assert not formats.grouped_profitable(32, 7, 4)
    # f64 values, which the JAX kernels do not take, follow the same rule
    assert formats.grouped_profitable(17, 35, 8) and not formats.grouped_profitable(17, 34, 8)


def test_routes_follow_the_device(monkeypatch):
    """On a device tensor (``meta`` stands in for CUDA) a wide band's
    k = 24 matmat and k = 32 matmat_rhs_major launch the grouped kernel once
    each, in the column and RHS-major layouts; the stencil's k = 32 runs two
    16-column launches; dia_spmv_staged launches the resident kernel, the
    windowed kernel or dia_spmv by its route.  The plain versions are never
    called."""
    launched = []

    def fake_launch(entry, data, x, offsets, shape, n, *extra):
        assert data.device == x.device == offsets.device
        launched.append(entry)
        return torch.empty(shape, dtype=x.dtype, device=x.device)

    def no_plain(*args, **kw):
        raise AssertionError("plain version called for a device tensor")

    for mod in (spmm_dia, spmv_dia):
        monkeypatch.setattr(mod, "_launch", fake_launch)
    for name in ("dia_spmm_reference", "dia_spmm_grouped_reference"):
        monkeypatch.setattr(spmm_dia, name, no_plain)
    monkeypatch.setattr(spmv_dia, "dia_spmv_reference", no_plain)
    rng = np.random.default_rng(47)
    n = 2_000
    wide = _wide_diags(rng, count=150)  # > 128 diagonals: k = 32 in f32 takes the grouped route
    A = convert.dia_from_arrays(wide, _band_data(rng, n, n, wide, np.float32), (n, n),
                                   device="meta")
    before = dict(spmm_dia.dia_spmm_grouped.launches_by_layout)
    assert A.matmat(torch.empty((n, 24), device="meta")).shape == (n, 24)
    assert A.matmat_rhs_major(torch.empty((32, n), device="meta")).shape == (32, n)
    after = spmm_dia.dia_spmm_grouped.launches_by_layout
    assert {k: after[k] - before[k] for k in after} == {"rhs_major": 1, "cols": 1}
    S = st.laplacian_3d_dia(8, torch.float32, device="cpu").to("meta")
    S.matmat(torch.empty((512, 32), device="meta"))
    assert launched == ["sigma_dia_spmm_grouped"] * 2 + ["sigma_dia_spmm"] * 2
    x = torch.empty(n, device="meta")
    launched.clear()
    spmv_dia.dia_spmv_staged(A.data, x, wide, n, n)
    big = 60_000
    Ab = convert.dia_from_arrays([-1, 0, 1], np.zeros((3, -(-big // 128) * 128)), (big, big),
                                 device="meta")
    xb = torch.empty(big, dtype=torch.float64, device="meta")
    spmv_dia.dia_spmv_staged(Ab.data, xb, [-1, 0, 1], big, big)
    spmv_dia.dia_spmv_staged(Ab.data, xb, [-1, 0, 1], big, big, allow_dma_path=True)
    assert launched == ["sigma_dia_spmv_resident", "sigma_dia_spmv", "sigma_dia_spmv_window"]


def _jax_dia_spmv_pallas(dA, x, allow_dma_path, monkeypatch):
    A = JaxDIA.from_dense(dA)
    if allow_dma_path:
        monkeypatch.setattr(sp, "_MAX_X_ELEMS", 1)  # force the manual-DMA body
    n = dA.shape[0]
    return np.asarray(sp.dia_spmv_pallas(A.data.astype(jnp.float32), jnp.asarray(x),
                                         A.graph.offsets, n, n, interpret=True,
                                         allow_dma_path=allow_dma_path)), A.graph.offsets


@pytest.mark.parametrize("allow_dma_path", [False, True], ids=["resident", "dma"])
def test_staged_spmv_matches_the_jax_kernel(allow_dma_path, monkeypatch):
    """dia_spmv_staged (its plain route on the CPU) against the JAX
    package's dia_spmv_pallas in interpret mode, on the VMEM-resident body
    and on the manual-DMA body (as tests/test_pallas.py runs them)."""
    n = 1_500
    rng = np.random.default_rng(5)
    dA = (np.diag(rng.standard_normal(n)) + np.diag(rng.standard_normal(n - 1), 1)
          + np.diag(rng.standard_normal(n - 300), -300))
    x = rng.standard_normal(n).astype(np.float32)
    want, offsets = _jax_dia_spmv_pallas(dA, x, allow_dma_path, monkeypatch)
    A = st.DIAMatrix.from_dense(dA.astype(np.float32), device="cpu")
    assert A.offsets == offsets
    got = st.ops.dia_spmv_staged(A.data, torch.from_numpy(x), offsets, n, n,
                                 allow_dma_path=allow_dma_path)
    assert rel(got, want) <= 1e-6  # f32 sums in another order
    assert rel(st.ops.dia_spmv_window(A.data, torch.from_numpy(x), offsets, n, n, 64),
               want) <= 1e-6


def test_staged_route_and_window_plan():
    """The resident gate (x of 57,600 f32 or 28,800 f64 values), and the
    window plan: the union of the per-diagonal windows of a tile, each
    diagonal's window inside it, the stencil's offsets in 3 pieces at 256
    rows and 5 at 128, the band's in one of 256 + 244."""
    assert st.ops.STAGED_SMEM_BYTES == 230_400
    assert st.ops.staged_route(57_600, 4) == "resident"
    assert st.ops.staged_route(57_601, 4) == "blocked"
    assert st.ops.staged_route(57_601, 4, allow_dma_path=True) == "window"
    assert st.ops.staged_route(28_800, 8) == "resident" != st.ops.staged_route(28_801, 8)
    stencil = [-46_656, -216, -1, 0, 1, 216, 46_656]
    for T, pieces, length in ((256, 3, 1_200), (128, 5, 642)):
        starts, bases, pos = st.ops.window_plan(stencil, T)
        assert starts.size == pieces and bases[-1] == length
        for o, p in zip(stencil, pos):  # diagonal o's window [o, o + T) is staged contiguously
            piece = np.searchsorted(bases, p, side="right") - 1
            assert starts[piece] <= o and p + T <= bases[piece + 1]
            assert p - bases[piece] == o - starts[piece]
    starts, bases, pos = st.ops.window_plan(list(range(-122, 123)), 256)
    assert starts.tolist() == [-122] and bases.tolist() == [0, 500]
    assert pos.tolist() == list(range(245))
    # any order of offsets, pos in that order
    starts, bases, pos = st.ops.window_plan([5, -5, 0], 4)
    assert starts.tolist() == [-5, 0, 5] and pos.tolist() == [8, 0, 4]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("tile_rows", [32, 128, 256, 1024])
@pytest.mark.parametrize(
    "offsets",
    [[-46_656, -216, -1, 0, 1, 216, 46_656], list(range(-122, 123)),
     [-301, -3, 0, 2, 5, 299], [7, -5, 0, 3_001], [-20_003, -1, 0, 1, 20_005],
     [3_000 * j + 1 for j in range(-15, 16)]],
    ids=["stencil", "band", "misaligned", "unsorted", "far", "scattered"])
def test_aligned_window_plan(offsets, tile_rows, itemsize):
    """The windowed kernel's layout (window_plan with align = 16 bytes over
    x's item size): every diagonal's window lies inside its piece, every
    start and base is a multiple of P, so column c of a tile starting at a
    multiple of P sits at an index congruent to c mod P; the pieces do not
    overlap, and the length with its padding is what the wrapper holds to
    STAGED_SMEM_BYTES.  The default layout is the plain union, pinned above."""
    P = 16 // itemsize
    starts, bases, pos = st.ops.window_plan(offsets, tile_rows, align=P)
    assert (starts % P == 0).all() and (bases % P == 0).all() and bases[0] == 0
    lengths = np.diff(bases)
    assert (lengths > 0).all() and (starts[1:] > starts[:-1] + lengths[:-1]).all()
    plain = st.ops.window_plan(offsets, tile_rows)
    assert bases[-1] >= plain[1][-1] and bases[-1] <= plain[1][-1] + 2 * (P - 1) * starts.size
    i0 = 5 * 1024  # a tile's first row: a multiple of every tile_rows and P
    for o, p in zip(offsets, pos):
        piece = np.searchsorted(bases, p, side="right") - 1
        # columns i0 + o .. i0 + o + tile_rows - 1 at pos .. pos + tile_rows - 1
        assert starts[piece] <= o and p + tile_rows <= bases[piece + 1]
        assert p - bases[piece] == o - starts[piece]
        assert (p - (i0 + o)) % P == 0
    length = int(bases[-1])
    fits = length * itemsize <= st.ops.STAGED_SMEM_BYTES
    x = torch.zeros(10, dtype=torch.float32 if itemsize == 4 else torch.float64)
    data = torch.zeros((len(offsets), 128), dtype=x.dtype)
    if fits:
        assert st.ops.dia_spmv_window(data, x, offsets, 10, 10, tile_rows).shape == (10,)
    else:
        with pytest.raises(ValueError, match="does not fit"):
            st.ops.dia_spmv_window(data, x, offsets, 10, 10, tile_rows)
