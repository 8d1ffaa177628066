"""The port's pruned block-DIA storage held against the JAX package: the plan
(bitwise, after the documented mapping), the plain versions of the four
pruned kernels against the JAX kernels in interpret mode (f32), and every
matrix method against the JAX package's ``PrunedDIAMatrix`` in f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigma_tpu.matrix.formats import DIAMatrix as JaxDIA
from sigma_tpu.matrix.pruned import PrunedDIAMatrix as JaxPruned
from sigma_tpu.matrix.pruned import SymmetricPrunedDIAMatrix as JaxSymPruned
from sigma_tpu.ops import spmv_pruned as jsp
import sigma_tpu_torch as st
from sigma_tpu_torch import convert, native
from sigma_tpu_torch.ops import spmv_pruned as sp


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def random_banded(rng, n, m, nnz, band=120, outliers=20, lo=None):
    """Random banded triples with a few far outliers (tests/test_pruned.py's
    generator), duplicate-free, and their dense mirror."""
    rows = rng.integers(0, n, nnz)
    cols = np.clip(rows + rng.integers(-band if lo is None else lo, band + 1, nnz), 0, m - 1)
    if outliers:
        cols[:outliers] = rng.integers(0, m, outliers)
    vals = rng.standard_normal(nnz)
    _, idx = np.unique(rows * m + cols, return_index=True)
    rows, cols, vals = rows[idx], cols[idx], vals[idx]
    dense = np.zeros((n, m))
    dense[rows, cols] = vals
    return rows, cols, vals, dense


def random_symmetric(rng, n, nnz, band=150):
    r, c, v, _ = random_banded(rng, n, n, nnz, band=band, outliers=0)
    up = c > r
    d = np.arange(n)
    rows = np.concatenate([r[up], c[up], d])
    cols = np.concatenate([c[up], r[up], d])
    vals = np.concatenate([v[up], v[up], 4.0 + rng.random(n)])
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    return rows, cols, vals, dense


def jax_layout(J):
    """The JAX package's plan arrays in the port's layout."""
    TR = J.T * 128
    G = -(-(-(-J.n // 128)) // J.T)
    offsets = (J.rowoff.astype(np.int64) - J.E) * 128 + J.laneoff
    tile_ptr = np.concatenate([[0], np.cumsum(np.bincount(J.tile, minlength=G) * J.C)])
    return np.asarray(J.data).reshape(-1, TR), offsets, tile_ptr


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plan_matches_jax_bitwise(dtype):
    """f32 goes through the JAX package's C++ pack, f64 through its numpy
    pack; the port's C++ pack and its numpy form give the same layout."""
    rng = np.random.default_rng(0)
    n, m = 3100, 3333
    r, c, v, _ = random_banded(rng, n, m, 20000)
    r, c, v = np.r_[r, r[:40]], np.r_[c, c[:40]], np.r_[v, v[:40] + 1.0]  # last value wins
    J = jsp.build_pruned_plan(n, m, r, c, v, tile_rows=1024, group=4, dtype=dtype)
    jdata, joff, jptr = jax_layout(J)
    for build in (sp.build_pruned_plan, sp.build_pruned_plan_reference):
        P = build(n, m, r, c, v, tile_rows=1024, group=4, dtype=dtype)
        assert (P.tile_rows, P.halo, P.group, P.n_steps) == (J.T * 128, J.E, J.C, J.L)
        assert P.data.dtype == jdata.dtype and np.array_equal(P.data, jdata)
        assert np.array_equal(P.offsets, joff) and np.array_equal(P.tile_ptr, jptr)
        assert P.n_slots_active == J.n_slots_active


def test_plan_widens_the_tile_for_a_wide_reach():
    rng = np.random.default_rng(1)
    n = 6000
    r, c, v, _ = random_banded(rng, n, n, 20000, band=1500, outliers=0)
    J = jsp.build_pruned_plan(n, n, r, c, v, tile_rows=1024, group=8, dtype=np.float64)
    P = sp.build_pruned_plan(n, n, r, c, v, tile_rows=1024, group=8, dtype=np.float64)
    assert P.tile_rows == J.T * 128 > 1024 and P.halo == J.E
    assert P.halo * 128 > int(np.abs(c - r).max())


@pytest.mark.parametrize("shape", [(3100, 3100), (2500, 3333), (3333, 2500)])
def test_full_products_match_jax_f64(shape):
    rng = np.random.default_rng(2)
    n, m = shape
    r, c, v, dense = random_banded(rng, n, m, 16000, band=300)
    Aj = JaxPruned.from_coo(n, m, r, c, v, tile_rows=1024, group=3)
    At = st.PrunedDIAMatrix.from_coo(n, m, r, c, v, tile_rows=1024, group=3, device="cpu")
    assert At.stored_slots == Aj.stored_slots and At.nnz == Aj.nnz
    assert At.dtype == torch.float64
    x = rng.standard_normal(m)
    z = rng.standard_normal(n)
    assert rel(At.matvec(torch.from_numpy(x)), np.asarray(Aj.matvec(jnp.asarray(x)))) <= 1e-12
    assert rel(At.rmatvec(torch.from_numpy(z)), np.asarray(Aj.rmatvec(jnp.asarray(z)))) <= 1e-12
    for k in (1, 3, 8, 17):
        X = rng.standard_normal((m, k))
        Y = At.matmat(torch.from_numpy(X))
        assert Y.shape == (n, k)
        assert rel(Y, np.asarray(Aj.matmat(jnp.asarray(X)))) <= 1e-12
        assert rel(Y, dense @ X) <= 1e-12
        YT = At.matmat_rhs_major(torch.from_numpy(X.T.copy()))
        assert rel(YT, np.asarray(Aj.matmat_rhs_major(jnp.asarray(X.T)))) <= 1e-12
    Z = rng.standard_normal((n, 5))
    assert rel(At.rmatmat(torch.from_numpy(Z)), dense.T @ Z) <= 1e-12


def test_symmetric_products_match_jax_f64():
    rng = np.random.default_rng(3)
    n = 3300
    r, c, v, dense = random_symmetric(rng, n, 20000)
    Aj = JaxSymPruned.from_coo(n, n, r, c, v, tile_rows=1024)
    At = st.SymmetricPrunedDIAMatrix.from_coo(n, n, r, c, v, tile_rows=1024, device="cpu")
    assert At.stored_slots == Aj.stored_slots and At.nnz == Aj.nnz == np.count_nonzero(dense)
    assert (At.stored_upper, At.n_diag_entries) == (Aj.stored_upper, Aj.n_diag_entries)
    x = rng.standard_normal(n)
    y = At.matvec(torch.from_numpy(x))
    assert rel(y, np.asarray(Aj.matvec(jnp.asarray(x)))) <= 1e-12
    assert rel(y, dense @ x) <= 1e-12
    assert torch.equal(At.rmatvec(torch.from_numpy(x)), y)
    for k in (1, 3, 8, 17):
        X = rng.standard_normal((n, k))
        Y = At.matmat(torch.from_numpy(X))
        assert rel(Y, np.asarray(Aj.matmat(jnp.asarray(X)))) <= 1e-12
        YT = At.matmat_rhs_major(torch.from_numpy(X.T.copy()))
        assert rel(YT, np.asarray(Aj.matmat_rhs_major(jnp.asarray(X.T)))) <= 1e-12
    assert At.transpose() is At
    with pytest.raises(ValueError, match="not symmetric"):
        st.SymmetricPrunedDIAMatrix.from_coo(n, n, r, c, v + (r > c), device="cpu")
    Sf = st.SymmetricPrunedDIAMatrix.from_pruned(
        st.PrunedDIAMatrix.from_coo(n, n, r, c, v, tile_rows=1024, device="cpu")
    )
    assert Sf.group == 12 and rel(Sf.matvec(torch.from_numpy(x)), dense @ x) <= 1e-12


def _jax_arrays(J):
    return dict(
        data=jnp.asarray(J.data.reshape(J.L, J.C, J.T, 128)), tile=jnp.asarray(J.tile),
        first=jnp.asarray(J.first), rowoff=jnp.asarray(J.rowoff),
        laneoff=jnp.asarray(J.laneoff),
    )


def _port_arrays(J):
    data, offsets, tile_ptr = jax_layout(J)
    return torch.from_numpy(np.array(data)), torch.from_numpy(offsets), torch.from_numpy(tile_ptr)


# -- the plain versions against the JAX kernels (interpret mode, f32) --------
@pytest.mark.parametrize("kernel", ["spmv", "spmm_k3", "sym_spmv", "sym_spmm_k3"])
def test_plain_versions_match_jax_kernels_f32(kernel):
    rng = np.random.default_rng(4)
    n = 2600
    if kernel.startswith("sym"):
        r, c, v, _ = random_symmetric(rng, n, 12000, band=200)
        up = c >= r
        r, c, v = r[up], c[up], v[up]
    else:
        r, c, v, _ = random_banded(rng, n, n, 16000, band=200, outliers=0)
    J = jsp.build_pruned_plan(n, n, r, c, v.astype(np.float32), tile_rows=1024, group=4)
    ja = _jax_arrays(J)
    kw = dict(T=J.T, E=J.E, C=J.C, n=n, m=n, interpret=True)
    data, offs, tptr = _port_arrays(J)
    if kernel.endswith("k3"):
        XT = rng.standard_normal((3, n)).astype(np.float32)
        if kernel.startswith("sym"):
            Yj, Sj = jsp.dia_sym_spmm_pruned_rhs_major(ja["data"], jnp.asarray(XT), ja["tile"],
                                                       ja["first"], ja["rowoff"], ja["laneoff"], **kw)
            Yt, St = sp.pruned_sym_spmm(data, torch.from_numpy(XT), offs, tptr, n, n,
                                        "rhs_major", halo=J.E, with_spill=True)
            assert St.shape == (3, J.E * 128) and float(St.abs().max()) == 0.0
            assert float(np.abs(np.asarray(Sj)).max()) == 0.0
        else:
            Yj = jsp.dia_spmm_pruned_rhs_major(ja["data"], jnp.asarray(XT), ja["tile"],
                                               ja["first"], ja["rowoff"], ja["laneoff"], **kw)
            Yt = sp.pruned_spmm(data, torch.from_numpy(XT), offs, tptr, n, n, "rhs_major")
    else:
        x = rng.standard_normal(n).astype(np.float32)
        if kernel.startswith("sym"):
            Yj, _ = jsp.dia_sym_spmv_pallas_pruned(ja["data"], jnp.asarray(x), ja["tile"],
                                                   ja["first"], ja["rowoff"], ja["laneoff"], **kw)
            Yt = sp.pruned_sym_spmv(data, torch.from_numpy(x), offs, tptr, n, n, halo=J.E)
        else:
            Yj = jsp.dia_spmv_pallas_pruned(ja["data"], jnp.asarray(x), ja["tile"], ja["first"],
                                            ja["rowoff"], ja["laneoff"], **kw)
            Yt = sp.pruned_spmv(data, torch.from_numpy(x), offs, tptr, n, n)
    assert Yt.dtype == torch.float32 and tuple(Yt.shape) == tuple(np.shape(Yj))
    assert rel(Yt, np.asarray(Yj)) <= 1e-5


def test_sym_shift_spill_matches_jax_reference():
    """A rectangular block of a distributed layout: columns shifted by
    sym_shift, n a multiple of the tile, the mirror rows past n returned
    as the spill."""
    rng = np.random.default_rng(5)
    n, m, shift = 2048, 2048 + 512, 128
    r, c, v, _ = random_banded(rng, n, m, 9000, band=shift + 300, outliers=0, lo=shift)
    J = jsp.build_pruned_plan(n, m, r, c, v, tile_rows=1024, group=3, dtype=np.float64)
    ja = _jax_arrays(J)
    x = rng.standard_normal(m)
    yj, sj = jsp.pruned_sym_matvec_reference(
        ja["data"], jnp.asarray(x), ja["tile"], ja["rowoff"], ja["laneoff"], T=J.T, E=J.E,
        C=J.C, n=n, m=m, sym_shift=shift, with_spill=True,
    )
    assert float(np.abs(np.asarray(sj)).max()) > 0  # the spill is exercised
    data, offs, tptr = _port_arrays(J)
    yt, st_ = sp.pruned_sym_spmv(data, torch.from_numpy(x), offs, tptr, n, m, halo=J.E,
                                 sym_shift=shift, with_spill=True)
    assert rel(yt, np.asarray(yj)) <= 1e-12 and rel(st_, np.asarray(sj)) <= 1e-12
    X = rng.standard_normal((m, 3))
    Yt, St = sp.pruned_sym_spmm(data, torch.from_numpy(X), offs, tptr, n, m, "cols",
                                halo=J.E, sym_shift=shift, with_spill=True)
    for j in range(3):
        yj, sj = jsp.pruned_sym_matvec_reference(
            ja["data"], jnp.asarray(X[:, j]), ja["tile"], ja["rowoff"], ja["laneoff"], T=J.T,
            E=J.E, C=J.C, n=n, m=m, sym_shift=shift, with_spill=True,
        )
        assert rel(Yt[:, j], np.asarray(yj)) <= 1e-12 and rel(St[:, j], np.asarray(sj)) <= 1e-12
    with pytest.raises(ValueError, match="multiple of the tile"):
        sp.pruned_sym_spmv(data, torch.from_numpy(x), offs, tptr, n - 48, m, halo=J.E)


def test_entries_dense_transpose_from_dia_astype():
    rng = np.random.default_rng(6)
    n, m = 1500, 1400
    r, c, v, dense = random_banded(rng, n, m, 8000)
    A = st.PrunedDIAMatrix.from_coo(n, m, r, c, v, tile_rows=1024, group=2, device="cpu")
    assert np.array_equal(A.to_dense(), dense)
    assert np.array_equal(A.transpose().to_dense(), dense.T)
    assert A.with_transpose().t is not None
    i, j = int(r[0]), int(c[0])
    assert A.get_value(i, j) == dense[i, j]
    # duplicates: the last value wins
    B = st.PrunedDIAMatrix.from_coo(100, 100, [5, 5], [7, 7], [1.0, 2.0], device="cpu")
    assert B.get_value(5, 7) == 2.0 and B.nnz == 1
    # from_dia drops the band's structural zeros, as the JAX package's
    D = st.DIAMatrix.from_coo(n, m, r, c, v, dtype=torch.float64, device="cpu")
    P = st.PrunedDIAMatrix.from_dia(D, tile_rows=1024, group=4)
    Pj = JaxPruned.from_dia(JaxDIA.from_coo(n, m, r, c, v, dtype=jnp.float64),
                            tile_rows=1024, group=4)
    assert P.stored_slots == Pj.stored_slots and P.nnz == Pj.nnz
    assert np.array_equal(P.to_dense(), dense)
    Ab = A.astype(torch.bfloat16)
    assert Ab.dtype == torch.bfloat16 and Ab.stored_slots == A.stored_slots
    x = torch.from_numpy(rng.standard_normal(m)).float()
    yb = Ab.matvec(x)
    assert yb.dtype == torch.float32
    dense_b = torch.from_numpy(dense).bfloat16().double().numpy()
    assert rel(yb, dense_b @ x.double().numpy()) <= 1e-5
    assert st.PrunedDIAMatrix.from_coo(n, m, r, c, v, dtype=torch.bfloat16,
                                       device="cpu").group == 16


def test_pruned_from_arrays_carries_the_jax_plan():
    rng = np.random.default_rng(7)
    n = 3000
    r, c, v, dense = random_symmetric(rng, n, 15000)
    for Aj in (JaxPruned.from_coo(n, n, r, c, v, tile_rows=1024, group=5),
               JaxSymPruned.from_coo(n, n, r, c, v, tile_rows=1024)):
        sym = isinstance(Aj, JaxSymPruned)
        A = convert.pruned_from_arrays(
            np.asarray(Aj.data), np.asarray(Aj.tile), np.asarray(Aj.first),
            np.asarray(Aj.rowoff), np.asarray(Aj.laneoff), Aj.n, Aj.m, Aj.halo, Aj.nnz,
            symmetric=sym, device="cpu",
        )
        assert isinstance(A, st.SymmetricPrunedDIAMatrix) == sym
        x = rng.standard_normal(n)
        assert rel(A.matvec(torch.from_numpy(x)), np.asarray(Aj.matvec(jnp.asarray(x)))) <= 1e-12
        assert A.stored_slots == Aj.stored_slots and A.group == Aj.group


def _recount_ends(n, rows, cols, tile_rows, tile_ptr):
    """Each tile's first slot plus its number of distinct (tile, offset)
    pairs, counted from the triples."""
    G = tile_ptr.size - 1
    tile = rows // tile_rows
    pairs = np.unique(tile * (4 * n + 1) + (cols - rows + 2 * n))
    return tile_ptr[:-1] + np.bincount(pairs // (4 * n + 1), minlength=G)


@pytest.mark.parametrize("case", ["full", "full_negative_only", "sym", "sym_shift"])
def test_active_tile_ends_match_a_recount_of_the_plan(case):
    """The per-tile end of the active slots, from the host pack, its numpy
    form, the matrix classes and a plan carried across from the JAX
    package, against a count of the (tile, offset) pairs of the triples.
    The plans have tiles with no pair (one padding step only) and tiles
    whose last active offset is negative (the first padding slot follows
    in ascending order)."""
    rng = np.random.default_rng(13)
    n, m, T = 6000, 6000, 1024
    if case.startswith("sym"):
        shift = 128 if case == "sym_shift" else 0
        m = n + 512 if shift else n
        r, c, v, _ = random_banded(rng, n, m, 9000, band=shift + 200, outliers=0, lo=shift)
    else:
        r, c, v, _ = random_banded(rng, n, m, 9000, band=200, outliers=0,
                                   lo=None if case == "full" else 200)
        if case == "full_negative_only":
            keep = c < r
            r, c, v = r[keep], c[keep], v[keep]
    # empty tiles 2 and 4
    keep = (r // T != 2) & (r // T != 4)
    r, c, v = r[keep], c[keep], v[keep]
    for build in (sp.build_pruned_plan, sp.build_pruned_plan_reference):
        P = build(n, m, r, c, v, tile_rows=T, group=5, dtype=np.float64)
        want = _recount_ends(n, r, c, P.tile_rows, P.tile_ptr)
        assert want[2] == P.tile_ptr[2] and want[4] == P.tile_ptr[4]
        assert np.array_equal(P.tile_end, want)
        assert int((P.tile_end - P.tile_ptr[:-1]).sum()) == P.n_slots_active
    A = st.PrunedDIAMatrix.from_coo(n, m, r, c, v, tile_rows=T, group=5, device="cpu")
    assert np.array_equal(A.tile_end.numpy(), want)
    assert np.array_equal(A.astype(torch.bfloat16).tile_end.numpy(), want)
    J = jsp.build_pruned_plan(n, m, r, c, v, tile_rows=T, group=5, dtype=np.float64)
    C = convert.pruned_from_arrays(J.data.reshape(J.L, J.C, J.T, 128), J.tile, J.first,
                                   J.rowoff, J.laneoff, n, m, J.E, r.size, device="cpu")
    assert np.array_equal(C.tile_ptr.numpy(), P.tile_ptr)
    assert np.array_equal(C.tile_end.numpy(), want)
    # the ends only drop padding: the product is unchanged
    x = torch.from_numpy(rng.standard_normal(m))
    y = sp.pruned_spmv(A.data, x, A.offsets, A.tile_ptr, n, m, group=5, tile_end=A.tile_end)
    assert torch.equal(y, A.matvec(x))
    with pytest.raises(ValueError, match="tile_end must be int64"):
        sp.pruned_spmv(A.data, x, A.offsets, A.tile_ptr, n, m, tile_end=A.tile_end[1:])


def test_host_library_is_built_once_and_raises_without_a_compiler(monkeypatch, tmp_path):
    path = native.build()
    assert path.exists() and native.build() == path
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        native.build()


def test_cpu_routing_launches_no_kernel_and_device_tensors_go_to_the_kernel(monkeypatch):
    rng = np.random.default_rng(8)
    n = 2100
    r, c, v, dense = random_symmetric(rng, n, 9000)
    kernels = (sp.pruned_spmv, sp.pruned_spmm, sp.pruned_sym_spmv, sp.pruned_sym_spmm)
    before = [f.launches for f in kernels]
    A = st.PrunedDIAMatrix.from_coo(n, n, r, c, v, tile_rows=1024, device="cpu")
    S = st.SymmetricPrunedDIAMatrix.from_coo(n, n, r, c, v, tile_rows=1024, device="cpu")
    x = torch.from_numpy(rng.standard_normal(n))
    X = torch.from_numpy(rng.standard_normal((n, 4)))
    for M in (A, S):
        assert rel(M.matvec(x), dense @ x.numpy()) <= 1e-12
        assert rel(M.matmat(X), dense @ X.numpy()) <= 1e-12
    assert [f.launches for f in kernels] == before

    launched = []

    def fake_launch(entry, data, X, offsets, tile_ptr, outs, *sizes, tile_end=None):
        assert data.device == X.device == offsets.device == tile_ptr.device
        # the SpMV kernels get the matrix's active tile ends, the SpMMs none
        assert (tile_end is None) == entry.endswith("spmm")
        assert tile_end is None or tile_end.device == X.device
        launched.append(entry)

    def no_plain(*args, **kw):
        raise AssertionError("plain version called for a device tensor")

    monkeypatch.setattr(sp, "_launch", fake_launch)
    for name in ("pruned_matvec_reference", "pruned_sym_matvec_reference",
                 "pruned_spmm_reference", "pruned_sym_spmm_reference"):
        monkeypatch.setattr(sp, name, no_plain)
    xm, Xm = x.float().to("meta"), X.float().to("meta")
    Am, Sm = A.astype(torch.bfloat16).to("meta"), S.to("meta")
    assert Am.matvec(xm).device.type == "meta" and Am.matmat(Xm).shape == (n, 4)
    assert Sm.matvec(xm.double()).shape == (n,) and Sm.matmat(Xm.double()).shape == (n, 4)
    assert launched == ["sigma_pruned_spmv", "sigma_pruned_spmm", "sigma_pruned_sym_spmv",
                        "sigma_pruned_sym_spmm"]
    assert [f.launches - b for f, b in zip(kernels, before)] == [1, 1, 1, 1]


def test_pruned_spmm_counts_launches_by_layout(monkeypatch):
    """A contiguous (n, k) block goes to the kernels as column panels, a
    column-major one (a QR factor, ``XT.T``) as RHS-major panels; each
    launch is counted under its layout."""
    rng = np.random.default_rng(9)
    n = 2100
    r, c, v, _ = random_symmetric(rng, n, 9000)
    A = st.PrunedDIAMatrix.from_coo(n, n, r, c, v, tile_rows=1024, device="cpu").to("meta")
    S = st.SymmetricPrunedDIAMatrix.from_coo(n, n, r, c, v, tile_rows=1024, device="cpu").to("meta")
    monkeypatch.setattr(sp, "_launch", lambda *args: None)
    cols = torch.empty((n, 4), dtype=torch.float64, device="meta")
    rhs_major = torch.empty((4, n), dtype=torch.float64, device="meta").T
    for M, fn in ((A, sp.pruned_spmm), (S, sp.pruned_sym_spmm)):
        before = dict(fn.launches_by_layout)
        for X, times in ((cols, 2), (rhs_major, 1)):
            for _ in range(times):
                assert M.matmat(X).shape == (n, 4)
        assert {k: fn.launches_by_layout[k] - before[k] for k in before} == {
            "rhs_major": 1, "cols": 2}
