"""The port's general formats and mutable matrix API against the JAX
package, on the CPU in float64: CSC and ELL graphs and their four products,
the ``SparseMatrix`` accessors and functional mutators on every format,
the graph builder and the format factories.

The same numpy inputs go to both packages.  Index arrays and value reads
agree exactly (the JAX package's padding past ``nnz`` cut off); products
agree to 1e-12 relative (a few terms summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu as sj
import sigma_tpu_torch as st
from sigma_tpu.graph import GraphBuilder as JGraphBuilder
from sigma_tpu.graph import factory as jgf
from sigma_tpu.matrix import factory as jmf
from sigma_tpu_torch.graph import factory as tgf
from sigma_tpu_torch.matrix import factory as tmf
from sigma_tpu_torch.utils import ordered_sum

torch.set_num_threads(1)

TOL = 1e-12
FORMATS = ["coo", "csr", "csc", "ell", "bsr", "dia"]


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def random_dense(seed, n, m, p=0.12):
    rng = np.random.default_rng(seed)
    d = np.where(rng.random((n, m)) < p, rng.standard_normal((n, m)), 0.0)
    d[n // 2] = 0.0  # an empty row
    return d


def banded_dense(seed, n):
    """Every slot of five diagonals filled: the pattern DIA keeps exactly."""
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n))
    for o in (-7, -1, 0, 1, 5):
        i = np.arange(max(0, -o), min(n, n - o))
        d[i, i + o] = rng.standard_normal(i.size)
    return d


def kw(fmt):
    return dict(block_shape=(4, 4)) if fmt == "bsr" else {}


def both(fmt, dense):
    Aj = jmf.choose_matrix_type(fmt).from_dense(dense, **kw(fmt))
    At = tmf.choose_matrix_type(fmt).from_dense(dense, device="cpu", **kw(fmt))
    assert At.dtype == torch.float64 and At.format == Aj.format == fmt
    return Aj, At


# -- graphs ---------------------------------------------------------------------


def test_csc_graph_arrays_equal_jax():
    dense = random_dense(0, 37, 29)
    r, c = np.nonzero(dense)
    order = np.random.default_rng(1).permutation(r.size)
    r, c = np.r_[r[order], r[:5]], np.r_[c[order], c[:5]]  # unsorted, with duplicates
    gj, gt = sj.graph.CSCGraph.from_coo(37, 29, r, c), st.CSCGraph.from_coo(37, 29, r, c)
    assert (gt.shape, gt.nnz) == (gj.shape, gj.nnz)
    assert np.array_equal(gt.indptr, np.asarray(gj.indptr))
    assert np.array_equal(gt.indices, np.asarray(gj.indices)[: gj.nnz])
    assert np.array_equal(gt.col_ids, np.asarray(gj.col_ids)[: gj.nnz])
    for a, b in zip(gt.edges_numpy(), gj.edges_numpy()):
        assert np.array_equal(a, b)
    rng = np.random.default_rng(2)
    qr, qc = rng.integers(-2, 39, 200), rng.integers(-2, 31, 200)
    assert np.array_equal(gt.edge_positions(qr, qc), gj.edge_positions(qr, qc))
    assert np.array_equal(gt.degrees_numpy(), gj.degrees_numpy())


@pytest.mark.parametrize("min_width", [1, 12])
def test_ell_graph_arrays_equal_jax(min_width):
    """The (n, width) neighbour array with the duplicate-first-neighbour
    padding rule, an empty row included."""
    dense = random_dense(3, 31, 23)
    r, c = np.nonzero(dense)
    gj = sj.graph.ELLGraph.from_coo(31, 23, r, c, min_width=min_width)
    gt = st.ELLGraph.from_coo(31, 23, r, c, min_width=min_width)
    assert (gt.shape, gt.nnz, gt.width) == (gj.shape, gj.nnz, gj.width)
    assert np.array_equal(gt.cols, np.asarray(gj.cols))
    assert np.array_equal(gt.degrees, np.asarray(gj.degrees))
    # padding slots repeat the row's first neighbour; the empty row holds 0
    i = int(np.argmax((gt.degrees > 0) & (gt.degrees < gt.width)))
    assert (gt.cols[i, gt.degrees[i]:] == gt.cols[i, 0]).all() and (gt.cols[31 // 2] == 0).all()
    for a, b in zip(gt.edges_numpy(), gj.edges_numpy()):
        assert np.array_equal(a, b)
    rng = np.random.default_rng(4)
    qr, qc = rng.integers(-2, 33, 200), rng.integers(-2, 25, 200)
    assert np.array_equal(gt.edge_positions(qr, qc), gj.edge_positions(qr, qc))
    assert np.array_equal(gt.neighbors(3), gj.neighbors(3))


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc", "ell", "bsr"])
def test_graph_queries_and_transforms_equal_jax(fmt):
    dense = random_dense(5, 26, 21)
    r, c = np.nonzero(dense)
    extra = dict(device="cpu") if fmt == "bsr" else {}
    gj = jgf.build_graph(JGraphBuilder.from_coo(26, 21, r, c), fmt, **kw(fmt))
    gt = tgf.build_graph(st.GraphBuilder.from_coo(26, 21, r, c), fmt, **kw(fmt), **extra)
    assert type(gt).__name__ == type(gj).__name__ and gt.format == fmt
    gb = type(gt).from_builder(st.GraphBuilder.from_coo(26, 21, r, c), **kw(fmt), **extra)
    assert np.array_equal(gb.to_dense(), gj.to_dense())
    assert (gt.num_edges, gt.max_degree, gt.degree(3)) == (gj.num_edges, gj.max_degree, gj.degree(3))
    assert np.array_equal(np.sort(gt.neighbors(3)), np.sort(gj.neighbors(3)))
    assert gt.has_edge(int(r[0]), int(c[0])) and not gt.has_edge(26 // 2, 0)
    assert np.array_equal(gt.to_dense(), gj.to_dense())
    rng = np.random.default_rng(6)
    p, q = rng.permutation(26), rng.permutation(21)
    assert np.array_equal(gt.transpose().to_dense(), gj.transpose().to_dense())
    assert np.array_equal(gt.permute_rows(p).to_dense(), gj.permute_rows(p).to_dense())
    assert np.array_equal(gt.permute_cols(q).to_dense(), gj.permute_cols(q).to_dense())
    assert np.array_equal(type(gt).from_dense(dense != 0, **extra, **kw(fmt)).to_dense(), gj.to_dense())


def test_graph_builder_matches_jax():
    rng = np.random.default_rng(7)
    bj, bt = JGraphBuilder(15, 11), st.GraphBuilder(15, 11)
    r, c = rng.integers(0, 15, 40), rng.integers(0, 11, 40)
    for b in (bj, bt):
        b.add_edges(r, c)
        b.add_edge(14, 10)
        b.delete_edge(int(r[0]), int(c[0]))
        b.delete_edge(3, 3)
        b.add_edges([3], [3])  # re-added in bulk: must not stay deleted
    for a, b in zip(bt.edges(), bj.edges()):
        assert np.array_equal(a, b)
    assert bt.num_edges == bj.num_edges and bt.max_degree == bj.max_degree
    assert np.array_equal(bt.degrees(), bj.degrees()) and bt.degree(3) == bj.degree(3)
    assert np.array_equal(bt.neighbors(3), bj.neighbors(3))
    assert bt.has_edge(14, 10) and not bt.has_edge(int(r[0]), int(c[0]))
    assert np.array_equal(bt.to_dense(), bj.to_dense())
    assert np.array_equal(bt.transpose().to_dense(), bj.transpose().to_dense())
    assert np.array_equal(st.GraphBuilder.from_graph(bt.freeze("csc")).to_dense(), bj.to_dense())
    assert bt.freeze("ell").format == "ell"
    with pytest.raises(IndexError):
        bt.add_edge(15, 0)
    with pytest.raises(ValueError):
        st.GraphBuilder(-1)


def test_factories_choose_by_name_and_code():
    assert tgf.num_graph_types == jgf.num_graph_types == tmf.num_matrix_types == 5
    for code in range(1, 6):
        assert tgf.choose_graph_type(code).__name__ == jgf.choose_graph_type(code).__name__
        assert tmf.choose_matrix_type(code).__name__ == jmf.choose_matrix_type(code).__name__
    assert sorted(tgf.GRAPH_FORMATS) == sorted(jgf.GRAPH_FORMATS)
    assert sorted(tmf.MATRIX_FORMATS) == sorted(jmf.MATRIX_FORMATS)
    for name in tgf.GRAPH_FORMATS:
        assert tgf.choose_graph_type(name.upper()).__name__ == jgf.choose_graph_type(name).__name__
    for bad in (0, 6, "nope"):
        with pytest.raises(ValueError):
            tgf.choose_graph_type(bad)
        with pytest.raises(ValueError):
            tmf.choose_matrix_type(bad)


@pytest.mark.parametrize("src", FORMATS[:5])
@pytest.mark.parametrize("dst", FORMATS[:5])
def test_convert_between_formats(src, dst):
    """convert_graph and convert_matrix across every pair of the five
    pattern-exact formats keep sparsity and values."""
    dense = random_dense(8, 24, 20)
    _, At = both(src, dense)
    extra = dict(device="cpu") if dst == "bsr" else {}
    g = tgf.convert_graph(At.graph, dst, **kw(dst), **extra)
    assert g.format == dst and np.array_equal(g.to_dense(), dense != 0)
    B = tmf.convert_matrix(At, dst, **kw(dst))
    assert B.format == dst and B.nnz == At.nnz and B.device.type == "cpu"
    assert np.array_equal(B.to_dense(), dense)


# -- products of the formats this slice adds ----------------------------------------


@pytest.mark.parametrize("fmt", ["csc", "ell"])
@pytest.mark.parametrize("product", ["matvec", "rmatvec", "matmat", "rmatmat"])
def test_products_match_jax(fmt, product):
    dense = random_dense(9, 41, 33)
    Aj, At = both(fmt, dense)
    rng = np.random.default_rng(10)
    rows = 41 if product.startswith("r") else 33
    x = rng.standard_normal(rows if product.endswith("vec") else (rows, 5))
    y = getattr(At, product)(t(x))
    assert rel(y, getattr(Aj, product)(jnp.asarray(x))) <= TOL
    assert rel(y, (dense.T if product.startswith("r") else dense) @ x) <= TOL


@pytest.mark.parametrize("fmt", ["csr", "coo", "csc"])
@pytest.mark.parametrize("product", ["matvec", "rmatvec", "matmat", "rmatmat"])
def test_fixed_order_edge_sums_match_jax(fmt, product):
    """The edge-list products' fixed-order sum (what runs off the CPU: each
    target's terms added in stored edge order, no atomics) gives the CPU
    ``index_add_``'s bits, and the JAX package's product, on a shuffled
    mesh operator."""
    from sigma_tpu_torch.utils.ordered_sum import ordered_sum, sum_plan

    n, r, c, v = st.irregular_mesh_laplacian_coo(16, 8, rng=np.random.default_rng(0),
                                                 shift=1e-3, shuffle=True)
    dense = np.zeros((n, n))
    dense[r, c] = v
    Aj, At = both(fmt, dense)
    side = 1 if product.startswith("r") else 0
    x = np.random.default_rng(11).standard_normal(n if product.endswith("vec") else (n, 5))
    y = getattr(At, product)(t(x))
    edges = At.graph.edges_numpy()
    gather = (At.cols_dev, At.rows_dev)[side]
    prod = (At.data[:, None] if x.ndim == 2 else At.data) * t(x)[gather]
    y_fixed = ordered_sum(prod, sum_plan(edges[side], "cpu"), n)
    assert torch.equal(y_fixed, y)
    assert rel(y_fixed, getattr(Aj, product)(jnp.asarray(x))) <= TOL
    assert rel(y_fixed, (dense.T if side else dense) @ x) <= TOL


@pytest.mark.parametrize("fmt", ["csc", "ell"])
def test_values_equal_jax(fmt):
    dense = random_dense(11, 30, 30)
    Aj, At = both(fmt, dense)
    dj = np.asarray(Aj.data)
    assert np.array_equal(At.data.numpy().reshape(-1), dj.reshape(-1)[: At.data.numel()])
    for a, b in zip(At.entries(), Aj.entries()):
        assert np.array_equal(a, b)
    assert np.array_equal(At.diagonal().numpy(), np.asarray(Aj.diagonal()))
    assert (At.is_get_row_fast, At.is_get_column_fast) == (Aj.is_get_row_fast, Aj.is_get_column_fast)


# -- the mutable SparseMatrix API on every format ------------------------------------


def _dense_for(fmt, seed, n=24):
    return banded_dense(seed, n) if fmt == "dia" else random_dense(seed, n, n)


@pytest.mark.parametrize("fmt", FORMATS)
def test_accessors_match_jax(fmt):
    dense = _dense_for(fmt, 12)
    Aj, At = both(fmt, dense)
    rng = np.random.default_rng(13)
    ii, jj = rng.integers(0, 24, 60), rng.integers(0, 24, 60)
    assert np.array_equal(At.get_values(ii, jj), Aj.get_values(ii, jj))
    assert At.get_value(5, 5) == Aj.get_value(5, 5) == dense[5, 5]
    for i in (0, 5, 12, 23):
        for a, b in zip(At.get_row(i), Aj.get_row(i)):
            assert np.array_equal(a, b)
        cj, vj = Aj.get_column(i)
        ct, vt = At.get_column(i)
        oj, ot = np.argsort(cj), np.argsort(ct)
        assert np.array_equal(ct[ot], cj[oj]) and np.array_equal(vt[ot], vj[oj])
        assert At.row_degree(i) == Aj.row_degree(i)
    assert (At.is_get_row_fast, At.is_get_column_fast) == (Aj.is_get_row_fast, Aj.is_get_column_fast)
    assert np.array_equal(At.to_dense(), dense)


@pytest.mark.parametrize("fmt", FORMATS)
def test_set_and_add_values_match_jax(fmt):
    """Updates at stored positions (with a repeated pair, which add_values
    accumulates) and at absent ones (fill-in: a host-side graph rebuild)."""
    dense = _dense_for(fmt, 14)
    Aj, At = both(fmt, dense)
    r, c = np.nonzero(dense)
    pick = slice(0, r.size, max(1, r.size // 9))
    ii, jj = r[pick], c[pick]
    vals = np.arange(ii.size, dtype=float) + 2.0
    Aj2, At2 = Aj.set_values(ii, jj, vals), At.set_values(ii, jj, vals)
    assert At2.graph is At.graph  # a value update shares the topology
    assert np.array_equal(At2.to_dense(), Aj2.to_dense())
    assert np.array_equal(At.to_dense(), dense)  # functional: the source is untouched
    ii2, jj2 = np.r_[ii, ii[:3]], np.r_[jj, jj[:3]]
    v2 = np.ones(ii2.size) * 0.5
    assert np.array_equal(At2.add_values(ii2, jj2, v2).to_dense(), Aj2.add_values(ii2, jj2, v2).to_dense())
    # fill-in
    zr, zc = np.nonzero(dense == 0)
    fi, fj = np.r_[zr[:4], ii[:2]], np.r_[zc[:4], jj[:2]]
    fv = np.arange(6, dtype=float) + 10.0
    Aj3, At3 = Aj.set_values(fi, fj, fv), At.set_values(fi, fj, fv)
    assert np.array_equal(At3.to_dense(), Aj3.to_dense())
    assert At3.nnz == Aj3.nnz and At3.format == fmt and At3.device.type == "cpu"
    Aj4, At4 = Aj.add_values(fi, fj, fv), At.add_values(fi, fj, fv)
    assert np.array_equal(At4.to_dense(), Aj4.to_dense())
    x = np.random.default_rng(15).standard_normal(24)
    assert rel(At3.matvec(t(x)), Aj3.to_dense() @ x) <= TOL


@pytest.mark.parametrize("fmt", FORMATS)
def test_add_block_scale_with_data_match_jax(fmt):
    dense = _dense_for(fmt, 16)
    Aj, At = both(fmt, dense)
    rows, cols = np.array([2, 3, 9]), np.array([3, 4])
    block = np.arange(6, dtype=float).reshape(3, 2) + 1.0
    assert np.array_equal(At.add_block(rows, cols, block).to_dense(),
                          Aj.add_block(rows, cols, block).to_dense())
    assert np.array_equal(At.scale(-2.5).to_dense(), Aj.scale(-2.5).to_dense())
    new = np.asarray(Aj.data) * 3.0
    Bt = At.with_data(new.reshape(-1)[: At.data.numel()].reshape(tuple(At.data.shape)))
    assert np.array_equal(Bt.to_dense(), Aj.with_data(jnp.asarray(new)).to_dense())
    with pytest.raises(ValueError):
        At.with_data(np.zeros(3))
    assert At.astype(torch.float32).dtype == torch.float32
    small = tmf.choose_matrix_type(fmt).from_dense(np.round(dense * 4) / 4, device="cpu", **kw(fmt))
    assert small.astype_exact(torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        At.astype_exact(torch.bfloat16)


@pytest.mark.parametrize("fmt", FORMATS)
def test_transpose_and_permute_match_jax(fmt):
    n, m = (24, 24) if fmt == "dia" else (24, 20)
    dense = banded_dense(17, n) if fmt == "dia" else random_dense(17, n, m)
    Aj, At = both(fmt, dense)
    Tj, Tt = Aj.transpose_matrix(), At.transpose_matrix()
    assert Tt.format == fmt and Tt.shape == (m, n) and np.array_equal(Tt.to_dense(), Tj.to_dense())
    if fmt == "bsr":
        assert Tt.graph.block_shape == Tj.graph.block_shape
    rng = np.random.default_rng(18)
    p, q = rng.permutation(n), rng.permutation(m)
    assert np.array_equal(At.permute_rows(p).to_dense(), Aj.permute_rows(p).to_dense())
    assert np.array_equal(At.permute_cols(q).to_dense(), Aj.permute_cols(q).to_dense())
    assert np.array_equal(At.permute_rows(p).to_dense()[p], dense)


def test_from_graph_shares_and_coerces():
    dense = random_dense(19, 16, 16)
    r, c = np.nonzero(dense)
    g = st.CSRGraph.from_coo(16, 16, r, c)
    A = st.CSRMatrix.from_graph(g, dtype=torch.float64, device="cpu")
    assert A.graph is g and float(A.data.abs().sum()) == 0.0
    for fmt in ("csc", "ell", "coo", "bsr"):
        B = tmf.choose_matrix_type(fmt).from_graph(g, dtype=torch.float64, device="cpu")
        assert B.format == fmt and B.nnz == g.nnz
        assert np.array_equal(B.set_values(r, c, dense[r, c]).to_dense(), dense)
    gb = st.BSRGraph.from_coo(16, 16, r, c, block_shape=(4, 4), device="cpu")
    assert st.BSRMatrix.from_graph(gb, device="cpu").graph is gb


# -- the fixed-order sums that replace index_add_ off the CPU ---------------
# Each site's sum, run on CPU tensors once as the CPU runs it (index_add_)
# and once through the fixed-order path that every other device takes
# (``ordered_sum.fixed_order`` forced true), must give the same bits; and
# the CPU's own result must be what the plain index_add_ gives.


def _mesh_case(seed=0):
    """A shuffled mesh operator (rows of ~7 terms) as dense, and x."""
    n, r, c, v = st.irregular_mesh_laplacian_coo(16, 8, rng=np.random.default_rng(seed),
                                                 shift=1e-3, shuffle=True)
    dense = np.zeros((n, n))
    dense[r, c] = v
    return dense


def _duplicate_triples(rng, n):
    """Triples with each (row, col) pair up to four times, in shuffled
    order, off a 7-diagonal band."""
    r = rng.integers(0, n, 6 * n)
    c = np.clip(r + rng.integers(-3, 4, r.size), 0, n - 1)
    r, c = np.concatenate([r, r[: 2 * n], r[: n]]), np.concatenate([c, c[: 2 * n], c[: n]])
    p = rng.permutation(r.size)
    return r[p], c[p], rng.standard_normal(r.size)


def _site(name):
    """(run, plain): the site's computation through the port, and the
    same computation with a bare CPU index_add_ as the port had it."""
    rng = np.random.default_rng(31)
    dense = _mesh_case()
    n = dense.shape[0]
    ell = tmf.choose_matrix_type("ell").from_dense(dense, device="cpu")
    bsr = tmf.choose_matrix_type("bsr").from_dense(dense, device="cpu", block_shape=(4, 4))
    x, X = t(rng.standard_normal(n)), t(rng.standard_normal((n, 5)))

    def ell_cols(prod):
        return torch.zeros((n,) + tuple(prod.shape[2:]), dtype=prod.dtype).index_add_(
            0, ell.cols_dev.reshape(-1), prod.reshape((-1,) + tuple(prod.shape[2:])))

    def bsr_plain(A, Xk, transpose):
        g = A.graph
        bh, bw = g.block_shape
        k = Xk.shape[1]
        if transpose:
            Xp = A._padded(Xk, g.nb_rows * bh).reshape(g.nb_rows, bh, k)
            Yb = torch.bmm(A.data.transpose(1, 2), Xp[g.block_rows.clamp(max=g.nb_rows - 1)])
            Y = torch.zeros((g.nb_cols, bw, k), dtype=Yb.dtype).index_add_(0, g.indices, Yb)
            return Y.reshape(-1, k)[: g.shape[1]]
        Xb = A._padded_x(Xk).reshape(g.nb_cols, bw, k)
        Yb = torch.bmm(A.data, Xb[g.indices])
        Y = torch.zeros((g.nb_rows + 1, bh, k), dtype=Yb.dtype).index_add_(0, g.block_rows, Yb)
        return Y[: g.nb_rows].reshape(-1, k)[: g.shape[0]]

    if name == "ell_rmatvec":
        return lambda: ell.rmatvec(x), lambda: ell_cols(ell.data * x[:, None])
    if name == "ell_rmatmat":
        return (lambda: ell.rmatmat(X),
                lambda: ell_cols(ell.data[:, :, None] * X[:, None, :]))
    if name.startswith("bsr_") and not name.endswith("from_coo"):
        product = name[4:]
        Xk = X if product.endswith("mat") else x[:, None]

        def plain():
            Y = bsr_plain(bsr, Xk, product.startswith("r"))
            return Y if product.endswith("mat") else Y[:, 0]

        return lambda: getattr(bsr, product)(X if product.endswith("mat") else x), plain
    if name in ("dia_from_coo", "bsr_from_coo"):
        r, c, v = _duplicate_triples(rng, n)
        if name == "dia_from_coo":
            def plain():
                A = st.DIAMatrix.from_coo(n, n, r, c, v, dtype=torch.float64, device="cpu",
                                          sum_duplicates=False)
                offs = torch.tensor(A.graph.offsets)
                pos = torch.searchsorted(offs, torch.from_numpy(c - r)) * A.data.shape[1]
                pos, inv = torch.unique(pos + torch.from_numpy(r), return_inverse=True)
                A.data.view(-1)[pos] = torch.zeros(pos.numel(), dtype=torch.float64).index_add_(
                    0, inv, t(v))
                return A.data

            return lambda: st.DIAMatrix.from_coo(n, n, r, c, v, dtype=torch.float64,
                                                   device="cpu").data, plain

        def plain():
            keys, inv = torch.unique(torch.from_numpy(r * n + c), return_inverse=True)
            s = torch.zeros(keys.numel(), dtype=torch.float64).index_add_(0, inv, t(v))
            A = st.BSRMatrix.from_coo(n, n, r, c, v, dtype=torch.float64, device="cpu", block_shape=(4, 4),
                                      sum_duplicates=False)
            A.data.view(-1)[A.graph.positions_torch(keys // n, keys % n)] = s
            return A.data

        return (lambda: st.BSRMatrix.from_coo(n, n, r, c, v, dtype=torch.float64, device="cpu",
                                              block_shape=(4, 4)).data, plain)
    # repeated add_values / add_block into non-zero storage, each batch
    # naming its pairs several times
    A = tmf.choose_matrix_type("csr").from_dense(dense, device="cpu")
    rows, cols = np.nonzero(dense)
    pick = rng.integers(0, rows.size, 3 * rows.size)
    batches = [(rows[pick], cols[pick], rng.standard_normal(pick.size)) for _ in range(3)]
    if name == "add_block":
        blk = np.unique(rows[:6])
        block_batches = [(blk, blk, rng.standard_normal((blk.size, blk.size))) for _ in range(3)]

        def run():
            B = A
            for args in block_batches:
                B = B.add_block(*args)
            return B.data

        def plain():
            flat = A.data.clone()
            for br, bc, bv in block_batches:
                rr, cc = np.repeat(br, bc.size), np.tile(bc, br.size)
                pos = torch.from_numpy(A.graph.edge_positions(rr, cc).astype(np.int64))
                flat.index_add_(0, pos, t(bv.reshape(-1)))
            return flat

        return run, plain

    def run():
        B = A
        for args in batches:
            B = B.add_values(*args)
        return B.data

    def plain():
        flat = A.data.clone()
        for br, bc, bv in batches:
            pos = torch.from_numpy(A.graph.edge_positions(br, bc).astype(np.int64))
            flat.index_add_(0, pos, t(bv))
        return flat

    return run, plain


SUM_SITES = ["ell_rmatvec", "ell_rmatmat", "bsr_matvec", "bsr_matmat", "bsr_rmatvec",
             "bsr_rmatmat", "dia_from_coo", "bsr_from_coo", "add_values", "add_block"]


@pytest.mark.parametrize("site", SUM_SITES)
def test_fixed_order_sum_gives_the_cpu_bits(site, monkeypatch):
    run, _ = _site(site)
    cpu = run()
    monkeypatch.setattr(ordered_sum, "fixed_order", lambda device: True)
    fixed = run()
    assert torch.equal(fixed, cpu)
    assert torch.equal(run(), cpu)  # again, from the kept plan where there is one


@pytest.mark.parametrize("site", SUM_SITES)
def test_repaired_sums_on_the_cpu_are_index_add(site):
    run, plain = _site(site)
    assert torch.equal(run(), plain())


def test_products_keep_their_sum_plans(monkeypatch):
    """Off the CPU a product builds its plan once and keeps it with the
    matrix; on the CPU it builds none."""
    dense = _mesh_case()
    x = t(np.ones(dense.shape[0]))
    ell = tmf.choose_matrix_type("ell").from_dense(dense, device="cpu")
    bsr = tmf.choose_matrix_type("bsr").from_dense(dense, device="cpu", block_shape=(4, 4))
    ell.rmatvec(x), bsr.matvec(x)
    assert "_sum_plans" not in ell.__dict__ and "_sum_plans" not in bsr.__dict__
    monkeypatch.setattr(ordered_sum, "fixed_order", lambda device: True)
    ell.rmatvec(x), bsr.matvec(x), bsr.rmatvec(x)
    plans = (ell.__dict__["_sum_plans"]["cols"], bsr.__dict__["_sum_plans"]["rows"])
    ell.rmatmat(x[:, None]), bsr.matmat(x[:, None])
    assert ell.__dict__["_sum_plans"]["cols"] is plans[0]
    assert bsr.__dict__["_sum_plans"]["rows"] is plans[1]
    assert set(bsr.__dict__["_sum_plans"]) == {"rows", "cols"}
