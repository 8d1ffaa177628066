"""The port's BlockMatrix against the JAX package's, following
``tests/test_composite.py``, and the block / multi-DOF slice as a whole: the
elasticity-like operator at a small grid in its three layouts.

CPU, float64; the same numpy inputs go to both packages.  Products agree to
1e-12 relative (a handful of terms summed in another order); value reads,
entries and dense mirrors agree exactly; CG takes the JAX package's
iteration count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu as sj
import sigma_tpu_torch as st
from sigma_tpu.matrix.composite import BlockMatrix as JBlockMatrix
from sigma_tpu.operators.linear_operator import MatvecOperator as JMatvecOperator
from sigma_tpu_torch import convert

torch.set_num_threads(1)

TOL = 1e-12
F64 = dict(dtype=torch.float64, device="cpu")


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def er_laplacian(rng, n, p=0.15):
    adj = np.triu(rng.random((n, n)) < p, 1)
    adj = adj | adj.T
    return np.diag(adj.sum(1).astype(float)) - adj.astype(float) + np.eye(n)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


@pytest.fixture
def block_2x2():
    """(JAX composite, port composite, dense): mixed CSR / CSC / ELL blocks."""
    rng = np.random.default_rng(0)
    n1, n2 = 20, 14
    dA, dB = er_laplacian(rng, n1), er_laplacian(rng, n2)
    dC = np.where(rng.random((n1, n2)) < 0.2, rng.standard_normal((n1, n2)), 0.0)
    dC[0, 0] = 1.5
    Aj = JBlockMatrix.from_blocks([
        [sj.CSRMatrix.from_dense(dA), sj.CSRMatrix.from_dense(dC)],
        [sj.CSCMatrix.from_dense(dC.T), sj.ELLMatrix.from_dense(dB)],
    ])
    At = st.BlockMatrix.from_blocks([
        [st.CSRMatrix.from_dense(dA, device="cpu"), st.CSRMatrix.from_dense(dC, device="cpu")],
        [st.CSCMatrix.from_dense(dC.T, device="cpu"), st.ELLMatrix.from_dense(dB, device="cpu")],
    ])
    return Aj, At, np.block([[dA, dC], [dC.T, dB]])


def test_shapes_and_offsets(block_2x2):
    Aj, At, dense = block_2x2
    assert At.shape == Aj.shape == dense.shape
    assert At.block_shape == Aj.block_shape == (2, 2)
    assert list(At.row_offsets) == list(Aj.row_offsets) == [0, 20, 34]
    assert list(At.col_offsets) == list(Aj.col_offsets) == [0, 20, 34]
    assert At.nnz == Aj.nnz and At.get_block(1, 0).format == "csc"
    assert At.device.type == "cpu"


@pytest.mark.parametrize("product", ["matvec", "rmatvec", "matmat", "rmatmat"])
def test_products_match_jax(block_2x2, product):
    Aj, At, dense = block_2x2
    rng = np.random.default_rng(1)
    x = rng.standard_normal(dense.shape[0] if product.endswith("vec") else (dense.shape[0], 5))
    want = (dense.T if product.startswith("r") else dense) @ x
    y = getattr(At, product)(t(x))
    assert rel(y, getattr(Aj, product)(jnp.asarray(x))) <= TOL
    assert rel(y, want) <= TOL


def test_global_get(block_2x2):
    Aj, At, dense = block_2x2
    rng = np.random.default_rng(2)
    ii = rng.integers(0, dense.shape[0], 50)
    jj = rng.integers(0, dense.shape[1], 50)
    got = At.get_values(ii, jj)
    assert np.array_equal(got, Aj.get_values(ii, jj)) and np.array_equal(got, dense[ii, jj])
    assert At.get_value(0, 20) == dense[0, 20] == 1.5


def test_global_set_add_routing(block_2x2):
    """Entries spanning all four blocks, routed to the owning block's
    set_values / add_values; the results equal the JAX package's."""
    Aj, At, dense = block_2x2
    rows, cols, _ = Aj.entries()
    pick = slice(0, len(rows), max(1, len(rows) // 7))
    ii, jj = rows[pick], cols[pick]
    vals = np.arange(len(ii), dtype=float) + 7.0
    Aj2, At2 = Aj.set_values(ii, jj, vals), At.set_values(ii, jj, vals)
    assert np.array_equal(At2.get_values(ii, jj), vals)
    assert np.array_equal(At2.to_dense(), Aj2.to_dense())
    Aj3, At3 = Aj2.add_values(ii, jj, np.ones(len(ii))), At2.add_values(ii, jj, np.ones(len(ii)))
    assert np.array_equal(At3.get_values(ii, jj), vals + 1.0)
    assert np.array_equal(At3.to_dense(), Aj3.to_dense())
    assert np.array_equal(At.to_dense(), dense)  # the original is untouched


def test_entries_and_dense_roundtrip(block_2x2):
    Aj, At, dense = block_2x2
    for a, b in zip(At.entries(), Aj.entries()):
        assert np.array_equal(a, b)
    assert np.array_equal(At.to_dense(), dense)


def test_shared_graph_blocks():
    """One coupling topology reused by (0,1) as CSR and, transposed, by
    (1,0): the two blocks share one graph object."""
    rng = np.random.default_rng(3)
    n1, n2 = 12, 9
    rows, cols = np.array([0, 3, 5, 11, 7]), np.array([1, 8, 0, 2, 7])
    vals = rng.standard_normal(5)
    dA, dB = er_laplacian(rng, n1), er_laplacian(rng, n2)
    gj = sj.graph.CSRGraph.from_coo(n1, n2, rows, cols)
    gt = st.CSRGraph.from_coo(n1, n2, rows, cols)
    C12j = sj.CSRMatrix.from_graph(gj).set_values(rows, cols, vals)
    C12t = st.CSRMatrix.from_graph(gt, **F64).set_values(rows, cols, vals)
    assert C12t.graph is gt
    Aj = JBlockMatrix.from_blocks([[sj.CSRMatrix.from_dense(dA), C12j],
                                   [C12j.transpose_matrix(), sj.CSRMatrix.from_dense(dB)]])
    At = st.BlockMatrix.from_blocks([[st.CSRMatrix.from_dense(dA, device="cpu"), C12t],
                                     [C12t.transpose_matrix(), st.CSRMatrix.from_dense(dB, device="cpu")]])
    x = rng.standard_normal(n1 + n2)
    dC = C12t.to_dense()
    dense = np.block([[dA, dC], [dC.T, dB]])
    assert rel(At.matvec(t(x)), Aj.matvec(jnp.asarray(x))) <= TOL
    assert rel(At.matvec(t(x)), dense @ x) <= TOL


def test_absent_blocks():
    """None blocks are structural zeros: a block-diagonal grid built by
    empty + set_block."""
    rng = np.random.default_rng(4)
    d1, d2 = er_laplacian(rng, 10), er_laplacian(rng, 6)
    A = st.BlockMatrix.empty([10, 6], [10, 6])
    A = A.set_block(0, 0, st.CSRMatrix.from_dense(d1, device="cpu"))
    A = A.set_block(1, 1, st.CSRMatrix.from_dense(d2, device="cpu"))
    Aj = JBlockMatrix.empty([10, 6], [10, 6])
    Aj = Aj.set_block(0, 0, sj.CSRMatrix.from_dense(d1)).set_block(1, 1, sj.CSRMatrix.from_dense(d2))
    dense = np.block([[d1, np.zeros((10, 6))], [np.zeros((6, 10)), d2]])
    x = np.random.default_rng(5).standard_normal(16)
    assert rel(A.matvec(t(x)), dense @ x) <= TOL
    assert rel(A.rmatmat(t(np.c_[x, 2 * x])), Aj.rmatmat(jnp.asarray(np.c_[x, 2 * x]))) <= TOL
    assert A.get_value(3, 12) == 0.0 and A.nnz == Aj.nnz
    # a block row with no block at all gives zeros of the operand's dtype
    Z = st.BlockMatrix.empty([3, 2], [4]).set_block(0, 0, st.CSRMatrix.from_dense(
        np.ones((3, 4)), device="cpu"))
    y = Z.matvec(torch.ones(4, dtype=torch.float64))
    assert y.dtype == torch.float64 and y.tolist() == [4.0, 4.0, 4.0, 0.0, 0.0]
    with pytest.raises(ValueError, match="absent"):
        A.set_values([0], [12], [1.0])


def test_strategy_wrapper_and_capability_flags(block_2x2):
    """1x1 wrap of a CSR leaf; the flags AND-reduce over the blocks."""
    rng = np.random.default_rng(6)
    d = er_laplacian(rng, 15)
    A = st.BlockMatrix.wrap(st.CSRMatrix.from_dense(d, device="cpu"))
    Aj = JBlockMatrix.wrap(sj.CSRMatrix.from_dense(d))
    assert A.shape == (15, 15)
    assert (A.is_get_row_fast, A.is_get_column_fast) == (Aj.is_get_row_fast, Aj.is_get_column_fast) == (True, False)
    x = rng.standard_normal(15)
    assert rel(A.matvec(t(x)), d @ x) <= TOL
    ii, jj = rng.integers(0, 15, 20), rng.integers(0, 15, 20)
    assert np.array_equal(A.get_values(ii, jj), d[ii, jj]) and np.array_equal(A.to_dense(), d)
    _, At, _ = block_2x2  # mixed CSR/CSC/ELL grid: neither
    assert not At.is_get_row_fast and not At.is_get_column_fast
    eye = st.CSRMatrix.from_dense(np.eye(4), device="cpu")
    assert st.BlockMatrix.from_blocks([[eye, eye]]).is_get_row_fast
    dia = st.laplacian_3d_dia(3, **F64)
    assert st.BlockMatrix.wrap(dia).is_get_column_fast


def test_shape_validation_and_bounds(block_2x2):
    eye3 = st.CSRMatrix.from_dense(np.eye(3), device="cpu")
    eye4 = st.CSRMatrix.from_dense(np.eye(4), device="cpu")
    with pytest.raises(ValueError):
        st.BlockMatrix.from_blocks([[eye3, eye4], [eye4, eye4]])
    with pytest.raises(ValueError):
        st.BlockMatrix.from_blocks([[eye3, eye3], [eye3]])
    with pytest.raises(ValueError):
        st.BlockMatrix.from_blocks([[eye3, None], [None, None]])
    with pytest.raises(ValueError):
        st.BlockMatrix.empty([3, 4], [3, 4]).set_block(0, 1, eye3)
    _, At, dense = block_2x2
    with pytest.raises(IndexError):
        At.get_values([-1], [0])
    with pytest.raises(IndexError):
        At.get_values([dense.shape[0]], [0])


def test_solver_on_composite(block_2x2):
    """The composite feeds straight into CG, with the JAX iteration count
    (to 1e-10: a tolerance at the rounding floor, as 1e-14 is here, stops
    on the summation order's noise)."""
    Aj, At, dense = block_2x2
    xstar = np.random.default_rng(7).standard_normal(dense.shape[0])
    b = dense @ xstar
    xj, ij = sj.solvers.cg_solve(Aj, jnp.asarray(b), tol=1e-10, maxiter=2000)
    xt, it = st.cg_solve(At, t(b), tol=1e-10, maxiter=2000)
    assert it.iterations == int(ij.iterations)
    assert np.abs(xt.numpy() - xstar).max() < 1e-8


def test_nested_blockmatrix():
    inner = st.BlockMatrix.wrap(st.CSRMatrix.from_dense(np.eye(3), device="cpu"))
    outer = st.BlockMatrix.from_blocks([[inner]])
    assert outer.nnz == 3
    out2 = outer.set_values([2], [2], [9.0])
    assert out2.get_value(2, 2) == 9.0 and outer.get_value(2, 2) == 1.0


def test_ducktyped_leaves():
    """Pruned and symmetric leaves are LinearOperators with .nnz and
    .entries, not SparseMatrix: nnz, entries and rmatmat go through."""
    n = 600
    i = np.arange(n)
    rows, cols = np.r_[i, i[:-1], i[1:]], np.r_[i, i[1:], i[:-1]]
    vals = np.r_[np.full(n, 3.0), -np.ones(n - 1), -np.ones(n - 1)]
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    P = st.PrunedDIAMatrix.from_coo(n, n, rows, cols, vals, tile_rows=1024, group=2,
                                    dtype=torch.float64, device="cpu")
    A = st.BlockMatrix.from_blocks([[P, None], [None, P]])
    assert A.nnz == 2 * P.nnz and st.BlockMatrix.from_blocks([[A]]).nnz == A.nnz
    r, c, v = A.entries()
    big = np.zeros((2 * n, 2 * n))
    big[:n, :n] = dense
    big[n:, n:] = dense
    d2 = np.zeros_like(big)
    d2[r, c] = v
    assert np.array_equal(d2, big)
    X = np.random.default_rng(8).standard_normal((2 * n, 3))
    assert rel(A.rmatmat(t(X)), big.T @ X) <= TOL


def test_block_matrix_from_converted_leaves(block_2x2):
    """The JAX composite's leaves carried across array by array."""
    Aj, At, dense = block_2x2

    def carry(blk):
        g, d = blk.graph, np.asarray(blk.data)
        if blk.format == "csr":
            return convert.csr_from_arrays(np.asarray(g.indptr), np.asarray(g.indices), d,
                                           g.shape, device="cpu")
        if blk.format == "csc":
            return convert.csc_from_arrays(np.asarray(g.indptr), np.asarray(g.indices), d,
                                           g.shape, device="cpu")
        return convert.ell_from_arrays(np.asarray(g.cols), np.asarray(g.degrees), d, g.shape,
                                       device="cpu")

    Ac = convert.block_matrix_from_blocks([[carry(b) for b in row] for row in Aj.blocks])
    assert [[b.format for b in row] for row in Ac.blocks] == [["csr", "csr"], ["csc", "ell"]]
    x = np.random.default_rng(9).standard_normal(dense.shape[0])
    assert torch.equal(Ac.matvec(t(x)), At.matvec(t(x)))
    assert np.array_equal(Ac.to_dense(), dense)


# -- the slice as a whole: the elasticity operator in three layouts -----------

NX = 12


def _jax_elasticity(nx):
    """The JAX package's operators as ``benchmarks/elasticity3d.py`` builds
    them (field-blocked composite, node-major DIA and its symmetric
    storage) plus the node-major (3, 3)-block grouped BSR, in f64."""
    L = st.laplacian_3d_dia(nx, torch.float64, "cpu", diag=6.0)
    n, offsets, data = L.shape[0], L.offsets, L.data.numpy()
    ctr = offsets.index(0)
    C = np.array(st.problems.ELASTICITY_COUPLING)
    g = sj.graph.DIAGraph(offsets=offsets, shape=(n, n), nnz=L.nnz)

    def blk(i, j):
        d = C[i, j] * data
        if i == j:
            d[ctr, :n] += 1.0
        return sj.DIAMatrix(graph=g, data=jnp.asarray(d.reshape(len(offsets), -1, 128)))

    A = JBlockMatrix.from_blocks([[blk(i, j) for j in range(3)] for i in range(3)])
    N = 3 * n
    node_vals = {}
    for si, o_sp in enumerate(offsets):
        for a in range(3):
            for fb in range(3):
                v = node_vals.setdefault(3 * o_sp + (fb - a), np.zeros(N))
                v[a::3] += C[a, fb] * data[si, :n]
    node_vals[0] += 1.0
    offs_node = tuple(sorted(node_vals))
    nd = np.zeros((len(offs_node), -(-N // 128) * 128))
    for d, o in enumerate(offs_node):
        nd[d, :N] = node_vals[o]
    A_node = sj.DIAMatrix(graph=sj.graph.DIAGraph(offsets=offs_node, shape=(N, N), nnz=9 * L.nnz),
                          data=jnp.asarray(nd.reshape(len(offs_node), -1, 128)))
    keep = [d for d, o in enumerate(offs_node) if o >= 0]
    A_sym = sj.SymmetricDIAMatrix(data=jnp.asarray(nd[keep].reshape(len(keep), -1, 128)),
                                  offsets=tuple(offs_node[d] for d in keep), n=N)
    r, c, v = A_node.entries()
    nz = v != 0
    A_bsr = sj.BSRMatrix.from_coo(N, N, r[nz], c[nz], v[nz], block_shape=(3, 3))
    return A, A_node, A_sym, A_bsr.grouped(group=8)


@pytest.fixture(scope="module")
def elasticity():
    n = NX ** 3
    port = {
        "field_blocked": st.elasticity_field_blocked(NX, **F64),
        "node_dia": st.elasticity_node_major_dia(NX, **F64),
        "node_sym_dia": st.elasticity_node_major_dia(NX, symmetric=True, **F64),
        "node_bsr_grouped": st.elasticity_node_major_bsr(NX, **F64).grouped(8),
    }
    return port, dict(zip(port, _jax_elasticity(NX))), st.elasticity_permutation(n)


LAYOUTS = ["field_blocked", "node_dia", "node_sym_dia", "node_bsr_grouped"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_elasticity_products_match_jax(elasticity, layout):
    """A x and A X (k = 4) of each layout: equal to the JAX package's to
    1e-12, and to the field-blocked layout's through the dof permutation."""
    port, jx, perm = elasticity
    N = 3 * NX ** 3
    rng = np.random.default_rng(10)
    xv, Xv = rng.standard_normal(N), rng.standard_normal((N, 4))
    node = layout != "field_blocked"

    def lay(v):
        if not node:
            return v
        out = np.empty_like(v)
        out[perm] = v
        return out

    y, Y = port[layout].matvec(t(lay(xv))), port[layout].matmat(t(lay(Xv)))
    assert rel(y, jx[layout].matvec(jnp.asarray(lay(xv)))) <= TOL
    assert rel(Y, jx[layout].matmat(jnp.asarray(lay(Xv)))) <= TOL
    y_ref = port["field_blocked"].matvec(t(xv)).numpy()
    Y_ref = port["field_blocked"].matmat(t(Xv)).numpy()
    assert rel(y.numpy()[perm] if node else y, y_ref) <= TOL
    assert rel(Y.numpy()[perm] if node else Y, Y_ref) <= TOL


def test_elasticity_structure(elasticity):
    port, jx, perm = elasticity
    n = NX ** 3
    nnz_blk = 7 * n - 6 * NX * NX
    A, D, S, G = (port[k] for k in LAYOUTS)
    assert A.shape == D.shape == S.shape == G.shape == (3 * n, 3 * n)
    assert A.nnz == D.nnz == 9 * nnz_blk and A.block_shape == (3, 3)
    assert D.graph.n_diags == 31 and len(S.offsets) == 16
    # one group of 8 per block row, at most 7 real blocks in it
    assert G.gdata.shape == (n, 3, 24) and G.stored_slots == 72 * n
    assert all(A.blocks[a][b].graph is A.blocks[0][0].graph for a in range(3) for b in range(3))
    Gj = jx["node_bsr_grouped"]
    for name in ("gdata", "gcols", "grow"):
        assert np.array_equal(getattr(G, name).numpy(), np.asarray(getattr(Gj, name))), name
    assert np.array_equal(D.data.numpy().reshape(-1), np.asarray(jx["node_dia"].data).reshape(-1))
    dense = A.to_dense()
    assert np.array_equal(dense, dense.T) and np.linalg.eigvalsh(dense).min() > 0
    assert np.array_equal(dense, D.to_dense()[np.ix_(perm, perm)])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_elasticity_cg_matches_jax(elasticity, layout):
    """Jacobi-CG of benchmarks/elasticity3d.py (rtol 1e-6, manufactured
    solution): the JAX package's iteration count, on every layout."""
    port, jx, perm = elasticity
    n = NX ** 3
    node = layout != "field_blocked"
    xstar = np.tile(np.sin(np.arange(n) * 0.001), 3)
    b = port["field_blocked"].matvec(t(xstar)).numpy()
    if node:
        b_l = np.empty_like(b)
        b_l[perm] = b
    else:
        b_l = b
    M = st.elasticity_jacobi(NX, node_major=node, **F64)
    C = np.array(st.problems.ELASTICITY_COUPLING)
    dinv = 1.0 / np.repeat(np.diag(C) * 6.0 + 1.0, n)
    if node:
        dn = np.empty_like(dinv)
        dn[perm] = dinv
        dinv = dn
    assert np.array_equal(M.diag.numpy(), dinv)
    Mj = JMatvecOperator(params=jnp.asarray(dinv), mv=lambda d, r: d * r, rmv=None,
                         shape=(3 * n, 3 * n))
    xj, ij = sj.solvers.cg_solve(jx[layout], jnp.asarray(b_l), tol=0.0, rtol=1e-6, maxiter=150, M=Mj)
    xt, it = st.cg_solve(port[layout], t(b_l), tol=0.0, rtol=1e-6, maxiter=150, M=M)
    assert it.converged and it.iterations == int(ij.iterations)
    assert rel(xt, np.asarray(xj)) <= 1e-10
    err = np.abs((xt.numpy()[perm] if node else xt.numpy()) - xstar).max()
    assert err < 1e-5
