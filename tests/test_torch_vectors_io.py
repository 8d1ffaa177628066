"""The port's block vectors and file I/O held against the JAX package's.

``BlockVector``: the cases of ``tests/test_vectors_util_io.py`` (fields,
set/add with negative indices wrapping within a field, arithmetic, a CG
solve through ``.values``) on the port, with the same numbers as the JAX
package's vector.  I/O: for every file kind, the JAX package writes and
the port reads, and the reverse (text files byte for byte equal when both
write the same matrix); Matrix Market symmetric, skew-symmetric and
pattern files, which only readers handle, are read by both; npz keeps the
format and the value dtype (bfloat16 included); checkpoints cross both
ways and resume a CG solve.  Inputs are numpy, f64 unless said."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import sigma_tpu
import sigma_tpu.io as jio
from sigma_tpu.graph import CSRGraph as JaxCSRGraph
from sigma_tpu.vectors import BlockVector as JaxBlockVector
import sigma_tpu_torch as st
import sigma_tpu_torch.io as tio
from sigma_tpu_torch import convert
from sigma_tpu_torch.vectors import BlockVector


def dense_matrix(seed, n=14, m=10, density=0.3):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((n, m)) < density, rng.standard_normal((n, m)), 0.0)


# -- BlockVector -----------------------------------------------------------------
def test_block_vector_fields_match_jax():
    rng = np.random.default_rng(0)
    u, v = rng.standard_normal(8), rng.standard_normal(5)
    b = BlockVector.from_fields([u, v], device="cpu")
    bj = JaxBlockVector.from_fields([u, v])
    assert (b.num_fields, b.size) == (bj.num_fields, bj.size) == (2, 13)
    np.testing.assert_array_equal(b.offsets, bj.offsets)
    for f in range(2):
        np.testing.assert_array_equal(b.field(f).numpy(), np.asarray(bj.field(f)))
    assert b.get(2, field=1) == bj.get(2, field=1) == v[2]
    assert b.get(9) == bj.get(9) == v[1]
    assert b.field(1).data_ptr() == b.values.data_ptr() + 8 * b.values.element_size()  # a view


def test_block_vector_set_add_match_jax():
    b = BlockVector.zeros([4, 3], dtype=torch.float64, device="cpu")
    bj = JaxBlockVector.zeros([4, 3], dtype=jnp.float64)
    b2, bj2 = b.set(1, 5.0, field=1), bj.set(1, 5.0, field=1)
    assert b2.get(5) == bj2.get(5) == 5.0 and b.get(5) == 0.0  # functional
    b3, bj3 = b2.add(1, 2.0, field=1), bj2.add(1, 2.0, field=1)
    assert b3.get(1, field=1) == bj3.get(1, field=1) == 7.0
    b4 = b3.with_field(0, np.arange(4.0))
    np.testing.assert_array_equal(b4.to_numpy(), bj3.with_field(0, jnp.arange(4.0)).to_numpy())
    with pytest.raises(ValueError):
        b3.with_field(0, np.arange(3.0))


def test_block_vector_default_dtype_is_the_ports():
    assert BlockVector.zeros([2, 2], device="cpu").dtype == torch.float32


def test_block_vector_arithmetic_matches_jax():
    rng = np.random.default_rng(1)
    f = [rng.standard_normal(6), rng.standard_normal(4)]
    g = [rng.standard_normal(6), rng.standard_normal(4)]
    a, c = BlockVector.from_fields(f, device="cpu"), BlockVector.from_fields(g, device="cpu")
    aj, cj = JaxBlockVector.from_fields(f), JaxBlockVector.from_fields(g)
    np.testing.assert_array_equal((a + 2.0 * c).to_numpy(), (aj + 2.0 * cj).to_numpy())
    np.testing.assert_array_equal((a - c * 3.0).to_numpy(), (aj - cj * 3.0).to_numpy())
    assert float(a.dot(c)) == pytest.approx(float(aj.dot(cj)), rel=1e-14)
    assert float(a.norm()) == pytest.approx(float(aj.norm()), rel=1e-14)
    with pytest.raises(ValueError, match="partition"):
        a + BlockVector.zeros([5, 5], device="cpu")


def test_block_vector_with_solver_matches_jax():
    """Flat storage goes straight into CG; the same iterations and solution
    as the JAX package."""
    from sigma_tpu.solvers import cg_solve as jax_cg

    rng = np.random.default_rng(2)
    n1, n2 = 10, 6
    n = n1 + n2
    d = 3 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    xstar = [rng.standard_normal(n1), rng.standard_normal(n2)]
    A = st.CSRMatrix.from_dense(d, device="cpu")
    Aj = sigma_tpu.CSRMatrix.from_dense(d)
    xs, xsj = BlockVector.from_fields(xstar, device="cpu"), JaxBlockVector.from_fields(xstar)
    x, info = st.cg_solve(A, A.matvec(xs.values), tol=1e-14)
    xj, infoj = jax_cg(Aj, Aj.matvec(xsj.values), tol=1e-14)
    got = BlockVector.from_flat(x, (n1, n2))
    assert got.values is x  # wrapped, not copied
    assert info.iterations == int(infoj.iterations)
    np.testing.assert_allclose(got.to_numpy(), np.asarray(xj), rtol=0, atol=1e-13)
    assert np.abs(got.to_numpy() - xs.to_numpy()).max() < 1e-9


def test_block_vector_negative_field_index():
    v = BlockVector.from_fields([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], device="cpu")
    vj = JaxBlockVector.from_fields([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    assert v.get(-1, field=0) == vj.get(-1, field=0) == 3.0
    assert v.set(-1, 99.0, field=0).values.tolist() == [1.0, 2.0, 99.0, 4.0, 5.0, 6.0]
    assert v.add(-1, 1.0, field=1).values.tolist() == np.asarray(
        vj.add(-1, 1.0, field=1).values).tolist() == [1.0, 2.0, 3.0, 4.0, 5.0, 7.0]
    for bad in ((3, 0), (-4, 1)):
        with pytest.raises(IndexError):
            v.set(bad[0], 0.0, field=bad[1])
        with pytest.raises(IndexError):
            v.add(bad[0], 0.0, field=bad[1])


def test_block_vector_from_flat_checks_the_length():
    with pytest.raises(ValueError, match="flat length"):
        BlockVector.from_flat(np.zeros(5), (2, 2), device="cpu")


def test_block_vector_from_jax_arrays():
    bj = JaxBlockVector.from_fields([np.arange(3.0), np.arange(4.0) + 10])
    b = convert.block_vector_from_arrays(np.asarray(bj.values), bj.field_sizes, device="cpu")
    assert b.field_sizes == bj.field_sizes and b.dtype == torch.float64
    np.testing.assert_array_equal(b.to_numpy(), np.asarray(bj.values))
    np.testing.assert_array_equal(b.field(1).numpy(), np.asarray(bj.field(1)))


# -- I/O: graph and matrix text --------------------------------------------------
def test_graph_text_crosses_both_ways(tmp_path):
    dense = np.random.default_rng(3).random((15, 11)) < 0.2
    r, c = np.nonzero(dense)
    g, gj = st.CSRGraph.from_coo(15, 11, r, c), JaxCSRGraph.from_coo(15, 11, r, c)
    tio.write_graph(g, tmp_path / "t.txt")
    jio.write_graph(gj, tmp_path / "j.txt")
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    for frmt in ("csr", "ell", "coo"):
        a, b = tio.read_graph(tmp_path / "j.txt", frmt), jio.read_graph(tmp_path / "t.txt", frmt)
        assert a.shape == b.shape == (15, 11)
        for x, y in zip(a.edges_numpy(), b.edges_numpy()):
            np.testing.assert_array_equal(x, np.asarray(y))
    gb = tio.read_graph(tmp_path / "j.txt", "bsr", device="cpu", block_shape=(4, 4))
    np.testing.assert_array_equal(gb.edges_numpy()[1], c)


@pytest.mark.parametrize("frmt", ["csr", "ell", "dia", "coo"])
def test_matrix_text_crosses_both_ways(tmp_path, frmt):
    d = dense_matrix(4, 12, 9)
    A = st.choose_matrix_type(frmt).from_dense(d, device="cpu")
    Aj = sigma_tpu.choose_matrix_type(frmt).from_dense(d)
    tio.write_matrix(A, tmp_path / "t.txt")
    jio.write_matrix(Aj, tmp_path / "j.txt")
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    B = tio.read_matrix(tmp_path / "j.txt", "ell", dtype=torch.float64, device="cpu")
    Bj = jio.read_matrix(tmp_path / "t.txt", "ell")
    assert isinstance(B, st.ELLMatrix) and B.dtype == torch.float64
    np.testing.assert_array_equal(B.to_dense(), np.asarray(Bj.to_dense()))
    np.testing.assert_array_equal(B.to_dense(), d)


def test_matrix_text_reader_counts_entries(tmp_path):
    (tmp_path / "bad.txt").write_text("3 3 2\n0 0 1.0\n")
    with pytest.raises(ValueError, match="expected 2 entries"):
        tio.read_matrix(tmp_path / "bad.txt", device="cpu")


# -- I/O: Matrix Market --------------------------------------------------------------
def test_matrix_market_general_crosses_both_ways(tmp_path):
    d = dense_matrix(5)
    A, Aj = st.CSRMatrix.from_dense(d, device="cpu"), sigma_tpu.CSRMatrix.from_dense(d)
    tio.write_matrix_market(A, tmp_path / "t.mtx", comment="test matrix")
    jio.write_matrix_market(Aj, tmp_path / "j.mtx", comment="test matrix")
    assert (tmp_path / "t.mtx").read_bytes() == (tmp_path / "j.mtx").read_bytes()
    B = tio.read_matrix_market(tmp_path / "j.mtx", dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(B.to_dense(), d)
    np.testing.assert_array_equal(np.asarray(jio.read_matrix_market(tmp_path / "t.mtx").to_dense()), d)


MM_FILES = {
    "symmetric": ("%%MatrixMarket matrix coordinate real symmetric\n3 3 4\n"
                  "1 1 2.0\n2 1 -1.0\n2 2 2.0\n3 3 2.0\n"),
    "skew": "%%MatrixMarket matrix coordinate real skew-symmetric\n3 3 1\n2 1 1.5\n",
    "pattern": "%%MatrixMarket matrix coordinate pattern general\n% a comment line\n2 2 2\n1 2\n2 1\n",
    "hermitian": ("%%MatrixMarket matrix coordinate real hermitian\n4 4 3\n"
                  "1 1 4.0\n4 1 0.5\n3 2 -2.0\n"),
}


@pytest.mark.parametrize("kind", sorted(MM_FILES))
def test_matrix_market_readers_agree(tmp_path, kind):
    p = tmp_path / f"{kind}.mtx"
    p.write_text(MM_FILES[kind])
    got = tio.read_matrix_market(p, dtype=torch.float64, device="cpu").to_dense()
    np.testing.assert_array_equal(got, np.asarray(jio.read_matrix_market(p).to_dense()))
    if kind == "symmetric":
        assert got[0, 1] == got[1, 0] == -1.0
    if kind == "skew":
        assert got[1, 0] == 1.5 and got[0, 1] == -1.5
    if kind == "pattern":
        assert got[0, 1] == got[1, 0] == 1.0


def test_matrix_market_rejects_other_files(tmp_path):
    (tmp_path / "a.mtx").write_text("3 3 0\n")
    (tmp_path / "b.mtx").write_text("%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n")
    with pytest.raises(ValueError, match="not a MatrixMarket"):
        tio.read_matrix_market(tmp_path / "a.mtx", device="cpu")
    with pytest.raises(ValueError, match="coordinate"):
        tio.read_matrix_market(tmp_path / "b.mtx", device="cpu")


# -- I/O: npz ----------------------------------------------------------------------------
NPZ = [("csr", "float64"), ("ell", "float64"), ("dia", "float32"), ("coo", "float32"),
       ("csc", "float64"), ("csr", "bfloat16"), ("dia", "bfloat16")]


def tridiagonal(n=60):
    i = np.arange(n)
    d = np.zeros((n, n))
    d[i, i] = 2.0
    d[i[:-1], i[1:]] = -0.5
    d[i[1:], i[:-1]] = -0.5
    return d


@pytest.mark.parametrize("frmt,dtype", NPZ)
def test_npz_crosses_both_ways(tmp_path, frmt, dtype):
    d = tridiagonal() if dtype == "bfloat16" else dense_matrix(6, 20, 20, 0.15)
    r, c = np.nonzero(d)
    A = st.choose_matrix_type(frmt).from_coo(d.shape[0], d.shape[1], r, c, d[r, c],
                                             dtype=getattr(torch, dtype), device="cpu")
    Aj = sigma_tpu.choose_matrix_type(frmt).from_coo(d.shape[0], d.shape[1], r, c, d[r, c],
                                                     dtype=getattr(jnp, dtype))
    tio.save_matrix_npz(A, tmp_path / "t.npz")
    jio.save_matrix_npz(Aj, tmp_path / "j.npz")
    with np.load(tmp_path / "t.npz") as zt, np.load(tmp_path / "j.npz") as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zt.files:
            np.testing.assert_array_equal(zt[k], zj[k])
            assert zt[k].dtype == zj[k].dtype
    B = tio.load_matrix_npz(tmp_path / "j.npz", device="cpu")
    Bj = jio.load_matrix_npz(tmp_path / "t.npz")
    assert B.format == Bj.format == frmt
    assert B.dtype == getattr(torch, dtype) and Bj.dtype == getattr(jnp, dtype)
    np.testing.assert_array_equal(B.to_dense().astype(np.float64),
                                  np.asarray(Bj.to_dense()).astype(np.float64))
    assert torch.equal(B.data, A.data)


def test_npz_overrides_format_and_dtype(tmp_path):
    A = st.CSRMatrix.from_dense(dense_matrix(7), device="cpu")
    tio.save_matrix_npz(A, tmp_path / "a.npz")
    B = tio.load_matrix_npz(tmp_path / "a.npz", frmt="ell", dtype=torch.float32, device="cpu")
    assert isinstance(B, st.ELLMatrix) and B.dtype == torch.float32


# -- I/O: checkpoints ---------------------------------------------------------------
def test_checkpoint_crosses_both_ways(tmp_path):
    rng = np.random.default_rng(8)
    x, r = rng.standard_normal(64), rng.standard_normal(64)
    tio.save_checkpoint(tmp_path / "t.npz", torch.from_numpy(x), iteration=17, residual=1e-9,
                        r=torch.from_numpy(r))
    jio.save_checkpoint(tmp_path / "j.npz", jnp.asarray(x), iteration=17, residual=1e-9, r=r)
    for path in ("t.npz", "j.npz"):
        xt, meta, extras = tio.load_checkpoint(tmp_path / path, device="cpu")
        xj, metaj, extrasj = jio.load_checkpoint(tmp_path / path)
        assert isinstance(xt, torch.Tensor) and xt.dtype == torch.float64
        np.testing.assert_array_equal(xt.numpy(), x)
        np.testing.assert_array_equal(np.asarray(xj), x)
        assert meta == metaj == {"iteration": 17, "residual": 1e-9}
        np.testing.assert_array_equal(extras["r"], r)
        np.testing.assert_array_equal(extrasj["r"], r)


def test_checkpoint_resume_solve(tmp_path):
    """Interrupt CG, checkpoint, resume from x0: converges, and resumes
    from the JAX package's checkpoint to the same iterate."""
    from sigma_tpu.solvers import cg_solve as jax_cg

    n = 80
    d = 3 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    xstar = np.random.default_rng(9).standard_normal(n)
    A, Aj = st.CSRMatrix.from_dense(d, device="cpu"), sigma_tpu.CSRMatrix.from_dense(d)
    b = torch.from_numpy(d @ xstar)
    x_half, info = st.cg_solve(A, b, tol=0.0, maxiter=10)
    tio.save_checkpoint(tmp_path / "s.npz", x_half, iteration=info.iterations)
    xj_half, _ = jax_cg(Aj, jnp.asarray(d @ xstar), tol=0.0, maxiter=10)
    jio.save_checkpoint(tmp_path / "sj.npz", xj_half, iteration=10)
    x0, meta, _ = tio.load_checkpoint(tmp_path / "s.npz", device="cpu")
    x0j, _, _ = tio.load_checkpoint(tmp_path / "sj.npz", device="cpu")
    assert meta["iteration"] == 10 and torch.equal(x0, x_half)
    np.testing.assert_allclose(x0.numpy(), x0j.numpy(), rtol=0, atol=1e-13)
    x_final, _ = st.cg_solve(A, b, x0=x0, tol=1e-14)
    assert np.abs(x_final.numpy() - xstar).max() < 1e-9


# -- scipy -----------------------------------------------------------------------------
@pytest.mark.parametrize("kind,frmt", [("csc", None), ("csr", None), ("coo", None),
                                       ("lil", None), ("csr", "ell")])
def test_scipy_interop_matches_jax(kind, frmt):
    d = dense_matrix(10, 15, 12)
    S = scipy.sparse.csr_matrix(d).asformat(kind)
    A = tio.from_scipy(S, frmt, dtype=torch.float64, device="cpu")
    Aj = jio.from_scipy(S, frmt)
    assert A.format == Aj.format
    np.testing.assert_array_equal(A.to_dense(), d)
    back, backj = tio.to_scipy(A), jio.to_scipy(Aj)
    assert back.format == "csr"
    np.testing.assert_array_equal(back.toarray(), np.asarray(backj.toarray()))
