"""The port's block format against the JAX package, on the CPU in float64.

Inputs are made once with numpy from a seed and fed to both packages.
``BSRGraph`` and ``GroupedBSR.from_bsr`` arrays must equal the JAX
package's exactly (the port assembles them with torch on a device, the JAX
package with numpy on the host); products agree to 1e-12 relative in f64
(different summation orders of a few dozen terms); the plain version of
the grouped kernel agrees with the Pallas kernel in interpret mode to 1e-5
relative in f32, the JAX test's own limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu as sj
import sigma_tpu_torch as st
from sigma_tpu.ops.bsr_pallas import GroupedBSR as JGroupedBSR
from sigma_tpu.ops.bsr_pallas import bsr_grouped_spmv as j_bsr_grouped_spmv
from sigma_tpu_torch import convert
from sigma_tpu_torch.ops import bsr_grouped as bg

torch.set_num_threads(1)

SHAPES = [((500, 460), (8, 16)), ((260, 260), (4, 4)), ((301, 305), (3, 3))]
TOL = 1e-12


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def random_dense(seed, n, m, p=0.04, empty=None):
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((n, m)) < p, rng.standard_normal((n, m)), 0.0)
    if empty is not None:
        dense[empty] = 0.0
    return dense


def both_bsr(dense, blk, dtype=np.float64):
    r, c = np.nonzero(dense)
    Aj = sj.BSRMatrix.from_coo(*dense.shape, r, c, dense[r, c], block_shape=blk, dtype=dtype)
    At = st.BSRMatrix.from_coo(*dense.shape, r, c, dense[r, c], block_shape=blk,
                               dtype=st.utils.torch_dtype(dtype), device="cpu")
    return Aj, At


def assert_same_graph(gj, gt):
    assert (gt.shape, gt.block_shape, gt.nnz, gt.nnzb) == (gj.shape, gj.block_shape, gj.nnz, gj.nnzb)
    for name in ("indptr", "indices", "block_rows", "mask"):
        assert np.array_equal(getattr(gt, name).numpy(), np.asarray(getattr(gj, name))), name


@pytest.mark.parametrize("shape,blk", SHAPES)
def test_bsr_graph_and_values_equal_jax(shape, blk):
    dense = random_dense(1, *shape, empty=slice(40, 40 + 2 * blk[0]))
    Aj, At = both_bsr(dense, blk)
    assert_same_graph(Aj.graph, At.graph)
    assert np.array_equal(At.data.numpy(), np.asarray(Aj.data))
    # graph alone, from unsorted edges with duplicates
    r, c = np.nonzero(dense)
    order = np.random.default_rng(2).permutation(r.size)
    r2, c2 = np.r_[r[order], r[:7]], np.r_[c[order], c[:7]]
    assert_same_graph(sj.graph.BSRGraph.from_coo(*shape, r2, c2, block_shape=blk),
                      st.BSRGraph.from_coo(*shape, r2, c2, block_shape=blk, device="cpu"))


@pytest.mark.parametrize("shape,blk", SHAPES[:2])
def test_bsr_graph_queries_equal_jax(shape, blk):
    dense = random_dense(3, *shape)
    Aj, At = both_bsr(dense, blk)
    gj, gt = Aj.graph, At.graph
    for a, b in zip(gj.edges_numpy(), gt.edges_numpy()):
        assert np.array_equal(a, b)
    rng = np.random.default_rng(4)
    qr = np.r_[rng.integers(-2, shape[0] + 2, 300), np.nonzero(dense)[0][:50]]
    qc = np.r_[rng.integers(-2, shape[1] + 2, 300), np.nonzero(dense)[1][:50]]
    assert np.array_equal(gt.edge_positions(qr, qc), gj.edge_positions(qr, qc))
    assert np.array_equal(gt.degrees_numpy(), gj.degrees_numpy())
    assert gt.max_degree == gj.max_degree and gt.has_edge(*np.argwhere(dense)[0])
    assert_same_graph(gj.transpose(), gt.transpose())
    p = rng.permutation(shape[0])
    assert_same_graph(gj.permute_rows(p), gt.permute_rows(p))
    q = rng.permutation(shape[1])
    assert_same_graph(gj.permute_cols(q), gt.permute_cols(q))


@pytest.mark.parametrize("shape,blk", SHAPES)
def test_bsr_products_match_jax(shape, blk):
    """matvec, rmatvec, matmat, rmatmat of the ungrouped BSRMatrix."""
    n, m = shape
    dense = random_dense(5, n, m)
    Aj, At = both_bsr(dense, blk)
    rng = np.random.default_rng(6)
    x, xt = rng.standard_normal(m), rng.standard_normal(n)
    X, XT = rng.standard_normal((m, 5)), rng.standard_normal((n, 5))
    assert rel(At.matvec(torch.from_numpy(x)), Aj.matvec(jnp.asarray(x))) <= TOL
    assert rel(At.rmatvec(torch.from_numpy(xt)), Aj.rmatvec(jnp.asarray(xt))) <= TOL
    assert rel(At.matmat(torch.from_numpy(X)), Aj.matmat(jnp.asarray(X))) <= TOL
    assert rel(At.rmatmat(torch.from_numpy(XT)), Aj.rmatmat(jnp.asarray(XT))) <= TOL
    assert rel(At.matvec(torch.from_numpy(x)), dense @ x) <= TOL
    assert np.array_equal(At.to_dense(), dense)
    assert At._padded_x(torch.from_numpy(x)).shape[0] == At.graph.nb_cols * blk[1]


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("shape,blk", SHAPES)
def test_from_bsr_arrays_equal_jax(shape, blk, group):
    dense = random_dense(7, *shape, empty=slice(16, 16 + 3 * blk[0]))
    Aj, At = both_bsr(dense, blk)
    Gj, Gt = Aj.grouped(group=group), At.grouped(group=group)
    assert (Gt.shape, Gt.block_shape, Gt.group) == (Gj.shape, Gj.block_shape, Gj.group)
    assert (Gt.nb_rows, Gt.nb_cols) == (Gj.nb_rows, Gj.nb_cols)
    assert Gt.gcols.dtype == torch.int32 and Gt.grow.dtype == torch.int32
    for name in ("gdata", "gcols", "grow"):
        assert np.array_equal(getattr(Gt, name).numpy(), np.asarray(getattr(Gj, name))), name
    # the group pointer names each block row's run of groups
    grow = Gt.grow.numpy()
    ptr = Gt.gptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == grow.size and (np.diff(ptr) >= 1).all()
    assert np.array_equal(np.repeat(np.arange(Gt.nb_rows), np.diff(ptr)), grow)


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("shape,blk", SHAPES)
def test_grouped_products_match_jax(shape, blk, group):
    n, m = shape
    dense = random_dense(8, n, m)
    Aj, At = both_bsr(dense, blk)
    Gj, Gt = Aj.grouped(group=group), At.grouped(group=group)
    rng = np.random.default_rng(9)
    x, X = rng.standard_normal(m), rng.standard_normal((m, 5))
    y, Y = Gt.matvec(torch.from_numpy(x)), Gt.matmat(torch.from_numpy(X))
    assert rel(y, Gj.matvec(jnp.asarray(x))) <= TOL
    assert rel(Y, Gj.matmat(jnp.asarray(X))) <= TOL
    assert rel(y, dense @ x) <= TOL and rel(Y, dense @ X) <= TOL
    # a column-major block (X.T contiguous) is taken as it is
    Xc = torch.from_numpy(np.asfortranarray(X))
    assert not Xc.is_contiguous() and rel(Gt.matmat(Xc), dense @ X) <= TOL
    # converted from the JAX object's arrays
    Gc = convert.grouped_bsr_from_arrays(np.asarray(Gj.gdata), np.asarray(Gj.gcols),
                                         np.asarray(Gj.grow), Gj.shape, Gj.block_shape,
                                         Gj.group, device="cpu")
    assert torch.equal(Gc.matvec(torch.from_numpy(x)), y)


def _interpret_case():
    rng = np.random.default_rng(10)
    n = m = 384
    dense = np.zeros((n, m))
    # dense band rows (rows of several groups) and empty block rows
    dense[:64] = np.where(rng.random((64, m)) < 0.3, rng.standard_normal((64, m)), 0.0)
    dense[128:160, :32] = rng.standard_normal((32, 32))
    return dense, rng


@pytest.mark.parametrize("k", [1, 3])
def test_reference_matches_pallas_kernel_interpret(k):
    """The plain version against the Pallas kernel itself (interpret
    mode), f32, with empty block rows and rows of several groups: 1e-5
    relative, the JAX test's limit."""
    dense, rng = _interpret_case()
    n, m = dense.shape
    Aj, At = both_bsr(dense, (8, 16), dtype=np.float32)
    Gj, Gt = Aj.grouped(group=4), At.grouped(group=4)
    X = rng.standard_normal((m, k)).astype(np.float32)
    yj = j_bsr_grouped_spmv(Gj.gdata, Gj.gcols, Gj.grow, Gj._pad_x(jnp.asarray(X)),
                            Gj.nb_rows, Gj.nb_cols, Gj.block_shape, Gj.group, interpret=True)
    args = (Gt.gdata, Gt.gcols, Gt.grow, Gt._pad_x(torch.from_numpy(X)), Gt.nb_rows, Gt.nb_cols,
            Gt.block_shape, Gt.group)
    yt = bg.bsr_grouped_spmv_reference(*args)
    assert yt.dtype == torch.float32 and tuple(yt.shape) == tuple(yj.shape)
    assert rel(yt, np.asarray(yj)) <= 1e-5
    assert rel(yt[:n], dense @ X) <= 1e-5
    # on a CPU tensor the wrapper is the plain version, and counts no launch
    before = bg.bsr_grouped_spmv.launches
    assert torch.equal(bg.bsr_grouped_spmv(*args, gptr=Gt.gptr), yt)
    assert bg.bsr_grouped_spmv.launches == before


@pytest.mark.parametrize("vdt,xdt", sorted(bg.BSR_KERNEL_DTYPES, key=str), ids=str)
def test_reference_dtype_pairs(vdt, xdt):
    """Values cast up to the vector's dtype; bf16 vectors computed in f32
    and rounded once.  Against the f64 product of the same (rounded)
    operands: 1e-12 for f64 vectors, 1e-5 for f32, 2^-7 for bf16."""
    dense = random_dense(11, 96, 96, p=0.1)
    At = both_bsr(dense, (4, 4))[1].astype(vdt)
    G = At.grouped(4)
    X = torch.from_numpy(np.random.default_rng(12).standard_normal((96, 3))).to(xdt)
    Y = G.matmat(X)
    assert Y.dtype == xdt
    exact = At.astype(torch.float64).matmat(X.double())
    tol = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}[xdt]
    assert rel(Y.double(), exact) <= tol


def test_wrapper_rejects_bad_operands():
    dense = random_dense(13, 64, 64, p=0.1)
    G = both_bsr(dense, (4, 4))[1].grouped(4)
    X = torch.zeros((64, 2), dtype=torch.float64)
    args = [G.gdata, G.gcols, G.grow, X, G.nb_rows, G.nb_cols, G.block_shape, G.group]
    with pytest.raises(ValueError, match="want x"):
        bg.bsr_grouped_spmv(*args[:3], X[:60], *args[4:])
    with pytest.raises(TypeError, match="int32"):
        bg.bsr_grouped_spmv(G.gdata, G.gcols.long(), *args[2:])
    with pytest.raises(ValueError, match="want gdata"):
        bg.bsr_grouped_spmv(G.gdata[:, :, :8], *args[1:])


def test_device_tensors_never_reach_the_plain_version(monkeypatch):
    """Routing is by the tensor's device alone: off the CPU the wrapper
    goes on to the kernel (no library here, so the build raises; the
    ``meta`` device is refused as no CUDA device) and never to the plain
    version; an unsupported dtype pair raises."""
    def no_plain(*a):
        raise AssertionError("plain version called for a device tensor")

    monkeypatch.setattr(bg, "bsr_grouped_spmv_reference", no_plain)
    dense = random_dense(14, 64, 64, p=0.1)
    G = both_bsr(dense, (4, 4))[1].grouped(4).to("meta")
    assert G.device.type == "meta" and G.gptr.device.type == "meta"
    with pytest.raises(ValueError, match="no grouped-BSR kernel for device meta"):
        G.matvec(torch.empty(64, dtype=torch.float64, device="meta"))
    assert (torch.float64, torch.float32) not in bg.BSR_KERNEL_DTYPES
    assert (torch.float16, torch.float16) not in bg.BSR_KERNEL_DTYPES


@pytest.mark.parametrize("blk,group,itemsize,aligned,form", [
    ((8, 128), 8, 4, True, "wide"),  # block-banded operator: 1,024 f32 columns
    ((8, 128), 1, 4, True, "wide"),  # 128 columns: one 16-byte piece a lane
    ((8, 128), 8, 2, True, "wide"),  # bf16: 8 values a piece, 128 pieces
    ((8, 128), 1, 2, True, "narrow"),  # bf16: 16 pieces, under a warp's width
    ((12, 64), 4, 8, True, "wide"),  # f64: 2 values a piece; 12 rows, two passes
    ((8, 16), 8, 8, True, "wide"),
    ((8, 16), 4, 4, True, "narrow"),
    ((3, 3), 8, 4, True, "narrow"),  # elasticity: 96-byte group rows
    ((3, 3), 8, 2, True, "narrow"),  # 48 bytes
    ((3, 3), 1, 4, True, "narrow_unaligned"),  # 12 bytes
    ((4, 4), 1, 2, True, "narrow_unaligned"),  # 8 bytes
    ((4, 4), 8, 2, True, "narrow"),
    ((4, 33), 8, 4, True, "narrow"),  # 1,056 bytes, but pieces straddle blocks
    ((4, 33), 1, 2, True, "narrow_unaligned"),  # odd bw, bf16: 66 bytes
    ((8, 128), 8, 4, False, "narrow_unaligned"),  # gdata off a 16-byte boundary
])
def test_form_rule(blk, group, itemsize, aligned, form):
    """The wrapper's one rule for the kernel's form, from the block shape,
    the group, the value size and gdata's alignment."""
    assert bg.bsr_grouped_form(blk, group, itemsize, aligned) == form


def test_grouped_bsr_form_follows_its_arrays():
    """GroupedBSR fixes its form at construction: the block-banded operator
    wide, the elasticity operator narrow, a group of one (3, 3) block and
    gdata off a 16-byte boundary one value a load; products on the CPU do
    not depend on it."""
    assert st.block_banded_grouped_bsr(16, device="cpu").form == "wide"
    B = st.elasticity_node_major_bsr(4, torch.float32, "cpu")
    G8, G1 = B.grouped(8), B.grouped(1)
    assert (G8.form, G1.form) == ("narrow", "narrow_unaligned")
    store = torch.zeros(G8.gdata.numel() + 1, dtype=torch.float32)
    store[1:] = G8.gdata.reshape(-1)
    off = bg.GroupedBSR(store[1:].view(G8.gdata.shape), G8.gcols, G8.grow, G8.shape,
                        G8.block_shape, G8.group)
    assert off.gdata.data_ptr() % 16 and off.form == "narrow_unaligned"
    x = torch.from_numpy(np.random.default_rng(18).standard_normal(B.shape[1])).float()
    assert torch.equal(off.matvec(x), G8.matvec(x))
    assert rel(G1.matvec(x), B.matvec(x)) <= 1e-6


def _bad_grouped(case):
    G = st.BSRMatrix.from_dense(random_dense(19, 64, 64, p=0.2), block_shape=(4, 4),
                                device="cpu").grouped(4)
    a = dict(gdata=G.gdata, gcols=G.gcols, grow=G.grow, shape=G.shape,
             block_shape=G.block_shape, group=G.group)
    if case == "gdata_shape":
        a["gdata"] = G.gdata[:, :, :8].contiguous()
    elif case == "gcols_shape":
        a["gcols"] = G.gcols[:, :3].contiguous()
    elif case == "gcols_int64":
        a["gcols"] = G.gcols.long()
    elif case == "grow_int64":
        a["grow"] = G.grow.long()
    elif case == "gdata_not_contiguous":
        a["gdata"] = G.gdata.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "grow_descending":
        a["grow"] = G.grow.flip(0).contiguous()
    elif case == "grow_past_last_row":
        a["shape"] = (G.shape[0] - 8, G.shape[1])
    elif case == "gcols_past_last_column":
        a["gcols"] = G.gcols + 15
    elif case == "gcols_negative":
        a["gcols"] = G.gcols - 1
    elif case == "devices_differ":
        a["gcols"] = G.gcols.to("meta")
    return a


@pytest.mark.parametrize("case,error", [
    ("gdata_shape", ValueError), ("gcols_shape", ValueError), ("gcols_int64", TypeError),
    ("grow_int64", TypeError), ("gdata_not_contiguous", ValueError),
    ("grow_descending", ValueError), ("grow_past_last_row", ValueError),
    ("gcols_past_last_column", ValueError), ("gcols_negative", ValueError),
    ("devices_differ", ValueError),
])
def test_grouped_bsr_rejects_bad_arrays_at_construction(case, error):
    """The fixed arrays are checked once, when the operator is made, so a
    product checks only its operand: each bad array raises there."""
    with pytest.raises(error):
        bg.GroupedBSR(**_bad_grouped(case))


def test_grouped_bsr_product_checks_its_operand():
    G = st.BSRMatrix.from_dense(random_dense(20, 64, 60, p=0.2), block_shape=(4, 4),
                                device="cpu").grouped(4)
    with pytest.raises(ValueError, match="want x"):
        G.matmat(torch.zeros((59, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="different devices"):
        G.matvec(torch.zeros(60, dtype=torch.float64, device="meta"))
    # the unpadded and the padded operand (nb_cols * bw = 60 here: equal) agree
    x = torch.from_numpy(np.random.default_rng(21).standard_normal(60))
    assert rel(G.matvec(x), G.to_dense() @ x.numpy()) <= TOL


def test_grouped_in_cg_matches_jax():
    """GroupedBSR is a LinearOperator: straight into CG, with the JAX
    package's iteration count."""
    rng = np.random.default_rng(15)
    n = 128
    dense = np.where(rng.random((n, n)) < 0.05, rng.standard_normal((n, n)), 0.0)
    dense = dense + dense.T + np.diag(np.abs(dense).sum(1) + 1.0)
    b = rng.standard_normal(n)
    Gj = sj.BSRMatrix.from_dense(dense, block_shape=(8, 8)).grouped(group=2)
    Gt = st.BSRMatrix.from_dense(dense, block_shape=(8, 8), device="cpu").grouped(group=2)
    xj, ij = sj.solvers.cg_solve(Gj, jnp.asarray(b), tol=1e-12)
    xt, it = st.cg_solve(Gt, torch.from_numpy(b), tol=1e-12)
    assert it.iterations == int(ij.iterations)
    assert rel(xt, np.asarray(xj)) <= 1e-10
    assert np.abs(xt.numpy() - np.linalg.solve(dense, b)).max() < 1e-9


def test_block_banded_generator_matches_benchmark_arrays():
    """The block-banded operator at a small size: the arrays of the JAX
    package's benchmark generator, drawn in its order."""
    nb_rows, bh, bw, grp = 64, 8, 128, 8
    G = st.block_banded_grouped_bsr(nb_rows, device="cpu")
    nbc = nb_rows * bh // bw
    rngb = np.random.default_rng(1)
    grow_b = np.arange(nb_rows, dtype=np.int32)
    center = (grow_b.astype(np.int64) * bh) // bw
    gcols_b = np.clip(center[:, None] + rngb.integers(-4, 5, size=(nb_rows, grp)), 0,
                      nbc - 1).astype(np.int32)
    gdata_b = rngb.standard_normal((nb_rows, bh, grp * bw)).astype(np.float32)
    assert np.array_equal(G.gcols.numpy(), gcols_b) and np.array_equal(G.gdata.numpy(), gdata_b)
    Gj = JGroupedBSR(gdata=jnp.asarray(gdata_b), gcols=jnp.asarray(gcols_b),
                     grow=jnp.asarray(grow_b), shape=(nb_rows * bh,) * 2, block_shape=(bh, bw),
                     group=grp)
    X = np.random.default_rng(2).standard_normal((nb_rows * bh, 4)).astype(np.float32)
    assert G.stored_slots == nb_rows * bh * grp * bw
    assert rel(G.matmat(torch.from_numpy(X)), np.asarray(Gj.matmat(jnp.asarray(X)))) <= 1e-5
    assert rel(G.matvec(torch.from_numpy(X[:, 0])), np.asarray(Gj.matvec(jnp.asarray(X[:, 0])))) <= 1e-5


def test_bsr_from_arrays_carries_the_jax_object():
    dense = random_dense(16, 100, 90)
    Aj, At = both_bsr(dense, (4, 8))
    g = Aj.graph
    Ac = convert.bsr_from_arrays(np.asarray(g.indptr), np.asarray(g.indices),
                                 np.asarray(g.block_rows), np.asarray(g.mask),
                                 np.asarray(Aj.data), g.shape, g.block_shape, device="cpu")
    assert_same_graph(g, Ac.graph)
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(90))
    assert torch.equal(Ac.matvec(x), At.matvec(x))
