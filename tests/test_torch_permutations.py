"""The port's breadth-first ordering held against the JAX package's: the
same permutation from the host library and from the plain numpy version,
on the cases of the reference's own tests (a random symmetric graph, a
path graph, a disconnected graph, a start vertex > 0) and on every graph
format.  Then the greedy colouring and colour ordering: the same colours
and permutation as the JAX package's on a nonsymmetric random graph of
every format and on the 7-point stencil, and the host colouring equal to
its plain numpy version."""

import numpy as np
import pytest

from sigma_tpu.graph import GraphBuilder as JaxBuilder
from sigma_tpu.graph import build_graph as jax_build_graph
from sigma_tpu.graph import graph as jax_graph
from sigma_tpu.graph.permutations import breadth_first_search as jax_bfs
import sigma_tpu_torch as st
from sigma_tpu_torch import native
from sigma_tpu_torch.graph.permutations import breadth_first_search_reference

from test_torch_jax_host import jax_host_library

jax_host_library()  # the bit-for-bit checks need the JAX host library, not its fallback


def both_graphs(n, edges):
    """The port's and the JAX package's CSR graphs of an edge list."""
    b, bj = st.GraphBuilder(n), JaxBuilder(n)
    for i, j in edges:
        b.add_edge(i, j)
        bj.add_edge(i, j)
    return st.build_graph(b, "csr"), jax_build_graph(bj, "csr")


def path_edges(n):
    return [e for i in range(n - 1) for e in ((i, i + 1), (i + 1, i))] + [
        (i, i) for i in range(n)
    ]


def check(g, gj, start, want=None):
    """Host ordering == numpy version == the JAX package's (== ``want``)."""
    p = st.breadth_first_search(g, start)
    assert np.array_equal(p, jax_bfs(gj, start))
    assert np.array_equal(p, breadth_first_search_reference(g.indptr, g.indices, start))
    assert np.array_equal(np.sort(p), np.arange(g.shape[0]))
    if want is not None:
        assert np.array_equal(p, want)
    return p


@pytest.mark.parametrize("start", [0, 17])
def test_bfs_of_a_random_graph_is_the_jax_packages(start):
    rng = np.random.default_rng(0)
    n = 50
    d = rng.random((n, n)) < 0.1
    d = d | d.T | np.eye(n, dtype=bool)
    g, gj = both_graphs(n, zip(*np.nonzero(d)))
    check(g, gj, start)


def test_bfs_of_a_path_graph_is_the_identity():
    g, gj = both_graphs(10, path_edges(10))
    check(g, gj, 0, want=np.arange(10))


@pytest.mark.parametrize(
    "start, want", [(0, [0, 1, 2, 3, 4, 5]), (4, [2, 3, 4, 5, 0, 1])], ids=["0", "4"]
)
def test_bfs_restarts_at_the_lowest_unvisited_vertex(start, want):
    g, gj = both_graphs(6, [(0, 1), (1, 0), (4, 5), (5, 4)])
    check(g, gj, start, want=np.array(want))


def test_bfs_from_a_start_after_zero():
    g, gj = both_graphs(10, path_edges(10))
    # from 3: 3, then 2 and 4, then 1 and 5, then 0 and 6, then 7, 8, 9
    check(g, gj, 3, want=np.array([5, 3, 1, 0, 2, 4, 6, 7, 8, 9]))


@pytest.mark.parametrize("fmt", ["CSRGraph", "COOGraph", "CSCGraph", "ELLGraph"])
def test_bfs_of_a_graph_of_any_format_is_the_jax_packages(fmt):
    rng = np.random.default_rng(3)
    n, k = 300, 1200
    r, c = rng.integers(0, n, k), rng.integers(0, n, k)
    rows, cols = np.r_[r, c, np.arange(n)], np.r_[c, r, np.arange(n)]
    p = st.breadth_first_search(getattr(st, fmt).from_coo(n, n, rows, cols), 5)
    assert np.array_equal(p, jax_bfs(getattr(jax_graph, fmt).from_coo(n, n, rows, cols), 5))
    csr = st.CSRGraph.from_coo(n, n, rows, cols)
    assert np.array_equal(native.bfs_order(csr.indptr, csr.indices, 5),
                          breadth_first_search_reference(csr.indptr, csr.indices, 5))
    with pytest.raises(ValueError, match="square"):
        st.breadth_first_search(getattr(st, fmt).from_coo(n, n + 1, rows, cols))
    with pytest.raises(ValueError, match="out of range"):
        st.breadth_first_search(csr, n)


# -- greedy colouring (tests/test_solvers.py:382's ordering) -----------------
from sigma_tpu.graph.permutations import greedy_color_ordering as jax_color_ordering  # noqa: E402
from sigma_tpu.graph.permutations import greedy_coloring as jax_coloring  # noqa: E402
from sigma_tpu_torch.graph.permutations import greedy_coloring_reference  # noqa: E402


def _valid_coloring(g, colors):
    r, c = g.edges_numpy()
    off = r != c
    return not np.any(colors[r[off]] == colors[c[off]])


@pytest.mark.parametrize("fmt", ["CSRGraph", "COOGraph", "CSCGraph", "ELLGraph"])
def test_coloring_of_a_random_graph_is_the_jax_packages(fmt):
    rng = np.random.default_rng(4)
    n, k = 200, 700
    rows, cols = rng.integers(0, n, k), rng.integers(0, n, k)  # nonsymmetric
    g = getattr(st, fmt).from_coo(n, n, rows, cols)
    colors, nc = st.greedy_coloring(g)
    want, ncj = jax_coloring(getattr(jax_graph, fmt).from_coo(n, n, rows, cols))
    assert nc == ncj and np.array_equal(colors, want)
    assert colors.max() + 1 == nc and _valid_coloring(g, colors)
    sym = st.CSRGraph.from_coo(n, n, np.r_[rows, cols], np.r_[cols, rows])
    assert np.array_equal(native.greedy_coloring(sym.indptr, sym.indices)[0],
                          greedy_coloring_reference(sym.indptr, sym.indices)[0])


@pytest.mark.parametrize("nx", [5, 8])
def test_stencil_takes_two_colours_and_the_ordering_blocks_them(nx):
    """The 7-point stencil's nonzeros form a bipartite graph: first fit in
    natural order gives the checkerboard, and the ordering puts each colour
    in one block.  (DIA storage's graph also joins the zero slots where a
    +-1 diagonal wraps to the next grid line, which at even nx joins two
    cells of one colour: the stencil is coloured on its nonzeros.)"""
    r, c, v = st.laplacian_3d_dia(nx, device="cpu").entries()
    keep = v != 0
    n = nx ** 3
    g = st.CSRGraph.from_coo(n, n, r[keep], c[keep])
    colors, nc = st.greedy_coloring(g)
    assert nc == 2 and _valid_coloring(g, colors)
    p, ptr = st.greedy_color_ordering(g)
    pj, ptrj = jax_color_ordering(jax_graph.CSRGraph.from_coo(n, n, r[keep], c[keep]))
    assert np.array_equal(p, pj) and np.array_equal(ptr, ptrj)
    assert np.array_equal(np.sort(p), np.arange(n))
    assert np.array_equal(ptr, [0, np.sum(colors == 0), n])
    assert np.all(colors[np.argsort(p)][: ptr[1]] == 0)


def test_coloring_needs_a_square_graph():
    with pytest.raises(ValueError, match="square"):
        st.greedy_coloring(st.CSRGraph.from_coo(3, 4, [0, 1], [1, 3]))


def _mesh_graph(seed):
    n, r, c, _ = st.irregular_mesh_laplacian_coo(9, 13, rng=np.random.default_rng(seed),
                                                 shuffle=True)
    return st.CSRGraph.from_coo(n, n, r, c)


def _components_graph():
    """A path, a 4-cycle, an isolated vertex and a small torus, interleaved
    in the labels."""
    g = st.apps.torus(3, 4)
    rt, ct = g.edges_numpy()
    rows = [np.r_[0, 1, 1, 2], np.r_[3, 4, 5, 6, 4, 5, 6, 3], rt + 8]
    cols = [np.r_[1, 0, 2, 1], np.r_[4, 5, 6, 3, 3, 4, 5, 6], ct + 8]
    n = 8 + 12
    shuffle = np.random.default_rng(5).permutation(n)
    r, c = shuffle[np.concatenate(rows)], shuffle[np.concatenate(cols)]
    return st.CSRGraph.from_coo(n, n, r, c)


@pytest.mark.parametrize("make", [lambda: st.apps.torus(9, 7), lambda: st.apps.torus(16, 16),
                                  lambda: _mesh_graph(0), lambda: _mesh_graph(1),
                                  _components_graph],
                         ids=["torus9x7", "torus16", "mesh0", "mesh1", "components"])
def test_sloan_order_is_the_jax_packages(make):
    import sigma_tpu.native as jax_native

    g = make()
    ip, ix = g.indptr, g.indices[: g.nnz]
    p = native.sloan_order(ip, ix)
    assert np.array_equal(p, jax_native.sloan_order(ip, ix))
    assert np.array_equal(np.sort(p), np.arange(g.shape[0]))
