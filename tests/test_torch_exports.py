"""Public names and accessors of the port held against the JAX package:
``compress_coo`` from the graph subpackage, ``num_graph_types`` and
``num_matrix_types`` at the top level, and the ``data2d`` view of full and
symmetric DIA storage.  Inputs are made once in numpy and go to both
packages on the CPU in f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu
import sigma_tpu.graph
from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix as JaxSym
import sigma_tpu_torch as st
import sigma_tpu_torch.graph


@pytest.mark.parametrize("dedup", [True, False])
def test_compress_coo_matches_jax(dedup):
    rng = np.random.default_rng(11)
    n, m = 37, 53
    rows = rng.integers(0, n, 400)
    cols = rng.integers(0, m, 400)
    rows = np.concatenate([rows, rows[:60]])  # repeated edges
    cols = np.concatenate([cols, cols[:60]])
    got = sigma_tpu_torch.graph.compress_coo(rows, cols, n, m, dedup=dedup)
    want = sigma_tpu.graph.compress_coo(rows, cols, n, m, dedup=dedup)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].size == (np.unique(rows * m + cols).size if dedup else rows.size)


@pytest.mark.parametrize("name", ["num_graph_types", "num_matrix_types"])
def test_format_counts_at_the_top_level(name):
    assert name in st.__dict__
    assert getattr(st, name) == getattr(sigma_tpu, name)


def _dia_coo(rng, n, m, offsets):
    rows, cols = [], []
    for o in offsets:
        r = np.arange(max(0, -o), min(n, m - o))
        rows.append(r)
        cols.append(r + o)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return rows, cols, rng.standard_normal(rows.size)


@pytest.mark.parametrize(
    "n,m,offsets",
    [(300, 300, (-17, -1, 0, 1, 17)), (260, 190, (-40, 0, 3, 100)), (150, 333, (-5, 0, 2, 180))],
    ids=["square", "tall", "wide"],
)
def test_dia_data2d_matches_jax(n, m, offsets):
    rng = np.random.default_rng(n + m)
    r, c, v = _dia_coo(rng, n, m, offsets)
    Aj = sigma_tpu.DIAMatrix.from_coo(n, m, r, c, v, dtype=jnp.float64)
    At = st.DIAMatrix.from_coo(n, m, r, c, v, dtype=torch.float64, device="cpu")
    assert tuple(At.data2d.shape) == tuple(Aj.data2d.shape)
    np.testing.assert_array_equal(At.data2d.numpy(), np.asarray(Aj.data2d))
    assert At.data2d.data_ptr() == At.data.data_ptr()  # a view, not a copy


def test_symmetric_dia_data2d_matches_jax():
    rng = np.random.default_rng(5)
    n, offsets = 333, (0, 2, 7, 130)
    rows, cols, vals = [], [], []
    for o in offsets:
        i = np.arange(n - o)
        w = rng.standard_normal(n - o)
        rows += [i, i + o] if o else [i]
        cols += [i + o, i] if o else [i]
        vals += [w, w] if o else [w]
    r, c, v = (np.concatenate(a) for a in (rows, cols, vals))
    Sj = JaxSym.from_dia(sigma_tpu.DIAMatrix.from_coo(n, n, r, c, v, dtype=jnp.float64))
    St = st.SymmetricDIAMatrix.from_dia(
        st.DIAMatrix.from_coo(n, n, r, c, v, dtype=torch.float64, device="cpu"))
    assert tuple(St.data2d.shape) == tuple(Sj.data2d.shape)
    np.testing.assert_array_equal(St.data2d.numpy(), np.asarray(Sj.data2d))
    assert St.data2d.data_ptr() == St.data.data_ptr()
