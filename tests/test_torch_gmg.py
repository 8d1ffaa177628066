"""The port's structured pair-aggregation multigrid held against the JAX
package in f64: the same hierarchy (offsets, values, dinv, axes, lmax,
coarse inverse), the same V-cycle and FMG results, and the same GMG-CG
iteration counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu
from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix as JaxSym
from sigma_tpu.solvers import cg_solve as jax_cg
from sigma_tpu.solvers import structured_pair_amg as jax_amg
import sigma_tpu_torch as st
from sigma_tpu_torch.utils import to_numpy


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def stencil_coo(dims, weights=None):
    """Dirichlet Laplacian on ``dims``: -w_ax to each in-grid axis
    neighbour, 2 * sum(w) on the diagonal (w = 1 unless given)."""
    nd = len(dims)
    w = weights or (1.0,) * nd
    n = int(np.prod(dims))
    coords = np.unravel_index(np.arange(n), dims)
    strides = [int(np.prod(dims[ax + 1 :])) for ax in range(nd)]
    idx = np.arange(n)
    rows, cols, vals = [idx], [idx], [np.full(n, 2.0 * sum(w))]
    for ax in range(nd):
        for s in (1, -1):
            mk = (coords[ax] + s >= 0) & (coords[ax] + s < dims[ax])
            rows.append(idx[mk])
            cols.append(idx[mk] + s * strides[ax])
            vals.append(np.full(mk.sum(), -w[ax]))
    return n, np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def build_both(dims, symmetric=False, weights=None, **kw):
    n, r, c, v = stencil_coo(dims, weights)
    Aj = sigma_tpu.DIAMatrix.from_coo(n, n, r, c, v, dtype=jnp.float64)
    At = st.DIAMatrix.from_coo(n, n, r, c, v, dtype=torch.float64, device="cpu")
    if symmetric:
        Aj, At = JaxSym.from_dia(Aj), st.SymmetricDIAMatrix.from_dia(At)
    kwj = dict(kw)
    if kw.get("level_dtype") is not None:
        kwj["level_dtype"] = getattr(jnp, kw["level_dtype"])
        kw["level_dtype"] = getattr(torch, kw["level_dtype"])
    return Aj, At, jax_amg(Aj, dims, **kwj), st.structured_pair_amg(At, dims, **kw)


def _offsets(A):
    return tuple(A.offsets) if hasattr(A, "n") else tuple(A.graph.offsets)


def assert_same_hierarchy(Mj, Mt):
    assert len(Mt.levels) == len(Mj.levels) > 0
    assert (Mt.n_smooth, Mt.smoother) == (Mj.n_smooth, Mj.smoother)
    for lj, lt in zip(Mj.levels, Mt.levels):
        assert lt.dims == lj.dims and lt.axes == lj.axes and lt.omega == lj.omega
        assert type(lt.A).__name__ == type(lj.A).__name__
        assert _offsets(lt.A) == _offsets(lj.A)
        dj = np.asarray(lj.A.data2d)
        assert lt.A.dtype == getattr(torch, dj.dtype.name)
        assert rel(to_numpy(lt.A.data), dj.astype(np.float64)) <= 1e-12
        assert rel(lt.dinv.numpy(), np.asarray(lj.dinv)) <= 1e-12
        if lj.lmax is None:
            assert lt.lmax is None
        else:
            assert abs(float(lt.lmax) - float(lj.lmax)) <= 1e-12 * float(lj.lmax)
    assert rel(Mt.coarse_inv.numpy(), np.asarray(Mj.coarse_inv)) <= 1e-12


# (dims, options, compare FMG too); the JAX side of each compare is one
# jitted program, whose compile dominates this file's run time
CASES = {
    "cube16": ((16, 16, 16), {}, True),
    "odd_9x10x11": ((9, 10, 11), {}, True),
    "grid2d": ((20, 24), {}, False),
    "pairs3": ((16, 16, 16), {"pairs_per_level": 3}, False),
    "symmetric": ((12, 12, 12), {"symmetric": True, "pairs_per_level": 3}, False),
    "bf16_levels": (
        (12, 12, 12), {"symmetric": True, "level_dtype": "bfloat16"}, True,
    ),
    "chebyshev_strength": (
        (10, 12, 8), {"smoother": "chebyshev", "n_smooth": 3, "pair_by": "strength",
                      "weights": (1.0, 0.05, 1.0)}, False,
    ),
    "frozen_axis": ((8, 12, 10), {"freeze_axes": (0,), "coarse_size": 16}, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hierarchy_and_cycle_match_jax(case):
    dims, kw, with_fmg = CASES[case]
    Aj, At, Mj, Mt = build_both(dims, **kw)
    assert_same_hierarchy(Mj, Mt)
    r = np.random.default_rng(5).standard_normal(At.shape[0])
    rt, rj = torch.from_numpy(r), jnp.asarray(r)
    assert rel(Mt.matvec(rt), jax.jit(type(Mj).matvec)(Mj, rj)) <= 1e-12
    if with_fmg:
        assert rel(Mt.fmg(rt), jax.jit(type(Mj).fmg)(Mj, rj)) <= 1e-12


@pytest.mark.parametrize(
    "smoother,n_smooth", [("jacobi", 1), ("chebyshev", 4)]
)
def test_gmg_cg_iterations_match_jax(smoother, n_smooth):
    dims = (16, 16, 16)
    Aj, At, Mj, Mt = build_both(
        dims, symmetric=True, smoother=smoother, n_smooth=n_smooth, pairs_per_level=3
    )
    b = np.random.default_rng(0).standard_normal(At.shape[0])
    xj, ij = jax_cg(Aj, jnp.asarray(b), tol=0.0, rtol=1e-9, M=Mj)
    xt, it = st.cg_solve(At, torch.from_numpy(b), tol=0.0, rtol=1e-9, M=Mt)
    assert it.converged and bool(ij.converged)
    assert it.iterations == int(ij.iterations)
    assert it.iterations < 30  # the preconditioner is doing its job
    assert rel(xt, xj) <= 1e-10


@pytest.mark.parametrize("symmetric", [False, True])
def test_host_data_builds_the_same_hierarchy(symmetric):
    """``host_data`` (here the JAX package's (D, S, 128) value tiles)
    stands in for the copy of A's values to the host."""
    dims, kw = (12, 12, 12), dict(pairs_per_level=3, smoother="chebyshev")
    Aj, At, Mj, _ = build_both(dims, symmetric=symmetric, **kw)
    tiles = np.asarray(Aj.data)
    assert tiles.ndim == 3
    assert_same_hierarchy(Mj, st.structured_pair_amg(At, dims, host_data=tiles, **kw))
    # the values really come from host_data: twice them halve the coarse inverse
    M2 = st.structured_pair_amg(At, dims, host_data=2.0 * tiles, **kw)
    assert rel(2.0 * M2.coarse_inv.numpy(), np.asarray(Mj.coarse_inv)) <= 1e-12


def test_rejects_non_stencil():
    """A flat diagonal that wraps across grid lines with nonzero values is
    not a stencil for those dims (the JAX package's own case)."""
    n, dims = 64, (8, 8)
    i = np.arange(n)
    rows = np.concatenate([i, i[:-1]])
    cols = np.concatenate([i, i[:-1] + 1])
    vals = np.concatenate([np.full(n, 2.0), np.full(n - 1, -1.0)])
    A = st.DIAMatrix.from_coo(n, n, rows, cols, vals, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="stencil"):
        st.structured_pair_amg(A, dims)
    with pytest.raises(ValueError, match="do not tile"):
        st.structured_pair_amg(A, (8, 9))
    with pytest.raises(ValueError, match="smoother"):
        st.structured_pair_amg(A, dims, smoother="sor")
