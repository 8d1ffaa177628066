"""``graphed(cg_solve)`` and ``graphed(cg_fused_solve)`` with ILDU as M, on
the CPU in f64: ILDU(0), ILU(1), colour-ordered ILDU(0) (applied through
the permutation, as ``benchmarks/ildu3d.py``'s operator is solved in
``chip_smoke.py``'s phase 30) and the block ILDU of an 8-shard mesh.  The
plain version of the captured loop is held bit for bit against the eager
solve (x, iteration count, residual norm, ``converged``, history, one host
read a block) and against the JAX package's jitted solve with
``LDUSolver(level=k).setup`` (or its ``distributed_block_ildu`` on the 8
virtual devices of ``tests/conftest.py``): equal counts, x within 1e-10
relative.  Both packages' factors come from the same numpy triples of
the 7-point Laplacian + I at nx = 8 (22 + 22 levels in natural order).

Last, the level sweep's plain version and ``TriangularLevels.solve``
against the JAX package's ``TriangularLevels.solve`` (the per-shard
sweep for the block ILDU) on every level pack of those factors, within
rounding."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu as sj
import sigma_tpu.parallel as jp
import sigma_tpu.solvers as js
from sigma_tpu.solvers.ildu import LDUSolver, TriangularLevels as JaxLevels
import sigma_tpu_torch as st
import sigma_tpu_torch.parallel as tp
from sigma_tpu_torch.ops import level_sweep, level_sweep_reference
from sigma_tpu_torch.solvers.graphed import BLOCK

NX = 8
N = NX ** 3
SHARDS = 8
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@functools.lru_cache(maxsize=None)
def triples():
    """COO triples of the 7-point Laplacian + I on the nx^3 grid (7 on the
    diagonal, -1 to each in-grid neighbour), x fastest."""
    g = np.arange(N).reshape(NX, NX, NX)
    r, c = [g.ravel()], [g.ravel()]
    for ax in range(3):
        lo = np.take(g, np.arange(NX - 1), axis=ax).ravel()
        hi = np.take(g, np.arange(1, NX), axis=ax).ravel()
        r += [lo, hi]
        c += [hi, lo]
    r, c = np.concatenate(r), np.concatenate(c)
    v = np.where(r == c, 7.0, -1.0)
    return r, c, v


@functools.lru_cache(maxsize=None)
def colouring():
    r, c, v = triples()
    C = st.CSRMatrix.from_coo(N, N, r, c, v, dtype=torch.float64, device="cpu")
    p, ptr = st.greedy_color_ordering(C.graph)
    pj, ptrj = sj.greedy_color_ordering(sj.CSRMatrix.from_coo(N, N, r, c, v).graph)
    assert np.array_equal(p, pj) and np.array_equal(ptr, ptrj) and ptr.size - 1 == 2
    return p


@functools.lru_cache(maxsize=None)
def operators(kind):
    """(A, M) of the port and of the JAX package: A the DIA operator (the
    ELL ring blocks of an 8-shard mesh for the block ILDU), M the
    preconditioner of ``kind``."""
    r, c, v = triples()
    A = st.DIAMatrix.from_coo(N, N, r, c, v, dtype=torch.float64, device="cpu")
    Aj = sj.DIAMatrix.from_coo(N, N, r, c, v, dtype=jnp.float64)
    if kind == "block":
        C = st.CSRMatrix.from_coo(N, N, r, c, v, dtype=torch.float64, device="cpu")
        Cj = sj.CSRMatrix.from_coo(N, N, r, c, v, dtype=jnp.float64)
        assert len(jax.devices()) >= SHARDS, "conftest must provide 8 virtual devices"
        mesh, jmesh = tp.make_mesh(SHARDS, device="cpu"), jp.make_mesh(SHARDS)
        return (tp.distribute_matrix(C, mesh), tp.distributed_block_ildu(C, mesh),
                jp.distribute_matrix(Cj, jmesh), jp.distributed_block_ildu(Cj, jmesh))
    if kind == "colored":
        p = colouring()
        C = st.CSRMatrix.from_coo(N, N, p[r], p[c], v, dtype=torch.float64, device="cpu")
        Cj = sj.CSRMatrix.from_coo(N, N, p[r], p[c], v, dtype=jnp.float64)
        Mc, Mcj = st.ldu().setup(C), LDUSolver(level=0).setup(Cj)
        assert (Mc.lower.nlev, Mc.upper.nlev) == (Mcj.lower.nlev, Mcj.upper.nlev) == (2, 2)
        # M = P^T Mc P: r in new labels is r[inv], z back in old labels z[p]
        pt = torch.from_numpy(p)
        M = st.MatvecOperator(params=(Mc, pt, torch.argsort(pt)),
                              mv=lambda q, x: q[0].matvec(x[q[2]])[q[1]], rmv=None,
                              shape=A.shape)
        pj = jnp.asarray(p)
        Mj = sj.MatvecOperator(params=(Mcj, pj, jnp.argsort(pj)),
                               mv=lambda q, x: q[0].matvec(x[q[2]])[q[1]], rmv=None,
                               shape=Aj.shape)
        return A, M, Aj, Mj
    level = {"ildu0": 0, "ilu1": 1}[kind]
    C = st.CSRMatrix.from_coo(N, N, r, c, v, dtype=torch.float64, device="cpu")
    Cj = sj.CSRMatrix.from_coo(N, N, r, c, v, dtype=jnp.float64)
    M, Mj = st.ldu(level=level).setup(C), LDUSolver(level=level).setup(Cj)
    if kind == "ildu0":
        assert (M.lower.nlev, M.upper.nlev) == (3 * NX - 2, 3 * NX - 2)
    assert (M.lower.nlev, M.upper.nlev) == (Mj.lower.nlev, Mj.upper.nlev)
    return A, M, Aj, Mj


def _assert_same(got, want):
    (x, info), (y, ref) = got, want
    assert torch.equal(x, y)
    assert info.iterations == ref.iterations
    assert torch.equal(info.residual_norm, ref.residual_norm)
    assert info.converged == ref.converged
    if ref.history is None:
        assert info.history is None
    else:
        assert torch.equal(info.history.nan_to_num(-1.0), ref.history.nan_to_num(-1.0))


SOLVERS = {"cg": (st.cg_solve, js.cg_solve), "cg_fused": (st.cg_fused_solve, js.cg_fused_solve)}
KINDS = ("ildu0", "ilu1", "colored", "block")


@pytest.mark.parametrize("history", [False, True], ids=["", "history"])
@pytest.mark.parametrize("solver", sorted(SOLVERS))
@pytest.mark.parametrize("kind", KINDS)
def test_graphed_ildu_equals_eager_and_matches_jax(kind, solver, history):
    ft, fj = SOLVERS[solver]
    A, M, Aj, Mj = operators(kind)
    r, c, v = triples()
    b = np.zeros(N)
    np.add.at(b, r, v * np.sin(0.001 * np.arange(N))[c])  # b = A x*, as the benchmarks
    bt = torch.from_numpy(b)
    kw = dict(tol=0.0, rtol=RTOL, M=M, history=history)

    G = st.graphed(ft)
    before = level_sweep.launches
    got = G(A, bt, **kw)
    want = ft(A, bt, **kw)
    _assert_same(got, want)
    x, info = got
    assert info.converged and info.iterations > 0
    assert G.host_reads == max(1, -(-info.iterations // BLOCK))
    assert not G.captured  # the CPU runs the plain version
    assert level_sweep.launches == before  # and the sweep's plain version
    _assert_same(G(A, bt, **kw), want)  # a second call, the same bits

    xj, ij = jax.jit(lambda A_, b_, M_: fj(A_, b_, tol=0.0, rtol=RTOL, M=M_))(
        Aj, jnp.asarray(b), Mj)
    assert info.iterations == int(ij.iterations)
    assert info.converged == bool(ij.converged)
    assert rel(x, xj) <= 1e-10


def _jax_sweeps(kind):
    """(forward, backward) of the JAX package's factors of ``kind``: each
    b (n,) -> x through its ``TriangularLevels.solve``; for the block ILDU
    the shards' sweeps of its ``shard_map`` program side by side."""
    Mj = operators(kind)[3]
    if kind == "colored":
        Mj = Mj.params[0]
    if kind != "block":
        return [lambda b, vdt, T=T: JaxLevels(rows=T.rows, cols=T.cols, vals=T.vals.astype(vdt),
                                              n=T.n).solve(b)
                for T in (Mj.lower, Mj.upper)]

    def blocks(rows, cols, vals):
        def sweep(b, vdt):
            B = b.reshape(rows.shape[0], Mj.block)
            return jnp.concatenate([
                JaxLevels(rows=rows[s], cols=cols[s], vals=vals[s].astype(vdt),
                          n=Mj.block).solve(B[s]) for s in range(rows.shape[0])])
        return sweep

    return [blocks(Mj.l_rows, Mj.l_cols, Mj.l_vals), blocks(Mj.u_rows, Mj.u_cols, Mj.u_vals)]


@pytest.mark.parametrize("kind", KINDS)
def test_level_sweep_reference_matches_the_jax_sweep(kind):
    """Every level pack of the four factorizations (forward and backward,
    f64 and f32 values with f32 and f64 vectors): the plain version, and
    ``TriangularLevels.solve`` on the CPU, against the JAX package's
    sweep of the same factors (its ``fori_loop`` over the levels) within
    1e-12 relative with an f64 vector, 1e-5 with an f32 one; the two
    packages add a row's terms in their own order."""
    M = operators(kind)[1]
    if kind == "colored":
        M = M.params[0]
    rng = np.random.default_rng(27)
    for T, sweep in zip((M.lower, M.upper), _jax_sweeps(kind)):
        for vdt, xdt, tol in ((torch.float64, torch.float64, 1e-12),
                              (torch.float32, torch.float32, 1e-5),
                              (torch.float32, torch.float64, 1e-12)):
            vals = T.vals.to(vdt)
            bn = rng.standard_normal(T.n)
            b = torch.from_numpy(bn).to(xdt)
            Tc = st.TriangularLevels(rows=T.rows, cols=T.cols, vals=vals,
                                     level_ptr=T.level_ptr, n=T.n)
            x = level_sweep_reference(T.rows, T.cols, vals, Tc._ptr, b)
            assert x.dtype == xdt and torch.equal(Tc.solve(b), x)
            want = sweep(jnp.asarray(b.numpy()), jnp.dtype(str(vdt).split(".")[1]))
            assert want.dtype == jnp.dtype(str(xdt).split(".")[1])
            assert rel(x, want) <= tol


def test_level_sweep_on_the_cpu_edge_cases():
    """Empty levels leave the sweep's bits unchanged; n = 0 gives an empty
    x; mismatched operands raise."""
    T = operators("ildu0")[1].lower
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(T.n))
    p = list(T.level_ptr)
    padded = torch.tensor([0] + p[:3] + [p[3]] * 3 + p[3:] + [p[-1]])
    want = level_sweep(T.rows, T.cols, T.vals, T._ptr, b, T._max_rows)
    assert torch.equal(level_sweep(T.rows, T.cols, T.vals, padded, b, T._max_rows), want)
    e = torch.empty(0, dtype=torch.int64)
    z = level_sweep(e, e.view(0, 1), torch.empty(0, 1, dtype=torch.float64),
                    torch.zeros(2, dtype=torch.int64), torch.empty(0, dtype=torch.float64), 0)
    assert z.shape == (0,)
    with pytest.raises(ValueError, match="want rows"):
        level_sweep(T.rows, T.cols, T.vals, T._ptr, b[:-1], T._max_rows)
    with pytest.raises(TypeError, match="int64"):
        level_sweep(T.rows, T.cols, T.vals, T._ptr.int(), b, T._max_rows)
