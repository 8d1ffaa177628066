"""``graphed(bicgstab_solve)`` and ``graphed(gmres_solve)`` on the CPU: the
plain version of the captured loop (BiCG-stab in blocks of iterations over
two buffer sets, GMRES one restart cycle a replay) held bit for bit against
the eager solvers (x, iteration count, residual norm, ``converged``,
history) and against the JAX package's jitted solves as
``benchmarks/adv3d.py`` calls them (equal counts, x within 1e-10
relative), on the upwinded advection-diffusion stencil in f64, with no
preconditioner, Jacobi and structured GMG.  Also GMRES's Givens update
(the plain version of its kernel) against the host arithmetic it
replaced."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu
import sigma_tpu.solvers as js
import sigma_tpu_torch as st
from sigma_tpu_torch.ops import givens_update, givens_update_reference
from sigma_tpu_torch.solvers.graphed import BLOCK


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


class Counted:
    """``A`` with its matvecs counted: a GMRES solve makes one a step, one
    a cycle and one at set-up, so the count gives the cycles."""

    def __init__(self, A):
        self.A, self.shape, self.calls = A, A.shape, 0

    def matvec(self, x):
        self.calls += 1
        return self.A.matvec(x)


@functools.lru_cache(maxsize=None)
def operators(nx, precond):
    """The upwinded advection-diffusion stencil (beta 10) on nx^3 in both
    packages, and the preconditioner in each (None, Jacobi or structured
    GMG with three pairings a level)."""
    A = st.advection_diffusion_dia(nx, 10.0, torch.float64, device="cpu")
    n = A.shape[0]
    Aj = sigma_tpu.DIAMatrix.from_coo(n, n, *A.entries(), dtype=jnp.float64)
    if precond is None:
        return A, Aj, None, None
    if precond == "jacobi":
        return A, Aj, st.jacobi().setup(A), js.jacobi().setup(Aj)
    dims = (nx,) * 3
    return (A, Aj, st.structured_amg(dims, pairs_per_level=3).setup(A),
            js.structured_amg(dims, pairs_per_level=3).setup(Aj))


SOLVERS = {"bicgstab": (st.bicgstab_solve, js.bicgstab_solve),
           "gmres": (st.gmres_solve, js.gmres_solve)}

# name: (solver, nx, preconditioner, keywords, x0, zero b)
CASES = {
    "bicgstab_plain": ("bicgstab", 8, None, {}, False, False),
    "bicgstab_jacobi": ("bicgstab", 10, "jacobi", {}, False, False),
    "bicgstab_gmg": ("bicgstab", 8, "gmg", {}, False, False),
    "bicgstab_history_jacobi": ("bicgstab", 6, "jacobi", {"history": True}, False, False),
    "bicgstab_x0_gmg": ("bicgstab", 6, "gmg", {}, True, False),
    # converges past the first block, maxiter not a multiple of it
    "bicgstab_past_one_block": ("bicgstab", 10, None,
                                {"rtol": 1e-13, "maxiter": 1000, "history": True}, False, False),
    # stopped unconverged by maxiter, in the first block and in the second
    "bicgstab_maxiter_below_block": ("bicgstab", 8, "jacobi", {"maxiter": 5}, False, False),
    "bicgstab_unconverged_at_maxiter": ("bicgstab", 10, None,
                                        {"rtol": 1e-15, "maxiter": BLOCK + 5}, False, False),
    "bicgstab_zero_rhs": ("bicgstab", 6, "jacobi", {}, False, True),
    "gmres8_plain": ("gmres", 8, None, {"restart": 8}, False, False),
    "gmres8_jacobi": ("gmres", 8, "jacobi", {"restart": 8}, False, False),
    "gmres32_plain": ("gmres", 10, None, {"restart": 32}, False, False),
    "gmres32_jacobi": ("gmres", 8, "jacobi", {"restart": 32}, False, False),
    "gmres8_x0_gmg": ("gmres", 6, "gmg", {"restart": 8}, True, False),
    # stopped by maxiter in the middle of the second cycle
    "gmres8_maxiter_mid_cycle": ("gmres", 8, None, {"restart": 8, "rtol": 1e-14, "maxiter": 13},
                                 False, False),
    "gmres32_zero_rhs": ("gmres", 6, None, {"restart": 32}, False, True),
}


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


@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_nonsym_equals_eager_and_matches_jax(case):
    solver, nx, precond, kw, with_x0, zero_b = CASES[case]
    ft, fj = SOLVERS[solver]
    A, Aj, M, Mj = operators(nx, precond)
    n = A.shape[0]
    rng = np.random.default_rng(nx)
    b = np.zeros(n) if zero_b else rng.standard_normal(n)
    x0 = rng.standard_normal(n) if with_x0 else None
    kw = {"tol": 0.0, "rtol": 1e-10, **kw}
    bt = torch.from_numpy(b)
    x0t = None if x0 is None else torch.from_numpy(x0.copy())

    G = st.graphed(ft)
    Ac = Counted(A)
    want = ft(Ac, bt, x0t, M=M, **kw)
    eager_matvecs = Ac.calls
    got = G(A, bt, x0t, M=M, **kw)
    _assert_same(got, want)
    x, info = got
    if solver == "gmres":
        cycles = eager_matvecs - 1 - info.iterations
        assert cycles == (0 if zero_b else -(-info.iterations // kw["restart"]))
        assert G.host_reads == max(1, cycles)  # one read a restart cycle
    else:
        assert G.host_reads == max(1, -(-info.iterations // BLOCK))
    assert not G.captured  # the CPU runs the plain version
    if x0 is not None:
        assert np.array_equal(x0t.numpy(), x0)  # the buffers are copies
    _assert_same(G(A, bt, x0t, M=M, **kw), want)  # a second call, the same bits

    jx0 = None if x0 is None else jnp.asarray(x0)
    xj, ij = jax.jit(lambda b, x0: fj(Aj, b, x0, M=Mj, **kw))(jnp.asarray(b), jx0)
    assert info.iterations == int(ij.iterations)
    assert info.converged == bool(ij.converged)
    assert rel(x, xj) <= 1e-10
    if zero_b:
        assert info.iterations == 0 and info.converged
    if kw.get("maxiter") not in (None, 1000):
        assert info.iterations == kw["maxiter"] and not info.converged
    if "past_one_block" in case:
        assert BLOCK < info.iterations < kw["maxiter"] and info.converged
    if case.startswith("gmres8") and not zero_b:
        assert info.iterations > 8  # more than one cycle


def _host_givens(h, R, cs, sn, g, j):
    """The host arithmetic the device update replaced (numpy scalars in
    the arrays' dtype)."""
    for i in range(j):
        c, s = cs[i], sn[i]
        h[i], h[i + 1] = c * h[i] + s * h[i + 1], -s * h[i] + c * h[i + 1]
    denom = np.sqrt(h[j] * h[j] + h[j + 1] * h[j + 1])
    if denom > 0:
        cs[j], sn[j] = h[j] / denom, h[j + 1] / denom
    else:
        cs[j], sn[j] = 1.0, 0.0
    gj = g[j]
    g[j], g[j + 1] = cs[j] * gj, -sn[j] * gj
    R[:j, j] = h[:j]
    R[j, j] = denom


def _state(m, dtype, bdtype=None):
    """(h1, h2, wn, eps10, h, d, R, cs, sn, g, est, inner, jdev) of a fresh
    cycle: the projections' placeholders empty, g[0] = 2.5."""
    sdt = torch.float64 if dtype == torch.float64 else torch.float32
    bdt = bdtype or dtype
    z = functools.partial(torch.zeros, dtype=sdt)
    eps10 = torch.tensor(torch.finfo(bdt).eps, dtype=sdt) * 10
    g = z(m + 1)
    g[0] = 2.5
    return [None, None, None, eps10, z(m + 1), torch.zeros((), dtype=bdt), z(m, m), z(m), z(m),
            g, z(()), torch.zeros((), dtype=torch.bool), torch.zeros((), dtype=torch.int64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_givens_update_plain_version_equals_the_host_arithmetic(dtype):
    """A whole cycle of m = 8 steps on random projections (one step with a
    zero ||w||, one all zero): the column h = [h1 + h2, ||w||] and the
    divisor, R, cs, sn, g bit for bit, the estimate, the predicate and the
    step count."""
    m, maxiter, k = 8, 100, 95
    rng = np.random.default_rng(3)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    eps10 = npdt(np.finfo(npdt).eps) * npdt(10)
    R, cs, sn, g = (np.zeros(s, npdt) for s in ((m, m), m, m, m + 1))
    g[0] = npdt(2.5)
    Rt, cst, snt, gt = (torch.from_numpy(a.copy()) for a in (R, cs, sn, g))
    ht, dt = torch.zeros(m + 1, dtype=dtype), torch.zeros((), dtype=dtype)
    est, jdev = torch.zeros((), dtype=dtype), torch.zeros((), dtype=torch.int64)
    inner = torch.zeros((), dtype=torch.bool)
    kt, tol = torch.tensor(k), torch.tensor(1e-3, dtype=dtype)
    for j in range(m):
        h1, h2 = rng.standard_normal((2, j + 1)).astype(npdt)
        wn = npdt(abs(rng.standard_normal()))
        if j == 3:
            wn = npdt(0)
        if j == 5:
            h1[:], h2[:], wn = 0, 0, npdt(0)
        h = np.zeros(j + 2, npdt)
        h[: j + 1] = h1 + h2
        h[j + 1] = wn if wn > eps10 else 0
        want_h, want_d = h.copy(), (wn if wn > eps10 else np.inf)
        _host_givens(h, R, cs, sn, g, j)
        givens_update(torch.from_numpy(h1), torch.from_numpy(h2), torch.tensor(wn),
                      torch.tensor(eps10), ht, dt, Rt, cst, snt, gt, est, inner, jdev, kt, tol, j,
                      maxiter)
        assert np.array_equal(ht[: j + 2].numpy(), want_h) and float(dt) == want_d
        for got, want in ((Rt, R), (cst, cs), (snt, sn), (gt, g)):
            assert np.array_equal(got.numpy(), want)
        assert float(est) == abs(float(g[j + 1]))
        assert bool(inner) == (abs(g[j + 1]) > 1e-3 and j + 1 < m and k + j + 1 < maxiter)
        assert int(jdev) == j + 1
    assert givens_update.launches == 0  # the CPU runs the plain version


def _old_tail(h1, h2, wn, j, eps10):
    """The CGS2 column's tail as the solver ran it before the kernel took
    it: the column in the small dtype, breakdown applied, and the divisor."""
    h = torch.cat([h1 + h2, wn[None]]).to(eps10.dtype)
    ok = h[j + 1] > eps10
    d = torch.where(ok, wn, torch.full_like(wn, math.inf))
    h[j + 1] *= ok
    return h, d


def _old_update(h, R, cs, sn, g, est, inner, jdev, k, tol, j, maxiter):
    """The Givens update's plain version before the kernel took the tail."""
    m = R.shape[0]
    cur = h[0]
    for i in range(j):
        c, s, nxt = cs[i], sn[i], h[i + 1]
        R[i, j] = c * cur + s * nxt
        cur = -s * cur + c * nxt
    low = h[j + 1]
    denom = torch.sqrt(cur * cur + low * low)
    safe = denom > 0
    one = torch.ones_like(denom)
    c = torch.where(safe, cur / torch.where(safe, denom, one), one)
    s = torch.where(safe, low / torch.where(safe, denom, one), torch.zeros_like(denom))
    cs[j] = c
    sn[j] = s
    gj = g[j].clone()
    g[j + 1] = -s * gj
    g[j] = c * gj
    R[j, j] = denom
    est.copy_(g[j + 1].abs())
    inner.copy_((est > tol) & (j + 1 < m) & (k + (j + 1) < maxiter))
    jdev.fill_(j + 1)


@pytest.mark.parametrize("bdtype", [torch.float32, torch.float64, torch.bfloat16, torch.float16],
                         ids=str)
def test_givens_update_plain_version_equals_the_old_tail_and_update(bdtype):
    """The plain version against the solver's old tail ops followed by the
    old plain update, bit for bit, over a cycle of m = 12 steps in each of
    b's dtypes: a zero ||w||, a breakdown (0 < ||w|| <= eps10: h[j + 1] = 0,
    divisor inf), ||w|| just above eps10, an all-zero column; then the
    basis row w / d the same."""
    m, maxiter = 12, 50
    rng = np.random.default_rng(29)
    new = _state(m, bdtype)
    old = _state(m, bdtype)
    eps10 = new[3]
    k, tol = torch.tensor(40), torch.tensor(1e-4, dtype=eps10.dtype)
    for j in range(m):
        h1, h2 = (torch.from_numpy(a).to(bdtype) for a in rng.standard_normal((2, j + 1)))
        wn = torch.tensor(abs(rng.standard_normal())).to(bdtype)
        if j == 2:
            wn = torch.zeros((), dtype=bdtype)
        if j == 4:
            wn = (eps10 / 2).to(bdtype)  # a breakdown, though not zero
        if j == 6:
            wn = (eps10 * 2).to(bdtype)
        if j == 8:
            h1, h2, wn = h1 * 0, h2 * 0, wn * 0
        givens_update(h1, h2, wn, *new[3:], k, tol, j, maxiter)
        h, d = _old_tail(h1, h2, wn, j, eps10)
        _old_update(h, *old[6:], k, tol, j, maxiter)
        assert torch.equal(new[4][: j + 2], h) and torch.equal(new[5], d)
        for a, b in zip(new[6:], old[6:]):
            assert torch.equal(a, b)
        if j == 4:
            assert float(d) == math.inf and float(h[j + 1]) == 0.0
        w = torch.from_numpy(rng.standard_normal(16)).to(bdtype)
        assert torch.equal(torch.div(w, new[5], out=torch.empty_like(w)), w / d)
    assert givens_update.launches == 0


def test_givens_update_refuses_what_the_kernel_does_not_take():
    m = 4
    z = functools.partial(torch.zeros, dtype=torch.float32)
    args = [z(1), z(1), z(()), z(()), z(m + 1), z(()), z(m, m), z(m), z(m), z(m + 1), z(()),
            torch.zeros((), dtype=torch.bool), torch.zeros((), dtype=torch.int64),
            torch.zeros((), dtype=torch.int64), z(())]
    with pytest.raises(ValueError):
        givens_update(*args, m, 10)  # j past the cycle
    with pytest.raises(ValueError):
        givens_update(*args, 1, 10)  # h1 and h2 of j entries, not j + 1
    bad = list(args)
    bad[6] = torch.zeros(m, m, dtype=torch.float64)
    with pytest.raises(TypeError):
        givens_update(*bad, 0, 10)  # R not in the small dtype
    bad = list(args)
    bad[11] = torch.zeros((), dtype=torch.int64)
    with pytest.raises(TypeError):
        givens_update(*bad, 0, 10)  # inner not bool
    bad = list(args)
    bad[5] = torch.zeros((), dtype=torch.float64)
    with pytest.raises(TypeError):
        givens_update(*bad, 0, 10)  # d not in b's dtype
    bad = list(args)
    bad[0], bad[1], bad[2], bad[5] = (torch.zeros(s, dtype=torch.int32) for s in (1, 1, (), ()))
    with pytest.raises(TypeError):
        givens_update(*bad, 0, 10)  # b's dtype not one the kernel takes
    bad = list(args)
    bad[3] = torch.zeros((), dtype=torch.float64)
    with pytest.raises(TypeError):
        givens_update(*[t.to(torch.bfloat16) if i in (0, 1, 2, 5) else t
                        for i, t in enumerate(bad)], 0, 10)  # bf16 b, eps10 not float32
    givens_update_reference(*args, 0, 10)  # all zero: the identity rotation
    assert float(args[7][0]) == 1.0 and float(args[8][0]) == 0.0 and not math.isnan(args[10])
    assert float(args[5]) == math.inf and float(args[4][1]) == 0.0  # a breakdown
