"""The port's utilities held against the JAX package's: ``order``,
``determinant`` and ``init_seed``; the float checks (``checked``,
``checked_solve``, ``debug_nans``) and ``validate_matrix`` on every stored
format, padding checked slot by slot; the timers; and ``SolverLog``'s
report text for the same iteration count, residual and history."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu
from sigma_tpu.solvers.krylov import SolveInfo as JaxSolveInfo
from sigma_tpu.utils import checks as jchecks
from sigma_tpu.utils import util as jutil
from sigma_tpu.utils.profiling import SolverLog as JaxSolverLog
import sigma_tpu_torch as st
from sigma_tpu_torch.solvers import SolveInfo
from sigma_tpu_torch.utils import checks, profiling, util

F64 = torch.float64


def tridiag(n, diag=3.0):
    return diag * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)


# -- util --------------------------------------------------------------------------
def test_order_matches_jax():
    x = np.random.default_rng(0).integers(0, 7, 60).astype(float)  # ties: stability
    p = util.order(x)
    np.testing.assert_array_equal(p, jutil.order(x))
    np.testing.assert_array_equal(util.order(torch.from_numpy(x)), p)
    assert (np.diff(x[p]) >= 0).all()


@pytest.mark.parametrize("n", [5, 12])
def test_determinant_matches_jax(n):
    A = tridiag(n, 2.0)
    assert abs(util.determinant(A) - (n + 1)) < 1e-10
    rng = np.random.default_rng(n)
    B = rng.standard_normal((n, n))
    want = jutil.determinant(B)
    assert util.determinant(B) == pytest.approx(want, rel=1e-12)
    assert util.determinant(torch.from_numpy(B)) == pytest.approx(want, rel=1e-12)


def test_init_seed_same_seed_same_draws():
    a = torch.rand(8, generator=util.init_seed(42, "cpu"))
    b = torch.rand(8, generator=util.init_seed(42, "cpu"))
    c = torch.rand(8, generator=util.init_seed(43, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = util.init_seed(device="cpu")  # clock-seeded
    assert isinstance(g, torch.Generator) and g.device == torch.device("cpu")
    assert jutil.init_seed() is not None


# -- float checks ---------------------------------------------------------------------
def test_checked_passes_clean_results_through():
    f = checks.checked(lambda x: torch.sqrt(x) + 1.0)
    x = torch.arange(4.0)
    assert torch.equal(f(x), torch.sqrt(x) + 1.0)


@pytest.mark.parametrize("fn,kind", [(lambda x: torch.log(x - 1.0), "nan"),
                                     (lambda x: (x + 1.0) / 0.0, "inf"),
                                     (lambda x: torch.exp(x + 1e4).sum(), "inf"),
                                     (lambda x: x.sqrt().sum() * (x - 1.0).sqrt(), "nan")],
                         ids=["log", "div", "exp", "sqrt"])
def test_checked_raises_at_the_first_bad_op(fn, kind):
    with pytest.raises(FloatingPointError, match=kind):
        checks.checked(fn)(torch.zeros(3))


@pytest.mark.parametrize("frmt", ["csr", "dia"])
def test_checked_solve_matches_jax(frmt):
    """A clean solve passes; a NaN in the matrix raises in both packages."""
    from sigma_tpu.solvers import cg_solve as jax_cg

    n = 16
    d = tridiag(n, 2.0)
    b = np.random.default_rng(1).standard_normal(n)
    A = st.choose_matrix_type(frmt).from_dense(d, device="cpu")
    x, info = checks.checked_solve(st.cg_solve, A, torch.from_numpy(b), tol=1e-12)
    Aj = sigma_tpu.choose_matrix_type(frmt).from_dense(d)
    xj, infoj = jchecks.checked_solve(jax_cg, Aj, jnp.asarray(b), tol=1e-12)
    assert info.converged and info.iterations == int(infoj.iterations)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-12)
    data = A.data.clone()
    data.view(-1)[int(torch.nonzero(data.view(-1))[0])] = float("nan")
    with pytest.raises(FloatingPointError, match="nan"):
        checks.checked_solve(st.cg_solve, A.with_data(data), torch.from_numpy(b), tol=1e-12,
                             maxiter=4)
    bad = Aj.with_data(Aj.data.reshape(-1).at[int(np.flatnonzero(np.asarray(Aj.data))[0])]
                       .set(jnp.nan).reshape(Aj.data.shape))
    with pytest.raises(Exception, match="nan"):
        jchecks.checked_solve(jax_cg, bad, jnp.asarray(b), tol=1e-12, maxiter=4)


def test_checks_skip_allocations_and_fills():
    """Uninitialized buffers and explicit fills are not computed values: a
    solve with a NaN-filled history passes; a computed NaN still raises."""
    def run():
        buf = torch.empty(1 << 16)
        buf.fill_(float("nan"))
        hist = torch.full((4,), float("nan")).new_full((2,), float("inf"))
        return buf, hist

    checks.checked(run)()
    A = st.CSRMatrix.from_dense(tridiag(20), device="cpu")
    x, info = checks.checked_solve(st.cg_solve, A, torch.ones(20, dtype=F64), tol=1e-12,
                                   history=True)
    assert info.converged and torch.isnan(info.history[-1])
    with pytest.raises(FloatingPointError, match="nan"):
        checks.checked(lambda: torch.full((3,), float("nan")) * 2.0)()


def test_debug_nans_block():
    with checks.debug_nans(True):
        with pytest.raises(FloatingPointError, match="nan"):
            torch.log(torch.tensor([-1.0]))
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()  # off after the block
    with checks.debug_nans(False):
        assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()
    prev = jax.config.jax_debug_nans
    with jchecks.debug_nans(True):
        assert jax.config.jax_debug_nans
    assert jax.config.jax_debug_nans == prev


def test_checks_exported_at_the_top_level():
    for name in ("checked", "checked_solve", "debug_nans", "validate_matrix"):
        assert getattr(st, name) is getattr(checks, name)


# -- validate_matrix -----------------------------------------------------------------
def ragged_dense(n=12, m=12):
    d = np.eye(n, m) * 3.0
    d[0, 5] = 1.0
    d[4, :4] = -0.5
    d[9, 11] = 2.0
    return d


def padding_slot(A):
    """The flat index of one stored slot that is padding."""
    mask = checks._true_slots(A).reshape(-1)
    return int(torch.nonzero(~mask)[0])


def entry_slot(A):
    return int(torch.nonzero(A.data.reshape(-1))[0])


def build(frmt):
    d = ragged_dense()
    if frmt == "bsr":
        return st.BSRMatrix.from_dense(d, device="cpu", block_shape=(4, 4))
    if frmt == "pruned":
        r, c = np.nonzero(d)
        return st.PrunedDIAMatrix.from_coo(12, 12, r, c, d[r, c], tile_rows=1024, device="cpu")
    if frmt == "sym_dia":
        s = d + d.T
        return st.SymmetricDIAMatrix.from_dense(s, device="cpu")
    return st.choose_matrix_type(frmt).from_dense(d, device="cpu")


ALL = ["csr", "coo", "csc", "ell", "dia", "bsr", "pruned", "sym_dia"]
PADDED = ["ell", "dia", "bsr", "pruned", "sym_dia"]


def with_value(A, index, value):
    data = A.data.clone()
    data.view(-1)[index] = value
    if isinstance(A, st.SymmetricDIAMatrix):
        return st.SymmetricDIAMatrix(data=data, offsets=A.offsets, n=A.n)
    if isinstance(A, st.PrunedDIAMatrix):
        import dataclasses

        return dataclasses.replace(A, data=data)
    return A.with_data(data)


@pytest.mark.parametrize("frmt", ALL)
def test_validate_matrix_passes_a_clean_matrix(frmt):
    checks.validate_matrix(build(frmt))


@pytest.mark.parametrize("value", [float("inf"), float("nan")])
@pytest.mark.parametrize("frmt", ALL)
def test_validate_matrix_raises_on_a_non_finite_value(frmt, value):
    A = build(frmt)
    with pytest.raises(ValueError, match="non-finite"):
        checks.validate_matrix(with_value(A, entry_slot(A), value))


@pytest.mark.parametrize("frmt", PADDED)
def test_validate_matrix_raises_on_a_nonzero_padding_slot(frmt):
    A = build(frmt)
    with pytest.raises(ValueError, match="padded slot"):
        checks.validate_matrix(with_value(A, padding_slot(A), 1.0))


@pytest.mark.parametrize("frmt", PADDED)
def test_validate_matrix_checks_every_padding_slot(frmt):
    """Each padding slot alone, set to 1.0, raises; each true slot set to
    a new value passes."""
    A = build(frmt)
    mask = checks._true_slots(A).reshape(-1)
    assert mask.shape[0] == A.data.numel() and 0 < int(mask.sum()) < mask.numel()
    for i in torch.nonzero(~mask)[:, 0].tolist()[:40]:
        with pytest.raises(ValueError, match="padded slot"):
            checks.validate_matrix(with_value(A, i, 1.0))
    for i in torch.nonzero(mask)[:, 0].tolist()[:20]:
        checks.validate_matrix(with_value(A, i, 0.25))


def test_padding_slot_plus_zeroed_entry_is_caught_in_both_packages():
    """A padded slot turned nonzero while a true entry turns zero: the JAX
    package's count comparison catches it (the zeroed entry is still
    counted by ``entries()``), and the port's slot-by-slot check too."""
    d = ragged_dense()
    A = st.ELLMatrix.from_dense(d, device="cpu")
    Aj = sigma_tpu.ELLMatrix.from_dense(d)
    row = 1  # degree 1 in a width-5 ELL array: slot (1, 1) is padding
    assert A.graph.degrees[row] < A.graph.width
    data = A.data.clone()
    data[row, 1], data[0, 0] = 7.0, 0.0
    with pytest.raises(ValueError, match="padded slot"):
        checks.validate_matrix(A.with_data(data))
    bad = Aj.with_data(jnp.asarray(data.numpy()))
    with pytest.raises(ValueError, match="padded slots"):
        jchecks.validate_matrix(bad)


def test_validate_matrix_agrees_with_jax_on_csr():
    d = ragged_dense()
    A, Aj = st.CSRMatrix.from_dense(d, device="cpu"), sigma_tpu.CSRMatrix.from_dense(d)
    checks.validate_matrix(A)
    jchecks.validate_matrix(Aj)
    with pytest.raises(ValueError):
        checks.validate_matrix(with_value(A, 0, float("inf")))
    with pytest.raises(ValueError):
        jchecks.validate_matrix(Aj.with_data(Aj.data.at[0].set(jnp.inf)))


# -- profiling ---------------------------------------------------------------------------
def test_time_fn_is_positive_on_the_cpu():
    x = torch.ones(256, dtype=F64)

    def make(K):
        def run(x):
            for _ in range(K):
                x = x * 0.5 + 1.0
            return x
        return run

    assert profiling.time_fn(make, x, k1=2, k2=10) > 0


@pytest.mark.parametrize("frmt", ["csr", "dia"])
def test_spmv_throughput_is_positive_on_the_cpu(frmt):
    A = st.choose_matrix_type(frmt).from_dense(tridiag(256), device="cpu")
    assert profiling.spmv_throughput(A, k1=2, k2=10) > 0


def test_sync_returns_the_first_element():
    assert profiling.sync((torch.tensor([2.5, 1.0]), 3)) == 2.5


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert prof is not None


HISTORY = [np.array([1.0, 0.25, 3e-3, 2.5e-7] + [np.nan] * 4), None]


@pytest.mark.parametrize("history", HISTORY, ids=["history", "no_history"])
@pytest.mark.parametrize("converged", [True, False])
def test_solver_log_report_is_the_jax_packages(history, converged):
    info = SolveInfo(4, torch.tensor(2.5e-7, dtype=F64), converged,
                     None if history is None else torch.from_numpy(history))
    infoj = JaxSolveInfo(jnp.int32(4), jnp.float64(2.5e-7), jnp.bool_(converged),
                         None if history is None else jnp.asarray(history))
    log, logj = profiling.SolverLog(info), JaxSolverLog(infoj)
    np.testing.assert_array_equal(log.residuals(), logj.residuals())
    for name in ("solve", "cg"):
        assert log.report(name) == logj.report(name)


def test_solver_log_of_a_cg_solve_is_the_jax_packages():
    from sigma_tpu.solvers import cg_solve as jax_cg

    n = 60
    d = tridiag(n)
    b = d @ np.ones(n)
    _, info = st.cg_solve(st.CSRMatrix.from_dense(d, device="cpu"), torch.from_numpy(b),
                          tol=1e-13, history=True)
    _, infoj = jax_cg(sigma_tpu.CSRMatrix.from_dense(d), jnp.asarray(b), tol=1e-13, history=True)
    log, logj = profiling.SolverLog(info), JaxSolverLog(infoj)
    assert log.residuals().size == info.iterations == int(infoj.iterations)
    r = logj.residuals()
    np.testing.assert_allclose(log.residuals(), r, rtol=1e-10, atol=1e-12 * r[0])
    assert log.report().split(",")[0] == logj.report().split(",")[0]
