"""The port's example scripts held against the JAX package's on the CPU.

Each JAX script of ``examples/`` runs in this process as its own
``__main__`` (``runpy``; this directory's conftest sets CPU and x64, which
is what ``examples/_common.py`` sets) with its standard output captured,
and the port's module of the same name runs ``main(device="cpu")``.  Both
outputs are cut into lines and the numbers in them (labels such as
``degree(0)`` or ``Chebyshev(8)`` taken out first), and held so:

- each line reads the same once its numbers are masked, but for the lines
  the port words its own way (a matrix's repr, the kernel route that
  replaces ``why_not_pallas``, the eager solve that replaces the jitted one);
- integers are equal, and f64 quantities agree to the digits printed
  (within 1.5 units of the last printed digit, so that a value on a
  rounding boundary does not fail);
- rounding-level quantities (``|lazy - explicit|``, the adjoint check and
  the f64 CG errors of ~1e-14) are each below 1e-12;
- in the f32 examples (``solver_example_4``, ``_5`` and ``_6``) the
  iteration counts differ by at most 2 and the errors by at most a factor
  of 2.  Measured on the CPU: the counts differ by at most 1 (plain CG on
  symmetric pruned storage, 196 against 197) and the errors by at most a
  factor of 1.29 (BiCG-stab, 4.29e-06 against 3.34e-06); the summation
  order of f32 products differs between the packages;
- every number the port prints is the value its ``main`` returns under
  the key the spec names.

LOBPCG in ``solver_example_2`` is fed the JAX package's start block (its
``jax.random.PRNGKey(0)`` draw) through the port's ``X0``, so its count is
equal too.  The file also holds ``sigma_tpu_torch.tools.entry.entry()``
against ``__graft_entry__.entry()`` and runs every Python block of
``docs/MIGRATING_TORCH.md`` on the CPU in one namespace."""

import contextlib
import importlib
import io
import re
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from sigma_tpu_torch.examples import EXAMPLES
from sigma_tpu_torch.tools.entry import entry

ROOT = Path(__file__).resolve().parent.parent

# a number (or a bool) not glued to a word, a dot or a caret on its left
NUM = re.compile(r"(?<![\w.^])(?:-?\d+(?:\.\d+)?(?:e[-+]?\d+)?|True\b|False\b)")
# numbers that belong to a label, not to the result
LABELS = re.compile(
    r"connected\(0, 1\)|degree\(0\)|IC\(0\)|\(true 0\.02\)|is 2-colorable|after 50 steps"
    r"|\(expect O\(h(?:\^2)?\) ~ [\d.e+-]+\)|p=\s*[\d.]+:|Chebyshev\(8\)|\(8 rhs\)|lowest 4")

EQ, DIGITS, ROUND, COUNT32, ERR32 = "eq", "digits", "round", "count32", "err32"
COUNT32_TOL, ERR32_FACTOR, ROUND_BOUND = 2, 2.0, 1e-12


def _p(*path):
    return path


def _solve(key, err_kind):
    return [(_p(key, "iterations"), EQ), (_p(key, "err"), err_kind)]


# per example: one entry a line, the (dict path, kind) of each number in it;
# TEXT marks the lines the port words its own way
TEXT = "text"
SPEC = {
    "graphs.graph_example_1": [
        [(_p("connected_0_1"), EQ)], [(_p("degree_0"), EQ)],
        [(_p("edges"), EQ), (_p("max_degree"), EQ)], [(_p("estimated_p"), DIGITS)]],
    "graphs.graph_example_2": [
        [(_p("csr", "shape", 0), EQ), (_p("csr", "shape", 1), EQ), (_p("csr", "nnz"), EQ)]] + [
        [(_p(f, "shape", 0), EQ), (_p(f, "shape", 1), EQ), (_p(f, "nnz"), EQ),
         (_p(f, "edges_preserved"), EQ)] for f in ("coo", "ell", "csc", "bsr")],
    "graphs.graph_example_3": [[(_p("original_bandwidth"), EQ)], [(_p("bfs_bandwidth"), EQ)]],
    "graphs.graph_example_4": [
        [(_p("colors"), EQ)],
        [(_p("color_block_sizes", 0), EQ), (_p("color_block_sizes", 1), EQ)],
        [(_p("conflicting_edges"), EQ)]],
    "matrices.matrix_example_1": [
        [(_p("entropy"), DIGITS), (_p("max_entropy"), DIGITS)], [(_p("total_probability"), DIGITS)]],
    "matrices.matrix_example_2": [
        [(_p("sum_lazy_vs_explicit"), ROUND)], [(_p("prod_lazy_vs_explicit"), ROUND)],
        [TEXT, (_p("product_shape", 0), EQ), (_p("product_shape", 1), EQ),
         (_p("product_nnz"), EQ)],
        [(_p("adjoint_check"), ROUND)]],
    "solvers.solver_example_1": [_solve(k, ROUND) for k in ("plain", "jacobi", "ic0")],
    "fem_poisson": [
        [(_p("nodes"), EQ), (_p("elements"), EQ)], [(_p("iterations"), EQ)],
        [(_p("nodal_error"), DIGITS)], [(_p("gradient_error"), DIGITS)]],
    "eigen_example": [
        [(_p(f"p={p}", "lambda_2"), DIGITS), (_p(f"p={p}", "lambda_max"), DIGITS)]
        for p in (0.0, 0.05, 0.3)] + [[]],
    "solvers.solver_example_2": [
        [(_p("plain_iterations"), EQ)], [(_p("amg_iterations"), EQ), (_p("amg_levels"), EQ)],
        [(_p("chebyshev_iterations"), EQ)], [(_p("block_cg_iterations"), EQ)],
        [(_p("lobpcg_eigenvalues", i), DIGITS) for i in range(4)]
        + [(_p("lobpcg_iterations"), EQ)]
        + [(_p("exact_eigenvalues", i), DIGITS) for i in range(4)]],
    "solvers.solver_example_3": [
        _solve("plain", DIGITS), _solve("pairs", DIGITS) + [(_p("pairs", "levels"), EQ)],
        [TEXT] + _solve("cubes", DIGITS) + [(_p("cubes", "levels"), EQ)]],
    "solvers.solver_example_4": [
        [(_p("n"), EQ), (_p("nnz"), EQ), (_p("input_bandwidth"), EQ)],
        [(_p("stored_diagonals"), EQ), (_p("occupancy_before"), DIGITS),
         (_p("occupancy_after"), DIGITS)],
        [TEXT],
        [(_p("banded", "iterations"), COUNT32), (_p("banded", "err"), ERR32)],
        [(_p("symmetric", "upper_diagonals"), EQ), (_p("symmetric", "iterations"), COUNT32),
         (_p("symmetric", "err"), ERR32)]],
    "solvers.solver_example_5": [
        [(_p("n"), EQ), (_p("stored_slots"), EQ), (_p("nnz"), EQ),
         (_p("local_occupancy"), DIGITS)],
        [(_p("plain_iterations"), COUNT32)],
        [(_p("amg_iterations"), COUNT32), (_p("levels"), EQ), (_p("err"), ERR32)]],
    "solvers.solver_example_6": [
        [(_p("n"), EQ), (_p("nnz"), EQ), (_p("bandwidth"), EQ)],
        [(_p("full_slots"), EQ), (_p("symmetric_slots"), EQ), (_p("slot_ratio"), DIGITS)],
        [(_p("cg_plain_iterations"), COUNT32), (_p("cg_gmg_iterations"), COUNT32),
         (_p("cg_gmg_err"), ERR32)],
        [(_p("skew_dominance"), DIGITS)],
        [(_p("bicgstab_iterations"), COUNT32), (_p("bicgstab_err"), ERR32)],
        [(_p("fgmres_iterations"), COUNT32), (_p("fgmres_err"), ERR32)]],
}


def _split(text):
    """(masked line, number tokens) for each line of an example's output."""
    out = []
    for line in text.strip().splitlines():
        line = LABELS.sub("<label>", line)
        out.append((NUM.sub("#", line), NUM.findall(line)))
    return out


def _last_digit(tok):
    """One unit of the last digit printed in the number ``tok``."""
    mant, _, exp = tok.partition("e")
    places = len(mant.partition(".")[2])
    return 10.0 ** (int(exp or 0) - places)


def _value(tok):
    return tok == "True" if tok in ("True", "False") else float(tok)


def _agree(kind, got, want):
    """Whether the port's token ``got`` agrees with the JAX token ``want``."""
    if kind == EQ:
        return got == want
    g, w = _value(got), _value(want)
    if kind == DIGITS:
        return abs(g - w) <= 1.5 * max(_last_digit(got), _last_digit(want))
    if kind == ROUND:
        return abs(g) <= ROUND_BOUND and abs(w) <= ROUND_BOUND
    if kind == COUNT32:
        return abs(g - w) <= COUNT32_TOL
    if kind == ERR32:
        return max(g, w) <= ERR32_FACTOR * min(g, w)
    raise ValueError(kind)


def _at(d, path):
    for k in path:
        d = d[k]
    return d


def _run_jax_example(name):
    path = ROOT / "examples" / (name.replace(".", "/") + ".py")
    buf, argv = io.StringIO(), sys.argv
    sys.argv = [str(path)]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = argv
    return buf.getvalue()


def _jax_lobpcg_start(n=1024, m=4):
    """The start block the JAX package's ``lobpcg`` draws without X0."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n, m), dtype=jnp.float64))


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_the_jax_scripts_numbers(name):
    want = _run_jax_example(name)
    module = importlib.import_module(f"sigma_tpu_torch.examples.{name}")
    kw = {"X0": _jax_lobpcg_start()} if name == "solvers.solver_example_2" else {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = module.main(device="cpu", **kw)
    got = buf.getvalue()
    spec = SPEC[name]
    g_lines, w_lines = _split(got), _split(want)
    assert len(g_lines) == len(w_lines) == len(spec), (got, want)
    for i, ((g_mask, g_toks), (w_mask, w_toks), line) in enumerate(zip(g_lines, w_lines, spec)):
        free = bool(line) and line[0] == TEXT
        line = line[1:] if free else line
        if not free:
            assert g_mask == w_mask, f"line {i}: {g_mask!r} != {w_mask!r}"
        assert len(g_toks) == len(w_toks) == len(line), f"line {i}: {g_toks} {w_toks}"
        for g, w, (path, kind) in zip(g_toks, w_toks, line):
            assert _agree(kind, g, w), f"line {i} {path}: port {g}, JAX {w} ({kind})"
            v = _at(result, path)
            if isinstance(v, (bool, int, np.integer)):
                assert _value(g) == v, f"line {i} {path}: printed {g}, returned {v}"
            else:
                assert abs(v - float(g)) <= 0.5001 * _last_digit(g), (path, g, v)


def test_entry_matches_the_repositorys_entry():
    """The same operator as ``__graft_entry__.entry()`` (its DIA values bit
    for bit, f32) and the same 50-step CG iterate to rtol 1e-4."""
    fn, (A, b) = entry(device="cpu")
    fnj, (Aj, bj) = __graft_entry__.entry()
    assert A.dtype == torch.float32 and A.offsets == tuple(Aj.offsets)
    np.testing.assert_array_equal(A.data2d.numpy(), np.asarray(Aj.data2d))
    np.testing.assert_array_equal(b.numpy(), np.asarray(bj))
    x, xj = fn(A, b), np.asarray(fnj(Aj, bj))
    assert x.dtype == torch.float32 and x.shape == xj.shape
    np.testing.assert_allclose(x.numpy(), xj, rtol=1e-4, atol=0)


def _guide_blocks():
    text = (ROOT / "docs" / "MIGRATING_TORCH.md").read_text()
    return re.findall(r"^```python\n(.*?)^```", text, flags=re.S | re.M)


def test_migration_guide_blocks_run_on_the_cpu():
    """Every Python block of docs/MIGRATING_TORCH.md, in order, in one
    namespace; the first block names the device, which the test sets to
    the CPU before the rest run."""
    blocks = _guide_blocks()
    assert len(blocks) >= 9
    ns = {"__name__": "migrating_torch"}
    exec(compile(blocks[0], "MIGRATING_TORCH.md[0]", "exec"), ns)
    assert "DEVICE" in ns
    ns["DEVICE"] = "cpu"
    for i, block in enumerate(blocks[1:], 1):
        exec(compile(block, f"MIGRATING_TORCH.md[{i}]", "exec"), ns)
