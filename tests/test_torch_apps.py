"""The port's graph generators, Ising model and self-avoiding walks held
against the JAX package's.

The generators are host numpy driven by the caller's
``np.random.Generator``: the same seed gives bitwise the same edges in
every graph format.  The apps draw from a ``torch.Generator`` in the port
and from ``jax.random`` in the JAX package, streams torch cannot
reproduce, so the parity tests replay the JAX package's exact key splits
here and feed those draws through the port's draw seam (``_run``): spins,
magnetization, walk lengths and histogram then match exactly.  The
dynamical invariants of ``tests/test_apps.py`` are checked on the port's
own public entries, and the two command-line drivers' output lines
against the JAX package's scripts."""

import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import sigma_tpu.apps as japps
from sigma_tpu.graph import CSRGraph as JaxCSRGraph
import sigma_tpu_torch.apps as tapps
from sigma_tpu_torch.apps import ising as tising
from sigma_tpu_torch.apps import saw as tsaw
from sigma_tpu_torch.graph import CSRGraph

ROOT = Path(__file__).resolve().parents[1]

FORMATS = ["csr", "coo", "csc", "ell", "dia"]


def same_graph(gt, gj):
    assert gt.shape == gj.shape and gt.nnz == gj.nnz
    rt, ct = gt.edges_numpy()
    rj, cj = gj.edges_numpy()
    np.testing.assert_array_equal(rt, np.asarray(rj))
    np.testing.assert_array_equal(ct, np.asarray(cj))
    if gt.format == "ell":
        np.testing.assert_array_equal(gt.cols, np.asarray(gj.cols))
        np.testing.assert_array_equal(gt.degrees, np.asarray(gj.degrees))
    if gt.format == "csr":
        np.testing.assert_array_equal(gt.indptr, np.asarray(gj.indptr))


# (name, args, needs an rng)
GENERATORS = [
    ("torus", (6, 5), False),
    ("torus", (8, 8), False),
    ("petersen", (5, 2), False),
    ("petersen", (10, 3), False),
    ("flower_snark", (5,), False),
    ("hypercube", (4,), False),
    ("erdos_renyi", (300, 0.05), True),
    ("erdos_renyi", (10_000, 2e-4), True),
    ("watts_strogatz", (100, 3, 0.2), True),
    ("watts_strogatz", (5, 4, 1.0), True),
    ("barabasi_albert", (150, 3), True),
]


def make(pkg, name, args, rng, frmt, **kw):
    extra = (np.random.default_rng(rng),) if rng is not None else ()
    return getattr(pkg, name)(*args, *extra, frmt=frmt, **kw)


# (a random graph of 10,000 vertices spans ~20,000 diagonals: not in DIA)
CASES = [(g, f) for g in GENERATORS for f in FORMATS
         if not (f == "dia" and g[0] == "erdos_renyi" and g[1][0] > 4096)]


@pytest.mark.parametrize("name,args,random,frmt", [(*g, f) for g, f in CASES],
                         ids=[f"{g[0]}{g[1]}-{f}" for g, f in CASES])
def test_generator_edges_are_the_jax_packages(name, args, random, frmt):
    seed = 7 if random else None
    same_graph(make(tapps, name, args, seed, frmt), make(japps, name, args, seed, frmt))


@pytest.mark.parametrize("name,args,random", GENERATORS[:7] + GENERATORS[8:],
                         ids=[f"{g[0]}{g[1]}" for g in GENERATORS[:7] + GENERATORS[8:]])
def test_generator_in_bsr_on_a_device(name, args, random):
    seed = 7 if random else None
    gt = make(tapps, name, args, seed, "bsr", device="cpu", block_shape=(4, 4))
    same_graph(gt, make(japps, name, args, seed, "bsr"))
    assert gt.device == torch.device("cpu")


def test_erdos_renyi_large_n_sampler_properties():
    n, p = 10_000, 2e-4
    g = tapps.erdos_renyi(n, p, np.random.default_rng(0))
    rows, cols = g.edges_numpy()
    assert (rows != cols).all()
    assert np.array_equal(np.sort(rows * n + cols), np.sort(cols * n + rows))
    mean = p * n * (n - 1) / 2
    assert abs(g.nnz / 2 - mean) < 5 * np.sqrt(mean * (1 - p)) + 1


def test_watts_strogatz_saturated_terminates_and_stays_simple():
    g = tapps.watts_strogatz(5, 4, 1.0, np.random.default_rng(3))
    r, c = g.edges_numpy()
    assert g.shape == (5, 5) and (r != c).all()


NAMES = [("torus", 4, 5), ("petersen", 7, 2), ("snark", 4, 0), ("flower-snark", 4, 0),
         ("flowersnark", 3, 0), ("hypercube", 3, 0), ("hypercube", 12, 0), ("erdos-renyi", 60, 6),
         ("erdos_renyi", 60, 6), ("er", 60, 6), ("ErdosRenyi", 60, 6), ("watts-strogatz", 40, 3),
         ("ws", 40, 3), ("small-world", 40, 3), ("smallworld", 40, 3), ("wattsstrogatz", 40, 3),
         ("barabasi-albert", 50, 2), ("ba", 50, 2), ("scale-free", 50, 2), ("scalefree", 50, 2),
         ("barabasialbert", 50, 2)]


@pytest.mark.parametrize("name,n,k", NAMES)
def test_named_graph_dispatch_is_the_jax_packages(name, n, k):
    gt = tapps.named_graph(name, n, k, 0.3, np.random.default_rng(2), frmt="ell")
    gj = japps.named_graph(name, n, k, 0.3, np.random.default_rng(2), frmt="ell")
    same_graph(gt, gj)


def test_named_graph_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown graph family"):
        tapps.named_graph("nonsense", 4, 4)


# -- Ising: the JAX package's draws through the port's seam --------------------
def jax_uniforms(seed, n, sweeps, n_colors, hot_start):
    """The uniform vectors the JAX package's ``ising_metropolis`` draws, in
    order: the hot start's, then one a colour a sweep."""
    key = jax.random.PRNGKey(seed)
    out = []
    if hot_start:
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (n,))))
    for _ in range(sweeps * n_colors):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (n,))))
    return out


def replay(arrays):
    it = iter(arrays)

    def draw(*shape):
        a = next(it)
        assert a.shape == (tuple(shape[0]) if isinstance(shape[0], tuple) else shape)
        return torch.from_numpy(np.array(a))

    return draw, it


ISING = [("torus", (8, 8), 0.6, 30, False, 0), ("torus", (8, 8), 0.3, 25, True, 1),
         ("torus", (6, 6), 0.5, 10, False, 2), ("petersen", (10, 3), 0.4, 20, True, 3),
         ("petersen", (5, 2), 0.7, 15, False, 4)]


@pytest.mark.parametrize("family,args,beta,sweeps,hot,seed", ISING)
def test_ising_with_the_jax_draws_is_the_jax_packages(family, args, beta, sweeps, hot, seed):
    gj = getattr(japps, family)(*args, frmt="ell")
    gt = getattr(tapps, family)(*args, frmt="ell")
    want = japps.ising_metropolis(gj, beta=beta, sweeps=sweeps, seed=seed, hot_start=hot)
    colors, nc = tising.greedy_coloring(gt)
    assert nc == want.num_colors
    n = gt.shape[0]
    draw, rest = replay(jax_uniforms(seed, n, sweeps, nc, hot))
    spins0 = tising._spins0(n, hot, draw, "cpu")
    spins, mags = tising._run(tising._ones_ell(gt, "cpu"), torch.from_numpy(colors), beta,
                              spins0, draw, sweeps, nc)
    assert next(rest, None) is None  # every draw used
    np.testing.assert_array_equal(spins.numpy(), np.asarray(want.spins))
    np.testing.assert_array_equal(mags.numpy(), np.asarray(want.magnetization))
    assert spins.dtype == torch.float32 and mags.shape == (sweeps,)


@pytest.mark.parametrize("args,colours", [((10, 3), 2), ((5, 2), 3), ((7, 2), 4)])
def test_ising_colour_count_is_the_jax_packages(args, colours):
    """GP(10, 3) is bipartite (n even, k odd): two colours; first fit in
    vertex order gives the Petersen graph GP(5, 2) three and GP(7, 2)
    four."""
    res = tapps.ising_metropolis(tapps.petersen(*args, frmt="ell"), sweeps=2, device="cpu")
    want = japps.ising_metropolis(japps.petersen(*args, frmt="ell"), sweeps=2)
    assert res.num_colors == want.num_colors == colours


# -- self-avoiding walks: the JAX package's draws through the port's seam ------
def jax_walk_draws(seed, walkers, n, steps, width):
    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    starts = np.asarray(jax.random.randint(sub, (walkers,), 0, n))
    g = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        g.append(np.asarray(jax.random.gumbel(sub, (walkers, width))))
    return starts, g


def path_graph(cls, n=10):
    rows = np.arange(n - 1)
    return cls.from_coo(n, n, np.r_[rows, rows + 1], np.r_[rows + 1, rows])


WALKS = [("torus", lambda: (tapps.torus(8, 8), japps.torus(8, 8)), 300, 0),
         ("path10", lambda: (path_graph(CSRGraph), path_graph(JaxCSRGraph)), 200, 3),
         ("petersen", lambda: (tapps.petersen(10, 3), japps.petersen(10, 3)), 250, 5)]


@pytest.mark.parametrize("label,graphs,walkers,seed", WALKS, ids=[w[0] for w in WALKS])
def test_walks_with_the_jax_draws_are_the_jax_packages(label, graphs, walkers, seed):
    gt, gj = graphs()
    want = japps.self_avoiding_walks(gj, walkers=walkers, seed=seed)
    n = gt.shape[0]
    ell = tsaw.ELLGraph.from_coo(n, n, *gt.edges_numpy())
    lengths_j = np.asarray(want.lengths)
    # the JAX loop takes max(lengths) + 1 steps (the last finds every walker stuck)
    starts, gumbels = jax_walk_draws(seed, walkers, n, int(lengths_j.max()) + 1, ell.width)
    draw, rest = replay(gumbels)
    lengths = tsaw._run(torch.from_numpy(ell.cols), torch.from_numpy(ell.degrees),
                        torch.from_numpy(starts), draw, n, n)
    assert next(rest, None) is None
    np.testing.assert_array_equal(lengths.numpy(), lengths_j)
    np.testing.assert_array_equal(np.bincount(lengths.numpy(), minlength=n + 1), want.histogram)
    assert lengths.dtype == torch.int32


# -- tests/test_apps.py's invariants on the port's public entries --------------
def test_ising_cold_ordered():
    res = tapps.ising_metropolis(tapps.torus(8, 8), beta=2.0, sweeps=30, seed=0, device="cpu")
    assert set(np.unique(res.spins.numpy())) <= {-1.0, 1.0}
    assert abs(float(res.magnetization[-1])) > 0.8
    assert res.num_colors >= 2


def test_ising_hot_disordered():
    res = tapps.ising_metropolis(tapps.torus(16, 16), beta=0.01, sweeps=50, seed=1,
                                 hot_start=True, device="cpu")
    assert abs(float(res.magnetization[-1])) < 0.3


def test_ising_magnetization_range():
    res = tapps.ising_metropolis(tapps.torus(6, 6), beta=0.5, sweeps=10, seed=2, device="cpu")
    m = res.magnetization.numpy()
    assert (m >= -1).all() and (m <= 1).all() and m.shape == (10,)


def test_ising_same_seed_same_run():
    g = tapps.torus(6, 6)
    a = tapps.ising_metropolis(g, beta=0.4, sweeps=5, seed=9, hot_start=True, device="cpu")
    b = tapps.ising_metropolis(g, beta=0.4, sweeps=5, seed=9, hot_start=True, device="cpu")
    assert torch.equal(a.spins, b.spins) and torch.equal(a.magnetization, b.magnetization)


def test_saw_lengths_valid():
    res = tapps.self_avoiding_walks(tapps.torus(8, 8), walkers=500, seed=0, device="cpu")
    lengths = res.lengths.numpy()
    assert (lengths >= 1).all() and (lengths <= 63).all()
    assert res.histogram.sum() == 500


def test_saw_line_graph():
    res = tapps.self_avoiding_walks(path_graph(CSRGraph), walkers=300, seed=3, device="cpu")
    lengths = res.lengths.numpy()
    assert lengths.max() == 9 and (lengths >= 1).all()


def test_saw_visits_each_vertex_once():
    """Every walk is self-avoiding: replaying a walk's steps from the
    visited mask is impossible after the fact, so check on a graph where
    the length bounds it: on the hypercube Q3 (8 vertices) no walk is
    longer than 7 steps."""
    res = tapps.self_avoiding_walks(tapps.hypercube(3), walkers=400, seed=4, device="cpu")
    assert res.lengths.numpy().max() <= 7 and res.histogram.sum() == 400


# -- the command-line drivers ---------------------------------------------------
def run_script(path, argv, capsys, monkeypatch):
    spec = importlib.util.spec_from_file_location(f"_cli_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    mod.main()
    return capsys.readouterr().out.splitlines()


def test_ising_cli_lines_match_the_jax_script(capsys, monkeypatch):
    from sigma_tpu_torch.tools import ising as tool

    argv = ["--graph", "petersen", "--n", "10", "--k", "3", "--sweeps", "40", "-v"]
    want = run_script(ROOT / "apps" / "ising.py", argv, capsys, monkeypatch)
    tool.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want)
    assert got[:2] == want[:2]  # the graph and colour lines
    for g, w in zip(got[2:-1], want[2:-1]):
        assert re.fullmatch(r"\d+ -?\d+\.\d+(e-?\d+)?", g) and g.split()[0] == w.split()[0]
    assert re.fullmatch(r"final magnetization: -?\d\.\d{6}", got[-1])


def test_saw_cli_lines_match_the_jax_script(capsys, monkeypatch):
    from sigma_tpu_torch.tools import self_avoiding_walk as tool

    argv = ["--graph", "torus", "--n", "6", "--k", "5", "--iter", "400", "-v"]
    want = run_script(ROOT / "apps" / "self_avoiding_walk.py", argv, capsys, monkeypatch)
    tool.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0]
    pat = r"walks: 400  mean length: \d+\.\d\d  max: \d+"
    assert re.fullmatch(pat, got[1]) and re.fullmatch(pat, want[1])
    counts = [tuple(map(int, line.split())) for line in got[2:]]
    assert sum(c for _, c in counts) == 400 and all(1 <= n <= 29 for n, _ in counts)
    assert [n for n, _ in counts] == sorted(n for n, _ in counts)
