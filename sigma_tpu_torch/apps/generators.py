"""Graph generators and the model problems of the unstructured path.

Port of :mod:`sigma_tpu.apps.generators`: the regular families ``torus``,
``petersen``, ``flower_snark`` and ``hypercube``, the random ones
``erdos_renyi``, ``watts_strogatz`` and ``barabasi_albert`` (the media of
the Ising and self-avoiding-walk apps), ``named_graph`` (the apps'
``--graph`` names), and the weighted Laplacian (+ ``shift`` I) of a
randomly triangulated H x W quad mesh, as host COO triples or as a
:class:`~sigma_tpu_torch.matrix.formats.CSRMatrix`.  All of it is host
numpy driven by the caller's ``np.random.Generator``, so a seed gives
bitwise the same edges and values as the JAX package.

Each graph generator freezes its symmetric edge list in the format
``frmt`` names (:func:`~sigma_tpu_torch.graph.factory.choose_graph_type`);
keyword arguments go to that format's ``from_coo`` (``device`` and
``block_shape`` for ``"bsr"``, whose arrays are tensors; ``min_width``
for ``"ell"``).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "barabasi_albert",
    "erdos_renyi",
    "flower_snark",
    "hypercube",
    "irregular_mesh_laplacian",
    "irregular_mesh_laplacian_coo",
    "named_graph",
    "petersen",
    "torus",
    "watts_strogatz",
]


def _graph(n, rows, cols, frmt, kw):
    from sigma_tpu_torch.graph.factory import choose_graph_type

    return choose_graph_type(frmt).from_coo(n, n, rows, cols, **kw)


def _freeze(n, rows, cols, frmt, kw):
    """The graph of the undirected edges (rows[e], cols[e]): both
    directions stored."""
    return _graph(n, np.concatenate([rows, cols]), np.concatenate([cols, rows]), frmt, kw)


def torus(nx: int, ny: int, frmt="csr", **kw):
    """2-torus grid: each (x, y) joined to (x, y+1) and (x+1, y) mod sizes;
    vertex (x, y) is ``x * ny + y``."""
    x, y = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    i = (x * ny + y).ravel()
    right = (x * ny + (y + 1) % ny).ravel()
    down = (((x + 1) % nx) * ny + y).ravel()
    rows = np.concatenate([i, i])
    cols = np.concatenate([right, down])
    return _freeze(nx * ny, rows, cols, frmt, kw)


def petersen(n: int, k: int, frmt="csr", **kw):
    """Generalized Petersen graph GP(n, k): outer cycle, spokes, inner
    k-step cycle."""
    i = np.arange(n)
    rows = np.concatenate([i, i, i + n])
    cols = np.concatenate([(i + 1) % n, i + n, (i + k) % n + n])
    return _freeze(2 * n, rows, cols, frmt, kw)


def flower_snark(n: int, frmt="csr", **kw):
    """Flower snark J_n on 4n vertices: n stars (A_k centre; B, C, D
    leaves), the B cycle, and the C and D paths cross-linked at the
    ends."""
    k = np.arange(n)
    A, B, C, D = 4 * k, 4 * k + 1, 4 * k + 2, 4 * k + 3
    rows = [A, A, A, B, C[:-1], D[:-1], np.array([C[-1], D[-1]])]
    cols = [B, C, D, np.roll(B, -1), C[1:], D[1:], np.array([D[0], C[0]])]
    return _freeze(4 * n, np.concatenate(rows), np.concatenate(cols), frmt, kw)


def hypercube(k: int, frmt="csr", **kw):
    """k-dimensional hypercube on 2^k vertices: i ~ i xor 2^b."""
    n = 2**k
    i = np.repeat(np.arange(n), k)
    b = np.tile(np.arange(k), n)
    return _freeze(n, i, i ^ (1 << b), frmt, kw)


def erdos_renyi(n: int, p: float, rng=None, frmt="csr", **kw):
    """G(n, p): each unordered pair independently with probability p.

    Up to n = 4096 the dense upper-triangle mask of ``rng.random((n, n))``
    (the draws the JAX package makes, so its seeded graphs come out the
    same); above, an O(E) sampler: the edge count is Binomial(C(n, 2), p)
    and the edges a uniform sample of distinct pair indices, mapped to
    (i, j) by the triangular-number inverse."""
    rng = rng or np.random.default_rng()
    if n <= 4096:
        rows, cols = np.nonzero(np.triu(rng.random((n, n)) < p, 1))
        return _freeze(n, rows, cols, frmt, kw)
    n_pairs = n * (n - 1) // 2
    e = int(rng.binomial(n_pairs, min(max(p, 0.0), 1.0)))
    picked = np.empty(0, dtype=np.int64)
    while picked.size < e:
        extra = rng.integers(0, n_pairs, int((e - picked.size) * 1.2) + 8)
        picked = np.unique(np.concatenate([picked, extra]))
        if picked.size > e:
            picked = rng.permutation(picked)[:e]
            picked.sort()
    i = ((np.sqrt(8.0 * picked + 1.0) - 1.0) / 2.0).astype(np.int64)
    # the float inverse can be one off at a triangular number
    i = np.where(i * (i + 1) // 2 > picked, i - 1, i)
    i = np.where((i + 1) * (i + 2) // 2 <= picked, i + 1, i)
    j = picked - i * (i + 1) // 2
    # pair (j, i + 1) with j <= i
    return _freeze(n, j, i + 1, frmt, kw)


def watts_strogatz(n: int, k: int, p: float, rng=None, frmt="csr", **kw):
    """Small world: a ring with k forward neighbours, each edge rewired
    with probability p to a uniform endpoint that keeps the graph simple.
    When the vertex is already joined to every other (k >= n - 1) the
    edge is kept after 4 n tries rather than retried forever."""
    rng = rng or np.random.default_rng()
    i = np.repeat(np.arange(n), k)
    j = (i + np.tile(np.arange(1, k + 1), n)) % n
    edges = set(zip(i.tolist(), j.tolist())) | set(zip(j.tolist(), i.tolist()))
    rewire = rng.random(i.size) < p
    for e in np.nonzero(rewire)[0]:
        a, b = int(i[e]), int(j[e])
        edges.discard((a, b))
        edges.discard((b, a))
        new = b
        for _ in range(4 * n):
            cand = int(rng.integers(n))
            if cand != a and cand != b and (a, cand) not in edges:
                new = cand
                break
        edges.add((a, new))
        edges.add((new, a))
    arr = np.array(sorted(edges), dtype=np.int64).reshape(-1, 2)
    return _graph(n, arr[:, 0], arr[:, 1], frmt, kw)


def barabasi_albert(n: int, k: int, rng=None, frmt="csr", **kw):
    """Scale-free preferential attachment: a path on the first k vertices,
    then each new vertex attaches k edges to distinct earlier vertices
    with probability proportional to their degree."""
    rng = rng or np.random.default_rng()
    deg = np.zeros(n, dtype=np.int64)
    rows, cols = [], []
    for i in range(k - 1):
        rows.append(i)
        cols.append(i + 1)
        deg[i] += 1
        deg[i + 1] += 1
    for i in range(k, n):
        w = deg[:i].astype(float)
        tot = w.sum()
        probs = np.full(i, 1.0 / i) if tot == 0 else w / tot
        for j in rng.choice(i, size=min(k, i), replace=False, p=probs):
            rows.append(i)
            cols.append(int(j))
            deg[i] += 1
            deg[j] += 1
    return _freeze(n, np.array(rows), np.array(cols), frmt, kw)


def named_graph(name: str, n: int, k: int, p: float = 0.25, rng=None, frmt="csr", **kw):
    """A generator by the reference apps' ``--graph`` names: torus (n x k),
    petersen GP(n, k), snark (J_n), hypercube (dimension min(n, 10)),
    Erdos-Renyi (p = k / n), Watts-Strogatz and Barabasi-Albert; raises
    ValueError for any other name."""
    name = name.lower().replace("_", "-")
    if name == "torus":
        return torus(n, k, frmt, **kw)
    if name == "petersen":
        return petersen(n, k, frmt, **kw)
    if name in ("snark", "flower-snark", "flowersnark"):
        return flower_snark(n, frmt, **kw)
    if name == "hypercube":
        return hypercube(min(n, 10), frmt, **kw)
    if name in ("erdos-renyi", "erdosrenyi", "er"):
        return erdos_renyi(n, k / n, rng, frmt, **kw)
    if name in ("watts-strogatz", "wattsstrogatz", "ws", "small-world", "smallworld"):
        return watts_strogatz(n, k, p, rng, frmt, **kw)
    if name in ("barabasi-albert", "barabasialbert", "ba", "scale-free", "scalefree"):
        return barabasi_albert(n, k, rng, frmt, **kw)
    raise ValueError(f"unknown graph family {name!r}")


def irregular_mesh_laplacian(H: int, W: int, rng=None, shift: float = 1.0,
                             dtype=np.float64, device=None):
    """The mesh Laplacian of :func:`irregular_mesh_laplacian_coo` in natural
    vertex order, as a CSR matrix of ``dtype`` on ``device`` (None: CUDA):
    the start of the full-band pipeline (shuffle, then
    :func:`~sigma_tpu_torch.matrix.banded.to_banded_dia`)."""
    from sigma_tpu_torch.matrix.formats import CSRMatrix

    n, rows, cols, vals = irregular_mesh_laplacian_coo(H, W, rng=rng, shift=shift)
    return CSRMatrix.from_coo(n, n, rows, cols, vals, dtype=dtype, device=device)


def irregular_mesh_laplacian_coo(
    H: int, W: int, rng=None, shift: float = 1.0, shuffle: bool = False
):
    """``(n, rows, cols, vals)`` of the Laplacian of an H x W quad mesh
    with grid edges plus one randomly oriented diagonal per quad, random
    edge weights in [0.5, 1.5), plus ``shift`` on the diagonal: SPD for
    shift > 0, interior degrees 4..8, no constant diagonal structure.
    Duplicate-free; written straight into preallocated buffers (one pass
    over the 70M entries of the 10M-row mesh).

    ``shuffle=True`` relabels the vertices by a random permutation from
    ``rng`` (the shuffled-mesh north star).  Feed the result to
    :func:`sigma_tpu_torch.matrix.banded.reorder_triples_rcm` and
    ``PrunedDIAMatrix.from_coo(..., assume_unique=True)``."""
    rng = rng or np.random.default_rng()
    n = H * W
    idx = np.arange(n, dtype=np.int64).reshape(H, W)
    Eh = H * (W - 1)
    Ev = (H - 1) * W
    Ed = (H - 1) * (W - 1)
    E = Eh + Ev + Ed
    total = n + 2 * E
    rows = np.empty(total, dtype=np.int64)
    cols = np.empty(total, dtype=np.int64)
    vals = np.empty(total, dtype=np.float64)
    # edge endpoints in their final slices: [n : n+E] hold (u, v),
    # [n+E :] hold (v, u)
    u = rows[n : n + E]
    v = cols[n : n + E]
    u[:Eh] = idx[:, :-1].ravel()
    v[:Eh] = u[:Eh] + 1
    u[Eh : Eh + Ev] = idx[:-1, :].ravel()
    v[Eh : Eh + Ev] = u[Eh : Eh + Ev] + W
    flip = rng.random(Ed) < 0.5  # per-quad diagonal choice
    np.copyto(
        u[Eh + Ev :],
        np.where(flip, idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()),
    )
    v[Eh + Ev :] = u[Eh + Ev :] + np.where(flip, W + 1, W - 1)
    w = rng.random(E) + 0.5
    diag = (
        shift
        + np.bincount(u, weights=w, minlength=n)
        + np.bincount(v, weights=w, minlength=n)
    )
    rows[:n] = idx.ravel()
    cols[:n] = rows[:n]
    vals[:n] = diag
    vals[n : n + E] = -w
    vals[n + E :] = -w
    rows[n + E :] = v
    cols[n + E :] = u
    if shuffle:
        sh = rng.permutation(n)
        rows[:] = sh[rows]
        cols[:] = sh[cols]
    return n, rows, cols, vals
