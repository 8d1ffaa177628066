"""Model problems of the unstructured path.

Port of ``irregular_mesh_laplacian_coo`` and ``irregular_mesh_laplacian`` of
:mod:`sigma_tpu.apps.generators`: the weighted graph Laplacian (+ ``shift``
I) of a randomly triangulated H x W quad mesh, as host COO triples or as a
:class:`~sigma_tpu_torch.matrix.formats.CSRMatrix`.  It is host numpy
driven by the caller's ``np.random.Generator``, so a seed gives bitwise the
same matrix as the JAX package.
"""

from __future__ import annotations

import numpy as np

__all__ = ["irregular_mesh_laplacian", "irregular_mesh_laplacian_coo"]


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
