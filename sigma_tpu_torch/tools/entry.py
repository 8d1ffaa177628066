"""The port's counterpart of the repository's ``__graft_entry__.entry()``:
a fixed-budget CG forward step on the flagship workload.

``entry(device=None)`` returns ``(fn, (A, b))``: ``A`` is the 5-point
Laplacian + I of a 64 x 64 Dirichlet grid in DIA storage, f32, on the card
unless another device is given, ``b`` is ones, and ``fn(A, b)`` runs
``cg_solve(A, b, tol=1e-5, maxiter=50)`` and returns x.  Each CG step is
one DIA SpMV (#1, ``csrc/dia_spmv.cu``, on a CUDA tensor), dots and axpys;
the solve runs eagerly.
"""

from __future__ import annotations

import numpy as np


def _laplacian_2d(nx):
    """5-point stencil Laplacian + I on an nx*nx grid (Dirichlet), as
    symmetric COO triples: entry (i, j) = -1 iff j is the in-range grid
    neighbor of i along one axis."""
    n = nx * nx
    idx = np.arange(n).reshape(nx, nx)
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    vals = [np.full(n, 5.0)]
    for axis in range(2):
        src = np.take(idx, np.arange(nx - 1), axis=axis).ravel()
        dst = np.take(idx, np.arange(1, nx), axis=axis).ravel()
        rows.extend([src, dst])
        cols.extend([dst, src])
        vals.extend([np.full(src.size, -1.0)] * 2)
    return n, np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def entry(device=None):
    """(fn, example_args): the CG forward step on the DIA-format stencil
    operator (the gather-free speed-of-light path)."""
    import torch

    from sigma_tpu_torch import DIAMatrix
    from sigma_tpu_torch.solvers import cg_solve

    n, r, c, v = _laplacian_2d(64)
    A = DIAMatrix.from_coo(n, n, r, c, v, dtype=torch.float32, device=device)
    b = torch.ones((n,), dtype=torch.float32, device=A.device)

    def fn(A, b):
        x, info = cg_solve(A, b, tol=1e-5, maxiter=50)
        return x

    return fn, (A, b)

