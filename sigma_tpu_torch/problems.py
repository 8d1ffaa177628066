"""Model problems of the stencil main path, built directly in DIA layout.

Port of ``bench.laplacian_3d_dia``: the 7-point 3-D Laplacian with
analytic boundary masks, no COO sort.  The values are made on the
requested device (at nx=216 that spares a 282 MB host-to-device copy).
"""

from __future__ import annotations

import torch

from sigma_tpu_torch.graph.graph import DIAGraph
from sigma_tpu_torch.matrix.formats import DIAMatrix
from sigma_tpu_torch.utils.dtypes import round_up

__all__ = ["laplacian_3d_dia"]


def laplacian_3d_dia(nx, dtype=torch.float32, device=None, diag=7.0) -> DIAMatrix:
    """7-point Laplacian on an nx^3 grid (row-major, last axis fastest)
    with ``diag`` on the main diagonal: 7 gives Laplacian + I (the CG
    north star of ``benchmarks/cg3d.py``), 6 the pure Dirichlet Poisson
    operator of ``benchmarks/gmg3d.py``.  Entry for entry the matrix of
    ``bench.laplacian_3d_dia``."""
    n = nx * nx * nx
    offsets = (-nx * nx, -nx, -1, 0, 1, nx, nx * nx)
    i = torch.arange(n, device=device)
    iz = i % nx
    iy = (i // nx) % nx
    ix = i // (nx * nx)
    data = torch.zeros((7, round_up(n, 128)), dtype=dtype, device=device)
    data[3, :n] = diag
    for d, keep in (
        (4, iz < nx - 1),
        (2, iz > 0),
        (5, iy < nx - 1),
        (1, iy > 0),
        (6, ix < nx - 1),
        (0, ix > 0),
    ):
        data[d, :n].masked_fill_(keep, -1.0)
    nnz = int(torch.count_nonzero(data))
    graph = DIAGraph(offsets=offsets, shape=(n, n), nnz=nnz)
    return DIAMatrix(graph=graph, data=data)
