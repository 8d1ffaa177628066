#!/usr/bin/env python
"""Multigrid on a structured grid (no reference analogue; the multilevel
intent of the reference's src/solver/README.md realized gather-free): a
3-D Dirichlet Poisson problem in DIA form, solved with plain CG, then CG
preconditioned by structured pair-aggregation multigrid — aggregates are
grid-cell pairs, transfers are reshapes/repeats, and the Galerkin coarse
operators are computed in closed form on the diagonal value grids (a
7-point stencil stays 7-point on every level).  Every level's product
runs the DIA SpMV kernel (#1, ``csrc/dia_spmv.cu``) on the card; the solve
runs eagerly, one host read of the residual a step.

2x2x2 cube aggregates give a 3x shallower hierarchy of similar quality.
At the 10M-row stencil (nx=216, f32, rtol 1e-6; ``chip_smoke.py`` phase
10 on an NVIDIA H100 80GB HBM3 at 700 W) plain CG takes 288 iterations in
0.128-0.136 s and GMG-CG 28 in 0.077-0.118 s: the coarse levels of the
V-cycle are launch-bound, so the host's speed sets much of its time.

    python -m sigma_tpu_torch.examples.solvers.solver_example_3 [--device cpu]
"""

import numpy as np
import torch

from sigma_tpu_torch import DIAMatrix
from sigma_tpu_torch.examples._common import cli
from sigma_tpu_torch.solvers import cg_solve, structured_pair_amg
from sigma_tpu_torch.utils import to_numpy
from sigma_tpu_torch.utils.device import resolve_device


def poisson_3d(nx, device):
    """Pure Dirichlet Laplacian on an nx^3 grid, directly in DIA form."""
    n = nx**3
    i = np.arange(n)
    iz, iy, ix = i % nx, (i // nx) % nx, i // (nx * nx)
    rows, cols, vals = [i], [i], [np.full(n, 6.0)]
    for o, mk in (
        (1, iz < nx - 1), (-1, iz > 0),
        (nx, iy < nx - 1), (-nx, iy > 0),
        (nx * nx, ix < nx - 1), (-nx * nx, ix > 0),
    ):
        rows.append(i[mk])
        cols.append(i[mk] + o)
        vals.append(np.full(mk.sum(), -1.0))
    return DIAMatrix.from_coo(
        n, n, np.concatenate(rows), np.concatenate(cols),
        np.concatenate(vals), dtype=torch.float64, device=device,
    )


def main(device=None) -> dict:
    device = resolve_device(device)
    nx = 24
    dims = (nx, nx, nx)
    A = poisson_3d(nx, device)
    n = A.shape[0]
    rng = np.random.default_rng(0)
    xstar = rng.standard_normal(n)
    b = A.matvec(torch.from_numpy(xstar).to(device))
    out = {"n": n}

    x, info = cg_solve(A, b, tol=0.0, rtol=1e-10, maxiter=2000)
    err = float(np.max(np.abs(to_numpy(x) - xstar)))
    out["plain"] = {"iterations": int(info.iterations), "err": err}
    print(f"plain CG:        {int(info.iterations):4d} iterations, err {err:.2e}")

    # pairwise aggregates (2 cells per aggregate, deepest hierarchy)
    M = structured_pair_amg(A, dims)
    x, info = cg_solve(A, b, tol=0.0, rtol=1e-10, M=M, maxiter=2000)
    err = float(np.max(np.abs(to_numpy(x) - xstar)))
    out["pairs"] = {"iterations": int(info.iterations), "err": err, "levels": len(M.levels)}
    print(f"CG + MG (pairs): {int(info.iterations):4d} iterations, "
          f"err {err:.2e}, {len(M.levels)} levels")

    # 2x2x2 cube aggregates: 3x shallower hierarchy, similar quality
    M8 = structured_pair_amg(A, dims, pairs_per_level=3)
    x, info = cg_solve(A, b, tol=0.0, rtol=1e-10, M=M8, maxiter=2000)
    err = float(np.max(np.abs(to_numpy(x) - xstar)))
    out["cubes"] = {"iterations": int(info.iterations), "err": err, "levels": len(M8.levels)}
    print(f"CG + MG (cubes): {int(info.iterations):4d} iterations, "
          f"err {err:.2e}, {len(M8.levels)} levels (eager end-to-end)")
    return out


if __name__ == "__main__":
    main(**cli(__doc__))
