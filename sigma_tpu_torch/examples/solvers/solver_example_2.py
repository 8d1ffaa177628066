#!/usr/bin/env python
"""Beyond the reference: the solver extensions working together.

On one 2-D Poisson problem: smoothed-aggregation AMG (V-cycle pc),
Chebyshev polynomial preconditioning, block CG for 8 right-hand sides at
once, and LOBPCG for the lowest eigenpairs — all composed from the same
operator/preconditioner protocols the reference pioneered.  Everything is
f64 CSR on the device; the AMG hierarchy is set up in the host library.

LOBPCG starts from ``X0`` when given (an (n, 4) array or tensor); without it from
the port's own seeded normal draw (``lobpcg``'s generator seeded with 0),
which is not the JAX package's ``PRNGKey(0)`` block, so its iteration
count may differ from that package's by one or two.

    python -m sigma_tpu_torch.examples.solvers.solver_example_2 [--device cpu]
"""

import numpy as np
import torch

from sigma_tpu_torch import CSRMatrix, lobpcg
from sigma_tpu_torch.examples._common import cli
from sigma_tpu_torch.solvers import (
    block_cg_solve,
    cg_solve,
    chebyshev,
    smoothed_aggregation_amg,
)
from sigma_tpu_torch.utils import to_numpy
from sigma_tpu_torch.utils.device import resolve_device


def laplacian_2d(nx):
    n = nx * nx
    idx = np.arange(n).reshape(nx, nx)
    d = 4 * np.eye(n)
    for ax in range(2):
        s = np.take(idx, np.arange(nx - 1), axis=ax).ravel()
        t = np.take(idx, np.arange(1, nx), axis=ax).ravel()
        d[s, t] = -1
        d[t, s] = -1
    return d


def main(device=None, X0=None) -> dict:
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    nx = 32
    dense = laplacian_2d(nx)
    n = nx * nx
    A = CSRMatrix.from_dense(dense, device=device)
    xstar = rng.standard_normal(n)
    b = torch.from_numpy(dense @ xstar).to(device)
    out = {}

    _, plain = cg_solve(A, b, tol=1e-11)
    out["plain_iterations"] = int(plain.iterations)
    print(f"plain CG:        {int(plain.iterations):4d} iterations")

    amg = smoothed_aggregation_amg(A)
    _, info = cg_solve(A, b, tol=1e-11, M=amg)
    out.update(amg_iterations=int(info.iterations), amg_levels=len(amg.levels) + 1)
    print(f"AMG-CG:          {int(info.iterations):4d} iterations "
          f"({len(amg.levels) + 1} levels)")

    ev = np.linalg.eigvalsh(dense)
    cheb = chebyshev(A, degree=8, lmax=ev.max() * 1.05, lmin=ev.min())
    _, info = cg_solve(A, b, tol=1e-11, M=cheb)
    out["chebyshev_iterations"] = int(info.iterations)
    print(f"Chebyshev(8)-CG: {int(info.iterations):4d} iterations")

    B = torch.from_numpy(dense @ rng.standard_normal((n, 8))).to(device)
    _, info = block_cg_solve(A, B, tol=1e-10, M=amg)
    out["block_cg_iterations"] = int(info.iterations)
    print(f"block CG (8 rhs):{int(info.iterations):4d} iterations "
          "(one SpMM each)")

    if X0 is not None:
        X0 = X0 if isinstance(X0, torch.Tensor) else torch.from_numpy(np.array(X0))
        X0 = X0.to(device=device, dtype=torch.float64)
    res = lobpcg(A, X0, m=4, M=amg, tol=1e-7, maxiter=200)
    lam = np.sort(to_numpy(res.eigenvalues))
    exact = ev[:4]
    out.update(lobpcg_eigenvalues=[float(v) for v in lam], lobpcg_iterations=int(res.iterations),
               exact_eigenvalues=[float(v) for v in exact])
    print(f"LOBPCG lowest 4: {lam.round(5)} in {int(res.iterations)} "
          f"iterations (exact: {exact.round(5)})")
    return out


if __name__ == "__main__":
    main(**cli(__doc__))
