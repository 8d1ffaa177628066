#!/usr/bin/env python
"""2-D Poisson with P1 finite elements (the worked version of the
reference's unbuilt ``examples/fem.f90`` module): assemble stiffness on a
triangulated unit square, apply Dirichlet BCs, solve with IC(0)-CG, and
check against the manufactured solution u = sin(pi x) sin(pi y).  The
matrices are f64 CSR on the device; IC(0) is ``ldu(incomplete=True)``.

    python -m sigma_tpu_torch.examples.fem_poisson [--device cpu]
"""

import numpy as np
import torch

from sigma_tpu_torch.examples._common import cli
from sigma_tpu_torch.fem import (
    gradient_2d,
    interior_dirichlet,
    mass_2d,
    stiffness_2d,
    unit_square_mesh,
)
from sigma_tpu_torch.solvers import cg_solve, ldu
from sigma_tpu_torch.utils import to_numpy
from sigma_tpu_torch.utils.device import resolve_device


def main(device=None) -> dict:
    device = resolve_device(device)
    nx = 32
    coords, ele = unit_square_mesh(nx)
    n = coords.shape[0]
    print(f"mesh: {n} nodes, {len(ele)} elements")

    A = stiffness_2d(coords, ele, dtype=torch.float64, device=device)
    M = mass_2d(coords, ele, dtype=torch.float64, device=device)

    # manufactured solution: -lap(u) = f with u = sin(pi x) sin(pi y)
    xs, ys = coords[:, 0], coords[:, 1]
    u_exact = np.sin(np.pi * xs) * np.sin(np.pi * ys)
    f = 2 * np.pi**2 * u_exact
    b = M.matvec(torch.from_numpy(f).to(device))  # weak-form load vector

    on_boundary = (
        (xs == 0) | (xs == 1) | (ys == 0) | (ys == 1)
    )
    Aii, bi = interior_dirichlet(A, b, on_boundary)

    ui, info = cg_solve(Aii, bi, tol=1e-12, M=ldu(incomplete=True).setup(Aii))
    u = np.zeros(n)
    u[~on_boundary] = to_numpy(ui)

    err = np.max(np.abs(u - u_exact))
    print(f"CG iterations: {int(info.iterations)}")
    print(f"max nodal error: {err:.2e} (expect O(h^2) ~ {1.0 / nx**2:.1e})")

    g = gradient_2d(coords, ele, u)
    centroids = coords[ele].mean(axis=1)
    gx = np.pi * np.cos(np.pi * centroids[:, 0]) * np.sin(np.pi * centroids[:, 1])
    gy = np.pi * np.sin(np.pi * centroids[:, 0]) * np.cos(np.pi * centroids[:, 1])
    g_err = np.max(np.abs(g - np.stack([gx, gy], axis=1)))
    print(f"max element-gradient error: {g_err:.2e} (expect O(h) ~ {1.0 / nx:.1e})")
    return {"nodes": int(n), "elements": int(len(ele)), "iterations": int(info.iterations),
            "nodal_error": float(err), "gradient_error": float(g_err)}


if __name__ == "__main__":
    main(**cli(__doc__))
