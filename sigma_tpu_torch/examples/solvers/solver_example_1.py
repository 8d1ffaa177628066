#!/usr/bin/env python
"""Iterative solving with and without preconditioning (after the
reference's examples/solvers/solver_example_1.f90): CG on a random graph
Laplacian + I, plain vs Jacobi-preconditioned vs IC(0), in f64 on the
device.  IC(0) is ``ldu(incomplete=True)``: its triangular solves are
level-scheduled sweeps, one batched update per dependency level.

    python -m sigma_tpu_torch.examples.solvers.solver_example_1 [--device cpu]
"""

import numpy as np
import torch

from sigma_tpu_torch import CSRMatrix
from sigma_tpu_torch.examples._common import cli
from sigma_tpu_torch.solvers import cg_solve, jacobi, ldu
from sigma_tpu_torch.utils import to_numpy
from sigma_tpu_torch.utils.device import resolve_device


def main(device=None) -> dict:
    device = resolve_device(device)
    rng = np.random.default_rng(3)
    n, p = 512, 0.02
    adj = np.triu(rng.random((n, n)) < p, 1)
    adj = adj | adj.T
    dA = np.diag(adj.sum(1).astype(float)) - adj + np.eye(n)
    A = CSRMatrix.from_dense(dA, device=device)

    xstar = rng.standard_normal(n)
    b = torch.from_numpy(dA @ xstar).to(device)

    out = {}
    for key, label, M in (("plain", "plain CG:  ", None),
                          ("jacobi", "jacobi CG: ", jacobi().setup(A)),
                          ("ic0", "IC(0) CG:  ", ldu(incomplete=True).setup(A))):
        x, info = cg_solve(A, b, tol=1e-12, M=M)
        err = float(np.max(np.abs(to_numpy(x) - xstar)))
        print(f"{label} {int(info.iterations)} iterations, err {err:.2e}")
        out[key] = {"iterations": int(info.iterations), "err": err}
    return out


if __name__ == "__main__":
    main(**cli(__doc__))
