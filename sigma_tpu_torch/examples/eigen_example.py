#!/usr/bin/env python
"""Graph-Laplacian spectra via Lanczos (the reference's eigensolver layer,
applied as its apps intended): algebraic connectivity (Fiedler value) of a
small-world graph, and the spectral gap closing as rewiring drops.  The
Laplacians are f64 CSR on the device; each Lanczos run starts from a
vector of the example's numpy seed.

    python -m sigma_tpu_torch.examples.eigen_example [--device cpu]
"""

import numpy as np

from sigma_tpu_torch import CSRMatrix, eigensolve
from sigma_tpu_torch.apps import watts_strogatz
from sigma_tpu_torch.examples._common import cli
from sigma_tpu_torch.utils import to_numpy
from sigma_tpu_torch.utils.device import resolve_device


def laplacian_of(g, device):
    rows, cols = g.edges_numpy()
    deg = np.bincount(rows, minlength=g.shape[0]).astype(float)
    dense = np.diag(deg)
    dense[rows, cols] -= 1.0
    return CSRMatrix.from_dense(dense, device=device)


def main(device=None) -> dict:
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    n = 128
    out = {}
    for p in (0.0, 0.05, 0.3):
        g = watts_strogatz(n, 3, p, rng)
        L = laplacian_of(g, device)
        lam, V = eigensolve(L, v0=rng.standard_normal(n))
        lam = np.sort(to_numpy(lam))
        print(
            f"p={p:4}: lambda_2 (algebraic connectivity) = {lam[1]:.4f}, "
            f"lambda_max = {lam[-1]:.2f}"
        )
        out[f"p={p}"] = {"lambda_2": float(lam[1]), "lambda_max": float(lam[-1])}
    print("(rewiring creates shortcuts: connectivity rises with p)")
    return out


if __name__ == "__main__":
    main(**cli(__doc__))
