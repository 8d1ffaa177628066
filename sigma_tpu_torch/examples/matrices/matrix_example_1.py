#!/usr/bin/env python
"""Random walk on a directed random graph via the transition matrix (after
the reference's examples/matrices/matrix_example_1.f90): build P with
P[i, j] = 1/deg(i) for each edge, evolve a distribution with rmatvec
(rho_{t+1} = P^T rho_t), and watch the entropy rise to the stationary value.
The 50 products run on the device in f64 (plain PyTorch, as in the JAX
package: CSR has no hand-written kernel).

    python -m sigma_tpu_torch.examples.matrices.matrix_example_1 [--device cpu]
"""

import numpy as np
import torch

from sigma_tpu_torch import CSRMatrix
from sigma_tpu_torch.examples._common import cli
from sigma_tpu_torch.utils import to_numpy
from sigma_tpu_torch.utils.device import resolve_device


def main(device=None) -> dict:
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    n, p = 512, 0.02
    mask = rng.random((n, n)) < p
    np.fill_diagonal(mask, False)
    mask[mask.sum(1) == 0, 0] = True  # no dangling vertices
    rows, cols = np.nonzero(mask)

    deg = np.bincount(rows, minlength=n)
    P = CSRMatrix.from_coo(n, n, rows, cols, 1.0 / deg[rows], dtype=torch.float64, device=device)

    rho = torch.zeros(n, dtype=torch.float64, device=device)
    rho[0] = 1.0  # start at vertex 0
    for t in range(50):
        rho = P.rmatvec(rho)
    rho_np = to_numpy(rho)
    entropy = -np.sum(np.where(rho_np > 0, rho_np * np.log(rho_np), 0.0))
    print(f"entropy after 50 steps: {entropy:.4f} (max {np.log(n):.4f})")
    print(f"total probability: {rho_np.sum():.6f}")
    return {"entropy": float(entropy), "max_entropy": float(np.log(n)),
            "total_probability": float(rho_np.sum())}


if __name__ == "__main__":
    main(**cli(__doc__))
