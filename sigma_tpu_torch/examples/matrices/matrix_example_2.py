#!/usr/bin/env python
"""Lazy operator algebra and explicit sparse algebra side by side (after
matrix_example_2.f90): L = A + B and Q = A @ B as lazy operators versus
materialized sparse results — same numbers, different costs.  The
explicit sum and product run once in the host library, and their results
are moved to the device where every matvec runs.

    python -m sigma_tpu_torch.examples.matrices.matrix_example_2 [--device cpu]
"""

import numpy as np
import torch

from sigma_tpu_torch import CSRMatrix, ELLMatrix, sparse_add, sparse_matmul
from sigma_tpu_torch.examples._common import cli
from sigma_tpu_torch.utils.device import resolve_device


def main(device=None) -> dict:
    device = resolve_device(device)
    rng = np.random.default_rng(2)
    n = 256
    dA = np.where(rng.random((n, n)) < 0.03, rng.standard_normal((n, n)), 0.0)
    dB = np.where(rng.random((n, n)) < 0.03, rng.standard_normal((n, n)), 0.0)
    A = CSRMatrix.from_dense(dA, device=device)
    B = ELLMatrix.from_dense(dB, device=device)

    x = torch.from_numpy(rng.standard_normal(n)).to(device)

    lazy_sum = A + B          # no new matrix: matvec = two matvecs
    lazy_prod = A @ B         # no new matrix: matvec = two chained matvecs
    expl_sum = sparse_add(A, B)
    expl_prod = sparse_matmul(A, B)

    out = {
        "sum_lazy_vs_explicit": float((lazy_sum.matvec(x) - expl_sum.matvec(x)).abs().max()),
        "prod_lazy_vs_explicit": float((lazy_prod.matvec(x) - expl_prod.matvec(x)).abs().max()),
        "product_shape": tuple(expl_prod.shape),
        "product_nnz": int(expl_prod.nnz),
    }
    print("sum  |lazy - explicit| =", out["sum_lazy_vs_explicit"])
    print("prod |lazy - explicit| =", out["prod_lazy_vs_explicit"])
    print("explicit product:", expl_prod)
    out["adjoint_check"] = float((A.T.matvec(x) - A.rmatvec(x)).abs().max())
    print("adjoint check:", out["adjoint_check"])
    return out


if __name__ == "__main__":
    main(**cli(__doc__))
