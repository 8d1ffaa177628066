#!/usr/bin/env python
"""The unstructured-at-scale recipe (no reference analogue — this is where
the library exceeds the reference's serial CSR solve): any-pattern matrix
-> RCM -> pruned block-DIA -> CG with the pair-AMG multilevel
preconditioner, all in the permuted frame, f32 on the device.  Every
level's product runs the pruned SpMV kernel (#10, ``csrc/pruned.cu``).

    python -m sigma_tpu_torch.examples.solvers.solver_example_5 [--device cpu]
"""

import numpy as np
import torch

from sigma_tpu_torch import CSRMatrix
from sigma_tpu_torch.apps.generators import irregular_mesh_laplacian
from sigma_tpu_torch.examples._common import cli
from sigma_tpu_torch.matrix.banded import to_pruned_dia
from sigma_tpu_torch.solvers import cg_solve, pruned_pair_amg
from sigma_tpu_torch.utils import to_numpy
from sigma_tpu_torch.utils.device import resolve_device


def main(device=None) -> dict:
    device = resolve_device(device)
    rng = np.random.default_rng(7)
    # an irregular SPD operator: mesh-local couplings, shuffled labels
    A0 = irregular_mesh_laplacian(96, 32, rng=rng, shift=1e-2, dtype=np.float32, device=device)
    n = A0.shape[0]
    rr, cc, vv = A0.entries()
    sh = rng.permutation(n)
    A = CSRMatrix.from_coo(n, n, sh[rr], sh[cc], vv, dtype=np.float32, device=device)

    # pack: RCM reorder + only the active (row-tile x diagonal) blocks
    P, p = to_pruned_dia(A, tile_rows=1024, group=4)
    out = {"n": n, "stored_slots": int(P.stored_slots), "nnz": int(P.nnz),
           "local_occupancy": P.nnz / P.stored_slots}
    print(f"n={n}: packed {P.stored_slots} slots for {P.nnz} nonzeros "
          f"(local occupancy {P.nnz / P.stored_slots:.2f})")

    xstar = rng.standard_normal(n).astype(np.float32)
    b = to_numpy(A.matvec(torch.from_numpy(xstar).to(device)))
    b_p = np.empty_like(b)
    b_p[p] = b  # into the permuted frame
    b_p = torch.from_numpy(b_p).to(device)

    x0, info0 = cg_solve(P, b_p, tol=0.0, rtol=1e-8, maxiter=2000)
    rows, cols, vals = A.entries()
    M = pruned_pair_amg(n, p[rows], p[cols], vals, coarse_size=256,
                        tile_rows=1024, group=4, fine_A=P)
    x1, info1 = cg_solve(P, b_p, tol=0.0, rtol=1e-8, maxiter=2000, M=M)
    err = float(np.abs(to_numpy(x1)[p] - xstar).max())
    out.update(plain_iterations=int(info0.iterations), amg_iterations=int(info1.iterations),
               levels=len(M.levels), err=err)
    print(f"plain CG:      {int(info0.iterations)} iterations")
    print(f"pair-AMG CG:   {int(info1.iterations)} iterations "
          f"({len(M.levels)} pruned levels), max err {err:.2e}")
    return out


if __name__ == "__main__":
    main(**cli(__doc__))
