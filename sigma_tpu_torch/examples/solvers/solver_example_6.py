#!/usr/bin/env python
"""The unstructured-at-scale recipe end-to-end at example size (no
reference analogue — this is the capability set the other solver
examples build toward): an irregular SPD mesh through

1. the host-only setup pipeline (COO -> RCM reorder, no device bounces),
2. SYMMETRIC pruned block-DIA storage (upper triangle + in-kernel
   mirror; half the value stream of full pruned),
3. the symmetric pruned multilevel preconditioner,
4. the in-code skew router for a nonsymmetric variant (pair-AMG helps
   elliptic-dominant operators and HURTS strongly skewed ones — the
   router measures ||A - A^T||_F / ||A + A^T||_F and decides), and
5. FGMRES with an inner Krylov solve as the preconditioner.

f32 on the device.  The symmetric storage's products run the symmetric
pruned SpMV kernel (#12, ``csrc/pruned.cu``), the full storage's and the
nonsymmetric levels' the pruned SpMV (#10); every solve runs eagerly.  At
the 10,092,544-row mesh (``chip_profile.py --paths unstructured``, the
median of five warm solves on an NVIDIA H100 80GB HBM3 at 700 W)
pruned-multigrid CG takes 33 iterations, 105.0 ms on symmetric and 129.9
ms on full storage, against plain CG's 290 in 201.7 and 265.7 ms.

    python -m sigma_tpu_torch.examples.solvers.solver_example_6 [--device cpu]
"""

import numpy as np
import torch

from sigma_tpu_torch.apps import irregular_mesh_laplacian_coo
from sigma_tpu_torch.examples._common import cli
from sigma_tpu_torch.matrix.banded import reorder_triples_rcm
from sigma_tpu_torch.matrix.pruned import (
    PrunedDIAMatrix,
    SymmetricPrunedDIAMatrix,
)
from sigma_tpu_torch.solvers import (
    auto_pruned_preconditioner,
    bicgstab_solve,
    cg_solve,
    fgmres_solve,
    pruned_pair_amg,
)
from sigma_tpu_torch.utils import to_numpy
from sigma_tpu_torch.utils.device import resolve_device


def main(device=None) -> dict:
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    # 1. shuffled irregular mesh -> RCM, all on the host
    n, rows, cols, vals = irregular_mesh_laplacian_coo(
        96, 32, rng=rng, shift=1e-2, shuffle=True
    )
    pr, pc, vals, p = reorder_triples_rcm(n, rows, cols, vals)
    vals = vals.astype(np.float32)  # one dtype end-to-end
    out = {"n": n, "nnz": int(rows.size), "bandwidth": int(np.abs(pc - pr).max())}
    print(f"mesh: n={n}, nnz={rows.size}, "
          f"bandwidth after RCM={out['bandwidth']}")

    # 2. symmetric pruned storage (the SPD fast path)
    S = SymmetricPrunedDIAMatrix.from_coo(
        n, n, pr, pc, vals, dtype=np.float32, tile_rows=1024, group=4, device=device
    )
    P = PrunedDIAMatrix.from_coo(
        n, n, pr, pc, vals, dtype=np.float32, tile_rows=1024, group=4, device=device
    )
    out.update(full_slots=int(P.stored_slots), symmetric_slots=int(S.stored_slots),
               slot_ratio=P.stored_slots / S.stored_slots)
    print(f"packed slots: full {P.stored_slots}, "
          f"symmetric {S.stored_slots} "
          f"({P.stored_slots / S.stored_slots:.2f}x fewer)")

    # 3. symmetric multilevel preconditioner + CG (in the RCM frame:
    #    permute b in, solution out)
    M = pruned_pair_amg(n, pr, pc, vals, coarse_size=512, tile_rows=1024,
                        group=4, symmetric=True, validate=False, device=device)
    xstar = rng.standard_normal(n).astype(np.float32)
    xs = torch.from_numpy(xstar).to(device)
    b = S.matvec(xs)
    x_pl, info_pl = cg_solve(S, b, tol=0.0, rtol=1e-8, maxiter=500)
    x_mg, info_mg = cg_solve(S, b, tol=0.0, rtol=1e-8, maxiter=500, M=M)
    err = float(np.abs(to_numpy(x_mg) - xstar).max())
    out.update(cg_plain_iterations=int(info_pl.iterations),
               cg_gmg_iterations=int(info_mg.iterations), levels=len(M.levels), cg_gmg_err=err)
    print(f"CG plain: {int(info_pl.iterations)} iterations; "
          f"+sym-GMG: {int(info_mg.iterations)}; "
          f"err {err:.2e}")

    # 4. a nonsymmetric variant through the skew router
    skew = (vals + 0.05 * np.sign(pc - pr) * np.abs(vals)).astype(np.float32)
    Mn, route = auto_pruned_preconditioner(
        n, pr, pc, skew, coarse_size=512, tile_rows=1024, group=4,
        smoother="jacobi", device=device,
    )
    out.update(skew_dominance=float(route["skew_dominance"]), route=route["route"])
    print(f"router: skew_dominance={route['skew_dominance']:.4f} -> "
          f"{route['route']}")
    Pn = PrunedDIAMatrix.from_coo(n, n, pr, pc, skew, dtype=np.float32,
                                  tile_rows=1024, group=4, device=device)
    bn = Pn.matvec(xs)
    xn, infon = bicgstab_solve(Pn, bn, tol=0.0, rtol=1e-8, maxiter=500, M=Mn)
    err = float(np.abs(to_numpy(xn) - xstar).max())
    out.update(bicgstab_iterations=int(infon.iterations), bicgstab_err=err)
    print(f"BiCG-stab via route: {int(infon.iterations)} iterations, "
          f"err {err:.2e}")

    # 5. FGMRES with an inner fixed-iteration Krylov preconditioner
    xf, infof = fgmres_solve(
        # rtol 1e-6: f32 FGMRES residuals floor near 1e-7 — a tighter
        # target just exhausts maxiter after converging
        Pn, bn, tol=0.0, rtol=1e-6, restart=30, maxiter=300,
        M=lambda v: bicgstab_solve(Pn, v, tol=0.0, maxiter=4)[0],
    )
    err = float(np.abs(to_numpy(xf) - xstar).max())
    out.update(fgmres_iterations=int(infof.iterations), fgmres_err=err)
    print(f"FGMRES(inner BiCG-stab x4): {int(infof.iterations)} outer "
          f"iterations, err {err:.2e}")
    return out


if __name__ == "__main__":
    main(**cli(__doc__))
