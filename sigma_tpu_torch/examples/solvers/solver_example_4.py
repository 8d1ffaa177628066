#!/usr/bin/env python
"""The general-sparsity recipe end to end: an unstructured (irregular,
arbitrarily labeled) SPD matrix solved through the pipeline

    RCM reorder -> banded DIA (-> symmetric upper-only storage) -> CG

General sparsity is served structurally: ``to_banded_dia`` reorders into a
band and stores every band diagonal densely, assembled on the device;
the band's products run the DIA SpMV kernel (#1, ``csrc/dia_spmv.cu``),
and the symmetric band's the symmetric one (#2), at memory rate rather
than a gather a nonzero.  The ``route:`` line names the kernel that serves
the band's product on this device.  f32 throughout.

Small by default so it runs anywhere; at ``--height 16384 --width 64``
(1,048,576 rows, ``benchmarks/unstructured.py``'s mesh) the full band
holds 245 diagonals, and on an NVIDIA H100 80GB HBM3 at 700 W a CG
iteration on it takes 0.51 ms (``chip_smoke.py`` phase 17).

    python -m sigma_tpu_torch.examples.solvers.solver_example_4 [--device cpu]
        [--height 120] [--width 40]
"""

import numpy as np
import torch

from sigma_tpu_torch import CSRMatrix
from sigma_tpu_torch.apps.generators import irregular_mesh_laplacian
from sigma_tpu_torch.examples._common import cli
from sigma_tpu_torch.matrix.banded import band_occupancy, bandwidth, to_banded_dia
from sigma_tpu_torch.matrix.symmetric import SymmetricDIAMatrix
from sigma_tpu_torch.solvers import cg_solve
from sigma_tpu_torch.utils import to_numpy
from sigma_tpu_torch.utils.device import resolve_device


def route(D) -> str:
    """The kernel that serves D's matvec on its device."""
    if D.data.device.type != "cuda":
        return f"plain version ({D.data.device.type})"
    if isinstance(D, SymmetricDIAMatrix):
        return "dia_sym_spmv (#2, csrc/dia_spmv.cu)"
    return "dia_spmv (#1, csrc/dia_spmv.cu)"


def main(device=None, height=120, width=40) -> dict:
    device = resolve_device(device)
    rng = np.random.default_rng(7)
    A = irregular_mesh_laplacian(height, width, rng=rng, dtype=torch.float32, device=device)
    n = A.shape[0]
    # matrices arrive in arbitrary labelings; shuffle to make that real
    rr, cc, vv = A.entries()
    sh = rng.permutation(n)
    A = CSRMatrix.from_coo(n, n, sh[rr], sh[cc], vv, dtype=torch.float32, device=device)
    out = {"n": n, "nnz": int(A.graph.nnz), "input_bandwidth": bandwidth(A)}
    print(f"n={n}, nnz={A.graph.nnz}, input bandwidth {out['input_bandwidth']}")

    D, p = to_banded_dia(A)  # RCM + dense-diagonal refreeze
    out.update(stored_diagonals=int(D.graph.n_diags), occupancy_before=float(band_occupancy(A)),
               occupancy_after=A.graph.nnz / (n * D.graph.n_diags))
    print(
        f"after RCM: {D.graph.n_diags} stored diagonals, "
        f"occupancy {out['occupancy_before']:.4f} -> {out['occupancy_after']:.4f}"
    )
    # which kernel serves the band's product here
    out["kernel_route"] = route(D)
    print("route:", out["kernel_route"])

    # solve in the permuted frame: b_p[p] = b, x = x_p[p]
    xstar = np.sin(np.arange(n) * 0.01).astype(np.float32)
    b = to_numpy(A.matvec(torch.from_numpy(xstar).to(device)))
    b_p = np.empty_like(b)
    b_p[p] = b
    b_p = torch.from_numpy(b_p).to(device)
    x_p, info = cg_solve(D, b_p, tol=0.0, rtol=1e-6)
    err = float(np.abs(to_numpy(x_p)[p] - xstar).max())
    out["banded"] = {"iterations": int(info.iterations), "err": err}
    print(f"banded CG: {int(info.iterations)} iters, max err {err:.2e}")

    # the matrix is SPD: upper-only storage halves the value stream
    Ds = SymmetricDIAMatrix.from_dia(D)
    x_p, info = cg_solve(Ds, b_p, tol=0.0, rtol=1e-6)
    err = float(np.abs(to_numpy(x_p)[p] - xstar).max())
    out["symmetric"] = {"iterations": int(info.iterations), "err": err,
                        "upper_diagonals": len(Ds.offsets), "kernel_route": route(Ds)}
    print(
        f"symmetric-storage CG ({len(Ds.offsets)} upper diagonals): "
        f"{int(info.iterations)} iters, max err {err:.2e}"
    )
    return out


def _flags(ap):
    ap.add_argument("--height", type=int, default=120)
    ap.add_argument("--width", type=int, default=40)


if __name__ == "__main__":
    main(**cli(__doc__, _flags))
