#!/usr/bin/env python3
"""Plain f64 CG against the mixed-precision refinement ladder, in turns.

    python3 sigma_tpu_torch/tools/compare_refinement.py [--nx 216] [--repeats 7]

The four solves of ``chip_smoke.py``'s refinement path on the Dirichlet
Poisson stencil at nx^3 (symmetric storage, f64, relative-residual target
1e-10, xstar from ``default_rng(0)``): (a) ``cg_solve`` + Chebyshev GMG
with f64 levels; (b) ``refined_solve`` with an f32 inner GMG-CG (f32
operator and levels); (c) as (b) with the inner operator's values in bf16
(exact for this stencil); (d) ``minres_solve`` with (a)'s M.  Each solve
runs once to warm up, then ``--repeats`` rounds, the order of the four
reversed every other round; a solve's time is the host clock around it,
ended by a device synchronisation.  Prints the card's name and power limit,
then one JSON line a solve (iterations, outer sweeps and inner iterations
for the ladder, the recomputed true relative residual, every round's
seconds, their median and quartiles), then one line naming the fastest
median.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=216)
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--rtol", type=float, default=1e-10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_refinement: no CUDA device")
    # the checkout that holds this script
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    from sigma_tpu_torch import (
        SymmetricDIAMatrix, cg_solve, laplacian_3d_dia, minres_solve, refined_solve,
        structured_pair_amg,
    )
    from sigma_tpu_torch.ops import dia_sym_spmv_reference

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    dev, nx, rtol = torch.device("cuda", 0), args.nx, args.rtol
    S = SymmetricDIAMatrix.from_dia(laplacian_3d_dia(nx, torch.float64, dev, diag=6.0))
    n = S.shape[0]

    def cast(dtype):
        return SymmetricDIAMatrix(data=S.data.to(dtype), offsets=S.offsets, n=S.n)

    S32, Sbf = cast(torch.float32), cast(torch.bfloat16)
    gmg = dict(pairs_per_level=3, smoother="chebyshev", n_smooth=4)
    M64 = structured_pair_amg(S, (nx, nx, nx), **gmg)
    M32 = structured_pair_amg(S32, (nx, nx, nx), **gmg)
    xstar = torch.from_numpy(np.random.default_rng(0).standard_normal(n)).to(dev)
    b = dia_sym_spmv_reference(S.data, xstar, S.offsets_dev, n)
    inner = []

    def counted_cg(A, r, **kw):
        x, info = cg_solve(A, r, **kw)
        inner.append(info.iterations)
        return x, info

    runs = {
        "a_cg_f64": lambda: cg_solve(S, b, tol=0.0, rtol=rtol, maxiter=3000, M=M64),
        "b_refined_f32": lambda: refined_solve(S, b, tol=0.0, rtol=rtol, A_lo=S32, M_lo=M32,
                                               inner_solver=counted_cg),
        "c_refined_bf16_values": lambda: refined_solve(S, b, tol=0.0, rtol=rtol, A_lo=Sbf,
                                                       M_lo=M32, inner_solver=counted_cg),
        "d_minres_f64": lambda: minres_solve(S, b, tol=0.0, rtol=rtol, maxiter=3000, M=M64),
    }
    rows = {}
    for label, run in runs.items():  # warm-up, and the results
        inner.clear()
        x, info = run()
        rel = float(torch.linalg.vector_norm(b - S.matvec(x)) / torch.linalg.vector_norm(b))
        rows[label] = {"run": label, "n": n, "iterations": info.iterations,
                       "converged": info.converged, "inner_iterations": sum(inner) or None,
                       "relative_residual": rel, "seconds": []}
    order = list(runs)
    for r in range(args.repeats):
        for label in order if r % 2 == 0 else order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[label]()
            torch.cuda.synchronize()
            rows[label]["seconds"].append(time.perf_counter() - t0)
    for row in rows.values():
        q = statistics.quantiles(row["seconds"], n=4)
        row.update(median_s=statistics.median(row["seconds"]), q1_s=q[0], q3_s=q[2])
        print(json.dumps(row), flush=True)
    print(json.dumps({"fastest": min(rows, key=lambda k: rows[k]["median_s"]),
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
