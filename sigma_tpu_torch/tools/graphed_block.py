#!/usr/bin/env python3
"""Graphed CG solves at several block sizes, beside the eager loop.

    python3 sigma_tpu_torch/tools/graphed_block.py [--nx 216] [--blocks 8,16,32,64]

The solves of ``chip_smoke.py``'s phases 9-10b at nx^3, f32: CG on
Laplacian + I (rtol 1e-6), and on the Dirichlet Poisson stencil in
symmetric storage plain CG and GMG-CG with the Jacobi hierarchy (bf16
levels; rtol 2e-7).  For each block size, set as
``sigma_tpu_torch.solvers.graphed.BLOCK`` before a new ``graphed``
callable captures, every solve is called once to capture, then
``--repeats`` times from the cache, in turns with the eager solve; each
time is the host clock around a solve ended by a device synchronisation.
Prints the card's name and power limit, then one JSON line a solve and
block size: iterations, host reads, capture seconds, the median cached
and eager seconds and their seconds an iteration.  Every graphed result
is checked bit for bit against the eager one.  Needs a CUDA device.
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
    ap.add_argument("--blocks", default="8,16,32,64")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("graphed_block: no CUDA device")
    # the checkout that holds this script
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    from sigma_tpu_torch import (
        SymmetricDIAMatrix, cg_solve, graphed, laplacian_3d_dia, structured_pair_amg,
    )

    # the module (its name is shadowed by the function in the package)
    module = sys.modules["sigma_tpu_torch.solvers.graphed"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    dev, nx = torch.device("cuda", 0), args.nx
    A = laplacian_3d_dia(nx, torch.float32, dev)
    b = A.matvec(torch.sin(torch.arange(A.shape[0], dtype=torch.float32, device=dev) * 0.001))
    S = SymmetricDIAMatrix.from_dia(laplacian_3d_dia(nx, torch.float32, dev, diag=6.0))
    bs = S.matvec(torch.from_numpy(
        np.random.default_rng(0).standard_normal(S.shape[0]).astype(np.float32)).to(dev))
    Mj = structured_pair_amg(S, (nx, nx, nx), pairs_per_level=3, level_dtype=torch.bfloat16,
                             smoother="jacobi", n_smooth=1)
    solves = {
        "cg_laplacian_plus_i": (A, b, dict(tol=0.0, rtol=1e-6, maxiter=100)),
        "plain_cg_poisson": (S, bs, dict(tol=0.0, rtol=2e-7, maxiter=3000)),
        "gmg_jacobi": (S, bs, dict(tol=0.0, rtol=2e-7, maxiter=3000, M=Mj)),
    }

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for block in (int(v) for v in args.blocks.split(",")):
        module.BLOCK = block
        for label, (op, rhs, kw) in solves.items():
            (x, info), _ = timed(lambda: cg_solve(op, rhs, **kw))
            G = graphed(cg_solve)
            (y, gi), first = timed(lambda: G(op, rhs, **kw))
            eager, cached = [], []
            for _ in range(args.repeats):
                eager.append(timed(lambda: cg_solve(op, rhs, **kw))[1])
                (y, gi), secs = timed(lambda: G(op, rhs, **kw))
                cached.append(secs)
            if not (torch.equal(y, x) and gi.iterations == info.iterations):
                raise AssertionError(f"{label} at block {block}: graphed differs from eager")
            its = max(info.iterations, 1)
            print(json.dumps({
                "solve": label, "block": block, "iterations": info.iterations,
                "host_reads": G.host_reads, "capture_s": G.capture_seconds,
                "first_call_s": first, "cached_s": statistics.median(cached),
                "eager_s": statistics.median(eager),
                "cached_s_per_iteration": statistics.median(cached) / its,
                "eager_s_per_iteration": statistics.median(eager) / its,
                "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            }), flush=True)
            del G


if __name__ == "__main__":
    main()
