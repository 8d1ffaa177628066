#!/usr/bin/env python3
"""Where the device time of the port's solves goes, on one GPU.

    python3 chip_profile.py [--nx 216] [--out chiprun_out/profile.txt]

Runs the solves of ``chip_smoke.py``'s phases 4 and 5 through the same
entry points (CG and fused CG on Laplacian + I; plain CG and GMG-CG with
the Jacobi and the Chebyshev smoother on pure Poisson), each five times
warm and untraced and once under ``torch.profiler``, and prints one JSON
line per solve:

- ``device_busy_ms``: the union of the kernel and copy intervals in the
  trace;
- ``wall_ms``: the median of five untraced warm solves, host clock;
- ``idle_share``: 1 - device_busy_ms / wall_ms;
- ``device_ops``: the number of kernels and copies the solve ran;
- ``dia_kernels_ms``: the device time of the port's DIA SpMV kernels;
- ``top``: the kernels that take the most device time, as
  [name, ms, launches].

Every kernel, by device time, goes to ``--out``.  The card's name and
power limit come first, as nvidia-smi gives them.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import os
import statistics
import sys
import time

from chip_smoke import emit, phase_device


def _solves(device, nx):
    """(label, solve) pairs: chip_smoke.py's phase 4 and 5 solves."""
    import numpy as np
    import torch

    from sigma_tpu_torch import (
        SymmetricDIAMatrix, cg_fused_solve, cg_solve, laplacian_3d_dia,
        structured_pair_amg,
    )

    A = laplacian_3d_dia(nx, torch.float32, device)
    b = A.matvec(torch.sin(torch.arange(A.shape[0], dtype=torch.float32, device=device) * 0.001))
    yield "cg_solve", lambda: cg_solve(A, b, tol=0.0, rtol=1e-6, maxiter=100)
    yield "cg_fused_solve", lambda: cg_fused_solve(A, b, tol=0.0, rtol=1e-6, maxiter=100)
    del A, b

    S = SymmetricDIAMatrix.from_dia(laplacian_3d_dia(nx, torch.float32, device, diag=6.0))
    xstar = np.random.default_rng(0).standard_normal(S.shape[0]).astype(np.float32)
    bs = S.matvec(torch.from_numpy(xstar).to(device))
    yield "plain_cg_poisson", lambda: cg_solve(S, bs, tol=0.0, rtol=2e-7, maxiter=3000)
    for label, kw in (
        ("gmg_jacobi", dict(smoother="jacobi", n_smooth=1)),
        ("gmg_chebyshev", dict(smoother="chebyshev", n_smooth=4)),
    ):
        M = structured_pair_amg(
            S, (nx, nx, nx), pairs_per_level=3, level_dtype=torch.bfloat16, **kw
        )
        yield label, lambda M=M: cg_solve(S, bs, tol=0.0, rtol=2e-7, maxiter=3000, M=M)


def _device_events(prof):
    """(start_us, end_us, name) of every kernel and copy in the trace."""
    from torch.autograd import DeviceType

    return [
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    ]


def _union_us(events) -> float:
    busy, end = 0.0, float("-inf")
    for s, e, _ in sorted(events):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=216, help="grid size (nx^3 rows)")
    ap.add_argument("--out", default="chiprun_out/profile.txt",
                    help="file for every kernel's device time per solve")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_profile: no CUDA device (torch.cuda.is_available() is false)")
    device = torch.device("cuda", 0)
    phase_device()

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as out:
        for label, solve in _solves(device, args.nx):
            solve()  # warm-up
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, info = solve()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            wall = statistics.median(walls)
            with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA],
            ) as prof:
                solve()
                torch.cuda.synchronize()
            events = _device_events(prof)
            if not events:
                raise RuntimeError(f"{label}: the profiler recorded no device time")
            by_name = collections.defaultdict(lambda: [0.0, 0])
            for s, e, name in events:
                by_name[name][0] += (e - s) / 1e3
                by_name[name][1] += 1
            ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
            busy_ms = _union_us(events) / 1e3
            emit({
                "phase": "profile", "run": label, "iterations": info.iterations,
                "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
                "idle_share": 1.0 - busy_ms / (wall * 1e3),
                "device_ops": len(events),
                "dia_kernels_ms": sum(v[0] for k, v in ranked if "dia_" in k),
                "top": [[k[:70], v[0], v[1]] for k, v in ranked[:6]],
            })
            out.write(f"{label}: {info.iterations} iterations, device busy "
                      f"{busy_ms:.3f} ms, untraced wall {wall * 1e3:.3f} ms\n")
            for name, (ms, count) in ranked:
                out.write(f"  {ms:10.3f} ms  {count:6d}  {name}\n")
            out.write("\n")


if __name__ == "__main__":
    main()
