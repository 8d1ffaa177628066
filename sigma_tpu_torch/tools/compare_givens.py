#!/usr/bin/env python3
"""Time GMRES's Givens kernel (``csrc/givens.cu``) of one checkout by
CUDA-graph replay, and graphed GMRES(32) and FGMRES(32) + GMG with it.

    python3 sigma_tpu_torch/tools/compare_givens.py [--repo DIR] [--nx 216]

Imports ``sigma_tpu_torch`` from ``--repo`` (by default the checkout that
holds this script), so one copy of the script times two checkouts of the
port, for example a parent commit unpacked with ``git archive`` beside the
working tree: run it on each in turn (parent, tree, tree, parent), one
after the other on one card.  It uses only APIs that every version of the
port has had since the Givens kernel (``gmres_solve``, ``fgmres_solve``,
``graphed``, ``structured_amg``, ``advection_diffusion_dia`` and
``ops.givens_update``, whose two contracts it tells apart by their first
parameter: ``h``, the assembled Hessenberg column, or ``h1``, the two CGS2
projections and ``||w||``); kernels are built into each checkout's own
``build/``.

Lines, each a JSON object:

- ``kernel``: f32, m = 32, at steps j = 7, 15 and 31: ``graph_ms``, the
  device time per launch of 50 launches replayed from one CUDA graph
  (the first replay dropped, the median of 5); ``tail_graph_ms``, the
  same for the step's whole scalar tail as the checkout's solver runs it
  (the kernel alone, or the torch ops that assemble the column, test the
  breakdown and make the divisor, then the kernel); ``call_ms``, one
  call between two CUDA events (the host's time: Python's checks and the
  launch); ``state_sha256``, a hash of R, cs, sn and g after a whole
  cycle of 32 steps on random columns (equal across checkouts where the
  two give the same bits).
- ``floor``: the same ``graph_ms`` for an empty ``<<<1, 32>>>`` kernel,
  built by this script with ``nvcc`` into its own checkout's
  ``build/compare_givens/`` (the same for every checkout timed).
- ``solve``: graphed GMRES(32) and FGMRES(32) + GMG (``structured_amg``,
  three pairings a level) on the upwinded advection-diffusion stencil
  (beta 10, f32, ``nx``^3 rows; b = A x*, x* from numpy's seed 0), tol 0,
  rtol 1e-6, maxiter 2000: ``ms_per_step`` of the cached graphed call and
  of the eager solve (host clock to a synchronised end, median of 5 after
  the capturing call), the Arnoldi steps, and ``x_sha256``, a hash of x's
  bytes (the eager and graphed x must be equal, else the script fails;
  across checkouts, equal where the two give the same bits).

Prints the card's name and power limit first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
EMPTY_SRC = """
#include <cuda_runtime.h>
__global__ void __launch_bounds__(32) empty_warp_kernel() {}
extern "C" int empty_warp(void* stream) {
  empty_warp_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
"""


def graph_ms(fn, launches=50, reps=5) -> float:
    """Device time per launch: ``launches`` calls captured in one CUDA
    graph and replayed, over ``launches``; the median of ``reps`` replays
    after one warm replay."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    times = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times[1:])


def median_ms(fn, reps=30, warmup=5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def empty_warp():
    """The empty one-warp kernel's launcher (built at first use)."""
    import torch
    from torch.utils.cpp_extension import CUDA_HOME

    out = HERE / "build" / "compare_givens" / "empty_warp.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(".cu")
        src.write_text(EMPTY_SRC)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler", "-fPIC",
                        "-o", str(tmp), str(src)], check=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.empty_warp.argtypes = [ctypes.c_void_p]
    lib.empty_warp.restype = ctypes.c_int

    def launch():
        if lib.empty_warp(torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("the empty kernel did not launch")

    return launch


def givens_step(ops, m, device):
    """(a fresh cycle's state, calls(j, h1, h2, wn)) for either contract of
    ``ops.givens_update``, f32; ``calls`` gives (the kernel's launch alone,
    the step's whole scalar tail as the solver runs it)."""
    import math

    import torch

    f32 = dict(dtype=torch.float32, device=device)
    R, cs, sn, g, est = (torch.zeros(s, **f32) for s in ((m, m), m, m, m + 1, ()))
    g[0] = 2.5
    inner = torch.zeros((), dtype=torch.bool, device=device)
    jdev = torch.zeros((), dtype=torch.int64, device=device)
    k, tol = torch.tensor(7, device=device), torch.tensor(1e-30, **f32)
    eps10 = torch.tensor(torch.finfo(torch.float32).eps, **f32) * 10
    h, d = torch.zeros(m + 1, **f32), torch.zeros((), **f32)
    tail = (R, cs, sn, g, est, inner, jdev, k, tol)
    if next(iter(inspect.signature(ops.givens_update).parameters)) == "h":
        def calls(j, h1, h2, wn):
            def column():
                # the solver's tail before the kernel took it: the column,
                # the breakdown test and the divisor
                col = torch.cat([h1 + h2, wn[None]])
                ok = col[j + 1] > eps10
                d.copy_(torch.where(ok, wn, torch.full_like(wn, math.inf)))
                col[j + 1] *= ok
                return col

            col = column()
            return (lambda: ops.givens_update(col, *tail, j, 1000),
                    lambda: ops.givens_update(column(), *tail, j, 1000))
    else:
        def calls(j, h1, h2, wn):
            def step():
                ops.givens_update(h1, h2, wn, eps10, h, d, *tail, j, 1000)

            return step, step
    return (R, cs, sn, g), calls


def kernel_rows(ops, device):
    import numpy as np
    import torch

    m = 32
    state, calls = givens_step(ops, m, device)
    rng = np.random.default_rng(29)
    for j in range(m):
        h1, h2 = (torch.from_numpy(a).float().to(device) for a in rng.standard_normal((2, j + 1)))
        calls(j, h1, h2, torch.tensor(abs(float(rng.standard_normal())), device=device))[1]()
    sha = hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in state)).hexdigest()[:16]
    for j in (7, 15, 31):
        _, calls = givens_step(ops, m, device)
        h1, h2 = (torch.from_numpy(a).float().to(device) for a in rng.standard_normal((2, j + 1)))
        kernel, step = calls(j, h1, h2, torch.tensor(0.75, device=device))
        print(json.dumps({"kernel": "givens_update", "m": m, "j": j,
                          "graph_ms": graph_ms(kernel), "tail_graph_ms": graph_ms(step),
                          "call_ms": median_ms(kernel), "state_sha256": sha}), flush=True)


def solve_rows(st, nx, device):
    import numpy as np
    import torch

    A = st.advection_diffusion_dia(nx, 10.0, torch.float32, device)
    n = A.shape[0]
    xstar = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32))
    b = A.matvec(xstar.to(device))
    M = st.structured_amg((nx, nx, nx), pairs_per_level=3).setup(A)
    kw = dict(tol=0.0, rtol=1e-6, maxiter=2000, restart=32)
    for label, fn, extra in (("gmres32", st.gmres_solve, {}),
                             ("fgmres32_gmg", st.fgmres_solve, {"M": M})):
        G = st.graphed(fn)
        runs = {}
        for name, call in (("eager", fn), ("graphed", G)):
            def solve(call=call):
                out = call(A, b, **kw, **extra)
                torch.cuda.synchronize()
                return out

            x, info = solve()  # the graphed call captures here
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                solve()
                walls.append((time.perf_counter() - t0) * 1e3)
            runs[name] = (x, info.iterations, statistics.median(walls))
        (xe, ie, we), (xg, ig, wg) = runs["eager"], runs["graphed"]
        if not (torch.equal(xe, xg) and ie == ig):
            raise AssertionError(f"{label}: the graphed solve differs from the eager one")
        print(json.dumps({"solve": label, "nx": nx, "steps": ig,
                          "graphed_ms_per_step": wg / max(ig, 1),
                          "eager_ms_per_step": we / max(ie, 1), "graphed_ms": wg, "eager_ms": we,
                          "x_sha256": hashlib.sha256(xg.cpu().numpy().tobytes()).hexdigest()[:16]}),
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(HERE),
                    help="the checkout whose sigma_tpu_torch is timed")
    ap.add_argument("--nx", type=int, default=216)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    import sigma_tpu_torch as st
    from sigma_tpu_torch import ops

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(json.dumps({"repo": str(Path(st.__file__).resolve().parents[1]), "nx": args.nx}))
    device = torch.device("cuda", 0)
    kernel_rows(ops, device)
    print(json.dumps({"floor": "empty <<<1, 32>>> kernel", "graph_ms": graph_ms(empty_warp())}),
          flush=True)
    solve_rows(st, args.nx, device)


if __name__ == "__main__":
    main()
