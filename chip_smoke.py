#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one GPU.

    python3 chip_smoke.py [--nx 216]

Builds the DIA SpMV kernels from ``sigma_tpu_torch/csrc/`` with nvcc,
checks each against its plain PyTorch version on the card, times them at
the north-star size (the 7-point 3-D Laplacian at nx=216: 10,077,696
rows, 70,263,936 nonzeros), then runs CG, fused CG and CG preconditioned
by structured pair-aggregation multigrid at that size through the
package's public entry points, and shows from the kernels' launch counts
that those solves ran on the kernels.

Phases print one line each (JSON, or the card's name and power limit as
nvidia-smi gives them); the line before the last is the kernels' summary,
and the last line is ``{"ok": true, "device": {...}}``.  Any failed
check raises and the script exits nonzero without that line.  It needs a
CUDA device and exits nonzero without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def emit(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def rel_err(y, ref) -> float:
    scale = float(ref.double().abs().max())
    return float((y.double() - ref.double()).abs().max()) / max(scale, 1e-300)


def median_ms(fn, reps=30, warmup=5) -> float:
    """Median of ``reps`` single-launch times from CUDA events."""
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


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit(smi)
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = subprocess.run(
        [f"{CUDA_HOME}/bin/nvcc", "--version"], capture_output=True, text=True,
        check=True,
    ).stdout.splitlines()
    try:  # information only: the port's kernels are CUDA C++
        import triton

        triton_info = triton.__version__
    except ImportError as e:
        triton_info = f"not importable ({e})"
    emit({
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": next((l for l in nvcc if "release" in l), nvcc[0]),
        "triton": triton_info,
    })
    return smi


def phase_build():
    from sigma_tpu_torch.ops import _build

    b = _build.build()
    _build.library()
    ptxas = [l.strip() for l in b.log.splitlines() if "registers" in l]
    emit({"phase": "build", "seconds": round(b.seconds, 3), "library": b.path.name,
          "ptxas": ptxas})


def _random_dia(rng, n, m, offsets, vdtype, device):
    import numpy as np
    import torch

    stride = -(-n // 128) * 128
    data = np.zeros((len(offsets), stride))
    for d, o in enumerate(offsets):
        lo, hi = max(0, -o), min(n, m - o)
        data[d, lo:hi] = rng.standard_normal(max(hi - lo, 0))
    return torch.from_numpy(data).to(device, vdtype)


def phase_kernels(device):
    """Each kernel against its plain version on the card, every
    instantiated dtype pair, at small and odd shapes."""
    import numpy as np
    import torch

    from sigma_tpu_torch import DIAGraph, DIAMatrix
    from sigma_tpu_torch.ops import (
        KERNEL_DTYPES, dia_spmv, dia_spmv_reference, dia_sym_spmv,
        dia_sym_spmv_reference,
    )

    rng = np.random.default_rng(0)
    band = sorted(int(o) for o in rng.choice(np.arange(-3000, 3001), 64, replace=False))
    full_cases = [
        ("square", 50_000, 50_000, [0, 1, -1, 300, -300, 2500, -2500]),
        ("tall", 60_000, 45_001, [0, 4, -300, 2500, -2500]),
        ("wide", 45_001, 60_000, [-1, 0, -4, 300, 2500]),
        ("unaligned", 33_333, 33_333, [0, 1, -1, 300, -2500]),
        ("one_diag", 70_000, 70_000, [0]),
        ("band64", 40_000, 40_000, band),
    ]
    sym_cases = [
        ("stencil", 50_000, [0, 1, 300, 2500]),
        ("no_main_unaligned", 33_333, [1, 130, 259]),
        ("wide_band", 40_000, sorted({abs(o) for o in band})),
    ]

    def tol(vdt, xdt):
        # accumulation is in x's dtype; values widen exactly
        return 1e-12 if xdt == torch.float64 else 1e-5

    worst = {"dia_spmv": 0.0, "dia_sym_spmv": 0.0}
    count = 0
    for vdt, xdt in sorted(KERNEL_DTYPES, key=str):
        for name, n, m, offs in full_cases:
            data = _random_dia(rng, n, m, offs, vdt, device)
            x = torch.from_numpy(rng.standard_normal(m)).to(device, xdt)
            off_t = torch.tensor(offs, dtype=torch.int64, device=device)
            y = dia_spmv(data, x, off_t, n, m)
            torch.cuda.synchronize()
            e = rel_err(y, dia_spmv_reference(data, x, off_t, n, m))
            if not e <= tol(vdt, xdt):
                raise AssertionError(f"dia_spmv {name} {vdt}/{xdt}: rel err {e:.3e}")
            worst["dia_spmv"] = max(worst["dia_spmv"], e)
            count += 1
        for name, n, offs in sym_cases:
            offs = sorted(offs)
            stride = -(-n // 128) * 128
            data = np.zeros((len(offs), stride))
            for d, o in enumerate(offs):
                data[d, : n - o] = rng.standard_normal(n - o)
            data = torch.from_numpy(data).to(device, vdt)
            x = torch.from_numpy(rng.standard_normal(n)).to(device, xdt)
            off_t = torch.tensor(offs, dtype=torch.int64, device=device)
            y = dia_sym_spmv(data, x, off_t, n)
            torch.cuda.synchronize()
            e = rel_err(y, dia_sym_spmv_reference(data, x, off_t, n))
            if not e <= tol(vdt, xdt):
                raise AssertionError(f"dia_sym_spmv {name} {vdt}/{xdt}: rel err {e:.3e}")
            worst["dia_sym_spmv"] = max(worst["dia_sym_spmv"], e)
            count += 1
    # the format layer: rmatvec of a tall matrix through the transposed
    # layout, against the same matrix on the CPU (plain version)
    n, m, offs = 60_000, 45_001, [0, 4, -300, 2500, -2500]
    data = _random_dia(rng, n, m, offs, torch.float64, device)
    nnz = sum(max(0, min(n, m - o) - max(0, -o)) for o in offs)
    A = DIAMatrix(graph=DIAGraph(offsets=tuple(offs), shape=(n, m), nnz=nnz), data=data)
    x = torch.from_numpy(rng.standard_normal(n)).to(device)
    yT = A.rmatvec(x)
    torch.cuda.synchronize()
    e = rel_err(yT.cpu(), A.to("cpu").rmatvec(x.cpu()))
    if not e <= 1e-12:
        raise AssertionError(f"DIAMatrix.rmatvec: rel err {e:.3e}")
    emit({"phase": "kernel_checks", "cases": count + 1,
          "worst_rel_err": {k: float(v) for k, v in worst.items()},
          "rmatvec_rel_err": e,
          "tolerance": "1e-12 with f64 vectors, 1e-5 with f32 vectors"})


def phase_north_star_spmv(device, nx):
    """Kernel and plain version at the main path's shapes, timed with
    CUDA events; returns the kernels' summary rows."""
    import torch

    from sigma_tpu_torch import SymmetricDIAMatrix, laplacian_3d_dia
    from sigma_tpu_torch.ops import (
        dia_spmv, dia_spmv_reference, dia_sym_spmv, dia_sym_spmv_reference,
    )

    # the card's stream bandwidth: a 1 GiB device-to-device copy
    src = torch.empty(1 << 28, dtype=torch.float32, device=device).fill_(1.0)
    dst = torch.empty_like(src)
    copy_ms = median_ms(lambda: dst.copy_(src), reps=20)
    stream_gbs = 2 * src.numel() * 4 / (copy_ms * 1e-3) / 1e9
    del src, dst

    A = laplacian_3d_dia(nx, torch.float32, device)
    n, nnz = A.shape[0], A.nnz
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(n, generator=g, device=device)
    S = SymmetricDIAMatrix.from_dia(A)
    Ab = A.astype_exact(torch.bfloat16)
    variants = [
        ("dia_spmv", "full_f32", A.data, A.offsets_dev, dia_spmv, dia_spmv_reference, (n, n)),
        ("dia_spmv", "full_bf16_values", Ab.data, Ab.offsets_dev, dia_spmv, dia_spmv_reference, (n, n)),
        ("dia_sym_spmv", "sym_f32", S.data, S.offsets_dev, dia_sym_spmv, dia_sym_spmv_reference, (n,)),
    ]
    rows = {}
    for kname, label, data, offs, kern, plain, dims in variants:
        y = kern(data, x, offs, *dims)
        yr = plain(data, x, offs, *dims)
        torch.cuda.synchronize()
        err_abs = float((y - yr).abs().max())
        err_rel = rel_err(y, yr)
        if not err_rel <= 1e-5:
            raise AssertionError(f"{kname} {label} at nx={nx}: rel err {err_rel:.3e}")
        ms = median_ms(lambda: kern(data, x, offs, *dims))
        plain_ms = median_ms(lambda: plain(data, x, offs, *dims))
        # bytes: stored nonzero values once + x read + y written (the
        # bench.py:579 model, 4 + 8n/nnz B/nnz for full f32)
        stored = int(torch.count_nonzero(data))
        byts = stored * data.element_size() + 2 * n * x.element_size()
        row = {
            "phase": "north_star_spmv", "variant": label, "kernel": kname,
            "n": n, "nnz": nnz, "kernel_ms": ms, "plain_ms": plain_ms,
            "gnnz_s": nnz / (ms * 1e-3) / 1e9,
            "plain_gnnz_s": nnz / (plain_ms * 1e-3) / 1e9,
            "bytes_per_nnz": byts / nnz,
            "achieved_gbs": byts / (ms * 1e-3) / 1e9,
            "stream_copy_gbs": stream_gbs,
            "max_abs_err": err_abs, "rel_err": err_rel,
        }
        emit(row)
        if kname not in rows:  # the summary takes the f32 row of each kernel
            rows[kname] = row
    return rows


def _true_rel_residual(A, b, x) -> float:
    import torch

    return float(torch.linalg.vector_norm(b - A.matvec(x)) / torch.linalg.vector_norm(b))


def _timed_solve(solve):
    """Run twice; returns (x, info, warm seconds)."""
    import torch

    solve()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = solve()
    torch.cuda.synchronize()
    return x, info, time.perf_counter() - t0


def phase_cg(device, nx):
    """CG and fused CG on Laplacian + I, as benchmarks/cg3d.py runs them."""
    import torch

    from sigma_tpu_torch import cg_fused_solve, cg_solve, laplacian_3d_dia

    A = laplacian_3d_dia(nx, torch.float32, device)
    n = A.shape[0]
    xstar = torch.sin(torch.arange(n, dtype=torch.float32, device=device) * 0.001)
    b = A.matvec(xstar)
    for name, fn in (("cg_solve", cg_solve), ("cg_fused_solve", cg_fused_solve)):
        x, info, warm = _timed_solve(
            lambda: fn(A, b, tol=0.0, rtol=1e-6, maxiter=100)
        )
        rel = _true_rel_residual(A, b, x)
        emit({"phase": "cg", "solver": name, "n": n, "iterations": info.iterations,
              "converged": info.converged, "relative_residual": rel,
              "max_err_vs_xstar": float((x - xstar).abs().max()),
              "wall_s_warm": warm, "s_per_iteration": warm / max(info.iterations, 1)})
        if not (info.converged and rel < 1e-5):
            raise AssertionError(f"{name} did not converge: {info}, true rel {rel:.3e}")


def phase_gmg(device, nx):
    """Plain CG against GMG-CG on pure Poisson, as benchmarks/gmg3d.py
    runs them (symmetric operator, bf16 levels, 2x2x2 aggregates)."""
    import numpy as np
    import torch

    from sigma_tpu_torch import SymmetricDIAMatrix, cg_solve, laplacian_3d_dia, structured_pair_amg

    S = SymmetricDIAMatrix.from_dia(laplacian_3d_dia(nx, torch.float32, device, diag=6.0))
    n = S.shape[0]
    xstar = torch.from_numpy(
        np.random.default_rng(0).standard_normal(n).astype(np.float32)
    ).to(device)
    b = S.matvec(xstar)
    rtol, maxiter = 2e-7, 3000
    iters = {}
    for label, kw in (
        ("plain", None),
        ("gmg_jacobi", dict(smoother="jacobi", n_smooth=1)),
        ("gmg_chebyshev", dict(smoother="chebyshev", n_smooth=4)),
    ):
        M, setup = None, 0.0
        if kw is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            M = structured_pair_amg(
                S, (nx, nx, nx), pairs_per_level=3, level_dtype=torch.bfloat16, **kw
            )
            torch.cuda.synchronize()
            setup = time.perf_counter() - t0
        x, info, warm = _timed_solve(
            lambda: cg_solve(S, b, tol=0.0, rtol=rtol, maxiter=maxiter, M=M)
        )
        rel = _true_rel_residual(S, b, x)
        iters[label] = info.iterations
        emit({"phase": "gmg", "run": label, "n": n, "setup_s": setup,
              "levels": None if M is None else len(M.levels) + 1,
              "iterations": info.iterations, "converged": info.converged,
              "relative_residual": rel, "wall_s_warm": warm,
              "s_per_iteration": warm / max(info.iterations, 1)})
        if not (info.converged and rel < 1e-5):
            raise AssertionError(f"{label} did not converge: {info}, true rel {rel:.3e}")
    for label in ("gmg_jacobi", "gmg_chebyshev"):
        if not iters[label] * 3 <= iters["plain"]:
            raise AssertionError(f"{label} took {iters[label]} iterations vs plain {iters['plain']}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=216, help="grid size (nx^3 rows)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    from sigma_tpu_torch.ops import dia_spmv, dia_sym_spmv  # fails early without the package

    smi = phase_device()                                    # phase 0
    phase_build()                                           # phase 1
    phase_kernels(device)                                   # phase 2
    spmv_rows = phase_north_star_spmv(device, args.nx)      # phase 3

    counters = {"dia_spmv": dia_spmv, "dia_sym_spmv": dia_sym_spmv}
    for fn in counters.values():
        fn.launches = 0
    phase_cg(device, args.nx)                               # phase 4
    phase_gmg(device, args.nx)                              # phase 5
    launches = {k: fn.launches for k, fn in counters.items()}
    emit({"phase": "kernel_use", "launches": launches})     # phase 6
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{k} was not launched on the main path")

    source = "sigma_tpu_torch/csrc/dia_spmv.cu"
    replaces = {
        "dia_spmv": "sigma_tpu/ops/spmv_pallas.py:204",
        "dia_sym_spmv": "sigma_tpu/ops/spmv_pallas.py:516",
    }
    emit(smi)
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": source, "replaces": replaces[k],
         "launches": launches[k], "max_abs_err": spmv_rows[k]["max_abs_err"],
         "ms": spmv_rows[k]["kernel_ms"], "plain_ms": spmv_rows[k]["plain_ms"]}
        for k in ("dia_spmv", "dia_sym_spmv")
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
