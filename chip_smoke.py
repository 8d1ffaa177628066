#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one GPU.

    python3 chip_smoke.py [--nx 216]

Builds the DIA SpMV and SpMM kernels from ``sigma_tpu_torch/csrc/`` with
nvcc, checks each against its plain PyTorch version on the card (every
dtype pair; for SpMM every panel layout and k in {1, 3, 8, 16}), times
them at the north-star size (the 7-point 3-D Laplacian at nx=216:
10,077,696 rows, 70,263,936 nonzeros; SpMM at k=8), then drives two paths
through the package's public entry points at that size:

- the single-RHS path: CG, fused CG and CG preconditioned by structured
  pair-aggregation multigrid;
- the multi-RHS path: block CG with 8 right-hand sides (interleaved and
  column panels), GMG-preconditioned block CG with 4, and LOBPCG + GMG
  for the lowest 4 eigenpairs of the Dirichlet Laplacian (f32 and f64),
  checked against the analytic spectrum.

The kernels' launch counts are zeroed before each path and read after it,
and each path must have launched its kernels.

Phases print one line each or more (JSON, or the card's name and power
limit as nvidia-smi gives them); the line before the last is the kernels'
summary, and the last line is ``{"ok": true, "device": {...}}``.  Any failed
check raises and the script exits nonzero without that line.  It needs a
CUDA device and exits nonzero without one.
"""

from __future__ import annotations

import argparse
import json
import re
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


def copy_gbs(device) -> float:
    """The card's stream bandwidth: a 1 GiB device-to-device copy, read
    plus write, GB/s."""
    import torch

    src = torch.empty(1 << 28, dtype=torch.float32, device=device).fill_(1.0)
    dst = torch.empty_like(src)
    ms = median_ms(lambda: dst.copy_(src), reps=20)
    return 2 * src.numel() * 4 / (ms * 1e-3) / 1e9


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
    # "N bytes stack frame, N bytes spill stores, N bytes spill loads", one
    # line per kernel instantiation
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill stores", b.log)]
    emit({"phase": "build", "seconds": round(b.seconds, 3), "library": b.path.name,
          "kernels": len(spills), "spill_store_bytes": sum(spills), "ptxas": ptxas})
    if not spills or any(spills):
        raise AssertionError(f"ptxas spill stores per kernel: {spills}")


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


def phase_spmm_kernels(device):
    """dia_spmm and dia_sym_spmm against their plain versions on the card:
    every dtype pair, every panel layout, k in {1, 3, 8, 16}, at the odd
    shapes of phase_kernels; and DIAMatrix.rmatmat of a tall matrix
    against the CPU."""
    import numpy as np
    import torch

    from sigma_tpu_torch import DIAGraph, DIAMatrix
    from sigma_tpu_torch.ops import (
        KERNEL_DTYPES, LAYOUTS, dia_spmm, dia_spmm_reference, dia_sym_spmm,
        dia_sym_spmm_reference, interleave_panels,
    )

    rng = np.random.default_rng(1)
    band = sorted(int(o) for o in rng.choice(np.arange(-3000, 3001), 64, replace=False))
    full_cases = [
        ("tall", 30_000, 22_501, [0, 4, -300, 2500, -2500]),
        ("wide", 22_501, 30_000, [-1, 0, -4, 300, 2500]),
        ("unaligned", 16_667, 16_667, [0, 1, -1, 300, -2500]),
        ("one_diag", 35_000, 35_000, [0]),
        ("band64", 20_000, 20_000, band),
    ]
    sym_cases = [
        ("stencil", 25_000, [0, 1, 300, 2500]),
        ("no_main_unaligned", 16_667, [1, 130, 259]),
        ("wide_band", 20_000, sorted({abs(o) for o in band})),
    ]

    def panels(length, k, xdt, layout):
        XT = torch.from_numpy(rng.standard_normal((k, length))).to(device, xdt)
        if layout == "rhs_major":
            return XT
        if layout == "cols":
            return XT.T.contiguous()
        return interleave_panels(XT, length)

    def check(name, y, ref, xdt):
        e = rel_err(y, ref)
        tol = 1e-12 if xdt == torch.float64 else 1e-5
        if not e <= tol:
            raise AssertionError(f"{name}: rel err {e:.3e} > {tol}")
        if y.shape != ref.shape:
            raise AssertionError(f"{name}: shape {tuple(y.shape)} != {tuple(ref.shape)}")
        return e

    worst = {"dia_spmm": 0.0, "dia_sym_spmm": 0.0}
    count = 0
    for vdt, xdt in sorted(KERNEL_DTYPES, key=str):
        for layout in LAYOUTS:
            for k in (1, 3, 8, 16):
                for name, n, m, offs in full_cases:
                    data = _random_dia(rng, n, m, offs, vdt, device)
                    off_t = torch.tensor(offs, dtype=torch.int64, device=device)
                    X = panels(m, k, xdt, layout)
                    # the comparison covers y's interleaved padding rows,
                    # which the kernel must write as zeros (y is torch.empty)
                    y = dia_spmm(data, X, off_t, n, m, layout)
                    torch.cuda.synchronize()
                    e = check(f"dia_spmm {name} {layout} k={k} {vdt}/{xdt}", y,
                              dia_spmm_reference(data, X, off_t, n, m, layout), xdt)
                    worst["dia_spmm"] = max(worst["dia_spmm"], e)
                    count += 1
                for name, n, offs in sym_cases:
                    stride = -(-n // 128) * 128
                    data = np.zeros((len(offs), stride))
                    for d, o in enumerate(offs):
                        data[d, : n - o] = rng.standard_normal(n - o)
                    data = torch.from_numpy(data).to(device, vdt)
                    off_t = torch.tensor(offs, dtype=torch.int64, device=device)
                    X = panels(n, k, xdt, layout)
                    y = dia_sym_spmm(data, X, off_t, n, layout)
                    torch.cuda.synchronize()
                    e = check(f"dia_sym_spmm {name} {layout} k={k} {vdt}/{xdt}", y,
                              dia_sym_spmm_reference(data, X, off_t, n, layout), xdt)
                    worst["dia_sym_spmm"] = max(worst["dia_sym_spmm"], e)
                    count += 1
    # the format layer: rmatmat of a tall matrix through the transposed
    # layout, against the same matrix on the CPU (plain version)
    n, m, offs = 30_000, 22_501, [0, 4, -300, 2500, -2500]
    data = _random_dia(rng, n, m, offs, torch.float64, device)
    nnz = sum(max(0, min(n, m - o) - max(0, -o)) for o in offs)
    A = DIAMatrix(graph=DIAGraph(offsets=tuple(offs), shape=(n, m), nnz=nnz), data=data)
    X = torch.from_numpy(rng.standard_normal((n, 8))).to(device)
    YT = A.rmatmat(X)
    torch.cuda.synchronize()
    e = rel_err(YT.cpu(), A.to("cpu").rmatmat(X.cpu()))
    if not e <= 1e-12:
        raise AssertionError(f"DIAMatrix.rmatmat: rel err {e:.3e}")
    emit({"phase": "spmm_kernel_checks", "cases": count + 1,
          "worst_rel_err": {k: float(v) for k, v in worst.items()},
          "rmatmat_rel_err": e,
          "tolerance": "1e-12 with f64 vectors, 1e-5 with f32 vectors"})


def phase_north_star_spmm(device, nx, k=8):
    """The SpMM kernels and their plain versions at the main path's shapes
    (nx=216, k=8: bench.py's and cg3d.py's width), timed with CUDA events
    in each layout the TPU kernels they replace took; returns the kernels'
    summary rows (the interleaved one of each, block CG's layout)."""
    import torch

    from sigma_tpu_torch import SymmetricDIAMatrix, laplacian_3d_dia
    from sigma_tpu_torch.ops import (
        dia_spmm, dia_spmm_reference, dia_sym_spmm, dia_sym_spmm_reference,
        interleave_panels,
    )

    stream_gbs = copy_gbs(device)
    A = laplacian_3d_dia(nx, torch.float32, device)
    S = SymmetricDIAMatrix.from_dia(A)
    n, nnz = A.shape[0], A.nnz
    g = torch.Generator(device=device).manual_seed(0)
    XT = torch.rand((k, n), generator=g, device=device)
    layouts = {"rhs_major": XT, "interleaved": interleave_panels(XT, n),
               "cols": XT.T.contiguous()}
    del XT
    variants = [
        ("dia_spmm", "full_f32_interleaved", "interleaved", A.data, A.offsets_dev, dia_spmm, dia_spmm_reference, (n, n)),
        ("dia_spmm", "full_f32_rhs_major", "rhs_major", A.data, A.offsets_dev, dia_spmm, dia_spmm_reference, (n, n)),
        ("dia_spmm", "full_f32_cols", "cols", A.data, A.offsets_dev, dia_spmm, dia_spmm_reference, (n, n)),
        ("dia_sym_spmm", "sym_f32_interleaved", "interleaved", S.data, S.offsets_dev, dia_sym_spmm, dia_sym_spmm_reference, (n,)),
        ("dia_sym_spmm", "sym_f32_rhs_major", "rhs_major", S.data, S.offsets_dev, dia_sym_spmm, dia_sym_spmm_reference, (n,)),
    ]
    rows = {}
    for kname, label, layout, data, offs, kern, plain, dims in variants:
        X = layouts[layout]
        y = kern(data, X, offs, *dims, layout)
        yr = plain(data, X, offs, *dims, layout)
        torch.cuda.synchronize()
        err_abs = float((y - yr).abs().max())
        err_rel = rel_err(y, yr)
        del y, yr
        if not err_rel <= 1e-5:
            raise AssertionError(f"{kname} {label} at nx={nx}: rel err {err_rel:.3e}")
        ms = median_ms(lambda: kern(data, X, offs, *dims, layout))
        plain_ms = median_ms(lambda: plain(data, X, offs, *dims, layout), reps=10, warmup=2)
        # byte floor: stored nonzero values once + k x-panels read + k
        # y-panels written
        stored = int(torch.count_nonzero(data))
        byts = stored * data.element_size() + 2 * k * n * X.element_size()
        row = {
            "phase": "north_star_spmm", "variant": label, "kernel": kname,
            "layout": layout, "k": k, "n": n, "nnz": nnz,
            "kernel_ms": ms, "plain_ms": plain_ms,
            "k_gnnz_s": k * nnz / (ms * 1e-3) / 1e9,
            "plain_k_gnnz_s": k * nnz / (plain_ms * 1e-3) / 1e9,
            "bytes_floor_mb": byts / 1e6,
            "achieved_gbs": byts / (ms * 1e-3) / 1e9,
            "stream_copy_gbs": stream_gbs,
            "max_abs_err": err_abs, "rel_err": err_rel,
        }
        emit(row)
        if kname not in rows:  # the summary takes the first row of each kernel
            rows[kname] = row
    return rows


def phase_north_star_spmv(device, nx):
    """Kernel and plain version at the main path's shapes, timed with
    CUDA events; returns the kernels' summary rows."""
    import torch

    from sigma_tpu_torch import SymmetricDIAMatrix, laplacian_3d_dia
    from sigma_tpu_torch.ops import (
        dia_spmv, dia_spmv_reference, dia_sym_spmv, dia_sym_spmv_reference,
    )

    stream_gbs = copy_gbs(device)

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


def _timed(run):
    """Run twice; returns (the second run's result, its warm seconds)."""
    import torch

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_cg(device, nx):
    """CG and fused CG on Laplacian + I, as benchmarks/cg3d.py runs them."""
    import torch

    from sigma_tpu_torch import cg_fused_solve, cg_solve, laplacian_3d_dia

    A = laplacian_3d_dia(nx, torch.float32, device)
    n = A.shape[0]
    xstar = torch.sin(torch.arange(n, dtype=torch.float32, device=device) * 0.001)
    b = A.matvec(xstar)
    for name, fn in (("cg_solve", cg_solve), ("cg_fused_solve", cg_fused_solve)):
        (x, info), warm = _timed(lambda: fn(A, b, tol=0.0, rtol=1e-6, maxiter=100))
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
        (x, info), warm = _timed(
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


def _col_rel_residuals(A, B, X):
    """||b_j - A x_j|| / ||b_j|| for every column."""
    import torch

    R = B - A.matmat(X)
    return (torch.linalg.vector_norm(R, dim=0) / torch.linalg.vector_norm(B, dim=0)).tolist()


def phase_block_cg(device, nx):
    """Block CG with 8 right-hand sides on Laplacian + I (cg3d.py's operator
    and SpMM width), rtol 1e-6, in the interleaved (``auto`` on the card)
    and the column layout; then GMG-preconditioned block CG with 4 on pure
    Poisson (symmetric storage, bf16 levels, as phase_gmg)."""
    import torch

    from sigma_tpu_torch import (
        SymmetricDIAMatrix, block_cg_solve, laplacian_3d_dia, structured_pair_amg,
    )
    from sigma_tpu_torch.ops import dia_spmm

    A = laplacian_3d_dia(nx, torch.float32, device)
    n, s = A.shape[0], 8
    i = torch.arange(n, dtype=torch.float32, device=device)
    Xstar = torch.stack([torch.sin(i * (0.001 * (j + 1))) for j in range(s)], dim=1)
    B = A.matmat(Xstar)
    del Xstar
    iters, interleaved = {}, {}
    for panels in ("auto", "cols"):
        before = dia_spmm.launches_by_layout["interleaved"]
        (X, info), warm = _timed(
            lambda: block_cg_solve(A, B, tol=0.0, rtol=1e-6, maxiter=100, panels=panels)
        )
        interleaved[panels] = dia_spmm.launches_by_layout["interleaved"] - before
        rels = _col_rel_residuals(A, B, X)
        iters[panels] = info.iterations
        emit({"phase": "block_cg", "operator": "laplacian+I", "panels": panels,
              "interleaved_spmm_launches": interleaved[panels],
              "n": n, "rhs": s, "iterations": info.iterations,
              "converged": info.converged, "col_relative_residuals": rels,
              "wall_s_warm": warm, "s_per_iteration": warm / max(info.iterations, 1)})
        if not (info.converged and max(rels) < 1e-5):
            raise AssertionError(f"block CG ({panels}) did not converge: {info}, {rels}")
        del X
    if iters["auto"] != iters["cols"]:
        raise AssertionError(f"block CG iterations differ by layout: {iters}")
    if interleaved["auto"] <= 0:
        raise AssertionError("block CG (auto) did not run the interleaved SpMM")
    del A, B

    S = SymmetricDIAMatrix.from_dia(laplacian_3d_dia(nx, torch.float32, device, diag=6.0))
    s = 4
    g = torch.Generator(device=device).manual_seed(0)
    B = S.matmat(torch.randn((n, s), generator=g, device=device))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    M = structured_pair_amg(S, (nx, nx, nx), pairs_per_level=3, level_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    (X, info), warm = _timed(
        lambda: block_cg_solve(S, B, tol=0.0, rtol=1e-6, maxiter=300, M=M)
    )
    rels = _col_rel_residuals(S, B, X)
    emit({"phase": "block_cg", "operator": "poisson_sym", "preconditioner": "gmg_jacobi_bf16",
          "n": n, "rhs": s, "setup_s": setup, "iterations": info.iterations,
          "converged": info.converged, "col_relative_residuals": rels,
          "wall_s_warm": warm, "s_per_iteration": warm / max(info.iterations, 1)})
    if not (info.converged and max(rels) < 1e-5):
        raise AssertionError(f"GMG block CG did not converge: {info}, {rels}")


def analytic_lowest(nx, count):
    """Lowest ``count`` eigenvalues of the 3-D Dirichlet Laplacian on an
    nx^3 grid: sums of 4 sin^2(pi q / (2 (nx + 1))) over the three axes
    (benchmarks/eigen3d.py)."""
    import numpy as np

    q = np.arange(1, nx + 1)
    w = 4.0 * np.sin(np.pi * q / (2.0 * (nx + 1))) ** 2
    c = min(nx, 8)
    block = (w[:c, None, None] + w[None, :c, None] + w[None, None, :c]).ravel()
    return np.sort(block)[:count]


# LOBPCG eigenvalues against the analytic spectrum at nx=216, tol 1e-4:
# measured on an H100 at most 7.8e-5 relative in f32 and 1.9e-5 in f64
# (PERF.md, Findings); 1e-3 leaves a 13-fold margin and still fails a
# stall like the JAX package's f32 run on the TPU (0.3-2.4%).
LOBPCG_RTOL = 1e-3


def phase_lobpcg(device, nx, m=4):
    """LOBPCG + structured multigrid for the lowest 4 eigenpairs of the
    pure Dirichlet Laplacian, as benchmarks/eigen3d.py runs it (full
    storage, pairs_per_level=3, tol 1e-4, maxiter 120, X0 from
    np.random.default_rng(0)), in f32 and in f64 (values, vectors, levels),
    against the analytic spectrum."""
    import numpy as np
    import torch

    from sigma_tpu_torch import laplacian_3d_dia, lobpcg, structured_pair_amg

    exact = analytic_lowest(nx, m)
    X0 = np.random.default_rng(0).standard_normal((nx**3, m))
    rtol = LOBPCG_RTOL
    for dtype in (torch.float32, torch.float64):
        # values made on the host and pushed once, as eigen3d.py does;
        # host_data spares the hierarchy's device-to-host copy
        host = laplacian_3d_dia(nx, dtype, "cpu", diag=6.0)
        A = host.to(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M = structured_pair_amg(A, (nx, nx, nx), pairs_per_level=3,
                                host_data=host.data.numpy())
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        del host
        x0 = torch.from_numpy(X0).to(device, dtype)
        res, warm = _timed(lambda: lobpcg(A, x0, M=M, tol=1e-4, maxiter=120))
        lam = np.sort(res.eigenvalues.double().cpu().numpy())
        rel = np.abs(lam - exact) / exact
        emit({"phase": "lobpcg", "dtype": str(dtype).replace("torch.", ""), "n": A.shape[0],
              "m": m, "setup_s": setup, "iterations": res.iterations,
              "converged": res.converged,
              "residual_norms": res.residual_norms.double().cpu().tolist(),
              "eigenvalues": lam.tolist(), "analytic": exact.tolist(),
              "rel_err": rel.tolist(), "tolerance": rtol, "wall_s_warm": warm,
              "s_per_iteration": warm / max(res.iterations, 1)})
        if not (np.isfinite(lam).all() and rel.max() <= rtol):
            raise AssertionError(f"LOBPCG {dtype}: eigenvalue rel err {rel} > {rtol}")
        del A, M, x0, res


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
    # fails early without the package
    from sigma_tpu_torch.ops import LAYOUTS, dia_spmm, dia_spmv, dia_sym_spmm, dia_sym_spmv

    smi = phase_device()                                    # phase 0
    phase_build()                                           # phase 1
    phase_kernels(device)                                   # phase 2
    phase_spmm_kernels(device)                              # phase 3
    rows = phase_north_star_spmv(device, args.nx)           # phase 4
    rows.update(phase_north_star_spmm(device, args.nx))     # phase 5

    kernels = {"dia_spmv": dia_spmv, "dia_sym_spmv": dia_sym_spmv,
               "dia_spmm": dia_spmm, "dia_sym_spmm": dia_sym_spmm}

    def zero_counts():
        for fn in kernels.values():
            fn.launches = 0
            if hasattr(fn, "launches_by_layout"):
                fn.launches_by_layout = dict.fromkeys(LAYOUTS, 0)

    def read_counts(path, must_run):
        launches = {k: fn.launches for k, fn in kernels.items()}
        emit({"phase": "kernel_use", "path": path, "launches": launches,
              "by_layout": {k: dict(fn.launches_by_layout) for k, fn in kernels.items()
                            if hasattr(fn, "launches_by_layout")}})
        for k in must_run:
            if launches[k] <= 0:
                raise AssertionError(f"{k} was not launched on the {path} path")
        return launches

    # the single-RHS path: counts zeroed just before, read just after
    zero_counts()
    phase_cg(device, args.nx)                               # phase 6
    phase_gmg(device, args.nx)                              # phase 7
    single = read_counts("single_rhs", ("dia_spmv", "dia_sym_spmv"))
    # the multi-RHS path
    zero_counts()
    phase_block_cg(device, args.nx)                         # phase 8
    phase_lobpcg(device, args.nx)                           # phase 9
    # (the GMG levels here are bf16 full storage: dia_spmv, not dia_sym_spmv)
    multi = read_counts("multi_rhs", ("dia_spmv", "dia_spmm", "dia_sym_spmm"))
    if dia_spmm.launches_by_layout["cols"] + dia_spmm.launches_by_layout["rhs_major"] <= 0:
        raise AssertionError("dia_spmm ran no column or RHS-major product on the multi-RHS path")

    src = "sigma_tpu_torch/csrc/"
    pallas = "sigma_tpu/ops/spmv_pallas.py"
    summary = {
        "dia_spmv": ("dia_spmv.cu", f"{pallas}:204"),
        "dia_sym_spmv": ("dia_spmv.cu", f"{pallas}:516"),
        "dia_spmm": ("dia_spmm.cu", f"{pallas}:1039 and {pallas}:1390"),
        "dia_sym_spmm": ("dia_spmm.cu", f"{pallas}:723 and {pallas}:1494"),
    }
    emit(smi)
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": src + f, "replaces": r,
         "launches": single[k] + multi[k], "max_abs_err": rows[k]["max_abs_err"],
         "ms": rows[k]["kernel_ms"], "plain_ms": rows[k]["plain_ms"]}
        for k, (f, r) in summary.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
