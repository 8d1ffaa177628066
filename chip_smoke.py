#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one GPU.

    python3 chip_smoke.py [--nx 216]

Builds the DIA, grouped, staged, pruned and grouped-BSR SpMV and SpMM
kernels from ``sigma_tpu_torch/csrc/`` with nvcc (and the host library with
g++), checks each against its plain PyTorch version on the card (every
dtype pair; the full-storage and symmetric SpMVs at each of their load
forms: odd strides, values or x off a 16-byte boundary, n not a whole
number of a thread's rows or below one block, offsets at and past +-n,
more diagonals than one staged chunk, the symmetric one with and without
a main diagonal and launched twice for the same bits; the resident staged
SpMV at a 32,768-row level and below one row tile; the windowed staged
SpMV at tile_rows 32 to 1024 on a piece that starts off a 16-byte
boundary, the stencil's far offsets, a band and below one tile, launched
twice and bit for bit against the full-storage SpMV; for SpMM every
panel layout and k in {1, 3, 8, 16}, and the full-storage SpMM at k in
{1, 3, 4, 5, 8, 9, 12, 16} on eight offset sets
and value strides with NaN in every slot outside the matrix, the
symmetric one at the same k on seven offset sets and value forms with NaN
in every slot it must not read, launched twice for the same bits; the grouped
SpMM in both of its layouts at k in {1, 17, 24, 32, 33, 48} on
five offset sets, and with no diagonals; the grouped-BSR kernel in every
form at six block shapes, three group sizes and k in {1, 2, 3, 4, 5, 8,
9, 16}, and with gdata and x off a 16-byte boundary), and times them
at the north stars' shapes beside their bound and the same product in
cuSPARSE (``torch.sparse_csr``): the 7-point 3-D Laplacian at nx=216
(10,077,696 rows, 70,263,936 nonzeros) and the shuffled irregular-mesh
Laplacian of ``benchmarks/unstructured_pruned.py`` after RCM (157,696 x 64
= 10,092,544 rows, 70.0M nonzeros, pruned storage), SpMM at k=8 (the
symmetric DIA SpMM also at k=4).  Then it
drives eleven paths through the package's public entry points:

- the stencil single-RHS path: CG, fused CG and CG preconditioned by
  structured pair-aggregation multigrid;
- the stencil multi-RHS path: block CG with 8 right-hand sides
  (interleaved and column panels), GMG-preconditioned block CG with 4, and
  LOBPCG + GMG for the lowest 4 eigenpairs of the Dirichlet Laplacian (f32
  and f64), checked against the analytic spectrum;
- the unstructured single-RHS path: CG and pruned-pair-multigrid CG on
  full and symmetric pruned storage, against the manufactured solution;
- the unstructured multi-RHS path: block CG with 8 right-hand sides and
  pruned multigrid at 10M rows, and LOBPCG + pruned multigrid at
  ``benchmarks/eigen_unstructured.py``'s settings (1M rows, 8 pairs) on
  full and on symmetric storage (phases 14-15);
- the full-band path of ``benchmarks/unstructured.py`` at 1,048,576 rows
  (phases 16-18): irregular_mesh_laplacian -> shuffle -> CSRMatrix ->
  to_banded_dia (245 diagonals, assembled on the card); CG at shift 1.0
  and the bf16-operator refined_solve_fixed; at shift 1e-3 CG,
  Chebyshev-CG, banded pair-multigrid CG and CG on the symmetric band;
  and LOBPCG + banded multigrid for 8 pairs, whose k = 24 Rayleigh-Ritz
  products run the grouped SpMM kernel (timed at that shape after the
  path, in both layouts, beside its bound and cuSPARSE);
- the 10,092,544-row mesh's full band (phase 19), built on the card from
  phase 7's RCM triples (9.89 GB of f32 values): the SpMV, symmetric SpMV,
  windowed staged SpMV, k = 8 and k = 16 SpMM and k = 32 grouped SpMM
  (RHS-major through ``matmat_rhs_major``, and columns) beside two
  16-column passes,
  each checked once against its plain version and timed beside its bound
  and cuSPARSE on the same matrix;
- the staged-x SpMV entry ``dia_spmv_staged`` (phase 20): the resident
  kernel on every multigrid level of the nx=216 stencil and of the band
  whose x fits shared memory, the windowed kernel on the nx=216 stencil,
  each beside ``dia_spmv`` and cuSPARSE, single launch and device time
  (50 back-to-back launches; ``device_ms`` also in phases 5 and 19);
- the block / multi-DOF path (phases 21-22): the grouped-BSR kernel on the
  block-banded operator of ``bench.py`` ((8, 128) blocks in groups of 8;
  65,536 rows with 67,108,864 stored slots, and 524,288 rows with 2.15 GB)
  and on the elasticity-like operator of ``benchmarks/elasticity3d.py`` at
  nx=150 (10,125,000 dof, 211,410,000 nonzeros) as node-major (3, 3)-block
  BSR assembled on the card, each timed beside its bound, its plain
  version, ``torch.sparse_csr`` and ``torch.sparse_bsr`` of the same
  matrix; and that operator in three layouts (a field-blocked
  ``BlockMatrix`` of 9 DIA blocks, the node-major DIA band in full and
  symmetric storage, the grouped BSR): parity of A x, SpMV and SpMM
  (k = 4) times, and the Jacobi-CG solve against the manufactured
  solution, with equal iteration counts;
- the nonsymmetric stencil (phase 23): ``benchmarks/adv3d.py``'s upwinded
  advection-diffusion operator at nx=216 (beta 10, f32), BiCG-stab with
  ``jacobi()`` and with ``structured_amg(...).setup(A)``, GMRES(32), and
  100 CGLS steps whose rmatvec runs the DIA SpMV on the transposed layout;
- the nonsymmetric mesh (phase 24): ``benchmarks/unstructured_nonsym.py``'s
  skew-perturbed shuffled mesh at 1,048,576 rows in pruned storage, its
  skew statistic and route, plain and pruned-multigrid BiCG-stab, and
  FGMRES(32) with a 4-step inner BiCG-stab given as a lambda and through
  ``attach_solver`` (equal counts);
- the refinement question (phase 25): on the Dirichlet Poisson stencil at
  nx=216 to a relative residual of 1e-10, f64 CG + GMG against
  ``refined_solve`` with an f32 inner GMG-CG (f32, then bf16 operator
  values) and f64 MINRES with the same M.

Each solve prints its iterations beside the JAX package's recorded TPU
count where there is one, its warm seconds, seconds per iteration, the
recomputed true relative residual and the error against the manufactured
solution; a solve that does not converge, or whose true residual is above
twice its target, fails the run.

The kernels' launch counts are zeroed before each path and read after it,
and each path must have launched its kernels; launches that compare a
kernel with its plain version run outside the counted paths.

Phases print one line each or more (JSON, or the card's name and power
limit as nvidia-smi gives them); the line before the last is the kernels'
summary (each SpMM in the panel layout its paths launched most, the
symmetric DIA SpMM at k = 4), and the
last line is ``{"ok": true, "device": {...}}``.  Any failed
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
from functools import partial


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one line: a string as it is, a dict as JSON; a phase's dict
    with ``t_s``, the seconds since the script started."""
    if isinstance(obj, dict) and "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 3)}
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


def device_ms(fn, launches=50, reps=5) -> float:
    """Device time per launch: ``launches`` back-to-back calls between two
    CUDA events, over ``launches``; the median of ``reps`` such runs.  The
    host's time per call hides behind the device's when it is shorter."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def copy_gbs(device) -> float:
    """The card's stream bandwidth: a 1 GiB device-to-device copy, read
    plus write, GB/s."""
    import torch

    src = torch.empty(1 << 28, dtype=torch.float32, device=device).fill_(1.0)
    dst = torch.empty_like(src)
    ms = median_ms(lambda: dst.copy_(src), reps=20)
    return 2 * src.numel() * 4 / (ms * 1e-3) / 1e9


# the H100 SXM's published peaks (NVIDIA's H100 datasheet): device
# memory rate and the float32 / float64 rates outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.float32": 67e12, "torch.float64": 34e12}


def bound(nbytes, flops, dtype):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move ``nbytes`` and do ``flops`` operations in ``dtype``."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def csr_from_coo(rows, cols, vals, n, m):
    """torch.sparse_csr of COO triples on their device (int32 indices):
    the cuSPARSE baseline (``library_ms``), used nowhere in the port."""
    import torch

    order = torch.argsort(rows * m + cols)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return torch.sparse_csr_tensor(crow.int(), cols[order].int(), vals[order], size=(n, m))


def csr_from_dia(A):
    """The full-storage DIAMatrix A as torch.sparse_csr (its nonzeros)."""
    import torch

    n, m = A.shape
    parts = []
    for d, o in enumerate(A.offsets):
        lo, hi = max(0, -o), min(n, m - o)
        i = torch.arange(lo, hi, device=A.data.device)
        v = A.data[d, lo:hi]
        keep = v != 0
        parts.append((i[keep], i[keep] + o, v[keep]))
    rows, cols, vals = (torch.cat(t) for t in zip(*parts))
    return csr_from_coo(rows, cols, vals, n, m)


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


def _ptxas_entries(log):
    """(function, registers, spill store bytes, spill load bytes, static
    shared-memory bytes) of every kernel instantiation in nvcc's
    ``-Xptxas -v`` output."""
    out, name, spills = [], None, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = int(m.group(1)), int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and name and spills:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(m.group(1)), *spills, int(smem.group(1)) if smem else 0))
            name = spills = None
    return out


# the SpMV kernels redesigned for Hopper (pruned.cu), reported one by one
PTXAS_REPORTED = ("pruned_spmv_kernel", "pruned_sym_spmv_kernel")
# the pruned SpMMs #11 and #13 (pruned.cu, one template): one instantiation
# a dtype pair, column-group count G (1 or 2 with f32 vectors; 1, 2 or 4
# with f64, but 2 or 4 with f64 values) and kernel (full or symmetric)
PRUNED_SPMM_KERNEL = "pruned_spmm_kernel"
PRUNED_SPMM_INSTANTIATIONS = 2 * 12
# the grouped SpMM (dia_spmm_grouped.cu): one instantiation a dtype pair
GROUPED_KERNEL = "dia_spmm_grouped_kernel"
# the SpMM (dia_spmm.cu): one instantiation a dtype pair and column-group
# count G (1 or 2 with f32 vectors, 1, 2 or 4 with f64)
SPMM_KERNEL = "dia_spmm_kernel"
SPMM_INSTANTIATIONS = 13
# the symmetric SpMM (dia_spmm.cu) #3/#8: per dtype pair, the column
# layout's lane-rows tile at two column counts C and the panels' tile at two
# C in two value-load forms (16-byte pieces or one value a load)
SYM_SPMM_KERNEL = "dia_sym_spmm_kernel"
SYM_SPMM_INSTANTIATIONS = 5 * (2 + 2 * 2)
# the grouped-BSR kernel (bsr_grouped.cu): the wide form per dtype pair and
# column tile (1, 2, 4 or 8 columns a pass), the narrow form per dtype
# pair, column tile and load width (16-byte pieces or one value)
BSR_KERNELS = ("bsr_wide_kernel", "bsr_narrow_kernel")
BSR_INSTANTIATIONS = 7 * 4 + 7 * 4 * 2
# the DIA SpMVs (dia_spmv.cu) #1, #2, #5 and #6: one instantiation a dtype
# pair and value-load form (16-byte pieces, or one value a load) each
DIA_SPMV_KERNELS = ("dia_spmv_kernel", "dia_sym_spmv_kernel", "dia_spmv_resident_kernel",
                    "dia_spmv_window_kernel")
DIA_SPMV_INSTANTIATIONS = 5 * 2


def phase_build():
    import torch

    from sigma_tpu_torch.ops import KERNEL_DTYPES, _build
    from sigma_tpu_torch.ops.spmm_dia import grouped_launch_config, spmm_launch_config

    b = _build.build()
    _build.library()
    ptxas = [l.strip() for l in b.log.splitlines() if "registers" in l]
    # "N bytes stack frame, N bytes spill stores, N bytes spill loads", one
    # line per kernel instantiation
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill stores", b.log)]
    entries = _ptxas_entries(b.log)
    reported = [
        {"kernel": next(k for k in PTXAS_REPORTED if k in name), "function": name,
         "registers": regs, "spill_store_bytes": st, "spill_load_bytes": ld}
        for name, regs, st, ld, _ in entries if any(k in name for k in PTXAS_REPORTED)
    ]
    grouped = [
        {"function": name, "registers": regs, "spill_store_bytes": st, "spill_load_bytes": ld,
         "static_smem_bytes": smem}
        for name, regs, st, ld, smem in entries if GROUPED_KERNEL in name
    ]
    spmm = [
        {"function": name, "registers": regs, "spill_store_bytes": st, "spill_load_bytes": ld,
         "static_smem_bytes": smem}
        for name, regs, st, ld, smem in entries if SPMM_KERNEL in name
    ]
    sym_spmm = [
        {"function": name, "registers": regs, "spill_store_bytes": st, "spill_load_bytes": ld,
         "static_smem_bytes": smem}
        for name, regs, st, ld, smem in entries if SYM_SPMM_KERNEL in name
    ]
    bsr = [
        {"function": name, "registers": regs, "spill_store_bytes": st, "spill_load_bytes": ld,
         "static_smem_bytes": smem}
        for name, regs, st, ld, smem in entries if any(k in name for k in BSR_KERNELS)
    ]
    pruned_spmm = [
        {"function": name, "registers": regs, "spill_store_bytes": st, "spill_load_bytes": ld,
         "static_smem_bytes": smem}
        for name, regs, st, ld, smem in entries if PRUNED_SPMM_KERNEL in name
    ]
    dia_spmv = {
        k: [{"function": name, "registers": regs, "spill_store_bytes": st,
             "spill_load_bytes": ld, "static_smem_bytes": smem}
            for name, regs, st, ld, smem in entries if k in name]
        for k in DIA_SPMV_KERNELS
    }
    launch = {f"{v}/{x}": grouped_launch_config(v, x)
              for v, x in sorted(KERNEL_DTYPES, key=str)}
    # one k per column-group count: 1, and one past each multiple of C
    spmm_launch = {f"{v}/{x}/k={k}": spmm_launch_config(v, x, k)
                   for v, x in sorted(KERNEL_DTYPES, key=str)
                   for k in ((1, 9) if x == torch.float32 else (1, 5, 9))}
    emit({"phase": "build", "seconds": round(b.seconds, 3), "library": b.path.name,
          "kernels": len(spills), "spill_store_bytes": sum(spills), "ptxas": ptxas})
    emit({"phase": "build_spmv_kernels", "instantiations": reported})
    emit({"phase": "build_grouped_spmm", "instantiations": grouped,
          "launch_by_dtype_pair": launch})
    emit({"phase": "build_spmm", "instantiations": spmm, "launch_by_dtype_pair_and_k": spmm_launch})
    emit({"phase": "build_sym_spmm", "instantiations": sym_spmm,
          "registers": [min(r["registers"] for r in sym_spmm),
                        max(r["registers"] for r in sym_spmm)] if sym_spmm else None,
          "spill_bytes": sum(r["spill_store_bytes"] + r["spill_load_bytes"] for r in sym_spmm)})
    emit({"phase": "build_bsr_grouped", "instantiations": bsr,
          "registers": [min(r["registers"] for r in bsr), max(r["registers"] for r in bsr)]
          if bsr else None,
          "spill_bytes": sum(r["spill_store_bytes"] + r["spill_load_bytes"] for r in bsr)})
    emit({"phase": "build_pruned_spmm", "instantiations": pruned_spmm,
          "registers": [min(r["registers"] for r in pruned_spmm),
                        max(r["registers"] for r in pruned_spmm)] if pruned_spmm else None,
          "spill_bytes": sum(r["spill_store_bytes"] + r["spill_load_bytes"] for r in pruned_spmm),
          "dynamic_smem_bytes": 110592})
    emit({"phase": "build_dia_spmv", "instantiations": dia_spmv,
          "dynamic_smem": "dia_spmv and dia_sym_spmv none; dia_spmv_resident its window, at "
                          "most m values; dia_spmv_window its tile's aligned pieces"})
    if not spills or any(spills):
        raise AssertionError(f"ptxas spill stores per kernel: {spills}")
    for k, rows in dia_spmv.items():
        if len(rows) != DIA_SPMV_INSTANTIATIONS or any(
                r["spill_store_bytes"] or r["spill_load_bytes"] for r in rows):
            raise AssertionError(f"want {DIA_SPMV_INSTANTIATIONS} {k} instantiations without "
                                 f"spills: {rows}")
    if len(reported) != 10 or any(r["spill_store_bytes"] or r["spill_load_bytes"] for r in reported):
        raise AssertionError(f"want 10 pruned SpMV instantiations without spills: {reported}")
    if len(pruned_spmm) != PRUNED_SPMM_INSTANTIATIONS or any(
            r["spill_store_bytes"] or r["spill_load_bytes"] for r in pruned_spmm):
        raise AssertionError(f"want {PRUNED_SPMM_INSTANTIATIONS} pruned SpMM instantiations "
                             f"without spills: {pruned_spmm}")
    if len(grouped) != 5 or any(r["spill_store_bytes"] or r["spill_load_bytes"] for r in grouped):
        raise AssertionError(f"want 5 grouped SpMM instantiations without spills: {grouped}")
    if len(spmm) != SPMM_INSTANTIATIONS or any(r["spill_store_bytes"] or r["spill_load_bytes"]
                                               for r in spmm):
        raise AssertionError(f"want {SPMM_INSTANTIATIONS} SpMM instantiations without spills: {spmm}")
    if len(sym_spmm) != SYM_SPMM_INSTANTIATIONS or any(
            r["spill_store_bytes"] or r["spill_load_bytes"] for r in sym_spmm):
        raise AssertionError(f"want {SYM_SPMM_INSTANTIATIONS} symmetric SpMM instantiations "
                             f"without spills: {sym_spmm}")
    if len(bsr) != BSR_INSTANTIATIONS or any(r["spill_store_bytes"] or r["spill_load_bytes"]
                                             for r in bsr):
        raise AssertionError(f"want {BSR_INSTANTIATIONS} grouped-BSR instantiations without "
                             f"spills: {bsr}")


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
    many = sorted(int(o) for o in rng.choice(np.arange(-3000, 3001), 300, replace=False))
    full_cases = [
        ("square", 50_000, 50_000, [0, 1, -1, 300, -300, 2500, -2500]),
        ("tall", 60_000, 45_001, [0, 4, -300, 2500, -2500]),
        ("wide", 45_001, 60_000, [-1, 0, -4, 300, 2500]),
        ("unaligned", 33_333, 33_333, [0, 1, -1, 300, -2500]),
        ("one_diag", 70_000, 70_000, [0]),
        ("band64", 40_000, 40_000, band),
    ]
    # dia_spmv's load forms (NaN in every slot outside the matrix): an odd
    # stride and values or x off a 16-byte boundary (one value a load), n
    # not a whole number of a thread's rows, n below one block, offsets past
    # +-n, more diagonals than one staged chunk of 128
    form_cases = [
        ("odd_stride", 33_333, 33_333, [-300, -1, 0, 1, 2, 3, 300], "odd_stride"),
        ("rows_not_whole", 50_003, 49_999, [-2500, -3, -1, 0, 1, 7, 2500], "aligned"),
        ("below_one_block", 100, 90, [-7, -1, 0, 1, 2, 50], "aligned"),
        ("below_one_block_odd_stride", 37, 41, [-5, 0, 3], "odd_stride"),
        ("past_n", 20_000, 20_000, [-20_005, -20_000, -1, 0, 1, 20_000, 20_003], "aligned"),
        ("many_diagonals", 20_001, 25_000, many, "aligned"),
        ("many_diagonals_odd_stride", 20_001, 25_000, many, "odd_stride"),
        ("values_off_16", 30_000, 30_000, [-300, -1, 0, 1, 300], "values_off_16"),
        ("x_off_16", 30_000, 30_000, [-300, -1, 0, 1, 300], "x_off_16"),
    ]
    g = torch.Generator(device=device).manual_seed(3)

    def off_16(t):  # a contiguous copy one value into a larger store
        store = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        v = store[1:].view(t.shape)
        v.copy_(t)
        return v
    sym_cases = [
        ("stencil", 50_000, [0, 1, 300, 2500]),
        ("no_main_unaligned", 33_333, [1, 130, 259]),
        ("wide_band", 40_000, sorted({abs(o) for o in band})),
    ]
    # dia_sym_spmv's load forms (NaN in every slot outside the matrix):
    # mirror offsets that are and are not multiples of a thread's rows, an
    # odd stride and values or x off a 16-byte boundary, n not a whole
    # number of a thread's rows, n below one block, offsets at and past n,
    # no main diagonal, more diagonals than one staged chunk of 256
    many_upper = sorted(int(o) for o in rng.choice(np.arange(0, 3001), 300, replace=False))
    sym_form_cases = [
        ("odd_offsets", 40_001, [0, 1, 2, 3, 5, 7, 122], "aligned"),
        ("odd_stride", 33_333, [0, 1, 30, 259], "odd_stride"),
        ("values_off_16", 30_000, [0, 1, 3, 300], "values_off_16"),
        ("x_off_16", 30_000, [0, 1, 3, 300], "x_off_16"),
        ("rows_not_whole", 50_003, [0, 1, 5, 250], "aligned"),
        ("below_one_block", 37, [0, 1, 2, 5], "aligned"),
        ("below_one_block_odd_stride", 37, [0, 3, 36], "odd_stride"),
        ("at_and_past_n", 20_000, [0, 1, 19_999, 20_000, 20_003], "aligned"),
        ("no_main", 33_333, [1, 130, 259], "aligned"),
        ("many_diagonals", 20_001, many_upper, "aligned"),
        ("many_diagonals_odd_stride", 20_001, many_upper, "odd_stride"),
    ]

    def tol(vdt, xdt):
        # accumulation is in x's dtype; values widen exactly
        return 1e-12 if xdt == torch.float64 else 1e-5

    worst = {"dia_spmv": 0.0, "dia_sym_spmv": 0.0}
    worst_form, worst_sym_form = {}, {}
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
        for name, n, m, offs, form in form_cases:
            stride = n + 1 + n % 2 if form == "odd_stride" else -(-n // 128) * 128
            data, off_t = nan_outside_dia(g, n, m, offs, stride, vdt, device)
            x = torch.randn(m, generator=g, device=device, dtype=torch.float64).to(xdt)
            if form == "values_off_16":
                data = off_16(data)
            elif form == "x_off_16":
                x = off_16(x)
            y = dia_spmv(data, x, off_t, n, m)
            torch.cuda.synchronize()
            e = rel_err(y, dia_spmv_reference(data, x, off_t, n, m))
            if not e <= tol(vdt, xdt):
                raise AssertionError(f"dia_spmv {name} {vdt}/{xdt}: rel err {e:.3e}")
            worst_form[name] = max(worst_form.get(name, 0.0), e)
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
        for name, n, offs, form in sym_form_cases:
            stride = n + 1 + n % 2 if form == "odd_stride" else -(-n // 128) * 128
            # slot (d, i) lies inside for i < n - o: dia_spmv's mask at m = n
            data, off_t = nan_outside_dia(g, n, n, offs, stride, vdt, device)
            x = torch.randn(n, generator=g, device=device, dtype=torch.float64).to(xdt)
            if form == "values_off_16":
                data = off_16(data)
            elif form == "x_off_16":
                x = off_16(x)
            y, y2 = dia_sym_spmv(data, x, off_t, n), dia_sym_spmv(data, x, off_t, n)
            torch.cuda.synchronize()
            e = rel_err(y, dia_sym_spmv_reference(data, x, off_t, n))
            if not (e <= tol(vdt, xdt) and torch.equal(y, y2)):
                raise AssertionError(f"dia_sym_spmv {name} {vdt}/{xdt}: rel err {e:.3e}, "
                                     f"repeat bitwise equal {torch.equal(y, y2)}")
            worst_sym_form[name] = max(worst_sym_form.get(name, 0.0), e)
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
          "dia_spmv_load_forms_worst_rel_err": worst_form,
          "dia_sym_spmv_load_forms_worst_rel_err": worst_sym_form,
          "dia_sym_spmv_load_forms_repeat": "two launches a case, bitwise equal",
          "rmatvec_rel_err": e,
          "tolerance": "1e-12 with f64 vectors, 1e-5 with f32 vectors"})


# dia_spmm's check cases (tests/test_torch_cuda.py's): k of one and two
# column groups (four with f64 vectors), whole and partial register tiles
SPMM_CHECK_K = (1, 3, 4, 5, 8, 9, 12, 16)
SPMM_CHECK_SHAPE = (20_001, 25_000)  # n != m, n not a multiple of a block's rows


def spmm_check_offsets(n, m):
    """dia_spmm's offset sets over the port's value stride (n padded to a
    multiple of 128: value rows in 16-byte pieces, NaN padding rows n and
    above): a stencil's far offsets (runs of one diagonal), one consecutive
    band, a band with gaps, a band wider than one window (several runs),
    offsets wholly outside [-n, m], and none; and the stencil's offsets
    again over an odd stride (value rows one value a copy) and over a
    stride of 2 mod 4 just past n (f64 rows in 16-byte pieces, whose last
    row group's piece would run past the row)."""
    stencil = [-4900, -70, -1, 0, 1, 70, 4900]
    padded = -(-n // 128) * 128
    return {
        "stencil": (stencil, padded),
        "band": (list(range(-122, 123)), padded),
        "band_with_gaps": (sorted(set(range(-60, 61)) - {-7, 3, 4, 30}), padded),
        "past_the_window": (list(range(-600, 601)), padded),
        "outside": ([-n - 7, -n, m, m + 5, 3 * m], padded),
        "none": ([], padded),
        "odd_stride": (stencil, n + 2),
        "stride_2_mod_4": (stencil, n + 1),
    }


def nan_outside_dia(g, n, m, offsets, stride, vdtype, device):
    """Random (D, stride) DIA values, NaN in every slot outside the n x m
    matrix: an out-of-range term must be selected away, never multiplied
    by zero."""
    import torch

    offs = torch.tensor(offsets, dtype=torch.int64, device=device)
    data = torch.randn((len(offsets), stride), generator=g, device=device, dtype=torch.float64)
    rows = torch.arange(stride, device=device)
    cols = rows[None, :] + offs[:, None]
    data[~((rows[None, :] < n) & (cols >= 0) & (cols < m))] = float("nan")
    return data.to(vdtype), offs


def dia_spmm_cases(device):
    """dia_spmm against its plain version on every SPMM_CHECK_K, offset
    set, dtype pair and layout; returns (cases, worst rel err by set)."""
    import torch

    from sigma_tpu_torch.ops import (
        KERNEL_DTYPES, LAYOUTS, dia_spmm, dia_spmm_reference, interleave_panels,
    )

    n, m = SPMM_CHECK_SHAPE
    g = torch.Generator(device=device).manual_seed(9)
    worst, count = {}, 0
    for vdt, xdt in sorted(KERNEL_DTYPES, key=str):
        tol = 1e-12 if xdt == torch.float64 else 1e-5
        for label, (offs, stride) in spmm_check_offsets(n, m).items():
            data, off_t = nan_outside_dia(g, n, m, offs, stride, vdt, device)
            for layout in LAYOUTS:
                for k in SPMM_CHECK_K:
                    XT = torch.randn((k, m), generator=g, device=device, dtype=xdt)
                    X = (XT if layout == "rhs_major" else XT.T.contiguous()
                         if layout == "cols" else interleave_panels(XT, m))
                    # y comes from torch.empty: the comparison covers every
                    # row, the interleaved layout's zero padding included
                    Y = dia_spmm(data, X, off_t, n, m, layout)
                    torch.cuda.synchronize()
                    ref = dia_spmm_reference(data, X, off_t, n, m, layout)
                    e = rel_err(Y, ref)
                    if not (e <= tol and Y.shape == ref.shape):
                        raise AssertionError(f"dia_spmm {label} {layout} k={k} {vdt}/{xdt}: "
                                             f"rel err {e:.3e} > {tol}")
                    worst[label] = max(worst.get(label, 0.0), e)
                    count += 1
    return count, worst


SYM_CHECK_N = 20_001  # not a multiple of a block's rows, nor of 4


def sym_spmm_check_offsets(n, band):
    """dia_sym_spmm's offset sets (value stride n padded to a multiple of
    128 unless said): a stencil's {0, 1, nx, nx^2} with nx^2 past a block's
    rows, runs of consecutive offsets as the node-major elasticity
    operator's, no main diagonal, a 64-diagonal band, offsets at and past
    n; the stencil's again over an odd stride (one value a load) and in a
    value view off a 16-byte boundary."""
    stencil = [0, 1, 70, 4900]
    padded = -(-n // 128) * 128
    return {
        "stencil": (stencil, padded, 0),
        "runs": ([0, 1, 2, 3, 4, 5, 448, 449, 450, 451, 452], padded, 0),
        "no_main": ([1, 130, 259], padded, 0),
        "band": (sorted({abs(o) for o in band}), padded, 0),
        "past_n": ([0, 3, n - 1, n, n + 5], padded, 0),
        "odd_stride": (stencil, n + 2, 0),
        "unaligned_view": (stencil, padded, 1),
    }


def dia_sym_spmm_cases(device, band):
    """dia_sym_spmm against its plain version on every SPMM_CHECK_K, offset
    set, dtype pair and layout, NaN in every stored slot the matrix does not
    hold (rows n - o and past of each diagonal), two launches bitwise
    equal; returns (cases, worst rel err by set)."""
    import torch

    from sigma_tpu_torch.ops import (
        KERNEL_DTYPES, LAYOUTS, dia_sym_spmm, dia_sym_spmm_reference, interleave_panels,
    )

    n = SYM_CHECK_N
    g = torch.Generator(device=device).manual_seed(13)
    worst, count = {}, 0
    for vdt, xdt in sorted(KERNEL_DTYPES, key=str):
        tol = 1e-12 if xdt == torch.float64 else 1e-5
        for label, (offs, stride, skew) in sym_spmm_check_offsets(n, band).items():
            off_t = torch.tensor(offs, dtype=torch.int64, device=device)
            vals = torch.randn((len(offs), stride), generator=g, device=device,
                               dtype=torch.float64)
            rows = torch.arange(stride, device=device)
            vals[rows[None, :] + off_t[:, None] >= n] = float("nan")
            store = torch.empty(vals.numel() + skew, dtype=vdt, device=device)
            data = store[skew:].view(vals.shape)
            data.copy_(vals)
            for layout in LAYOUTS:
                for k in SPMM_CHECK_K:
                    XT = torch.randn((k, n), generator=g, device=device, dtype=xdt)
                    X = (XT if layout == "rhs_major" else XT.T.contiguous()
                         if layout == "cols" else interleave_panels(XT, n))
                    # y comes from torch.empty: the comparison covers every
                    # row, the interleaved layout's zero padding included
                    Y = dia_sym_spmm(data, X, off_t, n, layout)
                    Y2 = dia_sym_spmm(data, X, off_t, n, layout)
                    torch.cuda.synchronize()
                    ref = dia_sym_spmm_reference(data, X, off_t, n, layout)
                    e = rel_err(Y, ref)
                    name = f"dia_sym_spmm {label} {layout} k={k} {vdt}/{xdt}"
                    if not (e <= tol and Y.shape == ref.shape):
                        raise AssertionError(f"{name}: rel err {e:.3e} > {tol}")
                    if not torch.equal(Y, Y2):
                        raise AssertionError(f"{name}: two launches differ")
                    worst[label] = max(worst.get(label, 0.0), e)
                    count += 1
    return count, worst


def phase_spmm_kernels(device):
    """dia_spmm and dia_sym_spmm against their plain versions on the card:
    dia_spmm in every dtype pair and panel layout, k in {1, 3, 8, 16}, at
    the odd shapes of phase_kernels and on dia_spmm_cases; dia_sym_spmm on
    dia_sym_spmm_cases; and DIAMatrix.rmatmat of a tall matrix against the
    CPU."""
    import numpy as np
    import torch

    from sigma_tpu_torch import DIAGraph, DIAMatrix
    from sigma_tpu_torch.ops import (
        KERNEL_DTYPES, LAYOUTS, dia_spmm, dia_spmm_reference, interleave_panels,
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

    worst = {"dia_spmm": 0.0}
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
    cases, worst_by_set = dia_spmm_cases(device)
    sym_cases, sym_worst_by_set = dia_sym_spmm_cases(device, band)
    worst["dia_sym_spmm"] = max(sym_worst_by_set.values())
    emit({"phase": "spmm_kernel_checks", "cases": count + 1 + cases + sym_cases,
          "worst_rel_err": {k: float(v) for k, v in worst.items()},
          "dia_spmm_cases": cases, "dia_spmm_k": list(SPMM_CHECK_K),
          "dia_spmm_worst_rel_err_by_offsets": worst_by_set,
          "dia_sym_spmm_cases": sym_cases, "dia_sym_spmm_k": list(SPMM_CHECK_K),
          "dia_sym_spmm_worst_rel_err_by_offsets": sym_worst_by_set,
          "rmatmat_rel_err": e,
          "tolerance": "1e-12 with f64 vectors, 1e-5 with f32 vectors"})


# the grouped SpMM's check cases (tests/test_torch_cuda.py's): scattered
# offsets and a band past the window space (the runs route), a band with
# gaps, all-positive and all-negative bands; k of one column, partial and
# whole register tiles and several column groups; n not a multiple of 256
GROUPED_CHECK_K = (1, 17, 24, 32, 33, 48)


def phase_grouped_kernels(device):
    """dia_spmm_grouped against its plain version on the card: every dtype
    pair, both layouts, every k of GROUPED_CHECK_K, five offset sets, at
    20,001 x 25,000; and D = 0 (zeros written over torch.empty)."""
    import numpy as np
    import torch

    from sigma_tpu_torch.ops import (
        GROUPED_LAYOUTS, KERNEL_DTYPES, dia_spmm_grouped, dia_spmm_grouped_reference,
    )

    rng = np.random.default_rng(20)
    offsets = {
        "scattered": sorted(int(o) for o in rng.choice(np.arange(-3000, 3001), 100,
                                                       replace=False)),
        "band_with_gaps": sorted(set(range(-60, 61)) - {-7, 3, 4, 30}),
        "all_positive": list(range(1, 90)),
        "all_negative": list(range(-89, 0)),
        "past_the_window": list(range(-150, 151)),
    }
    n, m = 20_001, 25_000
    worst, count = {}, 0
    for vdt, xdt in sorted(KERNEL_DTYPES, key=str):
        tol = 1e-12 if xdt == torch.float64 else 1e-5
        for label, offs in offsets.items():
            data = _random_dia(rng, n, m, offs, vdt, device)
            off_t = torch.tensor(offs, dtype=torch.int64, device=device)
            for layout in GROUPED_LAYOUTS:
                for k in GROUPED_CHECK_K:
                    XT = torch.from_numpy(rng.standard_normal((k, m))).to(device, xdt)
                    X = XT if layout == "rhs_major" else XT.T.contiguous()
                    Y = dia_spmm_grouped(data, X, off_t, n, m, layout)
                    torch.cuda.synchronize()
                    ref = dia_spmm_grouped_reference(data, X, off_t, n, m, layout)
                    e = rel_err(Y, ref)
                    if not (e <= tol and Y.shape == ref.shape):
                        raise AssertionError(f"dia_spmm_grouped {label} {layout} k={k} "
                                             f"{vdt}/{xdt}: rel err {e:.3e} > {tol}")
                    worst[label] = max(worst.get(label, 0.0), e)
                    count += 1
        for layout in GROUPED_LAYOUTS:
            X = torch.ones((40, 700) if layout == "rhs_major" else (700, 40), dtype=xdt,
                           device=device)
            Y = dia_spmm_grouped(torch.empty((0, 1024), dtype=vdt, device=device), X,
                                 torch.empty(0, dtype=torch.int64, device=device), 1000, 700,
                                 layout)
            torch.cuda.synchronize()
            if Y.any():
                raise AssertionError(f"dia_spmm_grouped with no diagonals wrote nonzeros ({layout})")
            count += 1
    emit({"phase": "grouped_kernel_checks", "cases": count, "k": list(GROUPED_CHECK_K),
          "worst_rel_err": worst,
          "tolerance": "1e-12 with f64 vectors, 1e-5 with f32 vectors"})


def phase_north_star_spmm(device, nx, k=8, sym_k=4):
    """The SpMM kernels and their plain versions at the main path's shapes
    (nx=216, k=8: bench.py's and cg3d.py's width; dia_sym_spmm also at
    k=4, the GMG block CG's width), timed with CUDA events in every panel
    layout; returns the rows keyed "kernel/layout" (k=8) and
    "dia_sym_spmm/layout/k4"."""
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
    csr = csr_from_dia(A)
    panels, library = {}, {}
    for kk in (k, sym_k):
        XT = torch.rand((kk, n), generator=g, device=device)
        panels[kk] = {"rhs_major": XT, "interleaved": interleave_panels(XT, n),
                      "cols": XT.T.contiguous()}
        # cuSPARSE on the same panels: the (n, k) columns, and the RHS-major
        # panels as the column-major (n, k) block XT.T; it has no interleaved
        # layout, so that row is held to the columns
        cols = (median_ms(lambda: csr @ panels[kk]["cols"]), "X (n, k)")
        library[kk] = {"cols": cols, "interleaved": cols,
                       "rhs_major": (median_ms(lambda: csr @ XT.T), "XT.T (n, k) column-major")}
        del XT
    del csr
    variants = [
        ("dia_spmm", "full_f32_interleaved", "interleaved", k, A.data, A.offsets_dev, dia_spmm, dia_spmm_reference, (n, n)),
        ("dia_spmm", "full_f32_rhs_major", "rhs_major", k, A.data, A.offsets_dev, dia_spmm, dia_spmm_reference, (n, n)),
        ("dia_spmm", "full_f32_cols", "cols", k, A.data, A.offsets_dev, dia_spmm, dia_spmm_reference, (n, n)),
    ] + [
        ("dia_sym_spmm", f"sym_f32_{layout}", layout, kk, S.data, S.offsets_dev, dia_sym_spmm, dia_sym_spmm_reference, (n,))
        for kk in (k, sym_k) for layout in ("interleaved", "rhs_major", "cols")
    ]
    rows = {}
    for kname, label, layout, kk, data, offs, kern, plain, dims in variants:
        X = panels[kk][layout]
        y = kern(data, X, offs, *dims, layout)
        yr = plain(data, X, offs, *dims, layout)
        torch.cuda.synchronize()
        err_abs = float((y - yr).abs().max())
        err_rel = rel_err(y, yr)
        del y, yr
        if not err_rel <= 1e-5:
            raise AssertionError(f"{kname} {label} k={kk} at nx={nx}: rel err {err_rel:.3e}")
        ms = median_ms(lambda: kern(data, X, offs, *dims, layout))
        plain_ms = median_ms(lambda: plain(data, X, offs, *dims, layout), reps=10, warmup=2)
        # byte floor: stored nonzero values once + k x-panels read + k
        # y-panels written
        stored = int(torch.count_nonzero(data))
        byts = stored * data.element_size() + 2 * kk * n * X.element_size()
        bound_ms, bound_by = bound(
            data.numel() * data.element_size() + 2 * kk * n * X.element_size(),
            2 * kk * nnz, X.dtype,
        )
        row = {
            "phase": "north_star_spmm", "variant": label, "kernel": kname,
            "layout": layout, "k": kk, "n": n, "nnz": nnz,
            "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library[kk][layout][0],
            "library": f"torch.sparse_csr @ {library[kk][layout][1]} (cuSPARSE), full storage",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "k_gnnz_s": kk * nnz / (ms * 1e-3) / 1e9,
            "plain_k_gnnz_s": kk * nnz / (plain_ms * 1e-3) / 1e9,
            "bytes_floor_mb": byts / 1e6,
            "achieved_gbs": byts / (ms * 1e-3) / 1e9,
            "stream_copy_gbs": stream_gbs,
            "max_abs_err": err_abs, "rel_err": err_rel,
        }
        emit(row)
        rows[f"{kname}/{layout}" + ("" if kk == k else f"/k{kk}")] = row
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
    csr = csr_from_dia(A)
    library_ms = median_ms(lambda: csr @ x)
    library_device_ms = device_ms(lambda: csr @ x)
    del csr
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
        dev_ms = device_ms(lambda: kern(data, x, offs, *dims))
        plain_ms = median_ms(lambda: plain(data, x, offs, *dims))
        # bytes: stored nonzero values once + x read + y written (the
        # bench.py:579 model, 4 + 8n/nnz B/nnz for full f32)
        stored = int(torch.count_nonzero(data))
        byts = stored * data.element_size() + 2 * n * x.element_size()
        # the bound: the value array as given, x read once, y written once
        bound_ms, bound_by = bound(
            data.numel() * data.element_size() + 2 * n * x.element_size(), 2 * nnz, x.dtype
        )
        row = {
            "phase": "north_star_spmv", "variant": label, "kernel": kname,
            "n": n, "nnz": nnz, "kernel_ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "library": "torch.sparse_csr @ x (cuSPARSE), full storage",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "device_bound_share": bound_ms / dev_ms,
            "library_device_bound_share": bound_ms / library_device_ms,
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
    runs them (symmetric operator, bf16 levels, 2x2x2 aggregates); returns
    the Chebyshev hierarchy (its levels are the staged path's operands)."""
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
    return M


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


# -- the unstructured pruned path ------------------------------------------
def _random_pruned(rng, n, m, band, *, lo=None, outliers=0, tile_rows=1024, group=3):
    """A pruned plan (f64 values) of random banded-with-outliers triples."""
    import numpy as np

    from sigma_tpu_torch.ops import build_pruned_plan

    rows = rng.integers(0, n, 4 * n)
    cols = rows + rng.integers(-band if lo is None else lo, band + 1, rows.size)
    if outliers:
        cols[:outliers] = rng.integers(0, m, outliers)
    ok = (cols >= 0) & (cols < m)
    return build_pruned_plan(n, m, rows[ok], cols[ok], rng.standard_normal(int(ok.sum())),
                             tile_rows=tile_rows, group=group, dtype=np.float64)


# edge cases of the pruned kernels (1024-row SpMV blocks, 1024 / G-row
# SpMM blocks; a TMA value ring and a staged x window where the tile's
# reach allows, plain loads beyond it): (name, n, m, tile_rows, reach,
# sym_shift, tile left empty); the last two only for the SpMMs: an x window
# that does not fit at k = 16 with f64 vectors, and an operand of more
# blocks than half the SMs (below that the SpMMs take twice the column
# groups and half the rows a block)
SPMV_EDGES = [
    ("n_not_a_multiple_of_the_block", 5000, 5000, 1024, 300, 0, None),
    ("tile_of_padding_only", 6000, 6000, 1024, 200, 0, 2),
    ("reach_at_the_halo", 4096, 4096, 1024, 895, 0, None),
    ("window_at_its_cap", 4096, 4096, 1024, 508, 0, None),
    ("t_minus_1_beyond_the_first_block", 6144, 6144, 2048, 1500, 0, None),
    ("sym_shift_spill", 2048, 2560, 1024, 300, 128, None),
]
SPMM_EDGES = SPMV_EDGES + [("window_past_its_cap_at_k16_f64", 4096, 4096, 1024, 300, 0, None),
                           ("more_blocks_than_half_the_sms", 70_000, 70_000, 2048, 300, 0, None)]


def _edge_plan(rng, n, m, tile_rows, reach, shift, empty):
    """A pruned plan (f64 values) of banded triples whose reach is exactly
    ``reach`` (columns >= rows + shift for a symmetric block), without the
    rows of tile ``empty``."""
    import numpy as np

    from sigma_tpu_torch.ops import build_pruned_plan

    rows = rng.integers(0, n, 4 * n)
    cols = rows + rng.integers(shift if shift else -reach, reach + 1, rows.size)
    rows = np.r_[rows, n // 2, n // 3]
    cols = np.r_[cols, n // 2 + reach, n // 3 + (shift if shift else -reach)]
    keep = (cols >= 0) & (cols < m)
    if empty is not None:
        keep &= rows // tile_rows != empty
    return build_pruned_plan(n, m, rows[keep], cols[keep], rng.standard_normal(int(keep.sum())),
                             tile_rows=tile_rows, group=3, dtype=np.float64)


def phase_pruned_kernels(device):
    """The four pruned kernels against their plain versions on the card:
    every dtype pair, both panel layouts, k in {1, 3, 8, 16}, rectangular
    and unaligned shapes, tiles of 1024 and 2048 rows, groups 3, 8 and 12,
    and a rectangular symmetric block with sym_shift > 0 and its spill;
    each with the plan's active tile ends and without them (every slot
    walked), the SpMMs twice for equal bits; and on the edge cases of
    ``SPMV_EDGES`` (the SpMMs at k = 3 and 16 on ``SPMM_EDGES``).  Each
    case's SpMM panels are the first k of 16, held to the first k panels
    of one plain SpMM of all 16."""
    import numpy as np
    import torch

    from sigma_tpu_torch.ops import (
        KERNEL_DTYPES, PRUNED_LAYOUTS, pruned_matvec_reference, pruned_spmm,
        pruned_spmm_reference, pruned_spmv, pruned_sym_matvec_reference, pruned_sym_spmm,
        pruned_sym_spmm_reference, pruned_sym_spmv,
    )

    rng = np.random.default_rng(2)
    full_cases = [  # (name, n, m, band, outliers, tile_rows, group)
        ("square", 20_000, 20_000, 300, 40, 1024, 8),
        ("tall_unaligned", 21_001, 17_777, 500, 20, 2048, 3),
        ("wide_unaligned", 17_777, 21_001, 900, 0, 1024, 12),
    ]
    sym_cases = [  # (name, n, m, band, sym_shift, tile_rows, group)
        ("square_unaligned", 20_001, 20_001, 300, 0, 1024, 12),
        ("square", 16_384, 16_384, 700, 0, 2048, 8),
        ("rect_sym_shift", 16_384, 16_384 + 1024, 400, 256, 1024, 3),
    ]
    worst = dict.fromkeys(("pruned_spmv", "pruned_spmm", "pruned_sym_spmv", "pruned_sym_spmm"), 0.0)
    count = 0

    def same_bits(name, key, a, b):
        if not torch.equal(a, b):
            raise AssertionError(f"{key} {name}: two launches differ")

    def check(name, key, y, ref, xdt):
        nonlocal count
        e = rel_err(y, ref)
        tol = 1e-12 if xdt == torch.float64 else 1e-5
        if not (e <= tol and y.shape == ref.shape):
            raise AssertionError(f"{key} {name}: rel err {e:.3e} > {tol} or shape {tuple(y.shape)}")
        worst[key] = max(worst[key], e)
        count += 1

    def spill_check(name, key, s, sr, scale, xdt):
        e = float((s.double() - sr.double()).abs().max()) / max(scale, 1e-300)
        if not e <= (1e-12 if xdt == torch.float64 else 1e-5):
            raise AssertionError(f"{key} {name}: spill err {e:.3e}")

    def in_layout(T, k, layout):
        """The first k rows of the RHS-major T (16 panels of x, or their
        reference) in ``layout``: each panel's plain version is computed
        alone, so the reference of 16 panels holds that of their first k."""
        return T[:k] if layout == "rhs_major" else T[:k].T.contiguous()

    def panels16(m, xdt):
        return torch.from_numpy(rng.standard_normal((16, m))).to(device, xdt)

    plans = [(c, _random_pruned(rng, c[1], c[2], c[3], outliers=c[4], tile_rows=c[5], group=c[6]))
             for c in full_cases]
    sym_plans = [(c, _random_pruned(rng, c[1], c[2], c[3] + c[4], lo=c[4], tile_rows=c[5], group=c[6]))
                 for c in sym_cases]
    edge_plans = [(c, _edge_plan(rng, *c[1:])) for c in SPMM_EDGES]

    def ends(P):
        return torch.from_numpy(P.tile_end).to(device)
    for vdt, xdt in sorted(KERNEL_DTYPES, key=str):
        for (name, n, m, *_), P in plans:
            d = torch.from_numpy(P.data).to(device, vdt)
            o, tp = torch.from_numpy(P.offsets).to(device), torch.from_numpy(P.tile_ptr).to(device)
            x = torch.from_numpy(rng.standard_normal(m)).to(device, xdt)
            label = f"{name} {vdt}/{xdt}"
            yr = pruned_matvec_reference(d, x, o, tp, n, m)
            check(label, "pruned_spmv", pruned_spmv(d, x, o, tp, n, m), yr, xdt)
            check(f"{label} active ends", "pruned_spmv",
                  pruned_spmv(d, x, o, tp, n, m, tile_end=ends(P)), yr, xdt)
            XT = panels16(m, xdt)
            R = pruned_spmm_reference(d, XT, o, tp, n, m, "rhs_major")
            for layout in PRUNED_LAYOUTS:
                for k in (1, 3, 8, 16):
                    X, Yr = in_layout(XT, k, layout), in_layout(R, k, layout)
                    for te in (ends(P), None):
                        case = f"{label} {layout} k={k}" + (" every slot" if te is None else "")
                        Y = pruned_spmm(d, X, o, tp, n, m, layout, tile_end=te)
                        check(case, "pruned_spmm", Y, Yr, xdt)
                        same_bits(case, "pruned_spmm", Y,
                                  pruned_spmm(d, X, o, tp, n, m, layout, tile_end=te))
        for (name, n, m, _, shift, *_), P in sym_plans:
            d = torch.from_numpy(P.data).to(device, vdt)
            o, tp = torch.from_numpy(P.offsets).to(device), torch.from_numpy(P.tile_ptr).to(device)
            kw = dict(halo=P.halo, sym_shift=shift, with_spill=True)
            x = torch.from_numpy(rng.standard_normal(m)).to(device, xdt)
            label = f"{name} {vdt}/{xdt}"
            yr, sr = pruned_sym_matvec_reference(d, x, o, tp, n, m, **kw)
            for te in (None, ends(P)):
                y, s = pruned_sym_spmv(d, x, o, tp, n, m, tile_end=te, **kw)
                check(label, "pruned_sym_spmv", y, yr, xdt)
                spill_check(label, "pruned_sym_spmv", s, sr, float(yr.abs().max()), xdt)
            if (shift > 0) != bool(sr.abs().max() > 0):
                raise AssertionError(f"pruned_sym_spmv {label}: spill {float(sr.abs().max())}")
            XT = panels16(m, xdt)
            R, RS = pruned_sym_spmm_reference(d, XT, o, tp, n, m, "rhs_major", **kw)
            for layout in PRUNED_LAYOUTS:
                for k in (1, 3, 8, 16):
                    X, Yr = in_layout(XT, k, layout), in_layout(R, k, layout)
                    Sr = in_layout(RS, k, layout)
                    for te in (ends(P), None):
                        case = f"{label} {layout} k={k}" + (" every slot" if te is None else "")
                        Y, S = pruned_sym_spmm(d, X, o, tp, n, m, layout, tile_end=te, **kw)
                        check(case, "pruned_sym_spmm", Y, Yr, xdt)
                        spill_check(case, "pruned_sym_spmm", S, Sr, float(Yr.abs().max()), xdt)
                        same_bits(case, "pruned_sym_spmm", Y,
                                  pruned_sym_spmm(d, X, o, tp, n, m, layout, tile_end=te, **kw)[0])
        for (name, n, m, _, _, shift, empty), P in edge_plans:
            d = torch.from_numpy(P.data).to(device, vdt)
            o, tp = torch.from_numpy(P.offsets).to(device), torch.from_numpy(P.tile_ptr).to(device)
            if empty is not None and not P.tile_end[empty] == P.tile_ptr[empty] < P.tile_ptr[empty + 1]:
                raise AssertionError(f"{name}: tile {empty} is not padding only")
            x = torch.from_numpy(rng.standard_normal(m)).to(device, xdt)
            label = f"{name} {vdt}/{xdt}"
            kw = dict(halo=P.halo, sym_shift=shift, with_spill=True)
            yr, sr = pruned_sym_matvec_reference(d, x, o, tp, n, m, **kw)
            if (shift > 0) != bool(sr.abs().max() > 0):
                raise AssertionError(f"pruned_sym_spmv {label}: spill {float(sr.abs().max())}")
            yfull = None if shift else pruned_matvec_reference(d, x, o, tp, n, m)
            XT = panels16(m, xdt)
            R = None if shift else pruned_spmm_reference(d, XT, o, tp, n, m, "rhs_major")
            RY, RS = pruned_sym_spmm_reference(d, XT, o, tp, n, m, "rhs_major", **kw)
            for te in (ends(P), None):
                if any(name == c[0] for c in SPMV_EDGES):
                    if not shift:
                        check(label, "pruned_spmv", pruned_spmv(d, x, o, tp, n, m, tile_end=te),
                              yfull, xdt)
                    y, s = pruned_sym_spmv(d, x, o, tp, n, m, tile_end=te, **kw)
                    check(label, "pruned_sym_spmv", y, yr, xdt)
                    spill_check(label, "pruned_sym_spmv", s, sr, float(yr.abs().max()), xdt)
                for layout in PRUNED_LAYOUTS:
                    for k in (3, 16):
                        X = in_layout(XT, k, layout)
                        case = f"{label} {layout} k={k}" + (" every slot" if te is None else "")
                        if not shift:
                            check(case, "pruned_spmm",
                                  pruned_spmm(d, X, o, tp, n, m, layout, tile_end=te),
                                  in_layout(R, k, layout), xdt)
                        Y, S = pruned_sym_spmm(d, X, o, tp, n, m, layout, tile_end=te, **kw)
                        Yr, Sr = in_layout(RY, k, layout), in_layout(RS, k, layout)
                        check(case, "pruned_sym_spmm", Y, Yr, xdt)
                        spill_check(case, "pruned_sym_spmm", S, Sr, float(Yr.abs().max()), xdt)
    torch.cuda.synchronize()
    emit({"phase": "pruned_kernel_checks", "cases": count, "worst_rel_err": worst,
          "tolerance": "1e-12 with f64 vectors, 1e-5 with f32 vectors"})


# the unstructured north star: benchmarks/unstructured_pruned.py --height
# 157696 --width 64 --shift 1e-3 --seed 0, tile 16384, groups 8 / 12,
# coarse_size 4096, Chebyshev smoother (BENCHMARKS.md:697-716)
MESH_HEIGHT, MESH_WIDTH, MESH_SHIFT = 157_696, 64, 1e-3


def unstructured_setup(device, height=MESH_HEIGHT, width=MESH_WIDTH, seed=0, emit_as=None):
    """Generate the shuffled irregular mesh, RCM-reorder it, pack it in full
    (group 8) and symmetric (group 12) f32 storage from the same triples,
    and build the pruned pair multigrid over each (``fine_A`` reused).
    Returns a dict of the objects; with ``emit_as`` prints each step."""
    import numpy as np
    import torch

    from sigma_tpu_torch import (
        PrunedDIAMatrix, SymmetricPrunedDIAMatrix, irregular_mesh_laplacian_coo,
        pruned_pair_amg, reorder_triples_rcm,
    )

    rng = np.random.default_rng(seed)
    out, secs = {"rng": rng}, {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return r

    n, rows, cols, vals = step("generate_s", lambda: irregular_mesh_laplacian_coo(
        height, width, rng=rng, shift=MESH_SHIFT, shuffle=True))
    pr, pc, vals, p = step("rcm_s", lambda: reorder_triples_rcm(n, rows, cols, vals))
    del rows, cols
    vals = vals.astype(np.float32)  # the f32 path: operator and hierarchy
    offs = pc - pr
    nnz = int(pr.size)
    band = {"n": n, "nnz": nnz, "bandwidth": int(np.abs(offs).max()),
            "n_diags": int(np.unique(offs).size)}
    del offs
    P = step("pack_full_s", lambda: PrunedDIAMatrix.from_coo(
        n, n, pr, pc, vals, tile_rows=16384, group=8, assume_unique=True, device=device))
    S = step("pack_sym_s", lambda: SymmetricPrunedDIAMatrix.from_coo(
        n, n, pr, pc, vals, tile_rows=16384, group=12, assume_unique=True, validate=False,
        device=device))
    Mf = step("gmg_full_s", lambda: pruned_pair_amg(
        n, pr, pc, vals, coarse_size=4096, smoother="chebyshev", group=8, fine_A=P))
    Ms = step("gmg_sym_s", lambda: pruned_pair_amg(
        n, pr, pc, vals, coarse_size=4096, smoother="chebyshev", group=12, fine_A=S,
        symmetric=True, validate=False))
    out.update(n=n, nnz=nnz, pr=pr, pc=pc, vals=vals, p=p, P=P, S=S, Mf=Mf, Ms=Ms)
    if emit_as:
        emit({"phase": emit_as, **band, "seconds": secs,
              "tile_rows": P.tile_rows, "levels": len(Mf.levels) + 1,
              "full": {"group": P.group, "stored_slots": P.stored_slots,
                       "packed_gb": P.stored_slots * 4 / 1e9,
                       "local_occupancy": nnz / P.stored_slots},
              "sym": {"group": S.group, "stored_slots": S.stored_slots,
                      "packed_gb": S.stored_slots * 4 / 1e9}})
    return out


def phase_unstructured_timing(device, U, k=8):
    """The pruned kernels and their plain versions at the north star's
    shapes, the SpMMs in both panel layouts, CUDA events (median of 30;
    plain of 5, SpMM plain of 3), beside cuSPARSE (torch.sparse_csr) on the
    same permuted matrix and the same vector or panels; returns the
    kernels' summary rows, the SpMMs' keyed "kernel/layout"."""
    import torch

    from sigma_tpu_torch.ops import (
        PRUNED_LAYOUTS, pruned_matvec_reference, pruned_spmm, pruned_spmm_reference,
        pruned_spmv, pruned_sym_matvec_reference, pruned_sym_spmm, pruned_sym_spmm_reference,
        pruned_sym_spmv,
    )

    stream_gbs = copy_gbs(device)
    n, nnz, P, S = U["n"], U["nnz"], U["P"], U["S"]
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(n, generator=g, device=device)
    XT = torch.rand((k, n), generator=g, device=device)
    panels = {"rhs_major": XT, "cols": XT.T.contiguous()}
    csr = csr_from_coo(*(torch.from_numpy(a).to(device) for a in (U["pr"], U["pc"], U["vals"])), n, n)
    # cuSPARSE on the same operands: x, the (n, k) columns, and the
    # RHS-major panels as the column-major (n, k) block XT.T
    lib = {None: median_ms(lambda: csr @ x), "cols": median_ms(lambda: csr @ panels["cols"]),
           "rhs_major": median_ms(lambda: csr @ XT.T)}
    del csr
    Pb, Sb = P.astype(torch.bfloat16), S.astype(torch.bfloat16)

    sym = dict(halo=S.halo)
    variants = [  # (kernel, label, layout, kernel call, plain call, matrix, k)
        ("pruned_spmv", "full_f32", None,
         partial(pruned_spmv, P.data, x, P.offsets, P.tile_ptr, n, n, tile_end=P.tile_end),
         partial(pruned_matvec_reference, P.data, x, P.offsets, P.tile_ptr, n, n, group=P.group),
         P, 1),
        ("pruned_spmv", "full_bf16_values", None,
         partial(pruned_spmv, Pb.data, x, Pb.offsets, Pb.tile_ptr, n, n, tile_end=Pb.tile_end),
         partial(pruned_matvec_reference, Pb.data, x, Pb.offsets, Pb.tile_ptr, n, n, group=P.group),
         Pb, 1),
        ("pruned_sym_spmv", "sym_f32", None,
         partial(pruned_sym_spmv, S.data, x, S.offsets, S.tile_ptr, n, n, tile_end=S.tile_end,
                 **sym),
         partial(pruned_sym_matvec_reference, S.data, x, S.offsets, S.tile_ptr, n, n,
                 group=S.group, **sym),
         S, 1),
        ("pruned_sym_spmv", "sym_bf16_values", None,
         partial(pruned_sym_spmv, Sb.data, x, Sb.offsets, Sb.tile_ptr, n, n,
                 tile_end=Sb.tile_end, **sym),
         partial(pruned_sym_matvec_reference, Sb.data, x, Sb.offsets, Sb.tile_ptr, n, n,
                 group=S.group, **sym),
         Sb, 1),
    ]
    for layout in PRUNED_LAYOUTS:
        X = panels[layout]
        variants += [
            ("pruned_spmm", f"full_f32_{layout}", layout,
             partial(pruned_spmm, P.data, X, P.offsets, P.tile_ptr, n, n, layout,
                     tile_end=P.tile_end),
             partial(pruned_spmm_reference, P.data, X, P.offsets, P.tile_ptr, n, n, layout,
                     group=P.group),
             P, k),
            ("pruned_sym_spmm", f"sym_f32_{layout}", layout,
             partial(pruned_sym_spmm, S.data, X, S.offsets, S.tile_ptr, n, n, layout,
                     tile_end=S.tile_end, **sym),
             partial(pruned_sym_spmm_reference, S.data, X, S.offsets, S.tile_ptr, n, n, layout,
                     group=S.group, **sym),
             S, k),
        ]
    rows = {}
    for kname, label, layout, kern, plain, A, kk in variants:
        data = A.data
        y, yr = kern(), plain()
        torch.cuda.synchronize()
        err_abs = float((y - yr).abs().max())
        err_rel = rel_err(y, yr)
        del y, yr
        if not err_rel <= 1e-5:
            raise AssertionError(f"{kname} {label} at n={n}: rel err {err_rel:.3e}")
        ms = median_ms(kern)
        plain_ms = median_ms(plain, reps=5 if kk == 1 else 3, warmup=1)
        # the byte floor: the active slots' values once (a slot holding a
        # nonzero; the zero slots that pad each tile to a multiple of
        # `group` are the packing's, not the product's), the x panels read
        # and the y panels written once (the offsets and tile pointers are
        # under 0.2% of it)
        active = int(data.ne(0).any(1).sum())
        panel_bytes = 2 * kk * n * x.element_size()
        slot_bytes = data.shape[1] * data.element_size()
        byts = active * slot_bytes + panel_bytes
        # what the kernel streams: each tile's active slots (tile_end)
        walked = int((A.tile_end - A.tile_ptr[:-1]).sum())
        streamed = walked * slot_bytes + panel_bytes
        # the same kernel walking every slot, padding included
        extra = {"padding_walked_ms": median_ms(partial(kern, tile_end=None)),
                 "padding_walked_streamed_gb": (data.shape[0] * slot_bytes + panel_bytes) / 1e9}
        bound_ms, bound_by = bound(byts, 2 * kk * nnz, x.dtype)
        row = {
            "phase": "unstructured_timing", "variant": label, "kernel": kname,
            "layout": layout, "k": kk, "n": n, "nnz": nnz, "stored_slots": data.numel(),
            "slots": data.shape[0], "active_slots": active, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": lib[layout],
            "library": "torch.sparse_csr @ " + {None: "x", "cols": "X (n, k)",
                                                "rhs_major": "XT.T (n, k) column-major"}[layout]
                       + " (cuSPARSE), full storage",
            "true_gnnz_s": kk * nnz / (ms * 1e-3) / 1e9,
            "library_true_gnnz_s": kk * nnz / (lib[layout] * 1e-3) / 1e9,
            "bytes_floor_gb": byts / 1e9, "achieved_gbs": byts / (ms * 1e-3) / 1e9,
            "share_of_copy": byts / (ms * 1e-3) / 1e9 / stream_gbs,
            "streamed_gb": streamed / 1e9, "streamed_gbs": streamed / (ms * 1e-3) / 1e9,
            "streamed_share_of_copy": streamed / (ms * 1e-3) / 1e9 / stream_gbs,
            "stream_copy_gbs": stream_gbs, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err_abs, "rel_err": err_rel, **extra,
        }
        emit(row)
        rows.setdefault(kname if layout is None else f"{kname}/{layout}", row)
    return rows


def _manufactured(U):
    """(xstar, xstar in the permuted frame, b = A xstar_p) of
    benchmarks/unstructured_pruned.py: xstar_i = sin(0.001 i).  b comes
    from the plain version, so a solve is not held only to the kernel it
    drives."""
    import numpy as np
    import torch

    from sigma_tpu_torch.ops import pruned_matvec_reference

    P = U["P"]
    xstar = np.sin(np.arange(U["n"]) * 0.001).astype(np.float32)
    xp = np.empty_like(xstar)
    xp[U["p"]] = xstar
    xp = torch.from_numpy(xp).to(P.device)
    return xstar, xp, pruned_matvec_reference(P.data, xp, P.offsets, P.tile_ptr, P.n, P.m,
                                              group=P.group)


# recomputed true relative residual that every unstructured CG solve at
# rtol 1e-6, maxiter 300 must reach (f32; the recursive residual stops at
# 1e-6, and plain CG needs about 290 iterations: the JAX package's count)
UNSTRUCTURED_CG_RTOL = 2e-6
# max |x - xstar| after those solves: measured on an H100 1.27e-3 and
# 1.28e-3 for CG, 1.15e-3 and 1.14e-3 for multigrid CG, full and
# symmetric storage (PERF.md, Findings); 3e-3 is 2.3 times the largest,
# and a consistently wrong kernel, which solves another operator, misses
# xstar by O(1)
UNSTRUCTURED_XSTAR_ERR = 3e-3


def phase_unstructured_cg(device, U):
    """CG (rtol 1e-6, maxiter 300) on full and symmetric storage, and
    pruned-pair-multigrid CG (Chebyshev) with full and symmetric levels,
    at the north star, as benchmarks/unstructured_pruned.py runs them."""
    import numpy as np
    import torch

    from sigma_tpu_torch import cg_solve

    xstar, _, b = _manufactured(U)
    iters = {}
    for label, A, M in (("cg_full", U["P"], None), ("cg_sym", U["S"], None),
                        ("gmg_cg_full", U["P"], U["Mf"]), ("gmg_cg_sym", U["S"], U["Ms"])):
        (x, info), warm = _timed(lambda: cg_solve(A, b, tol=0.0, rtol=1e-6, maxiter=300, M=M))
        rel = _true_rel_residual(A, b, x)
        err = float(np.abs(x.cpu().numpy()[U["p"]] - xstar).max())
        iters[label] = info.iterations
        emit({"phase": "unstructured_cg", "run": label, "n": U["n"],
              "levels": None if M is None else len(M.levels) + 1,
              "iterations": info.iterations, "converged": info.converged,
              "relative_residual": rel, "max_err_vs_xstar": err,
              "xstar_tolerance": UNSTRUCTURED_XSTAR_ERR, "wall_s_warm": warm,
              "s_per_iteration": warm / max(info.iterations, 1)})
        if not (rel <= UNSTRUCTURED_CG_RTOL and err <= UNSTRUCTURED_XSTAR_ERR):
            raise AssertionError(
                f"{label}: true rel residual {rel:.3e}, max err vs xstar {err:.3e} after {info}")
        del x
    for tag in ("full", "sym"):
        if not iters[f"gmg_cg_{tag}"] * 3 <= iters[f"cg_{tag}"]:
            raise AssertionError(f"multigrid CG ({tag}) took {iters} iterations")


# block CG stops on the block's Frobenius norm, ||R||_F <= 1e-6 ||B||_F;
# each column's recomputed true residual must be within twice that,
# ||b_j - A x_j|| <= 2e-6 ||B||_F (f32).  Relative to its own ||b_j|| a
# smooth column (a small ||b_j||) may sit above 1e-5.
BLOCK_CG_FRO_RTOL = 2e-6
# LOBPCG + pruned multigrid on the 1M-row mesh at eigen_unstructured.py's
# settings (tol 1e-5, maxiter 60) does not converge in f32 within 60
# iterations on the H100 either: two runs ended with the same Ritz
# residuals ||A v - lambda v|| / |lambda|, at most 0.127 on full storage
# and 0.0747 on symmetric (1.3e-4 absolute at most; the JAX package's TPU
# run stalled at 1.4e-2 absolute).  There is no analytic spectrum for a
# random mesh, and the eight eigenvalues lie within 3.2e-6 of each other,
# so three checks hold the result: the Ritz residuals within 0.2 (1.6
# times the largest measured); lambda_1 equal to the shift (the weighted
# graph Laplacian annihilates the constant vector) to 1e-4; and the full
# and symmetric runs, the same operator from the same X0, agreeing on all
# eight eigenvalues to 4e-4 relative (measured at most 1.33e-4 apart, an
# eighth of the eight's spread).
LOBPCG_RITZ_RTOL = 0.2
LOBPCG_LAMBDA1_RTOL = 1e-4
LOBPCG_STORAGE_RTOL = 4e-4


def phase_unstructured_block(device, U):
    """Block CG with 8 right-hand sides on the full-storage pruned matrix
    with pruned multigrid at the north star (the storage the JAX package
    routes block solvers to)."""
    import torch

    from sigma_tpu_torch import block_cg_solve

    from sigma_tpu_torch.ops import pruned_spmm, pruned_spmm_reference

    A, M, n = U["P"], U["Mf"], U["n"]
    i = torch.arange(n, dtype=torch.float32, device=device)
    # B from the plain version, so the solve is not held only to the kernel
    B = pruned_spmm_reference(
        A.data, torch.stack([torch.sin(i * (0.001 * (j + 1))) for j in range(8)], dim=1),
        A.offsets, A.tile_ptr, n, n, "cols", group=A.group)
    del i
    before = pruned_spmm.launches_by_layout["cols"]
    (X, info), warm = _timed(lambda: block_cg_solve(A, B, tol=0.0, rtol=1e-6, maxiter=300, M=M))
    cols = pruned_spmm.launches_by_layout["cols"] - before
    rels = _col_rel_residuals(A, B, X)
    fro = (torch.linalg.vector_norm(B - A.matmat(X), dim=0)
           / torch.linalg.vector_norm(B)).tolist()
    emit({"phase": "unstructured_block_cg", "storage": "full", "preconditioner": "pruned_gmg",
          "cols_spmm_launches": cols,
          "n": n, "rhs": 8, "iterations": info.iterations, "converged": info.converged,
          "col_relative_residuals": rels, "col_residuals_over_block_norm": fro,
          "tolerance": BLOCK_CG_FRO_RTOL, "wall_s_warm": warm,
          "s_per_iteration": warm / max(info.iterations, 1)})
    if not (info.converged and max(fro) <= BLOCK_CG_FRO_RTOL):
        raise AssertionError(f"unstructured block CG did not converge: {info}, {fro}")
    if cols <= 0:  # block CG keeps (n, k) column panels
        raise AssertionError("unstructured block CG ran no column-panel pruned SpMM")


def phase_unstructured_lobpcg(device, height=16_384, width=64, m=8):
    """LOBPCG + pruned multigrid at benchmarks/eigen_unstructured.py's
    settings (the 1M-row mesh, m=8, tol 1e-5, maxiter 60, X0 from the
    mesh's generator), on full and on symmetric storage.  Returns the
    full-storage eigenvalues and the RCM permutation, which the full-band
    LOBPCG is held to."""
    import numpy as np
    import torch

    from sigma_tpu_torch import lobpcg

    U = unstructured_setup(device, height, width)
    X0 = torch.from_numpy(U["rng"].standard_normal((U["n"], m)).astype(np.float32)).to(device)
    eigs = {}
    for storage, A, M in (("full", U["P"], U["Mf"]), ("sym", U["S"], U["Ms"])):
        res, warm = _timed(lambda: lobpcg(A, X0, M=M, tol=1e-5, maxiter=60))
        V, lam = res.eigenvectors, res.eigenvalues
        ritz = (torch.linalg.vector_norm(A.matmat(V) - V * lam[None, :], dim=0)
                / (torch.linalg.vector_norm(V, dim=0) * lam.abs())).double().cpu().numpy()
        lam = eigs[storage] = np.sort(lam.double().cpu().numpy())
        emit({"phase": "unstructured_lobpcg", "storage": storage, "n": U["n"], "m": m,
              "iterations": res.iterations, "converged": res.converged,
              "eigenvalues": lam.tolist(), "ritz_relative_residuals": ritz.tolist(),
              "lambda1_rel_err_vs_shift": float(abs(lam.min() - MESH_SHIFT) / MESH_SHIFT),
              "tolerance": LOBPCG_RITZ_RTOL, "wall_s_warm": warm,
              "s_per_iteration": warm / max(res.iterations, 1)})
        lam1_err = abs(lam.min() - MESH_SHIFT) / MESH_SHIFT
        if not (np.isfinite(lam).all() and ritz.max() <= LOBPCG_RITZ_RTOL
                and lam1_err <= LOBPCG_LAMBDA1_RTOL):
            raise AssertionError(
                f"unstructured LOBPCG ({storage}): Ritz residuals {ritz}, lambda_1 err {lam1_err:.3e}")
    apart = np.abs(eigs["full"] - eigs["sym"]) / eigs["sym"]
    emit({"phase": "unstructured_lobpcg", "full_vs_sym_rel": apart.tolist(),
          "tolerance": LOBPCG_STORAGE_RTOL})
    if not apart.max() <= LOBPCG_STORAGE_RTOL:
        raise AssertionError(f"unstructured LOBPCG: full and symmetric eigenvalues {apart} apart")
    return eigs["full"], U["p"]


# -- the full-band path ------------------------------------------------------
# benchmarks/unstructured.py's configuration: --height 16384 --width 64
# --seed 0, labels shuffled (1,048,576 rows)
BAND_HEIGHT, BAND_WIDTH = 16_384, 64
# the JAX package's recorded iteration counts there (TPU v5e, f32, rtol
# 1e-6): CG at shift 1.0 (BENCHMARKS.md:302), and CG, Chebyshev(4)-CG and
# banded pair-multigrid CG at shift 1e-3 (BENCHMARKS.md:370-376)
JAX_BAND_COUNTS = {"cg_shift1": 23, "cg": 290, "chebyshev_cg": 104, "gmg_cg": 39}
# max |x - xstar| after the shift-1.0 solves (condition number ~20):
# measured on the CPU with this package at 65,536 rows, 2.2e-5 for CG (f32,
# rtol 1e-6) and 7.7e-7 after three bf16-operator refinement sweeps; 5e-4
# leaves a 20-fold margin and still fails a wrong operator, which misses
# xstar by O(1).  The shift-1e-3 solves use the unstructured path's limits.
BAND_XSTAR_ERR_SHIFT1 = 5e-4
# the refined solve's recomputed relative residual (measured 9.0e-8 on the
# CPU: three sweeps of inner rtol 1e-3 at condition number ~20)
BAND_REFINED_RTOL = 1e-5
# the banded multigrid's coarsest size (unstructured.py's): 8 levels at 1M rows
BAND_COARSE = 4096


def full_band_setup(device, shift, height=BAND_HEIGHT, width=BAND_WIDTH, seed=0):
    """benchmarks/unstructured.py's band through the public entries:
    irregular_mesh_laplacian (CSR, f32) -> shuffled labels ->
    CSRMatrix.from_coo -> to_banded_dia (RCM on the host, the band
    assembled on the card); and its manufactured right-hand side, b = A
    xstar by the CSR gather (plain PyTorch) permuted to the band's frame.
    Returns a dict; the generator is left where phase 15's mesh leaves it,
    so X0 drawn from it is phase 15's."""
    import numpy as np
    import torch

    from sigma_tpu_torch import (
        CSRMatrix, band_occupancy, bandwidth, irregular_mesh_laplacian, to_banded_dia,
    )

    rng = np.random.default_rng(seed)
    secs = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return r

    A = step("generate_s", lambda: irregular_mesh_laplacian(
        height, width, rng=rng, shift=shift, dtype=torch.float32, device=device))
    n = A.shape[0]

    def shuffle():
        r, c, v = A.entries()
        sh = rng.permutation(n)
        return CSRMatrix.from_coo(n, n, sh[r], sh[c], v, dtype=torch.float32, device=device)

    A = step("shuffle_s", shuffle)
    before = bandwidth(A)
    D, p = step("to_banded_dia_s", lambda: to_banded_dia(A))
    row = {"phase": "full_band_setup", "shift": shift, "n": n, "nnz": A.nnz,
           "bandwidth_before": before, "bandwidth": bandwidth(D), "n_diags": D.graph.n_diags,
           "occupancy": band_occupancy(D), "dia_data_gb": D.data.numel() * 4 / 1e9,
           "device": str(D.device), "seconds": secs}
    emit(row)
    if not D.grouped_profitable(24):
        raise AssertionError(f"the band is too narrow for the grouped SpMM at k = 24: {row}")
    xstar = np.sin(np.arange(n) * 0.001).astype(np.float32)
    b = A.matvec(torch.from_numpy(xstar).to(device))
    bp = torch.empty_like(b)
    bp[torch.from_numpy(p).to(device)] = b
    return {"A": A, "D": D, "p": p, "rng": rng, "n": n, "xstar": xstar, "bp": bp}


def phase_full_band_solves(device, B1, B3):
    """The solves of benchmarks/unstructured.py on the 1M-row band, each
    checked against the manufactured solution: at shift 1.0 plain CG and
    refined_solve_fixed with a bf16-valued band (3 sweeps, inner rtol
    1e-3); at shift 1e-3 plain CG, Chebyshev(4)-CG (flexible, lmax the
    value rows' largest absolute sum, lmin lmax/30) and CG with the banded
    pair multigrid (structured_pair_amg(D, (n,), coarse_size=4096)), and
    plain and multigrid CG on the symmetric band.  Returns the multigrid
    hierarchy (the staged path's band levels)."""
    import numpy as np
    import torch

    from sigma_tpu_torch import (
        SymmetricDIAMatrix, cg_solve, chebyshev, refined_solve_fixed, structured_pair_amg,
    )

    iters = {}

    def record(B, label, A, run, xerr_tol, rtol, jax=None, **extra):
        out, warm = _timed(run)
        x, info = out if isinstance(out, tuple) else (out, None)
        rel = _true_rel_residual(A, B["bp"], x)
        err = float(np.abs(x.cpu().numpy()[B["p"]] - B["xstar"]).max())
        k = None if info is None else info.iterations
        iters[label] = k
        emit({"phase": "full_band_solve", "run": label, "n": B["n"], "iterations": k,
              "jax_package_iterations": jax, "converged": None if info is None else info.converged,
              "relative_residual": rel, "residual_tolerance": rtol, "max_err_vs_xstar": err,
              "xstar_tolerance": xerr_tol, "wall_s_warm": warm,
              "s_per_iteration": None if not k else warm / k, **extra})
        if (info is not None and not info.converged) or not (rel <= rtol and err <= xerr_tol):
            raise AssertionError(f"full band {label}: {info}, true rel {rel:.3e}, err {err:.3e}")

    D1 = B1["D"]
    record(B1, "cg_shift1", D1, lambda: cg_solve(D1, B1["bp"], tol=0.0, rtol=1e-6, maxiter=200),
           BAND_XSTAR_ERR_SHIFT1, UNSTRUCTURED_CG_RTOL, JAX_BAND_COUNTS["cg_shift1"])
    D1lo = D1.astype(torch.bfloat16)
    record(B1, "refined_bf16_shift1", D1, lambda: refined_solve_fixed(
        D1, B1["bp"], A_lo=D1lo, sweeps=3, inner_rtol=1e-3, inner_maxiter=200),
        BAND_XSTAR_ERR_SHIFT1, BAND_REFINED_RTOL, sweeps=3)
    del D1lo
    D = B3["D"]
    n = B3["n"]
    bp = B3["bp"]
    lim = dict(xerr_tol=UNSTRUCTURED_XSTAR_ERR, rtol=UNSTRUCTURED_CG_RTOL)
    record(B3, "cg", D, lambda: cg_solve(D, bp, tol=0.0, rtol=1e-6, maxiter=400),
           jax=JAX_BAND_COUNTS["cg"], **lim)
    lmax = float(D.data.abs().sum(0).max())
    Mc = chebyshev(D, degree=4, lmax=lmax, lmin=lmax / 30)
    record(B3, "chebyshev_cg", D, lambda: cg_solve(D, bp, tol=0.0, rtol=1e-6, maxiter=400,
                                                  M=Mc, flexible=True),
           jax=JAX_BAND_COUNTS["chebyshev_cg"], lmax=lmax, **lim)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    M = structured_pair_amg(D, (n,), coarse_size=BAND_COARSE)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    levels = len(M.levels)
    record(B3, "gmg_cg", D, lambda: cg_solve(D, bp, tol=0.0, rtol=1e-6, maxiter=400, M=M),
           jax=JAX_BAND_COUNTS["gmg_cg"], levels=levels, setup_s=setup,
           level_diagonals=[lv.A.graph.n_diags for lv in M.levels], **lim)
    S = SymmetricDIAMatrix.from_dia(D)
    record(B3, "cg_sym", S, lambda: cg_solve(S, bp, tol=0.0, rtol=1e-6, maxiter=400),
           upper_diagonals=len(S.offsets), **lim)
    record(B3, "gmg_cg_sym", S, lambda: cg_solve(S, bp, tol=0.0, rtol=1e-6, maxiter=400, M=M),
           **lim)
    if levels != int(np.ceil(np.log2(n / BAND_COARSE))):
        raise AssertionError(f"banded multigrid has {levels} levels for {n} rows")
    for label in ("gmg_cg", "gmg_cg_sym"):
        if not iters[label] * 3 <= iters["cg"]:
            raise AssertionError(f"full band {label} took {iters} iterations")
    if not iters["chebyshev_cg"] < iters["cg"]:
        raise AssertionError(f"full band Chebyshev-CG took {iters} iterations")
    return M


def phase_full_band_lobpcg(device, B3, ref_eigs, ref_p, m=8):
    """LOBPCG for 8 eigenpairs on the 1M-row band at phase 15's settings
    (tol 1e-5, maxiter 60, X0 from the mesh's generator), preconditioned by
    the banded multigrid with phase 15's Chebyshev smoother: its
    Rayleigh-Ritz products are k = 24 columns, the grouped kernel's route.
    The operator and X0 are phase 15's (the RCM order is checked equal), so
    the eigenvalues are held to its full-storage run as phase 15 holds its
    two storages to each other."""
    import numpy as np
    import torch

    from sigma_tpu_torch import lobpcg, structured_pair_amg
    from sigma_tpu_torch.ops import dia_spmm_grouped

    D, n = B3["D"], B3["n"]
    if not np.array_equal(B3["p"], ref_p):
        raise AssertionError("the band's RCM order differs from phase 15's")
    M = structured_pair_amg(D, (n,), coarse_size=BAND_COARSE, smoother="chebyshev")
    X0 = torch.from_numpy(B3["rng"].standard_normal((n, m)).astype(np.float32)).to(device)
    before = dia_spmm_grouped.launches
    res, warm = _timed(lambda: lobpcg(D, X0, M=M, tol=1e-5, maxiter=60))
    grouped = dia_spmm_grouped.launches - before
    V, lam = res.eigenvectors, res.eigenvalues
    ritz = (torch.linalg.vector_norm(D.matmat(V) - V * lam[None, :], dim=0)
            / (torch.linalg.vector_norm(V, dim=0) * lam.abs())).double().cpu().numpy()
    lam = np.sort(lam.double().cpu().numpy())
    lam1_err = abs(lam.min() - MESH_SHIFT) / MESH_SHIFT
    apart = np.abs(lam - ref_eigs) / ref_eigs
    emit({"phase": "full_band_lobpcg", "n": n, "m": m, "iterations": res.iterations,
          "converged": res.converged, "grouped_spmm_launches": grouped,
          "eigenvalues": lam.tolist(), "ritz_relative_residuals": ritz.tolist(),
          "lambda1_rel_err_vs_shift": float(lam1_err), "vs_phase15_full_rel": apart.tolist(),
          "tolerances": {"ritz": LOBPCG_RITZ_RTOL, "lambda1": LOBPCG_LAMBDA1_RTOL,
                         "vs_phase15": LOBPCG_STORAGE_RTOL},
          "wall_s_warm": warm, "s_per_iteration": warm / max(res.iterations, 1)})
    if not (np.isfinite(lam).all() and ritz.max() <= LOBPCG_RITZ_RTOL
            and lam1_err <= LOBPCG_LAMBDA1_RTOL and apart.max() <= LOBPCG_STORAGE_RTOL):
        raise AssertionError(f"full-band LOBPCG: Ritz {ritz}, lambda_1 err {lam1_err:.3e}, "
                             f"vs phase 15 {apart}")
    if grouped <= 0:
        raise AssertionError("full-band LOBPCG ran no grouped SpMM")


def phase_full_band_grouped(device, B3, k=24):
    """#9 at the shape full-band LOBPCG launches: the 1M-row band at k = 24
    in both layouts (D.matmat of (n, k) columns, D.matmat_rhs_major of
    (k, n) panels), each checked once against its plain version and timed
    beside its bound and cuSPARSE (torch.sparse_csr of the band's nonzeros
    @ X, @ XT.T).  Run after the counted full-band path."""
    import torch

    from sigma_tpu_torch.ops import dia_spmm_grouped_reference

    D, n = B3["D"], B3["n"]
    if not D.grouped_profitable(k):
        raise AssertionError(f"the 1M band does not take the grouped SpMM at k = {k}")
    g = torch.Generator(device=device).manual_seed(1)
    XT = torch.rand((k, n), generator=g, device=device)
    Xc = XT.T.contiguous()
    csr = csr_from_dia(D)
    o = D.offsets_dev
    floor = D.data.numel() * 4 + 2 * k * n * 4
    rows = {}
    for layout, kern, plain, lib in (
        ("rhs_major", lambda: D.matmat_rhs_major(XT),
         lambda: dia_spmm_grouped_reference(D.data, XT, o, n, n, "rhs_major"), lambda: csr @ XT.T),
        ("cols", lambda: D.matmat(Xc),
         lambda: dia_spmm_grouped_reference(D.data, Xc, o, n, n, "cols"), lambda: csr @ Xc),
    ):
        y, yr = kern(), plain()
        torch.cuda.synchronize()
        err_abs, err_rel = float((y - yr).abs().max()), rel_err(y, yr)
        del y, yr
        if not err_rel <= 1e-5:
            raise AssertionError(f"dia_spmm_grouped 1M band k={k} {layout}: rel err {err_rel:.3e}")
        ms = median_ms(kern)
        bound_ms, bound_by = bound(floor, 2 * k * D.nnz, torch.float32)
        row = {"phase": "full_band_grouped", "kernel": "dia_spmm_grouped", "layout": layout,
               "k": k, "n": n, "slots": D.nnz, "kernel_ms": ms,
               "plain_ms": median_ms(plain, reps=3, warmup=1), "library_ms": median_ms(lib),
               "library": "torch.sparse_csr of the band's nonzeros (cuSPARSE)",
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes_floor_gb": floor / 1e9,
               "max_abs_err": err_abs, "rel_err": err_rel}
        emit(row)
        rows[f"band_1m_f32_k{k}_{layout}"] = row
    return rows


def full_band_10m_setup(device, T):
    """The 10.1M-row mesh's full band from phase 7's RCM triples (no
    second RCM), assembled on the card by DIAMatrix.from_coo with int64
    slot positions: 245 diagonals, 9.89 GB of f32 values; and its upper
    diagonals in symmetric storage."""
    import torch

    from sigma_tpu_torch import DIAMatrix, SymmetricDIAMatrix, bandwidth

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    D = DIAMatrix.from_coo(T["n"], T["n"], T["pr"], T["pc"], T["vals"], dtype=torch.float32,
                           device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    S = SymmetricDIAMatrix.from_dia(D)
    torch.cuda.synchronize()
    emit({"phase": "full_band_10m_setup", "n": T["n"], "nnz": int(T["pr"].size),
          "n_diags": D.graph.n_diags, "bandwidth": bandwidth(D), "slots": D.nnz,
          "dia_data_gb": D.data.numel() * 4 / 1e9, "sym_upper_diagonals": len(S.offsets),
          "assemble_s": t1 - t0, "symmetric_s": time.perf_counter() - t1,
          "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9})
    if D.graph.n_diags != 2 * bandwidth(D) + 1:
        raise AssertionError(f"{D.graph.n_diags} diagonals for a band of reach {bandwidth(D)}")
    return D, S


def band_10m_variants(device, D, S, k=32):
    """The 10.1M band's timed products: (kernel, label, layout, k, kernel
    call through the public entry, plain call, bytes floor).  The floor is
    the value array as stored (every pass's read, for the two-pass route),
    the x panels read and the y panels written once."""
    import torch

    from sigma_tpu_torch.ops import (
        dia_spmm, dia_spmm_grouped_reference, dia_spmm_reference, dia_spmv_reference,
        dia_spmv_staged, dia_sym_spmv_reference,
    )

    n = D.shape[0]
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(n, generator=g, device=device)
    X8 = torch.rand((8, n), generator=g, device=device)
    XT = torch.rand((k, n), generator=g, device=device)
    Xc = XT.T.contiguous()
    X8c = X8.T.contiguous()
    X16 = torch.rand((16, n), generator=g, device=device)
    X16c = X16.T.contiguous()
    vals = D.data.numel() * 4
    vec = n * 4
    o = D.offsets_dev
    return {"x": x, "X8": X8, "XT": XT, "Xc": Xc, "X8c": X8c, "X16": X16, "X16c": X16c}, [
        ("dia_spmv", "band_f32", None, 1, lambda: D.matvec(x),
         lambda: dia_spmv_reference(D.data, x, o, n, n), vals + 2 * vec),
        ("dia_sym_spmv", "band_sym_f32", None, 1, lambda: S.matvec(x),
         lambda: dia_sym_spmv_reference(S.data, x, S.offsets_dev, n),
         S.data.numel() * 4 + 2 * vec),
        ("dia_spmv_window", "band_f32_window", None, 1,
         lambda: dia_spmv_staged(D.data, x, D.offsets, n, n, allow_dma_path=True),
         lambda: dia_spmv_reference(D.data, x, o, n, n), vals + 2 * vec),
        ("dia_spmm", "band_f32_k8_rhs_major", "rhs_major", 8, lambda: D.matmat_rhs_major(X8),
         lambda: dia_spmm_reference(D.data, X8, o, n, n, "rhs_major"), vals + 16 * vec),
        ("dia_spmm", "band_f32_k8_cols", "cols", 8, lambda: D.matmat(X8c),
         lambda: dia_spmm_reference(D.data, X8c, o, n, n, "cols"), vals + 16 * vec),
        ("dia_spmm", "band_f32_k16_rhs_major", "rhs_major", 16, lambda: D.matmat_rhs_major(X16),
         lambda: dia_spmm_reference(D.data, X16, o, n, n, "rhs_major"), vals + 32 * vec),
        ("dia_spmm", "band_f32_k16_cols", "cols", 16, lambda: D.matmat(X16c),
         lambda: dia_spmm_reference(D.data, X16c, o, n, n, "cols"), vals + 32 * vec),
        ("dia_spmm_grouped", f"band_f32_k{k}_rhs_major", "rhs_major", k,
         lambda: D.matmat_rhs_major(XT),
         lambda: dia_spmm_grouped_reference(D.data, XT, o, n, n, "rhs_major"),
         vals + 2 * k * vec),
        ("dia_spmm_grouped", f"band_f32_k{k}_cols", "cols", k, lambda: D.matmat(Xc),
         lambda: dia_spmm_grouped_reference(D.data, Xc, o, n, n, "cols"), vals + 2 * k * vec),
        ("dia_spmm", f"band_f32_k{k}_two_passes", "rhs_major", k,
         lambda: torch.cat([dia_spmm(D.data, XT[j:j + 16], o, n, n, "rhs_major")
                            for j in range(0, k, 16)]),
         lambda: dia_spmm_grouped_reference(D.data, XT, o, n, n, "rhs_major"),
         -(-k // 16) * vals + 2 * k * vec),
    ]


def full_band_10m_checks(variants):
    """Each 10.1M-band product against its plain version once (the grouped
    kernel at 1e-5 in f32; a plain k = 32 product is ~0.9 TB of traffic);
    returns {label: (max abs err, rel err, plain ms)}.  Run outside the
    counted path: these launches compare, they do not drive."""
    import torch

    out = {}
    for kname, label, layout, k, kern, plain, _ in variants:
        y, yr = kern(), plain()
        torch.cuda.synchronize()
        err_abs = float((y - yr).abs().max())
        err_rel = rel_err(y, yr)
        del y, yr
        if not err_rel <= 1e-5:
            raise AssertionError(f"{kname} {label} on the 10.1M band: rel err {err_rel:.3e}")
        out[label] = (err_abs, err_rel, median_ms(plain, reps=3, warmup=1))
    emit({"phase": "full_band_10m_checks", "rel_err": {k: v[1] for k, v in out.items()},
          "tolerance": "1e-5 (f32 vectors)"})
    return out


def phase_full_band_10m(device, D, ops, variants, checks, T):
    """The 10.1M band's products timed with CUDA events (median of 30)
    beside their bound, the copy rate and cuSPARSE (torch.sparse_csr of the
    same RCM-ordered matrix) on matching operands: x, the (n, k) columns,
    and RHS-major panels as the column-major block XT.T.  Returns the rows
    keyed "kernel/layout" or by label."""
    import torch

    stream_gbs = copy_gbs(device)
    n = D.shape[0]
    nnz = int(T["pr"].size)
    csr = csr_from_coo(*(torch.from_numpy(a).to(device) for a in (T["pr"], T["pc"], T["vals"])),
                       n, n)
    x, X8, XT, Xc = ops["x"], ops["X8"], ops["XT"], ops["Xc"]
    X8c, X16, X16c = ops["X8c"], ops["X16"], ops["X16c"]
    k = XT.shape[0]
    lib = {(1, None): median_ms(lambda: csr @ x),
           (8, "rhs_major"): median_ms(lambda: csr @ X8.T),
           (8, "cols"): median_ms(lambda: csr @ X8c),
           (16, "rhs_major"): median_ms(lambda: csr @ X16.T),
           (16, "cols"): median_ms(lambda: csr @ X16c),
           (k, "rhs_major"): median_ms(lambda: csr @ XT.T),
           (k, "cols"): median_ms(lambda: csr @ Xc)}
    del csr
    rows = {}
    for kname, label, layout, kk, kern, _, floor in variants:
        ms = median_ms(kern)
        # the SpMVs' device time too (50 back-to-back launches)
        dev_ms = device_ms(kern) if kk == 1 else None
        bound_ms, bound_by = bound(floor, 2 * kk * D.nnz, torch.float32)
        err_abs, err_rel, plain_ms = checks[label]
        row = {"phase": "full_band_10m", "variant": label, "kernel": kname, "layout": layout,
               "k": kk, "n": n, "nnz": nnz, "slots": D.nnz, "kernel_ms": ms,
               "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": lib[(kk, layout)],
               "library": "torch.sparse_csr @ " + {None: "x", "cols": "X (n, k)",
                                                   "rhs_major": "XT.T (n, k) column-major"}[layout]
                          + " (cuSPARSE), the same matrix",
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes_floor_gb": floor / 1e9,
               "achieved_gbs": floor / (ms * 1e-3) / 1e9, "stream_copy_gbs": stream_gbs,
               "true_k_gnnz_s": kk * nnz / (ms * 1e-3) / 1e9,
               "max_abs_err": err_abs, "rel_err": err_rel}
        emit(row)
        rows[label] = row
        if kname == "dia_spmm_grouped":
            rows[f"{kname}/{layout}"] = row
        elif kname == "dia_spmv_window":
            rows[kname] = row
    return rows


def staged_operands(device, nx, Mst, Mband):
    """(label, matrix) of the staged path: every multigrid level, of the
    nx=216 stencil hierarchy (bf16 levels) and of the band's, whose x fits
    one block's shared memory (the resident kernel's operands), and the
    nx=216 stencil in f32 (the windowed kernel's)."""
    import torch

    from sigma_tpu_torch import DIAMatrix, laplacian_3d_dia
    from sigma_tpu_torch.ops import staged_route

    levels = []
    for tag, M in ((f"stencil_nx{nx}", Mst), ("band_1m", Mband)):
        for li, lvl in enumerate(M.levels):
            A = lvl.A
            if isinstance(A, DIAMatrix) and staged_route(A.shape[1], 4) == "resident":
                levels.append((f"{tag}_level{li}", A))
    return levels, (f"stencil_nx{nx}_f32", laplacian_3d_dia(nx, torch.float32, device))


def staged_checks(device, levels, stencil):
    """dia_spmv_staged (resident on the levels, windowed on the stencil)
    against the plain version, outside the counted path; and the resident
    kernel in every dtype pair at a level's shape (32,768 rows, a narrow
    band) and below one row tile, NaN in every slot outside the matrix.
    Returns {label: (max abs err, plain ms)} of the levels and the
    stencil."""
    import torch

    from sigma_tpu_torch.ops import KERNEL_DTYPES, dia_spmv_reference, dia_spmv_staged

    out = {}
    g = torch.Generator(device=device).manual_seed(1)
    worst = {}
    for vdt, xdt in sorted(KERNEL_DTYPES, key=str):
        tol = 1e-12 if xdt == torch.float64 else 1e-5
        for label, n, offs in (("level_like_32768", 32_768, list(range(-12, 13))),
                               ("below_one_tile", 100, [-9, -4, -1, 0, 1, 4, 9])):
            data, off_t = nan_outside_dia(g, n, n, offs, -(-n // 128) * 128, vdt, device)
            x = torch.randn(n, generator=g, device=device, dtype=torch.float64).to(xdt)
            y = dia_spmv_staged(data, x, offs, n, n)
            torch.cuda.synchronize()
            e = rel_err(y, dia_spmv_reference(data, x, off_t, n, n))
            if not e <= tol:
                raise AssertionError(f"dia_spmv_resident {label} {vdt}/{xdt}: rel err {e:.3e}")
            worst[label] = max(worst.get(label, 0.0), e)
    emit({"phase": "staged_checks_resident", "worst_rel_err": worst, "dtype_pairs": 5,
          "tolerance": "1e-12 with f64 vectors, 1e-5 with f32 vectors"})
    window_checks(device, g)
    for (label, A), dma in [(lv, False) for lv in levels] + [(stencil, True)]:
        n = A.shape[0]
        x = torch.rand(n, generator=g, device=device)
        y = dia_spmv_staged(A.data, x, A.offsets, n, n, allow_dma_path=dma)
        plain = partial(dia_spmv_reference, A.data, x, A.offsets_dev, n, n)
        yr = plain()
        torch.cuda.synchronize()
        e = rel_err(y, yr)
        if not e <= 1e-5:
            raise AssertionError(f"dia_spmv_staged {label}: rel err {e:.3e}")
        out[label] = (float((y - yr).abs().max()), median_ms(plain, reps=10, warmup=2))
    emit({"phase": "staged_checks", "max_abs_err": {k: v[0] for k, v in out.items()},
          "tolerance": "1e-5 relative (f32 vectors)"})
    return out


# dia_spmv_window's check cases: (label, n, offsets, tile_rows); each also
# with x off a 16-byte boundary (one value a copy)
WINDOW_CASES = (
    ("reach_past_a_tile", 20_001, [-3000, -300, -1, 0, 1, 300, 3000], (32, 128, 256, 1024)),
    ("misaligned_piece", 9_999, [-301, -3, 0, 2, 5, 299], (32, 128, 1024)),
    ("stencil_far_offsets", 100_000, [-46_656, -216, -1, 0, 1, 216, 46_656], (256, 1024)),
    ("band", 65_536, list(range(-122, 123)), (32, 256)),
    ("below_one_tile", 100, [-9, -4, -1, 0, 1, 4, 9], (32, 256, 1024)),
)


def window_checks(device, g):
    """dia_spmv_window in every dtype pair at tile_rows 32 to 1024: a
    piece whose first column lies off a 16-byte boundary, the stencil's
    far offsets, a band, fewer rows than one tile, x aligned and off a
    16-byte boundary, NaN in every slot outside the matrix.  Each launched
    twice (bitwise equal), against its plain version, and bit for bit
    against dia_spmv (#1) on the same operands: the same row-tile body in
    the same order."""
    import torch

    from sigma_tpu_torch.ops import KERNEL_DTYPES, dia_spmv, dia_spmv_reference, dia_spmv_window

    worst, count = {}, 0
    for vdt, xdt in sorted(KERNEL_DTYPES, key=str):
        tol = 1e-12 if xdt == torch.float64 else 1e-5
        for label, n, offs, tiles in WINDOW_CASES:
            data, off_t = nan_outside_dia(g, n, n, offs, -(-n // 128) * 128, vdt, device)
            for x_form in ("aligned", "x_off_16"):
                x = torch.randn(n + 1, generator=g, device=device, dtype=torch.float64).to(xdt)
                x = x[1:] if x_form == "x_off_16" else x[:n]
                y1 = dia_spmv(data, x, off_t, n, n)
                ref = dia_spmv_reference(data, x, off_t, n, n)
                for tile_rows in tiles:
                    y = dia_spmv_window(data, x, offs, n, n, tile_rows=tile_rows)
                    y2 = dia_spmv_window(data, x, offs, n, n, tile_rows=tile_rows)
                    torch.cuda.synchronize()
                    e = rel_err(y, ref)
                    if not (e <= tol and torch.equal(y, y2) and torch.equal(y, y1)):
                        raise AssertionError(
                            f"dia_spmv_window {label} {x_form} tile_rows={tile_rows} "
                            f"{vdt}/{xdt}: rel err {e:.3e}, repeat bitwise equal "
                            f"{torch.equal(y, y2)}, bitwise dia_spmv's {torch.equal(y, y1)}")
                    key = f"{label}/{x_form}"
                    worst[key] = max(worst.get(key, 0.0), e)
                    count += 1
    emit({"phase": "staged_checks_window", "cases": count, "worst_rel_err": worst,
          "dtype_pairs": 5, "bitwise": "two launches equal, and equal to dia_spmv's y",
          "tolerance": "1e-12 with f64 vectors, 1e-5 with f32 vectors"})


def phase_staged(device, levels, stencil, checks, band_window_row):
    """The staged-x SpMV entry at its own shapes: the resident kernel (#5)
    on each level of `levels`, and the windowed kernel (#6) on the nx=216
    stencil (and on the 10.1M band, phase 19's row), each beside dia_spmv
    (#1) on the same operand and cuSPARSE on the same matrix (bf16 levels:
    their values widened to f32, exactly), CUDA events, median of 30.
    Returns the resident kernel's rows keyed by label."""
    import torch

    from sigma_tpu_torch.ops import dia_spmv_staged

    g = torch.Generator(device=device).manual_seed(2)
    rows = {}
    for (label, A), dma in [(lv, False) for lv in levels] + [(stencil, True)]:
        n = A.shape[0]
        x = torch.rand(n, generator=g, device=device)
        staged = partial(dia_spmv_staged, A.data, x, A.offsets, n, n, allow_dma_path=dma)
        ms, dev_ms = median_ms(staged), device_ms(staged)
        blocked_ms, blocked_dev_ms = median_ms(lambda: A.matvec(x)), device_ms(lambda: A.matvec(x))
        csr = csr_from_dia(A.astype(torch.float32)) if A.dtype == torch.bfloat16 else csr_from_dia(A)
        library_ms, library_dev_ms = median_ms(lambda: csr @ x), device_ms(lambda: csr @ x)
        del csr
        floor = A.data.numel() * A.data.element_size() + 2 * n * 4
        bound_ms, bound_by = bound(floor, 2 * A.nnz, torch.float32)
        kname = "dia_spmv_window" if dma else "dia_spmv_resident"
        row = {"phase": "staged", "variant": label, "kernel": kname, "n": n,
               "n_diags": A.graph.n_diags, "value_dtype": str(A.dtype).replace("torch.", ""),
               "kernel_ms": ms, "device_ms": dev_ms,
               "dia_spmv_ms": blocked_ms, "dia_spmv_device_ms": blocked_dev_ms,
               "plain_ms": checks[label][1],
               "library_ms": library_ms, "library_device_ms": library_dev_ms,
               "library": "torch.sparse_csr @ x (cuSPARSE), f32 values",
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes_floor_mb": floor / 1e6,
               "bound_share": {"kernel": bound_ms / dev_ms, "dia_spmv": bound_ms / blocked_dev_ms,
                               "library": bound_ms / library_dev_ms},
               "max_abs_err": checks[label][0]}
        emit(row)
        if not dma:
            rows[label] = row
    emit({"phase": "staged", "variant": "band_10m_window", "kernel": "dia_spmv_window",
          "n": band_window_row["n"], "kernel_ms": band_window_row["kernel_ms"],
          "note": "timed in phase 19 beside dia_spmv on the same band"})
    return rows


# -- the block / multi-DOF path: grouped BSR (#14), BlockMatrix ----------------


def phase_bsr_kernel(device):
    """bsr_grouped_spmv against its plain version on the card: every dtype
    pair, block shapes (8, 128), (12, 64), (8, 16), (4, 4), (3, 3) and the
    odd (4, 33), groups 1, 4 and 8, k in {1, 2, 3, 4, 5, 8, 9, 16}, shapes
    the blocks do not divide, empty block rows and rows of several groups:
    every form of the kernel (bsr_grouped_form) in every dtype pair, with
    group rows that are and are not 16-byte multiples; then gdata and x
    off a 16-byte boundary.  The f64 products also against the dense
    product.  The matrices are assembled on the card by BSRMatrix.from_coo
    and regrouped by GroupedBSR.from_bsr."""
    import numpy as np
    import torch

    from sigma_tpu_torch import BSRMatrix, GroupedBSR
    from sigma_tpu_torch.ops import (
        BSR_KERNEL_DTYPES, bsr_grouped_spmv, bsr_grouped_spmv_reference,
    )

    rng = np.random.default_rng(14)

    def dense_case(n, m, bh):
        d = np.where(rng.random((n, m)) < 0.04, rng.standard_normal((n, m)), 0.0)
        d[: 4 * bh] = np.where(rng.random((4 * bh, m)) < 0.3,
                               rng.standard_normal((4 * bh, m)), 0.0)  # rows of several groups
        d[n // 2 : n // 2 + 3 * bh] = 0.0  # empty block rows
        return d

    cases = [((500, 460), (8, 16)), ((260, 260), (4, 4)), ((301, 305), (3, 3)),
             ((520, 1000), (8, 128)), ((400, 700), (12, 64)), ((300, 330), (4, 33))]

    def tol(xdt):
        # f64 and f32 accumulate in x's dtype; bf16 vectors accumulate in
        # f32 and round once, so kernel and plain version may land one bf16
        # step (2^-7 relative) apart
        return {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}[xdt]

    def off_boundary(t):  # a contiguous copy one value into a larger store
        store = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
        store[1:] = t.reshape(-1)
        return store[1:].view(t.shape)

    worst, count, by_form = {}, 0, {}

    def check(label, G, X, dense=None):
        nonlocal count
        Xp = G._pad_x(X).contiguous()  # X itself where it needs no padding
        args = (G.gdata, G.gcols, G.grow, Xp, G.nb_rows, G.nb_cols, G.block_shape, G.group)
        Y = bsr_grouped_spmv(*args, gptr=G.gptr)
        torch.cuda.synchronize()
        e = rel_err(Y, bsr_grouped_spmv_reference(*args))
        if not e <= tol(X.dtype):
            raise AssertionError(f"bsr_grouped_spmv {label} ({G.form}): rel err {e:.3e}")
        if dense is not None:
            ed = rel_err(Y[: dense.shape[0]].cpu(), torch.from_numpy(dense @ X.cpu().numpy()))
            if not ed <= 1e-12:
                raise AssertionError(f"bsr_grouped_spmv {label} vs dense: {ed:.3e}")
        key = str(X.dtype).replace("torch.", "")
        worst[key] = max(worst.get(key, 0.0), e)
        by_form[G.form] = by_form.get(G.form, 0) + 1
        count += 1

    for (n, m), blk in cases:
        dense = dense_case(n, m, blk[0])
        r, c = np.nonzero(dense)
        for vdt, xdt in sorted(BSR_KERNEL_DTYPES, key=str):
            A = BSRMatrix.from_coo(n, m, r, c, dense[r, c], dtype=vdt, block_shape=blk,
                                   device=device)
            for group in (1, 4, 8):
                G = A.grouped(group)
                for k in (1, 2, 3, 4, 5, 8, 9, 16):
                    X = torch.from_numpy(rng.standard_normal((m, k))).to(device, xdt)
                    check(f"{blk} group {group} k {k} {vdt}/{xdt}", G, X,
                          dense if vdt == xdt == torch.float64 else None)
    # gdata and x off a 16-byte boundary
    n, m = 260, 1024
    for blk, group in (((8, 128), 8), ((3, 3), 8), ((4, 4), 4)):
        dense = dense_case(n, m, blk[0])
        r, c = np.nonzero(dense)
        for vdt, xdt in sorted(BSR_KERNEL_DTYPES, key=str):
            G = BSRMatrix.from_coo(n, m, r, c, dense[r, c], dtype=vdt, block_shape=blk,
                                   device=device).grouped(group)
            Go = GroupedBSR(off_boundary(G.gdata), G.gcols, G.grow, G.shape, G.block_shape,
                            G.group)
            if Go.form != "narrow_unaligned":
                raise AssertionError(f"gdata off a 16-byte boundary took the {Go.form} form")
            for k in (1, 4, 8):
                X = off_boundary(torch.from_numpy(rng.standard_normal((G.nb_cols * blk[1], k)))
                                 .to(device, xdt))
                check(f"{blk} group {group} k {k} {vdt}/{xdt} x off boundary", G, X)
                check(f"{blk} group {group} k {k} {vdt}/{xdt} gdata, x off boundary", Go, X)
    emit({"phase": "bsr_kernel_checks", "cases": count, "cases_by_form": by_form,
          "worst_rel_err_by_vector": worst,
          "tolerance": "1e-12 with f64 vectors, 1e-5 with f32, 2^-7 with bf16 vectors "
                       "(f32 accumulation, one rounding on the store)"})


def _library_operands(G):
    """The matrix of a GroupedBSR as torch.sparse_csr and torch.sparse_bsr
    (a block that a row names twice summed, the all-zero padding blocks
    dropped), for the library yardsticks; used nowhere in the port."""
    import torch

    n, m = G.nb_rows * G.block_shape[0], G.nb_cols * G.block_shape[1]
    bh, bw = G.block_shape
    n_groups, B = G.gcols.shape
    dev = G.gdata.device
    bkeys, inv = torch.unique(G.grow.long()[:, None] * G.nb_cols + G.gcols.long(),
                              return_inverse=True)
    blocks = G.gdata.view(n_groups, bh, B, bw).permute(0, 2, 1, 3).reshape(n_groups * B, bh, bw)
    values = torch.zeros((bkeys.numel(), bh, bw), dtype=G.gdata.dtype, device=dev)
    values.index_add_(0, inv.reshape(-1), blocks)
    del blocks, inv
    keep = values.abs().amax(dim=(1, 2)) > 0
    bkeys, values = bkeys[keep], values[keep]
    brow, bcol = bkeys // G.nb_cols, bkeys % G.nb_cols
    crow = torch.zeros(G.nb_rows + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(brow, minlength=G.nb_rows), 0)
    bsr = torch.sparse_bsr_tensor(crow.int(), bcol.int(), values, size=(n, m))
    rows = (brow[:, None, None] * bh + torch.arange(bh, device=dev)[None, :, None]) \
        .expand(-1, bh, bw).reshape(-1)
    cols = (bcol[:, None, None] * bw + torch.arange(bw, device=dev)[None, None, :]) \
        .expand(-1, bh, bw).reshape(-1)
    csr = csr_from_coo(rows, cols, values.reshape(-1), n, m)
    return csr, bsr


def block_setup(device, nx=150):
    """Build the block path's operators and print the set-up seconds per
    step: configuration A (the block-banded operator, 8,192 and 65,536 block
    rows) and configuration B (the elasticity operator at nx in its three
    layouts, the node-major ones assembled on the card)."""
    import torch

    from sigma_tpu_torch import (
        BSRMatrix, block_banded_grouped_bsr, elasticity_field_blocked, elasticity_jacobi,
        elasticity_node_major_dia, elasticity_permutation,
    )
    from sigma_tpu_torch.problems import elasticity_node_major_coo

    steps = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = round(time.perf_counter() - t0, 3)
        return out

    S = {"nx": nx, "n": nx ** 3}
    S["A_small"] = step("A_8192_generate", lambda: block_banded_grouped_bsr(8192, device=device))
    S["A_large"] = step("A_65536_generate", lambda: block_banded_grouped_bsr(65536, device=device))
    S["field"] = step("B_field_blocked", lambda: elasticity_field_blocked(nx, torch.float32, device))
    S["node"] = step("B_node_dia", lambda: elasticity_node_major_dia(nx, torch.float32, device))
    S["node_sym"] = step("B_node_sym_dia", lambda: elasticity_node_major_dia(
        nx, torch.float32, device, symmetric=True))
    N, r, c, v = step("B_node_triples", lambda: elasticity_node_major_coo(nx, torch.float32, device))
    torch.cuda.reset_peak_memory_stats()
    S["bsr"] = step("B_bsr_from_coo", lambda: BSRMatrix.from_coo(
        N, N, r, c, v, dtype=torch.float32, sum_duplicates=False, device=device,
        block_shape=(3, 3)))
    peak = torch.cuda.max_memory_allocated()
    del r, c, v
    S["grouped"] = step("B_grouped", lambda: S["bsr"].grouped(8))
    S["perm"] = torch.from_numpy(elasticity_permutation(S["n"])).to(device)
    S["M_field"] = elasticity_jacobi(nx, torch.float32, device)
    S["M_node"] = elasticity_jacobi(nx, torch.float32, device, node_major=True)
    G, B = S["grouped"], S["bsr"]
    emit({"phase": "block_setup", "seconds": steps,
          "A": {name: {"shape": S[name].shape, "slots": S[name].stored_slots,
                       "value_mb": S[name].stored_slots * 4 / 1e6}
                for name in ("A_small", "A_large")},
          "B": {"nx": nx, "dof": N, "nnz": B.nnz, "blocks": B.graph.nnzb,
                "groups": G.gdata.shape[0], "slots": G.stored_slots,
                "value_mb": G.stored_slots * 4 / 1e6, "column_indices": G.gcols.numel(),
                "node_diagonals": S["node"].graph.n_diags,
                "node_sym_diagonals": len(S["node_sym"].offsets),
                "field_blocked_value_mb": 9 * S["field"].blocks[0][0].data.numel() * 4 / 1e6,
                "assembly_peak_gb": peak / 1e9}})
    if (N, B.nnz, G.stored_slots) != (3 * nx ** 3, 9 * (7 * nx ** 3 - 6 * nx * nx),
                                      8 * 9 * nx ** 3):
        raise AssertionError(f"elasticity operator: {N} dof, {B.nnz} nnz, {G.stored_slots} slots")
    return S


def _bsr_variants(S, device):
    """(label, GroupedBSR, k, X) of the grouped-BSR kernel's timed shapes."""
    import torch

    g = torch.Generator(device=device).manual_seed(14)
    out = []
    for label, G, ks in (("A_8192", S["A_small"], (1, 4, 8)), ("A_65536", S["A_large"], (1, 4, 8)),
                         ("B3_elasticity", S["grouped"], (1, 4))):
        for k in ks:
            X = torch.randn((G.shape[1], k), generator=g, device=device)
            out.append((f"{label}_k{k}", G, k, X))
    return out


def block_checks(device, S, variants):
    """Outside the counted path: the kernel at each timed shape against its
    plain version (limit 1e-5 relative, f32), the plain version's time, the
    bare wrapper's single-launch and device time (device_ms), and the
    library yardsticks on the same operands: torch.sparse_csr @ X and
    torch.sparse_bsr @ X of the same matrix.  Returns {label: dict}."""
    import torch

    from sigma_tpu_torch.ops import bsr_grouped_spmv, bsr_grouped_spmv_reference

    out = {}
    lib_of, csr, bsr = None, None, None  # the library copies of one operator at a time
    for label, G, k, X in variants:
        args = (G.gdata, G.gcols, G.grow, X, G.nb_rows, G.nb_cols, G.block_shape, G.group)
        Y = bsr_grouped_spmv(*args, gptr=G.gptr)
        ref = bsr_grouped_spmv_reference(*args)
        torch.cuda.synchronize()
        e = rel_err(Y, ref)
        if not e <= 1e-5:
            raise AssertionError(f"bsr_grouped_spmv {label}: rel err {e:.3e}")
        out[label] = {"max_abs_err": float((Y - ref).abs().max()), "rel_err": e,
                      "plain_ms": median_ms(partial(bsr_grouped_spmv_reference, *args),
                                            reps=5, warmup=1)}
        del ref
        bare = partial(bsr_grouped_spmv, *args, gptr=G.gptr)
        out[label].update(form=G.form, wrapper_ms=median_ms(bare),
                          wrapper_device_ms=device_ms(bare))
        if G is not lib_of:
            csr = bsr = None
            torch.cuda.empty_cache()
            csr, bsr = _library_operands(G)
            lib_of = G
        Xv = X[:, 0].contiguous() if k == 1 else X
        yl = (csr @ Xv).reshape(-1)
        el = rel_err(yl, Y.reshape(-1))
        if not el <= 1e-5:
            raise AssertionError(f"torch.sparse_csr disagrees at {label}: {el:.3e}")
        out[label]["library_ms"] = median_ms(lambda: csr @ Xv, reps=10, warmup=2)
        out[label]["library_device_ms"] = device_ms(lambda: csr @ Xv, reps=3)
        try:  # a yardstick, not a check: this torch may not take the block shape
            out[label]["library_bsr_rel_err"] = rel_err((bsr @ Xv).reshape(-1), yl)
            out[label]["library_bsr_ms"] = median_ms(lambda: bsr @ Xv, reps=10, warmup=2)
        except (RuntimeError, NotImplementedError) as exc:
            out[label]["library_bsr_ms"] = None
            out[label]["library_bsr_error"] = f"{type(exc).__name__}: {str(exc)[:300]}"
    del csr, bsr
    torch.cuda.empty_cache()
    emit({"phase": "block_checks", "checks": out,
          "tolerance": "1e-5 relative (f32 vectors), kernel vs plain and library vs kernel"})
    return out


def phase_block(device, S, variants, checks):
    """The counted block path.  Timings of the grouped-BSR kernel through
    G.matvec / G.matmat at configurations A and B.3, single launches
    (CUDA events, median of 30) and device time (device_ms), each with its
    share of the bound, beside the bare wrapper's, the plain version's and
    the library calls' times; the three layouts of the elasticity
    operator: parity of A x, SpMV and SpMM (k = 4) times, and the Jacobi-CG
    solve of benchmarks/elasticity3d.py against its manufactured solution.
    Returns the kernel's rows keyed by label."""
    import numpy as np
    import torch

    from sigma_tpu_torch import cg_solve
    from sigma_tpu_torch.ops import bsr_grouped_spmv, dia_spmm, dia_spmv, dia_sym_spmm, dia_sym_spmv

    rows = {}
    for label, G, k, X in variants:
        Xv = X[:, 0].contiguous() if k == 1 else X
        product = (lambda: G.matvec(Xv)) if k == 1 else (lambda: G.matmat(Xv))
        ms, dev_ms = median_ms(product), device_ms(product)
        slots = G.stored_slots
        n_out = G.nb_rows * G.block_shape[0]
        floor = (G.gdata.numel() * 4 + G.gcols.numel() * 4 + G.gptr.numel() * 8
                 + X.numel() * 4 + n_out * k * 4)
        gathered = G.gcols.numel() * G.block_shape[1] * k * 4
        bound_ms, bound_by = bound(floor, 2 * slots * k, torch.float32)
        c = checks[label]
        row = {"phase": "block", "kernel": "bsr_grouped_spmv", "variant": label, "k": k,
               "shape": G.shape, "block": G.block_shape, "group": G.group, "slots": slots,
               "form": c["form"], "kernel_ms": ms, "device_ms": dev_ms,
               "wrapper_ms": c["wrapper_ms"], "wrapper_device_ms": c["wrapper_device_ms"],
               "plain_ms": c["plain_ms"], "library_ms": c["library_ms"],
               "library_device_ms": c["library_device_ms"],
               "library": "torch.sparse_csr @ X (cuSPARSE), the same matrix",
               "library_bsr_ms": c["library_bsr_ms"],
               "library_bsr": c.get("library_bsr_error", "torch.sparse_bsr @ X, the same matrix"),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "share_of_bound": bound_ms / ms, "device_share_of_bound": bound_ms / dev_ms,
               "wrapper_device_share_of_bound": bound_ms / c["wrapper_device_ms"],
               "bytes_floor_mb": floor / 1e6,
               "gathered_x_mb": gathered / 1e6, "achieved_gbs": floor / (ms * 1e-3) / 1e9,
               "slot_gnnz_s": slots * k / (ms * 1e-3) / 1e9,
               "max_abs_err": c["max_abs_err"], "rel_err": c["rel_err"]}
        emit(row)
        rows[label] = row

    # configuration B: the three layouts of the elasticity operator
    n, N, perm = S["n"], 3 * S["n"], S["perm"]
    layouts = [("field_blocked", S["field"], S["M_field"], False),
               ("node_dia", S["node"], S["M_node"], True),
               ("node_sym_dia", S["node_sym"], S["M_node"], True),
               ("node_bsr_grouped", S["grouped"], S["M_node"], True)]

    def to_layout(v, node):  # field-blocked vector or panels -> the layout's dof order
        if not node:
            return v
        out = torch.empty_like(v)
        out[perm] = v
        return out

    g = torch.Generator(device=device).manual_seed(5)
    xv = torch.randn(N, generator=g, device=device)
    Xv = torch.randn((N, 4), generator=g, device=device)
    y_ref = S["field"].matvec(xv)
    Y_ref = S["field"].matmat(Xv)
    xstar = torch.sin(torch.arange(n, dtype=torch.float32, device=device) * 0.001).repeat(3)
    b = S["field"].matvec(xstar)
    iters = {}
    for name, A, M, node in layouts:
        x_l, X_l, b_l = to_layout(xv, node), to_layout(Xv, node), to_layout(b, node)
        before = {f.__name__: f.launches
                  for f in (bsr_grouped_spmv, dia_spmv, dia_sym_spmv, dia_spmm, dia_sym_spmm)}
        y, Y = A.matvec(x_l), A.matmat(X_l)
        per_product = {k: f.launches - before[k]
                       for k, f in (("bsr_grouped_spmv", bsr_grouped_spmv), ("dia_spmv", dia_spmv),
                                    ("dia_sym_spmv", dia_sym_spmv), ("dia_spmm", dia_spmm),
                                    ("dia_sym_spmm", dia_sym_spmm)) if f.launches - before[k]}
        parity = rel_err(y[perm] if node else y, y_ref)
        parity_mm = rel_err(Y[perm] if node else Y, Y_ref)
        if not (parity <= 1e-5 and parity_mm <= 1e-5):
            raise AssertionError(f"{name}: A x differs from the field-blocked layout by "
                                 f"{parity:.3e} (k = 4: {parity_mm:.3e})")
        spmv_ms = median_ms(lambda: A.matvec(x_l))
        spmm_ms = median_ms(lambda: A.matmat(X_l))
        (x, info), warm = _timed(lambda: cg_solve(A, b_l, tol=0.0, rtol=1e-6, maxiter=150, M=M))
        rel = _true_rel_residual(A, b_l, x)
        err = float(((x[perm] if node else x) - xstar).abs().max())
        iters[name] = info.iterations
        emit({"phase": "block", "layout": name, "dof": N, "nnz": S["bsr"].nnz,
              "launches_matvec_plus_matmat": per_product,
              "rel_err_vs_field_blocked": parity, "rel_err_vs_field_blocked_k4": parity_mm,
              "spmv_ms": spmv_ms, "spmm_k4_ms": spmm_ms,
              "spmv_gnnz_s": S["bsr"].nnz / (spmv_ms * 1e-3) / 1e9,
              "cg_iterations": info.iterations, "cg_converged": info.converged,
              "relative_residual": rel, "max_err_vs_manufactured": err,
              "cg_wall_s_warm": warm, "cg_s_per_iteration": warm / max(info.iterations, 1),
              "jax_tpu_iterations": 26})
        if not (info.converged and rel < 1e-5 and err < 1e-3):
            raise AssertionError(f"{name}: CG {info}, true rel {rel:.3e}, error {err:.3e}")
    if max(iters.values()) - min(iters.values()) > 1:
        raise AssertionError(f"the layouts' CG iteration counts differ by more than 1: {iters}")
    return rows


# -- the nonsymmetric paths and the refinement ladder ------------------------
# the JAX package's recorded iteration counts (TPU, f32, rtol 1e-6): the
# upwinded stencil at nx=216, beta 10 (BENCHMARKS.md:644-660), and the
# skewed 1M-row mesh (BENCHMARKS.md:839-845, :947-970; FGMRES: outer steps)
JAX_ADV3D_COUNTS = {"bicgstab_jacobi": 77, "bicgstab_gmg": 12, "gmres32": 119}
JAX_NONSYM_MESH_COUNTS = {"bicgstab": 156, "bicgstab_pruned_gmg": 225, "fgmres_bicgstab4": 40}
NONSYM_RTOL = 1e-6
# the one exception to the limit of twice the target: BiCG-stab + pruned
# multigrid on the skewed mesh stops on its recursive residual at 1e-6
# after ~220 f32 iterations, and its true residual lies above it by f32
# rounding alone: 2.11e-6 in the JAX package's own f32 solve of this system
# (CPU, 230 iterations), 2.31e-6 in this port's on an H100 and 2.82e-6 on
# the CPU (215), 2.05e-6 with an f64-accumulated matvec (``PYTHONPATH=.
# python tests/test_torch_nonsym.py 16384`` gives the CPU numbers).  It is
# held to 3x; a wrong kernel, which solves another operator, misses by O(1).
NONSYM_GMG_TRUE_LIMIT = 3.0
# the refinement path's relative-residual target in f64
REFINE_RTOL = 1e-10


def _check_solve(label, info, rel, target, limit=2.0):
    """Raise unless the solve converged and its recomputed true relative
    residual is within ``limit`` (twice) times its target."""
    if not (info.converged and rel <= limit * target):
        raise AssertionError(f"{label}: {info}, true relative residual {rel:.3e} "
                             f"(target {target:.1e})")


def phase_nonsym_stencil(device, nx, beta=10.0):
    """benchmarks/adv3d.py's configuration: the upwinded advection-diffusion
    stencil at nx^3 (f32, beta 10, rtol 1e-6, maxiter 2000, full-storage
    DIA) against the manufactured solution from default_rng(0):
    BiCG-stab + jacobi(), BiCG-stab + structured_amg(pairs_per_level=3),
    GMRES(32); then 100 CGLS steps, whose rmatvec runs #1 on the transposed
    layout (CGLS squares the condition number: only the drop in ||A^T r||
    is held)."""
    import numpy as np
    import torch

    from sigma_tpu_torch import (
        advection_diffusion_dia, bicgstab_solve, cgls_solve, gmres_solve, jacobi,
        structured_amg,
    )
    from sigma_tpu_torch.ops import dia_spmv_reference

    A = advection_diffusion_dia(nx, beta, torch.float32, device)
    n = A.shape[0]
    xstar = torch.from_numpy(
        np.random.default_rng(0).standard_normal(n).astype(np.float32)).to(device)
    # b from the plain version, so a solve is not held only to the kernel
    b = dia_spmv_reference(A.data, xstar, A.offsets_dev, n, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Mg = structured_amg((nx, nx, nx), pairs_per_level=3).setup(A)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    kw = dict(tol=0.0, rtol=NONSYM_RTOL, maxiter=2000)
    for label, run, extra in (
        ("bicgstab_jacobi", lambda: bicgstab_solve(A, b, M=jacobi().setup(A), **kw), {}),
        ("bicgstab_gmg", lambda: bicgstab_solve(A, b, M=Mg, **kw),
         {"setup_s": setup, "levels": len(Mg.levels) + 1}),
        ("gmres32", lambda: gmres_solve(A, b, restart=32, **kw), {"restart": 32}),
    ):
        (x, info), warm = _timed(run)
        rel = _true_rel_residual(A, b, x)
        emit({"phase": "nonsym_stencil", "run": label, "n": n, "beta": beta, **extra,
              "iterations": info.iterations, "tpu_iterations": JAX_ADV3D_COUNTS[label],
              "converged": info.converged, "relative_residual": rel,
              "max_err_vs_xstar": float((x - xstar).abs().max()), "wall_s_warm": warm,
              "s_per_iteration": warm / max(info.iterations, 1)})
        _check_solve(label, info, rel, NONSYM_RTOL)
        del x
    atb = float(torch.linalg.vector_norm(A.rmatvec(b)))
    (x, info), warm = _timed(lambda: cgls_solve(A, b, tol=0.0, rtol=NONSYM_RTOL, maxiter=100))
    drop = float(info.residual_norm) / atb
    emit({"phase": "nonsym_stencil", "run": "cgls", "n": n, "iterations": info.iterations,
          "converged": info.converged, "normal_residual_drop": drop,
          "relative_residual": _true_rel_residual(A, b, x),
          "max_err_vs_xstar": float((x - xstar).abs().max()), "wall_s_warm": warm,
          "s_per_iteration": warm / max(info.iterations, 1)})
    if not drop < 1.0:
        raise AssertionError(f"CGLS did not lower ||A^T r||: {drop:.3e} of its start")


def phase_nonsym_unstructured(device, height=16_384, width=64, seed=0, beta=0.3,
                              shift=1e-3):
    """benchmarks/unstructured_nonsym.py's defaults: the skew-perturbed,
    shuffled 1,048,576-row mesh, RCM, full pruned storage (f32), xstar_i =
    sin(0.001 i); the skew statistic and auto_pruned_preconditioner's
    route, then (rtol 1e-6, maxiter 500) plain BiCG-stab, BiCG-stab +
    pruned_pair_amg (Jacobi smoother, coarse 4096), and FGMRES(32) with a
    4-step inner BiCG-stab as a lambda and through attach_solver, which
    must take the lambda's count."""
    import numpy as np
    import torch

    from sigma_tpu_torch import (
        PrunedDIAMatrix, attach_solver, auto_pruned_preconditioner, bicgstab, bicgstab_solve,
        fgmres_solve, pruned_pair_amg, reorder_triples_rcm, skew_dominance, skewed_mesh_coo,
    )
    from sigma_tpu_torch.ops import pruned_matvec_reference

    secs = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return r

    n, rows, cols, vals = step("generate_s", lambda: skewed_mesh_coo(
        height, width, seed, beta, shift, dtype=np.float32))
    pr, pc, vals, p = step("rcm_s", lambda: reorder_triples_rcm(n, rows, cols, vals))
    del rows, cols
    vals = vals.astype(np.float32)
    P = step("pack_s", lambda: PrunedDIAMatrix.from_coo(
        n, n, pr, pc, vals, assume_unique=True, device=device))
    s_dom = step("skew_s", lambda: skew_dominance(pr, pc, vals))
    amg = dict(coarse_size=4096, smoother="jacobi", fine_A=P)
    _, route = step("route_s", lambda: auto_pruned_preconditioner(n, pr, pc, vals, **amg))
    Mg = step("gmg_s", lambda: pruned_pair_amg(n, pr, pc, vals, **amg))
    emit({"phase": "nonsym_unstructured_setup", "n": n, "nnz": int(pr.size), "beta": beta,
          "skew_dominance": s_dom, "route": route["route"], "levels": len(Mg.levels) + 1,
          "stored_slots": P.stored_slots, "seconds": secs})
    del pr, pc, vals
    xstar = np.sin(np.arange(n) * 0.001).astype(np.float32)
    xp = np.empty_like(xstar)
    xp[p] = xstar
    # b from the plain version, so a solve is not held only to the kernel
    b = pruned_matvec_reference(P.data, torch.from_numpy(xp).to(device), P.offsets,
                                P.tile_ptr, P.n, P.m, group=P.group)

    def inner(v):
        return bicgstab_solve(P, v, tol=0.0, rtol=0.0, maxiter=4)[0]

    attached = attach_solver(P, bicgstab(tolerance=0.0, maxiter=4))
    kw = dict(tol=0.0, rtol=NONSYM_RTOL, maxiter=500)
    iters = {}
    for label, tpu, run in (
        ("bicgstab", "bicgstab", lambda: bicgstab_solve(P, b, **kw)),
        ("bicgstab_pruned_gmg", "bicgstab_pruned_gmg", lambda: bicgstab_solve(P, b, M=Mg, **kw)),
        ("fgmres_lambda", "fgmres_bicgstab4", lambda: fgmres_solve(P, b, restart=32, M=inner,
                                                                     **kw)),
        ("fgmres_attached", "fgmres_bicgstab4",
         lambda: fgmres_solve(P, b, restart=32, M=attached, **kw)),
    ):
        (x, info), warm = _timed(run)
        rel = _true_rel_residual(P, b, x)
        iters[label] = info.iterations
        limit = NONSYM_GMG_TRUE_LIMIT if label == "bicgstab_pruned_gmg" else 2.0
        emit({"phase": "nonsym_unstructured", "run": label, "n": n,
              "iterations": info.iterations, "tpu_iterations": JAX_NONSYM_MESH_COUNTS[tpu],
              "converged": info.converged, "relative_residual": rel,
              "residual_limit": limit * NONSYM_RTOL,
              "max_err_vs_xstar": float(np.abs(x.cpu().numpy()[p] - xstar).max()),
              "wall_s_warm": warm, "s_per_iteration": warm / max(info.iterations, 1)})
        _check_solve(label, info, rel, NONSYM_RTOL, limit)
        del x
    if iters["fgmres_attached"] != iters["fgmres_lambda"]:
        raise AssertionError(f"attach_solver's FGMRES took another count: {iters}")


def phase_refinement(device, nx):
    """Does plain f64 CG beat the refinement ladder on a card with native
    f64?  The Dirichlet Poisson stencil of phase 10 at nx^3, symmetric
    storage, relative-residual target 1e-10 in f64, xstar from
    default_rng(0): (a) f64 CG + Chebyshev GMG in f64; (b) refined_solve
    with an f32 inner GMG-CG (f32 operator and levels); (c) as (b) with the
    inner operator's values in bf16 (exact for this stencil); (d) MINRES
    in f64 with (a)'s M."""
    import numpy as np
    import torch

    from sigma_tpu_torch import (
        SymmetricDIAMatrix, cg_solve, laplacian_3d_dia, minres_solve, refined_solve,
        structured_pair_amg,
    )
    from sigma_tpu_torch.ops import dia_sym_spmv_reference

    S = SymmetricDIAMatrix.from_dia(laplacian_3d_dia(nx, torch.float64, device, diag=6.0))
    n = S.shape[0]

    def cast(dtype):
        return SymmetricDIAMatrix(data=S.data.to(dtype), offsets=S.offsets, n=S.n)

    S32, Sbf = cast(torch.float32), cast(torch.bfloat16)

    def timed_setup(op):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M = structured_pair_amg(op, (nx, nx, nx), pairs_per_level=3, smoother="chebyshev",
                                n_smooth=4)
        torch.cuda.synchronize()
        return M, time.perf_counter() - t0

    (M64, setup64), (M32, setup32) = timed_setup(S), timed_setup(S32)
    xstar = torch.from_numpy(np.random.default_rng(0).standard_normal(n)).to(device)
    b = dia_sym_spmv_reference(S.data, xstar, S.offsets_dev, n)
    inner = []

    def counted_cg(A, r, **kw):
        x, info = cg_solve(A, r, **kw)
        inner.append(info.iterations)
        return x, info

    runs = (
        ("a_cg_f64", lambda: cg_solve(S, b, tol=0.0, rtol=REFINE_RTOL, maxiter=3000, M=M64)),
        ("b_refined_f32", lambda: refined_solve(S, b, tol=0.0, rtol=REFINE_RTOL, A_lo=S32,
                                                M_lo=M32, inner_solver=counted_cg)),
        ("c_refined_bf16_values", lambda: refined_solve(S, b, tol=0.0, rtol=REFINE_RTOL,
                                                        A_lo=Sbf, M_lo=M32,
                                                        inner_solver=counted_cg)),
        ("d_minres_f64", lambda: minres_solve(S, b, tol=0.0, rtol=REFINE_RTOL, maxiter=3000,
                                              M=M64)),
    )
    iters, walls = {}, {}
    for label, run in runs:
        inner.clear()
        (x, info), warm = _timed(run)
        refined = label.startswith(("b_", "c_"))
        # _timed ran the solve twice: the inner counts of the second run
        inner_total = sum(inner[len(inner) // 2:]) if refined else None
        rel = _true_rel_residual(S, b, x)
        iters[label], walls[label] = info.iterations, warm
        emit({"phase": "refinement", "run": label, "n": n,
              "outer_sweeps": info.iterations if refined else None,
              "inner_iterations": inner_total,
              "iterations": info.iterations, "converged": info.converged,
              "relative_residual": rel, "max_err_vs_xstar": float((x - xstar).abs().max()),
              "setup_s": setup32 if refined else setup64, "wall_s_warm": warm,
              "s_per_iteration": warm / max(inner_total or info.iterations, 1)})
        _check_solve(label, info, rel, REFINE_RTOL)
        del x
    if abs(iters["d_minres_f64"] - iters["a_cg_f64"]) > 3:
        raise AssertionError(f"MINRES and CG with the same M differ by more than 3: {iters}")
    emit({"phase": "refinement", "fastest": min(walls, key=walls.get), "wall_s_warm": walls})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=216, help="grid size (nx^3 rows)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    # fails early without the package
    from sigma_tpu_torch.ops import (
        bsr_grouped_spmv, dia_spmm, dia_spmm_grouped, dia_spmv, dia_spmv_resident,
        dia_spmv_window, dia_sym_spmm, dia_sym_spmv, pruned_spmm, pruned_spmv, pruned_sym_spmm,
        pruned_sym_spmv,
    )

    smi = phase_device()                                    # phase 0
    phase_build()                                           # phase 1
    phase_kernels(device)                                   # phase 2
    phase_spmm_kernels(device)                              # phase 3
    phase_grouped_kernels(device)                           # phase 3b
    phase_pruned_kernels(device)                            # phase 4
    phase_bsr_kernel(device)                                # phase 4b
    rows = phase_north_star_spmv(device, args.nx)           # phase 5
    rows.update(phase_north_star_spmm(device, args.nx))     # phase 6
    U = unstructured_setup(device, emit_as="unstructured_setup")  # phase 7
    rows.update(phase_unstructured_timing(device, U))       # phase 8

    kernels = {"dia_spmv": dia_spmv, "dia_sym_spmv": dia_sym_spmv,
               "dia_spmm": dia_spmm, "dia_sym_spmm": dia_sym_spmm,
               "pruned_spmv": pruned_spmv, "pruned_sym_spmv": pruned_sym_spmv,
               "pruned_spmm": pruned_spmm, "pruned_sym_spmm": pruned_sym_spmm,
               "dia_spmm_grouped": dia_spmm_grouped, "dia_spmv_resident": dia_spmv_resident,
               "dia_spmv_window": dia_spmv_window, "bsr_grouped_spmv": bsr_grouped_spmv}

    def zero_counts():
        for fn in kernels.values():
            fn.launches = 0
            if hasattr(fn, "launches_by_layout"):
                fn.launches_by_layout = dict.fromkeys(fn.launches_by_layout, 0)

    def read_counts(path, must_run):
        launches = {k: fn.launches for k, fn in kernels.items()}
        by_layout = {k: dict(fn.launches_by_layout) for k, fn in kernels.items()
                     if hasattr(fn, "launches_by_layout")}
        emit({"phase": "kernel_use", "path": path, "launches": launches,
              "by_layout": by_layout})
        for k in must_run:
            if launches[k] <= 0:
                raise AssertionError(f"{k} was not launched on the {path} path")
        return launches, by_layout

    paths = []
    # the stencil single-RHS path: counts zeroed just before, read just after
    zero_counts()
    phase_cg(device, args.nx)                               # phase 9
    Mst = phase_gmg(device, args.nx)                        # phase 10
    paths.append(read_counts("single_rhs", ("dia_spmv", "dia_sym_spmv")))
    # the stencil multi-RHS path
    zero_counts()
    phase_block_cg(device, args.nx)                         # phase 11
    phase_lobpcg(device, args.nx)                           # phase 12
    # (the GMG levels here are bf16 full storage: dia_spmv, not dia_sym_spmv)
    paths.append(read_counts("multi_rhs", ("dia_spmv", "dia_spmm", "dia_sym_spmm")))
    if dia_spmm.launches_by_layout["cols"] + dia_spmm.launches_by_layout["rhs_major"] <= 0:
        raise AssertionError("dia_spmm ran no column or RHS-major product on the multi-RHS path")
    # the unstructured single-RHS path
    zero_counts()
    phase_unstructured_cg(device, U)                        # phase 13
    paths.append(read_counts("unstructured_single_rhs", ("pruned_spmv", "pruned_sym_spmv")))
    # the unstructured multi-RHS path
    zero_counts()
    phase_unstructured_block(device, U)                     # phase 14
    T = {k: U[k] for k in ("n", "pr", "pc", "vals")}  # the 10.1M triples, for phase 19
    del U
    eigs15, p15 = phase_unstructured_lobpcg(device)         # phase 15
    paths.append(read_counts("unstructured_multi_rhs",
                             ("pruned_spmv", "pruned_spmm", "pruned_sym_spmv", "pruned_sym_spmm")))
    # the full-band path at 1M rows
    B1 = full_band_setup(device, shift=1.0)                 # phase 16
    B3 = full_band_setup(device, shift=MESH_SHIFT)
    zero_counts()
    Mband = phase_full_band_solves(device, B1, B3)          # phase 17
    del B1
    phase_full_band_lobpcg(device, B3, eigs15, p15)         # phase 18
    paths.append(read_counts("full_band",
                             ("dia_spmv", "dia_sym_spmv", "dia_spmm", "dia_spmm_grouped")))
    rows.update(phase_full_band_grouped(device, B3))        # phase 18b
    del B3
    # the full band of the 10.1M-row mesh: kernel timings (compared with
    # their plain versions first, outside the counted path)
    D10, S10 = full_band_10m_setup(device, T)               # phase 19
    ops, variants = band_10m_variants(device, D10, S10)
    checks = full_band_10m_checks(variants)
    zero_counts()
    rows.update(phase_full_band_10m(device, D10, ops, variants, checks, T))
    paths.append(read_counts("full_band_10m", ("dia_spmv", "dia_sym_spmv", "dia_spmv_window",
                                               "dia_spmm", "dia_spmm_grouped")))
    if dia_spmm_grouped.launches_by_layout["rhs_major"] <= 0:
        raise AssertionError("matmat_rhs_major at k = 32 did not launch the grouped SpMM")
    del D10, S10, ops, variants, T
    # the staged-x SpMV entry on the multigrid levels and the stencil
    levels, stencil = staged_operands(device, args.nx, Mst, Mband)
    checks = staged_checks(device, levels, stencil)
    zero_counts()
    resident = phase_staged(device, levels, stencil, checks, rows["dia_spmv_window"])  # phase 20
    paths.append(read_counts("staged", ("dia_spmv_resident", "dia_spmv_window", "dia_spmv")))
    # the resident kernel's row: its largest operand
    rows["dia_spmv_resident"] = max(resident.values(), key=lambda r: r["n"])
    del levels, stencil, Mst, Mband
    # the block / multi-DOF path: grouped BSR and BlockMatrix
    S = block_setup(device)                                 # phase 21
    variants = _bsr_variants(S, device)
    checks = block_checks(device, S, variants)
    zero_counts()
    block_rows = phase_block(device, S, variants, checks)   # phase 22
    paths.append(read_counts("block", ("bsr_grouped_spmv", "dia_spmv", "dia_spmm",
                                       "dia_sym_spmv")))
    # the grouped-BSR kernel's row: the shape its path launches most, the
    # elasticity operator's matvec
    rows["bsr_grouped_spmv"] = block_rows["B3_elasticity_k1"]
    del S, variants
    # the nonsymmetric paths and the refinement ladder
    zero_counts()
    phase_nonsym_stencil(device, args.nx)                   # phase 23
    paths.append(read_counts("nonsym_stencil", ("dia_spmv",)))
    zero_counts()
    phase_nonsym_unstructured(device)                       # phase 24
    paths.append(read_counts("nonsym_unstructured", ("pruned_spmv",)))
    zero_counts()
    phase_refinement(device, args.nx)                       # phase 25
    paths.append(read_counts("refinement", ("dia_sym_spmv", "dia_spmv")))
    # each SpMM's summary row is its timing in the panel layout its paths
    # launched most (dia_sym_spmm's at k = 4, the width its paths take)
    summary_layouts = {}
    for k in ("dia_spmm", "dia_sym_spmm", "pruned_spmm", "pruned_sym_spmm", "dia_spmm_grouped"):
        by = {lay: sum(c[1][k][lay] for c in paths) for lay in kernels[k].launches_by_layout}
        summary_layouts[k] = max(by, key=by.get)
        rows[k] = rows[f"{k}/{summary_layouts[k]}" + ("/k4" if k == "dia_sym_spmm" else "")]

    src = "sigma_tpu_torch/csrc/"
    pallas = "sigma_tpu/ops/spmv_pallas.py"
    pruned = "sigma_tpu/ops/spmv_pruned.py"
    summary = {
        "dia_spmv": ("dia_spmv.cu", f"{pallas}:204"),
        "dia_sym_spmv": ("dia_spmv.cu", f"{pallas}:516"),
        "dia_spmm": ("dia_spmm.cu", f"{pallas}:1039 and {pallas}:1390"),
        "dia_sym_spmm": ("dia_spmm.cu", f"{pallas}:723 and {pallas}:1494"),
        "pruned_spmv": ("pruned.cu", f"{pruned}:187"),
        "pruned_sym_spmv": ("pruned.cu", f"{pruned}:482"),
        "pruned_spmm": ("pruned.cu", f"{pruned}:334"),
        "pruned_sym_spmm": ("pruned.cu", f"{pruned}:721"),
        "dia_spmm_grouped": ("dia_spmm_grouped.cu", f"{pallas}:1663 and {pallas}:1780"),
        "dia_spmv_resident": ("dia_spmv.cu", f"{pallas}:1246"),
        "dia_spmv_window": ("dia_spmv.cu", f"{pallas}:1277"),
        "bsr_grouped_spmv": ("bsr_grouped.cu", "sigma_tpu/ops/bsr_pallas.py:59"),
    }
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "spmm_summary_layouts": summary_layouts})
    emit(smi)
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": src + f, "replaces": r,
         "launches": sum(c[0][k] for c in paths), "max_abs_err": rows[k]["max_abs_err"],
         "ms": rows[k]["kernel_ms"], "plain_ms": rows[k]["plain_ms"],
         "bound_ms": rows[k]["bound_ms"], "bound_by": rows[k]["bound_by"],
         "library_ms": rows[k]["library_ms"]}
        for k, (f, r) in summary.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
