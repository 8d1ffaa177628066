#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one GPU.

    python3 chip_smoke.py [--nx 216]

Builds the DIA, grouped, staged, pruned and grouped-BSR SpMV and SpMM
kernels, GMRES's Givens update and ILDU's level sweep from
``sigma_tpu_torch/csrc/`` with nvcc (and the host library with g++),
checks each against its plain PyTorch version on the card (every
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
drives twenty-two paths through the package's public entry points:

- the stencil single-RHS path: CG, fused CG and CG preconditioned by
  structured pair-aggregation multigrid;
- the graphed path (phase 10b): CG and fused CG on Laplacian + I and
  GMG-CG with the Jacobi and the Chebyshev hierarchy again through
  ``graphed`` (one CUDA graph of 32 iterations under device-side
  if-nodes, ``csrc/graph_loop.cu``), the capturing and the cached call
  each held to the eager solve: x bit for bit, the count, the residual
  norm, ``converged``, the history and every kernel's launches; plus a
  solve past one block, one stopped unconverged by ``maxiter`` and one
  with b = 0;
- the stencil multi-RHS path: block CG with 8 right-hand sides
  (interleaved and column panels), GMG-preconditioned block CG with 4, and
  LOBPCG + GMG for the lowest 4 eigenpairs of the Dirichlet Laplacian (f32
  and f64), checked against the analytic spectrum;
- the unstructured single-RHS path: CG and pruned-pair-multigrid CG on
  full and symmetric pruned storage, against the manufactured solution;
- the graphed pruned path (phase 13b): phase 13's pruned-multigrid CG on
  full and symmetric storage and phase 14's block CG + pruned multigrid
  through ``graphed``, each held to the eager solve as in phase 10b (#10,
  #11 and #12 under a captured graph); plus CG stopped by ``maxiter`` and
  one with b = 0;
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
- the graphed nonsymmetric path (phase 23b): phase 23's BiCG-stab + Jacobi,
  BiCG-stab + GMG and GMRES(32) again through ``graphed`` (BiCG-stab 32
  iterations a replay, GMRES one restart cycle: its m Arnoldi steps and
  the cycle's end, each under an if-node, each step's scalar tail (the
  CGS2 column and the Givens update) one one-warp launch of
  ``csrc/givens.cu``, held first to its plain version in four dtypes at
  m = 32 and 48 and timed by CUDA-graph replay beside an empty warp), the
  capturing and the cached call each held to the eager solve as in phase
  10b; plus BiCG-stab stopped by ``maxiter``, GMRES(8) over several
  cycles, GMRES(32) stopped inside a cycle and a zero b for each;
- the nonsymmetric mesh (phase 24): ``benchmarks/unstructured_nonsym.py``'s
  skew-perturbed shuffled mesh at 1,048,576 rows in pruned storage, its
  skew statistic and route, plain and pruned-multigrid BiCG-stab, and
  FGMRES(32) with a 4-step inner BiCG-stab given as a lambda and through
  ``attach_solver`` (equal counts);
- the graphed nonsymmetric mesh (phase 24b): phase 24's BiCG-stab +
  pruned multigrid through ``graphed``, held to the eager solve as in
  phase 10b;
- the refinement question (phase 25): on the Dirichlet Poisson stencil at
  nx=216 to a relative residual of 1e-10, f64 CG + GMG against
  ``refined_solve`` with an f32 inner GMG-CG (f32, then bf16 operator
  values) and f64 MINRES with the same M;
- the graphed Krylov path (phase 25b): the rest of the solvers through
  ``graphed`` on the operators of phases 11, 23 and 25, each held to the
  eager solve as in phase 10b: block CG in the interleaved and the column
  layout and with GMG, f64 MINRES + GMG and MINRES with a history, CGLS,
  FGMRES(32) + GMG and FGMRES(8) with a plain callable M over several
  cycles, the stationary Jacobi iteration; block CG stopped by
  ``maxiter``, MINRES with b = 0, the stationary iteration with no steps;
  and FGMRES with an ``attach_solver`` M refused at capture;
- the eigen path (phases 26-29): ``refine_eigenpairs`` on phase 12's f32
  LOBPCG block over the f64 stencil (``benchmarks/eigen3d.py
  --inverse-step``), inverse generalized Lanczos on the 27-point Q1 FEM
  pencil at nx=102 with a GMG-CG-solved stiffness and f64 Rayleigh
  quotients (``benchmarks/geneigen3d.py``), and on phase 15's 1M-row mesh
  inverse Lanczos with pruned-GMG-CG and shift-invert Lanczos with its f64
  recurrence on the card (``benchmarks/eigen_unstructured.py --refine``),
  its inner pruned-GMG-CG through one ``graphed(cg_solve)`` (held first,
  over 4 steps, bit for bit to the eager inner solve), against the
  analytic spectra and the shift;
- the preconditioners (phases 30-31): ``benchmarks/ildu3d.py`` at nx=100
  (1M rows of Laplacian + I, f32 PCG on the DIA operator to rtol 1e-6)
  with Jacobi, Chebyshev(4), structured GMG, ILDU(0), ILU(1) and ILDU(0)
  after a greedy colour ordering, each ILDU apply held against the same
  operator on the CPU and repeated for equal bits, one traced apply each
  (two launches of the level-sweep kernel, ``csrc/ildu_sweep.cu``, and the
  scale); the level-sweep kernel held first to its plain version on each
  factor in f32 and f64 and timed beside an empty sweep, its bound and
  cuSPARSE's triangular solve; then (phase 30b) the ILDU(0), ILU(1) and
  colour-ordered PCGs by CG and fused CG through ``graphed``, each held
  to the eager solve as in phase 10b; then smoothed-aggregation AMG, the
  VMB hierarchy on that operator and the greedy one on
  ``benchmarks/amg_setup_probe.py``'s 262,144-row CSR Laplacian + I (each
  also on pure Poisson, where CG + AMG must take a quarter of plain CG's
  iterations), set-up split by step, CG + AMG and
  ``amg_solve``, and the algebra's device plans held to its host products;
- the apps (phases 32-33, no ported kernel: ELL gathers): the multicolour
  Metropolis Ising model on torus(4096, 4096) (16,777,216 sites), a cold
  start at beta = 0.6 against Onsager's spontaneous magnetization 0.97361
  and a hot start at beta = 0.3 against 0, each within 0.005; 10,000
  self-avoiding walks on torus(512, 512), whose mean trapping length must
  be within 3 of 70.7; and the two command-line drivers at their default
  sizes;
- the support modules (phase 34): the 2-D P1 Poisson solve on the unit
  square at nx = 512, 1024 and 2048 (4,198,401 nodes; f64 DIA on #1, held
  against its plain version on each operator with an f64 x), its
  max-norm error falling at least 3.5x per halving of h; npz, Matrix
  Market and checkpoint round trips bit for bit (a CG stopped at 200
  iterations resumed to rtol 1e-10); ``checked_solve`` and
  ``validate_matrix`` clean and raising on a NaN and on a nonzero padded
  slot; ``spmv_throughput`` of the nx=216 stencil beside phase 5's #1
  rate; and a two-field BlockVector through CG;
- the distributed layer (phase 35): a mesh of 4 shards on the card, the
  dry run, the nx=216 stencil under structured multigrid, phase 15's mesh
  in pruned storage and phase 30's operator as ELL ring blocks, each
  against its one-shard twin, and its CG + block ILDU(0) (the level-sweep
  kernel on the block-diagonal factors) through ``graphed``; then (phase
  35e) its rank form, 4 gloo ranks sharing the card and an NCCL group of one rank a card, on the
  stencil's and the mesh's multigrid CG at the shard mesh's counts, the
  ranks' launches counted with the path's;
- the examples (phase 36): the 14 example mains of
  ``sigma_tpu_torch/examples/`` and ``tools/entry.py``'s ``entry()`` run
  on the CPU first, recording the DIA and pruned operators their products
  use; each of those operands is held to its kernel (#1, #2, #10, #12) on
  the card; then each main runs on the card and its returned numbers are
  held against the CPU's (integers equal, the f32 examples' counts within
  2, errors within a factor 2, other floats to 1e-6), and
  ``solver_example_4`` runs again at 1,048,576 rows.

Each solve prints its iterations beside the JAX package's recorded TPU
count where there is one, its warm seconds, seconds per iteration, the
recomputed true relative residual and the error against the manufactured
solution; a solve that does not converge, or whose true residual is above
twice its target (the 2-D FEM solves: above their rtol plus f64 CG's
rounding estimate), fails the run.

The kernels' launch counts are zeroed before each path and read after it,
and each path must have launched its kernels; launches that compare a
kernel with its plain version run outside the counted paths, or (phase
34) are taken back out of the count.

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
import contextlib
import json
import math
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


def graph_ms(fn, launches=50, reps=5) -> float:
    """Device time per launch with the host out of the way: ``launches``
    calls captured in one CUDA graph and replayed, over ``launches``; the
    median of ``reps`` replays after one warm replay."""
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
    """CG and fused CG on Laplacian + I, as benchmarks/cg3d.py runs them;
    returns the operator and the right-hand side (phase 10b's)."""
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
    return A, b


def phase_gmg(device, nx):
    """Plain CG against GMG-CG on pure Poisson, as benchmarks/gmg3d.py
    runs them (symmetric operator, bf16 levels, 2x2x2 aggregates); returns
    the operator, the right-hand side and the hierarchies by smoother
    (phase 10b's; the Chebyshev one's levels are the staged path's
    operands)."""
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
    iters, hierarchies = {}, {}
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
            hierarchies[kw["smoother"]] = M
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
    return S, b, hierarchies


# phase 10b's time on the card, seconds: the path fails beyond it
GRAPHED_BUDGET_S = 40.0


class _MatvecCounter:
    """``A`` with its matvecs counted on the host (every other attribute
    A's own): a restarted solve makes one a step, one a cycle and one at
    set-up, so the count gives the cycles."""

    def __init__(self, A):
        self._A, self.calls = A, 0

    def __getattr__(self, name):
        return getattr(self._A, name)

    def matvec(self, x):
        self.calls += 1
        return self._A.matvec(x)


def _graphed_case(label, solve, A, b, kw, timed=False, phase="graphed", extra=(),
                  count_matvecs=False):
    """One solve eagerly and through ``graphed(solve)`` twice (the first
    call captures, the second replays from the cache), held equal: x bit
    for bit, the count, the residual norm, ``converged``, the history (for
    a solve that keeps one) and every kernel's launches.  ``b`` is the
    right-hand side (a block B for block CG); ``extra`` the positional
    operands after it (the stationary iteration's M).  ``timed`` repeats
    both three times, in turns, for the median seconds.
    ``count_matvecs`` counts A's matvecs in the first eager solve (the
    row's ``matvecs_eager``).  Returns the row (``phase`` its phase's
    name)."""
    import torch

    from sigma_tpu_torch import graphed
    from sigma_tpu_torch.ops import launch_counts, launch_difference

    def run(fn, op=A):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = fn(op, b, *extra, **kw)
        torch.cuda.synchronize()
        return x, info, time.perf_counter() - t0, launch_difference(launch_counts(), before)

    counter = _MatvecCounter(A) if count_matvecs else A
    x, info, eager_s, launches = run(solve, counter)
    G = graphed(solve)

    def check(call):
        y, gi, secs, glaunches = run(G)
        differ = [name for name, same in (
            ("x", torch.equal(y, x)),
            ("iterations", gi.iterations == info.iterations),
            ("residual_norm", torch.equal(gi.residual_norm, info.residual_norm)),
            ("converged", gi.converged == info.converged),
            ("history", (gi.history is None and info.history is None)
             or torch.equal(gi.history.nan_to_num(-1.0), info.history.nan_to_num(-1.0))),
            ("launches", glaunches == launches),
            ("captured", G.captured == (call == "capture")),
        ) if not same]
        if differ:
            raise AssertionError(f"graphed {label} ({call} call): {differ} differ from the eager "
                                 f"solve ({info.iterations} iterations, graphed {gi.iterations})")
        return secs

    first_s = check("capture")
    capture_s = G.capture_seconds
    cached_s = check("cached")
    eager_runs, cached_runs = [eager_s], [cached_s]
    if timed:
        for _ in range(3):
            eager_runs.append(run(solve)[2])
            cached_runs.append(check("cached"))
    its = max(info.iterations, 1)
    eager_s, cached_s = statistics.median(eager_runs), statistics.median(cached_runs)
    # a graphed GMRES or FGMRES reads once a restart cycle; its eager loop
    # once a step and once a cycle
    restarted = solve.__name__ in ("gmres_solve", "fgmres_solve")
    cycles = G.host_reads if restarted and info.iterations else 0
    row = {"phase": phase, "solve": label, "iterations": info.iterations,
           "converged": info.converged, "maxiter": kw.get("maxiter", kw.get("steps")),
           "history": bool(kw.get("history")), "x_bitwise_equal": True,
           "eager_s": eager_s, "first_call_s": first_s, "capture_s": capture_s,
           "cached_s": cached_s, "eager_s_per_iteration": eager_s / its,
           "graphed_s_per_iteration": cached_s / its,
           # eager: a read of the stopping rule an iteration and one more,
           # and one of converged; graphed: one of the status a replay
           "host_reads_eager": info.iterations + cycles + 2, "host_reads_graphed": G.host_reads,
           **({"restart": kw["restart"], "cycles": cycles} if "restart" in kw else {}),
           **({"matvecs_eager": counter.calls} if count_matvecs else {}),
           "launches": {k: n for k, (n, _) in launches.items() if n}}
    emit(row)
    return row


def phase_graphed(device, A9, b9, S10, b10, hierarchies):
    """Phase 10b: phase 9's CG and fused CG on Laplacian + I and phase
    10's GMG-CG with each hierarchy on Poisson, eagerly and as graphed
    solves, everything held equal (:func:`_graphed_case`); with and
    without a history, and three edge cases: a count past one block with
    ``maxiter`` not a multiple of the block, a solve stopped unconverged by
    ``maxiter``, and one that meets its tolerance at iteration 0.  Fails
    beyond ``GRAPHED_BUDGET_S``."""
    import torch

    from sigma_tpu_torch import cg_fused_solve, cg_solve
    from sigma_tpu_torch.solvers.graphed import BLOCK

    t0 = time.perf_counter()
    cg_kw = dict(tol=0.0, rtol=1e-6, maxiter=100)
    gmg_kw = dict(tol=0.0, rtol=2e-7, maxiter=3000)
    solves = (
        ("cg_solve", cg_solve, A9, b9, cg_kw),
        ("cg_fused_solve", cg_fused_solve, A9, b9, cg_kw),
        ("gmg_jacobi", cg_solve, S10, b10, dict(gmg_kw, M=hierarchies["jacobi"])),
        ("gmg_chebyshev", cg_solve, S10, b10, dict(gmg_kw, M=hierarchies["chebyshev"])),
    )
    for label, solve, A, b, kw in solves:
        _graphed_case(label, solve, A, b, kw, timed=True)
        _graphed_case(label, solve, A, b, dict(kw, history=True))
    edges = (
        ("plain_cg_past_one_block", cg_solve, S10, b10, dict(tol=0.0, rtol=1e-4, maxiter=1000)),
        ("fused_cg_stopped_by_maxiter", cg_fused_solve, S10, b10,
         dict(tol=0.0, rtol=2e-7, maxiter=BLOCK + 13)),
        ("gmg_jacobi_zero_rhs", cg_solve, S10, torch.zeros_like(b10),
         dict(gmg_kw, M=hierarchies["jacobi"])),
    )
    rows = {label: _graphed_case(label, solve, A, b, kw) for label, solve, A, b, kw in edges}
    if not (rows["plain_cg_past_one_block"]["iterations"] > BLOCK
            and rows["plain_cg_past_one_block"]["converged"]
            and rows["plain_cg_past_one_block"]["maxiter"] % BLOCK):
        raise AssertionError(f"plain CG did not run past one block: {rows}")
    if rows["fused_cg_stopped_by_maxiter"]["converged"]:
        raise AssertionError("fused CG met its tolerance within maxiter")
    if rows["gmg_jacobi_zero_rhs"]["iterations"] != 0:
        raise AssertionError("the zero right-hand side took iterations")
    secs = time.perf_counter() - t0
    emit({"phase": "graphed_path", "seconds": secs, "block": BLOCK,
          "budget_s": GRAPHED_BUDGET_S})
    if secs > GRAPHED_BUDGET_S:
        raise AssertionError(f"phase 10b took {secs:.1f} s, over its {GRAPHED_BUDGET_S} s")


def _col_rel_residuals(A, B, X):
    """||b_j - A x_j|| / ||b_j|| for every column."""
    import torch

    R = B - A.matmat(X)
    return (torch.linalg.vector_norm(R, dim=0) / torch.linalg.vector_norm(B, dim=0)).tolist()


def phase_block_cg(device, nx):
    """Block CG with 8 right-hand sides on Laplacian + I (cg3d.py's operator
    and SpMM width), rtol 1e-6, in the interleaved (``auto`` on the card)
    and the column layout; then GMG-preconditioned block CG with 4 on pure
    Poisson (symmetric storage, bf16 levels, as phase_gmg).  Returns both
    operators, their blocks and the hierarchy (phase 25b's)."""
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

    S = SymmetricDIAMatrix.from_dia(laplacian_3d_dia(nx, torch.float32, device, diag=6.0))
    s = 4
    g = torch.Generator(device=device).manual_seed(0)
    B4 = S.matmat(torch.randn((n, s), generator=g, device=device))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    M = structured_pair_amg(S, (nx, nx, nx), pairs_per_level=3, level_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    (X, info), warm = _timed(
        lambda: block_cg_solve(S, B4, tol=0.0, rtol=1e-6, maxiter=300, M=M)
    )
    rels = _col_rel_residuals(S, B4, X)
    emit({"phase": "block_cg", "operator": "poisson_sym", "preconditioner": "gmg_jacobi_bf16",
          "n": n, "rhs": s, "setup_s": setup, "iterations": info.iterations,
          "converged": info.converged, "col_relative_residuals": rels,
          "wall_s_warm": warm, "s_per_iteration": warm / max(info.iterations, 1)})
    if not (info.converged and max(rels) < 1e-5):
        raise AssertionError(f"GMG block CG did not converge: {info}, {rels}")
    return A, B, S, B4, M


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
    against the analytic spectrum.  Returns the f32 run's eigenvector block
    and hierarchy, which phase 26 refines."""
    import numpy as np
    import torch

    from sigma_tpu_torch import laplacian_3d_dia, lobpcg, structured_pair_amg

    exact = analytic_lowest(nx, m)
    X0 = np.random.default_rng(0).standard_normal((nx**3, m))
    rtol = LOBPCG_RTOL
    kept = None
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
        if kept is None:
            kept = (res.eigenvectors, M)
        del A, M, x0, res
    return kept


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


def _manufactured_block(U, k=8):
    """B = A X for the column block X_ij = sin(0.001 (j + 1) i) of phase 14
    (k columns), from the plain version as :func:`_manufactured`'s b."""
    import torch

    from sigma_tpu_torch.ops import pruned_spmm_reference

    P, n = U["P"], U["n"]
    i = torch.arange(n, dtype=torch.float32, device=P.device)
    X = torch.stack([torch.sin(i * (0.001 * (j + 1))) for j in range(k)], dim=1)
    del i
    return pruned_spmm_reference(P.data, X, P.offsets, P.tile_ptr, n, n, "cols", group=P.group)


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


# phase 13b's and phase 24b's times on the card, seconds: each fails beyond
GRAPHED_PRUNED_BUDGET_S = 40.0
GRAPHED_NONSYM_MESH_BUDGET_S = 20.0


def _check_host_reads(label, rows):
    """Each graphed row read its status once a block of iterations."""
    from sigma_tpu_torch.solvers.graphed import BLOCK

    for name, row in rows.items():
        want = max(1, -(-row["iterations"] // BLOCK))
        if row["host_reads_graphed"] != want:
            raise AssertionError(f"{label} {name}: {row['host_reads_graphed']} host reads, "
                                 f"want {want}")


def phase_graphed_pruned(device, U):
    """Phase 13b: phase 13's pruned-multigrid CG on full (``Mf``) and
    symmetric (``Ms``) storage and phase 14's block CG (8 right-hand sides
    in column panels, ``Mf``) eagerly and as graphed solves, everything held
    equal (:func:`_graphed_case`), the CGs also with a history; then CG
    stopped unconverged by ``maxiter`` = BLOCK + 13 and a zero right-hand
    side.  One graphed callable a case, dropped after it (a graph holds its
    own buffers at 10.1M rows).  Fails beyond ``GRAPHED_PRUNED_BUDGET_S``."""
    import torch

    from sigma_tpu_torch import block_cg_solve, cg_solve
    from sigma_tpu_torch.solvers.graphed import BLOCK

    t0 = time.perf_counter()
    P, S, Mf, Ms = U["P"], U["S"], U["Mf"], U["Ms"]
    b = _manufactured(U)[2]
    kw = dict(tol=0.0, rtol=1e-6, maxiter=300)
    run = partial(_graphed_case, phase="graphed_pruned")
    rows = {}
    for label, A, M in (("gmg_cg_full", P, Mf), ("gmg_cg_sym", S, Ms)):
        rows[label] = run(label, cg_solve, A, b, dict(kw, M=M), timed=True)
        rows[f"{label}_history"] = run(label, cg_solve, A, b, dict(kw, M=M, history=True))
    rows["gmg_block_cg_full"] = run("gmg_block_cg_full", block_cg_solve, P,
                                    _manufactured_block(U), dict(kw, M=Mf, panels="cols"))
    rows["gmg_cg_full_stopped_by_maxiter"] = run(
        "gmg_cg_full_stopped_by_maxiter", cg_solve, P, b,
        dict(kw, rtol=1e-12, maxiter=BLOCK + 13, M=Mf))
    rows["gmg_cg_sym_zero_rhs"] = run("gmg_cg_sym_zero_rhs", cg_solve, S, torch.zeros_like(b),
                                      dict(kw, M=Ms))
    _check_host_reads("graphed", rows)
    for label in ("gmg_cg_full", "gmg_cg_sym", "gmg_block_cg_full"):
        if not (rows[label]["converged"] and rows[label]["iterations"] > 0):
            raise AssertionError(f"graphed {label} did not converge: {rows[label]}")
    stopped = rows["gmg_cg_full_stopped_by_maxiter"]
    if stopped["converged"] or stopped["iterations"] != BLOCK + 13:
        raise AssertionError(f"pruned multigrid CG was not stopped by maxiter: {stopped}")
    if rows["gmg_cg_sym_zero_rhs"]["iterations"]:
        raise AssertionError("the zero right-hand side took iterations")
    if not rows["gmg_block_cg_full"]["launches"].get("pruned_spmm"):
        raise AssertionError("graphed block CG ran no pruned SpMM")
    secs = time.perf_counter() - t0
    emit({"phase": "graphed_pruned_path", "seconds": secs, "block": BLOCK,
          "budget_s": GRAPHED_PRUNED_BUDGET_S})
    if secs > GRAPHED_PRUNED_BUDGET_S:
        raise AssertionError(f"phase 13b took {secs:.1f} s, over its {GRAPHED_PRUNED_BUDGET_S} s")


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

    from sigma_tpu_torch.ops import pruned_spmm

    A, M, n = U["P"], U["Mf"], U["n"]
    # B from the plain version, so the solve is not held only to the kernel
    B = _manufactured_block(U)
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
    full-storage eigenvalues, which the full-band LOBPCG is held to, and
    the set-up (its RCM permutation too), which phases 28-29 reuse."""
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
    return eigs["full"], U


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
    is held).  Returns the operator, b and the two preconditioners."""
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
    Mj = jacobi().setup(A)
    kw = dict(tol=0.0, rtol=NONSYM_RTOL, maxiter=2000)
    for label, run, extra in (
        ("bicgstab_jacobi", lambda: bicgstab_solve(A, b, M=Mj, **kw), {}),
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
    return A, b, Mj, Mg


GRAPHED_NONSYM_BUDGET_S = 40.0


def _givens_step_inputs(j, bdtype, rng, device):
    """Step j's (h1, h2, ||w||) of a checked cycle: random, with ||w|| zero
    at j = 9, a breakdown (0 < ||w|| <= eps10) at j = 14, just above eps10
    at j = 15 and an all-zero column at j = 20."""
    import torch

    eps10 = torch.finfo(bdtype).eps * 10
    h1, h2 = (torch.from_numpy(a).to(device, bdtype) for a in rng.standard_normal((2, j + 1)))
    wn = {9: 0.0, 14: eps10 / 2, 15: eps10 * 2}.get(j, abs(float(rng.standard_normal())))
    if j == 20:
        h1, h2, wn = h1 * 0, h2 * 0, 0.0
    return h1, h2, torch.tensor(wn, device=device).to(bdtype)


def _givens_state(m, bdtype, device):
    """[eps10, h, d, R, cs, sn, g, est, inner, jdev] of a fresh cycle in
    ``arnoldi_loop``'s dtypes, g[0] = 2.5."""
    import torch

    from sigma_tpu_torch.ops import givens_small_dtype

    sdt = givens_small_dtype(bdtype)
    z = [torch.zeros(s, dtype=sdt, device=device) for s in ((m + 1,), (m, m), m, m, m + 1, ())]
    z[4][0] = 2.5
    eps10 = torch.tensor(torch.finfo(bdtype).eps, dtype=sdt, device=device) * 10
    return [eps10, z[0], torch.zeros((), dtype=bdtype, device=device), *z[1:],
            torch.zeros((), dtype=torch.bool, device=device),
            torch.zeros((), dtype=torch.int64, device=device)]


def givens_checks(device, ms=(32, 48)):
    """GMRES's scalar-tail kernel (``csrc/givens.cu``: one warp does the
    CGS2 column's assembly and breakdown test, then the Givens update)
    against its plain version on the card: whole cycles of m = 32 and 48
    steps with b in f64, f32, bf16 and f16 on random projections (a zero
    ||w||, a breakdown with 0 < ||w|| <= eps10, ||w|| just above eps10, an
    all-zero column), every output bit for bit in f64 and within 1e-6
    relative in the float32 small arrays, the column's h[j + 1], the
    divisor, the predicate and the step count exact.  Then, f32 at the last
    step of m = 32 (the longest chain): the kernel's device time from 50
    launches replayed from one CUDA graph (``kernel_ms``), an empty
    one-warp kernel's the same way (``floor_ms``), the bound, the plain
    version's single call (``plain_ms``) and the wrapper's single call
    (``call_ms``: the host's time, the device idle while Python checks and
    launches).  Outside the counted paths.  Returns the kernel's summary
    row."""
    import numpy as np
    import torch

    from sigma_tpu_torch.ops import empty_warp, givens_update, givens_update_reference

    k = torch.tensor(7, device=device)
    row = {"phase": "givens_kernel", "m": list(ms)}
    worst = 0.0
    for bdtype in (torch.float64, torch.float32, torch.bfloat16, torch.float16):
        for m in ms:
            kern, plain = _givens_state(m, bdtype, device), _givens_state(m, bdtype, device)
            tol = torch.tensor(1e-30, dtype=kern[0].dtype, device=device)
            rng = np.random.default_rng(24)
            bitwise, exact, rel = True, True, 0.0
            for j in range(m):
                h1, h2, wn = _givens_step_inputs(j, bdtype, rng, device)
                givens_update(h1, h2, wn, *kern, k, tol, j, 1000)
                givens_update_reference(h1, h2, wn, *plain, k, tol, j, 1000)
                exact &= torch.equal(kern[1][j + 1], plain[1][j + 1])
                for a, r in zip(kern, plain):
                    bitwise &= torch.equal(a, r)
                    if a.is_floating_point() and a is not kern[2]:
                        worst = max(worst, float((a.double() - r.double()).abs().max()))
                        rel = max(rel, rel_err(a, r))
                    else:
                        exact &= torch.equal(a, r)
                if j == 14:
                    exact &= float(kern[2]) == math.inf and float(kern[1][j + 1]) == 0.0
            name = f"{str(bdtype).split('.')[1]}_m{m}"
            row[name] = {"bitwise_equal": bitwise, "max_rel_err": rel, "exact_scalars": exact}
            if not exact or not (bitwise if bdtype == torch.float64 else rel <= 1e-6):
                raise AssertionError(f"the Givens kernel differs from its plain version: {row}")
    # time the last step of m = 32 (the longest chain of the main path), f32
    m = 32
    kern = _givens_state(m, torch.float32, device)
    h1, h2, _ = _givens_step_inputs(m - 1, torch.float32, np.random.default_rng(1), device)
    wn = torch.tensor(0.75, device=device)
    tol = torch.tensor(1e-30, device=device)

    def step():
        givens_update(h1, h2, wn, *kern, k, tol, m - 1, 1000)

    row["timing"] = "f32, j = 31 of m = 32; kernel_ms, floor_ms: 50 launches replayed from " \
                    "one CUDA graph, per launch; call_ms, plain_ms: one call between two events"
    row["kernel_ms"] = graph_ms(step)
    row["floor_ms"] = graph_ms(lambda: empty_warp(device))
    row["call_ms"] = median_ms(step)
    row["plain_ms"] = median_ms(lambda: givens_update_reference(h1, h2, wn, *kern, k, tol,
                                                                m - 1, 1000))
    j = m - 1
    # read h1, h2, wn (b), eps10, tol, cs, sn, g[j] (small), k; write h, R's
    # column, cs[j], sn[j], g[j], g[j + 1], est (small), d (b), inner, jdev:
    # j + 1 adds, 6 operations a rotation and ~16 more
    b_, s_ = 4, 4
    nbytes = b_ * (2 * (j + 1) + 2) + s_ * (2 + 2 * j + 1 + (j + 2) + (j + 1) + 5) + 8 + 1 + 8
    row["bound_ms"], row["bound_by"] = bound(nbytes, 7 * j + 16, torch.float32)
    row["limited_by"] = "latency: one warp, one launch (kernel_ms against floor_ms)"
    row["max_abs_err"], row["library_ms"] = worst, None
    emit(row)
    return row


def phase_graphed_nonsym(device, A, b, Mj, Mg):
    """Phase 23b: phase 23's BiCG-stab + Jacobi, BiCG-stab + GMG and
    GMRES(32) eagerly and as graphed solves (BiCG-stab a block of
    iterations a replay, GMRES a restart cycle), everything held equal
    (:func:`_graphed_case`), BiCG-stab also with a history; then the edge
    cases: BiCG-stab stopped unconverged by ``maxiter``, GMRES(8) over
    several cycles with ``maxiter`` not a multiple of 8, GMRES(32) stopped
    by ``maxiter`` inside its second cycle, and a zero right-hand side for
    each solver.  A graphed BiCG-stab reads once a block, a graphed GMRES
    once a cycle (the cycles counted from the eager solve's matvecs).
    Fails beyond ``GRAPHED_NONSYM_BUDGET_S``."""
    import torch

    from sigma_tpu_torch import bicgstab_solve, gmres_solve
    from sigma_tpu_torch.solvers.graphed import BLOCK

    t0 = time.perf_counter()
    kw = dict(tol=0.0, rtol=NONSYM_RTOL, maxiter=2000)
    run = partial(_graphed_case, phase="graphed_nonsym")
    rows = {}
    for label, solve, extra in (("bicgstab_jacobi", bicgstab_solve, dict(M=Mj)),
                                ("bicgstab_gmg", bicgstab_solve, dict(M=Mg)),
                                ("gmres32", gmres_solve, dict(restart=32))):
        rows[label] = run(label, solve, A, b, dict(kw, **extra), timed=True)
        if solve is bicgstab_solve:
            run(label, solve, A, b, dict(kw, history=True, **extra))
    z = torch.zeros_like(b)
    for label, solve, bb, extra in (
        ("bicgstab_stopped_by_maxiter", bicgstab_solve, b, dict(M=Mj, maxiter=BLOCK + 13)),
        ("gmres8_cycles", gmres_solve, b, dict(restart=8, maxiter=1001)),
        ("gmres32_stopped_mid_cycle", gmres_solve, b, dict(restart=32, maxiter=45)),
        ("bicgstab_zero_rhs", bicgstab_solve, z, dict(M=Mg)),
        ("gmres32_zero_rhs", gmres_solve, z, dict(restart=32)),
    ):
        rows[label] = run(label, solve, A, bb, dict(kw, **extra))
    for label, row in rows.items():
        its = row["iterations"]
        if label.startswith("gmres"):
            # no M: one matvec at set-up, one a step and one a cycle
            cycles = row["launches"].get("dia_spmv", 0) - 1 - its
            want = max(1, cycles)
        else:
            want = max(1, -(-its // BLOCK))
        if row["host_reads_graphed"] != want:
            raise AssertionError(f"graphed {label}: {row['host_reads_graphed']} host reads, "
                                 f"want {want}")
    stopped, cyc = rows["bicgstab_stopped_by_maxiter"], rows["gmres8_cycles"]
    mid = rows["gmres32_stopped_mid_cycle"]
    if stopped["converged"] or stopped["iterations"] != BLOCK + 13:
        raise AssertionError(f"BiCG-stab was not stopped by maxiter: {stopped}")
    if not (cyc["converged"] and cyc["cycles"] >= 3 and cyc["maxiter"] % 8):
        raise AssertionError(f"GMRES(8) did not converge over several cycles: {cyc}")
    if mid["converged"] or mid["iterations"] != 45 or mid["cycles"] != 2:
        raise AssertionError(f"GMRES(32) was not stopped inside its second cycle: {mid}")
    if rows["bicgstab_zero_rhs"]["iterations"] or rows["gmres32_zero_rhs"]["iterations"]:
        raise AssertionError("a zero right-hand side took iterations")
    secs = time.perf_counter() - t0
    emit({"phase": "graphed_nonsym_path", "seconds": secs, "block": BLOCK,
          "budget_s": GRAPHED_NONSYM_BUDGET_S})
    if secs > GRAPHED_NONSYM_BUDGET_S:
        raise AssertionError(f"phase 23b took {secs:.1f} s, over its {GRAPHED_NONSYM_BUDGET_S} s")


def nonsym_mesh_setup(device, height=16_384, width=64, seed=0, beta=0.3, shift=1e-3):
    """benchmarks/unstructured_nonsym.py's defaults: the skew-perturbed,
    shuffled 1,048,576-row mesh, RCM, full pruned storage (f32), its skew
    statistic, auto_pruned_preconditioner's route and pruned_pair_amg
    (Jacobi smoother, coarse 4096), and b = A xstar with xstar_i = sin(0.001
    i).  Returns a dict of the objects and the set-up's seconds."""
    import numpy as np
    import torch

    from sigma_tpu_torch import (
        PrunedDIAMatrix, auto_pruned_preconditioner, pruned_pair_amg, reorder_triples_rcm,
        skew_dominance, skewed_mesh_coo,
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
    xstar = np.sin(np.arange(n) * 0.001).astype(np.float32)
    xp = np.empty_like(xstar)
    xp[p] = xstar
    # b from the plain version, so a solve is not held only to the kernel
    b = pruned_matvec_reference(P.data, torch.from_numpy(xp).to(device), P.offsets,
                                P.tile_ptr, P.n, P.m, group=P.group)
    return {"n": n, "nnz": int(pr.size), "beta": beta, "P": P, "Mg": Mg, "b": b, "p": p,
            "xstar": xstar, "skew_dominance": s_dom, "route": route["route"], "seconds": secs}


def phase_nonsym_unstructured(device):
    """Phase 24 on :func:`nonsym_mesh_setup`'s mesh: (rtol 1e-6, maxiter
    500) plain BiCG-stab, BiCG-stab + pruned_pair_amg, and FGMRES(32) with a
    4-step inner BiCG-stab as a lambda and through attach_solver, which
    must take the lambda's count.  Returns (P, b, Mg) for phase 24b."""
    import numpy as np

    from sigma_tpu_torch import attach_solver, bicgstab, bicgstab_solve, fgmres_solve

    N = nonsym_mesh_setup(device)
    n, P, Mg, b, p, xstar = (N[k] for k in ("n", "P", "Mg", "b", "p", "xstar"))
    emit({"phase": "nonsym_unstructured_setup", "n": n, "nnz": N["nnz"], "beta": N["beta"],
          "skew_dominance": N["skew_dominance"], "route": N["route"],
          "levels": len(Mg.levels) + 1, "stored_slots": P.stored_slots,
          "seconds": N["seconds"]})

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
    return P, b, Mg


def phase_graphed_nonsym_mesh(device, P, b, Mg):
    """Phase 24b: phase 24's BiCG-stab + pruned multigrid (rtol 1e-6,
    maxiter 500) eagerly and as a graphed solve, held equal
    (:func:`_graphed_case`, timed), one host read a block.  Fails beyond
    ``GRAPHED_NONSYM_MESH_BUDGET_S``."""
    from sigma_tpu_torch import bicgstab_solve
    from sigma_tpu_torch.solvers.graphed import BLOCK

    t0 = time.perf_counter()
    kw = dict(tol=0.0, rtol=NONSYM_RTOL, maxiter=500, M=Mg)
    row = _graphed_case("bicgstab_pruned_gmg", bicgstab_solve, P, b, kw, timed=True,
                        phase="graphed_nonsym_mesh")
    _check_host_reads("graphed", {"bicgstab_pruned_gmg": row})
    if not (row["converged"] and row["iterations"] > BLOCK):
        raise AssertionError(f"graphed BiCG-stab + pruned multigrid: {row}")
    secs = time.perf_counter() - t0
    emit({"phase": "graphed_nonsym_mesh_path", "seconds": secs, "block": BLOCK,
          "budget_s": GRAPHED_NONSYM_MESH_BUDGET_S})
    if secs > GRAPHED_NONSYM_MESH_BUDGET_S:
        raise AssertionError(
            f"phase 24b took {secs:.1f} s, over its {GRAPHED_NONSYM_MESH_BUDGET_S} s")


def phase_refinement(device, nx):
    """Does plain f64 CG beat the refinement ladder on a card with native
    f64?  The Dirichlet Poisson stencil of phase 10 at nx^3, symmetric
    storage, relative-residual target 1e-10 in f64, xstar from
    default_rng(0): (a) f64 CG + Chebyshev GMG in f64; (b) refined_solve
    with an f32 inner GMG-CG (f32 operator and levels); (c) as (b) with the
    inner operator's values in bf16 (exact for this stencil); (d) MINRES
    in f64 with (a)'s M.  Returns the f64 operator, b and (a)'s M (phase
    25b's)."""
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
    return S, b, M64


# phase 25b's time on the card, seconds: the path fails beyond it
GRAPHED_KRYLOV_BUDGET_S = 40.0


def _richardson_sweeps(A, Minv, sweeps=3):
    """A preconditioner that is a plain callable with no host read:
    ``sweeps`` Jacobi-preconditioned Richardson sweeps on A z = v from
    z = 0."""

    def apply(v):
        z = Minv.matvec(v)
        for _ in range(sweeps - 1):
            z = z + Minv.matvec(v - A.matvec(z))
        return z

    return apply


def graphed_copy_costs(device, n, s=8):
    """The device time of what a captured loop moves that the eager one
    does not (CUDA events, median of 30; f32 panels in the interleaved
    layout of n rows and s columns, f64 vectors of n): block CG's best
    iterate, a ``where`` over the panel in place (the eager loop makes it
    into a fresh panel; the JAX package's ``jnp.where``), its new direction
    block copied into the buffer set, and MINRES's preconditioned vector
    copied into it (with an M; MINRES's swapped residuals and directions
    are held crosswise and copy nothing).  Each beside its byte bound."""
    import torch

    rows = s * -(-n // 128)
    X, Xb = (torch.rand((rows, 128), device=device) for _ in range(2))
    y, yb = (torch.rand(n, dtype=torch.float64, device=device) for _ in range(2))
    flag = torch.ones((), dtype=torch.bool, device=device)
    panel = X.numel() * 4
    row = {"phase": "graphed_copy_costs", "n": n, "rhs": s,
           "best_iterate_where_ms": median_ms(lambda: torch.where(flag, X, Xb, out=Xb)),
           "best_iterate_where_bound_ms": bound(3 * panel, 0, torch.float32)[0],
           "direction_copy_ms": median_ms(lambda: Xb.copy_(X)),
           "direction_copy_bound_ms": bound(2 * panel, 0, torch.float32)[0],
           "minres_y_copy_f64_ms": median_ms(lambda: yb.copy_(y)),
           "minres_y_copy_bound_ms": bound(2 * n * 8, 0, torch.float64)[0]}
    emit(row)
    return row


def phase_graphed_krylov(device, blk, nonsym, refine):
    """Phase 25b: the rest of the Krylov solvers as graphed solves, each
    eagerly and through ``graphed`` (:func:`_graphed_case`), everything
    held equal, on the operators of phases 11, 23 and 25 at nx=216: block
    CG with 8 right-hand sides on Laplacian + I in the interleaved
    (``auto``: #7) and the column layout (#4), GMG block CG with 4 on pure
    Poisson (#3/#8 and the bf16 levels), f64 MINRES + GMG to rtol 1e-10
    (#2 in f64), MINRES with no M and a history, 100 CGLS steps on the
    advection-diffusion stencil (#1 and its transposed layout), FGMRES(32)
    + GMG and FGMRES(8) whose M is a plain callable running 3
    Jacobi-preconditioned Richardson sweeps, and 45 Jacobi sweeps of the
    stationary iteration; then block CG stopped by ``maxiter``, MINRES
    with a zero right-hand side and the stationary iteration with no
    steps.  A graphed solve reads once a block of iterations, FGMRES once
    a restart cycle (the cycles counted from the eager solve's matvecs).
    FGMRES whose M is phase 24's ``attach_solver`` form must raise at
    capture, naming M's type, and the eager solve run as before.  Fails
    beyond ``GRAPHED_KRYLOV_BUDGET_S``."""
    import torch

    from sigma_tpu_torch import (
        attach_solver, bicgstab, block_cg_solve, cgls_solve, fgmres_solve, graphed, jacobi,
        minres_solve, stationary_solve,
    )
    from sigma_tpu_torch.solvers.graphed import BLOCK

    t0 = time.perf_counter()
    A11, B11, S11, B4, M11 = blk
    A23, b23, Mj23, Mg23 = nonsym
    S25, b25, M25 = refine
    run = partial(_graphed_case, phase="graphed_krylov")
    b11 = B11[:, 0].contiguous()
    Mj11 = jacobi().setup(A11)
    richardson = _richardson_sweeps(A23, Mj23)
    bkw = dict(tol=0.0, rtol=1e-6, maxiter=100)
    nkw = dict(tol=0.0, rtol=NONSYM_RTOL, maxiter=2000)
    mkw = dict(tol=0.0, rtol=REFINE_RTOL, maxiter=3000, M=M25)
    rows = {}
    for label, solve, A, b, kw, extra, timed in (
        ("block_cg_auto", block_cg_solve, A11, B11, dict(bkw, panels="auto"), (), True),
        ("block_cg_cols", block_cg_solve, A11, B11, dict(bkw, panels="cols"), (), True),
        ("block_cg_gmg", block_cg_solve, S11, B4, dict(bkw, maxiter=300, M=M11), (), True),
        ("minres_gmg_f64", minres_solve, S25, b25, mkw, (), True),
        ("minres_history", minres_solve, A11, b11, dict(bkw, history=True), (), False),
        ("cgls", cgls_solve, A23, b23, dict(nkw, maxiter=100), (), True),
        ("fgmres32_gmg", fgmres_solve, A23, b23, dict(nkw, restart=32, M=Mg23), (), True),
        ("fgmres8_richardson", fgmres_solve, A23, b23, dict(nkw, restart=8, M=richardson), (),
         False),
        ("stationary_jacobi", stationary_solve, A11, b11, dict(steps=BLOCK + 13), (Mj11,),
         True),
        ("block_cg_stopped_by_maxiter", block_cg_solve, S11, B4,
         dict(bkw, maxiter=BLOCK + 5), (), False),
        ("minres_zero_rhs", minres_solve, S25, torch.zeros_like(b25), mkw, (), False),
        ("stationary_no_steps", stationary_solve, A11, b11, dict(steps=0), (Mj11,), False),
    ):
        rows[label] = run(label, solve, A, b, kw, timed=timed, extra=extra,
                          count_matvecs=solve is fgmres_solve)
    for label, row in rows.items():
        its = row["iterations"]
        if label.startswith("fgmres"):
            cycles = row["matvecs_eager"] - 1 - its  # one at set-up and one a step
            want = max(1, cycles)
        else:
            want = max(1, -(-its // BLOCK))
        if row["host_reads_graphed"] != want:
            raise AssertionError(f"graphed {label}: {row['host_reads_graphed']} host reads, "
                                 f"want {want}")
        # 100 CGLS steps lower ||A^T r|| without reaching rtol (phase 23)
        if not (row["converged"] or label.endswith("by_maxiter") or label == "cgls"):
            raise AssertionError(f"graphed {label} did not converge: {row}")
    stopped = rows["block_cg_stopped_by_maxiter"]
    if stopped["converged"] or stopped["iterations"] != BLOCK + 5:
        raise AssertionError(f"block CG was not stopped by maxiter: {stopped}")
    if rows["fgmres8_richardson"]["cycles"] < 3:
        raise AssertionError(f"FGMRES(8) ran fewer than 3 cycles: {rows['fgmres8_richardson']}")
    if rows["stationary_jacobi"]["iterations"] != BLOCK + 13:
        raise AssertionError(f"the stationary iteration took another count: "
                             f"{rows['stationary_jacobi']}")
    if rows["minres_zero_rhs"]["iterations"] or rows["stationary_no_steps"]["iterations"]:
        raise AssertionError("a zero right-hand side or zero steps took iterations")
    if rows["block_cg_auto"]["iterations"] != rows["block_cg_cols"]["iterations"]:
        raise AssertionError("graphed block CG took other counts by layout")
    # an attached inner solve reads back: refused at capture, M named
    Ma = attach_solver(A23, bicgstab(tolerance=0.0, maxiter=4))
    akw = dict(tol=0.0, rtol=NONSYM_RTOL, restart=8, maxiter=16, M=Ma)
    x, info = fgmres_solve(A23, b23, **akw)
    try:
        graphed(fgmres_solve)(A23, b23, **akw)
    except RuntimeError as e:
        refused = str(e)
    else:
        raise AssertionError("graphed FGMRES with an attached solver did not raise at capture")
    if "OperatorWithSolver" not in refused:
        raise AssertionError(f"the refusal does not name M's type: {refused}")
    y, again = fgmres_solve(A23, b23, **akw)
    if not (torch.equal(y, x) and again.iterations == info.iterations > 0):
        raise AssertionError(f"the eager FGMRES with an attached solver changed after the "
                             f"refusal: {info}, then {again}")
    costs = graphed_copy_costs(device, A11.shape[0])
    secs = time.perf_counter() - t0
    emit({"phase": "graphed_krylov_path", "seconds": secs, "block": BLOCK,
          "budget_s": GRAPHED_KRYLOV_BUDGET_S, "attached_refusal": refused,
          "linalg_library": str(torch.backends.cuda.preferred_linalg_library())})
    if secs > GRAPHED_KRYLOV_BUDGET_S:
        raise AssertionError(f"phase 25b took {secs:.1f} s, over its {GRAPHED_KRYLOV_BUDGET_S} s")
    return costs


# -- the eigen path ----------------------------------------------------------
# refined eigenvalues against the analytic spectrum at nx=216: the JAX
# package recorded 2.7e-5 to 1.4e-4 relative after its own refinement step
# (benchmarks/eigen3d.py --inverse-step)
REFINE_EIG_RTOL = 1e-4
# the FEM pencil's f64 Rayleigh quotients against the analytic spectrum
# (the JAX package's record: 8.5e-8 for mu_1, 2.8e-8 and 8.2e-8 for mu_2)
FEM_RTOL = 1e-5
# inverse Lanczos on the 1M-row mesh: lambda_1 is the shift 1e-3 (the
# Laplacian's constant null vector) and the f32 Ritz residual norms (the
# JAX package's record: 5e-5 to 3e-4)
INVLANCZOS_LAMBDA1_RTOL = 1e-3
INVLANCZOS_RESIDUAL = 1e-3
# shift-invert Lanczos there: tests/test_eigensolver.py holds its residuals
# to 1e-9 (the JAX package reached 1.9e-12 to 1.0e-11 at this size)
SHIFT_INVERT_RESIDUAL = 1e-9
SHIFT_INVERT_LAMBDA1_RTOL = 1e-6


def _counted_solver(solver):
    """A solver object that runs ``solver`` and records each solve's
    iteration count and convergence in ``.runs``."""
    from sigma_tpu_torch import LinearSolver

    class Counted(LinearSolver):
        def __init__(self):
            self.runs = []

        def solve_info(self, A, b, x0=None, M=None):
            x, info = solver.solve_info(A, b, x0=x0, M=M)
            self.runs.append((info.iterations, info.converged))
            return x, info

    return Counted()


def _inner_totals(runs):
    return {"inner_solves": len(runs), "inner_iterations": sum(r[0] for r in runs),
            "inner_unconverged": sum(not r[1] for r in runs)}


def phase_refine_stencil(device, nx, V, M):
    """benchmarks/eigen3d.py --inverse-step: ``refine_eigenpairs`` with
    defaults (3 sweeps of inner rtol 1e-6, maxiter 300, f32 inner
    GMG-CG) on phase 12's f32 LOBPCG block and hierarchy over the f64
    Dirichlet Poisson stencil, against the analytic spectrum; the inner
    iterations are counted from the V-cycles (one a CG iteration, one more
    a solve)."""
    import numpy as np
    import torch

    from sigma_tpu_torch import MatvecOperator, laplacian_3d_dia
    from sigma_tpu_torch.eigen import refine_eigenpairs

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A64 = laplacian_3d_dia(nx, torch.float64, device, diag=6.0)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    vcycles = []

    def cycle(M_, r):
        vcycles.append(1)
        return M_.matvec(r)

    Mc = MatvecOperator(params=M, mv=cycle, rmv=None, shape=M.shape)
    m = V.shape[1]
    exact = analytic_lowest(nx, m)
    ref, warm = _timed(lambda: (vcycles.clear(), refine_eigenpairs(A64, V, M_lo=Mc))[1])
    sweeps, solves = 3, 3 * m
    cycles = len(vcycles)  # the warm run's
    lam, before = ref.eigenvalues, ref.rayleigh_before
    rel, rel_before = np.abs(lam - exact) / exact, np.abs(before - exact) / exact
    Vr = ref.eigenvectors
    resid = torch.linalg.vector_norm(A64.matmat(Vr) - Vr * torch.from_numpy(lam).to(device),
                                     dim=0).cpu().numpy()
    emit({"phase": "eigen", "solve": "refine_stencil", "n": A64.shape[0], "m": m,
          "sweeps": sweeps, "inner_solves": solves, "inner_iterations": cycles - solves,
          "eigenvalues": lam.tolist(), "rayleigh_before": before.tolist(),
          "analytic": exact.tolist(), "rel_err": rel.tolist(),
          "rel_err_before": rel_before.tolist(), "residual_norms": resid.tolist(),
          "tolerance": REFINE_EIG_RTOL, "setup_s": setup, "wall_s_warm": warm})
    if not (np.isfinite(lam).all() and (rel <= rel_before).all()
            and rel.max() <= REFINE_EIG_RTOL):
        raise AssertionError(f"refine_eigenpairs: rel err {rel} (input block {rel_before})")


def phase_geneigen_fem3d(device, nx=102, k=30, want=3):
    """benchmarks/geneigen3d.py defaults: the 27-point Q1 pencil at nx=102
    (1,061,208 rows), inverse generalized Lanczos on (M, K) with K solved
    by structured-GMG-CG to a relative 1e-7 (M is h^3-scaled), then the
    f64 Rayleigh quotients v'Kv / v'Mv of the top Ritz vectors on the card,
    against the analytic generalized spectrum."""
    import numpy as np
    import torch

    from sigma_tpu_torch import attach_solver, cg, generalized_lanczos, structured_pair_amg
    from sigma_tpu_torch.fem import (
        fem3d_generalized_spectrum, fem3d_pencil_dia, fem3d_stiffness_mass_dia,
    )

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrays = fem3d_stiffness_mass_dia(nx)
    K, M = fem3d_pencil_dia(*arrays, dtype=torch.float32, device=device)
    K64, M64 = fem3d_pencil_dia(*arrays, dtype=torch.float64, device=device)
    del arrays
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    t0 = time.perf_counter()
    Mg = structured_pair_amg(K, (nx, nx, nx), coarse_size=4096)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    n = K.shape[0]
    solver = _counted_solver(cg(tolerance=0.0, rtol=1e-7))
    Ks = attach_solver(K, solver, preconditioner=Mg)
    v0 = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32)).to(device)
    res, warm = _timed(lambda: (solver.runs.clear(), generalized_lanczos(M, Ks, k, v0))[1])
    runs = solver.runs
    theta, Q = np.linalg.eigh(res.tridiagonal().double().cpu().numpy())
    order = np.argsort(theta)[::-1][:want]
    mu_ritz, mu64 = [], []
    for j in order:
        v = (res.V @ torch.from_numpy(Q[:, j]).to(device, torch.float32)).double()
        mu_ritz.append(1.0 / float(theta[j]))
        mu64.append(float(torch.dot(v, K64.matvec(v)) / torch.dot(v, M64.matvec(v))))
    mu64, mu_ritz = np.sort(mu64), np.sort(mu_ritz)
    exact = fem3d_generalized_spectrum(nx, 10)
    nearest = np.array([exact[np.argmin(np.abs(exact - mu))] for mu in mu64])
    rel_nearest = np.abs(mu64 - nearest) / nearest
    rel_mu1 = abs(mu64[0] - exact[0]) / exact[0]
    emit({"phase": "eigen", "solve": "geneigen_fem3d", "n": n, "lanczos_steps": k,
          "levels": len(Mg.levels) + 1, **_inner_totals(runs),
          "mu_refined_f64": mu64.tolist(), "mu_ritz_f32": mu_ritz.tolist(),
          "mu_exact": exact[:want].tolist(), "nearest_exact": nearest.tolist(),
          "rel_err_nearest": rel_nearest.tolist(), "rel_err_mu1": rel_mu1,
          "tolerance": FEM_RTOL, "build_s": build, "setup_s": setup, "wall_s_warm": warm})
    if not (np.isfinite(mu64).all() and rel_mu1 <= FEM_RTOL and rel_nearest.max() <= FEM_RTOL):
        raise AssertionError(f"FEM pencil: mu {mu64}, nearest exact {nearest}")


def phase_inverse_lanczos_mesh(device, U, lobpcg_eigs, k=24):
    """benchmarks/eigen_unstructured.py:113-153 on phase 15's 1M-row mesh:
    generalized Lanczos on the pencil (I, P) with P solved by pruned-GMG-CG
    to a relative 1e-7, so the Krylov space targets the lowest eigenvalues
    (pencil values 1/theta), then the Rayleigh quotients and residual norms
    of the top Ritz vectors (f64 vectors, f32 matvec).  Returns the lowest
    pencil value."""
    import numpy as np
    import torch

    from sigma_tpu_torch import IdentityOperator, attach_solver, cg, generalized_lanczos

    P, Mg, n = U["P"], U["Mf"], U["n"]
    solver = _counted_solver(cg(tolerance=0.0, rtol=1e-7))
    Ps = attach_solver(P, solver, preconditioner=Mg)
    v0 = torch.from_numpy(U["rng"].standard_normal(n).astype(np.float32)).to(device)
    res, warm = _timed(lambda: (solver.runs.clear(),
                                generalized_lanczos(IdentityOperator(n=n), Ps, k, v0))[1])
    runs = solver.runs
    theta, Q = np.linalg.eigh(res.tridiagonal().double().cpu().numpy())
    mus = np.sort(1.0 / theta[theta > 0])[:3]
    V64 = res.V.double()
    rq, resid = [], []
    for j in np.argsort(-theta)[:3]:
        v = V64 @ torch.from_numpy(Q[:, j]).to(device)
        v = v / torch.linalg.vector_norm(v)
        Av = P.matvec(v.float()).double()
        lam = float(torch.dot(v, Av))
        rq.append(lam)
        resid.append(float(torch.linalg.vector_norm(Av - lam * v)))
    lam1_err = abs(mus[0] - MESH_SHIFT) / MESH_SHIFT
    vs_lobpcg = np.abs(mus - lobpcg_eigs[:3]) / lobpcg_eigs[:3]
    emit({"phase": "eigen", "solve": "inverse_lanczos_mesh", "n": n, "lanczos_steps": k,
          **_inner_totals(runs), "lowest3_pencil": mus.tolist(), "lowest3_rayleigh": rq,
          "residual_norms": resid, "lambda1_rel_err_vs_shift": lam1_err,
          "lobpcg_phase15": lobpcg_eigs[:3].tolist(), "vs_lobpcg_rel": vs_lobpcg.tolist(),
          "within_lobpcg_storage_rtol": bool(vs_lobpcg.max() <= LOBPCG_STORAGE_RTOL),
          "tolerances": {"lambda1": INVLANCZOS_LAMBDA1_RTOL, "residual": INVLANCZOS_RESIDUAL,
                         "vs_lobpcg": LOBPCG_STORAGE_RTOL},
          "wall_s_warm": warm})
    if not (np.isfinite(mus).all() and lam1_err <= INVLANCZOS_LAMBDA1_RTOL
            and max(resid) <= INVLANCZOS_RESIDUAL):
        raise AssertionError(f"inverse Lanczos: lambda_1 err {lam1_err:.3e}, residuals {resid}")
    return float(mus[0])


def shifted_mesh(device, U, sigma):
    """``U``'s f32 operator shifted by ``-sigma I`` in full pruned storage
    (tile 16384, group 8): the operator of shift-invert's inner solves."""
    import numpy as np

    from sigma_tpu_torch import PrunedDIAMatrix

    n, pr, pc = U["n"], U["pr"], U["pc"]
    vals_sig = U["vals"].astype(np.float64)
    vals_sig[pr == pc] -= sigma
    return PrunedDIAMatrix.from_coo(n, n, pr, pc, vals_sig.astype(np.float32), tile_rows=16384,
                                    group=8, assume_unique=True, device=device)


def phase_shift_invert_mesh(device, U, mu1, k=84, k_check=4):
    """eigen_unstructured.py --refine: shift-invert Lanczos at sigma =
    0.9 mu_1 (phase 28's lowest pencil value) on the 1M-row mesh, its f64
    recurrence, basis and CSR matvecs on the card, each resolvent applied
    by 3 ladder sweeps of f32 pruned-GMG-CG (rtol 1e-6, maxiter 400) over
    the shifted f32 operator with phase 15's unshifted hierarchy, as the
    JAX package's jitted inner solve: one ``graphed(cg_solve)`` for every
    inner solve, which captures on its first call and replays after.
    First ``k_check`` steps with the eager inner solve and with the graphed
    one, which must agree bit for bit (eigenvalues, residuals, every inner
    solve's count); then ``k`` steps through the graphed inner solve, run
    once."""
    import numpy as np
    import torch

    from sigma_tpu_torch import cg_solve, graphed
    from sigma_tpu_torch.eigen import shift_invert_lanczos

    n, pr, pc, Mg = U["n"], U["pr"], U["pc"], U["Mf"]
    vals64 = U["vals"].astype(np.float64)
    sigma = 0.9 * mu1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P_sig = shifted_mesh(device, U, sigma)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    G = graphed(cg_solve)
    kw = dict(tol=0.0, rtol=1e-6, maxiter=400, M=Mg)

    def lanczos(steps, solve):
        """Shift-invert Lanczos of ``steps`` steps, each inner solve by
        ``solve``: the result, its wall seconds, each inner solve's
        (iterations, converged), the inner solves' seconds and host reads
        (eager: a read an iteration and two more) and the captures."""
        out = {"runs": [], "inner_s": 0.0, "host_reads": 0, "captures": 0}

        def inner(r32):
            torch.cuda.synchronize()
            t = time.perf_counter()
            x, info = solve(P_sig, r32, **kw)
            torch.cuda.synchronize()
            out["inner_s"] += time.perf_counter() - t
            out["runs"].append((info.iterations, info.converged))
            graph = solve is G
            out["host_reads"] += G.host_reads if graph else info.iterations + 2
            out["captures"] += graph and G.captured
            return x

        torch.cuda.synchronize()
        t = time.perf_counter()
        out["res"] = shift_invert_lanczos(n, pr, pc, vals64, sigma=sigma, m=3, k=steps,
                                          sweeps=3, inner_solve=inner, device=device)
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t
        out["s_per_iteration"] = out["inner_s"] / max(sum(r[0] for r in out["runs"]), 1)
        return out

    eager, check = lanczos(k_check, cg_solve), lanczos(k_check, G)
    a, b = check["res"], eager["res"]
    same = {"eigenvalues": np.array_equal(a.eigenvalues, b.eigenvalues),
            "residuals": np.array_equal(a.residuals, b.residuals),
            "steps": a.steps == b.steps, "inner_counts": check["runs"] == eager["runs"]}
    emit({"phase": "eigen", "solve": "shift_invert_mesh_graphed_check", "n": n, "sigma": sigma,
          "lanczos_steps": a.steps, **_inner_totals(check["runs"]), "bitwise_equal": same,
          "capture_s": G.capture_seconds,
          **{label: {k: r[k] for k in ("wall_s", "inner_s", "s_per_iteration", "host_reads",
                                       "captures")}
             for label, r in (("eager", eager), ("graphed", check))}})
    if not all(same.values()) or check["captures"] != 1:
        raise AssertionError(f"shift-invert Lanczos, eager and graphed inner solves: {same}, "
                             f"{check['captures']} captures")
    run = lanczos(k, G)
    res, wall, inner_s, captures = run["res"], run["wall_s"], run["inner_s"], run["captures"]
    lam, resid = res.eigenvalues, res.residuals
    lam1_err = abs(lam[0] - MESH_SHIFT) / MESH_SHIFT
    emit({"phase": "eigen", "solve": "shift_invert_mesh", "n": n, "sigma": sigma,
          "inner": "graphed(cg_solve)", "lanczos_steps": res.steps, **_inner_totals(run["runs"]),
          "eigenvalues": lam.tolist(), "ritz_residuals": resid.tolist(),
          "lambda1_rel_err_vs_shift": lam1_err, "basis_f64_bytes": k * n * 8,
          "tolerances": {"residual": SHIFT_INVERT_RESIDUAL, "lambda1": SHIFT_INVERT_LAMBDA1_RTOL},
          "setup_s": setup, "wall_s_cold": wall, "inner_solve_s": inner_s,
          "recurrence_s": wall - inner_s, "host_reads": run["host_reads"], "captures": captures,
          "inner_s_per_iteration": run["s_per_iteration"],
          "eager_inner_s_per_iteration": eager["s_per_iteration"]})
    if not (np.isfinite(lam).all() and resid.max() <= SHIFT_INVERT_RESIDUAL
            and lam1_err <= SHIFT_INVERT_LAMBDA1_RTOL):
        raise AssertionError(f"shift-invert Lanczos: residuals {resid}, lambda_1 err {lam1_err:.3e}")
    if captures:
        raise AssertionError(f"the graphed inner solve captured {captures} times more")


# -- the preconditioner comparison and the generic AMG ----------------------
# benchmarks/ildu3d.py's configuration: the 7-point Laplacian + I at nx=100
# (1,000,000 rows, 6,940,000 nonzeros), f32 PCG to rtol 1e-6, maxiter 200.
# The JAX package's recorded iteration counts there (one TPU v5e chip:
# BENCHMARKS.md:410-430; its wall times are not the port's)
JAX_ILDU3D_COUNTS = {"jacobi": 18, "chebyshev4": 9, "gmg": 8, "ildu0": 6}
PRECOND_RTOL = 1e-6
# an ILDU apply on the card against the same operator moved to the CPU
# (f32; the sweeps' few-term row sums may add in another order)
ILDU_CPU_RTOL = 1e-5
# the algebra's device plans against its host products (f64)
PLAN_RTOL = 1e-12


def _ildu_row(label, M, A, b, extra, setup):
    """One preconditioner row of phase 30: PCG on the DIA operator A with M,
    its apply's CUDA-event time and the recomputed true residual."""
    import torch

    from sigma_tpu_torch import cg_solve

    flexible = label == "chebyshev4"
    apply_ms = median_ms(lambda: M.matvec(b), reps=10, warmup=2)
    (x, info), warm = _timed(lambda: cg_solve(A, b, tol=0.0, rtol=PRECOND_RTOL, maxiter=200, M=M,
                                              flexible=flexible))
    rel = _true_rel_residual(A, b, x)
    row = {"phase": "ildu3d", "run": label, "n": A.shape[0], **extra,
           "iterations": info.iterations, "tpu_iterations": JAX_ILDU3D_COUNTS.get(label),
           "converged": info.converged, "relative_residual": rel, "apply_ms": apply_ms,
           "setup_s": setup, "wall_s_warm": warm,
           "s_per_iteration": warm / max(info.iterations, 1)}
    emit(row)
    _check_solve(label, info, rel, PRECOND_RTOL)
    del x
    torch.cuda.empty_cache()
    return row


def _ildu_checks(label, M):
    """An ILDU operator's matvec and rmatvec on the card: twice for equal
    bits, and against the same operator moved to the CPU."""
    import torch

    r = torch.sin(torch.arange(M.shape[0], dtype=torch.float32, device=M.dinv.device) * 0.37)
    cpu = M.to("cpu")
    out = {}
    for name in ("matvec", "rmatvec"):
        y, y2 = getattr(M, name)(r), getattr(M, name)(r)
        if not torch.equal(y, y2):
            raise AssertionError(f"{label}: two {name} applies on the card differ")
        out[name] = rel_err(y.cpu(), getattr(cpu, name)(r.cpu()))
        if not out[name] <= ILDU_CPU_RTOL:
            raise AssertionError(f"{label}: {name} on the card vs the CPU {out[name]:.3e}")
    out["rmatvec_ms"] = median_ms(lambda: M.rmatvec(r), reps=5, warmup=1)
    return out


def _timed_setup(make):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    M = make()
    torch.cuda.synchronize()
    return M, time.perf_counter() - t0


def phase_ildu3d(device, nx=100):
    """benchmarks/ildu3d.py at its default nx=100: 1M rows of 7-point
    Laplacian + I in f32 DIA storage, b = A x*, x*_i = sin(0.001 i), PCG to
    rtol 1e-6 (maxiter 200) on the DIA operator with Jacobi, Chebyshev(4)
    (lmax 13, lmin 0.4, flexible CG), structured GMG (coarse_size 4096),
    ILDU(0) set up on the operator's CSR copy (its nonzeros), ILU(1), and
    ILDU(0) after a greedy colour ordering (factored on the reordered CSR
    copy and applied through the permutation, so this PCG too runs on the
    DIA operator).  Returns the operator and the ILDU operators."""
    import numpy as np
    import torch

    from sigma_tpu_torch import (
        CSRMatrix, MatvecOperator, chebyshev, greedy_color_ordering, jacobi, laplacian_3d_dia,
        ldu, structured_pair_amg,
    )

    A = laplacian_3d_dia(nx, torch.float32, device)
    n = A.shape[0]
    xstar = torch.sin(torch.arange(n, dtype=torch.float32, device=device) * 0.001)
    b = A.matvec(xstar)
    r, c, v = A.entries()
    keep = v != 0
    r, c, v = r[keep], c[keep], v[keep]
    Acsr, csr_s = _timed_setup(lambda: CSRMatrix.from_coo(n, n, r, c, v, dtype=torch.float32,
                                                           device=device))
    if Acsr.nnz != 7 * n - 6 * nx * nx:
        raise AssertionError(f"the CSR copy holds {Acsr.nnz} nonzeros")
    emit({"phase": "ildu3d_setup", "n": n, "nnz": Acsr.nnz, "csr_copy_s": csr_s})

    rows, ildu = {}, {}
    M, s = _timed_setup(lambda: jacobi().setup(A))
    rows["jacobi"] = _ildu_row("jacobi", M, A, b, {}, s)
    M, s = _timed_setup(lambda: chebyshev(A, degree=4, lmax=13.0, lmin=0.4))
    rows["chebyshev4"] = _ildu_row("chebyshev4", M, A, b, {"flexible": True}, s)
    M, s = _timed_setup(lambda: structured_pair_amg(A, (nx, nx, nx), coarse_size=4096))
    rows["gmg"] = _ildu_row("gmg", M, A, b, {"levels": len(M.levels) + 1}, s)
    del M
    for label, level in (("ildu0", 0), ("ilu1", 1)):
        M, s = _timed_setup(lambda: ldu(level=level).setup(Acsr))
        ildu[label] = M
        rows[label] = _ildu_row(label, M, A, b, {
            "levels_fwd_bwd": [M.lower.nlev, M.upper.nlev],
            # stored strict entries (a pad slot points at its own row) + D
            "factor_nnz": n + sum(int((T.cols != T.rows[:, None]).sum())
                                  for T in (M.lower, M.upper)),
        }, s)
    if [ildu["ildu0"].lower.nlev, ildu["ildu0"].upper.nlev] != [3 * nx - 2, 3 * nx - 2]:
        raise AssertionError(f"ILDU(0) levels {ildu['ildu0'].lower.nlev}, "
                             f"{ildu['ildu0'].upper.nlev}, want {3 * nx - 2} each")

    def colored():
        p, ptr = greedy_color_ordering(Acsr.graph)
        Ap = CSRMatrix.from_coo(n, n, p[r], p[c], v, dtype=torch.float32, device=device)
        pt = torch.from_numpy(p).to(device)
        inv = torch.argsort(pt)
        Mc = ldu().setup(Ap)
        # M = P^T Mc P: r in new labels is r[inv], z back in old labels z[p]
        return MatvecOperator(params=(Mc, pt, inv), mv=lambda q, x: q[0].matvec(x[q[2]])[q[1]],
                              rmv=lambda q, x: q[0].rmatvec(x[q[2]])[q[1]],
                              shape=A.shape), ptr.size - 1

    (Mp, colours), s = _timed_setup(colored)
    Mc = Mp.params[0]
    ildu["ildu0_colored"] = Mc
    rows["ildu0_colored"] = _ildu_row("ildu0_colored", Mp, A, b, {
        "colours": colours, "levels_fwd_bwd": [Mc.lower.nlev, Mc.upper.nlev],
    }, s)
    if colours != 2 or [Mc.lower.nlev, Mc.upper.nlev] != [2, 2]:
        raise AssertionError(f"colour ordering: {colours} colours, levels "
                             f"{Mc.lower.nlev} + {Mc.upper.nlev}, want 2 and 2 + 2")
    if rows["ildu0"]["iterations"] != JAX_ILDU3D_COUNTS["ildu0"]:
        raise AssertionError(f"PCG + ILDU(0) took {rows['ildu0']['iterations']} iterations, "
                             f"the JAX package's {JAX_ILDU3D_COUNTS['ildu0']}")
    checks = {label: _ildu_checks(label, M) for label, M in ildu.items()}
    emit({"phase": "ildu3d_checks", "vs_cpu_rel_err_and_rmatvec_ms": checks,
          "tolerance": ILDU_CPU_RTOL, "bitwise_repeat": True})
    fastest = min(rows, key=lambda k: rows[k]["wall_s_warm"])
    emit({"phase": "ildu3d", "fastest": fastest,
          "wall_s_warm": {k: rw["wall_s_warm"] for k, rw in rows.items()}})
    # the preconditioners as PCG takes them: the colour-ordered one through
    # its permutation
    return A, b, ildu, {"ildu0": ildu["ildu0"], "ilu1": ildu["ilu1"], "ildu0_colored": Mp}


# the level sweep against its plain version on the card (f32: the
# ILDU_CPU_RTOL precedent; f64 rounding)
SWEEP_RTOL = {"torch.float32": 1e-5, "torch.float64": 1e-12}


# a widest level this wide gives the level sweep its co-resident grid
ALL_ROWS = 1 << 40


def _sweep_library(T, b):
    """``torch.triangular_solve`` of (I + T) as sparse CSR on the card
    (cuSPARSE's triangular solve), the library yardstick used nowhere in
    the port: (a callable that repeats it, its x), or (None, the reason)
    where PyTorch refuses that form."""
    import torch

    real = T.cols != T.rows[:, None]  # unused slots point at their own row
    r = torch.cat([T.rows[:, None].expand_as(T.cols)[real], torch.arange(T.n, device=b.device)])
    c = torch.cat([T.cols[real], torch.arange(T.n, device=b.device)])
    v = torch.cat([T.vals[real].to(b.dtype), torch.ones(T.n, dtype=b.dtype, device=b.device)])
    upper = bool((T.cols[real] > T.rows[:, None].expand_as(T.cols)[real]).any())
    csr = csr_from_coo(r, c, v, T.n, T.n)
    try:
        out = torch.triangular_solve(b[:, None], csr, upper=upper).solution[:, 0]
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, f"no library call ({type(e).__name__}: {str(e).splitlines()[0][:120]})"
    return (lambda: torch.triangular_solve(b[:, None], csr, upper=upper)), out


def _chain_levels(nlev, device):
    """A pure chain packed as a level sweep: ``nlev`` one-row levels, row
    i depending on row i - 1 alone (value 0.5; row 0's slot unused), so a
    sweep of it is the dependency latency alone at that depth."""
    import types

    import torch

    rows = torch.arange(nlev, device=device)
    vals = torch.full((nlev, 1), 0.5, dtype=torch.float32, device=device)
    vals[0] = 0.0
    return types.SimpleNamespace(rows=rows, cols=(rows - 1).clamp_min(0)[:, None], vals=vals,
                                 _ptr=torch.arange(nlev + 1, device=device), _max_rows=1,
                                 n=nlev, nlev=nlev)


def level_sweep_checks(device, factors, emit_as="level_sweep_kernel"):
    """The level-sweep kernel (``csrc/ildu_sweep.cu``) against its plain
    version on the card, on each of ``factors`` ({label: ILDU operator,
    both triangular factors taken, or a packed system such as
    :func:`_chain_levels`'s}): values and vector in f32 and in f64, three
    launches (two on the grid sized from the widest level, one on the
    co-resident grid) bit for bit, within ``SWEEP_RTOL``, and bit for bit
    the kernel's arithmetic done in torch on the card, a level at a time
    (``level_sweep_slot_order``: ``slot_order_bitwise``).  Per factor and
    dtype the single-launch time on the sized grid and on the co-resident
    grid (``max_rows = n``), each grid's blocks, the plain version's
    time, ``chain_ms`` and ``coresident_chain_ms`` (a pure chain of
    ``nlev`` one-row levels, each depending on the one before, on each
    grid: the dependency latency alone at the factor's depth, a
    diagnostic of the design and no part of the bound), the bound (bytes:
    rows, the real entries' cols and vals, b, x read once and written
    once, over 3.35 TB/s; operations: a multiply and an add a real entry
    and a subtraction a row) and ``torch.triangular_solve`` on (I + T) in
    sparse CSR where cuSPARSE takes it.  Launches are taken back out of
    the count.  Returns the rows by (label, side, dtype)."""
    import numpy as np
    import torch

    from sigma_tpu_torch.ops import (
        level_sweep, level_sweep_blocks, level_sweep_reference, level_sweep_slot_order,
    )

    out, chains = {}, {}
    with _uncounted(level_sweep):
        for label, M in factors.items():
            sides = (("lower", M.lower), ("upper", M.upper)) if hasattr(M, "lower") else (
                ("chain", M),)
            for side, T in sides:
                if T.nlev not in chains:
                    chains[T.nlev] = _chain_levels(T.nlev, device)
                C = chains[T.nlev]
                for dt in (torch.float32, torch.float64):
                    vals = T.vals.to(dt)
                    b = torch.from_numpy(np.random.default_rng(27).standard_normal(T.n)).to(
                        device, dt)
                    args = (T.rows, T.cols, vals, T._ptr, b)
                    chain = (C.rows, C.cols, C.vals.to(dt), C._ptr, b[:C.n])
                    x = level_sweep(*args, T._max_rows)
                    ref = level_sweep_reference(*args)
                    err = rel_err(x, ref)
                    # a second launch, and one on the co-resident grid
                    bitwise = bool(torch.equal(x, level_sweep(*args, T._max_rows))
                                   and torch.equal(x, level_sweep(*args, ALL_ROWS)))
                    slot_order = bool(torch.equal(x, level_sweep_slot_order(*args)))
                    real = int((T.cols != T.rows[:, None]).sum())
                    xb, vb = b.element_size(), vals.element_size()
                    # rows; the real entries' cols and vals; b; x read once
                    # and written once
                    nbytes = 8 * T.n + real * (8 + vb) + 3 * xb * T.n
                    width = T.cols.shape[1]
                    row = {"phase": emit_as, "factor": label, "side": side, "dtype": str(dt),
                           "n": T.n, "nlev": T.nlev, "width": width,
                           "max_rows": T._max_rows, "entries": real,
                           "blocks": level_sweep_blocks(dt, dt, width, T._max_rows, device),
                           "coresident_blocks": level_sweep_blocks(dt, dt, width, ALL_ROWS,
                                                                   device),
                           "max_rel_err": err,
                           "max_abs_err": float((x.double() - ref.double()).abs().max()),
                           "bitwise_repeat": bitwise, "slot_order_bitwise": slot_order,
                           "kernel_ms": median_ms(lambda: level_sweep(*args, T._max_rows)),
                           "coresident_ms": median_ms(lambda: level_sweep(*args, ALL_ROWS)),
                           "chain_ms": median_ms(lambda: level_sweep(*chain, T._max_rows)),
                           "coresident_chain_ms": median_ms(
                               lambda: level_sweep(*chain, ALL_ROWS)),
                           "plain_ms": median_ms(lambda: level_sweep_reference(*args), reps=3,
                                                 warmup=1)}
                    row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * real + T.n, dt)
                    call, lib = _sweep_library(T, b)
                    if call is None:
                        row["library_ms"], row["library_note"] = None, lib
                    else:
                        row["library_ms"] = median_ms(call, reps=10, warmup=2)
                        row["library_rel_err"] = rel_err(lib, ref)
                    emit(row)
                    if not (bitwise and slot_order and err <= SWEEP_RTOL[str(dt)]):
                        raise AssertionError(f"level sweep {label} {side} {dt}: rel err "
                                             f"{err:.3e}, bitwise repeat {bitwise}, slot "
                                             f"order bitwise {slot_order}")
                    out[(label, side, str(dt))] = row
    return out


# phase 30b's time on the card, seconds: the path fails beyond it
GRAPHED_ILDU_BUDGET_S = 40.0


def phase_graphed_ildu(device, A, b, ops):
    """Phase 30b: phase 30's PCG (benchmarks/ildu3d.py, nx=100, f32, rtol
    1e-6, maxiter 200) with ILDU(0), ILU(1) and the colour-ordered ILDU(0)
    through its permutation, by ``cg_solve`` and ``cg_fused_solve``,
    eagerly and as graphed solves, everything held equal
    (:func:`_graphed_case`: x bit for bit, count, residual norm,
    ``converged``, every kernel's launches), one host read a block; ILDU(0)
    at the JAX package's 6 iterations.  Fails beyond
    ``GRAPHED_ILDU_BUDGET_S``."""
    from sigma_tpu_torch import cg_fused_solve, cg_solve
    from sigma_tpu_torch.solvers.graphed import BLOCK

    t0 = time.perf_counter()
    kw = dict(tol=0.0, rtol=PRECOND_RTOL, maxiter=200)
    rows = {}
    for label, M in ops.items():
        for solve in (cg_solve, cg_fused_solve):
            name = f"{solve.__name__}_{label}"
            rows[name] = _graphed_case(name, solve, A, b, dict(kw, M=M), timed=True,
                                       phase="graphed_ildu")
            if not (rows[name]["converged"] and rows[name]["launches"].get("level_sweep")):
                raise AssertionError(f"graphed {name}: {rows[name]}")
    _check_host_reads("graphed_ildu", rows)
    for solve in ("cg_solve", "cg_fused_solve"):
        if rows[f"{solve}_ildu0"]["iterations"] != JAX_ILDU3D_COUNTS["ildu0"]:
            raise AssertionError(f"graphed {solve} + ILDU(0): {rows[f'{solve}_ildu0']}")
    secs = time.perf_counter() - t0
    emit({"phase": "graphed_ildu_path", "seconds": secs, "block": BLOCK,
          "budget_s": GRAPHED_ILDU_BUDGET_S})
    if secs > GRAPHED_ILDU_BUDGET_S:
        raise AssertionError(f"phase 30b took {secs:.1f} s, over its {GRAPHED_ILDU_BUDGET_S} s")
    return rows


def _timed_call(split, key, fn):
    """``fn`` timed (device synchronised) into ``split[key]`` at each call."""
    def run(*args, **kw):
        import torch

        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        split[key] = split.get(key, 0.0) + time.perf_counter() - t0
        return out
    return run


@contextlib.contextmanager
def _timed_steps(module, steps, split):
    """While active, each function ``name`` of ``module`` in ``steps`` is
    timed in place into ``split[steps[name]]``."""
    saved = {name: getattr(module, name) for name in steps}
    try:
        for name, key in steps.items():
            setattr(module, name, _timed_call(split, key, saved[name]))
        yield split
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def _amg_setup_split(A, aggregate):
    """``smoothed_aggregation_amg(A, aggregate=aggregate)`` and its set-up
    seconds split into aggregation, prolongator smoothing, PtAP, the
    coarse inverse and the rest (tentative P, the diagonal read), by timing
    the module's steps in place for this one call."""
    from sigma_tpu_torch.solvers import amg

    split = dict.fromkeys(("aggregation", "prolongator_smoothing", "ptap", "coarse_inverse"), 0.0)
    steps = {"_smoothed_prolongator": "prolongator_smoothing", "ptap": "ptap",
             "_coarse_inverse": "coarse_inverse"}
    with _timed_steps(amg, steps, split):
        M, total = _timed_setup(lambda: amg.smoothed_aggregation_amg(
            A, aggregate=_timed_call(split, "aggregation", aggregate)))
    split = {f"{k}_s": v for k, v in split.items()}
    split["other_s"] = total - sum(split.values())
    return M, total, split


def _amg_rows(label, A, b, aggregate, poisson, stationary):
    """Phase 31's rows for one hierarchy: set-up split, levels, strict
    coarsening, plain CG and CG + AMG (rtol 1e-6), ``amg_solve`` to
    1e-6 ||b||, the V-cycle's apply time and two V-cycles bit for bit."""
    import torch

    from sigma_tpu_torch import amg_solve, cg_solve

    M, total, split = _amg_setup_split(A, aggregate)
    levels = [[lvl.A.shape[0], lvl.A.nnz] for lvl in M.levels] + [[M.coarse_inv.shape[0], None]]
    for lvl in M.levels:
        if not lvl.P.shape[1] < lvl.P.shape[0]:
            raise AssertionError(f"{label}: a level does not coarsen: P {lvl.P.shape}")
    z = M.matvec(b)
    if not torch.equal(z, M.matvec(b)):
        raise AssertionError(f"{label}: two V-cycles on the card differ")
    vcycle_ms = median_ms(lambda: M.matvec(b), reps=10, warmup=2)
    (_, plain), _ = _timed(lambda: cg_solve(A, b, tol=0.0, rtol=PRECOND_RTOL, maxiter=2000))
    (x, info), warm = _timed(lambda: cg_solve(A, b, tol=0.0, rtol=PRECOND_RTOL, maxiter=200, M=M))
    rel = _true_rel_residual(A, b, x)
    row = {"phase": "amg", "run": label, "n": A.shape[0], "nnz": A.nnz, "setup_s": total, **split,
           "levels_rows_nnz": levels, "vcycle_ms": vcycle_ms, "plain_cg_iterations":
           plain.iterations, "iterations": info.iterations, "converged": info.converged,
           "relative_residual": rel, "wall_s_warm": warm,
           "s_per_iteration": warm / max(info.iterations, 1)}
    _check_solve(label, info, rel, PRECOND_RTOL)
    # the quarter holds where plain CG is slow: on pure Poisson (on
    # Laplacian + I, condition number ~13, plain CG takes ~20 iterations)
    limit = 0.25 if poisson else 1.0
    if not info.iterations <= limit * plain.iterations or info.iterations >= plain.iterations:
        raise AssertionError(f"{label}: CG + AMG {info.iterations} iterations, plain CG "
                             f"{plain.iterations}")
    if stationary:
        tol = PRECOND_RTOL * float(torch.linalg.vector_norm(b))
        (x, st_info), st_warm = _timed(lambda: amg_solve(A, b, M, tol=tol, maxiter=200))
        st_rel = _true_rel_residual(A, b, x)
        row.update(amg_solve_iterations=st_info.iterations, amg_solve_converged=st_info.converged,
                   amg_solve_relative_residual=st_rel, amg_solve_wall_s_warm=st_warm)
        if not st_info.converged:
            raise AssertionError(f"{label}: amg_solve did not converge: {st_info}")
    emit(row)
    return M


def _plan_check(device, nx=32):
    """The algebra's device half against its host half: on the f64 CSR
    Laplacian + I at nx^3 with P the first smoothed prolongator of its
    greedy hierarchy, plan_ptap(A, P)(A, P) against ptap(A, P),
    plan_sparse_matmul against sparse_matmul (A P), and plan_sparse_add
    against sparse_add (P - 2/3 A P, beta a tensor); each plan's CUDA-event
    time beside the host product's seconds."""
    import torch

    from sigma_tpu_torch import (
        CSRMatrix, laplacian_3d_dia, plan_ptap, plan_sparse_add, plan_sparse_matmul, ptap,
        smoothed_aggregation_amg, sparse_add, sparse_matmul,
    )

    r, c, v = laplacian_3d_dia(nx, torch.float64, device).entries()
    keep = v != 0
    n = nx ** 3
    A = CSRMatrix.from_coo(n, n, r[keep], c[keep], v[keep], dtype=torch.float64, device=device)
    P = smoothed_aggregation_amg(A).levels[0].P
    AP = sparse_matmul(A, P)
    beta = torch.tensor(-2.0 / 3.0, dtype=torch.float64, device=device)
    cases = {
        "ptap": (lambda: ptap(A, P), lambda: plan_ptap(A, P), lambda pl: pl(A, P)),
        "sparse_matmul": (lambda: sparse_matmul(A, P), lambda: plan_sparse_matmul(A, P),
                          lambda pl: pl(A, P)),
        "sparse_add": (lambda: sparse_add(P, AP, 1.0, -2.0 / 3.0),
                       lambda: plan_sparse_add(P, AP), lambda pl: pl(P, AP, 1.0, beta)),
    }
    out = {}
    for name, (host, make, run) in cases.items():
        want, host_s = _timed_setup(host)
        plan, plan_s = _timed_setup(make)
        got = run(plan)
        if not (got.nnz == want.nnz and (got.graph.indptr == want.graph.indptr).all()
                and (got.graph.indices == want.graph.indices).all()):
            raise AssertionError(f"{name}: the plan's sparsity differs from the host product's")
        err = rel_err(got.data, want.data)
        out[name] = {"rel_err": err, "nnz": want.nnz, "host_s": host_s, "plan_setup_s": plan_s,
                     "plan_ms": median_ms(lambda: run(plan), reps=10, warmup=2),
                     "bitwise_repeat": bool(torch.equal(run(plan).data, got.data))}
        if not (err <= PLAN_RTOL and out[name]["bitwise_repeat"]):
            raise AssertionError(f"{name}: plan vs host {err:.3e}, {out[name]}")
    emit({"phase": "amg_plan_check", "n": n, "P_shape": list(P.shape), "checks": out,
          "tolerance": PLAN_RTOL})


def phase_amg(device, A, nx_greedy=64):
    """The generic smoothed-aggregation AMG: the VMB hierarchy on phase
    30's 1M-row DIA operator (its level 0 smooths with #1) and the default
    greedy hierarchy on benchmarks/amg_setup_probe.py's CSR f32 Laplacian +
    I at nx=64 (262,144 rows), each with ``amg_solve`` on the VMB one; each
    also on pure Poisson at the same size, where plain CG is slow enough to
    hold CG + AMG to a quarter of its iterations; then the plan check."""
    import torch

    from sigma_tpu_torch import CSRMatrix, laplacian_3d_dia
    from sigma_tpu_torch.solvers import greedy_aggregate, vmb_aggregate

    nx = round(A.shape[0] ** (1 / 3))
    for label, diag in (("vmb", 7.0), ("vmb_poisson", 6.0)):
        Ad = A if diag == 7.0 else laplacian_3d_dia(nx, torch.float32, device, diag=diag)
        xstar = torch.sin(torch.arange(Ad.shape[0], dtype=torch.float32, device=device) * 0.001)
        _amg_rows(label, Ad, Ad.matvec(xstar), vmb_aggregate, diag == 6.0, diag == 7.0)
    for label, diag in (("greedy", 7.0), ("greedy_poisson", 6.0)):
        r, c, v = laplacian_3d_dia(nx_greedy, torch.float32, device, diag=diag).entries()
        keep = v != 0
        n = nx_greedy ** 3
        Ac = CSRMatrix.from_coo(n, n, r[keep], c[keep], v[keep], dtype=torch.float32,
                                device=device)
        xstar = torch.sin(torch.arange(n, dtype=torch.float32, device=device) * 0.001)
        _amg_rows(label, Ac, Ac.matvec(xstar), greedy_aggregate, diag == 6.0, False)
    _plan_check(device)


# device ops an ILDU matvec may run: two level sweeps and the scale (a few
# more allowed for the profiler's own copies)
ILDU_TRACE_OPS = 8


def phase_ildu_trace(b, ildu):
    """One matvec of each ILDU operator under torch.profiler: the kernels
    and copies it launches and their device time against its wall (after
    every timing of the path: a traced run can leave the profiler's hooks
    behind; tracing the rmatvecs too, ~29,000 more events, took ~30 s)."""
    import torch
    from torch.autograd import DeviceType

    out = {}
    for label, M in ildu.items():
        M.matvec(b)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            M.matvec(b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        if not ev:
            raise RuntimeError(f"{label}: the profiler recorded no device time")
        busy, end = 0.0, float("-inf")
        for s, e in ev:
            if e > end:
                busy += e - max(s, end)
                end = e
        out[label] = {"levels": M.lower.nlev + M.upper.nlev, "device_ops": len(ev),
                      "device_busy_ms": busy / 1e3, "traced_wall_ms": wall * 1e3}
    emit({"phase": "ildu_trace", "matvec": out, "device_ops_limit": ILDU_TRACE_OPS})
    # two sweep launches and the scale by dinv (no longer ~5 ops a level)
    for label, row in out.items():
        if row["device_ops"] > ILDU_TRACE_OPS:
            raise AssertionError(f"{label}: an ILDU matvec ran {row['device_ops']} device ops")


# the apps path (phases 32-33): limits from the physics, not tuning
ISING_SIDE = 4096  # torus(4096, 4096): 16,777,216 sites, 2 colours
# Onsager's spontaneous magnetization (1 - sinh(2 beta)^-4)^(1/8) at beta = 0.6
ONSAGER_M_06 = (1.0 - math.sinh(1.2) ** -4) ** 0.125
ISING_M_TOL = 0.005
SAW_SIDE = 512
SAW_WALKERS = 10_000
# the mean trapping length of the self-avoiding walk on the square lattice
# (Hemmer & Hemmer, J. Chem. Phys. 81, 584, 1984); std ~49 a walk, so the
# standard error at 10,000 walkers is ~0.5
SAW_MEAN_LENGTH = 70.7
SAW_MEAN_TOL = 3.0


def phase_ising(device):
    """Phase 32: the multicolour Metropolis Ising model on torus(4096,
    4096) in ELL storage: a cold start at beta = 0.6 for 200 sweeps,
    whose mean magnetization over sweeps 101-200 must be Onsager's 0.97361
    within 0.005, and a hot start at beta = 0.3 (above the critical
    temperature) for 100 sweeps, whose mean over sweeps 51-100 must be
    within 0.005 of 0.  Set-up split into the generator, the colouring and
    the ELL build (timed in place inside ``ising_metropolis``); sweeps/s
    and site updates/s from the sweeps' own seconds."""
    import numpy as np

    from sigma_tpu_torch.apps import ising as ising_mod
    from sigma_tpu_torch.apps import ising_metropolis, torus

    t0 = time.perf_counter()
    g = torus(ISING_SIDE, ISING_SIDE, frmt="ell")
    gen_s = time.perf_counter() - t0
    n = g.shape[0]
    out = {}
    for label, beta, sweeps, hot, seed, window in (("cold_beta0.6", 0.6, 200, False, 0, 100),
                                                   ("hot_beta0.3", 0.3, 100, True, 1, 50)):
        split = {}
        steps = {"greedy_coloring": "colouring", "_ones_ell": "ell_build", "_run": "sweeps"}
        with _timed_steps(ising_mod, steps, split):
            t0 = time.perf_counter()
            res = ising_metropolis(g, beta=beta, sweeps=sweeps, seed=seed, hot_start=hot,
                                   device=device)
            mags = res.magnetization.cpu().numpy()
            wall = time.perf_counter() - t0
        m = float(np.mean(mags[window:]))
        spins = res.spins
        row = {"phase": "ising", "run": label, "sites": n, "colours": res.num_colors,
               "beta": beta, "sweeps": sweeps, "hot_start": hot,
               "setup_s": {"generator": gen_s, "colouring": split["colouring"],
                           "ell_build": split["ell_build"]},
               "sweeps_s": split["sweeps"], "wall_s": wall,
               "sweeps_per_s": sweeps / split["sweeps"],
               "site_updates_per_s": n * sweeps / split["sweeps"],
               f"mean_m_sweeps_{window + 1}_{sweeps}": m, "final_m": float(mags[-1])}
        if label.startswith("cold"):
            row.update(onsager_m=ONSAGER_M_06, error=abs(m - ONSAGER_M_06))
            ok = abs(m - ONSAGER_M_06) <= ISING_M_TOL
        else:
            ok = abs(m) < ISING_M_TOL
        emit(row)
        if not (ok and res.num_colors == 2 and bool(((spins == 1) | (spins == -1)).all())
                and mags.shape == (sweeps,)):
            raise AssertionError(f"ising {label}: mean m {m:.6f}, colours {res.num_colors}")
        out[label] = row
        del res, spins
    return out


def phase_saw(device):
    """Phase 33: 10,000 self-avoiding walks on torus(512, 512) at once (a
    (walkers, n) visited mask of 2.6 GB on the card): the mean trapping
    length must be within 3 of 70.7, every walk at least one step, and the
    histogram must count every walker."""
    import torch

    from sigma_tpu_torch.apps import saw as saw_mod
    from sigma_tpu_torch.apps import self_avoiding_walks, torus

    g = torus(SAW_SIDE, SAW_SIDE, frmt="ell")
    walkers = SAW_WALKERS
    split = {}
    with _timed_steps(saw_mod, {"_run": "walk"}, split):
        t0 = time.perf_counter()
        res = self_avoiding_walks(g, walkers=walkers, seed=0, device=device)
        lengths = res.lengths.cpu().numpy()
        wall = time.perf_counter() - t0
    mean = float(lengths.mean())
    row = {"phase": "saw", "vertices": g.shape[0], "walkers": walkers,
           "visited_mask_bytes": walkers * g.shape[0],
           "steps": int(lengths.max()) + 1,  # the last step finds every walker stuck
           "walk_s": split["walk"], "wall_s": wall, "mean_length": mean,
           "std_length": float(lengths.std()), "max_length": int(lengths.max()),
           "reference_mean": SAW_MEAN_LENGTH, "lengths_dtype": str(res.lengths.dtype)}
    emit(row)
    if not (abs(mean - SAW_MEAN_LENGTH) <= SAW_MEAN_TOL and int(res.histogram.sum()) == walkers
            and int(lengths.min()) >= 1 and res.lengths.device.type == torch.device(device).type
            and res.lengths.dtype == torch.int32):
        raise AssertionError(f"saw: mean length {mean:.3f}, {row}")
    return row


def phase_app_tools():
    """The two command-line drivers once each at their default sizes on
    the card (in-process, CUDA by default): the line formats of the JAX
    package's scripts."""
    import contextlib
    import io
    import re

    from sigma_tpu_torch.tools import ising as ising_tool
    from sigma_tpu_torch.tools import self_avoiding_walk as saw_tool

    out = {}
    for name, tool in (("ising", ising_tool), ("self_avoiding_walk", saw_tool)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            tool.main([])
        lines = buf.getvalue().splitlines()
        out[name] = {"seconds": time.perf_counter() - t0, "lines": len(lines),
                     "first": lines[0], "last": lines[-1]}
    ising_lines = out["ising"]
    if not (ising_lines["lines"] == 21 and re.fullmatch(r"final magnetization: -?\d\.\d{6}",
                                                        ising_lines["last"])):
        raise AssertionError(f"the ising tool's output: {ising_lines}")
    if not re.fullmatch(r"walks: 10000  mean length: \d+\.\d\d  max: \d+",
                        out["self_avoiding_walk"]["first"]):
        raise AssertionError(f"the walk tool's output: {out['self_avoiding_walk']}")
    emit({"phase": "app_tools", **out})


FEM2D_NX = (512, 1024, 2048)
FEM2D_RTOL = 1e-10
FEM2D_MIN_RATIO = 3.5  # O(h^2): 4x per halving of h
IO_DIR = "build/chip_smoke_io"
SUPPORT_NX_MM = 256  # the Matrix Market round trip (text I/O of 29M triples takes minutes)
SUPPORT_NX_CHECKS = 512  # checked_solve and the BlockVector solve
SUPPORT_NX_STENCIL = 216  # spmv_throughput on phase 5's 3-D stencil


def _fem2d_system(device, nx):
    """The unit square's P1 Poisson system at nx in f64 DIA storage:
    stiffness and mass assembled on the card, b = M (2 pi^2 u) for u =
    sin(pi x) sin(pi y), restricted to the interior nodes.  Returns (Aii,
    bi, u, boundary mask, assembly seconds)."""
    import numpy as np
    import torch

    from sigma_tpu_torch import DIAMatrix
    from sigma_tpu_torch.fem import interior_dirichlet, mass_2d, stiffness_2d, unit_square_mesh

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coords, ele = unit_square_mesh(nx)
    K = stiffness_2d(coords, ele, cls=DIAMatrix, dtype=torch.float64, device=device)
    M = mass_2d(coords, ele, cls=DIAMatrix, dtype=torch.float64, device=device)
    xs, ys = coords[:, 0], coords[:, 1]
    u = np.sin(np.pi * xs) * np.sin(np.pi * ys)
    b = M.matvec(torch.from_numpy(2 * np.pi ** 2 * u).to(device))
    bdry = (xs == 0) | (xs == 1) | (ys == 0) | (ys == 1)
    Aii, bi = interior_dirichlet(K, b, bdry)
    torch.cuda.synchronize()
    return Aii, bi, u, bdry, time.perf_counter() - t0


def _fem2d_true_target(A, b, x, iterations):
    """The true relative residual f64 CG can reach on the FEM systems:
    FEM2D_RTOL, which its recursive residual meets, plus the rounding the
    recursion leaves behind, eps sqrt(k) ||A||_inf ||x|| / ||b|| after k
    iterations (errors of size eps ||A|| ||x|| a step, adding up as a
    random walk).  b = M f is O(h^2) a node, so ||x|| / ||b|| grows 4x and
    sqrt(k) ~1.4x per halving of h: the estimate ~5.5x, the readings 1.2x,
    3.3x and then 5.4x as the floor passes FEM2D_RTOL.  The port, the JAX
    package and a textbook CG on scipy's CSR product reach the same true
    residual to 3 digits on the CPU, 0.84 / 0.19 / 0.11 / 0.11 of this at
    nx = 256 / 512 / 1024 / 2048 (``PYTHONPATH=. python
    tests/test_torch_fem2d.py 256 512 1024 2048``), and the card the
    same to 3 digits: rounding in CG, not the card."""
    import torch

    a_inf = float(A.data.abs().sum(0).max())  # padded slots hold 0
    ratio = float(torch.linalg.vector_norm(x) / torch.linalg.vector_norm(b))
    return FEM2D_RTOL + torch.finfo(torch.float64).eps * iterations ** 0.5 * a_inf * ratio


def _check_dia_spmv_f64(A, seed):
    """#1 held against its plain version on a FEM operator's own arrays
    with a random f64 x (relative 1e-12, as phase 2's f64 cases); the
    comparison's launch is taken back out of the path's count."""
    import torch

    from sigma_tpu_torch.ops import dia_spmv, dia_spmv_reference

    n, m = A.shape
    g = torch.Generator(device=A.data.device).manual_seed(seed)
    x = torch.randn(m, generator=g, device=A.data.device, dtype=torch.float64)
    before = dia_spmv.launches
    y = dia_spmv(A.data, x, A.offsets_dev, n, m)
    dia_spmv.launches = before
    ref = dia_spmv_reference(A.data, x, A.offsets_dev, n, m)
    err = {"max_abs_err": float((y - ref).abs().max()), "rel_err": rel_err(y, ref)}
    if not err["rel_err"] <= 1e-12:
        raise AssertionError(f"dia_spmv on the FEM operator, n={n}: {err}")
    return err


def phase_fem2d(device):
    """Phase 34a: the manufactured Poisson solve on unit_square_mesh(nx)
    for nx = 512, 1024, 2048 (4,198,401 nodes), CG to rtol 1e-10 on the
    interior operator (7 diagonals: #1); the max-norm error must fall at
    least 3.5x per halving of h, and gradient_2d of a linear field must be
    exact to 1e-10.  Returns the nx = 2048 system."""
    import numpy as np
    import torch

    from sigma_tpu_torch import cg_solve
    from sigma_tpu_torch.fem import gradient_2d, unit_square_mesh

    errs, out = [], None
    for nx in FEM2D_NX:
        Aii, bi, u, bdry, setup_s = _fem2d_system(device, nx)
        spmv_check = _check_dia_spmv_f64(Aii, nx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = cg_solve(Aii, bi, tol=0.0, rtol=FEM2D_RTOL)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        rel = _true_rel_residual(Aii, bi, x)
        target = _fem2d_true_target(Aii, bi, x, info.iterations)
        full = np.zeros(u.size)
        full[~bdry] = x.cpu().numpy()
        err = float(np.abs(full - u).max())
        errs.append(err)
        emit({"phase": "fem2d", "nx": nx, "nodes": u.size, "interior": Aii.shape[0],
              "offsets": list(Aii.offsets), "iterations": info.iterations,
              "converged": info.converged, "relative_residual": rel,
              "relative_residual_target": target, "max_error": err,
              "error_ratio": errs[-2] / err if len(errs) > 1 else None,
              "assembly_s": setup_s, "solve_s": solve_s,
              "ms_per_iteration": 1e3 * solve_s / max(info.iterations, 1),
              "dia_spmv_f64_check": spmv_check})
        _check_solve(f"fem2d nx={nx}", info, rel, target, limit=1.0)
        out = (Aii, bi)
        del x
    ratios = [a / b for a, b in zip(errs, errs[1:])]
    if not all(r >= FEM2D_MIN_RATIO for r in ratios):
        raise AssertionError(f"fem2d: error ratios {ratios} below {FEM2D_MIN_RATIO}")
    coords, ele = unit_square_mesh(FEM2D_NX[0])
    grad = gradient_2d(coords, ele, 4.0 * coords[:, 0] + 7.0 * coords[:, 1] - 2.0)
    grad_err = float(np.abs(grad - np.array([4.0, 7.0])).max())
    emit({"phase": "fem2d_gradient", "nx": FEM2D_NX[0], "elements": ele.shape[0],
          "max_error": grad_err, "error_ratios": ratios})
    if not grad_err <= 1e-10:
        raise AssertionError(f"gradient_2d of a linear field: error {grad_err:.3e}")
    return out


def phase_support(device, A, b, spmv_row):
    """Phase 34b: the support modules on the card.  I/O: npz of the nx =
    2048 interior operator and Matrix Market at nx = 256 read back bit for
    bit, and a checkpoint of CG stopped at 200 iterations reloaded bit for
    bit and resumed to rtol 1e-10.  Checks: ``checked_solve`` of CG clean,
    and raising FloatingPointError with a NaN among the stored values;
    ``validate_matrix`` of the operator clean, and raising once a padded
    slot is 1.0.  Profiling: ``spmv_throughput`` of the nx = 216 stencil
    (f32) beside phase 5's #1 rate, at most 5% past 3.35 TB/s.  A 2-field
    BlockVector through CG via ``.values``, bitwise the plain solve."""
    import os

    import torch

    from sigma_tpu_torch import (
        BlockVector, cg_solve, checked_solve, laplacian_3d_dia, validate_matrix,
    )
    from sigma_tpu_torch import io as sio
    from sigma_tpu_torch.utils.profiling import spmv_throughput

    os.makedirs(IO_DIR, exist_ok=True)
    row = {"phase": "support", "n": A.shape[0]}
    # npz of the nx = 2048 operator
    path = os.path.join(IO_DIR, "fem2048.npz")
    t0 = time.perf_counter()
    sio.save_matrix_npz(A, path)
    row["npz_save_s"] = time.perf_counter() - t0
    row["npz_bytes"] = os.path.getsize(path)
    t0 = time.perf_counter()
    B = sio.load_matrix_npz(path, device=device)
    row["npz_load_s"] = time.perf_counter() - t0
    if not (B.offsets == A.offsets and B.dtype == A.dtype and torch.equal(B.data, A.data)):
        raise AssertionError("npz round trip of the nx=2048 operator is not bitwise")
    del B
    os.remove(path)
    # Matrix Market at nx = 256
    Am, _, _, _, _ = _fem2d_system(device, SUPPORT_NX_MM)
    path = os.path.join(IO_DIR, "fem256.mtx")
    t0 = time.perf_counter()
    sio.write_matrix_market(Am, path, comment="P1 Poisson, unit square, nx=256, interior")
    Bm = sio.read_matrix_market(path, frmt="dia", dtype=torch.float64, device=device)
    row["mtx_round_trip_s"] = time.perf_counter() - t0
    row["mtx_entries"] = int(Am.entries()[0].size)
    if not (Bm.offsets == Am.offsets and torch.equal(Bm.data, Am.data)):
        raise AssertionError("Matrix Market round trip at nx=256 is not bitwise")
    os.remove(path)
    # checkpoint of CG stopped at 200 iterations, reloaded and resumed
    x200, info200 = cg_solve(A, b, tol=0.0, maxiter=200)
    path = os.path.join(IO_DIR, "cg200.npz")
    sio.save_checkpoint(path, x200, iteration=info200.iterations,
                        residual=float(info200.residual_norm))
    x0, meta, _ = sio.load_checkpoint(path, device=device)
    os.remove(path)
    if not (torch.equal(x0, x200) and meta["iteration"] == 200 and not info200.converged):
        raise AssertionError(f"the checkpoint did not reload bitwise (or CG had converged "
                             f"within 200 iterations): {meta}, {info200}")
    t0 = time.perf_counter()
    x, info = cg_solve(A, b, x0=x0, tol=0.0, rtol=FEM2D_RTOL)
    torch.cuda.synchronize()
    rel = _true_rel_residual(A, b, x)
    target = _fem2d_true_target(A, b, x, info200.iterations + info.iterations)
    row.update(resumed_iterations=info.iterations, resumed_relative_residual=rel,
               resumed_relative_residual_target=target, resume_s=time.perf_counter() - t0)
    _check_solve("resumed CG", info, rel, target, limit=1.0)
    del x, x0, x200
    # float checks and validation
    As, bs, _, _, _ = _fem2d_system(device, SUPPORT_NX_CHECKS)
    t0 = time.perf_counter()
    xs, info = checked_solve(cg_solve, As, bs, tol=0.0, rtol=FEM2D_RTOL)
    row["checked_solve"] = {"n": As.shape[0], "iterations": info.iterations,
                            "seconds": time.perf_counter() - t0}
    xp, _ = cg_solve(As, bs, tol=0.0, rtol=FEM2D_RTOL)
    if not (info.converged and torch.equal(xs, xp)):
        raise AssertionError("checked_solve: not converged, or not the plain solve's result")
    data = As.data.clone()
    data[As.offsets.index(0), 17] = float("nan")
    try:
        checked_solve(cg_solve, As.with_data(data), bs, tol=0.0, rtol=FEM2D_RTOL, maxiter=5)
    except FloatingPointError as e:
        row["checked_solve_nan"] = str(e)
    else:
        raise AssertionError("checked_solve did not raise on a NaN in the matrix")
    t0 = time.perf_counter()
    validate_matrix(A)
    row["validate_s"] = time.perf_counter() - t0
    data = A.data.clone()
    n = A.shape[0]
    data[A.offsets.index(1), n - 1] = 1.0  # A[n-1, n]: outside the matrix
    try:
        validate_matrix(A.with_data(data))
    except ValueError as e:
        row["validate_padded"] = str(e)
    else:
        raise AssertionError("validate_matrix passed a nonzero padded slot")
    del data
    # BlockVector through CG
    k = As.shape[0] // 3
    bv = BlockVector.from_flat(bs, (k, As.shape[0] - k))
    xv, infov = cg_solve(As, bv.values, tol=0.0, rtol=FEM2D_RTOL)
    sol = BlockVector.from_flat(xv, bv.field_sizes)
    if not (bv.values is bs and torch.equal(sol.values, xp) and infov.iterations == info.iterations
            and torch.equal(sol.field(1), xp[k:])):
        raise AssertionError("a BlockVector through CG differs from the plain solve")
    row["block_vector_iterations"] = infov.iterations
    # SpMV throughput of the stencil
    S = laplacian_3d_dia(SUPPORT_NX_STENCIL, torch.float32, device)
    rate = spmv_throughput(S)
    byts = S.data.numel() * S.data.element_size() + 2 * S.shape[0] * 4
    bps = byts * rate / S.nnz
    row.update(spmv_throughput_gnnz_s=rate / 1e9, spmv_throughput_bytes_per_s=bps,
               phase5_dia_spmv_gnnz_s=spmv_row["gnnz_s"],
               phase5_dia_spmv_device_gnnz_s=S.nnz / (spmv_row["device_ms"] * 1e-3) / 1e9)
    emit(row)
    if not (rate > 0 and bps <= 1.05 * PEAK_BYTES_PER_S):
        raise AssertionError(f"spmv_throughput {rate:.4e} nnz/s, {bps:.4e} B/s")
    return row


# -- the distributed path ----------------------------------------------------------
# shards of the distributed path, all on one card (the JAX package's dry
# run takes 8 virtual devices; D = 4 divides nx = 216 and keeps each shard
# of the 1M-row mesh a power of two)
DIST_SHARDS = 4
# distributed against one-shard iterates in f64: the JAX dry run's bound
DIST_PARITY_RTOL = 1e-10
# the same in f32, where a shard's halo and spill adds round in another
# order than the single-device kernel's in-tile sums: both solves stop at
# rtol 1e-6 on operators of condition number ~13 (ildu3d) and ~1e3 (the
# mesh under multigrid), so their iterates agree to about 1e-6 times that;
# 1e-3 fails a wrong halo, which solves another operator
DIST_F32_PARITY_RTOL = 1e-3


@contextlib.contextmanager
def _uncounted(*kernels):
    """Take the launches made inside the block (a kernel held against its
    plain version) back out of the kernels' counts."""
    saved = [(k, k.launches, dict(getattr(k, "launches_by_layout", {}))) for k in kernels]
    try:
        yield
    finally:
        for k, n, by in saved:
            k.launches = n
            if by:
                k.launches_by_layout = by


def _kernel_tol(dtype):
    import torch

    return 1e-12 if dtype == torch.float64 else 1e-5


def _dist_dia_checks(Ad, x):
    """#1 on every shard's (a rank's: its own) ring-0 block and received
    ring blocks (the operands a distributed matvec gives it) against its
    plain version; returns the worst relative error."""
    from sigma_tpu_torch.ops import dia_spmv, dia_spmv_reference

    nb = Ad.block
    X = Ad.mesh.blocks(x)
    recv = Ad.mesh.ring_shift(X, [k for k, *_ in Ad._rings if k != 0])
    worst, cases = 0.0, 0
    with _uncounted(dia_spmv):
        for k, a, b, lo in Ad._rings:
            Xk = X if k == 0 else recv[k]
            for d in range(X.shape[0]):
                y = dia_spmv(Ad.data[d, a:b], Xk[d], lo, nb, nb)
                e = rel_err(y, dia_spmv_reference(Ad.data[d, a:b], Xk[d], lo, nb, nb))
                worst, cases = max(worst, e), cases + 1
    if not worst <= _kernel_tol(x.dtype):
        raise AssertionError(f"dia_spmv on the distributed shards ({x.dtype}): rel err {worst:.3e}")
    return {"dia_spmv": worst, "cases": cases}


def _dist_pruned_checks(A, x, X):
    """#10 (#12 with symmetric storage, its y and mirror spill) on every
    shard's (a rank's: its own) halo-extended buffer [left | x_d | right]
    and, given X, #11 (#13) on its (block + 2 Hw, k) columns, against
    their plain versions; #10 also on the transposed plans.  Returns the
    worst relative errors."""
    from sigma_tpu_torch.ops import (
        pruned_matvec_reference, pruned_spmm, pruned_spmm_reference, pruned_spmv,
        pruned_sym_matvec_reference, pruned_sym_spmm, pruned_sym_spmm_reference,
        pruned_sym_spmv,
    )
    Hw, blk = A.halo_words, A.block
    m = blk + 2 * Hw
    ext = A._extended(x)
    Ext = None if X is None else A._extended(X)
    tol = _kernel_tol(x.dtype)
    worst = {}

    def check(key, y, ref, scale=None):
        e = (rel_err(y, ref) if scale is None
             else float((y.double() - ref.double()).abs().max()) / max(scale, 1e-300))
        if not e <= tol:
            raise AssertionError(f"{key} on a distributed shard ({x.dtype}): rel err {e:.3e}")
        worst[key] = max(worst.get(key, 0.0), e)

    with _uncounted(pruned_spmv, pruned_spmm, pruned_sym_spmv, pruned_sym_spmm):
        for d, s in enumerate(A.shards):
            kw = dict(group=s.group, tile_end=s.tile_end)
            args = (s.data, ext[d], s.offsets, s.tile_ptr, blk, m)
            cargs = None if Ext is None else (s.data, Ext[d], s.offsets, s.tile_ptr, blk, m,
                                              "cols")
            if A.symmetric:
                sk = dict(halo=s.halo, sym_shift=Hw, with_spill=True)
                y, sp = pruned_sym_spmv(*args, **sk, **kw)
                yr, spr = pruned_sym_matvec_reference(*args, **sk, group=s.group)
                scale = float(yr.double().abs().max())
                check("pruned_sym_spmv", y, yr)
                check("pruned_sym_spmv_spill", sp, spr, scale)
                if Ext is not None:
                    Y, SP = pruned_sym_spmm(*cargs, **sk, **kw)
                    Yr, SPr = pruned_sym_spmm_reference(*cargs, **sk, group=s.group)
                    check("pruned_sym_spmm", Y, Yr)
                    check("pruned_sym_spmm_spill", SP, SPr, float(Yr.double().abs().max()))
            else:
                check("pruned_spmv", pruned_spmv(*args, **kw),
                      pruned_matvec_reference(*args, group=s.group))
                if Ext is not None:
                    check("pruned_spmm", pruned_spmm(*cargs, **kw),
                          pruned_spmm_reference(*cargs, group=s.group))
                if s.t is not None:
                    t, xd = s.t, A.mesh.blocks(x)[d]
                    targs = (t.data, xd, t.offsets, t.tile_ptr, m, blk)
                    check("pruned_spmv_transposed", pruned_spmv(*targs, group=t.group,
                                                                tile_end=t.tile_end),
                          pruned_matvec_reference(*targs, group=t.group))
    return worst


def _per_matvec(A, x, kernels):
    """Each kernel's launches in one ``A.matvec(x)``."""
    before = {k: fn.launches for k, fn in kernels.items()}
    A.matvec(x)
    return {k: fn.launches - before[k] for k, fn in kernels.items() if fn.launches > before[k]}


def _cast_levels(M, dtype):
    """A structured hierarchy (single-device or distributed) with its
    level operators, dinv and coarse inverse cast to ``dtype``."""
    import dataclasses

    return dataclasses.replace(
        M, coarse_inv=M.coarse_inv.to(dtype),
        levels=tuple(dataclasses.replace(lv, A=lv.A.astype(dtype), dinv=lv.dinv.to(dtype))
                     for lv in M.levels))


def _parity(label, info_d, x_d, info_1, x_1, rtol):
    """Raise unless the distributed solve took the one-shard solve's
    iteration count with iterates within ``rtol``; returns their error."""
    err = rel_err(x_d, x_1)
    if not (info_d.iterations == info_1.iterations and err <= rtol):
        raise AssertionError(f"{label}: distributed {info_d.iterations} iterations, one shard "
                             f"{info_1.iterations}, iterates {err:.3e} apart (limit {rtol:.0e})")
    return err


def phase_dist_dryrun(device, shards=DIST_SHARDS):
    """Phase 35a: the port's dry run (``tools/dryrun_multichip.py``) on the
    card in f64: every distributed path against its one-shard twin."""
    from sigma_tpu_torch.tools.dryrun_multichip import dryrun_multichip

    t0 = time.perf_counter()
    out = dryrun_multichip(shards, device, verbose=False)
    emit({"phase": "dist_dryrun", "shards": shards, "paths": out,
          "seconds": time.perf_counter() - t0})


def phase_dist_stencil(device, nx, kernels, shards=DIST_SHARDS):
    """Phase 35b: the 7-point Poisson operator at nx (pure Dirichlet, f64)
    under structured pair multigrid with axis 0 frozen, slab-sharded over
    ``shards`` shards (DistributedDIAMatrix levels, #1 a shard and ring).
    #1 is held against its plain version on the shards' operands; CG + GMG
    on the mesh must take the one-shard solve's iteration count with
    iterates within 1e-10.  Then the same in f32 (the f64 hierarchy cast),
    timed: seconds an iteration, one matvec's time, halo bytes and launches."""
    import numpy as np
    import torch

    from sigma_tpu_torch import cg_solve, laplacian_3d_dia, structured_pair_amg
    from sigma_tpu_torch.ops import dia_spmv_reference
    from sigma_tpu_torch.parallel import (
        distribute_matrix_dia, distribute_structured_amg, make_mesh,
    )

    mesh = make_mesh(shards, device=device)
    A = laplacian_3d_dia(nx, torch.float64, device, diag=6.0)
    n = A.shape[0]
    M, setup = _timed_setup(lambda: structured_pair_amg(A, (nx,) * 3, freeze_axes=(0,)))
    (Ad, Md), dist_setup = _timed_setup(lambda: (distribute_matrix_dia(A, mesh),
                                                  distribute_structured_amg(M, mesh)))
    g = torch.Generator(device=device).manual_seed(35)
    xstar = torch.randn(n, generator=g, dtype=torch.float64, device=device)
    b = dia_spmv_reference(A.data, xstar, A.offsets_dev, n, n)  # the plain version's b
    checks = {"f64": _dist_dia_checks(Ad, xstar), "f32": _dist_dia_checks(
        Ad.astype(torch.float32), xstar.float())}
    kw = dict(tol=0.0, rtol=1e-8, maxiter=300)
    x1, i1 = cg_solve(A, b, M=M, **kw)
    xd, i_d = cg_solve(Ad, b, M=Md, **kw)
    err = _parity("dist_stencil f64", i_d, xd, i1, x1, DIST_PARITY_RTOL)
    twins = {"f64": (x1.cpu(), i1.iterations, i_d.iterations)}
    rel = _true_rel_residual(A, b, xd)
    _check_solve("dist_stencil f64", i_d, rel, 1e-8)
    row = {"phase": "dist_stencil", "n": n, "shards": shards, "block": Ad.block,
           "terms": Ad.terms, "levels": len(Md.levels) + 1, "setup_s": setup,
           "dist_setup_s": dist_setup, "kernel_checks": checks,
           "f64": {"iterations": i_d.iterations, "one_shard_iterations": i1.iterations,
                   "iterate_rel_err": err, "relative_residual": rel}}
    del x1, xd
    # f32: the same hierarchy cast, timed against the single-device solve
    A32, M32 = A.astype(torch.float32), _cast_levels(M, torch.float32)
    Ad32, Md32 = Ad.astype(torch.float32), _cast_levels(Md, torch.float32)
    b32 = b.float()
    kw = dict(tol=0.0, rtol=1e-6, maxiter=300)
    (x1, i1), w1 = _timed(lambda: cg_solve(A32, b32, M=M32, **kw))
    (xd, i_d), wd = _timed(lambda: cg_solve(Ad32, b32, M=Md32, **kw))
    rel = _true_rel_residual(A32, b32, xd)
    _check_solve("dist_stencil f32", i_d, rel, 1e-6)
    twins["f32"] = (x1.cpu(), i1.iterations, i_d.iterations)
    rings = sorted({k for k, _ in Ad.terms if k != 0})
    x32 = xstar.float()
    row["f32"] = {
        "iterations": i_d.iterations, "one_shard_iterations": i1.iterations,
        "relative_residual": rel, "wall_s_warm": wd, "one_shard_wall_s_warm": w1,
        "s_per_iteration": wd / max(i_d.iterations, 1),
        "one_shard_s_per_iteration": w1 / max(i1.iterations, 1),
        "iterate_rel_err": rel_err(xd, x1),
        "matvec_ms": median_ms(lambda: Ad32.matvec(x32), reps=20),
        "one_shard_matvec_ms": median_ms(lambda: A32.matvec(x32), reps=20),
        "matvec_device_ms": device_ms(lambda: Ad32.matvec(x32), launches=20),
        "one_shard_matvec_device_ms": device_ms(lambda: A32.matvec(x32), launches=20),
        "vcycle_ms": median_ms(lambda: Md32.matvec(x32), reps=10, warmup=2),
        "one_shard_vcycle_ms": median_ms(lambda: M32.matvec(x32), reps=10, warmup=2),
        "halo_bytes_per_matvec": len(rings) * shards * Ad.block * 4,
        "launches_per_matvec": _per_matvec(Ad32, x32, kernels),
        "one_shard_launches_per_matvec": _per_matvec(A32, x32, kernels),
    }
    emit(row)
    return row, twins


def phase_dist_mesh(device, U, kernels, shards=DIST_SHARDS):
    """Phase 35c: phase 15's 1,048,576-row mesh (f32, RCM) through
    distribute_pruned, full storage (with the transposed plans) and
    symmetric, each with distributed_pruned_pair_amg; the four pruned
    kernels held against their plain versions on the shards'
    halo-extended operands (f32, and f64 on the cast plans); CG + pruned
    multigrid against the single-device twin (n_pad = n, so U's hierarchy
    is the twin) with equal iteration counts; 8-RHS block CG (#11, #13)
    and 30 CGLS steps through the transposed plans (rmatvec)."""
    import numpy as np
    import torch

    from sigma_tpu_torch import block_cg_solve, cg_solve, cgls_solve
    from sigma_tpu_torch.parallel import (
        distribute_pruned, distributed_pruned_pair_amg, make_mesh,
    )

    mesh = make_mesh(shards, device=device)
    n, pr, pc, vals = U["n"], U["pr"], U["pc"], U["vals"]
    (Af, As), setup = _timed_setup(lambda: (
        distribute_pruned(n, pr, pc, vals, mesh, tile_rows=16384, group=8, assume_unique=True,
                          with_transpose=True),
        distribute_pruned(n, pr, pc, vals, mesh, tile_rows=16384, group=12, assume_unique=True,
                          symmetric=True, validate=False)))
    (Mf, Ms), gmg_setup = _timed_setup(lambda: (
        distributed_pruned_pair_amg(n, pr, pc, vals, mesh, coarse_size=4096,
                                    smoother="chebyshev", group=8, fine_A=Af),
        distributed_pruned_pair_amg(n, pr, pc, vals, mesh, coarse_size=4096,
                                    smoother="chebyshev", group=12, fine_A=As, symmetric=True)))
    if Af.n_pad != n or len(Mf.levels) != len(U["Mf"].levels):
        raise AssertionError(f"the mesh pads to {Af.n_pad} rows, {len(Mf.levels)} levels")
    g = torch.Generator(device=device).manual_seed(36)
    x = torch.randn(n, generator=g, device=device)
    X8 = torch.randn((n, 8), generator=g, device=device)
    checks = {}
    for tag, A in (("full", Af), ("sym", As)):
        checks[tag] = {"f32": _dist_pruned_checks(A, x, X8),
                       "f64": _dist_pruned_checks(A.astype(torch.float64), x.double(),
                                                  X8.double())}
    # the whole distributed product against the single-device one
    checks["matvec_vs_one_shard"] = {"full": rel_err(Af.matvec(x), U["P"].matvec(x)),
                                     "sym": rel_err(As.matvec(x), U["S"].matvec(x)),
                                     "rmatvec_vs_matvec": rel_err(Af.rmatvec(x), Af.matvec(x)),
                                     "matmat_full": rel_err(Af.matmat(X8), U["P"].matmat(X8)),
                                     "matmat_sym": rel_err(As.matmat(X8), U["S"].matmat(X8))}
    if not max(checks["matvec_vs_one_shard"].values()) <= 1e-5:
        raise AssertionError(f"distributed mesh products: {checks['matvec_vs_one_shard']}")
    xstar, _, b = _manufactured(U)
    row = {"phase": "dist_mesh", "n": n, "shards": shards, "block": Af.block,
           "halo_words": Af.halo_words, "halo_E": As.halo_E, "setup_s": setup,
           "gmg_setup_s": gmg_setup, "levels": len(Mf.levels) + 1, "kernel_checks": checks,
           "halo_bytes_per_matvec": {"full": 2 * (shards - 1) * Af.halo_words * 4,
                                     "sym": (shards - 1) * (As.halo_words + As.halo_E * 128) * 4},
           "steps_per_shard": {"full": [s.n_steps for s in Af.shards],
                               "sym": [s.n_steps for s in As.shards]}}
    kw = dict(tol=0.0, rtol=1e-6, maxiter=300)
    twins = {"b": b.cpu()}
    for tag, A, M, A1, M1 in (("full", Af, Mf, U["P"], U["Mf"]), ("sym", As, Ms, U["S"], U["Ms"])):
        (xd, i_d), wd = _timed(lambda: cg_solve(A, b, M=M, **kw))
        (x1, i1), w1 = _timed(lambda: cg_solve(A1, b, M=M1, **kw))
        _parity(f"dist_mesh {tag}", i_d, xd, i1, x1, DIST_F32_PARITY_RTOL)
        twins[tag] = (x1.cpu(), i1.iterations, i_d.iterations)
        rel = _true_rel_residual(A1, b, xd)
        _check_solve(f"dist_mesh {tag}", i_d, rel, 1e-6)
        row[f"gmg_cg_{tag}"] = {
            "iterations": i_d.iterations, "one_shard_iterations": i1.iterations,
            "relative_residual": rel, "iterate_rel_err": rel_err(xd, x1),
            "max_err_vs_xstar": float(np.abs(xd.cpu().numpy()[U["p"]] - xstar).max()),
            "s_per_iteration": wd / max(i_d.iterations, 1),
            "one_shard_s_per_iteration": w1 / max(i1.iterations, 1),
            "launches_per_matvec": _per_matvec(A, x, kernels)}
        # 8 right-hand sides: #11 (#13) for the block products
        B = A1.matmat(X8)
        (Xd, ib), wb = _timed(lambda: block_cg_solve(A, B, tol=0.0, rtol=1e-6, maxiter=300, M=M))
        fro = float(torch.linalg.vector_norm(B - A1.matmat(Xd)) / torch.linalg.vector_norm(B))
        row[f"block_cg_{tag}"] = {"rhs": 8, "iterations": ib.iterations, "converged": ib.converged,
                                  "fro_relative_residual": fro,
                                  "s_per_iteration": wb / max(ib.iterations, 1)}
        if not (ib.converged and fro <= BLOCK_CG_FRO_RTOL):
            raise AssertionError(f"dist_mesh block CG ({tag}): {ib}, {fro:.3e}")
        del xd, x1, Xd, B
    # CGLS: one matvec and one rmatvec (the transposed plans) a step
    (xl, il), wl = _timed(lambda: cgls_solve(Af, b, tol=0.0, maxiter=30, history=True))
    drop = float(il.history[-1] / il.history[0])
    row["cgls"] = {"iterations": il.iterations, "normal_residual_drop": drop,
                   "s_per_iteration": wl / max(il.iterations, 1)}
    if not (torch.isfinite(xl).all() and drop < 1.0):
        raise AssertionError(f"dist_mesh CGLS: {il}")
    emit(row)
    return row, twins


def phase_dist_ildu3d(device, A30, b, shards=DIST_SHARDS):
    """Phase 35d: phase 30's operator (benchmarks/ildu3d.py, nx=100, 1M rows
    of Laplacian + I, f32) as its CSR copy (the nonzeros: the DIA layout's
    zero slots would chain every row of ILDU's dependency levels) through
    distribute_matrix (ELL ring blocks): CG + distributed_amg (VMB
    aggregation) against CG + the same hierarchy on the CSR operator on
    the single device, equal counts; CG + distributed block ILDU(0) (no
    single-device twin: the shards' blocks), eagerly and as a graphed solve
    held equal (:func:`_graphed_case`), after the level-sweep kernel is
    held to its plain version on the block factors."""
    import torch

    from sigma_tpu_torch import CSRMatrix, cg_solve, smoothed_aggregation_amg
    from sigma_tpu_torch.parallel import (
        distribute_matrix, distributed_amg, distributed_block_ildu, make_mesh,
    )
    from sigma_tpu_torch.solvers import vmb_aggregate

    mesh = make_mesh(shards, device=device)
    n = A30.shape[0]
    r, c, v = A30.entries()
    keep = v != 0
    A = CSRMatrix.from_coo(n, n, r[keep], c[keep], v[keep], dtype=torch.float32, device=device)
    del r, c, v, keep
    Ad, dist_s = _timed_setup(lambda: distribute_matrix(A, mesh))
    Md, amg_s = _timed_setup(lambda: distributed_amg(A, mesh, aggregate=vmb_aggregate))
    M1, amg1_s = _timed_setup(lambda: smoothed_aggregation_amg(A, aggregate=vmb_aggregate))
    Mb, ildu_s = _timed_setup(lambda: distributed_block_ildu(A, mesh))
    kw = dict(tol=0.0, rtol=PRECOND_RTOL, maxiter=200)
    row = {"phase": "dist_ildu3d", "n": A.shape[0], "shards": shards, "offsets": Ad.offsets,
           "widths": [v.shape[2] for v in Ad.vals], "distribute_s": dist_s,
           "dist_amg_setup_s": amg_s, "one_shard_amg_setup_s": amg1_s, "block_ildu_setup_s": ildu_s}
    (xd, i_d), wd = _timed(lambda: cg_solve(Ad, b, M=Md, **kw))
    (x1, i1), w1 = _timed(lambda: cg_solve(A, b, M=M1, **kw))
    _parity("dist_ildu3d amg", i_d, xd, i1, x1, DIST_F32_PARITY_RTOL)
    rel = _true_rel_residual(A, b, xd)
    _check_solve("dist_ildu3d amg", i_d, rel, PRECOND_RTOL)
    row["amg"] = {"iterations": i_d.iterations, "one_shard_iterations": i1.iterations,
                  "relative_residual": rel, "iterate_rel_err": rel_err(xd, x1),
                  "s_per_iteration": wd / max(i_d.iterations, 1),
                  "one_shard_s_per_iteration": w1 / max(i1.iterations, 1),
                  "levels": len(Md.levels) + 1}
    (xb, ib), wb = _timed(lambda: cg_solve(Ad, b, M=Mb, **kw))
    rel = _true_rel_residual(A, b, xb)
    _check_solve("dist_ildu3d block_ildu", ib, rel, PRECOND_RTOL)
    row["block_ildu"] = {"iterations": ib.iterations, "relative_residual": rel,
                         "levels_fwd_bwd": [Mb.lower.nlev, Mb.upper.nlev],
                         "apply_ms": median_ms(lambda: Mb.matvec(b), reps=5, warmup=1),
                         "s_per_iteration": wb / max(ib.iterations, 1)}
    emit(row)
    # the level-sweep kernel on the block-diagonal factors (uncounted),
    # then CG + block ILDU(0) as a graphed solve, held to the eager one
    level_sweep_checks(device, {"block_ildu0": Mb}, emit_as="dist_level_sweep_kernel")
    graphed_row = _graphed_case("cg_solve_block_ildu0", cg_solve, Ad, b, dict(kw, M=Mb),
                                phase="dist_ildu3d_graphed")
    _check_host_reads("dist_ildu3d_graphed", {"block_ildu0": graphed_row})
    if graphed_row["iterations"] != ib.iterations or not graphed_row["launches"].get(
            "level_sweep"):
        raise AssertionError(f"graphed CG + block ILDU: {graphed_row}")
    return row


# phase 35e: gloo ranks sharing the one card (NCCL refuses two ranks on
# one card; its group runs at the card count)
RANK_COUNT = 4
RANK_COO = "build/chip_smoke_io/mesh_coo.npz"  # phase 15's mesh for the ranks
RANK_KERNELS = ("dia_spmv", "pruned_spmv", "pruned_sym_spmv")


def _once(run):
    """Run once; returns (the result, its seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _rank_stencil(mesh, nx):
    """Phase 35b's operator, hierarchy, b and x* on a rank mesh: each rank
    builds the global ones and keeps its shard.  Returns (A_d, M_d, b_d,
    x*_d, set-up seconds)."""
    import torch

    from sigma_tpu_torch import laplacian_3d_dia, structured_pair_amg
    from sigma_tpu_torch.ops import dia_spmv_reference
    from sigma_tpu_torch.parallel import distribute_matrix_dia, distribute_structured_amg

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = mesh.device
    A = laplacian_3d_dia(nx, torch.float64, dev, diag=6.0)
    n = A.shape[0]
    M = structured_pair_amg(A, (nx,) * 3, freeze_axes=(0,))
    Ad, Md = distribute_matrix_dia(A, mesh), distribute_structured_amg(M, mesh)
    g = torch.Generator(device=dev).manual_seed(35)
    xstar = torch.randn(n, generator=g, dtype=torch.float64, device=dev)
    b = dia_spmv_reference(A.data, xstar, A.offsets_dev, n, n)
    out = Ad, Md, Ad.shard_vector(b), Ad.shard_vector(xstar)
    del A, M, b, xstar
    torch.cuda.synchronize()
    return out + (time.perf_counter() - t0,)


def _rank_solve(A, b, M, kw):
    """CG on the rank mesh, run once (cold): iterations, seconds, the true
    relative residual and the rank's block of the iterate (on the host)."""
    import torch

    from sigma_tpu_torch import cg_solve

    (x, info), wall = _once(lambda: cg_solve(A, b, M=M, **kw))

    def norm(v):
        return float(torch.linalg.vector_norm(v).full_tensor())

    return {"iterations": info.iterations, "converged": bool(info.converged), "wall_s": wall,
            "s_per_iteration": wall / max(info.iterations, 1),
            "relative_residual": norm(b - A.matvec(x)) / norm(b), "x": x.to_local().cpu()}


def _rank_phase(mesh, nx, coo_path, b_mesh):
    """Phase 35e on one gloo rank: #1, #10 and #12 held against their plain
    versions on the rank's own operands, then (counted) phase 35b's f64
    and f32 CG + structured GMG and phase 35c's pruned multigrid CG in
    full and symmetric storage."""
    import torch

    from sigma_tpu_torch.ops import dia_spmv, pruned_spmv, pruned_sym_spmv
    from sigma_tpu_torch.parallel import distribute_pruned, distributed_pruned_pair_amg

    kernels = {"dia_spmv": dia_spmv, "pruned_spmv": pruned_spmv,
               "pruned_sym_spmv": pruned_sym_spmv}
    row = {"rank": mesh.rank, "transport": mesh.transport}
    Ad, Md, bd, xs, row["stencil_setup_s"] = _rank_stencil(mesh, nx)
    row["block"], row["terms"] = Ad.block, len(Ad.terms)
    checks = {"dia_spmv_f64": _dist_dia_checks(Ad, xs),
              "dia_spmv_f32": _dist_dia_checks(Ad.astype(torch.float32), xs.float())}
    import numpy as np

    with np.load(coo_path) as f:
        n, pr, pc, vals = int(f["n"]), f["pr"], f["pc"], f["vals"]

    def mesh_setup():
        Af = distribute_pruned(n, pr, pc, vals, mesh, tile_rows=16384, group=8,
                               assume_unique=True)
        As = distribute_pruned(n, pr, pc, vals, mesh, tile_rows=16384, group=12,
                               assume_unique=True, symmetric=True, validate=False)
        kw = dict(coarse_size=4096, smoother="chebyshev")
        return (Af, As, distributed_pruned_pair_amg(n, pr, pc, vals, mesh, group=8, fine_A=Af, **kw),
                distributed_pruned_pair_amg(n, pr, pc, vals, mesh, group=12, fine_A=As,
                                            symmetric=True, **kw))

    (Af, As, Mf, Ms), row["mesh_setup_s"] = _once(mesh_setup)
    row["halo_words"], row["halo_E"], row["mesh_block"] = Af.halo_words, As.halo_E, Af.block
    g = torch.Generator(device=mesh.device).manual_seed(36)
    xm = Af.shard_vector(torch.randn(n, generator=g, device=mesh.device))
    for tag, A in (("full", Af), ("sym", As)):
        checks[tag] = {"f32": _dist_pruned_checks(A, xm, None),
                       "f64": _dist_pruned_checks(A.astype(torch.float64), xm.double(), None)}
    row["kernel_checks"] = checks
    # the main path: the launches from here on are counted
    for fn in kernels.values():
        fn.launches = 0
    t_path = time.perf_counter()
    row["f64"] = _rank_solve(Ad, bd, Md, dict(tol=0.0, rtol=1e-8, maxiter=300))
    Ad, Md, bd = Ad.astype(torch.float32), _cast_levels(Md, torch.float32), bd.float()
    row["f32"] = _rank_solve(Ad, bd, Md, dict(tol=0.0, rtol=1e-6, maxiter=300))
    bm = Af.shard_vector(b_mesh)
    kw = dict(tol=0.0, rtol=1e-6, maxiter=300)
    row["mesh_full"] = _rank_solve(Af, bm, Mf, kw)
    row["mesh_sym"] = _rank_solve(As, bm, Ms, kw)
    row["path_s"] = time.perf_counter() - t_path
    row["launches"] = {k: fn.launches for k, fn in kernels.items()}
    return row


def _rank_nccl(mesh, nx):
    """Phase 35e's NCCL group: phase 35b's f64 CG + GMG, a rank a card."""
    from sigma_tpu_torch.ops import dia_spmv

    Ad, Md, bd, _, setup = _rank_stencil(mesh, nx)
    dia_spmv.launches = 0
    row = _rank_solve(Ad, bd, Md, dict(tol=0.0, rtol=1e-8, maxiter=300))
    row.update(rank=mesh.rank, transport=mesh.transport, device=str(mesh.device),
               setup_s=setup, launches={"dia_spmv": dia_spmv.launches})
    return row


def phase_dist_ranks(device, nx, U, kernels, stencil, mesh):
    """Phase 35e: the rank form of the distributed layer (a process a
    rank, ``sigma_tpu_torch.parallel.ranks``).  RANK_COUNT gloo ranks share
    the card, exchanging their halos through pinned host memory: each
    holds #1, #10 and #12 against their plain versions on its own
    operands, then runs phase 35b's f64 and f32 CG + structured GMG and
    phase 35c's pruned multigrid CG in both storages.  Every count must
    equal the shard mesh's (phases 35b, 35c) and the one-shard solve's,
    with iterates within DIST_PARITY_RTOL (f64) or DIST_F32_PARITY_RTOL
    (f32) of the one-shard ones; the ranks' launches go into the
    distributed path's counts.  Then an NCCL group of one rank a card
    (``torch.cuda.device_count()`` ranks) runs the f64 stencil solve to
    the same count.  ``stencil`` and ``mesh`` are phases 35b and 35c's
    (row, one-shard twins)."""
    import torch

    from sigma_tpu_torch.parallel.ranks import launch

    import os

    import numpy as np

    t_phase = time.perf_counter()
    os.makedirs(os.path.dirname(RANK_COO), exist_ok=True)
    np.savez(RANK_COO, n=U["n"], pr=U["pr"], pc=U["pc"], vals=U["vals"])
    cores = len(os.sched_getaffinity(0))  # the torch and BLAS threads a rank: a share of these
    out, t_gloo = _once(lambda: launch(_rank_phase, RANK_COUNT, "gloo", device,
                                       args=(nx, RANK_COO, mesh[1]["b"].numpy()),
                                       threads=max(1, cores // RANK_COUNT)))
    os.remove(RANK_COO)
    for r in out:
        for k, c in r["launches"].items():
            kernels[k].launches += c
            if c <= 0:
                raise AssertionError(f"rank {r['rank']} launched no {k} on the rank path")
    r0 = out[0]
    row = {"phase": "dist_ranks", "ranks": RANK_COUNT, "backend": "gloo", "transport": r0["transport"],
           "spawn_and_run_s": t_gloo, "stencil_setup_s": max(r["stencil_setup_s"] for r in out),
           "mesh_setup_s": max(r["mesh_setup_s"] for r in out),
           "path_s": max(r["path_s"] for r in out),
           "kernel_checks": {r["rank"]: r["kernel_checks"] for r in out},
           "launches_by_rank": {r["rank"]: r["launches"] for r in out}}
    runs = (("f64", stencil, "f64", DIST_PARITY_RTOL, 1e-8),
            ("f32", stencil, "f32", DIST_F32_PARITY_RTOL, 1e-6),
            ("mesh_full", mesh, "full", DIST_F32_PARITY_RTOL, 1e-6),
            ("mesh_sym", mesh, "sym", DIST_F32_PARITY_RTOL, 1e-6))
    for key, (prow, twins), tag, rtol, target in runs:
        x1, one_count, shard_count = twins[tag]
        runs_r = [r[key] for r in out]
        x = torch.cat([r.pop("x") for r in runs_r])
        res = runs_r[0]
        counts = {r["iterations"] for r in runs_r}
        err = rel_err(x, x1)
        if not (counts == {one_count} == {shard_count} and err <= rtol):
            raise AssertionError(f"dist_ranks {key}: ranks {counts}, shard mesh {shard_count}, "
                                 f"one shard {one_count}, iterates {err:.3e} apart "
                                 f"(limit {rtol:.0e})")
        if not (res["converged"] and res["relative_residual"] <= 2.0 * target):
            raise AssertionError(f"dist_ranks {key}: {res}")
        src = prow.get(key.replace("mesh_", "gmg_cg_"), prow.get(key, {}))
        row[key] = {**res, "shard_mesh_iterations": shard_count,
                    "one_shard_iterations": one_count, "iterate_rel_err": err,
                    "shard_mesh_s_per_iteration": src.get("s_per_iteration"),
                    "one_shard_s_per_iteration": src.get("one_shard_s_per_iteration")}
    rings = 2  # the stencil's ring offsets 1 and D - 1 (block-long terms)
    row["halo_bytes_per_matvec"] = {
        "stencil_f64": rings * RANK_COUNT * r0["block"] * 8,
        "stencil_f32": rings * RANK_COUNT * r0["block"] * 4,
        "mesh_full": 2 * (RANK_COUNT - 1) * r0["halo_words"] * 4,
        "mesh_sym": (RANK_COUNT - 1) * (r0["halo_words"] + r0["halo_E"] * 128) * 4}
    # the NCCL group: one rank a card
    cards = torch.cuda.device_count()
    nres, t_nccl = _once(lambda: launch(_rank_nccl, cards, "nccl", None, args=(nx,),
                                         threads=max(1, cores // cards)))
    x1, one_count, _ = stencil[1]["f64"]
    x = torch.cat([r.pop("x") for r in nres])
    err = rel_err(x, x1)
    if not ({r["iterations"] for r in nres} == {one_count} and err <= DIST_PARITY_RTOL):
        raise AssertionError(f"dist_ranks nccl: {[r['iterations'] for r in nres]} iterations, "
                             f"one shard {one_count}, iterates {err:.3e} apart")
    for r in nres:
        kernels["dia_spmv"].launches += r["launches"]["dia_spmv"]
    row["nccl"] = {"ranks": cards, "transport": nres[0]["transport"],
                   "devices": [r["device"] for r in nres], "spawn_and_run_s": t_nccl,
                   "setup_s": max(r["setup_s"] for r in nres), "iterations": nres[0]["iterations"],
                   "one_shard_iterations": one_count, "iterate_rel_err": err,
                   "wall_s": nres[0]["wall_s"], "s_per_iteration": nres[0]["s_per_iteration"],
                   "relative_residual": nres[0]["relative_residual"]}
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    return row


# the examples in f32: their counts may differ from the CPU's by the
# summation order of the kernels (the bound is stated in PERF.md)
EXAMPLES_F32 = ("solvers.solver_example_4", "solvers.solver_example_5",
                "solvers.solver_example_6")
EXAMPLES_F32_COUNT_TOL = 2
EXAMPLES_ERR_FACTOR = 2.0  # a solve's error on the card against the CPU's
EXAMPLES_ROUNDING = 1e-12  # rounding-level quantities: both below this
EXAMPLES_VALUE_RTOL = 1e-6  # every other float: eigenvalues, FEM errors, ratios
EXAMPLE4_LARGE = {"height": 16_384, "width": 64}  # benchmarks/unstructured.py's mesh
EXAMPLE4_LARGE_ERR = 1e-3
ENTRY_RTOL = 1e-4


def _leaves(d, path=()):
    """(path, value) of every non-dict, non-list leaf of a nested result."""
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(d, (list, tuple)):
        for i, v in enumerate(d):
            yield from _leaves(v, path + (i,))
    else:
        yield path, d


def _example_mismatches(name, card, cpu):
    """The leaves where an example's card result disagrees with its CPU
    result: strings, bools and integers equal (the f32 examples' iteration
    counts within EXAMPLES_F32_COUNT_TOL), a solve error and a rounding-level
    difference within a factor EXAMPLES_ERR_FACTOR of the CPU's or both
    below EXAMPLES_ROUNDING, every other float to EXAMPLES_VALUE_RTOL.  The
    kernel route is the card's own and is not compared."""
    cpu_leaves = dict(_leaves(cpu))
    bad = []
    for path, c in _leaves(card):
        key = next(k for k in reversed(path) if isinstance(k, str))
        if key == "kernel_route":
            continue
        h = cpu_leaves[path]
        if isinstance(h, (str, bool)):
            ok = c == h
        elif isinstance(h, int):
            tol = EXAMPLES_F32_COUNT_TOL if name in EXAMPLES_F32 and "iterations" in key else 0
            ok = abs(c - h) <= tol
        elif key.endswith("err") or key in ("sum_lazy_vs_explicit", "prod_lazy_vs_explicit",
                                             "adjoint_check"):
            ok = (max(c, h) <= EXAMPLES_ROUNDING
                  or max(c, h) <= EXAMPLES_ERR_FACTOR * min(c, h))
        else:
            ok = abs(c - h) <= EXAMPLES_VALUE_RTOL * abs(h)
        if not ok:
            bad.append({"path": list(path), "card": c, "cpu": h})
    return bad


@contextlib.contextmanager
def _recording_operators(seen):
    """Record, into the dict ``seen`` (id -> operator), every DIA, symmetric
    DIA, pruned and symmetric pruned matrix whose matvec runs inside the
    block: the operands the examples give the kernels."""
    from sigma_tpu_torch.matrix.formats import DIAMatrix
    from sigma_tpu_torch.matrix.pruned import PrunedDIAMatrix, SymmetricPrunedDIAMatrix
    from sigma_tpu_torch.matrix.symmetric import SymmetricDIAMatrix

    saved = []
    for cls in (DIAMatrix, SymmetricDIAMatrix, PrunedDIAMatrix, SymmetricPrunedDIAMatrix):
        orig = cls.__dict__["matvec"]

        def matvec(self, x, _orig=orig):
            seen.setdefault(id(self), self)
            return _orig(self, x)

        saved.append((cls, orig))
        cls.matvec = matvec
    try:
        yield seen
    finally:
        for cls, orig in saved:
            cls.matvec = orig


def _example_kernel_checks(ops, device, worst):
    """Each operator's kernel (#1, #2, #10 or #12 by its storage) held
    against its plain version on the card with a random x in the
    operator's dtype; the comparisons are not counted.  Adds each
    kernel's case count and worst relative error to ``worst``."""
    import torch

    from sigma_tpu_torch.matrix.formats import DIAMatrix
    from sigma_tpu_torch.matrix.pruned import SymmetricPrunedDIAMatrix
    from sigma_tpu_torch.matrix.symmetric import SymmetricDIAMatrix
    from sigma_tpu_torch.ops import (
        dia_spmv, dia_spmv_reference, dia_sym_spmv, dia_sym_spmv_reference,
        pruned_matvec_reference, pruned_spmv, pruned_sym_matvec_reference, pruned_sym_spmv,
    )

    g = torch.Generator(device=device).manual_seed(0)
    with _uncounted(dia_spmv, dia_sym_spmv, pruned_spmv, pruned_sym_spmv):
        for A in ops:
            A = A.to(device)
            n, m = A.shape
            x = torch.randn(m, generator=g, device=device, dtype=A.data.dtype)
            if isinstance(A, DIAMatrix):
                key = "dia_spmv"
                y = dia_spmv(A.data, x, A.offsets_dev, n, m)
                ref = dia_spmv_reference(A.data, x, A.offsets_dev, n, m)
            elif isinstance(A, SymmetricDIAMatrix):
                key = "dia_sym_spmv"
                y = dia_sym_spmv(A.data, x, A.offsets_dev, n)
                ref = dia_sym_spmv_reference(A.data, x, A.offsets_dev, n)
            elif isinstance(A, SymmetricPrunedDIAMatrix):
                key = "pruned_sym_spmv"
                args = (A.data, x, A.offsets, A.tile_ptr, n, m)
                y = pruned_sym_spmv(*args, halo=A.halo, group=A.group, tile_end=A.tile_end)
                ref = pruned_sym_matvec_reference(*args, halo=A.halo, group=A.group)
            else:
                key = "pruned_spmv"
                args = (A.data, x, A.offsets, A.tile_ptr, n, m)
                y = pruned_spmv(*args, group=A.group, tile_end=A.tile_end)
                ref = pruned_matvec_reference(*args, group=A.group)
            e = rel_err(y, ref)
            if not e <= _kernel_tol(x.dtype):
                raise AssertionError(f"{key} on an example's operand (n={n}, {x.dtype}): "
                                     f"rel err {e:.3e}")
            w = worst.setdefault(key, {"cases": 0, "worst_rel_err": 0.0, "rows": []})
            w["cases"] += 1
            w["worst_rel_err"] = max(w["worst_rel_err"], e)
            w["rows"] = sorted(set(w["rows"]) | {n})


def _run_example(main, **kw):
    """(result, printed lines, seconds) of one example's main."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = main(**kw)
    return out, buf.getvalue().splitlines(), time.perf_counter() - t0


def examples_setup(device):
    """The examples path's set-up, outside the counted path: each of the 14
    example mains (``sigma_tpu_torch/examples/``) and ``entry()`` run once
    on the CPU (the plain versions), recording the DIA and pruned operators
    their products use; those operands are moved to the card, where each
    one's kernel is held against its plain version.  solver_example_2's
    LOBPCG gets one start block, the CPU default draw, on both devices.
    Returns the CPU results and the start block."""
    import importlib

    import torch

    from sigma_tpu_torch.examples import EXAMPLES
    from sigma_tpu_torch.tools.entry import entry

    x0 = torch.randn((1024, 4), generator=torch.Generator().manual_seed(0),
                     dtype=torch.float64).numpy()
    cpu, ops = {}, {}
    with _recording_operators(ops):
        for name in EXAMPLES:
            main = importlib.import_module(f"sigma_tpu_torch.examples.{name}").main
            kw = {"X0": x0} if name == "solvers.solver_example_2" else {}
            cpu[name] = _run_example(main, device="cpu", **kw)
        fn, (A, b) = entry(device="cpu")
        cpu["entry"] = (fn(A, b), [], 0.0)
    worst = {}
    _example_kernel_checks(list(ops.values()), device, worst)
    emit({"phase": "examples_checks", "operators": len(ops), "kernels": worst,
          "cpu_seconds": {k: v[2] for k, v in cpu.items()}})
    return cpu, x0


def phase_examples(device, cpu, x0):
    """Phase 36: the 14 example mains and ``entry()``'s CG step on the card,
    each held against its CPU run (``_example_mismatches``;
    entry's x to ENTRY_RTOL), then solver_example_4 again at
    ``benchmarks/unstructured.py``'s 1,048,576-row mesh (card only: its
    two CG solves converge, agree in count to EXAMPLES_F32_COUNT_TOL and
    reach EXAMPLE4_LARGE_ERR against x*)."""
    import importlib

    from sigma_tpu_torch.examples import EXAMPLES
    from sigma_tpu_torch.tools.entry import entry

    rows = {}
    for name in EXAMPLES:
        module = importlib.import_module(f"sigma_tpu_torch.examples.{name}")
        kw = {"X0": x0} if name == "solvers.solver_example_2" else {}
        out, lines, secs = _run_example(module.main, device=device, **kw)
        bad = _example_mismatches(name, out, cpu[name][0])
        row = {"phase": "examples", "example": name, "seconds": secs,
               "cpu_seconds": cpu[name][2], "result": out, "lines": lines, "mismatches": bad}
        emit(row)
        if bad:
            raise AssertionError(f"{name} on the card disagrees with the CPU: {bad}")
        rows[name] = row
    route = rows["solvers.solver_example_4"]["result"]["kernel_route"]
    if route.startswith("plain"):
        raise AssertionError(f"solver_example_4's band on the card runs the {route}")
    t0 = time.perf_counter()
    fn, (A, b) = entry(device)
    x = fn(A, b)
    secs = time.perf_counter() - t0
    err = rel_err(x.cpu(), cpu["entry"][0])
    emit({"phase": "examples", "example": "entry", "seconds": secs, "n": A.shape[0],
          "offsets": A.offsets, "x_rel_err_vs_cpu": err})
    if not err <= ENTRY_RTOL:
        raise AssertionError(f"entry(): x on the card {err:.3e} from the CPU's")
    from sigma_tpu_torch.examples.solvers import solver_example_4

    out, lines, secs = _run_example(solver_example_4.main, device=device, **EXAMPLE4_LARGE)
    row = {"phase": "examples", "example": "solvers.solver_example_4", **EXAMPLE4_LARGE,
           "seconds": secs, "result": out, "lines": lines}
    emit(row)
    its = (out["banded"]["iterations"], out["symmetric"]["iterations"])
    if not (abs(its[0] - its[1]) <= EXAMPLES_F32_COUNT_TOL
            and max(out["banded"]["err"], out["symmetric"]["err"]) <= EXAMPLE4_LARGE_ERR):
        raise AssertionError(f"solver_example_4 at 1M rows: {out}")
    rows["solver_example_4_large"] = row
    return rows


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
        dia_spmv_window, dia_sym_spmm, dia_sym_spmv, givens_update, level_sweep, pruned_spmm,
        pruned_spmv, pruned_sym_spmm, pruned_sym_spmv,
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
               "dia_spmv_window": dia_spmv_window, "bsr_grouped_spmv": bsr_grouped_spmv,
               "givens_update": givens_update, "level_sweep": level_sweep}

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
    A9, b9 = phase_cg(device, args.nx)                      # phase 9
    S10, b10, hierarchies = phase_gmg(device, args.nx)      # phase 10
    paths.append(read_counts("single_rhs", ("dia_spmv", "dia_sym_spmv")))
    # the same solves as graphed solves, held to the eager loop
    zero_counts()
    phase_graphed(device, A9, b9, S10, b10, hierarchies)    # phase 10b
    paths.append(read_counts("graphed", ("dia_spmv", "dia_sym_spmv")))
    Mst = hierarchies["chebyshev"]
    del A9, b9, S10, b10, hierarchies
    # the stencil multi-RHS path
    zero_counts()
    blk11 = phase_block_cg(device, args.nx)                 # phase 11
    V12, M12 = phase_lobpcg(device, args.nx)                # phase 12
    # (the GMG levels here are bf16 full storage: dia_spmv, not dia_sym_spmv)
    paths.append(read_counts("multi_rhs", ("dia_spmv", "dia_spmm", "dia_sym_spmm")))
    if dia_spmm.launches_by_layout["cols"] + dia_spmm.launches_by_layout["rhs_major"] <= 0:
        raise AssertionError("dia_spmm ran no column or RHS-major product on the multi-RHS path")
    # the unstructured single-RHS path
    zero_counts()
    phase_unstructured_cg(device, U)                        # phase 13
    paths.append(read_counts("unstructured_single_rhs", ("pruned_spmv", "pruned_sym_spmv")))
    # the same solves and phase 14's block CG as graphed solves, held to
    # the eager loop
    zero_counts()
    phase_graphed_pruned(device, U)                         # phase 13b
    paths.append(read_counts("graphed_pruned", ("pruned_spmv", "pruned_sym_spmv",
                                                "pruned_spmm")))
    # the unstructured multi-RHS path
    zero_counts()
    phase_unstructured_block(device, U)                     # phase 14
    T = {k: U[k] for k in ("n", "pr", "pc", "vals")}  # the 10.1M triples, for phase 19
    del U
    eigs15, U15 = phase_unstructured_lobpcg(device)         # phase 15
    paths.append(read_counts("unstructured_multi_rhs",
                             ("pruned_spmv", "pruned_spmm", "pruned_sym_spmv", "pruned_sym_spmm")))
    # the full-band path at 1M rows
    B1 = full_band_setup(device, shift=1.0)                 # phase 16
    B3 = full_band_setup(device, shift=MESH_SHIFT)
    zero_counts()
    Mband = phase_full_band_solves(device, B1, B3)          # phase 17
    del B1
    phase_full_band_lobpcg(device, B3, eigs15, U15["p"])    # phase 18
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
    A23, b23, Mj23, Mg23 = phase_nonsym_stencil(device, args.nx)  # phase 23
    paths.append(read_counts("nonsym_stencil", ("dia_spmv", "givens_update")))
    # the same solves as graphed solves, held to the eager loop (GMRES's
    # Givens kernel held to its plain version first, outside the path)
    rows["givens_update"] = givens_checks(device)
    zero_counts()
    phase_graphed_nonsym(device, A23, b23, Mj23, Mg23)      # phase 23b
    paths.append(read_counts("graphed_nonsym", ("dia_spmv", "givens_update")))
    zero_counts()
    P24, b24, Mg24 = phase_nonsym_unstructured(device)      # phase 24
    paths.append(read_counts("nonsym_unstructured", ("pruned_spmv",)))
    zero_counts()
    phase_graphed_nonsym_mesh(device, P24, b24, Mg24)       # phase 24b
    paths.append(read_counts("graphed_nonsym_mesh", ("pruned_spmv",)))
    del P24, b24, Mg24
    zero_counts()
    refine25 = phase_refinement(device, args.nx)            # phase 25
    paths.append(read_counts("refinement", ("dia_sym_spmv", "dia_spmv")))
    # the rest of the Krylov solvers as graphed solves, held to the eager
    # loop, on phases 11's, 23's and 25's operators
    zero_counts()
    phase_graphed_krylov(device, blk11, (A23, b23, Mj23, Mg23), refine25)  # phase 25b
    paths.append(read_counts("graphed_krylov", ("dia_spmv", "dia_sym_spmv", "dia_spmm",
                                                "dia_sym_spmm", "givens_update")))
    del blk11, A23, b23, Mj23, Mg23, refine25
    # the eigen path: refinement of phase 12's block, the FEM pencil, and
    # inverse and shift-invert Lanczos on phase 15's mesh
    zero_counts()
    phase_refine_stencil(device, args.nx, V12, M12)         # phase 26
    del V12, M12
    phase_geneigen_fem3d(device)                            # phase 27
    mu1 = phase_inverse_lanczos_mesh(device, U15, eigs15)   # phase 28
    phase_shift_invert_mesh(device, U15, mu1)               # phase 29
    paths.append(read_counts("eigen", ("dia_spmv", "dia_spmm", "pruned_spmv")))
    # the preconditioner comparison of benchmarks/ildu3d.py and the generic
    # AMG (host algebra, V-cycles on #1 and CSR transfers)
    zero_counts()
    t_path = time.perf_counter()
    A30, b30, ildu, ops30 = phase_ildu3d(device)            # phase 30
    # the level-sweep kernel held to its plain version on phase 30's
    # factors (uncounted), then the same PCGs as graphed solves
    sweeps = level_sweep_checks(device, {k: ildu[k] for k in ("ildu0", "ilu1", "ildu0_colored")}
                                | {"chain4096": _chain_levels(4096, device)})
    rows["level_sweep"] = sweeps[("ildu0", "lower", "torch.float32")]
    phase_graphed_ildu(device, A30, b30, ops30)             # phase 30b
    del ops30
    phase_amg(device, A30)                                  # phase 31
    phase_ildu_trace(b30, ildu)
    paths.append(read_counts("preconditioners", ("dia_spmv", "level_sweep")))
    emit({"phase": "preconditioners_path", "seconds": time.perf_counter() - t_path})
    del ildu
    # the apps: Ising and self-avoiding walks (ELL gathers, no ported kernel)
    zero_counts()
    t_path = time.perf_counter()
    phase_ising(device)                                     # phase 32
    phase_saw(device)                                       # phase 33
    phase_app_tools()
    paths.append(read_counts("apps", ()))
    emit({"phase": "apps_path", "seconds": time.perf_counter() - t_path})
    # the support modules: 2-D FEM on #1, I/O, checks, profiling, BlockVector
    zero_counts()
    t_path = time.perf_counter()
    A34, b34 = phase_fem2d(device)                          # phase 34
    phase_support(device, A34, b34, rows["dia_spmv"])
    paths.append(read_counts("support", ("dia_spmv",)))
    emit({"phase": "support_path", "seconds": time.perf_counter() - t_path})
    del A34, b34
    # the distributed layer: a mesh of 4 shards on the one card (the dry
    # run, the nx=216 stencil, phase 15's mesh, phase 30's operator)
    zero_counts()
    t_path = time.perf_counter()
    phase_dist_dryrun(device)                               # phase 35a
    stencil35 = phase_dist_stencil(device, args.nx, kernels)  # phase 35b
    mesh35 = phase_dist_mesh(device, U15, kernels)          # phase 35c
    phase_dist_ildu3d(device, A30, b30)                     # phase 35d
    phase_dist_ranks(device, args.nx, U15, kernels, stencil35, mesh35)  # phase 35e
    del stencil35, mesh35
    paths.append(read_counts("distributed", ("dia_spmv", "pruned_spmv", "pruned_spmm",
                                             "pruned_sym_spmv", "pruned_sym_spmm",
                                             "level_sweep")))
    emit({"phase": "distributed_path", "seconds": time.perf_counter() - t_path})
    del U15, A30, b30
    # the examples: each main and entry() on the card against its CPU run,
    # the kernels checked first on the operands the CPU runs recorded
    t_path = time.perf_counter()
    cpu_examples, x0 = examples_setup(device)
    zero_counts()
    phase_examples(device, cpu_examples, x0)                # phase 36
    paths.append(read_counts("examples", ("dia_spmv", "dia_sym_spmv", "pruned_spmv",
                                          "pruned_sym_spmv")))
    emit({"phase": "examples_path", "seconds": time.perf_counter() - t_path})
    del cpu_examples
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
        # no pallas_call: the device form of the JAX GMRES loop's CGS2 tail and Givens update
        "givens_update": ("givens.cu", "sigma_tpu/solvers/krylov.py:357 and "
                                       "sigma_tpu/solvers/krylov.py:337"),
        # no pallas_call: the device form of the JAX ILDU sweeps' fori_loop
        "level_sweep": ("ildu_sweep.cu",
                        "sigma_tpu/solvers/ildu.py:306 and sigma_tpu/parallel/precond.py:73"),
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
