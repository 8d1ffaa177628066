#!/usr/bin/env python3
"""Where the device time of the port's solves goes, on one GPU.

    python3 chip_profile.py [--nx 216] [--paths stencil,unstructured,nonsym,krylov] [--out FILE]

Runs the solves of ``chip_smoke.py``'s paths through the same entry
points (CG and fused CG on Laplacian + I; plain CG and GMG-CG with the
Jacobi and the Chebyshev smoother on pure Poisson; CG, fused CG and the
two GMG-CG solves again as ``graphed`` solves, timed and traced from
their cached graphs after the first call captured them; block CG with 8
right-hand sides in the ``auto`` (interleaved) layout on Laplacian + I;
f32 LOBPCG + GMG for 4 eigenpairs of pure Poisson; on the 10M-row
irregular mesh, CG and pruned-multigrid CG on full and on symmetric
pruned storage, the latter and block CG + pruned multigrid (8 right-hand
sides) eagerly and as ``graphed`` solves; on the 1M-row meshes BiCG-stab
+ pruned multigrid on the skewed one and a shift-invert inner CG, eagerly
and as ``graphed`` solves; on the nonsymmetric stencil of
``benchmarks/adv3d.py``, BiCG-stab + Jacobi, BiCG-stab + GMG and GMRES(32), eagerly and as
``graphed`` solves; ``chip_smoke.py`` phase 25b's block CG + GMG with 4
right-hand sides on pure Poisson, f64 MINRES + GMG to rtol 1e-10 and
FGMRES(32) + GMG on the nonsymmetric stencil, eagerly and as ``graphed``
solves), each five times warm and untraced and once under
``torch.profiler``, and prints one JSON line per solve (``--paths``
picks the stencil solves, the unstructured ones, the nonsymmetric ones,
the Krylov ones, or any of them; the default is the first two):

- ``device_busy_ms``: the union of the kernel and copy intervals in the
  trace;
- ``wall_ms``: the median of five untraced warm solves, host clock,
  taken for every solve before any is traced;
- ``idle_share``: 1 - device_busy_ms / wall_ms;
- ``device_ops``: the number of kernels and copies the solve ran;
- ``port_kernels_ms``: the device time of the port's DIA and pruned
  SpMV and SpMM kernels and GMRES's Givens kernel;
- ``top``: the kernels that take the most device time, as
  [name, ms, launches].

Every kernel, by device time, goes to ``--out``.  On the unstructured
path it also prints, for each level of the two pruned multigrid
hierarchies, the matvec's time (CUDA events, median of 30) beside the
level's rows: the coarse levels are bound by their launches.  The card's
name and power limit come first, as nvidia-smi gives them.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import collections
import os
import statistics
import sys
import time

from chip_smoke import (
    MESH_SHIFT, NONSYM_RTOL, _manufactured, _manufactured_block, emit, median_ms,
    nonsym_mesh_setup, phase_device, shifted_mesh, unstructured_setup,
)


def _stencil_solves(device, nx):
    """(label, solve) pairs: chip_smoke.py's stencil solves.  Each solve
    returns a pair whose second item has ``iterations``."""
    import numpy as np
    import torch

    from sigma_tpu_torch import (
        SymmetricDIAMatrix, block_cg_solve, cg_fused_solve, cg_solve, graphed,
        laplacian_3d_dia, lobpcg, structured_pair_amg,
    )

    A = laplacian_3d_dia(nx, torch.float32, device)
    i = torch.arange(A.shape[0], dtype=torch.float32, device=device)
    b = A.matvec(torch.sin(i * 0.001))
    B = A.matmat(torch.stack([torch.sin(i * (0.001 * (j + 1))) for j in range(8)], dim=1))
    del i
    S = SymmetricDIAMatrix.from_dia(laplacian_3d_dia(nx, torch.float32, device, diag=6.0))
    xstar = np.random.default_rng(0).standard_normal(S.shape[0]).astype(np.float32)
    bs = S.matvec(torch.from_numpy(xstar).to(device))
    Mj, Mc = (structured_pair_amg(S, (nx, nx, nx), pairs_per_level=3,
                                  level_dtype=torch.bfloat16, **kw)
              for kw in (dict(smoother="jacobi", n_smooth=1),
                         dict(smoother="chebyshev", n_smooth=4)))
    host = laplacian_3d_dia(nx, torch.float32, "cpu", diag=6.0)
    P = host.to(device)
    Mp = structured_pair_amg(P, (nx, nx, nx), pairs_per_level=3, host_data=host.data.numpy())
    X0 = torch.from_numpy(
        np.random.default_rng(0).standard_normal((P.shape[0], 4)).astype(np.float32)
    ).to(device)
    # one graphed callable a solve, each keeping its own captured graph
    g_cg, g_fused, g_jacobi, g_chebyshev = (
        graphed(f) for f in (cg_solve, cg_fused_solve, cg_solve, cg_solve))
    return [
        ("cg_solve", lambda: cg_solve(A, b, tol=0.0, rtol=1e-6, maxiter=100)),
        ("cg_fused_solve", lambda: cg_fused_solve(A, b, tol=0.0, rtol=1e-6, maxiter=100)),
        ("plain_cg_poisson", lambda: cg_solve(S, bs, tol=0.0, rtol=2e-7, maxiter=3000)),
        ("gmg_jacobi", lambda: cg_solve(S, bs, tol=0.0, rtol=2e-7, maxiter=3000, M=Mj)),
        ("gmg_chebyshev", lambda: cg_solve(S, bs, tol=0.0, rtol=2e-7, maxiter=3000, M=Mc)),
        ("graphed_cg_solve", lambda: g_cg(A, b, tol=0.0, rtol=1e-6, maxiter=100)),
        ("graphed_cg_fused_solve", lambda: g_fused(A, b, tol=0.0, rtol=1e-6, maxiter=100)),
        ("graphed_gmg_jacobi",
         lambda: g_jacobi(S, bs, tol=0.0, rtol=2e-7, maxiter=3000, M=Mj)),
        ("graphed_gmg_chebyshev",
         lambda: g_chebyshev(S, bs, tol=0.0, rtol=2e-7, maxiter=3000, M=Mc)),
        ("block_cg_auto", lambda: block_cg_solve(A, B, tol=0.0, rtol=1e-6, maxiter=100)),
        ("lobpcg_f32_gmg", lambda: (None, lobpcg(P, X0, M=Mp, tol=1e-4, maxiter=120))),
    ]


def _nonsym_solves(device, nx):
    """(label, solve) pairs: ``chip_smoke.py`` phase 23's three solves on
    the upwinded advection-diffusion stencil (beta 10, f32, b from the
    manufactured solution), eagerly and as graphed solves."""
    import numpy as np
    import torch

    from sigma_tpu_torch import (
        advection_diffusion_dia, bicgstab_solve, gmres_solve, graphed, jacobi, structured_amg,
    )
    from sigma_tpu_torch.ops import dia_spmv_reference

    A = advection_diffusion_dia(nx, 10.0, torch.float32, device)
    n = A.shape[0]
    xstar = torch.from_numpy(
        np.random.default_rng(0).standard_normal(n).astype(np.float32)).to(device)
    b = dia_spmv_reference(A.data, xstar, A.offsets_dev, n, n)
    Mj, Mg = jacobi().setup(A), structured_amg((nx, nx, nx), pairs_per_level=3).setup(A)
    kw = dict(tol=0.0, rtol=NONSYM_RTOL, maxiter=2000)
    g_jacobi, g_gmg, g_gmres = (graphed(f) for f in (bicgstab_solve, bicgstab_solve, gmres_solve))
    return [
        ("bicgstab_jacobi", lambda: bicgstab_solve(A, b, M=Mj, **kw)),
        ("bicgstab_gmg", lambda: bicgstab_solve(A, b, M=Mg, **kw)),
        ("gmres32", lambda: gmres_solve(A, b, restart=32, **kw)),
        ("graphed_bicgstab_jacobi", lambda: g_jacobi(A, b, M=Mj, **kw)),
        ("graphed_bicgstab_gmg", lambda: g_gmg(A, b, M=Mg, **kw)),
        ("graphed_gmres32", lambda: g_gmres(A, b, restart=32, **kw)),
    ]


def _krylov_solves(device, nx):
    """(label, solve) pairs: ``chip_smoke.py`` phase 25b's block CG + GMG
    (4 right-hand sides, pure Poisson in symmetric storage, bf16 levels),
    f64 MINRES + Chebyshev GMG (phase 25's operator and M) and FGMRES(32)
    + GMG on the upwinded stencil (phase 23's), eagerly and as graphed
    solves."""
    import numpy as np
    import torch

    from sigma_tpu_torch import (
        SymmetricDIAMatrix, advection_diffusion_dia, block_cg_solve, fgmres_solve, graphed,
        laplacian_3d_dia, minres_solve, structured_amg, structured_pair_amg,
    )
    from sigma_tpu_torch.ops import dia_spmv_reference, dia_sym_spmv_reference

    dims = (nx, nx, nx)
    S = SymmetricDIAMatrix.from_dia(laplacian_3d_dia(nx, torch.float32, device, diag=6.0))
    n = S.shape[0]
    g = torch.Generator(device=device).manual_seed(0)
    B = S.matmat(torch.randn((n, 4), generator=g, device=device))
    Mb = structured_pair_amg(S, dims, pairs_per_level=3, level_dtype=torch.bfloat16)
    S64 = SymmetricDIAMatrix.from_dia(laplacian_3d_dia(nx, torch.float64, device, diag=6.0))
    M64 = structured_pair_amg(S64, dims, pairs_per_level=3, smoother="chebyshev", n_smooth=4)
    xstar = torch.from_numpy(np.random.default_rng(0).standard_normal(n)).to(device)
    b64 = dia_sym_spmv_reference(S64.data, xstar, S64.offsets_dev, n)
    A = advection_diffusion_dia(nx, 10.0, torch.float32, device)
    b = dia_spmv_reference(A.data, xstar.float(), A.offsets_dev, n, n)
    del xstar
    Mg = structured_amg(dims, pairs_per_level=3).setup(A)
    bkw = dict(tol=0.0, rtol=1e-6, maxiter=300, M=Mb)
    mkw = dict(tol=0.0, rtol=1e-10, maxiter=3000, M=M64)
    fkw = dict(tol=0.0, rtol=NONSYM_RTOL, maxiter=2000, restart=32, M=Mg)
    g_block, g_minres, g_fgmres = (graphed(f) for f in (block_cg_solve, minres_solve,
                                                        fgmres_solve))
    return [
        ("block_cg_gmg", lambda: block_cg_solve(S, B, **bkw)),
        ("minres_gmg_f64", lambda: minres_solve(S64, b64, **mkw)),
        ("fgmres32_gmg", lambda: fgmres_solve(A, b, **fkw)),
        ("graphed_block_cg_gmg", lambda: g_block(S, B, **bkw)),
        ("graphed_minres_gmg_f64", lambda: g_minres(S64, b64, **mkw)),
        ("graphed_fgmres32_gmg", lambda: g_fgmres(A, b, **fkw)),
    ]


def _unstructured_solves(U):
    """(label, solve) pairs of the 10M-row mesh, as ``_stencil_solves``:
    CG and pruned-multigrid CG on both storages, the latter also graphed,
    and phase 13b's block CG + pruned multigrid (8 right-hand sides),
    eager and graphed."""
    from sigma_tpu_torch import block_cg_solve, cg_solve, graphed

    P, b, B = U["P"], _manufactured(U)[2], _manufactured_block(U)
    kw = dict(tol=0.0, rtol=1e-6, maxiter=300)
    bkw = dict(kw, M=U["Mf"], panels="cols")
    g_full, g_sym, g_block = graphed(cg_solve), graphed(cg_solve), graphed(block_cg_solve)
    return [
        (label, lambda A=A, Mg=Mg, solve=solve: solve(A, b, M=Mg, **kw))
        for label, solve, A, Mg in (
            ("pruned_cg_full", cg_solve, P, None), ("pruned_cg_sym", cg_solve, U["S"], None),
            ("pruned_gmg_cg_full", cg_solve, P, U["Mf"]),
            ("pruned_gmg_cg_sym", cg_solve, U["S"], U["Ms"]),
            ("graphed_pruned_gmg_cg_full", g_full, P, U["Mf"]),
            ("graphed_pruned_gmg_cg_sym", g_sym, U["S"], U["Ms"]))
    ] + [
        ("pruned_gmg_block_cg_full", lambda: block_cg_solve(P, B, **bkw)),
        ("graphed_pruned_gmg_block_cg_full", lambda: g_block(P, B, **bkw)),
    ]


def _mesh_1m_solves(device):
    """(label, solve) pairs of the 1M-row meshes, as ``_stencil_solves``:
    ``chip_smoke.py`` phase 24b's BiCG-stab + pruned multigrid on the
    skewed mesh, and one of phase 29's shift-invert inner solves
    (pruned-multigrid CG, rtol 1e-6, on the mesh shifted by sigma = 0.9 x
    the shift 1e-3, the lowest eigenvalue phase 28 finds to within 1e-3,
    from a unit random f32 right-hand side), eager and graphed."""
    import numpy as np
    import torch

    from sigma_tpu_torch import bicgstab_solve, cg_solve, graphed

    N = nonsym_mesh_setup(device)
    U1 = unstructured_setup(device, height=16_384, width=64)
    P_sig, Mg = shifted_mesh(device, U1, 0.9 * MESH_SHIFT), U1["Mf"]
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(U1["n"]).astype(np.float32))
    r = (r / torch.linalg.vector_norm(r)).to(device)
    nkw = dict(tol=0.0, rtol=NONSYM_RTOL, maxiter=500, M=N["Mg"])
    skw = dict(tol=0.0, rtol=1e-6, maxiter=400, M=Mg)
    g_nonsym, g_inner = graphed(bicgstab_solve), graphed(cg_solve)
    P, b = N["P"], N["b"]
    return [
        ("nonsym_mesh_bicgstab_pruned_gmg", lambda: bicgstab_solve(P, b, **nkw)),
        ("graphed_nonsym_mesh_bicgstab_pruned_gmg", lambda: g_nonsym(P, b, **nkw)),
        ("shift_invert_inner_cg", lambda: cg_solve(P_sig, r, **skw)),
        ("graphed_shift_invert_inner_cg", lambda: g_inner(P_sig, r, **skw)),
    ]


def _level_times(U):
    """One JSON line per pruned multigrid hierarchy: each level's rows and
    the time of its matvec (the fine operator is level 0)."""
    import torch

    for label, A, M in (("full", U["P"], U["Mf"]), ("sym", U["S"], U["Ms"])):
        levels = []
        for op in (A, *(lv.A for lv in M.levels)):
            x = torch.rand(op.shape[1], device=op.data.device)
            levels.append([op.shape[0], median_ms(lambda: op.matvec(x))])
        emit({"phase": "profile_levels", "hierarchy": label, "levels": len(levels),
              "rows_and_matvec_ms": levels})


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
    ap.add_argument("--paths", default="stencil,unstructured",
                    help="comma-separated: stencil, unstructured, nonsym, krylov")
    ap.add_argument("--out", default="chiprun_out/profile.txt",
                    help="file for every kernel's device time per solve")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_profile: no CUDA device (torch.cuda.is_available() is false)")
    device = torch.device("cuda", 0)
    phase_device()

    paths = args.paths.split(",")
    if not paths or set(paths) - {"stencil", "unstructured", "nonsym", "krylov"}:
        sys.exit(f"chip_profile: unknown --paths {args.paths!r}")

    solves, U = [], None
    if "stencil" in paths:
        solves += _stencil_solves(device, args.nx)
    if "nonsym" in paths:
        solves += _nonsym_solves(device, args.nx)
    if "krylov" in paths:
        solves += _krylov_solves(device, args.nx)
    if "unstructured" in paths:
        U = unstructured_setup(device)
        solves += _unstructured_solves(U)
        solves += _mesh_1m_solves(device)

    # every solve's untraced wall first: a traced run can leave the
    # profiler's hooks behind, slowing the host side of later launches
    walls = {}
    for label, solve in solves:
        solve()  # warm-up
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, info = solve()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        walls[label] = statistics.median(times), info
    if U is not None:
        _level_times(U)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as out:
        for label, solve in solves:
            wall, info = walls[label]
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
                "port_kernels_ms": sum(v[0] for k, v in ranked
                                      if "dia_" in k or "pruned_" in k or "givens_" in k),
                "top": [[k[:70], v[0], v[1]] for k, v in ranked[:6]],
            })
            out.write(f"{label}: {info.iterations} iterations, device busy "
                      f"{busy_ms:.3f} ms, untraced wall {wall * 1e3:.3f} ms\n")
            for name, (ms, count) in ranked:
                out.write(f"  {ms:10.3f} ms  {count:6d}  {name}\n")
            out.write("\n")


if __name__ == "__main__":
    main()
