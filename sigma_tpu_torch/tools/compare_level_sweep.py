#!/usr/bin/env python3
"""Time ILDU's level-sweep kernel (``csrc/ildu_sweep.cu``) of one checkout
on the factors of ``benchmarks/ildu3d.py``'s operator, and PCG with them.

    python3 sigma_tpu_torch/tools/compare_level_sweep.py [--repo DIR] [--nx 100]

Imports ``sigma_tpu_torch`` from ``--repo`` (by default the checkout that
holds this script), so one copy of the script times two checkouts of the
port, for example a parent commit unpacked with ``git archive`` beside the
working tree: run it on each in turn (parent, tree, tree, parent), one
after the other on one card.  It uses only APIs that every version of the
port has had since the sweep kernel (``ops.level_sweep``,
``ops.level_sweep_reference``, ``ldu``, ``greedy_color_ordering``,
``distributed_block_ildu``); kernels are built into each checkout's own
``build/``.

The operator is the 7-point Laplacian + I at ``nx`` (1,000,000 rows at
nx = 100) as its f32 CSR copy; the factors ILDU(0) and ILU(1) in natural
order, ILDU(0) after a greedy colour ordering and the block ILDU(0) of a
4-shard mesh on the card.  For each factor's forward and backward sweep,
values and vector in f32 and in f64, one JSON line:

- ``ms``: the median of 30 single launches (CUDA events) with
  ``max_rows`` a quarter, half, once and twice the widest level's rows
  (``quarter``, ``half``, ``sized``, ``double``; ``sized`` is what
  ``TriangularLevels.solve`` passes) and 2^40 (``coresident``: the
  grid's co-resident maximum), with the blocks each launched where the
  checkout reports them (``ops.level_sweep_blocks``), else null (a
  kernel that sizes its grid as ``ceil(max_rows / 256)`` blocks launches
  a quarter, half, once and twice the widest level's blocks there);
- ``chain_ms``: the same on a pure chain of ``nlev`` one-row levels, each
  depending on the one before (the dependency latency alone at the
  factor's depth), on the grids ``sized`` and ``coresident``;
- ``bound_ms``: the bytes (rows, the real entries' cols and vals, b, x
  read once and written once) over 3.35 TB/s, every case here bound by
  bytes (``chip_smoke.py``'s ``level_sweep_checks`` times cuSPARSE beside
  it);
- ``x_sha256``: a hash of x's bytes, equal on every grid (else the script
  fails) and, across checkouts, equal where two kernels give the same
  bits; ``max_rel_err`` against the plain version (at most 1e-5 in f32
  and 1e-12 in f64, else the script fails).

Then one line a factor with PCG (``cg_solve``, rtol 1e-6, maxiter 200, b
= A x*, x*_i = sin(0.001 i)) eagerly: ``apply_ms`` (median of 10) and
``pcg_ms`` (host clock to a synchronised end, median of 5 after one
warm-up solve) with its iteration count.  Prints the card's name and
power limit first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

PEAK_BYTES_PER_S = 3.35e12
ALL_ROWS = 1 << 40
RTOL = {"torch.float32": 1e-5, "torch.float64": 1e-12}


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


def chain(nlev, dt, device):
    """A pure chain of ``nlev`` one-row levels packed for the sweep."""
    import torch

    rows = torch.arange(nlev, device=device)
    vals = torch.full((nlev, 1), 0.5, dtype=dt, device=device)
    vals[0] = 0.0
    return rows, (rows - 1).clamp_min(0)[:, None], vals, torch.arange(nlev + 1, device=device)


def factors(st, nx, device):
    """The operator (DIA), b, and {label: (preconditioner, its operator,
    (lower, upper))}."""
    import torch

    from sigma_tpu_torch.parallel import distribute_matrix, distributed_block_ildu, make_mesh

    A = st.laplacian_3d_dia(nx, torch.float32, device)
    n = A.shape[0]
    b = A.matvec(torch.sin(torch.arange(n, dtype=torch.float32, device=device) * 0.001))
    r, c, v = A.entries()
    keep = v != 0
    r, c, v = r[keep], c[keep], v[keep]
    C = st.CSRMatrix.from_coo(n, n, r, c, v, dtype=torch.float32, device=device)
    out = {}
    for label, level in (("ildu0", 0), ("ilu1", 1)):
        M = st.ldu(level=level).setup(C)
        out[label] = (M, A, (M.lower, M.upper))
    p, _ = st.greedy_color_ordering(C.graph)
    Mc = st.ldu().setup(st.CSRMatrix.from_coo(n, n, p[r], p[c], v, dtype=torch.float32,
                                              device=device))
    pt = torch.from_numpy(p).to(device)
    Mp = st.MatvecOperator(params=(Mc, pt, torch.argsort(pt)),
                           mv=lambda q, x: q[0].matvec(x[q[2]])[q[1]], rmv=None, shape=A.shape)
    out["ildu0_colored"] = (Mp, A, (Mc.lower, Mc.upper))
    mesh = make_mesh(4, device=device)
    Mb = distributed_block_ildu(C, mesh)
    out["block_ildu0"] = (Mb, distribute_matrix(C, mesh), (Mb.lower, Mb.upper))
    return A, b, out


def sweep_rows(ops, T, label, side, device):
    import numpy as np
    import torch

    ops_blocks = getattr(ops, "level_sweep_blocks", None)
    for dt in (torch.float32, torch.float64):
        vals = T.vals.to(dt)
        b = torch.from_numpy(np.random.default_rng(27).standard_normal(T.n)).to(device, dt)
        args = (T.rows, T.cols, vals, T._ptr, b)
        ch = (*chain(T.nlev, dt, device), b[:T.nlev])
        widest = T._max_rows
        grids = {"quarter": max(widest // 4, 1), "half": max(widest // 2, 1), "sized": widest,
                 "double": 2 * widest, "coresident": ALL_ROWS}
        xs = {g: ops.level_sweep(*args, m) for g, m in grids.items()}
        x = xs["sized"]
        if not all(torch.equal(x, y) for y in xs.values()):
            raise AssertionError(f"{label} {side} {dt}: the grids' x differ")
        ref = ops.level_sweep_reference(*args)
        err = float((x.double() - ref.double()).abs().max() / ref.double().abs().max())
        if not err <= RTOL[str(dt)]:
            raise AssertionError(f"{label} {side} {dt}: rel err {err:.3e}")
        real = int((T.cols != T.rows[:, None]).sum())
        nbytes = 8 * T.n + real * (8 + vals.element_size()) + 3 * b.element_size() * T.n
        width = T.cols.shape[1]
        print(json.dumps({
            "factor": label, "side": side, "dtype": str(dt), "n": T.n, "nlev": T.nlev,
            "width": width, "max_rows": T._max_rows, "entries": real,
            "ms": {g: median_ms(lambda m=m: ops.level_sweep(*args, m)) for g, m in grids.items()},
            "blocks": {g: (ops_blocks(dt, dt, width, m, device) if ops_blocks else None)
                       for g, m in grids.items()},
            "chain_ms": {g: median_ms(lambda m=m: ops.level_sweep(*ch, m))
                         for g, m in (("sized", T._max_rows), ("coresident", ALL_ROWS))},
            "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "x_sha256": hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16],
            "max_rel_err": err,
        }), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose sigma_tpu_torch is timed")
    ap.add_argument("--nx", type=int, default=100)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    import sigma_tpu_torch as st
    from sigma_tpu_torch import ops

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(json.dumps({"repo": str(Path(st.__file__).resolve().parents[1]), "nx": args.nx}))
    device = torch.device("cuda", 0)
    A, b, fs = factors(st, args.nx, device)
    for label, (_, _, sides) in fs.items():
        for side, T in zip(("lower", "upper"), sides):
            sweep_rows(ops, T, label, side, device)
    for label, (M, Aop, _) in fs.items():
        def solve():
            out = st.cg_solve(Aop, b, tol=0.0, rtol=1e-6, maxiter=200, M=M)
            torch.cuda.synchronize()
            return out

        _, info = solve()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            solve()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps({"factor": label, "apply_ms": median_ms(lambda: M.matvec(b), reps=10),
                          "pcg_ms": statistics.median(walls), "iterations": info.iterations,
                          "converged": bool(info.converged)}), flush=True)


if __name__ == "__main__":
    main()
