#!/usr/bin/env python3
"""Time the DIA SpMM kernels ``dia_spmm`` (full storage) and
``dia_sym_spmm`` (symmetric storage) of one checkout.

    python3 sigma_tpu_torch/tools/compare_dia_spmm.py [--repo DIR] [--nx 216]
        [--kernels dia_spmm,dia_sym_spmm]

Imports ``sigma_tpu_torch`` from ``--repo`` (by default the checkout that
holds this script), so one copy of the script times two checkouts of the
port, for example a parent commit unpacked with ``git archive`` beside the
working tree: run it on each in turn (parent, tree, tree, parent) in one
session on one card.  It uses only APIs that every version of the port
has.  Kernels are built into each checkout's own ``build/``.

f32 values and panels.  ``dia_spmm``: the 7-point stencil at ``nx`` (k = 8,
RHS-major, interleaved and column panels), and a band of 245 consecutive
diagonals (offsets -122 .. 122) over 10,092,544 rows with random values
(k = 8 and 16, RHS-major and columns), the structure of the 157,696 x 64
irregular mesh's RCM band.  ``dia_sym_spmm``: the stencil's 4 upper
diagonals at k = 4, 8 and 16 in all three layouts; the node-major
elasticity operator ``elasticity_node_major_dia(150, symmetric=True)``
(10,125,000 rows, 16 upper diagonals) at k = 4, columns and RHS-major; and
the upper half of the band (offsets 0 .. 122) at k = 8, RHS-major and
columns.

Each product is checked once against its plain version (relative error
at most 1e-5; a failed check raises) and its bits are printed as
``y_sha1``, so two checkouts' results can be compared bit for bit.  Two
times a product, from CUDA events: ``kernel_ms``, the median of 30 single
launches, and ``graph_ms``, 50 launches captured in one CUDA graph and
replayed (median of 5 replays), the device's time a launch with no host in
between; beside ``bound_ms``, the stored values once and the k x and k y
panels over 3.35 TB/s.  Prints the card's name and power limit, then one
JSON line a product.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

BAND_ROWS = 157_696 * 64
BAND_OFFSETS = (-122, 122)
PEAK_BYTES_PER_S = 3.35e12


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


def graph_ms(fn, launches=50, reps=5) -> float:
    """Device time a launch: ``launches`` calls captured in one CUDA graph
    and replayed, over ``launches``; the median of ``reps`` replays after
    one warm replay."""
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", type=Path, default=Path(__file__).resolve().parents[2],
                    help="checkout whose sigma_tpu_torch is timed")
    ap.add_argument("--nx", type=int, default=216, help="stencil grid size (nx^3 rows)")
    ap.add_argument("--kernels", default="dia_spmm,dia_sym_spmm",
                    help="comma-separated: dia_spmm, dia_sym_spmm")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    sys.path.insert(0, str(args.repo.resolve()))

    import torch

    if not torch.cuda.is_available():
        sys.exit("compare_dia_spmm: no CUDA device")
    from sigma_tpu_torch import SymmetricDIAMatrix, laplacian_3d_dia
    from sigma_tpu_torch.ops import (
        dia_spmm, dia_spmm_reference, dia_sym_spmm, dia_sym_spmm_reference, interleave_panels,
    )
    from sigma_tpu_torch.problems import elasticity_node_major_dia

    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device=device).manual_seed(0)

    def layouts(XT, names):
        n = XT.shape[1]
        made = {"rhs_major": lambda: XT, "interleaved": lambda: interleave_panels(XT, n),
                "cols": lambda: XT.T.contiguous()}
        return [(name, made[name]()) for name in names]

    def timed(kernel, operator, data, X, offs, n, layout, k):
        if kernel == "dia_sym_spmm":
            run = lambda: dia_sym_spmm(data, X, offs, n, layout)  # noqa: E731
            ref = dia_sym_spmm_reference(data, X, offs, n, layout)
        else:
            run = lambda: dia_spmm(data, X, offs, n, n, layout)  # noqa: E731
            ref = dia_spmm_reference(data, X, offs, n, n, layout)
        Y = run()
        err = float((Y.double() - ref.double()).abs().max()) / max(float(ref.abs().max()), 1e-300)
        sha = hashlib.sha1(Y.cpu().numpy().tobytes()).hexdigest()
        del Y, ref
        if not err <= 1e-5:
            raise AssertionError(f"{kernel} {operator} {layout} k={k}: rel err {err:.3e}")
        nbytes = data.numel() * data.element_size() + 2 * k * n * X.element_size()
        print(json.dumps({"kernel": kernel, "operator": operator, "layout": layout, "k": k,
                          "rel_err": err, "y_sha1": sha, "kernel_ms": median_ms(run),
                          "graph_ms": graph_ms(run),
                          "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}), flush=True)

    A = laplacian_3d_dia(args.nx, torch.float32, device)
    n = A.shape[0]
    stencil = f"stencil_nx{args.nx}"
    if "dia_spmm" in kernels:
        XT = torch.rand((8, n), generator=g, device=device)
        for layout, X in layouts(XT, ("rhs_major", "interleaved", "cols")):
            timed("dia_spmm", stencil, A.data, X, A.offsets_dev, n, layout, 8)
        del XT, X
    if "dia_sym_spmm" in kernels:
        S = SymmetricDIAMatrix.from_dia(A)
        for k in (4, 8, 16):
            XT = torch.rand((k, n), generator=g, device=device)
            for layout, X in layouts(XT, ("rhs_major", "interleaved", "cols")):
                timed("dia_sym_spmm", stencil, S.data, X, S.offsets_dev, n, layout, k)
            del XT, X
        del S
        E = elasticity_node_major_dia(150, torch.float32, device, symmetric=True)
        XT = torch.rand((4, E.n), generator=g, device=device)
        for layout, X in layouts(XT, ("rhs_major", "cols")):
            timed("dia_sym_spmm", "elasticity_node_major_150", E.data, X, E.offsets_dev, E.n,
                  layout, 4)
        del E, XT, X
    del A
    n = BAND_ROWS
    lo, hi = BAND_OFFSETS
    data = torch.rand((hi - lo + 1, -(-n // 128) * 128), generator=g, device=device)
    offs = torch.arange(lo, hi + 1, device=device)
    if "dia_spmm" in kernels:
        for k in (8, 16):
            XT = torch.rand((k, n), generator=g, device=device)
            for layout, X in layouts(XT, ("rhs_major", "cols")):
                timed("dia_spmm", f"band_{hi - lo + 1}", data, X, offs, n, layout, k)
            del XT, X
    if "dia_sym_spmm" in kernels:
        upper = data[-lo:].contiguous()  # offsets 0 .. 122
        del data
        XT = torch.rand((8, n), generator=g, device=device)
        for layout, X in layouts(XT, ("rhs_major", "cols")):
            timed("dia_sym_spmm", f"band_upper_{hi + 1}", upper, X, offs[-lo:].contiguous(), n,
                  layout, 8)


if __name__ == "__main__":
    main()
