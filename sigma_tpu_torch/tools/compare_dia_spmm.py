#!/usr/bin/env python3
"""Time the full-storage DIA SpMM kernel ``dia_spmm`` of one checkout.

    python3 sigma_tpu_torch/tools/compare_dia_spmm.py [--repo DIR] [--nx 216]

Imports ``sigma_tpu_torch`` from ``--repo`` (by default the checkout that
holds this script), so one copy of the script times two checkouts of the
port, for example a parent commit unpacked with ``git archive`` beside the
working tree: run it on each in turn (parent, tree, tree, parent) in one
session on one card.  It uses only APIs that every version of the port
has.  Kernels are built into each checkout's own ``build/``.

f32, CUDA events, median of 30 launches: the 7-point stencil at ``nx``
(k = 8, RHS-major, interleaved and column panels), and a band of 245
consecutive diagonals (offsets -122 .. 122) over 10,092,544 rows with
random values (k = 8 and 16, RHS-major and columns), the structure of the
157,696 x 64 irregular mesh's RCM band.  Each product is checked once
against ``dia_spmm_reference`` (relative error at most 1e-5) before it is
timed; a failed check raises.  Prints the card's name and power limit,
then one JSON line a timing.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

BAND_ROWS = 157_696 * 64
BAND_OFFSETS = (-122, 122)


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", type=Path, default=Path(__file__).resolve().parents[2],
                    help="checkout whose sigma_tpu_torch is timed")
    ap.add_argument("--nx", type=int, default=216, help="stencil grid size (nx^3 rows)")
    args = ap.parse_args()
    sys.path.insert(0, str(args.repo.resolve()))

    import torch

    if not torch.cuda.is_available():
        sys.exit("compare_dia_spmm: no CUDA device")
    from sigma_tpu_torch import laplacian_3d_dia
    from sigma_tpu_torch.ops import dia_spmm, dia_spmm_reference, interleave_panels

    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device=device).manual_seed(0)

    def timed(operator, data, X, offs, n, layout, k):
        run = lambda: dia_spmm(data, X, offs, n, n, layout)  # noqa: E731
        Y, ref = run(), dia_spmm_reference(data, X, offs, n, n, layout)
        err = float((Y.double() - ref.double()).abs().max()) / max(float(ref.abs().max()), 1e-300)
        del Y, ref
        if not err <= 1e-5:
            raise AssertionError(f"dia_spmm {operator} {layout} k={k}: rel err {err:.3e}")
        print(json.dumps({"operator": operator, "layout": layout, "k": k, "rel_err": err,
                          "kernel_ms": median_ms(run)}), flush=True)

    A = laplacian_3d_dia(args.nx, torch.float32, device)
    n = A.shape[0]
    XT = torch.rand((8, n), generator=g, device=device)
    for layout, X in (("rhs_major", XT), ("interleaved", interleave_panels(XT, n)),
                      ("cols", XT.T.contiguous())):
        timed(f"stencil_nx{args.nx}", A.data, X, A.offsets_dev, n, layout, 8)
    del A, XT, X
    n = BAND_ROWS
    lo, hi = BAND_OFFSETS
    data = torch.rand((hi - lo + 1, -(-n // 128) * 128), generator=g, device=device)
    offs = torch.arange(lo, hi + 1, device=device)
    for k in (8, 16):
        XT = torch.rand((k, n), generator=g, device=device)
        for layout, X in (("rhs_major", XT), ("cols", XT.T.contiguous())):
            timed(f"band_{hi - lo + 1}", data, X, offs, n, layout, k)
        del XT, X


if __name__ == "__main__":
    main()
