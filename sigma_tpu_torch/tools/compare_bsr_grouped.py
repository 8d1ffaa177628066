#!/usr/bin/env python3
"""Time the grouped-BSR kernel ``bsr_grouped_spmv`` of one checkout.

    python3 sigma_tpu_torch/tools/compare_bsr_grouped.py [--repo DIR] [--nx 150]

Imports ``sigma_tpu_torch`` from ``--repo`` (by default the checkout that
holds this script), so one copy of the script times two checkouts of the
port, for example a parent commit unpacked with ``git archive`` beside the
working tree: run it on each in turn (parent, tree, tree, parent), one
after another on one card.  It uses only APIs that every version of the port
since the block path has.  Kernels are built into each checkout's own
``build/``.

f32, on ``chip_smoke.py``'s block-path operators: the block-banded
operator A ((8, 128) blocks in groups of 8) at 8,192 and 65,536 block rows
(k = 1, 4, 8), and the elasticity operator B at ``nx`` as (3, 3)-block BSR
in groups of 8 (k = 1, 4).  Each product is checked once against
``bsr_grouped_spmv_reference`` (relative error at most 1e-5) before it is
timed; a failed check raises.  For each: the single-launch time through
``G.matvec`` / ``G.matmat`` (CUDA events, median of 30) and its device
time (50 back-to-back launches between two events, over 50; median of 5),
the same two for the bare wrapper, the bound (gdata + gcols + group
pointer + x + y bytes over 3.35 TB/s), and cuSPARSE (``torch.sparse_csr``
of the same matrix, as ``chip_smoke.py`` builds it).  Prints the card's
name and power limit, then one JSON line a shape.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", type=Path, default=ROOT,
                    help="checkout whose sigma_tpu_torch is timed")
    ap.add_argument("--nx", type=int, default=150, help="elasticity grid size (3 nx^3 dof)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _library_operands, bound, device_ms, median_ms, rel_err

    sys.path.insert(0, str(args.repo.resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("compare_bsr_grouped: no CUDA device")
    from sigma_tpu_torch import BSRMatrix, block_banded_grouped_bsr
    from sigma_tpu_torch.ops import bsr_grouped_spmv, bsr_grouped_spmv_reference
    from sigma_tpu_torch.problems import elasticity_node_major_coo

    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device=device).manual_seed(14)

    def timed(label, G, ks):
        csr = _library_operands(G)[0]
        for k in ks:
            X = torch.randn((G.shape[1], k), generator=g, device=device)
            wrapper_args = (G.gdata, G.gcols, G.grow, X, G.nb_rows, G.nb_cols, G.block_shape,
                            G.group)
            Y, ref = bsr_grouped_spmv(*wrapper_args, gptr=G.gptr), \
                bsr_grouped_spmv_reference(*wrapper_args)
            err = rel_err(Y, ref)
            del Y, ref
            if not err <= 1e-5:
                raise AssertionError(f"bsr_grouped_spmv {label} k={k}: rel err {err:.3e}")
            Xv = X[:, 0].contiguous() if k == 1 else X
            product = (lambda: G.matvec(Xv)) if k == 1 else (lambda: G.matmat(Xv))
            bare = partial(bsr_grouped_spmv, *wrapper_args, gptr=G.gptr)
            floor = (G.gdata.numel() * 4 + G.gcols.numel() * 4 + G.gptr.numel() * 8
                     + X.numel() * 4 + G.nb_rows * G.block_shape[0] * k * 4)
            print(json.dumps({
                "operator": label, "k": k, "rel_err": err, "form": getattr(G, "form", None),
                "kernel_ms": median_ms(product), "device_ms": device_ms(product),
                "wrapper_ms": median_ms(bare), "wrapper_device_ms": device_ms(bare),
                "bound_ms": bound(floor, 2 * G.stored_slots * k, torch.float32)[0],
                "library_ms": median_ms(lambda: csr @ Xv, reps=10, warmup=2),
                "library_device_ms": device_ms(lambda: csr @ Xv, reps=3),
            }), flush=True)
        del csr
        torch.cuda.empty_cache()

    for nb_rows in (8192, 65536):
        G = block_banded_grouped_bsr(nb_rows, device=device)
        timed(f"A_{nb_rows}", G, (1, 4, 8))
        del G
        torch.cuda.empty_cache()
    N, r, c, v = elasticity_node_major_coo(args.nx, torch.float32, device)
    B = BSRMatrix.from_coo(N, N, r, c, v, dtype=torch.float32, sum_duplicates=False,
                           device=device, block_shape=(3, 3))
    del r, c, v
    G = B.grouped(8)
    del B
    timed(f"B_elasticity_nx{args.nx}", G, (1, 4))


if __name__ == "__main__":
    main()
