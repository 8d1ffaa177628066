#!/usr/bin/env python3
"""Time the DIA SpMV kernels ``dia_spmv``, ``dia_sym_spmv``,
``dia_spmv_resident`` and ``dia_spmv_window`` of one checkout.

    python3 sigma_tpu_torch/tools/compare_dia_spmv.py [--repo DIR] [--nx 216]

Imports ``sigma_tpu_torch`` from ``--repo`` (by default the checkout that
holds this script), so one copy of the script times two checkouts of the
port, for example a parent commit unpacked with ``git archive`` beside the
working tree: run it on each in turn (parent, tree, tree, parent), one
after the other on one card.  It uses only APIs that every version of the port
has since the staged SpMV (``DIAMatrix.matvec``, ``SymmetricDIAMatrix``,
``dia_spmv_staged``, ``dia_spmv_window``, ``structured_pair_amg``,
``to_banded_dia``).  Kernels are built into each checkout's own ``build/``.

f32 vectors; each product checked once against its plain version
(``dia_spmv_reference``, ``dia_sym_spmv_reference``; relative error at
most 1e-5) before it is timed, a failed check raises.
Three times a product, from CUDA events: ``kernel_ms``, the median of 30
single launches (host time included where it is the longer);
``device_ms``, 50 back-to-back launches over 50 (median of 5 runs; still
the host's time a call where that is the longer, as on a small level);
and ``graph_ms``, the same 50 launches captured in one CUDA graph and
replayed (median of 5 replays), the device's time a launch with no host
in between (null where a call cannot be captured):

- ``dia_spmv`` through ``DIAMatrix.matvec``: the 7-point stencil at
  ``nx`` with f32 and with bf16 values, and a band of 245 consecutive
  diagonals (offsets -122 .. 122) over 10,092,544 rows with random f32
  values, the structure of the 157,696 x 64 irregular mesh's RCM band;
- ``dia_spmv_resident`` through ``dia_spmv_staged`` on every multigrid
  level whose x fits one block's shared memory: the stencil's
  (``structured_pair_amg``, 2x2x2 aggregates, bf16 levels, as
  ``chip_smoke.py`` phase 10 builds it) and the 1,048,576-row mesh band's
  (``irregular_mesh_laplacian(16384, 64, shift=1e-3)``, shuffled, then
  ``to_banded_dia`` and ``structured_pair_amg(D, (n,), coarse_size=4096)``,
  as phases 16-17 build it), each beside ``dia_spmv`` (``A.matvec``) on
  the same operand;
- ``dia_sym_spmv`` through ``SymmetricDIAMatrix.matvec``: the stencil's
  upper diagonals (offsets 0, 1, nx, nx^2) with f32 and with bf16 values,
  and a symmetric band of offsets 0 .. 122 over the band's rows with
  random f32 values (its upper half);
- ``dia_spmv_window`` through ``dia_spmv_staged(..., allow_dma_path=True)``
  on the f32 stencil and the 245-diagonal band (x too large for one
  block's shared memory, so the windowed route);
- all four on the 7-point stencil at nx=32 (32,768 rows, small enough
  that a fixed cost a launch shows against the bytes):
  ``dia_spmv``, ``dia_sym_spmv``, ``dia_spmv_resident`` (the staged
  route there) and ``dia_spmv_window`` (called directly), where
  ``graph_ms`` is the device's own time.

Each beside its bound (the value array, x and y over 3.35 TB/s) and
``torch.sparse_csr @ x`` (cuSPARSE) on the same matrix (bf16 values
widened to f32).  Prints the card's name and power limit, then one JSON
line a product.  Needs a CUDA device.
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


def device_ms(fn, launches=50, reps=5) -> float:
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


def graph_ms(fn, launches=50, reps=5):
    """Device time per launch with the host out of the way: ``launches``
    calls captured in one CUDA graph and replayed, over ``launches``; the
    median of ``reps`` replays.  None where the call cannot be captured."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(launches):
                fn()
    except RuntimeError:
        torch.cuda.synchronize()
        return None
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


def csr_of(A):
    """torch.sparse_csr of the DIAMatrix A's nonzeros, f32 values."""
    import torch

    n, m = A.shape
    rows, cols, vals = [], [], []
    for d, o in enumerate(A.offsets):
        lo, hi = max(0, -o), min(n, m - o)
        i = torch.arange(lo, hi, device=A.data.device)
        v = A.data[d, lo:hi].float()
        keep = v != 0
        rows.append(i[keep])
        cols.append(i[keep] + o)
        vals.append(v[keep])
    r, c, v = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    order = torch.argsort(r * m + c)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=r.device)
    crow[1:] = torch.cumsum(torch.bincount(r, minlength=n), 0)
    return torch.sparse_csr_tensor(crow.int(), c[order].int(), v[order], size=(n, m))


def mesh_band_levels(device):
    """The banded multigrid's levels of the 1M-row mesh band, built as
    chip_smoke.py phases 16-17 build them."""
    import numpy as np
    import torch

    from sigma_tpu_torch import (
        CSRMatrix, irregular_mesh_laplacian, structured_pair_amg, to_banded_dia,
    )

    rng = np.random.default_rng(0)
    A = irregular_mesh_laplacian(16_384, 64, rng=rng, shift=1e-3, dtype=torch.float32,
                                 device=device)
    n = A.shape[0]
    r, c, v = A.entries()
    sh = rng.permutation(n)
    A = CSRMatrix.from_coo(n, n, sh[r], sh[c], v, dtype=torch.float32, device=device)
    D, _ = to_banded_dia(A)
    return structured_pair_amg(D, (n,), coarse_size=4096).levels


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", type=Path, default=Path(__file__).resolve().parents[2],
                    help="checkout whose sigma_tpu_torch is timed")
    ap.add_argument("--nx", type=int, default=216, help="stencil grid size (nx^3 rows)")
    args = ap.parse_args()
    sys.path.insert(0, str(args.repo.resolve()))

    import torch

    if not torch.cuda.is_available():
        sys.exit("compare_dia_spmv: no CUDA device")
    from sigma_tpu_torch import (
        DIAGraph, DIAMatrix, SymmetricDIAMatrix, laplacian_3d_dia, structured_pair_amg,
    )
    from sigma_tpu_torch.ops import (
        dia_spmv_reference, dia_spmv_staged, dia_spmv_window, dia_sym_spmv_reference,
        staged_route,
    )

    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device=device).manual_seed(0)

    def timed(kernel, operator, A, run, csr=True):
        """Check, time and print ``run`` (x -> A x); A a DIAMatrix or a
        SymmetricDIAMatrix, ``csr`` False or the full-storage DIAMatrix
        whose nonzeros cuSPARSE multiplies (True: A itself)."""
        n, m = A.shape
        x = torch.rand(m, generator=g, device=device)
        if isinstance(A, SymmetricDIAMatrix):
            ref = dia_sym_spmv_reference(A.data, x, A.offsets_dev, n)
        else:
            ref = dia_spmv_reference(A.data, x, A.offsets_dev, n, m)
        y = run(x)
        err = float((y.double() - ref.double()).abs().max()) / max(float(ref.abs().max()), 1e-300)
        del y, ref
        if not err <= 1e-5:
            raise AssertionError(f"{kernel} {operator}: rel err {err:.3e}")
        bound_ms = (A.data.numel() * A.data.element_size() + (n + m) * 4) / PEAK_BYTES_PER_S * 1e3
        row = {"kernel": kernel, "operator": operator, "n": n, "n_diags": len(A.offsets),
               "value_dtype": str(A.data.dtype).replace("torch.", ""), "rel_err": err,
               "kernel_ms": median_ms(lambda: run(x)), "device_ms": device_ms(lambda: run(x)),
               "graph_ms": graph_ms(lambda: run(x)), "bound_ms": bound_ms}
        if csr is not False:
            C = csr_of(A if csr is True else csr)
            row["library_ms"] = median_ms(lambda: C @ x)
            row["library_device_ms"] = device_ms(lambda: C @ x)
            row["library_graph_ms"] = graph_ms(lambda: C @ x)
            del C
        print(json.dumps(row), flush=True)

    # dia_spmv, dia_sym_spmv and dia_spmv_window (the windowed route) on
    # the stencil (f32 and bf16 values)
    A = laplacian_3d_dia(args.nx, torch.float32, device)
    n = A.shape[0]
    timed("dia_spmv", f"stencil_nx{args.nx}", A, A.matvec)
    Ab = DIAMatrix(graph=A.graph, data=A.data.to(torch.bfloat16))
    timed("dia_spmv", f"stencil_nx{args.nx}_bf16_values", Ab, Ab.matvec, csr=False)
    del Ab
    S = SymmetricDIAMatrix.from_dia(A)
    timed("dia_sym_spmv", f"stencil_nx{args.nx}", S, S.matvec, csr=A)
    Sb = SymmetricDIAMatrix(data=S.data.to(torch.bfloat16), offsets=S.offsets, n=S.n)
    timed("dia_sym_spmv", f"stencil_nx{args.nx}_bf16_values", Sb, Sb.matvec, csr=False)
    del S, Sb
    timed("dia_spmv_window", f"stencil_nx{args.nx}", A,
          lambda x: dia_spmv_staged(A.data, x, A.offsets, n, n, allow_dma_path=True), csr=False)
    # all four on a stencil below ~33K rows (graph replay: the device's time)
    A32 = laplacian_3d_dia(32, torch.float32, device)
    n32 = A32.shape[0]
    S32 = SymmetricDIAMatrix.from_dia(A32)
    timed("dia_spmv", "stencil_nx32", A32, A32.matvec)
    timed("dia_sym_spmv", "stencil_nx32", S32, S32.matvec, csr=False)
    timed("dia_spmv_resident", "stencil_nx32", A32,
          lambda x: dia_spmv_staged(A32.data, x, A32.offsets, n32, n32), csr=False)
    timed("dia_spmv_window", "stencil_nx32", A32,
          lambda x: dia_spmv_window(A32.data, x, A32.offsets, n32, n32), csr=False)
    del A32, S32
    # the stencil hierarchy's levels (bf16), whose x fits shared memory
    S = SymmetricDIAMatrix.from_dia(laplacian_3d_dia(args.nx, torch.float32, device, diag=6.0))
    levels = [(f"stencil_nx{args.nx}_level{i}", lv.A) for i, lv in enumerate(
        structured_pair_amg(S, (args.nx,) * 3, pairs_per_level=3, level_dtype=torch.bfloat16,
                            smoother="chebyshev", n_smooth=4).levels)]
    del A, S
    lo, hi = BAND_OFFSETS
    n = BAND_ROWS
    offs = tuple(range(lo, hi + 1))
    graph = DIAGraph.from_offsets(list(offs), n, n)
    B = DIAMatrix(graph=graph, data=torch.rand((len(offs), graph.stride), generator=g,
                                               device=device))
    timed("dia_spmv", f"band_{hi - lo + 1}", B, B.matvec, csr=False)
    timed("dia_spmv_window", f"band_{hi - lo + 1}", B,
          lambda x: dia_spmv_staged(B.data, x, B.offsets, n, n, allow_dma_path=True), csr=False)
    del B
    # the symmetric band: offsets 0 .. hi, its upper half
    Sband = SymmetricDIAMatrix(data=torch.rand((hi + 1, graph.stride), generator=g,
                                               device=device), offsets=tuple(range(hi + 1)), n=n)
    timed("dia_sym_spmv", f"band_sym_{hi + 1}", Sband, Sband.matvec, csr=False)
    del Sband
    levels += [(f"band_1m_level{i}", lv.A) for i, lv in enumerate(mesh_band_levels(device))]
    # dia_spmv_resident through the staged entry, beside dia_spmv
    for label, L in levels:
        if not isinstance(L, DIAMatrix) or staged_route(L.shape[1], 4) != "resident":
            continue
        nn, mm = L.shape
        timed("dia_spmv_resident", label, L,
              lambda x, L=L, nn=nn, mm=mm: dia_spmv_staged(L.data, x, L.offsets, nn, mm))
        timed("dia_spmv", label, L, L.matvec, csr=False)


if __name__ == "__main__":
    main()
