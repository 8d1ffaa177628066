#!/usr/bin/env python3
"""Time the pruned SpMM kernels ``pruned_spmm`` (#11) and
``pruned_sym_spmm`` (#13) of one checkout.

    python3 sigma_tpu_torch/tools/compare_pruned_spmm.py [--repo DIR] [--cache DIR]

Imports ``sigma_tpu_torch`` from ``--repo`` (by default the checkout that
holds this script), so one copy of the script times two checkouts of the
port, for example a parent commit unpacked with ``git archive`` beside the
working tree: run it on each in turn (parent, tree, tree, parent), one
after the other on one card.  It calls the kernels through the matrix
classes' own product (``PrunedDIAMatrix._spmm`` and
``SymmetricPrunedDIAMatrix._spmm``, which every version of the port has),
so each checkout passes what its matrices pass.  Kernels are built into
each checkout's own ``build/``.  ``--cache DIR`` keeps the meshes' RCM
triples there (about 1.4 GB for the large one): the first run writes them,
later runs read them instead of generating and reordering again.

Operands, as ``chip_smoke.py`` builds them: the shuffled
``irregular_mesh_laplacian_coo(157696, 64, shift=1e-3)`` mesh (10,092,544
rows) after RCM, packed with tile_rows 16384 in full storage (group 8)
and symmetric storage (group 12), f32 values and panels, at k in
{4, 8, 16} in both panel layouts; the 1,048,576-row mesh
(``16384 x 64``) at k = 8; and every coarser level of that mesh's pruned
pair multigrid (``pruned_pair_amg(coarse_size=4096, smoother="chebyshev")``
over the full and the symmetric storage: 524,288 rows down to 8,192) at
k = 8, where ``graph_ms`` is the device's own time.
RHS-major panels are a (k, n) tensor, column panels an (n, k) one.

Each product is checked once against its plain version
(``pruned_spmm_reference``, ``pruned_sym_spmm_reference``; relative error
at most 1e-5; a failed check raises) and its bits are printed as
``y_sha1``, so two checkouts' results can be compared bit for bit.  Three
times a product, from CUDA events: ``kernel_ms``, the median of 30 single
launches; ``device_ms``, 50 back-to-back launches over 50 (median of 5
runs; the host's time a call where that is the longer, as on a small
level); ``graph_ms``, the same 50 launches captured in one CUDA graph and
replayed (median of 5 replays), the device's time a launch with no host in
between.  Each beside its bound (the active slots' values, the k x panels
and the k y panels once, over 3.35 TB/s) and ``torch.sparse_csr @ X``
(cuSPARSE) on the full matrix's nonzeros with the same panels (the
RHS-major ones as the column-major (n, k) block ``XT.T``).  Prints the
card's name and power limit, then one JSON line a product.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

PEAK_BYTES_PER_S = 3.35e12
MESH_SHIFT = 1e-3


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


def mesh_triples(height, width, cache):
    """(n, rows, cols, f32 values) of the shuffled mesh after RCM, as
    chip_smoke.py's unstructured_setup makes them; read from / written to
    ``cache`` when given."""
    import numpy as np

    from sigma_tpu_torch import irregular_mesh_laplacian_coo, reorder_triples_rcm

    path = None if cache is None else Path(cache) / f"mesh_{height}x{width}_seed0.npz"
    if path is not None and path.exists():
        z = np.load(path)
        return int(z["n"]), z["pr"], z["pc"], z["vals"]
    n, rows, cols, vals = irregular_mesh_laplacian_coo(
        height, width, rng=np.random.default_rng(0), shift=MESH_SHIFT, shuffle=True)
    pr, pc, vals, _ = reorder_triples_rcm(n, rows, cols, vals)
    vals = vals.astype(np.float32)
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, n=n, pr=pr, pc=pc, vals=vals)
    return n, pr, pc, vals


def csr_of(rows, cols, vals, n, device):
    """torch.sparse_csr (int32 indices, f32 values) of host COO triples."""
    import numpy as np
    import torch

    order = np.lexsort((cols, rows))
    crow = np.zeros(n + 1, dtype=np.int64)
    crow[1:] = np.cumsum(np.bincount(rows, minlength=n))
    return torch.sparse_csr_tensor(
        torch.from_numpy(crow).to(device, torch.int32),
        torch.from_numpy(cols[order]).to(device, torch.int32),
        torch.from_numpy(np.asarray(vals[order], dtype=np.float32)).to(device), size=(n, n))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose sigma_tpu_torch is timed")
    ap.add_argument("--cache", default=None, help="directory for the meshes' RCM triples")
    args = ap.parse_args()
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))

    import torch

    if not torch.cuda.is_available():
        sys.exit("compare_pruned_spmm: no CUDA device")
    import sigma_tpu_torch as st
    from sigma_tpu_torch.ops import _build, pruned_spmm_reference, pruned_sym_spmm_reference

    if not Path(st.__file__).resolve().is_relative_to(repo):
        sys.exit(f"imported {st.__file__}, not the checkout at {repo}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    b = _build.build()
    print(json.dumps({"repo": str(repo), "card": smi, "build_seconds": round(b.seconds, 3)}),
          flush=True)
    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(0)

    def timed(kernel, operator, A, k, layout, csr):
        """Check, time and print A's SpMM at k panels in ``layout``."""
        n = A.shape[0]
        XT = torch.rand((k, n), generator=g, device=device)
        X = XT if layout == "rhs_major" else XT.T.contiguous()
        if kernel == "pruned_sym_spmm":
            ref = pruned_sym_spmm_reference(A.data, X, A.offsets, A.tile_ptr, n, n, layout,
                                            halo=A.halo, group=A.group)
        else:
            ref = pruned_spmm_reference(A.data, X, A.offsets, A.tile_ptr, n, n, layout,
                                        group=A.group)
        y = A._spmm(X, layout)
        err = float((y.double() - ref.double()).abs().max()) / max(float(ref.abs().max()), 1e-300)
        digest = hashlib.sha1(y.contiguous().cpu().numpy().tobytes()).hexdigest()
        del y, ref
        if not err <= 1e-5:
            raise AssertionError(f"{kernel} {operator} {layout} k={k}: rel err {err:.3e}")
        active = int(A.data.ne(0).any(1).sum())
        byts = active * A.data.shape[1] * A.data.element_size() + 2 * k * n * 4
        run = lambda: A._spmm(X, layout)  # noqa: E731
        lib = (lambda: csr @ XT.T) if layout == "rhs_major" else (lambda: csr @ X)
        row = {"kernel": kernel, "operator": operator, "layout": layout, "k": k, "n": n,
               "slots": A.data.shape[0], "active_slots": active, "rel_err": err,
               "y_sha1": digest, "kernel_ms": median_ms(run), "device_ms": device_ms(run),
               "graph_ms": graph_ms(run), "bound_ms": byts / PEAK_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "library_ms": median_ms(lib),
               "library_device_ms": device_ms(lib), "library_graph_ms": graph_ms(lib)}
        print(json.dumps(row), flush=True)

    def storages(n, pr, pc, vals):
        P = st.PrunedDIAMatrix.from_coo(n, n, pr, pc, vals, tile_rows=16384, group=8,
                                        assume_unique=True, device=device)
        S = st.SymmetricPrunedDIAMatrix.from_coo(n, n, pr, pc, vals, tile_rows=16384, group=12,
                                                 assume_unique=True, validate=False,
                                                 device=device)
        return P, S

    # the 10.1M-row mesh at every k, both layouts
    n, pr, pc, vals = mesh_triples(157_696, 64, args.cache)
    P, S = storages(n, pr, pc, vals)
    csr = csr_of(pr, pc, vals, n, device)
    del pr, pc, vals
    for k in (4, 8, 16):
        for layout in ("rhs_major", "cols"):
            timed("pruned_spmm", "mesh_10m", P, k, layout, csr)
            timed("pruned_sym_spmm", "mesh_10m", S, k, layout, csr)
    del P, S, csr
    torch.cuda.empty_cache()
    # the 1M-row mesh at k = 8, and its multigrid's coarser levels
    n, pr, pc, vals = mesh_triples(16_384, 64, args.cache)
    P, S = storages(n, pr, pc, vals)
    csr = csr_of(pr, pc, vals, n, device)
    for layout in ("rhs_major", "cols"):
        timed("pruned_spmm", "mesh_1m", P, 8, layout, csr)
        timed("pruned_sym_spmm", "mesh_1m", S, 8, layout, csr)
    Mf = st.pruned_pair_amg(n, pr, pc, vals, coarse_size=4096, smoother="chebyshev", group=8,
                            fine_A=P)
    Ms = st.pruned_pair_amg(n, pr, pc, vals, coarse_size=4096, smoother="chebyshev", group=12,
                            fine_A=S, symmetric=True, validate=False)
    for kernel, M in (("pruned_spmm", Mf), ("pruned_sym_spmm", Ms)):
        for lv in M.levels[1:]:
            L = lv.A
            Lcsr = csr_of(*L.entries(), L.shape[0], device)
            for layout in ("rhs_major", "cols"):
                timed(kernel, f"mesh_1m_level_{L.shape[0]}", L, 8, layout, Lcsr)


if __name__ == "__main__":
    main()
