#!/usr/bin/env python3
"""The distributed layer's dry run: every distributed path against its
one-shard twin.

    python -m sigma_tpu_torch.tools.dryrun_multichip [--shards 8] [--device cpu]
    python -m sigma_tpu_torch.tools.dryrun_multichip --ranks 4 --backend gloo [--device cpu]

Port of the JAX package's ``__graft_entry__.dryrun_multichip``.  It builds
a mesh of ``n_devices`` shards on ``device`` (None: CUDA), or with
``--ranks N`` spawns N ranks (:func:`~sigma_tpu_torch.parallel.ranks.launch`:
``--backend nccl`` a card a rank, ``gloo`` on ``--device``, the card by
default) that each run the same paths on their rank mesh, and runs, in
float64, each distributed solve beside the same solve on the
single-device operator: CG on the ELL and DIA layouts, CG + AMG, CG +
block-Jacobi ILDU (which has no single-device twin: finiteness and use in
CG are checked), Chebyshev-preconditioned flexible CG, block CG, Lanczos,
CGLS on a rectangular matrix, GMRES, BiCG-stab and MINRES on 2,304 rows,
the wide-band DIA layout of an RCM-banded mesh, the pruned layout (one
and two tiles a shard, symmetric storage), FGMRES with an inner CG,
pruned block CG and CGLS, pruned pair multigrid and structured pair
multigrid.  Each pair must take the same iteration count and agree to
1e-10 relative (1e-8 for the block paths, whose panel algebra amplifies
rounding), as the JAX dry run holds its f64 mesh.  Prints one line a path
and raises on the first mismatch.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

PTOL = 1e-10
BTOL = 1e-8  # block panel algebra


def _laplacian_2d(nx):
    """5-point stencil Laplacian + I on an nx * nx grid, as symmetric COO
    triples (the JAX dry run's operator)."""
    n = nx * nx
    idx = np.arange(n).reshape(nx, nx)
    rows, cols, vals = [np.arange(n)], [np.arange(n)], [np.full(n, 5.0)]
    for axis in range(2):
        src = np.take(idx, np.arange(nx - 1), axis=axis).ravel()
        dst = np.take(idx, np.arange(1, nx), axis=axis).ravel()
        rows.extend([src, dst])
        cols.extend([dst, src])
        vals.extend([np.full(src.size, -1.0)] * 2)
    return n, np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def _stencil_3d(dims):
    """7-point stencil (6 on the diagonal) on a grid of ``dims``, as COO."""
    ng = int(np.prod(dims))
    idx = np.arange(ng)
    coords = np.unravel_index(idx, dims)
    strides = (dims[1] * dims[2], dims[2], 1)
    rows, cols, vals = [idx], [idx], [np.full(ng, 6.0)]
    for ax in range(3):
        for s in (+1, -1):
            mk = (coords[ax] + s >= 0) & (coords[ax] + s < dims[ax])
            rows.append(idx[mk])
            cols.append(idx[mk] + s * strides[ax])
            vals.append(np.full(int(mk.sum()), -1.0))
    return ng, np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def dryrun_multichip(n_devices: int, device=None, verbose: bool = True, *, mesh=None) -> dict:
    """Run every distributed path on a mesh of ``n_devices`` shards on
    ``device`` (None: CUDA) beside its one-shard twin; returns ``{path:
    {"err": relative error, "iterations": (distributed, single), ...}}``
    and raises AssertionError on a mismatch.  Given a rank ``mesh``
    (every rank calls this), the distributed paths run on it, each rank
    beside its own one-shard twin, and rank 0 prints."""
    import sigma_tpu_torch as st
    from sigma_tpu_torch.eigen import lanczos
    from sigma_tpu_torch.parallel import (
        distribute_amg,
        distribute_matrix,
        distribute_matrix_dia,
        distribute_pruned,
        distribute_structured_amg,
        distributed_block_ildu,
        distributed_pruned_pair_amg,
        make_mesh,
    )
    from sigma_tpu_torch.solvers import (
        bicgstab_solve,
        block_cg_solve,
        cg_solve,
        cgls_solve,
        chebyshev,
        fgmres_solve,
        gmres_solve,
        minres_solve,
        pruned_pair_amg,
        smoothed_aggregation_amg,
        structured_pair_amg,
    )
    from sigma_tpu_torch.utils.device import resolve_device
    from sigma_tpu_torch.utils.sharded import gathered

    if mesh is None:
        dev = resolve_device(device)
        mesh = make_mesh(n_devices, device=dev)
    else:
        dev, n_devices = mesh.device, mesh.n_shards
    DT = torch.float64
    out = {}
    lead = getattr(mesh, "rank", 0) == 0

    def say(line):
        if verbose and lead:
            print(line, flush=True)

    def host(x):
        return gathered(x).detach().cpu().numpy()

    def parity(name, n, x_d, it_d, x_ref, it_ref, tol=PTOL, **extra):
        xd, xr = host(x_d)[:n], host(x_ref)[:n]
        err = float(np.abs(xd - xr).max() / max(float(np.abs(xr).max()), 1e-30))
        ok = err < tol and int(it_d) == int(it_ref)
        say(f"dryrun_multichip[{name}] {'parity ok' if ok else 'PARITY FAIL'} "
            f"(err={err:.2e}, iters {int(it_d)}={int(it_ref)})")
        out[name] = dict(err=err, iterations=(int(it_d), int(it_ref)), **extra)
        if not ok:
            raise AssertionError(f"{name}: distributed/single mismatch err={err:.3e} "
                                 f"iters {int(it_d)} vs {int(it_ref)}")

    def ones(n_pad, n, k=None):
        b = torch.zeros((n_pad,) if k is None else (n_pad, k), dtype=DT, device=dev)
        b[:n] = 1.0
        return b

    n, r, c, v = _laplacian_2d(8)  # 64 rows
    A = st.CSRMatrix.from_coo(n, n, r, c, v, dtype=DT, device=dev)
    b1 = torch.ones(n, dtype=DT, device=dev)
    x_ref, i_ref = cg_solve(A, b1, tol=1e-4, maxiter=3)

    # both layouts: ELL local blocks and gather-free DIA locals
    for name, Ad in (("ell", distribute_matrix(A, mesh)), ("dia", distribute_matrix_dia(A, mesh))):
        x, info = cg_solve(Ad, Ad.shard_vector(host(b1)), tol=1e-4, maxiter=3)
        assert x.shape == (Ad.n_pad,)
        rings = (sorted(k for k in dict.fromkeys(Ad.offsets) if k != 0) if name == "ell"
                 else sorted({k for k, _ in Ad.terms if k != 0}))
        say(f"dryrun_multichip[{name}] ok: {n_devices} shards, halo_words_per_shard_per_spmv="
            f"{ {int(k): Ad.block for k in rings} }")
        parity(name, n, x, info.iterations, x_ref, i_ref.iterations)

    Ad = distribute_matrix(A, mesh)
    b = Ad.shard_vector(host(b1))

    # AMG-preconditioned CG: host-built hierarchy, distributed levels
    M1 = smoothed_aggregation_amg(A, coarse_size=16, max_levels=2)
    x, info = cg_solve(Ad, b, tol=1e-4, maxiter=3, M=distribute_amg(M1, mesh))
    xr, ir = cg_solve(A, b1, tol=1e-4, maxiter=3, M=M1)
    parity("amg", n, x, info.iterations, xr, ir.iterations)

    # block-Jacobi ILDU(0): one factorization per shard, a different
    # operator at each shard count, so no single-device twin exists
    x, info = cg_solve(Ad, b, tol=1e-4, maxiter=3, M=distributed_block_ildu(A, mesh))
    if not np.isfinite(host(x)).all():
        raise AssertionError("block_ildu: non-finite iterate")
    out["block_ildu"] = dict(iterations=(int(info.iterations), None))
    say(f"dryrun_multichip[block_ildu] ok: iters={info.iterations} (partition-dependent "
        "preconditioner: finiteness + use-in-CG checked; no single-device twin exists)")

    # Chebyshev-preconditioned flexible CG: the polynomial's matvecs are
    # the distributed SpMV
    x, info = cg_solve(Ad, b, tol=1e-4, maxiter=3, flexible=True,
                       M=chebyshev(Ad, degree=4, lmax=9.0, lmin=0.3))
    xr, ir = cg_solve(A, b1, tol=1e-4, maxiter=3, flexible=True,
                      M=chebyshev(A, degree=4, lmax=9.0, lmin=0.3))
    parity("chebyshev", n, x, info.iterations, xr, ir.iterations)

    # block CG with 4 right-hand sides: one matmat an iteration
    X, info = block_cg_solve(Ad, Ad.shard_vector(np.ones((n, 4))), tol=1e-4, maxiter=3)
    Xr, ir = block_cg_solve(A, ones(n, n, 4), tol=1e-4, maxiter=3)
    parity("block_cg", n, X, info.iterations, Xr, ir.iterations, tol=BTOL)

    # Lanczos: the recurrence coefficients are the layout-invariant
    # observables (padded slots of v0 must be zero)
    res = lanczos(Ad, 4, v0=Ad.shard_vector(np.ones(n)))
    res1 = lanczos(A, 4, v0=ones(n, n))
    errT = max(float((res.alpha - res1.alpha).abs().max()), float((res.beta - res1.beta).abs().max()))
    say(f"dryrun_multichip[lanczos] parity {'ok' if errT < PTOL else 'FAIL'}: k=4, "
        f"max |T_dist - T_single| = {errT:.2e}")
    out["lanczos"] = dict(err=errT, iterations=(4, 4))
    if not errT < PTOL:
        raise AssertionError(f"lanczos: |T_dist - T_single| = {errT:.3e}")

    # rectangular least squares: a forward and a reversed exchange an
    # iteration
    nr, nc = n, 24
    rng = np.random.default_rng(0)
    dls = np.where(rng.random((nr, nc)) < 0.2, 1.0, 0.0)
    dls[np.arange(nc), np.arange(nc)] += 3.0
    Als1 = st.CSRMatrix.from_coo(nr, nc, *np.nonzero(dls), dls[np.nonzero(dls)], dtype=DT,
                                 device=dev)
    Als = distribute_matrix(Als1, mesh)
    x, info = cgls_solve(Als, Als.shard_vector(np.ones(nr)), tol=1e-4, maxiter=3)
    xr, ir = cgls_solve(Als1, torch.ones(nr, dtype=DT, device=dev), tol=1e-4, maxiter=3)
    parity("cgls", nc, x, info.iterations, xr, ir.iterations)

    # nonsymmetric solvers on 2,304 rows (several hundred a shard): an
    # upwinded advection-diffusion operator, MINRES on the Laplacian
    nn, rn, cn, vn = _laplacian_2d(48)
    vnn = vn.copy()
    vnn[cn == rn + 1] = -1.5
    vnn[cn == rn - 1] = -0.5
    An = st.CSRMatrix.from_coo(nn, nn, rn, cn, vnn, dtype=DT, device=dev)
    Asym = st.CSRMatrix.from_coo(nn, nn, rn, cn, vn, dtype=DT, device=dev)
    bn = torch.ones(nn, dtype=DT, device=dev)
    for name, solve, A1 in (
        ("gmres", lambda A_, b_: gmres_solve(A_, b_, tol=1e-4, maxiter=6, restart=6), An),
        ("bicgstab", lambda A_, b_: bicgstab_solve(A_, b_, tol=1e-4, maxiter=6), An),
        ("minres", lambda A_, b_: minres_solve(A_, b_, tol=1e-4, maxiter=6), Asym),
    ):
        Ads = distribute_matrix(A1, mesh)
        xs, infos = solve(Ads, Ads.shard_vector(host(bn)))
        xr, ir = solve(A1, bn)
        parity(name, nn, xs, infos.iterations, xr, ir.iterations)

    # the wide band: an RCM-banded irregular mesh (tens of diagonals)
    # through DistributedDIAMatrix, several ring terms
    rngw = np.random.default_rng(1)
    Aw = st.irregular_mesh_laplacian(96, 24, rng=rngw, dtype=np.float64, device=dev)
    nw = Aw.shape[0]
    rw, cw, vw = Aw.entries()
    shw = rngw.permutation(nw)
    Aw = st.CSRMatrix.from_coo(nw, nw, shw[rw], shw[cw], vw, dtype=DT, device=dev)
    Dw, pw = st.to_banded_dia(Aw)
    Awd = distribute_matrix_dia(Dw, mesh)
    bw = torch.ones(nw, dtype=DT, device=dev)
    xw, infow = cg_solve(Awd, Awd.shard_vector(host(bw)), tol=1e-4, maxiter=3)
    xwr, iwr = cg_solve(Dw, bw, tol=1e-4, maxiter=3)
    parity("wideband_dia", nw, xw, infow.iterations, xwr, iwr.iterations,
           diagonals=Dw.graph.n_diags, rings=len({k for k, _ in Awd.terms}))

    # the pruned layout (one tile a shard, two tiles a shard, symmetric
    # storage) beside its single-device twin over the padded index space
    rwp, cwp, vwp = Aw.entries()
    prw, pcw = pw[rwp], pw[cwp]
    Apd = distribute_pruned(nw, prw, pcw, vwp, mesh, tile_rows=1024, group=4)
    P1 = st.PrunedDIAMatrix.from_coo(Apd.n_pad, Apd.n_pad, prw, pcw, vwp,
                                     tile_rows=min(1024, Apd.block), group=4, device=dev)
    bp, bp1 = Apd.shard_vector(np.ones(nw)), ones(Apd.n_pad, nw)
    xp, infop = cg_solve(Apd, bp, tol=1e-4, maxiter=3)
    xpr, ipr = cg_solve(P1, bp1, tol=1e-4, maxiter=3)
    parity("pruned", nw, xp, infop.iterations, xpr, ipr.iterations, block=Apd.block,
           halo=Apd.halo_words)

    Apm = distribute_pruned(nw, prw, pcw, vwp, mesh, tile_rows=1024, group=4, block=2048,
                            assume_unique=True)
    P1m = st.PrunedDIAMatrix.from_coo(Apm.n_pad, Apm.n_pad, prw, pcw, vwp, tile_rows=1024,
                                      group=4, assume_unique=True, device=dev)
    xm, infom = cg_solve(Apm, Apm.shard_vector(np.ones(nw)), tol=1e-4, maxiter=3)
    xmr, imr = cg_solve(P1m, ones(Apm.n_pad, nw), tol=1e-4, maxiter=3)
    parity("pruned_multitile", nw, xm, infom.iterations, xmr, imr.iterations,
           tiles_per_shard=Apm.block // 1024)

    Aps = distribute_pruned(nw, prw, pcw, vwp, mesh, tile_rows=1024, group=4, symmetric=True)
    S1 = st.SymmetricPrunedDIAMatrix.from_coo(Aps.n_pad, Aps.n_pad, prw, pcw, vwp,
                                              tile_rows=min(1024, Aps.block), group=4,
                                              validate=False, device=dev)
    xs, infos = cg_solve(Aps, bp, tol=1e-4, maxiter=3)
    xsr, isr = cg_solve(S1, bp1, tol=1e-4, maxiter=3)
    parity("pruned_sym", nw, xs, infos.iterations, xsr, isr.iterations)

    # FGMRES with an inner CG(2) as its variable preconditioner
    xf, infof = fgmres_solve(Apd, bp, tol=1e-4, maxiter=4, restart=4,
                             M=lambda vv: cg_solve(Apd, vv, tol=0.0, maxiter=2)[0])
    xfr, ifr = fgmres_solve(P1, bp1, tol=1e-4, maxiter=4, restart=4,
                            M=lambda vv: cg_solve(P1, vv, tol=0.0, maxiter=2)[0])
    parity("fgmres", nw, xf, infof.iterations, xfr, ifr.iterations)

    # pruned block CG (Gaussian columns keep the direction panels full
    # rank) and CGLS through the transposed plans
    Apt = distribute_pruned(nw, prw, pcw, vwp, mesh, tile_rows=1024, group=4,
                            with_transpose=True, assume_unique=True)
    B3 = np.random.default_rng(3).standard_normal((nw, 3))
    Bb = torch.zeros((Apt.n_pad, 3), dtype=DT, device=dev)
    Bb[:nw] = torch.from_numpy(B3).to(dev)
    Xb, infob = block_cg_solve(Apt, Apt.shard_vector(B3), tol=1e-4, maxiter=3)
    Xbr, ibr = block_cg_solve(P1, Bb, tol=1e-4, maxiter=3)
    parity("pruned_block_cg", nw, Xb, infob.iterations, Xbr, ibr.iterations, tol=BTOL)
    xl, infol = cgls_solve(Apt, bp, tol=1e-4, maxiter=3)
    xlr, ilr = cgls_solve(P1.with_transpose(), bp1, tol=1e-4, maxiter=3)
    parity("pruned_cgls", nw, xl, infol.iterations, xlr, ilr.iterations)

    # pruned pair multigrid: both builds stop at one pairing below the
    # fine level (the distributed one floors shard blocks at 1024 rows)
    csz = max(512, Apd.n_pad // 2)
    Mp_d = distributed_pruned_pair_amg(nw, prw, pcw, vwp, mesh, coarse_size=csz, tile_rows=1024,
                                       group=4, fine_A=Apd)
    Mp_1 = pruned_pair_amg(nw, prw, pcw, vwp, coarse_size=csz, tile_rows=min(1024, Apd.block),
                           group=4, pad_to=Apd.n_pad, fine_A=P1)
    xg, infog = cg_solve(Apd, bp, tol=1e-4, maxiter=3, M=Mp_d)
    xgr, igr = cg_solve(P1, bp1, tol=1e-4, maxiter=3, M=Mp_1)
    parity("pruned_gmg", nw, xg, infog.iterations, xgr, igr.iterations, levels=len(Mp_d.levels))

    # structured pair multigrid, slab-sharded along the frozen axis 0
    dims = (2 * n_devices, 6, 4)
    ng, rg, cg_, vg = _stencil_3d(dims)
    Ag = st.DIAMatrix.from_coo(ng, ng, rg, cg_, vg, dtype=DT, device=dev)
    Mg1 = structured_pair_amg(Ag, dims, freeze_axes=(0,), pairs_per_level=2, coarse_size=32)
    Mg = distribute_structured_amg(Mg1, mesh)
    Agd = distribute_matrix_dia(Ag, mesh)
    bg = torch.ones(ng, dtype=DT, device=dev)
    x, info = cg_solve(Agd, Agd.shard_vector(host(bg)), tol=1e-4, maxiter=3, M=Mg)
    xr, ir = cg_solve(Ag, bg, tol=1e-4, maxiter=3, M=Mg1)
    parity("structured_gmg", ng, x, info.iterations, xr, ir.iterations, levels=len(Mg.levels))
    return out


def _on_rank(mesh):
    """The dry run on one rank of a spawned group; rank 0's rows return."""
    out = dryrun_multichip(mesh.n_shards, mesh=mesh)
    return out if mesh.rank == 0 else None


def dryrun_ranks(n_ranks: int, backend: str = "gloo", device=None) -> dict:
    """The dry run on ``n_ranks`` spawned ranks (a process each); returns
    rank 0's rows and raises if any rank's path mismatched."""
    from sigma_tpu_torch.parallel.ranks import launch

    return launch(_on_rank, n_ranks, backend, device, threads=1)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--ranks", type=int, default=None,
                    help="spawn this many ranks instead of sharing one device")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.ranks is None:
        dryrun_multichip(args.shards, args.device)
    else:
        dryrun_ranks(args.ranks, args.backend, args.device)


if __name__ == "__main__":
    main()
