"""The distributed layer's rank form (a process a rank, ``torch.distributed``)
on 4 gloo ranks on the CPU, held against the one-process shard mesh of
the same layouts and against the JAX package on 4 of its virtual CPU
devices (``tests/conftest.py``), in f64.

One spawn of 4 ranks (:func:`sigma_tpu_torch.parallel.ranks.launch`)
runs every case; the ranks import only the port, set one torch thread
and send numpy results back.  Meanwhile the parent runs the shard mesh
and the JAX package on the same numpy inputs, made from a seed.

* Products: each layout's matvec, rmatvec and matmat (ELL, rectangular
  ELL, DIA, pruned full storage with the transposed plans, pruned
  symmetric storage with its spills) agree with the shard mesh's within
  1e-15 relative (each rank repeats the shard mesh's per-shard
  arithmetic) and with the JAX package's distributed products within
  1e-13.
* Solves take the JAX solve's iteration count, with iterates within
  1e-10 relative (1e-8 for block CG, whose panel algebra amplifies
  rounding): a rank's partial dot products add in another order than one
  sum.  The JAX solves run on its single-device operators, except block
  ILDU, which has no single-device twin.
* The ``convert`` carriers keep a rank's slice of the JAX arrays; the
  dry run's 20 paths pass on the ranks.
* Errors: NCCL with more ranks than cards, and ranks on a CUDA device
  without CUDA, raise in the parent before any rank starts.

JAX is imported in the parent's fixtures only, never at module level:
the ranks import this module to find their function."""

import threading

import numpy as np
import pytest
import torch

import sigma_tpu_torch as st
import sigma_tpu_torch.parallel as tp
from sigma_tpu_torch.parallel.ranks import launch

D = 4
SHARD_TOL = 1e-15  # against the shard mesh: the same per-shard arithmetic
TOL = 1e-13  # against the JAX package's distributed products
STOL = 1e-10  # solver iterates
BTOL = 1e-8  # block CG iterates


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def laplacian_1d(n):
    return 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)


def laplacian_2d(nx):
    n = nx * nx
    d = np.zeros((n, n))
    idx = np.arange(n).reshape(nx, nx)
    for i in range(nx):
        for j in range(nx):
            d[idx[i, j], idx[i, j]] = 4.0
            for a, b in ((i - 1, j), (i + 1, j), (i, j - 1), (i, j + 1)):
                if 0 <= a < nx and 0 <= b < nx:
                    d[idx[i, j], idx[a, b]] = -1.0
    return d


def poisson(dims):
    """2 * nd on the diagonal, -1 to each in-grid axis neighbour."""
    n = int(np.prod(dims))
    idx = np.arange(n)
    coords = np.unravel_index(idx, dims)
    strides = np.cumprod((1,) + tuple(dims[::-1]))[:-1][::-1]
    dense = np.diag(np.full(n, 2.0 * len(dims)))
    for ax, e in enumerate(dims):
        ok = coords[ax] + 1 < e
        dense[idx[ok], idx[ok] + strides[ax]] = dense[idx[ok] + strides[ax], idx[ok]] = -1.0
    return dense


def banded_spd(rng, n, offs=(1, 2, 5, 11), shift=0.01):
    dense = np.zeros((n, n))
    i = np.arange(n)
    for o in offs:
        v = -np.abs(rng.random(n - o)) * 0.4
        dense[i[:-o], i[:-o] + o] = v
        dense[i[:-o] + o, i[:-o]] = v
    dense[i, i] = np.abs(dense).sum(1) + shift
    rows, cols = np.nonzero(dense)
    return dense, rows, cols, dense[rows, cols]


def _inputs():
    """Every case's numpy inputs, from one seed: what the ranks get (the
    large operators as COO triples) and the parent's dense copies."""
    rng = np.random.default_rng(21)
    I, P = {}, {}
    n = 96
    ell = np.where(rng.random((n, n)) < 0.05, rng.standard_normal((n, n)), 0.0)
    I["ell"] = ell + np.diag(np.full(n, 4.0))
    I["x96"], I["X96"] = rng.standard_normal(n), rng.standard_normal((n, 3))
    rect = np.where(rng.random((120, 37)) < 0.15, rng.standard_normal((120, 37)), 0.0)
    I["rect"], I["xc"], I["xf"] = rect, rng.standard_normal(37), rng.standard_normal(120)
    I["Xc"], I["Xf"] = rng.standard_normal((37, 3)), rng.standard_normal((120, 3))
    dia = np.zeros((192, 192))
    for o in (0, 1, -1, 24, -24, 60):
        i = np.arange(max(0, -o), min(192, 192 - o))
        dia[i, i + o] = rng.standard_normal(i.size)
    I["dia"], I["x192"] = dia, rng.standard_normal(192)
    P["pruned"], r, c, v = banded_spd(rng, 6000)
    I["pruned"] = (r, c, v)
    I["x6000"], I["X6000"] = rng.standard_normal(6000), rng.standard_normal((6000, 3))
    I["b6000"] = P["pruned"] @ rng.standard_normal(6000)
    d4, r4, c4, v4 = banded_spd(rng, 4000, shift=0.5)
    I["block"] = (r4, c4, v4, d4 @ rng.standard_normal((4000, 3)))
    A = laplacian_1d(500) + np.eye(500)
    I["cg"] = (A, A @ rng.standard_normal(500))
    dims = (16, 12, 10)
    P["gmg"] = poisson(dims)
    r, c = np.nonzero(P["gmg"])
    I["gmg"] = (dims, (r, c, P["gmg"][r, c]), rng.standard_normal(int(np.prod(dims))))
    A = laplacian_2d(13) + 0.1 * np.eye(169)
    I["amg"] = (A, rng.standard_normal(169))
    A = laplacian_1d(500) + 0.02 * np.eye(500)
    I["ildu"] = (A, A @ rng.standard_normal(500), rng.standard_normal(500))
    ls = np.where(rng.random((96, 40)) < 0.2, rng.standard_normal((96, 40)), 0.0)
    ls[np.arange(40), np.arange(40)] += 3.0
    I["cgls"] = (ls, rng.standard_normal(96))
    A = laplacian_1d(300) + np.eye(300) + 0.3 * (np.eye(300, k=1) - np.eye(300, k=-1))
    I["nonsym"] = (A, A @ rng.standard_normal(300))
    A = laplacian_1d(300) + np.eye(300)
    I["minres"] = (A, A @ rng.standard_normal(300))
    adj = np.triu(rng.random((64, 64)) < 0.15, 1)
    adj = adj | adj.T
    I["lanczos"] = (np.diag(adj.sum(1).astype(float)) - adj + np.eye(64),
                    rng.standard_normal(64))
    dB = 0.1 * adj + np.diag(1.0 + adj.sum(1) * 0.1)
    I["pencil_B"] = (dB + dB.T) / 2
    return I, P


# -- on each rank ---------------------------------------------------------------
def _on_ranks(mesh, I, carried):
    """Every case on this rank; rank 0 returns the gathered results."""
    from sigma_tpu_torch import convert
    from sigma_tpu_torch.eigen import generalized_lanczos, lanczos
    from sigma_tpu_torch.tools.dryrun_multichip import dryrun_multichip

    out = {"transport": mesh.transport, "shard_ids": mesh.shard_ids}

    def full(v, n=None):
        return tp.undistribute_vector(v, v.shape[0] if n is None else n)

    def csr(d):
        return st.CSRMatrix.from_dense(d, device="cpu")

    def products(A, x, X, names=("matvec", "rmatvec", "matmat")):
        res = {}
        for name in names:
            arg = X if name in ("matmat", "rmatmat") else x
            dom = name.startswith("m") and hasattr(A, "shard_domain_vector")
            v = A.shard_domain_vector(arg) if dom else A.shard_vector(arg)
            res[name] = full(getattr(A, name)(v))
        return res

    Ae = tp.distribute_matrix(csr(I["ell"]), mesh)
    out["ell"] = products(Ae, I["x96"], I["X96"], ("matvec", "rmatvec", "matmat", "rmatmat"))
    out["ell"]["diagonal"] = full(Ae.diagonal())
    out["ell_nnz"] = Ae.nnz
    out["ell_dense"] = Ae.to_dense()
    r, c = np.nonzero(I["rect"])
    P = tp.distribute_matrix(st.CSRMatrix.from_coo(120, 37, r, c, I["rect"][r, c],
                                                   dtype=np.float64, device="cpu"), mesh)
    out["rect"] = {"matvec": full(P.matvec(P.shard_domain_vector(I["xc"]))),
                   "rmatvec": full(P.rmatvec(P.shard_vector(I["xf"]))),
                   "matmat": full(P.matmat(P.shard_domain_vector(I["Xc"]))),
                   "rmatmat": full(P.rmatmat(P.shard_vector(I["Xf"])))}
    Ad = tp.distribute_matrix_dia(csr(I["dia"]), mesh)
    out["dia"] = products(Ad, I["x192"], None, ("matvec", "rmatvec"))
    out["dia"]["diagonal"] = full(Ad.diagonal())
    out["dia_nnz"] = Ad.nnz

    r, c, v = I["pruned"]
    kw = dict(tile_rows=1024, group=4)
    Pf = tp.distribute_pruned(6000, r, c, v, mesh, with_transpose=True, **kw)
    Ps = tp.distribute_pruned(6000, r, c, v, mesh, symmetric=True, **kw)
    out["pruned"] = products(Pf, I["x6000"], I["X6000"])
    out["pruned_sym"] = products(Ps, I["x6000"], I["X6000"], ("matvec", "matmat"))
    out["pruned_steps"] = [s.n_steps for s in Pf.shards]

    def solve(name, A, b, fn, n, **kw):
        x, info = fn(A, A.shard_vector(b), **kw)
        out[name] = (int(info.iterations), full(x, n))

    A, b = I["cg"]
    solve("cg", tp.distribute_matrix(csr(A), mesh), b, st.cg_solve, 500, tol=1e-14)
    solve("cg_fused", tp.distribute_matrix_dia(csr(A), mesh), b, st.cg_fused_solve, 500,
          tol=1e-14)
    dims, (rg, cg, vg), bg = I["gmg"]
    ng = int(np.prod(dims))
    G = st.DIAMatrix.from_coo(ng, ng, rg, cg, vg, dtype=np.float64, device="cpu")
    Mg = tp.distribute_structured_amg(
        st.structured_pair_amg(G, dims, freeze_axes=(0,), pairs_per_level=2, coarse_size=128),
        mesh)
    solve("gmg", tp.distribute_matrix_dia(G, mesh), bg, st.cg_solve, ng, tol=1e-11, M=Mg)
    for sym in (False, True):
        Am = Ps if sym else Pf
        Mp = tp.distributed_pruned_pair_amg(6000, r, c, v, mesh, coarse_size=2048, fine_A=Am,
                                            symmetric=sym, **kw)
        solve(f"pruned_gmg_{sym}", Am, I["b6000"], st.cg_solve, 6000, tol=0.0, rtol=1e-8,
              maxiter=60, M=Mp)
    A, b = I["amg"]
    solve("amg", tp.distribute_matrix(csr(A), mesh), b, st.cg_solve, 169, tol=1e-12,
          M=tp.distributed_amg(csr(A), mesh, coarse_size=16, max_levels=2))
    A, b, rv = I["ildu"]
    Ai = tp.distribute_matrix_dia(csr(A), mesh)
    Mi = tp.distributed_block_ildu(csr(A), mesh)
    out["ildu_apply"] = full(Mi.matvec(Ai.shard_vector(rv)))
    solve("ildu", Ai, b, st.cg_solve, 500, tol=1e-12, M=Mi)
    r4, c4, v4, B4 = I["block"]
    Ab = tp.distribute_pruned(4000, r4, c4, v4, mesh, **kw)
    solve("block_cg", Ab, B4, st.block_cg_solve, 4000, tol=0.0, rtol=1e-10, maxiter=200)
    ls, bl = I["cgls"]
    r, c = np.nonzero(ls)
    Pl = tp.distribute_matrix(st.CSRMatrix.from_coo(96, 40, r, c, ls[r, c], dtype=np.float64,
                                                    device="cpu"), mesh)
    solve("cgls", Pl, bl, st.cgls_solve, 40, tol=1e-12, maxiter=300)
    A, b = I["nonsym"]
    An = tp.distribute_matrix(csr(A), mesh)
    solve("gmres", An, b, st.gmres_solve, 300, tol=1e-9, restart=16)
    for restart in (8, 48):  # several cycles; m past one warp's 32 entries
        solve(f"gmres{restart}", An, b, st.gmres_solve, 300, tol=1e-9, restart=restart)
        solve(f"fgmres{restart}", An, b, st.fgmres_solve, 300, tol=1e-9, restart=restart)
    solve("bicgstab", An, b, st.bicgstab_solve, 300, tol=1e-13, maxiter=600)
    A, b = I["minres"]
    solve("minres", tp.distribute_matrix(csr(A), mesh), b, st.minres_solve, 300, tol=1e-9)
    A, v0 = I["lanczos"]
    Al = tp.distribute_matrix(csr(A), mesh)
    res = lanczos(Al, 12, v0=Al.shard_vector(v0))
    out["lanczos"] = (res.alpha.numpy(), res.beta.numpy())
    Bl = tp.distribute_matrix(csr(I["pencil_B"]), mesh)
    res = generalized_lanczos(Al, st.attach_solver(Bl, st.cg(tolerance=1e-12)), 4,
                              v0=Al.shard_vector(v0))
    out["generalized_lanczos"] = (res.alpha.numpy(), res.beta.numpy())

    out["carried"] = {}
    ell, dia, pr = carried
    C = convert.distributed_matrix_from_arrays(*ell, mesh=mesh)
    out["carried"]["ell"] = products(C, I["x96"], None, ("matvec", "rmatvec"))
    C = convert.distributed_dia_from_arrays(*dia, mesh=mesh)
    out["carried"]["dia"] = products(C, I["x192"], None, ("matvec",))
    C = convert.distributed_pruned_from_arrays(*pr[0], mesh=mesh, **pr[1])
    out["carried"]["pruned"] = products(C, I["x6000"], None, ("matvec", "rmatvec"))
    out["carried_local_shards"] = len(C.shards)

    out["dryrun"] = dryrun_multichip(D, verbose=False, mesh=mesh)
    return out if mesh.rank == 0 else mesh.shard_ids


# -- in the parent: references, made while the ranks run ------------------------------
REFS = {}


def reference(fn):
    """Register a reference computation, run in the parent meanwhile."""
    REFS[fn.__name__] = fn
    return fn


def shard_mesh():
    return tp.make_mesh(D, device="cpu")


def _shard_products(A, x, X, names):
    res = {}
    for name in names:
        arg = X if name in ("matmat", "rmatmat") else x
        dom = name.startswith("m") and hasattr(A, "shard_domain_vector")
        v = A.shard_domain_vector(arg) if dom else A.shard_vector(arg)
        res[name] = getattr(A, name)(v).numpy()
    return res


def _jax_products(jx, A, x, X, names):
    """The JAX package's distributed products ``names`` of ``A``, all in
    one jitted program (one compile)."""
    sj, jp, js, jnp = jx
    import jax

    args = []
    for name in names:
        arg = X if name in ("matmat", "rmatmat") else x
        dom = name.startswith("m") and hasattr(A, "shard_domain_vector")
        if arg.ndim == 2:
            n_pad = A.m_pad if dom and hasattr(A, "m_pad") else A.n_pad
            args.append(jp.distribute_vector(arg, A.mesh, "rows", n_pad))
        else:
            args.append(A.shard_domain_vector(arg) if dom else A.shard_vector(arg))

    @jax.jit
    def run(A, args):
        return [getattr(A, name)(v) for name, v in zip(names, args)]

    return {name: np.asarray(y) for name, y in zip(names, run(A, args))}


def _jax_layouts(jx, I):
    """The JAX package's distributed layouts, and their arrays as the
    carriers' arguments."""
    sj, jp, js, jnp = jx
    jm = jp.make_mesh(D)
    De = jp.distribute_matrix(sj.CSRMatrix.from_dense(I["ell"]), jm)
    Dd = jp.distribute_matrix_dia(sj.CSRMatrix.from_dense(I["dia"]), jm)
    r, c, v = I["pruned"]
    Dp = jp.distribute_pruned(6000, r, c, v, jm, tile_rows=1024, group=4, with_transpose=True)
    names = ("data", "tile", "first", "rowoff", "laneoff")
    ell = ([np.asarray(a) for a in De.nodes], [np.asarray(a) for a in De.vals], De.offsets,
           De.n, De.m, De.block, De.block_cols, De.n_shards)
    dia = ([np.asarray(a) for a in Dd.vals], Dd.terms, Dd.n, Dd.block, Dd.n_shards)
    pr = (({k: np.asarray(getattr(Dp, k)) for k in names}, Dp.n, Dp.block, Dp.halo_words,
           Dp.halo_E, Dp.nnz, Dp.n_shards),
          dict(transpose={k: np.asarray(getattr(Dp, "t" + k)) for k in names},
               t_halo_E=Dp.t_halo_E))
    return (ell, dia, pr), {"ell": De, "dia": Dd, "pruned": Dp}


@reference
def ell(jx, I, P, L):
    A = tp.distribute_matrix(st.CSRMatrix.from_dense(I["ell"], device="cpu"), shard_mesh())
    names = ("matvec", "rmatvec", "matmat", "rmatmat")
    shard = _shard_products(A, I["x96"], I["X96"], names)
    shard["diagonal"] = A.diagonal().numpy()
    return shard, _jax_products(jx, L["ell"], I["x96"], I["X96"], names), A.nnz


@reference
def rect(jx, I, P, L):
    sj, jp, _, _ = jx
    r, c = np.nonzero(I["rect"])
    vals = I["rect"][r, c]
    P = tp.distribute_matrix(st.CSRMatrix.from_coo(120, 37, r, c, vals, dtype=np.float64,
                                                   device="cpu"), shard_mesh())
    Pj = jp.distribute_matrix(sj.CSRMatrix.from_coo(120, 37, r, c, vals), jp.make_mesh(D))
    shard = {"matvec": P.matvec(P.shard_domain_vector(I["xc"])).numpy(),
             "rmatvec": P.rmatvec(P.shard_vector(I["xf"])).numpy(),
             "matmat": P.matmat(P.shard_domain_vector(I["Xc"])).numpy(),
             "rmatmat": P.rmatmat(P.shard_vector(I["Xf"])).numpy()}
    import jax

    mv, rmv = jax.jit(lambda P, a, b: (P.matvec(a), P.rmatvec(b)))(
        Pj, Pj.shard_domain_vector(I["xc"]), Pj.shard_vector(I["xf"]))
    return shard, {"matvec": np.asarray(mv), "rmatvec": np.asarray(rmv)}


@reference
def dia(jx, I, P, L):
    A = tp.distribute_matrix_dia(st.CSRMatrix.from_dense(I["dia"], device="cpu"), shard_mesh())
    shard = _shard_products(A, I["x192"], None, ("matvec", "rmatvec"))
    shard["diagonal"] = A.diagonal().numpy()
    return shard, _jax_products(jx, L["dia"], I["x192"], None, ("matvec", "rmatvec")), A.nnz


@reference
def pruned(jx, I, P, L):
    sj, jp, _, _ = jx
    r, c, v = I["pruned"]
    out = {}
    for symmetric in (False, True):
        kw = dict(tile_rows=1024, group=4, symmetric=symmetric, with_transpose=not symmetric)
        A = tp.distribute_pruned(6000, r, c, v, shard_mesh(), **kw)
        names = ("matvec", "matmat") if symmetric else ("matvec", "rmatvec", "matmat")
        Aj = jp.distribute_pruned(6000, r, c, v, jp.make_mesh(D), **kw) if symmetric else L["pruned"]
        out[symmetric] = (_shard_products(A, I["x6000"], I["X6000"], names),
                          _jax_products(jx, Aj, I["x6000"], I["X6000"], names),
                          A.shards[0].n_steps)
    return out


@reference
def krylov(jx, I, P, L):
    sj, _, js, jnp = jx
    out = {}
    for case in ("cg", "cg_fused", "gmres", "bicgstab", "minres", "cgls"):
        if case in ("cg", "cg_fused"):
            A, b = I["cg"]
            fn, kw = getattr(js, f"{case}_solve"), dict(tol=1e-14)
        elif case in ("gmres", "bicgstab"):
            A, b = I["nonsym"]
            fn = getattr(js, f"{case}_solve")
            kw = dict(tol=1e-9, restart=16) if case == "gmres" else dict(tol=1e-13, maxiter=600)
        elif case == "minres":
            A, b = I["minres"]
            fn, kw = js.minres_solve, dict(tol=1e-9)
        else:
            A, b = I["cgls"]
            fn, kw = js.cgls_solve, dict(tol=1e-12, maxiter=300)
        if case == "cgls":
            r, c = np.nonzero(A)
            Aj = sj.CSRMatrix.from_coo(A.shape[0], A.shape[1], r, c, A[r, c])
        else:
            Aj = sj.CSRMatrix.from_dense(A)
        xj, itj = fn(Aj, jnp.asarray(b), **kw)
        out[case] = (int(itj.iterations), np.asarray(xj), A.shape[1])
    return out


@reference
def one_shard_gmres(jx, I, P, L):
    """GMRES and FGMRES on the nonsymmetric operator on one device, the
    ranks' twin."""
    A, b = I["nonsym"]
    C = st.CSRMatrix.from_dense(A, device="cpu")
    out = {}
    for restart in (8, 48):
        for name, fn in (("gmres", st.gmres_solve), ("fgmres", st.fgmres_solve)):
            x, info = fn(C, torch.from_numpy(b), tol=1e-9, restart=restart)
            out[f"{name}{restart}"] = (int(info.iterations), x.numpy())
    return out


@reference
def gmg(jx, I, P, L):
    sj, _, js, jnp = jx
    dims, _, b = I["gmg"]
    Aj = sj.DIAMatrix.from_dense(P["gmg"])
    Mj = js.structured_pair_amg(Aj, dims, freeze_axes=(0,), pairs_per_level=2, coarse_size=128)
    xj, itj = js.cg_solve(Aj, jnp.asarray(b), tol=1e-11, M=Mj)
    return int(itj.iterations), np.asarray(xj)


@reference
def pruned_gmg(jx, I, P, L):
    sj, jp, js, jnp = jx
    r, c, v = I["pruned"]
    n_pad = 8192  # 4 blocks of 2048 rows
    bp = np.zeros(n_pad)
    bp[:6000] = I["b6000"]
    out = {}
    for symmetric in (False, True):
        cls = sj.SymmetricPrunedDIAMatrix if symmetric else sj.PrunedDIAMatrix
        extra = dict(validate=False) if symmetric else {}
        P1 = cls.from_coo(n_pad, n_pad, r, c, v, tile_rows=1024, group=4, **extra)
        Mj = js.pruned_pair_amg(6000, r, c, v, pad_to=n_pad, fine_A=P1, coarse_size=2048,
                                tile_rows=1024, group=4, symmetric=symmetric)
        xj, itj = js.cg_solve(P1, jnp.asarray(bp), tol=0.0, rtol=1e-8, maxiter=60, M=Mj)
        out[symmetric] = (int(itj.iterations), np.asarray(xj))
    return out


@reference
def amg(jx, I, P, L):
    sj, _, js, jnp = jx
    A, b = I["amg"]
    Aj = sj.CSRMatrix.from_dense(A)
    Mj = js.amg.smoothed_aggregation_amg(Aj, coarse_size=16, max_levels=2)
    xj, itj = js.cg_solve(Aj, jnp.asarray(b), tol=1e-12, M=Mj)
    return int(itj.iterations), np.asarray(xj)


@reference
def ildu(jx, I, P, L):
    sj, jp, js, jnp = jx
    A, b, rv = I["ildu"]
    jm = jp.make_mesh(D)
    Aj = sj.CSRMatrix.from_dense(A)
    Mj = jp.distributed_block_ildu(Aj, jm)
    Dj = jp.distribute_matrix_dia(Aj, jm)
    xj, itj = js.cg_solve(Dj, Dj.shard_vector(b), tol=1e-12, M=Mj)
    return np.asarray(Mj.matvec(Dj.shard_vector(rv))), int(itj.iterations), np.asarray(xj)


@reference
def block_cg(jx, I, P, L):
    sj, _, js, jnp = jx
    r4, c4, v4, B4 = I["block"]
    Bp = np.zeros((4096, 3))
    Bp[:4000] = B4
    P1 = sj.PrunedDIAMatrix.from_coo(4096, 4096, r4, c4, v4, tile_rows=1024, group=4)
    Xj, itj = js.block_cg_solve(P1, jnp.asarray(Bp), tol=0.0, rtol=1e-10, maxiter=200)
    return int(itj.iterations), np.asarray(Xj)


@reference
def lanczos(jx, I, P, L):
    from sigma_tpu.eigen import generalized_lanczos as jax_generalized_lanczos
    from sigma_tpu.eigen import lanczos as jax_lanczos

    sj, _, js, _ = jx
    A, v0 = I["lanczos"]
    Aj = sj.CSRMatrix.from_dense(A)
    resj = jax_lanczos(Aj, 12, v0=v0)
    Bj = sj.attach_solver(sj.CSRMatrix.from_dense(I["pencil_B"]), js.cg(tolerance=1e-12))
    resg = jax_generalized_lanczos(Aj, Bj, 4, v0=v0)
    return {"lanczos": (np.asarray(resj.alpha), np.asarray(resj.beta)),
            "generalized_lanczos": (np.asarray(resg.alpha), np.asarray(resg.beta))}


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp

    import sigma_tpu as sj
    import sigma_tpu.parallel as jp
    import sigma_tpu.solvers as js

    return sj, jp, js, jnp


@pytest.fixture(scope="module")
def ranks(jx):
    """(rank 0's results, the inputs, the references): the ranks run in a
    thread of the parent while the parent computes the references."""
    I, P = _inputs()
    carriers, layouts = _jax_layouts(jx, I)
    box = {}

    def go():
        try:
            box["out"] = launch(_on_ranks, D, "gloo", "cpu", args=(I, carriers), threads=1)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["err"] = e

    t = threading.Thread(target=go)
    t.start()
    try:
        refs = {name: fn(jx, I, P, layouts) for name, fn in REFS.items()}
    finally:
        t.join()
    if "err" in box:
        raise box["err"]
    out = box["out"]
    assert out[1:] == [(1,), (2,), (3,)]  # each rank held its own shard
    return out[0], (I, P), refs


def _agree(got, shard, jaxp):
    for name, g in got.items():
        assert g.shape == shard[name].shape, name
        assert rel(g, shard[name]) <= SHARD_TOL, (name, rel(g, shard[name]))
        if name in jaxp:
            assert rel(g, jaxp[name]) < TOL, (name, rel(g, jaxp[name]))


def _solves_agree(got, itj, xj, n, tol=STOL):
    it, x = got
    assert it == itj
    assert rel(x[:n], np.asarray(xj)[:n]) < tol


def test_the_ranks_run_over_gloo_on_the_cpu(ranks):
    out, _, _ = ranks
    assert out["transport"] == "gloo" and out["shard_ids"] == (0,)


def test_ell_products(ranks):
    out, (I, _), refs = ranks
    shard, jaxp, nnz = refs["ell"]
    _agree(out["ell"], shard, jaxp)
    assert out["ell_nnz"] == nnz == np.count_nonzero(I["ell"])
    assert np.array_equal(out["ell_dense"], I["ell"])


def test_rectangular_ell_products(ranks):
    out, (I, _), refs = ranks
    _agree(out["rect"], *refs["rect"])
    assert rel(out["rect"]["matvec"][:120], I["rect"] @ I["xc"]) < TOL


def test_dia_products(ranks):
    out, _, refs = ranks
    shard, jaxp, nnz = refs["dia"]
    _agree(out["dia"], shard, jaxp)
    assert out["dia_nnz"] == nnz


@pytest.mark.parametrize("symmetric", [False, True])
def test_pruned_products(symmetric, ranks):
    out, (I, P), refs = ranks
    shard, jaxp, steps = refs["pruned"][symmetric]
    got = out["pruned_sym" if symmetric else "pruned"]
    _agree(got, shard, jaxp)
    assert rel(got["matvec"][:6000], P["pruned"] @ I["x6000"]) < 1e-10
    if not symmetric:
        assert out["pruned_steps"] == [steps]


@pytest.mark.parametrize("case", ["cg", "cg_fused", "gmres", "bicgstab", "minres", "cgls"])
def test_krylov_solves_take_the_jax_count(case, ranks):
    out, _, refs = ranks
    itj, xj, n = refs["krylov"][case]
    _solves_agree(out[case], itj, xj, n)


@pytest.mark.parametrize("case", ["gmres8", "fgmres8", "gmres48", "fgmres48"])
def test_rank_gmres_matches_one_shard(case, ranks):
    """The rank form's GMRES and FGMRES (the step's projections gathered
    over the ranks into the Givens update, the basis row divided as a
    sharded vector) at the one-device solve's count, iterates within
    STOL."""
    out, _, refs = ranks
    _solves_agree(out[case], *refs["one_shard_gmres"][case], 300)


def test_cg_with_structured_multigrid(ranks):
    out, (_, P), refs = ranks
    _solves_agree(out["gmg"], *refs["gmg"], P["gmg"].shape[0])


@pytest.mark.parametrize("symmetric", [False, True])
def test_cg_with_pruned_pair_multigrid(symmetric, ranks):
    out, _, refs = ranks
    _solves_agree(out[f"pruned_gmg_{symmetric}"], *refs["pruned_gmg"][symmetric], 6000)


def test_cg_with_distributed_amg(ranks):
    out, _, refs = ranks
    _solves_agree(out["amg"], *refs["amg"], 169)


def test_block_ildu(ranks):
    """The apply against the JAX package's at 4 shards, and CG with it at
    the JAX distributed solve's count."""
    out, _, refs = ranks
    apply_j, itj, xj = refs["ildu"]
    assert rel(out["ildu_apply"], apply_j) < 1e-12
    _solves_agree(out["ildu"], itj, xj, 500)


def test_block_cg(ranks):
    out, _, refs = ranks
    _solves_agree(out["block_cg"], *refs["block_cg"], 4000, tol=BTOL)


@pytest.mark.parametrize("case", ["lanczos", "generalized_lanczos"])
def test_lanczos(case, ranks):
    """The recurrence coefficients against the JAX package's (1e-9 for the
    pencil, whose every step is an inner CG solve)."""
    out, _, refs = ranks
    for got, want in zip(out[case], refs["lanczos"][case]):
        assert rel(got, want) < (STOL if case == "lanczos" else 1e-9)


@pytest.mark.parametrize("layout", ["ell", "dia", "pruned"])
def test_carriers_keep_the_ranks_slice(layout, ranks):
    """The JAX operator carried across onto the ranks applies as the
    ranks' own layout of the same matrix and as the JAX operator itself."""
    out, _, refs = ranks
    got = out["carried"][layout]
    jaxp = refs[layout][False][1] if layout == "pruned" else refs[layout][1]
    assert set(got) == ({"matvec"} if layout == "dia" else {"matvec", "rmatvec"})
    for name, y in got.items():
        assert rel(y, out[layout][name]) <= SHARD_TOL, name
        assert y.shape == jaxp[name].shape, name
        assert rel(y, jaxp[name]) < TOL, (name, rel(y, jaxp[name]))
    assert out["carried_local_shards"] == 1


def test_dryrun_on_ranks(ranks):
    out, _, _ = ranks
    rows = out["dryrun"]
    assert len(rows) == 20
    for name, row in rows.items():
        it_d, it_1 = row["iterations"]
        assert it_1 is None or it_d == it_1, name
        assert row.get("err", 0.0) < (1e-8 if "block_cg" in name else 1e-10), name


def _noop(mesh):
    return mesh.rank


def test_nccl_with_more_ranks_than_cards_raises():
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="cards"):
        launch(_noop, cards + 1, "nccl")


def test_ranks_on_a_card_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch(_noop, 2, "gloo")  # no device: the card
    with pytest.raises(RuntimeError, match="CUDA"):
        launch(_noop, 2, "gloo", "cuda")


def test_rank_mesh_needs_a_process_group(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="process group"):
        tp.make_mesh(ranks=True, device="cpu")


def test_a_rank_mesh_takes_only_sharded_vectors():
    from sigma_tpu_torch.parallel.ranks import RankMesh

    mesh = RankMesh(n_shards=2, axis="rows", device=torch.device("cpu"), rank=0,
                    backend="gloo")
    with pytest.raises(TypeError, match="DTensor"):
        mesh.blocks(torch.zeros(4))
