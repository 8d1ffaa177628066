"""The nonsymmetric paths held against the JAX package on the CPU in f64:
the upwinded advection-diffusion stencil against ``benchmarks/adv3d.py``'s
arrays, the skew-perturbed shuffled mesh against the pipeline of
``benchmarks/unstructured_nonsym.py``, and that mesh's solves (plain and
pruned-multigrid BiCG-stab, FGMRES with an inner BiCG-stab given as a
lambda and through ``attach_solver``) at a small size, with equal
iteration counts and solutions within 1e-10 relative."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu
import sigma_tpu.solvers as js
from sigma_tpu.apps.generators import irregular_mesh_laplacian as jax_mesh
from sigma_tpu.matrix.banded import reorder_triples_rcm as jax_reorder
from sigma_tpu.matrix.pruned import PrunedDIAMatrix as JaxPruned
import sigma_tpu_torch as st


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _adv3d():
    path = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "adv3d.py")
    spec = importlib.util.spec_from_file_location("adv3d_benchmark", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("nx,beta", [(6, 10.0), (9, 2.5), (16, 10.0)])
def test_advection_diffusion_dia_matches_the_benchmark(nx, beta):
    n, offsets, data, nnz = _adv3d().advection_diffusion_dia(nx, beta)
    A = st.advection_diffusion_dia(nx, beta, torch.float32, device="cpu")
    assert A.shape == (n, n) and A.offsets == offsets and A.nnz == nnz
    assert A.dtype == torch.float32
    np.testing.assert_array_equal(A.data.numpy(), data)
    # f64: the same stencil before the f32 rounding
    A64 = st.advection_diffusion_dia(nx, beta, torch.float64, device="cpu")
    np.testing.assert_allclose(A64.data.numpy(), data, rtol=1e-7)
    np.testing.assert_array_equal(A64.data.numpy().astype(np.float32), data)
    d = A64.to_dense()
    assert not np.allclose(d, d.T)  # upwinded: nonsymmetric
    assert (2 * np.abs(np.diag(d)) >= np.abs(d).sum(1) - 1e-12).all()  # diagonally dominant


def _jax_skewed(height, width, seed, beta, shift, dtype):
    """benchmarks/unstructured_nonsym.py:57-67 with the JAX package."""
    rng = np.random.default_rng(seed)
    A = jax_mesh(height, width, rng=rng, dtype=dtype, shift=shift)
    n = A.shape[0]
    rr, cc, vv = (np.asarray(a) for a in A.entries())
    vv = vv + beta * np.sign(cc - rr) * np.abs(vv)
    sh = rng.permutation(n)
    dense = np.zeros((n, n))
    dense[sh[rr], sh[cc]] = vv
    return dense


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_skewed_mesh_matches_the_benchmark_pipeline(dtype):
    height, width, seed, beta, shift = 24, 16, 3, 0.3, 1e-3
    n, r, c, v = st.skewed_mesh_coo(height, width, seed, beta, shift, dtype=dtype)
    assert n == height * width
    got = np.zeros((n, n))
    got[r, c] = v
    want = _jax_skewed(height, width, seed, beta, shift, dtype)
    np.testing.assert_array_equal(got, want)
    assert np.unique(r * n + c).size == r.size  # duplicate-free
    if dtype == np.float64:
        assert st.skew_dominance(r, c, v) == pytest.approx(
            js.skew_dominance(r, c, v), rel=1e-12)


def test_skewed_mesh_solves_match_jax():
    """The nonsym_unstructured path at 1,024 rows, RCM-reordered, in pruned
    storage: auto routing, plain BiCG-stab, BiCG-stab + pruned multigrid
    (Jacobi smoother), and FGMRES(32) with a 4-step inner BiCG-stab as a
    lambda and through attach_solver."""
    n, r, c, v = st.skewed_mesh_coo(64, 16, seed=0)
    pr, pc, v, p = jax_reorder(n, r, c, v)
    kw = dict(tile_rows=1024, assume_unique=True)
    Aj = JaxPruned.from_coo(n, n, pr, pc, v, **kw)
    At = st.PrunedDIAMatrix.from_coo(n, n, pr, pc, v, device="cpu", **kw)
    amg = dict(coarse_size=64, smoother="jacobi", tile_rows=1024)
    Mt, route = st.auto_pruned_preconditioner(n, pr, pc, v, device="cpu", **amg)
    Mj, jroute = js.auto_pruned_preconditioner(n, pr, pc, v, **amg)
    assert route == jroute
    Mj = js.pruned_pair_amg(n, pr, pc, v, fine_A=Aj, **amg)
    Mt = st.pruned_pair_amg(n, pr, pc, v, fine_A=At, device="cpu", **amg)
    xstar = np.sin(np.arange(n) * 0.01)
    b = np.zeros(n)
    np.add.at(b, pr, v * xstar[pc])
    bj, bt = jnp.asarray(b), torch.from_numpy(b)
    solve = dict(tol=0.0, rtol=1e-10, maxiter=500)
    counts = {}
    runs = (
        ("plain", lambda: js.bicgstab_solve(Aj, bj, **solve),
         lambda: st.bicgstab_solve(At, bt, **solve)),
        ("pruned_gmg", lambda: js.bicgstab_solve(Aj, bj, M=Mj, **solve),
         lambda: st.bicgstab_solve(At, bt, M=Mt, **solve)),
        ("fgmres_lambda",
         lambda: js.fgmres_solve(Aj, bj, restart=32, M=lambda w: js.bicgstab_solve(
             Aj, w, tol=0.0, rtol=0.0, maxiter=4)[0], **solve),
         lambda: st.fgmres_solve(At, bt, restart=32, M=lambda w: st.bicgstab_solve(
             At, w, tol=0.0, rtol=0.0, maxiter=4)[0], **solve)),
        ("fgmres_attached",
         lambda: js.fgmres_solve(Aj, bj, restart=32, M=sigma_tpu.attach_solver(
             Aj, js.bicgstab(tolerance=0.0, maxiter=4)), **solve),
         lambda: st.fgmres_solve(At, bt, restart=32, M=st.attach_solver(
             At, st.bicgstab(tolerance=0.0, maxiter=4)), **solve)),
    )
    for label, fj, ft in runs:
        xj, ij = fj()
        xt, it = ft()
        assert it.converged and bool(ij.converged), label
        assert it.iterations == int(ij.iterations), label
        assert rel(xt.numpy(), np.asarray(xj)) <= 1e-10, label
        assert np.abs(xt.numpy() - xstar).max() < 1e-6, label
        counts[label] = it.iterations
    assert counts["fgmres_lambda"] == counts["fgmres_attached"]


def residual_gap(height, width=64):
    """The f32 pruned-multigrid BiCG-stab of ``chip_smoke.py``'s
    nonsym_unstructured path on the CPU, in both packages and in the port
    with an f64-accumulated matvec of the same f32 matrix: each solve's
    iterations and recomputed true relative residual.  Too slow for the
    test run at the path's size (minutes); run as a script:
    ``PYTHONPATH=. python tests/test_torch_nonsym.py 16384``."""
    n, r, c, v = st.skewed_mesh_coo(height, width, 0, 0.3, 1e-3, dtype=np.float32)
    pr, pc, v, p = st.reorder_triples_rcm(n, r, c, v)
    v = v.astype(np.float32)
    At = st.PrunedDIAMatrix.from_coo(n, n, pr, pc, v, assume_unique=True, device="cpu")
    Mt = st.pruned_pair_amg(n, pr, pc, v, coarse_size=4096, smoother="jacobi", fine_A=At,
                            device="cpu")
    Aj = JaxPruned.from_coo(n, n, pr, pc, v, dtype=np.float32, assume_unique=True)
    Mj = js.pruned_pair_amg(n, pr, pc, v, coarse_size=4096, smoother="jacobi", fine_A=Aj)
    xstar = np.sin(np.arange(n) * 0.001).astype(np.float32)
    xp = np.empty_like(xstar)
    xp[p] = xstar
    b = At.matvec(torch.from_numpy(xp))

    def true_rel(x):
        return float(torch.linalg.vector_norm(b - At.matvec(x)) / torch.linalg.vector_norm(b))

    class F64Matvec:  # the f32 matrix applied with f64 sums, rounded to f32
        shape = At.shape

        def matvec(self, x):
            return At.astype(torch.float64).matvec(x.double()).float()

    kw = dict(tol=0.0, rtol=1e-6, maxiter=500)
    out = {"n": n}
    for label, M_t, M_j in (("plain", None, None), ("pruned_gmg", Mt, Mj)):
        x, i = st.bicgstab_solve(At, b, M=M_t, **kw)
        out[f"torch_{label}"] = (i.iterations, true_rel(x))
        xj, ij = js.bicgstab_solve(Aj, jnp.asarray(b.numpy()), M=M_j, **kw)
        out[f"jax_{label}"] = (int(ij.iterations), true_rel(torch.from_numpy(np.array(xj))))
    x, i = st.bicgstab_solve(F64Matvec(), b, M=Mt, **kw)
    out["torch_pruned_gmg_f64_matvec"] = (i.iterations, true_rel(x))
    return out


if __name__ == "__main__":
    import json
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    print(json.dumps(residual_gap(int(sys.argv[1]) if len(sys.argv) > 1 else 16_384)))
