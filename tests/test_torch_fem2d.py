"""The port's 2-D P1 finite elements held against the JAX package's: the
stiffness and mass matrices and the element gradients on the unit square
and on a periodic torus mesh (to 1e-13), the meshes bit for bit, the
Dirichlet restriction in CSR and DIA, and the O(h^2) convergence of the
manufactured Poisson solve (``tests/test_fem.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu
import sigma_tpu.fem as jfem
import sigma_tpu_torch as st
import sigma_tpu_torch.fem as tfem

F64 = torch.float64


def boundary(coords):
    xs, ys = coords[:, 0], coords[:, 1]
    return (xs == 0) | (xs == 1) | (ys == 0) | (ys == 1)


@pytest.mark.parametrize("nx", [1, 5, 8])
def test_unit_square_mesh_is_the_jax_packages(nx):
    c, e = tfem.unit_square_mesh(nx)
    cj, ej = jfem.unit_square_mesh(nx)
    assert c.dtype == cj.dtype and e.dtype == ej.dtype
    np.testing.assert_array_equal(c, cj)
    np.testing.assert_array_equal(e, ej)


@pytest.mark.parametrize("nx,ny", [(6, 5), (5, 5), (1, 4), (7, 2), (16, 9)])
def test_torus_mesh_is_the_jax_packages(nx, ny):
    c, e = tfem.torus_mesh(nx, ny)
    cj, ej = jfem.torus_mesh(nx, ny)
    assert e.dtype == ej.dtype and e.shape == (2 * nx * ny, 3)
    np.testing.assert_array_equal(c, cj)
    np.testing.assert_array_equal(e, ej)


MESHES = {"square8": (lambda: tfem.unit_square_mesh(8), None),
          "torus6x5": (lambda: tfem.torus_mesh(6, 5), (1.0, 1.0))}
FORMATS = ["csr", "dia", "ell", "coo"]


@pytest.mark.parametrize("fn", ["stiffness_2d", "mass_2d"])
@pytest.mark.parametrize("frmt", FORMATS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_assembly_is_the_jax_packages(fn, frmt, mesh):
    make, period = MESHES[mesh]
    coords, ele = make()
    A = getattr(tfem, fn)(coords, ele, cls=st.choose_matrix_type(frmt), dtype=F64,
                          period=period, device="cpu")
    Aj = getattr(jfem, fn)(coords, ele, cls=sigma_tpu.choose_matrix_type(frmt),
                           dtype=jnp.float64, period=period)
    assert type(A).__name__ == type(Aj).__name__ and A.dtype == F64
    np.testing.assert_allclose(A.to_dense(), np.asarray(Aj.to_dense()), rtol=0, atol=1e-13)
    x = np.sin(np.arange(coords.shape[0]) * 0.37)
    np.testing.assert_allclose(A.matvec(torch.from_numpy(x)).numpy(),
                               np.asarray(Aj.matvec(jnp.asarray(x))), rtol=0, atol=1e-13)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_gradient_is_the_jax_packages(mesh):
    make, period = MESHES[mesh]
    coords, ele = make()
    u = np.cos(3 * coords[:, 0]) * np.sin(2 * coords[:, 1])
    g = tfem.gradient_2d(coords, ele, torch.from_numpy(u), period=period)
    np.testing.assert_allclose(g, jfem.gradient_2d(coords, ele, u, period=period),
                               rtol=0, atol=1e-13)


def test_gradient_exact_on_linear():
    coords, ele = tfem.unit_square_mesh(5)
    u = 4.0 * coords[:, 0] + 7.0 * coords[:, 1] - 2.0
    assert np.abs(tfem.gradient_2d(coords, ele, u) - np.array([4.0, 7.0])).max() < 1e-12


def test_stiffness_and_mass_properties():
    coords, ele = tfem.unit_square_mesh(8)
    d = tfem.stiffness_2d(coords, ele, dtype=F64, device="cpu").to_dense()
    assert np.abs(d - d.T).max() < 1e-13 and np.abs(d.sum(1)).max() < 1e-12
    assert np.linalg.eigvalsh(d).min() > -1e-12
    m = tfem.mass_2d(coords, ele, dtype=F64, device="cpu").to_dense()
    assert abs(m.sum() - 1.0) < 1e-12 and np.linalg.eigvalsh(m).min() > 0


def test_torus_mesh_assembly_is_periodic():
    coords, ele = tfem.torus_mesh(5, 5)
    A = tfem.stiffness_2d(coords, ele, dtype=F64, period=(1.0, 1.0), device="cpu")
    M = tfem.mass_2d(coords, ele, dtype=F64, period=(1.0, 1.0), device="cpu")
    ones = torch.ones(coords.shape[0], dtype=F64)
    assert A.matvec(ones).abs().max() < 1e-12
    assert abs(float(M.matvec(ones).sum()) - 1.0) < 1e-12


def test_unit_square_stiffness_is_a_7_point_stencil():
    coords, ele = tfem.unit_square_mesh(6)
    A = tfem.stiffness_2d(coords, ele, cls=st.DIAMatrix, dtype=F64, device="cpu")
    assert A.offsets == (-7, -6, -1, 0, 1, 6, 7)


@pytest.mark.parametrize("frmt", ["csr", "dia"])
@pytest.mark.parametrize("b_kind", ["numpy", "tensor"])
def test_interior_dirichlet_is_the_jax_packages(frmt, b_kind):
    coords, ele = tfem.unit_square_mesh(7)
    A = tfem.stiffness_2d(coords, ele, cls=st.choose_matrix_type(frmt), dtype=F64, device="cpu")
    Aj = jfem.stiffness_2d(coords, ele, cls=sigma_tpu.choose_matrix_type(frmt), dtype=jnp.float64)
    b = np.arange(coords.shape[0], dtype=np.float64)
    bt = torch.from_numpy(b) if b_kind == "tensor" else b
    Aii, bi = tfem.interior_dirichlet(A, bt, boundary(coords))
    Ajj, bj = jfem.interior_dirichlet(Aj, b, boundary(coords))
    assert type(Aii) is type(A) and Aii.dtype == F64 and Aii.shape == (36, 36)
    assert isinstance(bi, torch.Tensor if b_kind == "tensor" else np.ndarray)
    np.testing.assert_array_equal(np.asarray(bi), np.asarray(bj))
    np.testing.assert_array_equal(Aii.to_dense(), np.asarray(Ajj.to_dense()))
    if frmt == "dia":
        assert Aii.offsets == tuple(np.asarray(Ajj.offsets).tolist())


@pytest.mark.parametrize("frmt", ["csr", "dia"])
def test_poisson_convergence(frmt):
    """Manufactured solution u = sin(pi x) sin(pi y): the max-norm error
    drops ~4x when h halves (O(h^2)), as in the JAX package, with the same
    CG iteration counts."""
    from sigma_tpu.solvers import cg_solve as jax_cg

    errs = []
    for nx in (8, 16, 32):
        coords, ele = tfem.unit_square_mesh(nx)
        cls = st.choose_matrix_type(frmt)
        A = tfem.stiffness_2d(coords, ele, cls=cls, dtype=F64, device="cpu")
        M = tfem.mass_2d(coords, ele, cls=cls, dtype=F64, device="cpu")
        u_exact = np.sin(np.pi * coords[:, 0]) * np.sin(np.pi * coords[:, 1])
        b = M.matvec(torch.from_numpy(2 * np.pi**2 * u_exact))
        bdry = boundary(coords)
        Aii, bi = tfem.interior_dirichlet(A, b, bdry)
        ui, info = st.cg_solve(Aii, bi, tol=0.0, rtol=1e-12)
        Aj = jfem.stiffness_2d(coords, ele, cls=sigma_tpu.choose_matrix_type(frmt),
                               dtype=jnp.float64)
        Ajj, bj = jfem.interior_dirichlet(Aj, b.numpy(), bdry)
        _, infoj = jax_cg(Ajj, jnp.asarray(bj), tol=0.0, rtol=1e-12)
        assert info.iterations == int(infoj.iterations)
        u = np.zeros(coords.shape[0])
        u[~bdry] = ui.numpy()
        errs.append(np.abs(u - u_exact).max())
    assert errs[1] < errs[0] / 3.5 and errs[2] < errs[1] / 3.5


def true_residual_witness(nx, rtol=1e-10):
    """The f64 true relative residual ||b - A x|| / ||b|| that CG reaches
    on the CPU on the manufactured Poisson system at ``nx``, when its
    recursive residual has met ``rtol``: the port's ``cg_solve`` on DIA,
    the JAX package's on DIA, and a textbook CG in numpy on scipy's CSR
    product (independent of both packages' solvers).  Beside each, the
    rounding estimate eps sqrt(k) ||A||_inf ||x|| / ||b|| after k
    iterations.  ``chip_smoke.py`` holds the card's FEM solves to that
    estimate; this puts the CPU's readings beside the card's."""
    import jax

    from sigma_tpu.solvers import cg_solve as jax_cg

    coords, ele = tfem.unit_square_mesh(nx)
    A = tfem.stiffness_2d(coords, ele, cls=st.DIAMatrix, dtype=F64, device="cpu")
    M = tfem.mass_2d(coords, ele, cls=st.DIAMatrix, dtype=F64, device="cpu")
    u = np.sin(np.pi * coords[:, 0]) * np.sin(np.pi * coords[:, 1])
    b = M.matvec(torch.from_numpy(2 * np.pi**2 * u))
    Aii, bi = tfem.interior_dirichlet(A, b, boundary(coords))
    S = st.io.to_scipy(Aii).tocsr()
    bn = bi.numpy()
    a_inf = float(np.abs(S).sum(axis=1).max())
    eps = np.finfo(np.float64).eps

    def row(x, k):
        rel = float(np.linalg.norm(bn - S @ x) / np.linalg.norm(bn))
        est = eps * np.sqrt(k) * a_inf * float(np.linalg.norm(x)) / float(np.linalg.norm(bn))
        return {"iterations": int(k), "true_relative_residual": rel, "estimate": est,
                "ratio": rel / est}

    out = {"nx": nx, "n": S.shape[0], "a_inf": a_inf}
    x, info = st.cg_solve(Aii, bi, tol=0.0, rtol=rtol)
    out["port_cpu"] = row(x.numpy(), info.iterations)
    with jax.default_device(jax.devices("cpu")[0]):
        Aj = sigma_tpu.fem.stiffness_2d(coords, ele, cls=sigma_tpu.DIAMatrix, dtype=jnp.float64)
        Ajj, bj = sigma_tpu.fem.interior_dirichlet(Aj, b.numpy(), boundary(coords))
        xj, infoj = jax_cg(Ajj, jnp.asarray(bj), tol=0.0, rtol=rtol)
    out["jax_package_cpu"] = row(np.asarray(xj), int(infoj.iterations))
    # textbook CG on scipy's CSR product
    x = np.zeros_like(bn)
    r = bn.copy()
    p = r.copy()
    rr = float(r @ r)
    stop = (rtol * np.linalg.norm(bn)) ** 2
    k = 0
    while rr > stop and k < 10 * bn.size:
        q = S @ p
        alpha = rr / float(p @ q)
        x += alpha * p
        r -= alpha * q
        rr, rr_old = float(r @ r), rr
        p = r + (rr / rr_old) * p
        k += 1
    out["scipy_textbook_cpu"] = row(x, k)
    return out


@pytest.mark.parametrize("nx", [32, 64])
def test_cg_true_residual_is_rounding(nx):
    """The port's f64 CG, the JAX package's and a textbook CG on scipy's
    CSR product reach the same true residual, within rtol plus the
    rounding estimate that ``chip_smoke.py`` holds the card's solves to."""
    w = true_residual_witness(nx)
    rels = [w[k]["true_relative_residual"] for k in ("port_cpu", "jax_package_cpu",
                                                     "scipy_textbook_cpu")]
    assert max(rels) <= 1.01 * min(rels)
    for k in ("port_cpu", "jax_package_cpu", "scipy_textbook_cpu"):
        assert w[k]["iterations"] == w["port_cpu"]["iterations"]
        assert w[k]["true_relative_residual"] <= 1e-10 + w[k]["estimate"]


if __name__ == "__main__":
    import json
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for nx in (int(a) for a in sys.argv[1:] or ["512"]):
        print(json.dumps(true_residual_witness(nx)), flush=True)
