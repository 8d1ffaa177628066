"""The port's stencil main path as a whole, held against the JAX package:
pure 3-D Poisson at nx=12 in f64, GMG-preconditioned CG built natively in
the port and built from the JAX hierarchy through ``convert.py``; plus the
port's import boundary and its kernel routing."""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu
from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix as JaxSym
from sigma_tpu.solvers import cg_solve as jax_cg
from sigma_tpu.solvers import structured_pair_amg as jax_amg
import sigma_tpu_torch as st
from sigma_tpu_torch import convert
from sigma_tpu_torch.ops import spmv_dia

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)
from bench import laplacian_3d_dia  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _jax_operator(nx, symmetric):
    """The JAX package's operator, built as benchmarks/gmg3d.py builds it."""
    n, offsets, data, nnz = laplacian_3d_dia(nx, np.float64)
    data[3, :n] = 6.0
    if symmetric:
        keep = [d for d, o in enumerate(offsets) if o >= 0]
        return JaxSym(
            data=jnp.asarray(data[keep].reshape(len(keep), -1, 128)),
            offsets=tuple(offsets[d] for d in keep),
            n=n,
        )
    g = sigma_tpu.DIAGraph(offsets=offsets, shape=(n, n), nnz=nnz)
    return sigma_tpu.DIAMatrix(graph=g, data=jnp.asarray(data.reshape(7, -1, 128)))


def _convert_operator(A, device="cpu"):
    if isinstance(A, JaxSym):
        return convert.sym_dia_from_arrays(A.offsets, np.asarray(A.data), A.n, device)
    return convert.dia_from_arrays(A.graph.offsets, np.asarray(A.data), A.shape, device)


def _convert_amg(M, device="cpu"):
    levels = []
    for lv in M.levels:
        sym = isinstance(lv.A, JaxSym)
        levels.append({
            "offsets": lv.A.offsets if sym else lv.A.graph.offsets,
            "data": np.asarray(lv.A.data),
            "shape": lv.A.shape,
            "dinv": np.asarray(lv.dinv),
            "dims": lv.dims,
            "axes": lv.axes,
            "omega": lv.omega,
            "lmax": None if lv.lmax is None else np.asarray(lv.lmax),
            "symmetric": sym,
        })
    return convert.structured_amg_from_arrays(
        levels, np.asarray(M.coarse_inv), M.n_smooth, M.smoother, device
    )


CONFIGS = {
    "full_jacobi": (False, dict(smoother="jacobi", n_smooth=1, pairs_per_level=3)),
    "sym_chebyshev": (True, dict(smoother="chebyshev", n_smooth=4, pairs_per_level=3)),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_gmg_cg_slice_matches_jax(config):
    symmetric, kw = CONFIGS[config]
    nx = 12
    dims = (nx, nx, nx)
    Aj = _jax_operator(nx, symmetric)
    Mj = jax_amg(Aj, dims, **kw)
    n = Aj.shape[0]
    b = np.random.default_rng(0).standard_normal(n)
    xj, ij = jax_cg(Aj, jnp.asarray(b), tol=0.0, rtol=1e-9, M=Mj)
    assert bool(ij.converged)

    # the port, built natively
    At = st.laplacian_3d_dia(nx, torch.float64, diag=6.0, device="cpu")
    if symmetric:
        At = st.SymmetricDIAMatrix.from_dia(At)
    Mt = st.structured_pair_amg(At, dims, **kw)
    xt, it = st.cg_solve(At, torch.from_numpy(b), tol=0.0, rtol=1e-9, M=Mt)
    assert it.converged
    assert it.iterations == int(ij.iterations)
    assert rel(xt, xj) <= 1e-10

    # the port, carrying the JAX package's objects across
    Ac, Mc = _convert_operator(Aj), _convert_amg(Mj)
    assert type(Ac) is type(At)
    xc, ic = st.cg_solve(Ac, torch.from_numpy(b), tol=0.0, rtol=1e-9, M=Mc)
    assert ic.iterations == int(ij.iterations)
    assert rel(xc, xj) <= 1e-10


def _foreign(name):
    """True for a module of JAX or of the JAX package."""
    return any(name == p or name.startswith(p + ".") for p in ("jax", "sigma_tpu"))


def test_import_loads_no_jax(tmp_path):
    """A fresh process, run from an empty directory so that only the
    checkout is on its path, imports every submodule of the port and
    loads neither JAX nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys; sys.path.insert(0, sys.argv[1]); "
        "import sigma_tpu_torch as p; "
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'sigma_tpu_torch.')]; "
        "[importlib.import_module(n) for n in names]; "
        "bad = sorted(m for m in sys.modules if m in ('jax', 'sigma_tpu') "
        "or m.startswith(('jax.', 'sigma_tpu.'))); "
        "assert len(names) >= 20 and 'sigma_tpu_torch.ops.spmv_pruned' in names, names; "
        "assert not bad, bad"
    )
    subprocess.run(
        [sys.executable, "-c", code, os.path.abspath(REPO)],
        check=True, cwd=tmp_path, timeout=120,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "chip_profile.py"])
def test_chip_scripts_import_no_jax(script):
    tree = ast.parse(open(os.path.join(REPO, script)).read())
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.append(node.module)
    assert "sigma_tpu_torch" in {m.split(".")[0] for m in imported}
    assert not [m for m in imported if _foreign(m)]


def test_constructors_without_a_device_need_a_card():
    """With no device given, constructors build on CUDA; without a card
    they raise and name the way to the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present (tests/test_torch_cuda.py covers it)")
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        st.laplacian_3d_dia(4)
    n, r, c, v = st.irregular_mesh_laplacian_coo(8, 4, rng=np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.PrunedDIAMatrix.from_coo(n, n, r, c, v, tile_rows=1024)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.DIAMatrix.from_coo(n, n, r, c, v)
    assert st.laplacian_3d_dia(4, device="cpu").device.type == "cpu"


def test_cpu_path_launches_no_kernel():
    before = (spmv_dia.dia_spmv.launches, spmv_dia.dia_sym_spmv.launches)
    nx = 6
    A = st.SymmetricDIAMatrix.from_dia(st.laplacian_3d_dia(nx, torch.float64, diag=6.0, device="cpu"))
    M = st.structured_pair_amg(A, (nx, nx, nx), level_dtype=torch.float32)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    x, info = st.cg_solve(A, b, tol=0.0, rtol=1e-8, M=M)
    assert info.converged
    after = (spmv_dia.dia_spmv.launches, spmv_dia.dia_sym_spmv.launches)
    assert after == before


def test_device_tensors_never_reach_the_plain_version(monkeypatch):
    """Routing is by the tensor's device alone: a tensor off the CPU goes
    to the kernel launcher (stubbed here: no card; the ``meta`` device
    stands in for CUDA) and never to the plain version."""
    launched = []

    def fake_launch(entry, data, x, offsets, n, *extra):
        assert data.device == x.device == offsets.device
        launched.append(entry)
        return torch.empty(n, dtype=x.dtype, device=x.device)

    def no_plain(*args):
        raise AssertionError("plain version called for a device tensor")

    monkeypatch.setattr(spmv_dia, "_launch", fake_launch)
    monkeypatch.setattr(spmv_dia, "dia_spmv_reference", no_plain)
    monkeypatch.setattr(spmv_dia, "dia_sym_spmv_reference", no_plain)
    before = (spmv_dia.dia_spmv.launches, spmv_dia.dia_sym_spmv.launches)

    nx = 6
    A = st.SymmetricDIAMatrix.from_dia(st.laplacian_3d_dia(nx, torch.float32, diag=6.0, device="cpu"))
    M = st.structured_pair_amg(
        A, (nx, nx, nx), pairs_per_level=3, level_dtype=torch.bfloat16,
        smoother="chebyshev", n_smooth=2,
    ).to("meta")
    Am = A.to("meta")
    assert Am.device.type == "meta" and M.device.type == "meta"
    assert Am.offsets_dev.device.type == "meta"
    r = torch.empty(A.shape[0], dtype=torch.float32, device="meta")
    assert Am.matvec(r).device.type == "meta"
    assert M.matvec(r).shape == r.shape
    assert "sigma_dia_sym_spmv" in launched and "sigma_dia_spmv" in launched
    assert spmv_dia.dia_spmv.launches - before[0] == launched.count("sigma_dia_spmv")
    assert spmv_dia.dia_sym_spmv.launches - before[1] == launched.count(
        "sigma_dia_sym_spmv"
    )
