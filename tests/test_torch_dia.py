"""The port's DIAMatrix and its full-storage SpMV held against the JAX
package.

Inputs come from seeded numpy and go to both packages.  On the CPU the
port's wrapper runs the kernel's plain version (``dia_spmv_reference``);
the CUDA kernel itself is checked against that plain version on the card
by ``chip_smoke.py`` (and ``tests/test_torch_cuda.py``).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu
import sigma_tpu.ops.spmv_pallas as sp
import sigma_tpu_torch as st
from sigma_tpu_torch.ops import dia_spmv, dia_spmv_reference


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def random_dia_coo(rng, n, m, offsets, integer=False):
    rows, cols, vals = [], [], []
    for o in offsets:
        lo, hi = max(0, -o), min(n, m - o)
        r = np.arange(lo, hi)
        rows.append(r)
        cols.append(r + o)
        v = rng.standard_normal(hi - lo)
        vals.append(np.round(4 * v) + 5.0 if integer else v)
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


_RNG_OFFS = sorted(
    int(o) for o in np.random.default_rng(3).choice(np.arange(-200, 201), 30, replace=False)
)
CASES = {
    "square": (300, 300, [0, 1, -1, 17, -17, 130]),
    "tall": (400, 250, [-100, 0, 3, 100]),
    "wide": (250, 400, [-3, 0, 100, 200]),
    "unaligned": (333, 333, [0, 5, -7]),
    "single_diagonal": (200, 200, [5]),
    "many_diagonals": (500, 500, _RNG_OFFS),  # > 24: the JAX scan path
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dia_matches_jax_f64(case):
    n, m, offsets = CASES[case]
    rng = np.random.default_rng(len(case))
    r, c, v = random_dia_coo(rng, n, m, offsets)
    Aj = sigma_tpu.DIAMatrix.from_coo(n, m, r, c, v, dtype=jnp.float64)
    At = st.DIAMatrix.from_coo(n, m, r, c, v, dtype=torch.float64)
    assert At.graph.offsets == Aj.graph.offsets
    assert At.nnz == Aj.nnz
    np.testing.assert_array_equal(At.data.numpy(), np.asarray(Aj.data2d))

    x = rng.standard_normal(m)
    xt = rng.standard_normal(n)
    assert rel(At.matvec(torch.from_numpy(x)), Aj.matvec(jnp.asarray(x))) <= 1e-12
    assert rel(At.rmatvec(torch.from_numpy(xt)), Aj.rmatvec(jnp.asarray(xt))) <= 1e-12
    np.testing.assert_array_equal(At.diagonal().numpy(), np.asarray(Aj.diagonal()))
    np.testing.assert_array_equal(At.to_dense(), Aj.to_dense())
    # the operator-level dense probe agrees with the entry export
    np.testing.assert_array_equal(
        st.LinearOperator.to_dense(At), At.to_dense()
    )


@pytest.mark.parametrize("case", ["square", "tall"])
def test_astype_exact_matches_jax(case):
    n, m, offsets = CASES[case]
    rng = np.random.default_rng(11)
    r, c, v = random_dia_coo(rng, n, m, offsets, integer=True)
    Aj = sigma_tpu.DIAMatrix.from_coo(n, m, r, c, v, dtype=jnp.float64)
    At = st.DIAMatrix.from_coo(n, m, r, c, v, dtype=torch.float64)
    Bj = Aj.astype_exact(jnp.bfloat16)
    Bt = At.astype_exact(torch.bfloat16)
    assert Bt.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        Bt.data.float().numpy(), np.asarray(Bj.data2d).astype(np.float32)
    )
    # the DTYPE CONVENTION: bf16 values computed in the operand's dtype
    x = rng.standard_normal(m)
    yj = Bj.matvec(jnp.asarray(x))
    yt = Bt.matvec(torch.from_numpy(x))
    assert yt.dtype == torch.float64
    assert rel(yt, yj) <= 1e-12
    # inexact values raise in both packages
    r2, c2, v2 = random_dia_coo(rng, n, m, offsets)
    with pytest.raises(ValueError, match="exactly representable"):
        sigma_tpu.DIAMatrix.from_coo(n, m, r2, c2, v2, dtype=jnp.float64).astype_exact(
            jnp.float32
        )
    with pytest.raises(ValueError, match="exactly representable"):
        st.DIAMatrix.from_coo(n, m, r2, c2, v2, dtype=torch.float64).astype_exact(
            torch.float32
        )


def _small_tile_pick(S, hrows, D, isz):
    return (64, next(e for e in range(8, 65, 8) if e >= hrows and 64 % e == 0))


@pytest.mark.parametrize("values", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n,m,offsets",
    [
        (30_000, 30_000, (-2500, -300, -1, 0, 1, 300, 2500)),  # multi-tile + halos
        (23_337, 23_337, (-7, 0, 5, 999)),  # unaligned n, odd offsets
        (25_000, 20_123, (-300, 0, 4, 2000)),  # tall: x shorter than y
    ],
)
def test_reference_matches_pallas_blocked(n, m, offsets, values, monkeypatch):
    """The plain version of the port's kernel against the TPU kernel it
    replaces, run in interpret mode with small tiles (many grid steps)."""
    monkeypatch.setattr(sp, "_full_tile_pick", _small_tile_pick)
    rng = np.random.default_rng(7)
    stride = -(-n // 128) * 128
    data = np.zeros((len(offsets), stride), np.float32)
    for d, o in enumerate(offsets):
        lo, hi = max(0, -o), min(n, m - o)
        data[d, lo:hi] = rng.standard_normal(hi - lo)
    x = rng.standard_normal(m).astype(np.float32)
    dj = jnp.asarray(data).astype(getattr(jnp, values))
    dt = torch.from_numpy(data).to(getattr(torch, values))
    yj = sp.dia_spmv_pallas_blocked(dj, jnp.asarray(x), offsets, n, m, interpret=True)
    off_t = torch.tensor(offsets, dtype=torch.int64)
    yt = dia_spmv_reference(dt, torch.from_numpy(x), off_t, n, m)
    assert yt.dtype == torch.float32
    assert rel(yt, yj) <= 1e-5
    # on the CPU the wrapper is the plain version
    torch.testing.assert_close(dia_spmv(dt, torch.from_numpy(x), off_t, n, m), yt)


@pytest.mark.parametrize("nx", [5, 9])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_laplacian_matches_bench(nx, dtype):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from bench import laplacian_3d_dia

    n, offsets, data, nnz = laplacian_3d_dia(nx, getattr(np, dtype))
    A = st.laplacian_3d_dia(nx, getattr(torch, dtype))
    assert A.shape == (n, n)
    assert A.offsets == offsets
    assert A.nnz == nnz
    assert A.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(A.data.numpy(), data)
    # the pure-Poisson variant of benchmarks/gmg3d.py
    data[3, :n] = 6.0
    np.testing.assert_array_equal(
        st.laplacian_3d_dia(nx, getattr(torch, dtype), diag=6.0).data.numpy(), data
    )


def test_wrapper_checks_operands():
    data = torch.zeros((2, 128), dtype=torch.float32)
    x = torch.zeros(100, dtype=torch.float32)
    offs = torch.tensor([0, 1])
    with pytest.raises(ValueError, match="entries"):
        dia_spmv(data, x, offs, 100, 99)
    with pytest.raises(ValueError, match="value rows"):
        dia_spmv(data, x, torch.tensor([0]), 100, 100)
    with pytest.raises(TypeError, match="int64"):
        dia_spmv(data, x, offs.int(), 100, 100)
    with pytest.raises(ValueError, match="stride"):
        dia_spmv(data, x, offs, 200, 100)
    with pytest.raises(ValueError, match="no DIA kernel for device"):
        dia_spmv(data.to("meta"), x.to("meta"), offs.to("meta"), 100, 100)
