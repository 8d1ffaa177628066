"""The port's SymmetricDIAMatrix and its symmetric SpMV held against the
JAX package (plain version on the CPU; the CUDA kernel is checked on the
card by ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigma_tpu
import sigma_tpu.ops.spmv_pallas as sp
from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix as JaxSym
import sigma_tpu_torch as st
from sigma_tpu_torch.ops import dia_sym_spmv, dia_sym_spmv_reference


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("values", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n,offsets,T,E",
    [
        (4000, (0, 1, 128, 300), 16, 8),  # all lane patterns
        (4096, (0, 5), 16, 8),  # grid covers exactly n
        (5000, (1, 130, 259), 24, 8),  # no main diagonal
        (3000, (0,), 8, 8),  # diagonal only, E == T
        (9000, (0, 2, 127, 129, 383), 32, 16),
    ],
)
def test_reference_matches_pallas_blocked(n, offsets, T, E, values):
    """The plain version of the port's symmetric kernel against the TPU
    kernel it replaces (interpret mode, tiny explicit tiles)."""
    rng = np.random.default_rng(13)
    stride = -(-n // 128) * 128
    data = np.zeros((len(offsets), stride), np.float32)
    for d, o in enumerate(offsets):
        data[d, : n - o] = rng.standard_normal(n - o)
    x = rng.standard_normal(n).astype(np.float32)
    dj = jnp.asarray(data).astype(getattr(jnp, values))
    dt = torch.from_numpy(data).to(getattr(torch, values))
    yj = sp.dia_sym_spmv_pallas_blocked(
        dj, jnp.asarray(x), offsets, n, interpret=True, tile_rows=T, halo_rows=E
    )
    off_t = torch.tensor(offsets, dtype=torch.int64)
    yt = dia_sym_spmv_reference(dt, torch.from_numpy(x), off_t, n)
    assert yt.dtype == torch.float32
    assert rel(yt, yj) <= 1e-5
    torch.testing.assert_close(dia_sym_spmv(dt, torch.from_numpy(x), off_t, n), yt)


def _sym_coo(rng, n, offsets):
    rows, cols, vals = [], [], []
    for o in offsets:
        r = np.arange(n - o)
        v = rng.standard_normal(n - o)
        rows += [r, r + o] if o else [r]
        cols += [r + o, r] if o else [r]
        vals += [v, v] if o else [v]
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


@pytest.mark.parametrize(
    "n,offsets",
    [(300, (0, 1, 17, 130)), (333, (2, 5)), (500, tuple(range(0, 60, 2)))],
)
def test_symmetric_matches_jax_f64(n, offsets):
    rng = np.random.default_rng(n)
    r, c, v = _sym_coo(rng, n, offsets)
    Aj = sigma_tpu.DIAMatrix.from_coo(n, n, r, c, v, dtype=jnp.float64)
    At = st.DIAMatrix.from_coo(n, n, r, c, v, dtype=torch.float64)
    Sj = JaxSym.from_dia(Aj)
    St = st.SymmetricDIAMatrix.from_dia(At)
    assert St.offsets == Sj.offsets
    assert St.nnz == Sj.nnz == Aj.nnz
    np.testing.assert_array_equal(St.data.numpy(), np.asarray(Sj.data2d))
    x = rng.standard_normal(n)
    assert rel(St.matvec(torch.from_numpy(x)), Sj.matvec(jnp.asarray(x))) <= 1e-12
    assert rel(St.matvec(torch.from_numpy(x)), At.matvec(torch.from_numpy(x))) <= 1e-12
    np.testing.assert_array_equal(St.diagonal().numpy(), np.asarray(Sj.diagonal()))
    Dj = Sj.to_dia()
    Dt = St.to_dia()
    assert Dt.offsets == Dj.graph.offsets
    np.testing.assert_array_equal(Dt.data.numpy(), np.asarray(Dj.data2d))
    np.testing.assert_array_equal(St.to_dense(), Aj.to_dense())


def test_from_dia_rejects_nonsymmetric():
    n = 50
    rng = np.random.default_rng(1)
    r, c, v = _sym_coo(rng, n, (0, 3))
    v = v.copy()
    v[-1] += 0.5  # break the mirror of one entry of diagonal +-3
    At = st.DIAMatrix.from_coo(n, n, r, c, v, dtype=torch.float64)
    with pytest.raises(ValueError, match="not symmetric"):
        st.SymmetricDIAMatrix.from_dia(At)
    i = np.arange(n - 1)
    Au = st.DIAMatrix.from_coo(n, n, i, i + 1, np.ones(n - 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="without mirror"):
        st.SymmetricDIAMatrix.from_dia(Au)
    with pytest.raises(ValueError, match="offsets >= 0"):
        st.SymmetricDIAMatrix(data=torch.zeros(1, 128), offsets=(-1,), n=n)
