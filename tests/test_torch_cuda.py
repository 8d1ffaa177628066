"""The port's CUDA kernels on the card: each against its plain version, and
CG / GMG-CG on the card against the same solve on the CPU.

Marked ``cuda``; every test skips without a CUDA device.  The test
configuration imports JAX, which the GPU machine need not have, so run
this file there without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -m cuda -q
"""

import numpy as np
import pytest
import torch

import sigma_tpu_torch as st
from sigma_tpu_torch.ops import (
    KERNEL_DTYPES,
    dia_spmv,
    dia_spmv_reference,
    dia_sym_spmv,
    dia_sym_spmv_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not st.cuda_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _tol(xdt):
    # accumulation is in x's dtype (values widen exactly); summation order
    # and FMA contraction differ from the plain version
    return 1e-12 if xdt == torch.float64 else 1e-5


@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
@pytest.mark.parametrize(
    "n,m,offsets",
    [
        (50_000, 50_000, [-2500, -300, -1, 0, 1, 300, 2500]),
        (60_000, 45_001, [-2500, -300, 0, 4, 2500]),
        (45_001, 60_000, [-4, -1, 0, 300, 2500]),
        (70_000, 70_000, [0]),
    ],
)
def test_dia_spmv_kernel(cuda, pair, n, m, offsets):
    vdt, xdt = pair
    g = torch.Generator(device=cuda).manual_seed(0)
    data = torch.randn(len(offsets), -(-n // 128) * 128, generator=g, device=cuda).to(vdt)
    x = torch.randn(m, generator=g, device=cuda).to(xdt)
    offs = torch.tensor(offsets, device=cuda)
    before = dia_spmv.launches
    y = dia_spmv(data, x, offs, n, m)
    torch.cuda.synchronize()
    assert dia_spmv.launches == before + 1
    assert y.dtype == xdt and y.shape == (n,)
    assert rel(y, dia_spmv_reference(data, x, offs, n, m)) <= _tol(xdt)


@pytest.mark.parametrize("pair", sorted(KERNEL_DTYPES, key=str), ids=str)
@pytest.mark.parametrize(
    "n,offsets", [(50_000, [0, 1, 300, 2500]), (33_333, [1, 130, 259])]
)
def test_dia_sym_spmv_kernel(cuda, pair, n, offsets):
    vdt, xdt = pair
    g = torch.Generator(device=cuda).manual_seed(1)
    data = torch.randn(len(offsets), -(-n // 128) * 128, generator=g, device=cuda).to(vdt)
    x = torch.randn(n, generator=g, device=cuda).to(xdt)
    offs = torch.tensor(offsets, device=cuda)
    before = dia_sym_spmv.launches
    y = dia_sym_spmv(data, x, offs, n)
    torch.cuda.synchronize()
    assert dia_sym_spmv.launches == before + 1
    assert rel(y, dia_sym_spmv_reference(data, x, offs, n)) <= _tol(xdt)


def test_kernel_rejects_what_it_does_not_take(cuda):
    data = torch.zeros(1, 128, dtype=torch.float64, device=cuda)
    offs = torch.zeros(1, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="no DIA kernel"):
        dia_spmv(data, torch.zeros(100, device=cuda), offs, 100, 100)
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmv(data.float(), torch.zeros(200, device=cuda)[::2], offs, 100, 100)
    with pytest.raises(ValueError, match="different devices"):
        dia_spmv(data, torch.zeros(100, dtype=torch.float64), offs, 100, 100)


def test_gmg_cg_on_card_matches_cpu(cuda):
    nx = 24
    A = st.SymmetricDIAMatrix.from_dia(st.laplacian_3d_dia(nx, torch.float64, diag=6.0))
    M = st.structured_pair_amg(A, (nx, nx, nx), pairs_per_level=3)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(A.shape[0]))
    x_cpu, i_cpu = st.cg_solve(A, b, tol=0.0, rtol=1e-10, M=M)
    x_gpu, i_gpu = st.cg_solve(A.to(cuda), b.to(cuda), tol=0.0, rtol=1e-10, M=M.to(cuda))
    assert i_gpu.converged and i_gpu.iterations == i_cpu.iterations
    assert rel(x_gpu, x_cpu) <= 1e-9
