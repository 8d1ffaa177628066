"""Finite-element operators: the 3-D Q1 stiffness/mass pencil in DIA layout.

Port of the 3-D half of :mod:`sigma_tpu.fem`.  :func:`fem3d_stiffness_mass_dia`
and :func:`fem3d_generalized_spectrum` are numpy and return the JAX
package's arrays bit for bit; :func:`fem3d_pencil_dia` turns the first one's
arrays into two :class:`DIAMatrix` on a device (CUDA unless asked), the
operands of the inverse generalized Lanczos recipe
(``benchmarks/geneigen3d.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from sigma_tpu_torch.graph.graph import DIAGraph
from sigma_tpu_torch.matrix.formats import DIAMatrix
from sigma_tpu_torch.utils.device import resolve_device
from sigma_tpu_torch.utils.dtypes import torch_dtype

__all__ = [
    "fem3d_generalized_spectrum",
    "fem3d_pencil_dia",
    "fem3d_stiffness_mass_dia",
]


def fem3d_stiffness_mass_dia(nx: int, dtype=np.float64):
    """Trilinear (Q1) FEM stiffness/mass pair on the unit cube with
    homogeneous Dirichlet BCs, directly in DIA layout at any scale.

    Tensor-product elements integrate separably, so the interior-node
    matrices are exactly Kronecker forms of the 1-D P1 pair
    ``A1 = tridiag(-1, 2, -1)/h`` and ``M1 = h·tridiag(1, 4, 1)/6``
    (h = 1/(nx+1)):

        K = A1⊗M1⊗M1 + M1⊗A1⊗M1 + M1⊗M1⊗A1,   M = M1⊗M1⊗M1

    Both are 27-point stencils; their diagonal value grids are built in
    closed form with per-axis boundary masks (no element loop, no COO
    sort).

    Returns ``(n, offsets, Kdata, Mdata)`` with data shaped
    ``(27, stride)``, stride = n rounded up to 128.
    """
    if nx < 3:
        # nx <= 2: distinct (dx, dy, dz) displacements flatten to the
        # same diagonal offset (e.g. (0,-1,1) and (0,0,-1) at nx=2),
        # breaking the unique-sorted-offsets DIA invariant
        raise ValueError("fem3d_stiffness_mass_dia requires nx >= 3 "
                         "(smaller grids alias distinct stencil offsets "
                         "onto the same flat diagonal)")
    n = nx * nx * nx
    h = 1.0 / (nx + 1)
    stride = -(-n // 128) * 128
    a = {0: 2.0 / h, 1: -1.0 / h, -1: -1.0 / h}
    m = {0: 4.0 * h / 6.0, 1: h / 6.0, -1: h / 6.0}
    i = np.arange(n)
    iz = i % nx
    iy = (i // nx) % nx
    ix = i // (nx * nx)
    valid = {}
    for d in (-1, 0, 1):
        valid[("x", d)] = (ix + d >= 0) & (ix + d < nx)
        valid[("y", d)] = (iy + d >= 0) & (iy + d < nx)
        valid[("z", d)] = (iz + d >= 0) & (iz + d < nx)
    offsets = []
    Kdata = np.zeros((27, stride), dtype)
    Mdata = np.zeros((27, stride), dtype)
    d_i = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                off = dx * nx * nx + dy * nx + dz
                mask = valid[("x", dx)] & valid[("y", dy)] & valid[("z", dz)]
                kc = (
                    a[dx] * m[dy] * m[dz]
                    + m[dx] * a[dy] * m[dz]
                    + m[dx] * m[dy] * a[dz]
                )
                mc = m[dx] * m[dy] * m[dz]
                Kdata[d_i, :n] = np.where(mask, kc, 0.0)
                Mdata[d_i, :n] = np.where(mask, mc, 0.0)
                offsets.append(off)
                d_i += 1
    return n, tuple(offsets), Kdata, Mdata


def fem3d_generalized_spectrum(nx: int, count: int) -> np.ndarray:
    """Lowest ``count`` exact generalized eigenvalues of the
    :func:`fem3d_stiffness_mass_dia` pencil K x = λ M x.

    The 1-D pencil (A1, M1) is diagonalized by discrete sines:
    μ_p = 6 (1 − cos θ_p) / (h² (2 + cos θ_p)), θ_p = pπ/(nx+1); the
    tensor eigenvalues are sums of three 1-D values."""
    if not 1 <= count <= nx**3:
        raise ValueError(f"count={count} out of range [1, {nx**3}]")
    p = np.arange(1, nx + 1)
    th = np.pi * p / (nx + 1)
    h = 1.0 / (nx + 1)
    mu = 6.0 * (1.0 - np.cos(th)) / (h * h * (2.0 + np.cos(th)))
    # the k-th smallest triple sum of an increasing sequence uses 1-D
    # indices <= k, so a corner block of side min(nx, count) is exact
    c = min(nx, count)
    block = (mu[:c, None, None] + mu[None, :c, None] + mu[None, None, :c]).ravel()
    return np.sort(block)[:count]


def fem3d_pencil_dia(n, offsets, Kdata, Mdata, dtype=torch.float64, device=None):
    """``(K, M)`` as two :class:`DIAMatrix` in ``dtype`` on ``device``
    (None: CUDA) from :func:`fem3d_stiffness_mass_dia`'s arrays; each
    one's nnz counts its nonzero values, as the JAX package's benchmark
    does."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype)

    def mk(data):
        data = np.asarray(data).reshape(len(offsets), -1)
        g = DIAGraph(offsets=tuple(offsets), shape=(n, n), nnz=int(np.count_nonzero(data)))
        return DIAMatrix(graph=g, data=torch.from_numpy(data).to(device=device, dtype=dtype))

    return mk(Kdata), mk(Mdata)
