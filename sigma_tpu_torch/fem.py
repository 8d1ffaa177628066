"""Finite-element operators: P1 triangles in 2-D and the 3-D Q1 pencil.

Port of :mod:`sigma_tpu.fem` (the reference's ``examples/fem.f90``).  The
2-D half: :func:`stiffness_2d` and :func:`mass_2d` compute every element
matrix in one numpy batch (``laplacian2d:11``: AE = V V^T / (4 area) from
the rotated edge vectors; ``mass2d:56``: area/12, area/6 on the diagonal)
and assemble them in one duplicate-summing ``cls.from_coo`` on a device
(CUDA unless asked); :func:`gradient_2d` is the per-element gradient
(``gradient:156``); :func:`unit_square_mesh` and :func:`torus_mesh` are
the structured meshes of the reference's tests, and
:func:`interior_dirichlet` restricts a system to the interior nodes.
``unit_square_mesh``'s triangulation couples each node to six neighbours,
so its operators are 7-point stencils: in :class:`DIAMatrix` storage they
run on the DIA SpMV kernel.

The 3-D half: :func:`fem3d_stiffness_mass_dia` and
:func:`fem3d_generalized_spectrum` are numpy and return the JAX
package's arrays bit for bit; :func:`fem3d_pencil_dia` turns the first
one's arrays into two :class:`DIAMatrix` on a device (CUDA unless asked),
the operands of the inverse generalized Lanczos recipe
(``benchmarks/geneigen3d.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sigma_tpu_torch.graph.graph import DIAGraph
from sigma_tpu_torch.matrix.formats import CSRMatrix, DIAMatrix
from sigma_tpu_torch.utils.device import resolve_device
from sigma_tpu_torch.utils.dtypes import torch_dtype

__all__ = [
    "fem3d_generalized_spectrum",
    "fem3d_pencil_dia",
    "fem3d_stiffness_mass_dia",
    "gradient_2d",
    "interior_dirichlet",
    "mass_2d",
    "stiffness_2d",
    "torus_mesh",
    "unit_square_mesh",
]


def _wrap(delta: np.ndarray, period) -> np.ndarray:
    """Minimum-image convention for periodic (torus) meshes: an element
    that wraps keeps its true geometry although its vertices' coordinates
    lie in one fundamental domain."""
    if period is None:
        return delta
    per = np.asarray(period, dtype=np.float64)
    return delta - per * np.round(delta / per)


def _element_geometry(x: np.ndarray, ele: np.ndarray, period=None):
    """Rotated edge vectors V (ne, 3, 2) and signed double areas (ne,)."""
    j = np.roll(ele, -1, axis=1)
    k = np.roll(ele, -2, axis=1)
    d = _wrap(x[j] - x[k], period)  # (ne, 3, 2) edge vectors
    V = np.empty_like(d)
    V[:, :, 0] = d[:, :, 1]  # y_j - y_k
    V[:, :, 1] = -d[:, :, 0]  # x_k - x_j
    det = V[:, 0, 0] * V[:, 1, 1] - V[:, 0, 1] * V[:, 1, 0]
    return V, det


def _assemble(n: int, ele: np.ndarray, element_mats: np.ndarray, cls, dtype, device):
    rows = np.repeat(ele, 3, axis=1).ravel()
    cols = np.tile(ele, (1, 3)).ravel()
    return cls.from_coo(n, n, rows, cols, element_mats.reshape(-1), dtype=dtype, device=device)


def stiffness_2d(x, ele, cls=CSRMatrix, dtype=None, period=None, device=None):
    """Assembled P1 stiffness matrix of the mesh (coordinates ``x`` (n,
    2), triangles ``ele`` (ne, 3)) in format ``cls``, on ``device`` (None:
    CUDA).  ``period=(Lx, Ly)`` for a periodic (torus) mesh."""
    x = np.asarray(x, dtype=np.float64)
    ele = np.asarray(ele, dtype=np.int64)
    V, det = _element_geometry(x, ele, period)
    area = np.abs(det) / 2.0
    AE = np.einsum("eia,eja->eij", V, V) * (0.25 / area)[:, None, None]
    return _assemble(x.shape[0], ele, AE, cls, dtype, device)


def mass_2d(x, ele, cls=CSRMatrix, dtype=None, period=None, device=None):
    """Assembled P1 mass matrix, arguments as :func:`stiffness_2d`."""
    x = np.asarray(x, dtype=np.float64)
    ele = np.asarray(ele, dtype=np.int64)
    _, det = _element_geometry(x, ele, period)
    area = np.abs(det) / 2.0
    BE = np.tile((area / 12.0)[:, None, None], (1, 3, 3))
    BE[:, np.arange(3), np.arange(3)] = (area / 6.0)[:, None]
    return _assemble(x.shape[0], ele, BE, cls, dtype, device)


def gradient_2d(x, ele, u, period=None) -> np.ndarray:
    """Per-element gradient (ne, 2) of the P1 field ``u`` (host numpy)."""
    x = np.asarray(x, dtype=np.float64)
    ele = np.asarray(ele, dtype=np.int64)
    u = u.detach().cpu().numpy() if isinstance(u, torch.Tensor) else u
    u = np.asarray(u, dtype=np.float64)
    T = np.stack(
        [
            _wrap(x[ele[:, 0]] - x[ele[:, 2]], period),
            _wrap(x[ele[:, 1]] - x[ele[:, 2]], period),
        ],
        axis=2,
    )  # (ne, 2, 2): columns are edge vectors
    det = T[:, 0, 0] * T[:, 1, 1] - T[:, 0, 1] * T[:, 1, 0]
    S = np.empty_like(T)
    S[:, 0, 0] = T[:, 1, 1] / det
    S[:, 1, 1] = T[:, 0, 0] / det
    S[:, 0, 1] = -T[:, 0, 1] / det
    S[:, 1, 0] = -T[:, 1, 0] / det
    du = np.stack([u[ele[:, 0]] - u[ele[:, 2]], u[ele[:, 1]] - u[ele[:, 2]]], axis=1)
    return np.einsum("ea,eab->eb", du, S)


def unit_square_mesh(nx: int) -> Tuple[np.ndarray, np.ndarray]:
    """Structured triangulation of [0, 1]^2: (nx + 1)^2 nodes, 2 nx^2
    triangles.  Returns (coordinates (n, 2), triangles (ne, 3))."""
    g = np.linspace(0.0, 1.0, nx + 1)
    X, Y = np.meshgrid(g, g, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)
    idx = np.arange((nx + 1) ** 2).reshape(nx + 1, nx + 1)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[:-1, 1:].ravel()
    d = idx[1:, 1:].ravel()
    tris = np.concatenate([np.stack([a, b, c], axis=1), np.stack([d, c, b], axis=1)])
    return coords, tris


def torus_mesh(nx: int, ny: int) -> Tuple[np.ndarray, np.ndarray]:
    """Uniformly triangulated periodic nx x ny grid on the unit square
    (the generalized-Lanczos test geometry), coordinates in the
    fundamental domain.  Cell (i, j) gives the triangles (v(i, j),
    v(i+1, j), v(i, j+1)) and (v(i+1, j+1), v(i, j+1), v(i+1, j)), cells
    in row-major order, as the JAX package's double loop lists them."""
    xs = np.arange(nx) / nx
    ys = np.arange(ny) / ny
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    i1, j1 = (i + 1) % nx, (j + 1) % ny

    def vid(a, b):
        return a * ny + b

    first = np.stack([vid(i, j), vid(i1, j), vid(i, j1)], axis=-1)
    second = np.stack([vid(i1, j1), vid(i, j1), vid(i1, j)], axis=-1)
    return coords, np.stack([first, second], axis=2).reshape(-1, 3)


def interior_dirichlet(A, b, boundary_mask):
    """Restrict A x = b to the interior nodes (homogeneous Dirichlet):
    ``(A_ii, b_i)``, A_ii in A's format, dtype and device (format
    keywords kept), b_i a tensor on b's device or a numpy array as b is."""
    boundary_mask = np.asarray(boundary_mask, dtype=bool)
    interior = np.nonzero(~boundary_mask)[0]
    lut = -np.ones(A.shape[0], dtype=np.int64)
    lut[interior] = np.arange(interior.size)
    rows, cols, vals = A.entries()
    keep = (lut[rows] >= 0) & (lut[cols] >= 0)
    Aii = type(A).from_coo(
        interior.size, interior.size, lut[rows[keep]], lut[cols[keep]], vals[keep],
        dtype=A.dtype, device=A.device, **A._format_kwargs(),
    )
    if isinstance(b, torch.Tensor):
        return Aii, b[torch.from_numpy(interior).to(b.device)]
    return Aii, np.asarray(b)[interior]


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
