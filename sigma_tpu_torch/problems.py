"""Model problems, built directly in their storage layout.

* :func:`laplacian_3d_dia`, port of ``bench.laplacian_3d_dia``: the
  7-point 3-D Laplacian with analytic boundary masks, no COO sort.
* :func:`advection_diffusion_dia`, the upwinded 3-D advection-diffusion
  stencil of ``benchmarks/adv3d.py`` (the nonsymmetric north star), built
  the same way.
* :func:`skewed_mesh_coo`, the skew-perturbed, shuffled irregular mesh of
  ``benchmarks/unstructured_nonsym.py`` as host COO triples.
* :func:`block_banded_grouped_bsr`, the block-banded synthetic operator of
  the JAX package's benchmark (``bench.py``, the grouped-BSR row): dense
  (8, 128) blocks near the block diagonal, made as a ``GroupedBSR``
  straight from its arrays.
* The elasticity-like operator of ``benchmarks/elasticity3d.py``,
  ``A = C (x) L + I`` with L the 7-point Laplacian and C the 3 x 3 SPD
  coupling :data:`ELASTICITY_COUPLING`, in three layouts:
  :func:`elasticity_field_blocked` (a ``BlockMatrix`` of 9 DIA stencil
  blocks, dof ``a * n + i``), :func:`elasticity_node_major_dia` (one
  31-diagonal DIA band over dof ``3 i + a``, and its symmetric storage) and
  :func:`elasticity_node_major_bsr` ((3, 3)-block BSR over the same dof
  order).  :func:`elasticity_permutation` maps one dof order to the other
  and :func:`elasticity_jacobi` is the field-diagonal Jacobi
  preconditioner.

The values are made on the requested device (at nx=216 the stencil spares
a 282 MB host-to-device copy; the 211M triples of the node-major
elasticity operator never exist on the host): the card unless the caller
passes another ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from sigma_tpu_torch.graph.graph import DIAGraph
from sigma_tpu_torch.matrix.composite import BlockMatrix
from sigma_tpu_torch.matrix.formats import BSRMatrix, DIAMatrix
from sigma_tpu_torch.matrix.symmetric import SymmetricDIAMatrix
from sigma_tpu_torch.operators.linear_operator import DiagonalOperator
from sigma_tpu_torch.ops.bsr_grouped import GroupedBSR
from sigma_tpu_torch.utils.device import resolve_device
from sigma_tpu_torch.utils.dtypes import round_up

__all__ = [
    "ELASTICITY_COUPLING",
    "advection_diffusion_dia",
    "block_banded_grouped_bsr",
    "elasticity_field_blocked",
    "elasticity_jacobi",
    "elasticity_node_major_bsr",
    "elasticity_node_major_coo",
    "elasticity_node_major_dia",
    "elasticity_permutation",
    "laplacian_3d_dia",
    "skewed_mesh_coo",
]

# the dense SPD coupling of the three fields (Lame-like cross terms)
ELASTICITY_COUPLING = ((2.0, 0.5, 0.3), (0.5, 2.0, 0.4), (0.3, 0.4, 2.0))


def laplacian_3d_dia(nx, dtype=torch.float32, device=None, diag=7.0) -> DIAMatrix:
    """7-point Laplacian on an nx^3 grid (row-major, last axis fastest)
    with ``diag`` on the main diagonal: 7 gives Laplacian + I (the CG
    north star of ``benchmarks/cg3d.py``), 6 the pure Dirichlet Poisson
    operator of ``benchmarks/gmg3d.py``.  Entry for entry the matrix of
    ``bench.laplacian_3d_dia``.  ``device=None`` builds on CUDA and raises
    without a card."""
    device = resolve_device(device)
    n = nx * nx * nx
    offsets = (-nx * nx, -nx, -1, 0, 1, nx, nx * nx)
    i = torch.arange(n, device=device)
    iz = i % nx
    iy = (i // nx) % nx
    ix = i // (nx * nx)
    data = torch.zeros((7, round_up(n, 128)), dtype=dtype, device=device)
    data[3, :n] = diag
    for d, keep in (
        (4, iz < nx - 1),
        (2, iz > 0),
        (5, iy < nx - 1),
        (1, iy > 0),
        (6, ix < nx - 1),
        (0, ix > 0),
    ):
        data[d, :n].masked_fill_(keep, -1.0)
    nnz = int(torch.count_nonzero(data))
    graph = DIAGraph(offsets=offsets, shape=(n, n), nnz=nnz)
    return DIAMatrix(graph=graph, data=data)


def advection_diffusion_dia(nx, beta=10.0, dtype=torch.float32, device=None) -> DIAMatrix:
    """-div(grad u) + beta . grad u on an nx^3 grid with first-order
    upwinding, the velocity (beta, beta, beta) h: the 7-point Laplacian
    whose upwind (negative-direction) neighbours carry -(1 + beta h) and
    whose diagonal is 6 + 3 beta h, h = 1 / (nx + 1); row-wise diagonally
    dominant and nonsymmetric.  Entry for entry the matrix of
    ``benchmarks/adv3d.py``'s ``advection_diffusion_dia`` (which builds it
    in f32).  ``device=None`` builds on CUDA and raises without a card."""
    device = resolve_device(device)
    n = nx * nx * nx
    offsets = (-nx * nx, -nx, -1, 0, 1, nx, nx * nx)
    bh = float(beta) / (nx + 1)
    i = torch.arange(n, device=device)
    iz = i % nx
    iy = (i // nx) % nx
    ix = i // (nx * nx)
    data = torch.zeros((7, round_up(n, 128)), dtype=dtype, device=device)
    data[3, :n] = 6.0 + 3.0 * bh
    for d, keep, v in (
        (2, iz > 0, -(1.0 + bh)),
        (4, iz < nx - 1, -1.0),
        (1, iy > 0, -(1.0 + bh)),
        (5, iy < nx - 1, -1.0),
        (0, ix > 0, -(1.0 + bh)),
        (6, ix < nx - 1, -1.0),
    ):
        data[d, :n].masked_fill_(keep, v)
    nnz = int(torch.count_nonzero(data))
    graph = DIAGraph(offsets=offsets, shape=(n, n), nnz=nnz)
    return DIAMatrix(graph=graph, data=data)


def skewed_mesh_coo(height=16_384, width=64, seed=0, beta=0.3, shift=1e-3,
                    dtype=np.float64):
    """``(n, rows, cols, vals)``: the nonsymmetric unstructured operator of
    ``benchmarks/unstructured_nonsym.py`` (defaults: 1,048,576 rows), as
    host triples in shuffled labels.  The mesh Laplacian of
    :func:`~sigma_tpu_torch.apps.generators.irregular_mesh_laplacian_coo`
    (H x W, ``shift``) from ``default_rng(seed)``, its values rounded to
    ``dtype`` (the benchmark builds it in float32), then the skew
    perturbation ``v + beta * sign(col - row) * |v|`` along the stored
    edges (diagonally dominant for |beta| < 1), then the vertices relabelled
    by the next ``rng.permutation(n)``.  RCM-reorder the triples
    (:func:`~sigma_tpu_torch.matrix.banded.reorder_triples_rcm`) before
    packing them in pruned storage."""
    from sigma_tpu_torch.apps.generators import irregular_mesh_laplacian_coo

    rng = np.random.default_rng(seed)
    n, rows, cols, vals = irregular_mesh_laplacian_coo(height, width, rng=rng, shift=shift)
    vals = vals.astype(dtype)
    vals = vals + beta * np.sign(cols - rows) * np.abs(vals)
    sh = rng.permutation(n)
    return n, sh[rows], sh[cols], vals


def block_banded_grouped_bsr(nb_rows=8192, block_shape=(8, 128), group=8, seed=1,
                             dtype=torch.float32, device=None) -> GroupedBSR:
    """The block-banded synthetic operator: ``nb_rows`` block rows of one
    group of ``group`` dense ``block_shape`` blocks each, at block columns
    ``clip(center + integers(-4, 5))`` around the block diagonal, standard
    normal values, all from ``numpy.random.default_rng(seed)`` in the
    order the JAX package's benchmark draws them.  The default is its
    65,536 x 65,536 operator with 67,108,864 stored slots."""
    device = resolve_device(device)
    bh, bw = block_shape
    nbc = nb_rows * bh // bw
    rng = np.random.default_rng(seed)
    grow = np.arange(nb_rows, dtype=np.int32)
    center = (grow.astype(np.int64) * bh) // bw
    gcols = np.clip(
        center[:, None] + rng.integers(-4, 5, size=(nb_rows, group)), 0, nbc - 1
    ).astype(np.int32)
    gdata = rng.standard_normal((nb_rows, bh, group * bw)).astype(np.float32)
    return GroupedBSR(
        gdata=torch.from_numpy(gdata).to(device=device, dtype=dtype),
        gcols=torch.from_numpy(gcols).to(device),
        grow=torch.from_numpy(grow).to(device),
        shape=(nb_rows * bh, nb_rows * bh),
        block_shape=(bh, bw),
        group=group,
    )


def elasticity_permutation(n) -> np.ndarray:
    """perm[a * n + i] = 3 i + a: the node-major position of each
    field-blocked dof.  ``x_node[perm] = x_field``."""
    return np.tile(np.arange(n), 3) * 3 + np.repeat(np.arange(3), n)


def elasticity_field_blocked(nx, dtype=torch.float32, device=None) -> BlockMatrix:
    """``C (x) L + I`` field-blocked: a 3 x 3 ``BlockMatrix`` of DIA stencil
    blocks ``C[a, b] * L`` (+ I on the diagonal blocks) that share one
    graph.  3 nx^3 dof; every block runs the DIA kernels."""
    L = laplacian_3d_dia(nx, dtype, device, diag=6.0)
    n = L.shape[0]
    ctr = L.offsets.index(0)

    def block(a, b):
        d = L.data * ELASTICITY_COUPLING[a][b]
        if a == b:
            d[ctr, :n] += 1.0
        return DIAMatrix(graph=L.graph, data=d)

    return BlockMatrix.from_blocks([[block(a, b) for b in range(3)] for a in range(3)])


def elasticity_node_major_dia(nx, dtype=torch.float32, device=None, symmetric=False):
    """The same operator over node-major dof ``3 i + a`` as one DIA band:
    stencil offset o and fields (a, b) land on diagonal ``3 o + (b - a)``,
    31 diagonals in all.  With ``symmetric`` the ``SymmetricDIAMatrix`` of
    its 16 upper diagonals."""
    L = laplacian_3d_dia(nx, dtype, device, diag=6.0)
    n = L.shape[0]
    N = 3 * n
    offs = sorted({3 * o + (b - a) for o in L.offsets for a in range(3) for b in range(3)})
    data = torch.zeros((len(offs), round_up(N, 128)), dtype=dtype, device=L.device)
    for s, o in enumerate(L.offsets):
        for a in range(3):
            for b in range(3):
                # row 3 i + a of diagonal 3 o + (b - a) holds C[a, b] * L[i, i + o]
                data[offs.index(3 * o + (b - a)), a:N:3] += ELASTICITY_COUPLING[a][b] * L.data[s, :n]
    data[offs.index(0), :N] += 1.0
    if symmetric:
        keep = [d for d, o in enumerate(offs) if o >= 0]
        return SymmetricDIAMatrix(data=data[keep].contiguous(),
                                  offsets=tuple(offs[d] for d in keep), n=N)
    graph = DIAGraph(offsets=tuple(offs), shape=(N, N), nnz=9 * L.nnz)
    return DIAMatrix(graph=graph, data=data)


def elasticity_node_major_coo(nx, dtype=torch.float32, device=None):
    """(N, rows, cols, vals) of the node-major operator as tensors on the
    device: for every stored stencil entry L[i, i + o] and every field
    pair (a, b) the triple (3 i + a, 3 (i + o) + b, C[a, b] * L[i, i + o]),
    + 1 on the main diagonal; 9 nnz(L) triples, no duplicates."""
    L = laplacian_3d_dia(nx, dtype, device, diag=6.0)
    n = L.shape[0]
    rr, cc, vv = [], [], []
    for s, o in enumerate(L.offsets):
        i = torch.nonzero(L.data[s, :n], as_tuple=True)[0]
        v = L.data[s, i]
        for a in range(3):
            for b in range(3):
                rr.append(3 * i + a)
                cc.append(3 * (i + o) + b)
                vv.append(v * ELASTICITY_COUPLING[a][b] + (1.0 if o == 0 and a == b else 0.0))
    return 3 * n, torch.cat(rr), torch.cat(cc), torch.cat(vv)


def elasticity_node_major_bsr(nx, dtype=torch.float32, device=None) -> BSRMatrix:
    """The node-major operator as (3, 3)-block BSR: one dense block per
    stencil entry, assembled on the device from
    :func:`elasticity_node_major_coo`.  ``.grouped(8)`` gives the kernel
    layout (at most 7 blocks per block row: one group of 8 each)."""
    N, rows, cols, vals = elasticity_node_major_coo(nx, dtype, device)
    return BSRMatrix.from_coo(N, N, rows, cols, vals, dtype=dtype, sum_duplicates=False,
                              device=rows.device, block_shape=(3, 3))


def elasticity_jacobi(nx, dtype=torch.float32, device=None, node_major=False) -> DiagonalOperator:
    """The field-diagonal Jacobi preconditioner ``1 / (6 C[a, a] + 1)`` as
    an operator, in field-blocked or node-major dof order."""
    device = resolve_device(device)
    n = nx * nx * nx
    dinv = torch.tensor([1.0 / (ELASTICITY_COUPLING[a][a] * 6.0 + 1.0) for a in range(3)],
                        dtype=dtype, device=device)
    return DiagonalOperator(dinv.repeat(n) if node_major else dinv.repeat_interleave(n))
