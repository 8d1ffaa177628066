"""Distributed AMG: a hierarchy built on the host, its levels on a shard
mesh.

Port of :mod:`sigma_tpu.parallel.amg`.

* :func:`distribute_amg` re-lays a smoothed-aggregation hierarchy
  (:func:`~sigma_tpu_torch.solvers.amg.smoothed_aggregation_amg`): every
  level's A and its rectangular prolongator P become
  :class:`~sigma_tpu_torch.parallel.dist.DistributedMatrix` (P partitions
  rows and columns over the same axis, each with its own block size, so
  restriction and prolongation are each one ring exchange), and the
  coarsest dense inverse is padded with an identity block, so padded
  slots pass through with their zero residual.  The V-cycle is the
  unchanged :class:`~sigma_tpu_torch.solvers.amg.AMGPreconditioner`.
* :func:`distribute_structured_amg` re-lays a structured pair hierarchy
  built with ``freeze_axes=(0,)``: the grid is slab-sharded along axis 0,
  which is never paired, so every transfer acts within a shard, and
  every level is a :class:`~sigma_tpu_torch.parallel.dist.DistributedDIAMatrix`
  whose matvec runs the DIA SpMV kernel per shard and ring.

The numbers are the single-device hierarchy's: distributed CG takes the
same iteration count.
"""

from __future__ import annotations

import torch

from sigma_tpu_torch.matrix.symmetric import SymmetricDIAMatrix
from sigma_tpu_torch.parallel.dist import (
    Mesh,
    distribute_matrix,
    distribute_matrix_dia,
    distribute_vector,
)
from sigma_tpu_torch.solvers.amg import AMGPreconditioner, _Level, smoothed_aggregation_amg
from sigma_tpu_torch.solvers.gmg import StructuredAMGPreconditioner, _SLevel

__all__ = ["distribute_amg", "distributed_amg", "distribute_structured_amg"]


def distribute_amg(M: AMGPreconditioner, mesh: Mesh, axis: str = "rows") -> AMGPreconditioner:
    """Re-lay a host-built AMG hierarchy on ``mesh``: the same levels and
    numbers in distributed storage, transfers through ring exchanges."""
    levels = []
    for lvl in M.levels:
        Ad = distribute_matrix(lvl.A, mesh, axis)
        Pd = distribute_matrix(lvl.P, mesh, axis)
        dinv = distribute_vector(lvl.dinv.to(mesh.device), mesh, axis, Ad.n_pad)
        levels.append(_Level(A=Ad, P=Pd, dinv=dinv, omega=lvl.omega))

    cinv = M.coarse_inv
    nc = cinv.shape[0]
    D = mesh.shape[axis]
    pad_to = levels[-1].P.m_pad if levels else -(-nc // D) * D
    # identity pad block: padded slots pass through unchanged (they carry
    # zero residual by construction)
    cp = torch.eye(pad_to, dtype=cinv.dtype, device=mesh.device)
    cp[:nc, :nc] = cinv
    return AMGPreconditioner(levels=tuple(levels), coarse_inv=cp, n_smooth=M.n_smooth)


def distributed_amg(A, mesh: Mesh, axis: str = "rows", **kwargs) -> AMGPreconditioner:
    """Build the hierarchy on the host from the single-device matrix ``A``
    (:func:`smoothed_aggregation_amg`'s keywords) and distribute it."""
    return distribute_amg(smoothed_aggregation_amg(A, **kwargs), mesh, axis)


def distribute_structured_amg(M: StructuredAMGPreconditioner, mesh: Mesh,
                              axis: str = "rows") -> StructuredAMGPreconditioner:
    """Re-lay a structured pair-aggregation hierarchy
    (:func:`~sigma_tpu_torch.solvers.gmg.structured_pair_amg` with
    ``freeze_axes=(0,)``) on ``mesh``, slab-partitioned along grid axis 0.
    Symmetric levels go to full storage (``to_dia``), as the JAX package
    distributes them.  Raises ValueError when a level pairs axis 0 or when
    axis 0 does not divide evenly over the shards."""
    D = mesh.shape[axis]
    levels = []
    for lvl in M.levels:
        if 0 in lvl.axes:
            raise ValueError(
                "hierarchy pairs the sharded axis: build it with "
                "structured_pair_amg(..., freeze_axes=(0,))"
            )
        if lvl.dims[0] % D:
            raise ValueError(f"grid axis 0 ({lvl.dims[0]}) must divide evenly over {D} shards")
        A = lvl.A.to_dia() if isinstance(lvl.A, SymmetricDIAMatrix) else lvl.A
        Ad = distribute_matrix_dia(A, mesh, axis)
        dinv = distribute_vector(lvl.dinv.to(mesh.device), mesh, axis, Ad.n_pad)
        levels.append(_SLevel(A=Ad, dinv=dinv, dims=lvl.dims, axes=lvl.axes, omega=lvl.omega,
                              lmax=lvl.lmax))
    return StructuredAMGPreconditioner(
        levels=tuple(levels), coarse_inv=M.coarse_inv.to(mesh.device), n_smooth=M.n_smooth,
        smoother=M.smoother,
    )
