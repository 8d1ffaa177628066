"""Distributed block preconditioners.

Port of :mod:`sigma_tpu.parallel.precond`.  Block-Jacobi ILDU(0) /
ILU(k): each shard factorizes its own diagonal block on the host at
set-up (the port's host library, :func:`~sigma_tpu_torch.solvers.ildu.iluk_factorize`)
and an apply runs the level-scheduled forward and backward sweeps of
every shard, with no communication: the couplings between shards are
dropped (the block-Jacobi approximation), so the preconditioner depends
on the partition and has no single-device twin.

The JAX package pads every shard's level packs to the global maxima,
because one ``shard_map`` program sweeps all shards side by side.  The
port packs the shards' factors as one block-diagonal system
(:class:`~sigma_tpu_torch.solvers.ildu.TriangularLevels`): no entry
couples two shards, so its dependency levels are the shards' own: on
the card each sweep is one launch of the level-sweep kernel
(:func:`~sigma_tpu_torch.ops.ildu_sweep.level_sweep`, the counterpart of
the ``fori_loop`` inside the JAX package's ``shard_map``), in which a
row waits on its own dependencies' ready flags and no barrier joins the
shards' levels, so each shard's chain runs at its own pace; it reads
nothing back, so the apply runs under a captured graph.  On a rank mesh
each rank factorizes and sweeps its own block alone.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from sigma_tpu_torch.matrix.formats import CSRMatrix
from sigma_tpu_torch.operators.linear_operator import LinearOperator
from sigma_tpu_torch.parallel.dist import Mesh
from sigma_tpu_torch.solvers.ildu import TriangularLevels, iluk_factorize
from sigma_tpu_torch.utils.dtypes import torch_dtype

__all__ = ["DistributedBlockILDU", "distributed_block_ildu"]


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class DistributedBlockILDU(LinearOperator):
    """z = blockdiag(L_s D_s U_s)^{-1} r over the shards' row blocks: the
    block-diagonal strict factors of the shards this process holds as
    packed level systems, and their ``dinv``, 0 on padded rows (which so
    come out 0, as the JAX package's sweeps leave them)."""

    lower: TriangularLevels
    dinv: torch.Tensor
    upper: TriangularLevels
    mesh: Mesh
    axis: str
    n: int
    block: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def n_pad(self) -> int:
        return self.block * self.mesh.n_shards

    def matvec(self, r):
        R = self.mesh.blocks(r)
        z = self.upper.solve(self.dinv * self.lower.solve(R.reshape(-1)))
        return self.mesh.join(z.reshape(R.shape))

    rmatvec = matvec  # the JAX package's: applied as a symmetric preconditioner


def _block_diagonal(parts, starts, n_pad):
    """One CSR (indptr, indices, data) over n_pad rows from the shards'
    (indptr, indices, data) factors, shard s's rows and columns moved by
    ``starts[s]``; rows past the last shard's are empty."""
    counts = np.zeros(n_pad, dtype=np.int64)
    for (p, _, _), lo in zip(parts, starts):
        counts[lo : lo + p.size - 1] = np.diff(p)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    indices = np.concatenate([np.zeros(0)] + [i + lo for (_, i, _), lo in zip(parts, starts)])
    data = np.concatenate([np.zeros(0)] + [x for _, _, x in parts]).astype(np.float64)
    return indptr, indices.astype(np.int64), data


def distributed_block_ildu(A, mesh: Mesh, axis: str = "rows",
                           level: int = 0) -> DistributedBlockILDU:
    """Block-Jacobi ILDU preconditioner for the row partition of
    :func:`~sigma_tpu_torch.parallel.dist.distribute_matrix` (blocks of
    ``ceil(n / D)`` rows), on the mesh's device in A's dtype.  ``level``
    is the fill level: 0 for ILDU(0), k > 0 for level-of-fill ILU(k) of
    each block (stronger blocks, the same communication-free apply).  On
    a rank mesh each rank factorizes its own block only."""
    if A.shape[0] != A.shape[1]:
        raise ValueError("block ILDU expects a square matrix")
    D = mesh.shape[axis]
    n = A.shape[0]
    nb = -(-n // D)

    rows, cols, vals = A.entries()
    lowers, uppers, starts = [], [], []
    ids = mesh.shard_ids
    base, n_here = ids[0] * nb, len(ids) * nb  # the rows this process holds
    dinv = np.zeros(n_here, dtype=np.float64)
    for s in ids:
        # trailing shards of a small n on a wide mesh start past n: they
        # hold padded rows only
        lo, hi = min(s * nb, n), min((s + 1) * nb, n)
        if hi == lo:
            continue
        sel = (rows >= lo) & (rows < hi) & (cols >= lo) & (cols < hi)
        blk = CSRMatrix.from_coo(hi - lo, hi - lo, rows[sel] - lo, cols[sel] - lo, vals[sel],
                                 dtype=torch.float64, device="cpu")
        L, d, U = iluk_factorize(blk, level)
        dinv[lo - base : hi - base] = 1.0 / d
        lowers.append(L)
        uppers.append(U)
        starts.append(lo - base)
    dtype = torch_dtype(A.dtype)
    return DistributedBlockILDU(
        lower=TriangularLevels.from_csr(*_block_diagonal(lowers, starts, n_here), n_here, False,
                                        dtype, mesh.device),
        dinv=torch.from_numpy(dinv).to(device=mesh.device, dtype=dtype),
        upper=TriangularLevels.from_csr(*_block_diagonal(uppers, starts, n_here), n_here, True,
                                        dtype, mesh.device),
        mesh=mesh, axis=axis, n=n, block=nb,
    )
