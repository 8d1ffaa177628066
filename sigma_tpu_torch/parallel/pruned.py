"""Distributed pruned block-DIA: the unstructured format on a shard mesh,
and its multilevel preconditioner.

Port of :mod:`sigma_tpu.parallel.pruned`.  A banded (RCM-reordered)
general matrix is row-partitioned into equal shard blocks of ``block``
rows; shard d holds the pruned plan (:mod:`sigma_tpu_torch.ops.spmv_pruned`)
of its row slab as a rectangular ``(block, block + 2 * Hw)`` matrix whose
columns are ``c - d * block + Hw``: its own x block with a halo of ``Hw``
columns on each side (the band's reach rounded up to whole 128s, never
past one block).  The JAX package pads every shard's plan to a common
step count, because one ``shard_map`` program serves all shards; here
each shard keeps its own plan and step count, and the plans share only
their geometry (tile, halo, group: every shard's plan is sized for the
reach ``reach + Hw``).

A product copies, before any local work, each shard's x block and its
neighbours' edge rows into the shard's ``[left | x | right]`` buffer
(the mesh's ``halos``: the JAX package's two ``ppermute`` halo
exchanges), then launches each shard's kernel on its buffer:

* ``matvec``: the pruned SpMV (``pruned_spmv``, which replaces
  ``dia_spmv_pallas_pruned``);
* ``matmat``: the pruned SpMM (``pruned_spmm``, replacing
  ``dia_spmm_pruned_rhs_major``), 16 columns a launch;
* symmetric storage: only the upper triangle is packed, the buffer gets
  no left halo, and the symmetric kernels (``pruned_sym_spmv`` /
  ``pruned_sym_spmm``, replacing ``dia_sym_spmv_pallas_pruned`` /
  ``dia_sym_spmm_pruned_rhs_major``) run with ``sym_shift=Hw`` and
  return the mirror terms past the shard's last row as a spill, which is
  added to the next shard's first ``halo * 128`` rows (the JAX package's
  forward ``ppermute``);
* ``rmatvec``: the pruned SpMV of each shard's transposed plan, whose
  ``Hw`` head and tail rows are added to the previous and the next
  shard's edge rows (the reversed halo exchange).

On a rank mesh (:mod:`sigma_tpu_torch.parallel.ranks`) each rank builds
and keeps its own shard's plan, the halo and reversed exchanges are sends
to the neighbour ranks and the spill a send to the next rank; each rank
runs its kernel on its own ``[left | x | right]`` buffer.

The edge shards' outer halos are zeros where the JAX package's ring wrap
delivers finite values; both only ever meet zero slots.  Each halo or
spill add is an elementwise add of one block into a slice of another, a
fixed order on every device (no ``index_add_``).

:func:`distributed_pruned_pair_amg` builds the 1-D pair-aggregation
hierarchy of :func:`~sigma_tpu_torch.solvers.gmg.pruned_pair_amg` with
every level a :class:`DistributedPrunedMatrix`: shard blocks are powers
of two times 128, so pair aggregates never straddle a shard boundary and
the reshape-pair transfers act within shards; the coarsest dense inverse
is one matrix.  Same numerics as the single-device hierarchy over the
same padded index space (``pad_to=n_pad``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from sigma_tpu_torch.matrix.pruned import PrunedDIAMatrix, _dtypes, check_symmetric_triples
from sigma_tpu_torch.ops.spmm_dia import MAX_PANELS
from sigma_tpu_torch.ops.spmv_pruned import (
    build_pruned_plan,
    pruned_spmm,
    pruned_spmv,
    pruned_sym_spmm,
    pruned_sym_spmv,
)
from sigma_tpu_torch.parallel.dist import Mesh, _Distributed, distribute_vector
from sigma_tpu_torch.solvers.gmg import (
    StructuredAMGPreconditioner,
    _coo_dinv_lmax,
    _pair_coarsen_coo,
    _SLevel,
)
from sigma_tpu_torch.utils.dtypes import torch_dtype

__all__ = [
    "DistributedPrunedMatrix",
    "distribute_pruned",
    "distributed_pruned_pair_amg",
]

_LANES = 128


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class DistributedPrunedMatrix(_Distributed):
    """Row-sharded pruned block-DIA (module docstring).

    ``shards[d]`` is shard d's local plan: a :class:`PrunedDIAMatrix` of
    shape ``(block, block + 2 * halo_words)``, local column ``c -
    d * block + halo_words``, carrying with ``with_transpose`` its
    transposed plan (``(block + 2 * halo_words, block)``) in ``t``.  With
    ``symmetric`` the plans hold the upper triangle (global ``c >= r``)
    only.  On a rank mesh ``shards`` is the rank's own plan alone."""

    shards: Tuple[PrunedDIAMatrix, ...]
    mesh: Mesh
    axis: str
    n: int
    block: int
    halo_words: int
    nnz: int
    symmetric: bool = False

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def halo_E(self) -> int:
        """The plans' halo in rows of 128: the symmetric spill's length."""
        return self.shards[0].halo

    def astype(self, dtype) -> "DistributedPrunedMatrix":
        """Cast the packed values only (and the transpose plans with them);
        iterate vectors keep the caller's dtype."""
        return dataclasses.replace(self, shards=tuple(s.astype(dtype) for s in self.shards))

    def _extended(self, x):
        return self.mesh.halos(self.mesh.blocks(x), self.halo_words,
                               forward_only=self.symmetric)

    def _add_spills(self, ys, spills):
        """Mirror spill of shard d onto shard d + 1's first rows (the last
        shard's spill holds no entries: no column lies past n)."""
        _, from_prev = self.mesh.neighbours(None, spills)
        for y, sp in zip(ys, from_prev):
            if sp is not None:
                y[: sp.shape[0]] += sp
        return self.mesh.join(ys)

    def matvec(self, x):
        Hw, blk = self.halo_words, self.block
        ext = self._extended(x)
        if not self.symmetric:
            return self.mesh.join([
                pruned_spmv(s.data, ext[d], s.offsets, s.tile_ptr, blk, blk + 2 * Hw,
                            group=s.group, tile_end=s.tile_end)
                for d, s in enumerate(self.shards)
            ])
        out = [
            pruned_sym_spmv(s.data, ext[d], s.offsets, s.tile_ptr, blk, blk + 2 * Hw,
                            halo=s.halo, sym_shift=Hw, with_spill=True, group=s.group,
                            tile_end=s.tile_end)
            for d, s in enumerate(self.shards)
        ]
        return self._add_spills([y for y, _ in out], [sp for _, sp in out])

    def matmat(self, X):
        """Multi-RHS product: the halo exchange ships (Hw, k) blocks and
        each shard runs the pruned SpMM on column panels of up to 16
        (packed values read once a panel): the block solvers run
        unchanged on the mesh."""
        Hw, blk, k = self.halo_words, self.block, X.shape[1]
        ext = self._extended(X)
        ys, spills = [], []
        for d, s in enumerate(self.shards):
            parts, sparts = [], []
            for j0 in range(0, k, MAX_PANELS):
                P = ext[d][:, j0 : j0 + MAX_PANELS].contiguous()
                if self.symmetric:
                    Y, sp = pruned_sym_spmm(s.data, P, s.offsets, s.tile_ptr, blk, blk + 2 * Hw,
                                            "cols", halo=s.halo, sym_shift=Hw, with_spill=True,
                                            group=s.group, tile_end=s.tile_end)
                    sparts.append(sp)
                else:
                    Y = pruned_spmm(s.data, P, s.offsets, s.tile_ptr, blk, blk + 2 * Hw, "cols",
                                    group=s.group, tile_end=s.tile_end)
                parts.append(Y)
            ys.append(torch.cat(parts, dim=1))
            if self.symmetric:
                spills.append(torch.cat(sparts, dim=1))
        return self._add_spills(ys, spills) if self.symmetric else self.mesh.join(ys)

    def rmatvec(self, x):
        """Transpose product: each shard applies its transposed plan to its
        own x block, giving its own columns and the two halo column ranges;
        the head goes back to the previous shard's tail rows and the tail
        to the next shard's head rows (the reversed exchange, in the JAX
        package's order: next shard's first).  Needs
        ``distribute_pruned(..., with_transpose=True)``; symmetric storage
        is its own transpose."""
        if self.symmetric:
            return self.matvec(x)
        if self.shards[0].t is None:
            raise NotImplementedError(
                "distributed rmatvec needs the transpose plan: build the matrix with "
                "distribute_pruned(..., with_transpose=True)"
            )
        Hw, blk = self.halo_words, self.block
        X = self.mesh.blocks(x)
        z = [pruned_spmv(s.t.data, X[d], s.t.offsets, s.t.tile_ptr, blk + 2 * Hw, blk,
                         group=s.t.group, tile_end=s.t.tile_end)
             for d, s in enumerate(self.shards)]
        ys = [zd[Hw : Hw + blk].clone() for zd in z]
        from_next, from_prev = self.mesh.neighbours([zd[:Hw] for zd in z],
                                                    [zd[Hw + blk :] for zd in z])
        for y, head, tail in zip(ys, from_next, from_prev):
            if head is not None:
                y[blk - Hw :] += head
            if tail is not None:
                y[:Hw] += tail
        return self.mesh.join(ys)

    def diagonal(self):
        raise NotImplementedError("extract the diagonal from the COO triples at set-up")

    def __repr__(self) -> str:
        return (
            f"DistributedPrunedMatrix(n={self.n}, shards={self.n_shards}, block={self.block}, "
            f"halo={self.halo_words}, steps/shard={tuple(s.n_steps for s in self.shards)})"
        )


def _next_pow2(v: int) -> int:
    return 1 << max(int(v) - 1, 0).bit_length()


def distribute_pruned(
    n, rows, cols, vals, mesh: Mesh, *, axis: str = "rows", tile_rows: int = 16384,
    group: Optional[int] = None, block: Optional[int] = None, dtype=None,
    assume_unique: bool = False, with_transpose: bool = False, symmetric: bool = False,
    validate: bool = True,
) -> DistributedPrunedMatrix:
    """Build a row-sharded pruned matrix from (RCM-ordered) COO triples on
    the mesh's device.

    ``block`` (rows per shard) defaults to the smallest power-of-two
    multiple of 128 covering ``ceil(n / n_shards)``, at least 1024 (the
    plan's least tile): the power of two keeps pair-aggregation levels
    aligned with the shards.  The band's reach must not exceed ``block``
    (the halo comes from the neighbours only).  ``with_transpose`` also
    builds the shards' transposed plans, which ``rmatvec`` needs.

    ``symmetric=True`` packs only the upper triangle of full
    (both-triangle) triples, whose symmetry ``validate`` checks on the
    host; tiles then must divide the shard block, so that the mirror
    spill starts at the next shard's first row."""
    D = mesh.shape[axis]
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals = np.asarray(vals).ravel()
    dt, plan_dt = _dtypes(vals, dtype)
    if symmetric and with_transpose:
        raise ValueError("symmetric storage needs no transpose plan (rmatvec = matvec)")
    if group is None:
        # the JAX package's measured defaults: f32 plateaus at group 8,
        # bf16 gains to 16, the symmetric half-sized slot pool's best is 12
        group = 12 if symmetric else (16 if dt == torch.bfloat16 else 8)
    n = int(n)
    if block is None:
        block = max(128 * _next_pow2(-(-n // (D * 128))), 1024)
    if block % 1024:
        raise ValueError("block must be a multiple of 1024 (the least tile)")
    offs = cols - rows
    reach = int(max(offs.max(initial=0), -offs.min(initial=0)))
    Hw = (reach // _LANES + 1) * _LANES
    # guard the exchanged width (lane-rounded), not the raw reach: a reach
    # in (block - 127, block] rounds Hw past block
    if Hw > block:
        raise ValueError(
            f"band reach {reach} (halo width {Hw}) exceeds the shard block {block}: the "
            "halo exchange is nearest-neighbour only; raise block or reduce the bandwidth "
            "(RCM)"
        )
    tr = min(tile_rows, block)

    if symmetric:
        # the mirror spill is emitted for rows past the last tile, so tiles
        # must tile the shard block exactly: the largest multiple of 1024
        # that divides block
        for d in range(tr // 1024, 0, -1):
            if block % (d * 1024) == 0:
                tr = d * 1024
                break
        if validate:
            check_symmetric_triples(n, rows, cols, vals)
        keep = cols >= rows
        rows, cols, vals = rows[keep], cols[keep], vals[keep]

    order = np.argsort(rows // block, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    bounds = np.searchsorted(rows // block, np.arange(D + 1))
    plan_kw = dict(tile_rows=tr, group=group, dtype=plan_dt, min_reach=reach + Hw)
    shards = []
    for s in mesh.shard_ids:
        sl = slice(bounds[s], bounds[s + 1])
        r_loc, c_loc = rows[sl] - s * block, cols[sl] - s * block + Hw
        plan = build_pruned_plan(block, block + 2 * Hw, r_loc, c_loc, vals[sl], **plan_kw)
        A = PrunedDIAMatrix._from_plan(plan, dt, mesh.device, r_loc.size)
        if with_transpose:
            # the local transposed block: entries (c_loc, r_loc), offsets
            # in [-(Hw + reach), -(Hw - reach)]
            tplan = build_pruned_plan(block + 2 * Hw, block, c_loc, r_loc, vals[sl], **plan_kw)
            A = dataclasses.replace(
                A, t=PrunedDIAMatrix._from_plan(tplan, dt, mesh.device, r_loc.size))
        shards.append(A)
    TR = shards[0].tile_rows
    if symmetric and (TR > block or block % TR):
        # the reach widened the tile past the shard block: the spill would
        # no longer start at the next shard's first row
        raise ValueError(
            f"band reach {reach} forces {TR}-row tiles, which do not tile the shard block "
            f"{block}: raise block (or reduce the bandwidth) for symmetric distributed storage"
        )

    if assume_unique:
        n_stored = rows.size
        n_diag = int((rows == cols).sum())
    else:
        uk = np.unique(rows * np.int64(n) + cols)
        n_stored = int(uk.size)
        n_diag = int((uk // n == uk % n).sum())
    # symmetric: stored = upper incl. diagonal; nnz counts both triangles
    nnz = 2 * n_stored - n_diag if symmetric else n_stored
    return DistributedPrunedMatrix(
        shards=tuple(shards), mesh=mesh, axis=axis, n=n, block=int(block), halo_words=int(Hw),
        nnz=int(nnz), symmetric=bool(symmetric),
    )


def distributed_pruned_pair_amg(
    n, rows, cols, vals, mesh: Mesh, *, axis: str = "rows", coarse_size: int = 4096,
    omega: float = 2.0 / 3.0, n_smooth: int = 1, smoother: str = "chebyshev",
    level_dtype=None, tile_rows: int = 16384, group: Optional[int] = None,
    fine_A: Optional[DistributedPrunedMatrix] = None, symmetric: bool = False,
) -> StructuredAMGPreconditioner:
    """Distributed 1-D pair-aggregation AMG over COO triples: every level a
    :class:`DistributedPrunedMatrix` (module docstring), the coarsest
    level a dense inverse on the mesh's device.  The same numbers as
    ``pruned_pair_amg(..., pad_to=n_pad)``: a hierarchy whose shard
    blocks would fall below 1024 rows before ``coarse_size`` is reached
    raises instead of differing from it."""
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"unknown smoother {smoother!r}")
    if coarse_size > 8192:
        raise ValueError("coarse_size above ~8K is dense-inverted")

    D = mesh.shape[axis]
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals = np.asarray(vals).ravel()
    dtype = np.dtype(vals.dtype)
    lvl_dtype = torch_dtype(level_dtype) if level_dtype is not None else torch_dtype(dtype)
    n = int(n)

    if fine_A is not None:
        block = fine_A.block
    else:
        block = max(128 * _next_pow2(-(-n // (D * 128))), 1024)
    if block & (block - 1) or block % 128:
        raise ValueError("shard block must be a power-of-two multiple of 128")

    levels = []
    nl, blk = D * block, block
    r, c, v = rows, cols, vals
    # blk >= 1024: the plan's least tile; below it the remainder goes to
    # the dense coarse solve
    while nl > coarse_size and blk >= 1024:
        if not levels and fine_A is not None:
            Alvl = fine_A if fine_A.dtype == lvl_dtype else fine_A.astype(lvl_dtype)
        else:
            # symmetric levels: pair coarsening keeps the fine level's
            # symmetry; coarsened triples are canonical
            Alvl = distribute_pruned(
                nl, r, c, v, mesh, axis=axis, tile_rows=min(tile_rows, blk), group=group,
                block=blk, dtype=lvl_dtype, symmetric=symmetric, validate=False,
                assume_unique=bool(levels),
            )
        dinv, lmax = _coo_dinv_lmax(nl, r, c, v, dtype, smoother == "chebyshev")
        levels.append(_SLevel(A=Alvl, dinv=distribute_vector(dinv, mesh, axis, nl), dims=(nl,),
                              axes=(0,), omega=float(omega), lmax=lmax))
        nc = nl // 2  # n_pad is D times a power of two: exact halving
        r, c, v = _pair_coarsen_coo(r, c, v, nc, dtype)
        nl, blk = nc, blk // 2

    if nl > coarse_size:
        raise ValueError(
            f"the {D}-shard 1024-row block floor stops pair-coarsening at {nl} rows, above "
            f"the requested coarse_size {coarse_size}: pass coarse_size >= {min(nl, 8192)} "
            "(<= 8192, the dense coarse solve's limit) or use fewer shards"
        )
    coarse = np.zeros((nl, nl), np.float64)
    coarse[r, c] = v.astype(np.float64)
    coarse += 1e-12 * np.eye(nl)
    cinv = torch.from_numpy(np.linalg.inv(coarse).astype(dtype)).to(mesh.device)
    return StructuredAMGPreconditioner(levels=tuple(levels), coarse_inv=cinv,
                                       n_smooth=n_smooth, smoother=smoother)
