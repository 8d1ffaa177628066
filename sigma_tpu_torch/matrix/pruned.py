"""Pruned block-DIA matrices: the unstructured-sparsity format.

Port of :mod:`sigma_tpu.matrix.pruned`.  After an RCM reorder an irregular
mesh's band is wide globally but narrow locally; storing every diagonal
of the band (DIA) would stream mostly zeros (10.3 GB of values at the
10M-row north star, 245 diagonals).  The pruned layout
(:mod:`sigma_tpu_torch.ops.spmv_pruned`) keeps only the active
(row tile x diagonal) blocks: 1.67 GB there, 0.98 GB in symmetric
storage.

Every matvec goes through :func:`~sigma_tpu_torch.ops.spmv_pruned.pruned_spmv`
(or ``pruned_sym_spmv``) and every multi-RHS product through
``pruned_spmm`` (or ``pruned_sym_spmm``): the CUDA kernel for a CUDA
operand, the plain PyTorch version for a CPU one, for every dtype pair of
``KERNEL_DTYPES`` (the JAX package sends float64 to its gather
reference).  The JAX package's ``why_not_pallas`` audits TPU gates the
port does not have and is left out.

Like :class:`~sigma_tpu_torch.matrix.symmetric.SymmetricDIAMatrix` these
are frozen :class:`LinearOperator` values; structural edits go back
through COO.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import numpy as np
import torch

from sigma_tpu_torch.matrix.formats import panel_apply
from sigma_tpu_torch.operators.linear_operator import LinearOperator
from sigma_tpu_torch.ops.spmv_pruned import (
    PrunedPlan,
    build_pruned_plan,
    pruned_spmm,
    pruned_spmv,
    pruned_sym_spmm,
    pruned_sym_spmv,
)
from sigma_tpu_torch.utils.device import resolve_device
from sigma_tpu_torch.utils.dtypes import to_numpy, torch_dtype

__all__ = [
    "PrunedDIAMatrix",
    "SymmetricPrunedDIAMatrix",
    "check_symmetric_triples",
]


def check_symmetric_triples(n, rows, cols, vals, rtol=1e-12):
    """Raise ValueError unless the COO triples are numerically symmetric
    (pattern and values, entry by entry within ``rtol`` of the largest
    off-diagonal value).  Duplicate keys are reduced last-value-wins first,
    as the pack does, so the check judges the matrix the operator holds."""

    def _canon(k, v):
        o = np.argsort(k, kind="stable")
        ks, vs = k[o], v[o]
        last = np.ones(ks.size, dtype=bool)
        last[:-1] = ks[1:] != ks[:-1]
        return ks[last], vs[last]

    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals = np.asarray(vals).ravel()
    up = cols > rows
    lo = cols < rows
    ku, vu = _canon(rows[up] * np.int64(n) + cols[up], vals[up])
    kl, vl = _canon(cols[lo] * np.int64(n) + rows[lo], vals[lo])
    if ku.size != kl.size or not np.array_equal(ku, kl):
        raise ValueError(
            "matrix pattern is not symmetric (upper/lower mirrors differ); pass "
            "validate=False only for known-symmetric triples"
        )
    scale = max(float(np.abs(vu).max(initial=0.0)), 1e-300)
    if float(np.abs(vu - vl).max(initial=0.0)) > rtol * scale:
        raise ValueError("matrix values are not symmetric")


def _dtypes(vals, dtype):
    """(torch value dtype, numpy dtype the pack writes): bfloat16 packs in
    float32 and is cast on the device."""
    dt = torch_dtype(dtype) if dtype is not None else torch_dtype(np.asarray(vals).dtype)
    return dt, (np.float64 if dt == torch.float64 else np.float32)


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class PrunedDIAMatrix(LinearOperator):
    """Packed active (row tile x diagonal) blocks of a banded matrix.

    ``data[s, r]`` is ``A[t * tile_rows + r, t * tile_rows + r +
    offsets[s]]`` for slot s of tile t; tile t's slots are ``tile_ptr[t]
    .. tile_ptr[t + 1]``, in offset order, padded with zero slots to a
    multiple of ``group``, and ``tile_end[t]`` ends tile t's active slots
    (the kernels skip the padding).  ``halo`` (rows of 128) sizes the
    symmetric spill.  ``t`` optionally carries the transposed plan, built
    at set-up by :meth:`with_transpose`.
    """

    data: torch.Tensor  # (n_slots, tile_rows) packed values
    offsets: torch.Tensor  # (n_slots,) int64 column offset per slot
    tile_ptr: torch.Tensor  # (G + 1,) int64 first slot per tile
    tile_end: torch.Tensor  # (G,) int64 end of each tile's active slots
    n: int
    m: int
    halo: int
    nnz: int
    group: int
    t: Optional["PrunedDIAMatrix"] = None

    format: ClassVar[str] = "dia_pruned"

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.m)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def tile_rows(self) -> int:
        return self.data.shape[1]

    @property
    def n_steps(self) -> int:
        """Groups of ``group`` slots (the TPU kernel's grid steps)."""
        return self.data.shape[0] // self.group

    @property
    def stored_slots(self) -> int:
        """Packed values: what each matvec streams."""
        return self.data.numel()

    # -- construction ------------------------------------------------------
    @classmethod
    def _from_plan(cls, plan: PrunedPlan, dtype, device, nnz):
        device = resolve_device(device)

        def dev(a):
            return torch.from_numpy(a).to(device)

        return cls(
            data=dev(plan.data).to(dtype), offsets=dev(plan.offsets),
            tile_ptr=dev(plan.tile_ptr), tile_end=dev(plan.tile_end), n=plan.n, m=plan.m,
            halo=plan.halo, nnz=int(nnz), group=plan.group,
        )

    @classmethod
    def from_coo(
        cls, n, m, rows, cols, vals, *, dtype=None, tile_rows: int = 16384,
        group: int | None = None, assume_unique=False, device=None,
    ) -> "PrunedDIAMatrix":
        """Pack COO entries on the host and push them once (duplicate
        entries: the last value wins).  ``tile_rows`` is the pruning
        granularity, ``group`` the padding multiple of each tile's slot
        count (default 16 for bfloat16 values, else 8, the JAX package's
        measured defaults).  ``assume_unique`` skips the duplicate count
        (canonical triples, such as ``entries()``).  ``device=None``
        builds on CUDA."""
        dt, plan_dt = _dtypes(vals, dtype)
        if group is None:
            group = 16 if dt == torch.bfloat16 else 8
        plan = build_pruned_plan(n, m, rows, cols, vals, tile_rows=tile_rows,
                                 group=group, dtype=plan_dt)
        rows = np.asarray(rows)
        if assume_unique:
            nnz = rows.size
        else:
            key = rows.astype(np.int64) * int(m) + np.asarray(cols)
            nnz = int(np.unique(key).size)
        return cls._from_plan(plan, dt, device, nnz)

    @classmethod
    def from_dia(cls, A, **kw) -> "PrunedDIAMatrix":
        """Repack a (wide-band) DIAMatrix, dropping its structural zeros;
        on A's device unless ``device`` is given."""
        rows, cols, vals = A.entries()
        keep = vals != 0
        kw.setdefault("device", A.device)
        return cls.from_coo(A.shape[0], A.shape[1], rows[keep], cols[keep],
                            vals[keep], dtype=A.dtype, **kw)

    @classmethod
    def from_dense(cls, dense, **kw) -> "PrunedDIAMatrix":
        dense = np.asarray(dense)
        rows, cols = np.nonzero(dense)
        return cls.from_coo(dense.shape[0], dense.shape[1], rows, cols,
                            dense[rows, cols], dtype=dense.dtype, **kw)

    # -- introspection -----------------------------------------------------
    def entries(self):
        """(rows, cols, vals) of the stored nonzeros, host numpy.  The
        pattern comes from nonzero values (padding slots look like stored
        zeros), so explicitly stored zeros are dropped and ``nnz`` can
        exceed ``len(vals)``."""
        TR = self.tile_rows
        data = to_numpy(self.data)
        tile_ptr = to_numpy(self.tile_ptr)
        starts = np.repeat(np.arange(tile_ptr.size - 1, dtype=np.int64) * TR,
                           np.diff(tile_ptr))
        slots, locs = np.nonzero(data)
        rows = starts[slots] + locs
        cols = rows + to_numpy(self.offsets)[slots]
        vals = data[slots, locs]
        ok = (rows < self.n) & (cols >= 0) & (cols < self.m)
        return rows[ok], cols[ok], vals[ok]

    def to_dense(self) -> np.ndarray:
        rows, cols, vals = self.entries()
        out = np.zeros(self.shape, dtype=vals.dtype)
        out[rows, cols] = vals
        return out

    def astype(self, dtype) -> "PrunedDIAMatrix":
        """Per-value cast (bfloat16 halves the value stream); the packing
        stays."""
        dt = torch_dtype(dtype)
        return dataclasses.replace(
            self, data=self.data.to(dt), t=None if self.t is None else self.t.astype(dt)
        )

    def transpose(self) -> "PrunedDIAMatrix":
        """Host rebuild of the transposed matrix (the layout is
        row-tile oriented), on the same device."""
        rows, cols, vals = self.entries()
        return PrunedDIAMatrix.from_coo(
            self.m, self.n, cols, rows, vals, dtype=self.dtype,
            tile_rows=self.tile_rows, group=self.group, assume_unique=True,
            device=self.device,
        )

    def with_transpose(self) -> "PrunedDIAMatrix":
        """A copy that carries the transposed plan, so that ``rmatvec`` and
        ``rmatmat`` cost no host rebuild."""
        if self.t is not None:
            return self
        return dataclasses.replace(self, t=self.transpose())

    def get_value(self, i: int, j: int):
        rows, cols, vals = self.entries()
        hit = (rows == i) & (cols == j)
        return float(vals[hit][0]) if hit.any() else 0.0

    # -- compute -----------------------------------------------------------
    def matvec(self, x):
        if x.ndim != 1:
            raise ValueError("matvec expects a vector; use matmat")
        return pruned_spmv(self.data, x, self.offsets, self.tile_ptr, self.n, self.m,
                           group=self.group, tile_end=self.tile_end)

    def _spmm(self, X, layout):
        return pruned_spmm(self.data, X, self.offsets, self.tile_ptr, self.n, self.m, layout,
                           group=self.group, tile_end=self.tile_end)

    def matmat(self, X):
        """A @ X for X (m, k): one SpMM launch per 16 columns, the packed
        values read once for all of them."""
        return panel_apply(X, self._spmm, self.n)

    def matmat_rhs_major(self, XT):
        """RHS-major product XT (k, m) -> (k, n), no transposes."""
        return self.matmat(XT.T).T

    def _transposed(self) -> "PrunedDIAMatrix":
        if self.t is not None:
            return self.t
        cached = getattr(self, "_t_cache", None)
        if cached is None:
            cached = self.transpose()
            object.__setattr__(self, "_t_cache", cached)
        return cached

    def rmatvec(self, x):
        """A^T x through the transposed plan (built once and cached unless
        :meth:`with_transpose` attached it)."""
        return self._transposed().matvec(x)

    def rmatmat(self, X):
        return self._transposed().matmat(X)

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(shape={self.shape}, nnz={self.nnz}, "
            f"slots={self.data.shape[0]}, tile_rows={self.tile_rows}, "
            f"dtype={self.dtype}, device={self.data.device})"
        )


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class SymmetricPrunedDIAMatrix(PrunedDIAMatrix):
    """Symmetric storage: only the slots with offset >= 0 (upper triangle
    and main diagonal) are packed, half the value stream of
    :class:`PrunedDIAMatrix` on an SPD operator; the lower triangle is the
    kernel's mirror term.  ``nnz`` counts both triangles; ``transpose()``
    is the identity and ``rmatvec`` is ``matvec``.

    The JAX package routes block solvers to full storage (its symmetric
    SpMM lost at k=8 on the TPU) and matvec-bound solvers (CG, Chebyshev,
    multigrid) to symmetric storage; the H100 times of both are in
    PERF.md."""

    format: ClassVar[str] = "dia_pruned_sym"

    @classmethod
    def from_coo(
        cls, n, m, rows, cols, vals, *, dtype=None, tile_rows: int = 16384,
        group: int | None = None, assume_unique=False, validate: bool = True,
        rtol: float = 1e-12, device=None,
    ) -> "SymmetricPrunedDIAMatrix":
        """Pack the upper triangle of full (both-triangle) COO triples.
        ``validate`` checks numeric symmetry entry by entry (an
        O(nnz log nnz) host sort; pass False for triples symmetric by
        construction).  ``group`` defaults to 12 (the JAX package's
        measured optimum for the halved slot pool)."""
        if int(n) != int(m):
            raise ValueError("symmetric storage requires a square matrix")
        n = int(n)
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        vals = np.asarray(vals).ravel()
        if validate:
            check_symmetric_triples(n, rows, cols, vals, rtol=rtol)
        keep = cols >= rows
        urows, ucols, uvals = rows[keep], cols[keep], vals[keep]
        dt, plan_dt = _dtypes(vals, dtype)
        if group is None:
            group = 12
        plan = build_pruned_plan(n, n, urows, ucols, uvals, tile_rows=tile_rows,
                                 group=group, dtype=plan_dt)
        if assume_unique:
            n_up = urows.size
            n_diag = int((urows == ucols).sum())
        else:
            uk = np.unique(urows * np.int64(n) + ucols)
            n_up = int(uk.size)
            n_diag = int((uk // n == uk % n).sum())
        return cls._from_plan(plan, dt, device, 2 * n_up - n_diag)

    @classmethod
    def from_pruned(cls, A: PrunedDIAMatrix, *, tile_rows=None, group=None,
                    validate: bool = True, rtol: float = 1e-12):
        """Fold a full-storage pruned matrix into symmetric storage, on A's
        device; ``group`` defaults to the symmetric 12, not A's."""
        rows, cols, vals = A.entries()
        return cls.from_coo(
            A.shape[0], A.shape[1], rows, cols, vals, dtype=A.dtype,
            tile_rows=A.tile_rows if tile_rows is None else tile_rows,
            group=group, assume_unique=True, validate=validate, rtol=rtol,
            device=A.device,
        )

    # -- introspection -----------------------------------------------------
    def entries(self):
        """Both-triangle (rows, cols, vals): the stored upper entries and
        their mirrors (explicit zeros dropped, as the parent's)."""
        r, c, v = super().entries()
        off = c > r
        return (np.concatenate([r, c[off]]), np.concatenate([c, r[off]]),
                np.concatenate([v, v[off]]))

    def _upper_counts(self):
        cached = getattr(self, "_upper_counts_cache", None)
        if cached is None:
            r, c, _ = super().entries()
            cached = (int(r.size), int((r == c).sum()))
            object.__setattr__(self, "_upper_counts_cache", cached)
        return cached

    @property
    def stored_upper(self) -> int:
        """Stored upper-triangle entries, main diagonal included (explicit
        zeros dropped, so it can undercount the construction's ``nnz``)."""
        return self._upper_counts()[0]

    @property
    def n_diag_entries(self) -> int:
        """Stored main-diagonal entries (same caveat)."""
        return self._upper_counts()[1]

    def transpose(self) -> "SymmetricPrunedDIAMatrix":
        return self

    def with_transpose(self) -> "SymmetricPrunedDIAMatrix":
        return self

    # -- compute -----------------------------------------------------------
    def matvec(self, x):
        if x.ndim != 1:
            raise ValueError("matvec expects a vector; use matmat")
        return pruned_sym_spmv(self.data, x, self.offsets, self.tile_ptr, self.n,
                               self.m, halo=self.halo, group=self.group,
                               tile_end=self.tile_end)

    rmatvec = matvec

    def _spmm(self, X, layout):
        return pruned_sym_spmm(self.data, X, self.offsets, self.tile_ptr, self.n,
                               self.m, layout, halo=self.halo, group=self.group,
                               tile_end=self.tile_end)

    def matmat(self, X):
        return panel_apply(X, self._spmm, self.n)

    rmatmat = matmat
