"""Composite block matrix: a matrix of matrices.

Port of :mod:`sigma_tpu.matrix.composite`.  :class:`BlockMatrix` is a
(br x bc) grid of optional leaf operators over fixed row and column
partitions.  ``matvec`` hands block (i, j) the slice ``x[off_j : off_j +
s_j]`` (a contiguous view with a storage offset, which the DIA kernels read
in place), sums the products of a block row and concatenates the row
segments; absent blocks (``None``) cost nothing.  Every present block runs
its own kernel, so a 3 x 3 grid of DIA blocks is 9 SpMV launches, 6 adds
and one ``torch.cat`` per product, where the JAX package traced the whole
grid into one XLA program.

Global <-> local index mapping is vectorised with ``np.searchsorted``.
The capability flags AND-reduce over the blocks.  Shared-graph blocks (one
topology reused by several blocks) work as they are: graphs are immutable.

A frozen dataclass holding a tuple of tuples of operators, as the port's
matrices are (the JAX package's is a registered pytree); ``set_block``,
``set_values`` and ``add_values`` return new objects.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sigma_tpu_torch.matrix.base import SparseMatrix
from sigma_tpu_torch.operators.linear_operator import LinearOperator

__all__ = ["BlockMatrix"]


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class BlockMatrix(LinearOperator):
    """Block "matrix of matrices" over fixed row/column partitions.

    ``blocks[i][j]`` is a leaf :class:`LinearOperator` (usually a
    :class:`SparseMatrix` in any format) of shape
    ``(row_sizes[i], col_sizes[j])``, or ``None`` for a structurally zero
    block.
    """

    blocks: Tuple[Tuple[Optional[LinearOperator], ...], ...]
    row_sizes: Tuple[int, ...]
    col_sizes: Tuple[int, ...]

    # -- construction ----------------------------------------------------------
    @classmethod
    def from_blocks(cls, blocks: Sequence[Sequence[Optional[LinearOperator]]]):
        """Build from a nested sequence (rows of blocks); sizes inferred.

        Every row must have the same number of blocks; each present block
        pins the sizes of its row/column slot, and inconsistencies raise.
        """
        grid = [list(row) for row in blocks]
        if not grid or not grid[0]:
            raise ValueError("empty block grid")
        bc = len(grid[0])
        if any(len(row) != bc for row in grid):
            raise ValueError("ragged block grid")
        row_sizes = [None] * len(grid)
        col_sizes = [None] * bc
        for i, row in enumerate(grid):
            for j, blk in enumerate(row):
                if blk is None:
                    continue
                r, c = blk.shape
                if row_sizes[i] is None:
                    row_sizes[i] = int(r)
                elif row_sizes[i] != r:
                    raise ValueError(f"block ({i},{j}) row size {r} != {row_sizes[i]}")
                if col_sizes[j] is None:
                    col_sizes[j] = int(c)
                elif col_sizes[j] != c:
                    raise ValueError(f"block ({i},{j}) col size {c} != {col_sizes[j]}")
        if any(s is None for s in row_sizes) or any(s is None for s in col_sizes):
            raise ValueError(
                "every block row/column needs at least one present block to "
                "pin its size; pass explicit zero matrices otherwise"
            )
        return cls(
            blocks=tuple(tuple(row) for row in grid),
            row_sizes=tuple(row_sizes),
            col_sizes=tuple(col_sizes),
        )

    @classmethod
    def empty(cls, row_sizes: Sequence[int], col_sizes: Sequence[int]):
        """All-zero block grid with a fixed partition."""
        grid = tuple(tuple(None for _ in col_sizes) for _ in range(len(row_sizes)))
        return cls(
            blocks=grid,
            row_sizes=tuple(int(s) for s in row_sizes),
            col_sizes=tuple(int(s) for s in col_sizes),
        )

    @classmethod
    def wrap(cls, leaf: LinearOperator) -> "BlockMatrix":
        """1x1 strategy wrapper around a single leaf."""
        return cls.from_blocks([[leaf]])

    def set_block(self, i: int, j: int, block: Optional[LinearOperator]):
        """Functional block insert."""
        if block is not None:
            want = (self.row_sizes[i], self.col_sizes[j])
            if tuple(block.shape) != want:
                raise ValueError(f"block shape {block.shape} != slot {want}")
        grid = [list(row) for row in self.blocks]
        grid[i][j] = block
        return dataclasses.replace(self, blocks=tuple(tuple(row) for row in grid))

    # -- shape/meta ------------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return (sum(self.row_sizes), sum(self.col_sizes))

    @property
    def block_shape(self) -> Tuple[int, int]:
        return (len(self.row_sizes), len(self.col_sizes))

    @property
    def row_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.row_sizes)])

    @property
    def col_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.col_sizes)])

    def get_block(self, i: int, j: int) -> Optional[LinearOperator]:
        return self.blocks[i][j]

    def _present(self):
        return [blk for row in self.blocks for blk in row if blk is not None]

    @property
    def nnz(self) -> int:
        # duck-typed: pruned, symmetric and nested BlockMatrix leaves are
        # LinearOperators with .nnz, not SparseMatrix
        return sum(getattr(blk, "nnz", 0) for blk in self._present())

    @property
    def is_get_row_fast(self) -> bool:
        return all(getattr(blk, "is_get_row_fast", False) for blk in self._present())

    @property
    def is_get_column_fast(self) -> bool:
        return all(getattr(blk, "is_get_column_fast", False) for blk in self._present())

    # -- compute ---------------------------------------------------------------
    def _apply(self, X, product: str, transpose: bool):
        """Block-wise sum: segment i of the result is the sum over the
        present blocks of (block) row i of ``blk.<product>(X segment j)``;
        with ``transpose`` the roles of rows and columns swap."""
        in_off = self.row_offsets if transpose else self.col_offsets
        out_sizes = self.col_sizes if transpose else self.row_sizes
        n_in = len(in_off) - 1
        ys = []
        for a, size in enumerate(out_sizes):
            acc = None
            for b in range(n_in):
                blk = self.blocks[b][a] if transpose else self.blocks[a][b]
                if blk is None:
                    continue
                t = getattr(blk, product)(X[in_off[b] : in_off[b + 1]])
                acc = t if acc is None else acc + t
            if acc is None:
                acc = X.new_zeros((size,) + tuple(X.shape[1:]))
            ys.append(acc)
        return ys[0] if len(ys) == 1 else torch.cat(ys)

    def matvec(self, x):
        """Block-wise y_i = sum_j A_ij x_j."""
        return self._apply(x, "matvec", transpose=False)

    def rmatvec(self, x):
        return self._apply(x, "rmatvec", transpose=True)

    def matmat(self, X):
        return self._apply(X, "matmat", transpose=False)

    def rmatmat(self, X):
        return self._apply(X, "rmatmat", transpose=True)

    # -- global index routing ----------------------------------------------------
    def _owners(self, rows, cols):
        rows = np.asarray(rows).ravel()
        cols = np.asarray(cols).ravel()
        n, m = self.shape
        if ((rows < 0) | (rows >= n) | (cols < 0) | (cols >= m)).any():
            raise IndexError(f"global index out of range for shape {self.shape}")
        ro, co = self.row_offsets, self.col_offsets
        bi = np.searchsorted(ro, rows, side="right") - 1
        bj = np.searchsorted(co, cols, side="right") - 1
        return bi, bj, rows - ro[bi], cols - co[bj]

    def get_values(self, rows, cols) -> np.ndarray:
        bi, bj, li, lj = self._owners(rows, cols)
        out = np.zeros(li.shape, dtype=float)
        for (i, j) in {(int(a), int(b)) for a, b in zip(bi, bj)}:
            blk = self.blocks[i][j]
            sel = (bi == i) & (bj == j)
            if blk is None:
                continue
            if isinstance(blk, (SparseMatrix, BlockMatrix)):
                out[sel] = blk.get_values(li[sel], lj[sel])
            else:
                out[sel] = [blk.get_value(a, b) for a, b in zip(li[sel], lj[sel])]
        return out

    def get_value(self, i: int, j: int) -> float:
        return float(self.get_values([i], [j])[0])

    def _route_update(self, rows, cols, vals, add: bool) -> "BlockMatrix":
        bi, bj, li, lj = self._owners(rows, cols)
        vals = np.asarray(vals).ravel()
        new = self
        for (i, j) in sorted({(int(a), int(b)) for a, b in zip(bi, bj)}):
            blk = new.blocks[i][j]
            if blk is None or not isinstance(blk, (SparseMatrix, BlockMatrix)):
                raise ValueError(f"cannot set values in absent/non-sparse block ({i},{j})")
            sel = (bi == i) & (bj == j)
            update = blk.add_values if add else blk.set_values
            new = new.set_block(i, j, update(li[sel], lj[sel], vals[sel]))
        return new

    def set_values(self, rows, cols, vals) -> "BlockMatrix":
        """Global batched set routed to the owning blocks."""
        return self._route_update(rows, cols, vals, add=False)

    def add_values(self, rows, cols, vals) -> "BlockMatrix":
        return self._route_update(rows, cols, vals, add=True)

    # -- export ----------------------------------------------------------------
    def entries(self):
        """Global (rows, cols, vals) across blocks, offset by block origin."""
        ro, co = self.row_offsets, self.col_offsets
        rr, cc, vv = [], [], []
        for i, row in enumerate(self.blocks):
            for j, blk in enumerate(row):
                if blk is None:
                    continue
                if hasattr(blk, "entries"):
                    r, c, v = blk.entries()
                else:
                    d = blk.to_dense()
                    r, c = np.nonzero(d)
                    v = d[r, c]
                rr.append(r + ro[i])
                cc.append(c + co[j])
                vv.append(v)
        if not rr:
            return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64), np.empty(0)
        return np.concatenate(rr), np.concatenate(cc), np.concatenate(vv)

    def to_dense(self) -> np.ndarray:
        rows, cols, vals = self.entries()
        d = np.zeros(self.shape)
        np.add.at(d, (rows, cols), vals)
        return d

    def __repr__(self) -> str:
        return (
            f"BlockMatrix(block_shape={self.block_shape}, shape={self.shape}, "
            f"nnz={self.nnz})"
        )
