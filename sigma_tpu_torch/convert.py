"""Carry the JAX package's state across as port objects.

Takes plain numpy arrays (for example ``np.asarray(A.data)`` of a
``sigma_tpu`` matrix) and returns port objects on a given device (CUDA
when ``device`` is None); it imports nothing of JAX.  DIA values are
accepted in the JAX package's ``(D, S, 128)`` tile layout or as
``(D, stride)``: the flat element order is the same, so the conversion
is a reshape.  A pruned plan arrives as the JAX package's arrays
(``data`` (L, C, T, 128), ``tile``, ``first``, ``rowoff``, ``laneoff``)
and is mapped to the port's layout: the values are a reshape to
(L * C, T * 128), each slot's window position becomes its column offset
``(rowoff - halo) * 128 + laneoff``, and the per-step tiles become
per-tile slot ranges.  CSR and COO matrices arrive as their index arrays
and values, which the JAX package pads to a multiple of 8 past ``nnz``;
the padding is cut off; so do CSC matrices.  ELL matrices arrive as the
(n, width) neighbour and value arrays.  BSR matrices arrive as their block
arrays, padding included, because the port keeps that padding; a grouped
BSR as its three arrays.  A block matrix is put together from leaves that
were converted one by one.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from sigma_tpu_torch.graph.graph import (
    BSRGraph,
    COOGraph,
    CSCGraph,
    CSRGraph,
    DIAGraph,
    ELLGraph,
)
from sigma_tpu_torch.matrix.composite import BlockMatrix
from sigma_tpu_torch.matrix.formats import (
    BSRMatrix,
    COOMatrix,
    CSCMatrix,
    CSRMatrix,
    DIAMatrix,
    ELLMatrix,
)
from sigma_tpu_torch.ops.bsr_grouped import GroupedBSR
from sigma_tpu_torch.matrix.pruned import PrunedDIAMatrix, SymmetricPrunedDIAMatrix
from sigma_tpu_torch.matrix.symmetric import SymmetricDIAMatrix
from sigma_tpu_torch.solvers.gmg import StructuredAMGPreconditioner, _SLevel
from sigma_tpu_torch.utils.device import resolve_device

__all__ = [
    "block_matrix_from_blocks",
    "bsr_from_arrays",
    "coo_from_arrays",
    "csc_from_arrays",
    "csr_from_arrays",
    "dia_from_arrays",
    "ell_from_arrays",
    "grouped_bsr_from_arrays",
    "pruned_amg_from_arrays",
    "pruned_from_arrays",
    "structured_amg_from_arrays",
    "sym_dia_from_arrays",
]


def _tensor(arr, device) -> torch.Tensor:
    """A copy of a numpy array as a tensor on ``device`` (None: CUDA).  A
    bfloat16 array (numpy's ml_dtypes extension; torch cannot read it)
    widens exactly to float32 and narrows back."""
    device = resolve_device(device)
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(arr, device=device)


def dia_from_arrays(offsets, data, shape, device=None) -> DIAMatrix:
    """DIAMatrix from its offsets, values ``(D, S, 128)`` or ``(D, stride)``
    and shape (n, m)."""
    graph = DIAGraph.from_offsets(offsets, *(int(s) for s in shape))
    values = np.asarray(data).reshape(graph.n_diags, -1)
    return DIAMatrix(graph=graph, data=_tensor(values, device))


def csr_from_arrays(indptr, indices, data, shape, device=None) -> CSRMatrix:
    """CSRMatrix from the JAX package's ``indptr``, ``indices`` and values
    (padded past nnz = ``indptr[-1]``) and shape (n, m); the values keep
    their dtype."""
    nnz = int(np.asarray(indptr)[-1])
    g = CSRGraph.from_csr(*shape, indptr, np.asarray(indices)[:nnz])
    return CSRMatrix(graph=g, data=_tensor(np.asarray(data).reshape(-1)[:nnz], device))


def coo_from_arrays(rows, cols, data, shape, nnz, device=None) -> COOMatrix:
    """COOMatrix from the JAX package's row-major sorted, duplicate-free
    ``rows``, ``cols`` and values (padded past ``nnz``) and shape (n, m)."""
    nnz = int(nnz)
    rows = np.asarray(rows, dtype=np.int64)[:nnz]
    cols = np.asarray(cols, dtype=np.int64)[:nnz]
    g = COOGraph(rows=rows, cols=cols, shape=tuple(int(s) for s in shape), nnz=nnz)
    return COOMatrix(graph=g, data=_tensor(np.asarray(data).reshape(-1)[:nnz], device))


def csc_from_arrays(indptr, indices, data, shape, device=None) -> CSCMatrix:
    """CSCMatrix from the JAX package's per-column ``indptr``, row
    ``indices`` and column-major values (padded past nnz = ``indptr[-1]``)
    and shape (n, m)."""
    n, m = (int(s) for s in shape)
    indptr = np.asarray(indptr, dtype=np.int64)
    nnz = int(indptr[-1])
    g = CSCGraph(
        indptr=indptr, indices=np.asarray(indices, dtype=np.int64)[:nnz],
        col_ids=np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr)),
        shape=(n, m), nnz=nnz,
    )
    return CSCMatrix(graph=g, data=_tensor(np.asarray(data).reshape(-1)[:nnz], device))


def ell_from_arrays(cols, degrees, data, shape, device=None) -> ELLMatrix:
    """ELLMatrix from the JAX package's (n, width) neighbour array, row
    degrees and (n, width) values, and shape (n, m)."""
    degrees = np.asarray(degrees, dtype=np.int64)
    g = ELLGraph(cols=np.asarray(cols, dtype=np.int64), degrees=degrees,
                 shape=tuple(int(s) for s in shape), nnz=int(degrees.sum()))
    return ELLMatrix(graph=g, data=_tensor(data, device))


def bsr_from_arrays(indptr, indices, block_rows, mask, data, shape, block_shape,
                    device=None) -> BSRMatrix:
    """BSRMatrix from the JAX package's block arrays, padding included:
    ``indptr`` (nb_rows + 1,), ``indices`` and ``block_rows`` (nnzb_pad,),
    ``mask`` and values (nnzb_pad, bh, bw), and the shapes."""
    device = resolve_device(device)
    indptr = np.asarray(indptr, dtype=np.int64)
    nnzb = int(indptr[-1])
    mask = np.asarray(mask, dtype=bool)
    g = BSRGraph(
        indptr=torch.from_numpy(indptr).to(device),
        indices=torch.from_numpy(np.asarray(indices, dtype=np.int64)).to(device),
        block_rows=torch.from_numpy(np.asarray(block_rows, dtype=np.int64)).to(device),
        mask=torch.from_numpy(mask).to(device),
        shape=tuple(int(s) for s in shape), block_shape=tuple(int(s) for s in block_shape),
        nnz=int(mask[:nnzb].sum()), nnzb=nnzb,
    )
    return BSRMatrix(graph=g, data=_tensor(data, device))


def grouped_bsr_from_arrays(gdata, gcols, grow, shape, block_shape, group,
                            device=None) -> GroupedBSR:
    """GroupedBSR from the JAX package's ``gdata`` (G, bh, B*bw), ``gcols``
    (G, B) and ``grow`` (G,), and the shapes."""
    device = resolve_device(device)
    return GroupedBSR(
        gdata=_tensor(gdata, device),
        gcols=torch.from_numpy(np.array(gcols, dtype=np.int32)).to(device),
        grow=torch.from_numpy(np.array(grow, dtype=np.int32)).to(device),
        shape=shape, block_shape=block_shape, group=group,
    )


def block_matrix_from_blocks(blocks) -> BlockMatrix:
    """BlockMatrix from a nested sequence of port operators (each made by
    one of this module's functions from the arrays of the JAX block in its
    place) and ``None`` for the absent blocks."""
    return BlockMatrix.from_blocks(blocks)


def sym_dia_from_arrays(offsets, data, n, device=None) -> SymmetricDIAMatrix:
    """SymmetricDIAMatrix from its upper offsets, values ``(D_u, S, 128)``
    or ``(D_u, stride)`` and order n."""
    offsets = tuple(int(o) for o in offsets)
    values = np.asarray(data).reshape(len(offsets), -1)
    return SymmetricDIAMatrix(data=_tensor(values, device), offsets=offsets, n=int(n))


def structured_amg_from_arrays(
    levels: Sequence[Mapping], coarse_inv, n_smooth=1, smoother="jacobi",
    device=None,
) -> StructuredAMGPreconditioner:
    """StructuredAMGPreconditioner from per-level dicts with keys
    ``offsets``, ``data``, ``shape``, ``dinv``, ``dims``, ``axes``,
    ``omega`` and ``lmax`` (None for the Jacobi smoother), plus the dense
    ``coarse_inv``.  A level dict with ``symmetric=True`` holds
    upper-diagonal storage (a symmetric fine operator)."""
    device = resolve_device(device)
    out = []
    for lv in levels:
        if lv.get("symmetric", False):
            A = sym_dia_from_arrays(lv["offsets"], lv["data"], lv["shape"][0], device)
        else:
            A = dia_from_arrays(lv["offsets"], lv["data"], lv["shape"], device)
        dinv = _tensor(lv["dinv"], device)
        lmax = lv.get("lmax")
        out.append(
            _SLevel(
                A=A,
                dinv=dinv,
                dims=tuple(int(d) for d in lv["dims"]),
                axes=tuple(int(a) for a in lv["axes"]),
                omega=float(lv["omega"]),
                lmax=None if lmax is None else float(lmax),
            )
        )
    return StructuredAMGPreconditioner(
        levels=tuple(out),
        coarse_inv=_tensor(coarse_inv, device),
        n_smooth=int(n_smooth),
        smoother=smoother,
    )


def pruned_from_arrays(data, tile, first, rowoff, laneoff, n, m, halo, nnz,
                       symmetric=False, device=None) -> PrunedDIAMatrix:
    """PrunedDIAMatrix (or SymmetricPrunedDIAMatrix) from the JAX package's
    plan arrays: values (L, C, T, 128), per-step ``tile`` and ``first``
    (L,), per-slot ``rowoff`` and ``laneoff`` (L * C,), and the matrix's
    n, m, halo and nnz."""
    data = np.asarray(data)
    L, C, T, lanes = data.shape
    tile = np.asarray(tile, dtype=np.int64)
    G = -(-(-(-int(n) // lanes)) // T)  # tiles of T rows of 128
    steps = np.bincount(tile, minlength=G)
    # the JAX plan gives every tile, in order, a run of steps whose first
    # is flagged: the runs become slot ranges
    if (tile.size != L or steps.size != G or np.any(steps == 0) or np.any(np.diff(tile) < 0)
            or not np.array_equal(np.asarray(first) == 1, np.r_[True, np.diff(tile) > 0])):
        raise ValueError("want each tile's steps contiguous, in tile order, the first flagged")
    offsets = (np.asarray(rowoff, np.int64) - int(halo)) * lanes + np.asarray(laneoff, np.int64)
    tile_ptr = np.concatenate([[0], np.cumsum(steps * C)]).astype(np.int64)
    device = resolve_device(device)
    cls = SymmetricPrunedDIAMatrix if symmetric else PrunedDIAMatrix
    return cls(
        data=_tensor(data.reshape(L * C, T * lanes), device),
        offsets=torch.from_numpy(offsets).to(device),
        tile_ptr=torch.from_numpy(tile_ptr).to(device),
        n=int(n), m=int(m), halo=int(halo), nnz=int(nnz), group=int(C),
    )


def pruned_amg_from_arrays(levels: Sequence[Mapping], coarse_inv, n_smooth=1,
                           smoother="chebyshev", device=None) -> StructuredAMGPreconditioner:
    """The pruned pair hierarchy of ``sigma_tpu.solvers.pruned_pair_amg``
    from per-level dicts with the plan keys of :func:`pruned_from_arrays`
    (``data``, ``tile``, ``first``, ``rowoff``, ``laneoff``, ``n``, ``m``,
    ``halo``, ``nnz``, ``symmetric``) and ``dinv``, ``omega``, ``lmax``
    (None for the Jacobi smoother), plus the dense ``coarse_inv``."""
    device = resolve_device(device)
    out = []
    for lv in levels:
        A = pruned_from_arrays(
            lv["data"], lv["tile"], lv["first"], lv["rowoff"], lv["laneoff"], lv["n"],
            lv["m"], lv["halo"], lv["nnz"], lv.get("symmetric", False), device,
        )
        lmax = lv.get("lmax")
        out.append(_SLevel(A=A, dinv=_tensor(lv["dinv"], device), dims=(int(lv["n"]),),
                           axes=(0,), omega=float(lv["omega"]),
                           lmax=None if lmax is None else float(lmax)))
    return StructuredAMGPreconditioner(
        levels=tuple(out), coarse_inv=_tensor(coarse_inv, device),
        n_smooth=int(n_smooth), smoother=smoother,
    )
