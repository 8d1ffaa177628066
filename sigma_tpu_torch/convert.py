"""Carry the JAX package's state across as port objects.

Takes plain numpy arrays (for example ``np.asarray(A.data)`` of a
``sigma_tpu`` matrix) and returns port objects on a given device; it
imports nothing of JAX.  DIA values are accepted in the JAX package's
``(D, S, 128)`` tile layout or as ``(D, stride)``: the flat element order
is the same, so the conversion is a reshape.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from sigma_tpu_torch.graph.graph import DIAGraph
from sigma_tpu_torch.matrix.formats import DIAMatrix
from sigma_tpu_torch.matrix.symmetric import SymmetricDIAMatrix
from sigma_tpu_torch.solvers.gmg import StructuredAMGPreconditioner, _SLevel

__all__ = ["dia_from_arrays", "sym_dia_from_arrays", "structured_amg_from_arrays"]


def _tensor(arr, device) -> torch.Tensor:
    """A copy of a numpy array as a tensor on ``device``.  A bfloat16 array
    (numpy's ml_dtypes extension; torch cannot read it) widens exactly to
    float32 and narrows back."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(arr, device=device)


def dia_from_arrays(offsets, data, shape, device="cpu") -> DIAMatrix:
    """DIAMatrix from its offsets, values ``(D, S, 128)`` or ``(D, stride)``
    and shape (n, m)."""
    offsets = tuple(int(o) for o in offsets)
    n, m = (int(s) for s in shape)
    nnz = sum(max(0, min(n, m - o) - max(0, -o)) for o in offsets)
    graph = DIAGraph(offsets=offsets, shape=(n, m), nnz=int(nnz))
    values = np.asarray(data).reshape(len(offsets), -1)
    return DIAMatrix(graph=graph, data=_tensor(values, device))


def sym_dia_from_arrays(offsets, data, n, device="cpu") -> SymmetricDIAMatrix:
    """SymmetricDIAMatrix from its upper offsets, values ``(D_u, S, 128)``
    or ``(D_u, stride)`` and order n."""
    offsets = tuple(int(o) for o in offsets)
    values = np.asarray(data).reshape(len(offsets), -1)
    return SymmetricDIAMatrix(data=_tensor(values, device), offsets=offsets, n=int(n))


def structured_amg_from_arrays(
    levels: Sequence[Mapping], coarse_inv, n_smooth=1, smoother="jacobi",
    device="cpu",
) -> StructuredAMGPreconditioner:
    """StructuredAMGPreconditioner from per-level dicts with keys
    ``offsets``, ``data``, ``shape``, ``dinv``, ``dims``, ``axes``,
    ``omega`` and ``lmax`` (None for the Jacobi smoother), plus the dense
    ``coarse_inv``.  A level dict with ``symmetric=True`` holds
    upper-diagonal storage (a symmetric fine operator)."""
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
