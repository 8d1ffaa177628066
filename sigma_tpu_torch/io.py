"""Persistence: graph and matrix files (text, Matrix Market, npz) and
solver checkpoints.

Port of :mod:`sigma_tpu.io`.  The file layouts are the JAX package's, so
either package reads what the other writes:

* text: a graph as "n m ne" and 0-based edges, a matrix as "nrow ncol
  nnz" and 0-based (i, j, v) triples (the reference's
  ``write_graph_to_file`` and ``sparse_matrix_to_file``);
* Matrix Market coordinate files (1-based; read: general, symmetric,
  skew-symmetric, hermitian and pattern);
* npz: a matrix's COO triples with its format and value dtype tags (a
  bfloat16 matrix stores its values widened to float32, exactly, and
  loads back as bfloat16), and checkpoints of a solver's iterate with
  its iteration count, residual and any extra arrays.

Readers build on ``device`` (None: CUDA); ``dtype=None`` means the tag's
dtype for npz and the port's default dtype (float32) for the text
formats, as ``from_coo`` has it.
"""

from __future__ import annotations

import json
from typing import Optional, Union

import numpy as np
import torch

from sigma_tpu_torch.graph.factory import choose_graph_type
from sigma_tpu_torch.matrix.factory import MATRIX_FORMATS, choose_matrix_type
from sigma_tpu_torch.utils.device import resolve_device
from sigma_tpu_torch.utils.dtypes import to_numpy

__all__ = [
    "from_scipy",
    "load_checkpoint",
    "load_matrix_npz",
    "read_graph",
    "read_matrix",
    "read_matrix_market",
    "save_checkpoint",
    "save_matrix_npz",
    "to_scipy",
    "write_graph",
    "write_matrix",
    "write_matrix_market",
]


def _write_triples(f, rows, cols, vals) -> None:
    np.savetxt(f, np.column_stack([rows, cols, np.asarray(vals, np.float64)]),
               fmt="%d %d %.17g")


def _host(x) -> np.ndarray:
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def write_graph(g, path) -> None:
    """Text "n m ne" header and the 0-based edge list."""
    rows, cols = g.edges_numpy()
    with open(path, "w") as f:
        f.write(f"{g.shape[0]} {g.shape[1]} {rows.size}\n")
        np.savetxt(f, np.column_stack([rows, cols]), fmt="%d %d")


def read_graph(path, frmt: Union[str, int] = "csr", **kw):
    """A :func:`write_graph` file as a graph of format ``frmt`` (``kw`` go
    to its ``from_coo``: ``device`` and ``block_shape`` for ``"bsr"``)."""
    with open(path) as f:
        n, m, ne = map(int, f.readline().split())
        data = np.loadtxt(f, dtype=np.int64, ndmin=2) if ne else np.empty((0, 2), np.int64)
    if data.shape[0] != ne:
        raise ValueError(f"expected {ne} edges, read {data.shape[0]}")
    return choose_graph_type(frmt).from_coo(n, m, data[:, 0], data[:, 1], **kw)


def write_matrix(A, path) -> None:
    """Text "nrow ncol nnz" header and 0-based (i, j, v) triples."""
    rows, cols, vals = A.entries()
    with open(path, "w") as f:
        f.write(f"{A.shape[0]} {A.shape[1]} {rows.size}\n")
        _write_triples(f, rows, cols, vals)


def read_matrix(A_or_path, frmt: Union[str, int] = "csr", dtype=None, device=None):
    """A :func:`write_matrix` file (the path ``A_or_path``, the JAX
    package's parameter name) as a matrix of format ``frmt``."""
    with open(A_or_path) as f:
        n, m, ne = map(int, f.readline().split())
        data = np.loadtxt(f, ndmin=2) if ne else np.empty((0, 3))
    if data.shape[0] != ne:
        raise ValueError(f"expected {ne} entries, read {data.shape[0]}")
    return choose_matrix_type(frmt).from_coo(
        n, m, data[:, 0].astype(np.int64), data[:, 1].astype(np.int64), data[:, 2],
        dtype=dtype, device=device,
    )


def write_matrix_market(A, path, comment: str = "") -> None:
    """Matrix Market coordinate file, real general, 1-based."""
    rows, cols, vals = A.entries()
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            f.write(f"% {comment}\n")
        f.write(f"{A.shape[0]} {A.shape[1]} {rows.size}\n")
        _write_triples(f, rows + 1, cols + 1, vals)


def read_matrix_market(path, frmt: Union[str, int] = "csr", dtype=None, device=None):
    """A Matrix Market coordinate file (general, symmetric, skew-symmetric,
    hermitian or pattern) as a matrix of format ``frmt``; a symmetric
    file's off-diagonal entries are mirrored (negated when skew)."""
    cls = choose_matrix_type(frmt)
    with open(path) as f:
        header = f.readline().strip().lower()
        if not header.startswith("%%matrixmarket"):
            raise ValueError(f"not a MatrixMarket file: {header!r}")
        if "coordinate" not in header:
            raise ValueError("only coordinate (sparse) MatrixMarket supported")
        skew = "skew-symmetric" in header
        symmetric = ("symmetric" in header and not skew) or "hermitian" in header
        pattern = "pattern" in header
        line = f.readline()
        while line.lstrip().startswith("%"):
            line = f.readline()
        n, m, ne = map(int, line.split())
        data = np.loadtxt(f, ndmin=2) if ne else np.empty((0, 3))
    if data.shape[0] != ne:
        raise ValueError(f"expected {ne} entries, read {data.shape[0]}")
    rows = data[:, 0].astype(np.int64) - 1
    cols = data[:, 1].astype(np.int64) - 1
    vals = np.ones(ne) if pattern or data.shape[1] < 3 else data[:, 2]
    if symmetric or skew:
        off = rows != cols
        mirrored = -vals[off] if skew else vals[off]
        rows, cols = np.concatenate([rows, cols[off]]), np.concatenate([cols, rows[off]])
        vals = np.concatenate([vals, mirrored])
    return cls.from_coo(n, m, rows, cols, vals, dtype=dtype, device=device)


def save_matrix_npz(A, path) -> None:
    """The matrix's COO triples with its format and value dtype tags
    (compressed npz).  Values other than float32 and float64 are stored
    widened: bfloat16 to float32, others to float64, both exact."""
    rows, cols, vals = A.entries()
    tag = str(A.dtype).removeprefix("torch.")
    if vals.dtype not in (np.float32, np.float64):
        vals = vals.astype(np.float32 if tag == "bfloat16" else np.float64)
    np.savez_compressed(
        path, format=np.array(A.format), nrow=np.array(A.shape[0]), ncol=np.array(A.shape[1]),
        rows=rows, cols=cols, vals=vals, vals_dtype=np.array(tag),
    )


def load_matrix_npz(path, frmt: Optional[str] = None, dtype=None, device=None):
    """A :func:`save_matrix_npz` file as a matrix on ``device``, in its
    saved format and dtype unless ``frmt`` or ``dtype`` override them (a
    file without the dtype tag loads at its values' storage dtype)."""
    with np.load(path, allow_pickle=False) as z:
        cls = MATRIX_FORMATS[frmt or str(z["format"])]
        if dtype is None:
            dtype = getattr(torch, str(z["vals_dtype"])) if "vals_dtype" in z else z["vals"].dtype
        return cls.from_coo(int(z["nrow"]), int(z["ncol"]), z["rows"], z["cols"], z["vals"],
                            dtype=dtype, device=device)


def save_checkpoint(path, x, *, iteration: int = 0, residual: float = 0.0, **extra) -> None:
    """A solver-state checkpoint: the iterate, its iteration count and
    residual, and any extra arrays (tensors are copied to the host)."""
    meta = {"iteration": int(iteration), "residual": float(residual)}
    np.savez_compressed(path, x=_host(x), meta=np.array(json.dumps(meta)),
                        **{k: _host(v) for k, v in extra.items()})


def load_checkpoint(path, device=None):
    """``(x, meta, extras)`` of a :func:`save_checkpoint` file: x a tensor
    on ``device`` (None: CUDA), the metadata dict and the extra arrays as
    numpy."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        extras = {k: z[k] for k in z.files if k not in ("x", "meta")}
        x = torch.from_numpy(z["x"]).to(resolve_device(device))
    return x, meta, extras


def from_scipy(A_scipy, frmt: Union[str, int] = None, dtype=None, device=None):
    """A scipy.sparse matrix as a matrix of format ``frmt`` (inferred when
    None: csr, csc and coo map to their namesakes, anything else to
    csr)."""
    if frmt is None:
        name = getattr(A_scipy, "format", "csr")
        frmt = name if name in MATRIX_FORMATS else "csr"
    coo = A_scipy.tocoo()
    return choose_matrix_type(frmt).from_coo(coo.shape[0], coo.shape[1], coo.row, coo.col,
                                             coo.data, dtype=dtype, device=device)


def to_scipy(A):
    """The matrix as a ``scipy.sparse.csr_matrix`` (host)."""
    import scipy.sparse

    rows, cols, vals = A.entries()
    return scipy.sparse.csr_matrix((vals, (rows, cols)), shape=A.shape)
