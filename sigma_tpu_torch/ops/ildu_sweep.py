"""The level-scheduled triangular sweep of ILDU / ILU(k): the kernel
wrapper, its plain PyTorch version, its launch count.

Replaces no Pallas kernel: it is the device form of the JAX package's
``lax.fori_loop`` over dependency levels in ``TriangularLevels.solve``
(``sigma_tpu/solvers/ildu.py``) and of the same loop inside ``shard_map``
in ``sigma_tpu/parallel/precond.py`` (the block ILDU's sweep), which XLA
runs on the device inside the compiled Krylov loop.  The plain version is
a Python loop of about five launches a level; the 7-point stencil at
nx = 100 has 298 levels a sweep in natural order, so one ILDU(0) apply was
~3,000 launches, the device idle most of it.

The CUDA kernel lives in ``sigma_tpu_torch/csrc/ildu_sweep.cu``: one
cooperative launch a sweep, a persistent grid of co-resident blocks that
walks the levels with a grid-wide barrier between two, x's gathers
bypassing L1.  What bounds it: the bytes (rows, the real entries' cols
and vals, b, x read once and written once), and in practice the chain of
``nlev - 1`` grid barriers on a deep sweep; the design pays one launch a
sweep and sizes the grid to the widest level, so a barrier joins no idle
block (``chip_smoke.py``'s ``level_sweep_checks`` times it against the
co-resident grid).

A CPU ``b`` goes to :func:`level_sweep_reference`, a CUDA one to the
kernel, and anything the kernel does not take raises.  The kernel adds a
row's terms in slot order with correctly rounded operations and skips the
unused slots; the plain version's row sum may add in another order, so
the two agree to rounding (two launches give the same bits).
"""

from __future__ import annotations

import torch

from sigma_tpu_torch.ops import _build

__all__ = ["level_sweep", "level_sweep_reference"]

# (values, vector) dtype pairs the kernel takes -> its dtype codes
_DTYPES = {
    (torch.float32, torch.float32): (0, 0),
    (torch.float64, torch.float64): (1, 1),
    (torch.float32, torch.float64): (0, 1),
}


def level_sweep_reference(rows, cols, vals, level_ptr, b):
    """The plain version of :func:`level_sweep`: one gather, multiply, row
    sum and indexed write a level, with torch ops on any device."""
    x = torch.zeros_like(b)
    bl = b[rows]  # b in level order
    bounds = level_ptr.tolist()
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        acc = (vals[lo:hi] * x[cols[lo:hi]]).sum(-1)
        x[rows[lo:hi]] = (bl[lo:hi] - acc).to(x.dtype)
    return x


def _check(rows, cols, vals, level_ptr, b):
    n = b.shape[0] if b.ndim == 1 else -1
    if not (b.ndim == rows.ndim == level_ptr.ndim == 1 and cols.ndim == vals.ndim == 2
            and rows.shape[0] == n and cols.shape == vals.shape and cols.shape[0] == n):
        raise ValueError(
            f"want rows (n,), cols and vals (n, width), level_ptr (nlev + 1,), b (n,); got "
            f"{tuple(rows.shape)}, {tuple(cols.shape)}, {tuple(vals.shape)}, "
            f"{tuple(level_ptr.shape)}, {tuple(b.shape)}"
        )
    if not (rows.dtype == cols.dtype == level_ptr.dtype == torch.int64):
        raise TypeError(f"rows, cols and level_ptr must be int64, got {rows.dtype}, "
                        f"{cols.dtype}, {level_ptr.dtype}")
    if not (rows.device == cols.device == vals.device == level_ptr.device == b.device):
        raise ValueError(f"operands on different devices: rows {rows.device}, cols "
                         f"{cols.device}, vals {vals.device}, level_ptr {level_ptr.device}, "
                         f"b {b.device}")


def level_sweep(rows, cols, vals, level_ptr, b, max_rows: int):
    """x solving (I + T) x = b for the strict triangular T packed by level:
    ``rows[level_ptr[l] : level_ptr[l + 1]]`` are level l's rows and
    ``cols`` / ``vals`` (n, width) their entries, a row's unused slots
    pointing at the row itself with value 0; ``level_ptr`` is an int64
    tensor on b's device.  ``max_rows``, the rows of the widest level (a
    host int, so that the launch reads nothing back), sizes the kernel's
    grid: at most the co-resident maximum, reached from ``max_rows = n``.
    x is in b's dtype."""
    _check(rows, cols, vals, level_ptr, b)
    if b.device.type == "cpu":
        return level_sweep_reference(rows, cols, vals, level_ptr, b)
    if b.device.type != "cuda":
        raise ValueError(f"no level sweep kernel for device {b.device}")
    codes = _DTYPES.get((vals.dtype, b.dtype))
    if codes is None:
        raise TypeError(f"no level sweep kernel for values {vals.dtype} with vector {b.dtype}")
    for name, t in (("rows", rows), ("cols", cols), ("vals", vals), ("level_ptr", level_ptr),
                    ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = b.shape[0]
    x = torch.empty_like(b)
    if n == 0:
        return x
    dev = b.get_device()
    rc = _build.library().sigma_level_sweep(
        dev, *codes, rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), level_ptr.data_ptr(),
        b.data_ptr(), x.data_ptr(), level_ptr.shape[0] - 1, cols.shape[1],
        max_rows, torch._C._cuda_getCurrentRawStream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"sigma_level_sweep failed with CUDA error {rc}: "
                           f"{_build.library().sigma_error_string(rc).decode()}")
    level_sweep.launches += 1
    return x


level_sweep.launches = 0

