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
cooperative launch a sweep, a persistent grid that walks the packed slots
in order with no barrier between levels.  Each row waits on its own
dependencies' ready flags, with its indices, values and b already loaded;
a flag, once set, is the complement of its row's x bits, so the poll that
sees it set brings the value.  The wrapper allocates the flags, zeros of
x's width beside x, on each call (one memset), so the sweep keeps no
state and replays from a CUDA graph.  What bounds it: the bytes (rows,
the real entries' cols and vals, b, x read once and written once), and
in practice the chain of dependent levels on a deep sweep, a store and a
poll through L2 each; the grid is sized from the widest level
(``chip_smoke.py``'s ``level_sweep_checks`` times it against the
co-resident grid).

A CPU ``b`` goes to :func:`level_sweep_reference`, a CUDA one to the
kernel, and anything the kernel does not take raises.  The kernel adds a
row's terms in slot order with correctly rounded operations and skips the
unused slots; the plain version's row sum may add in another order, so
the two agree to rounding (two launches give the same bits), and
:func:`level_sweep_slot_order` repeats the kernel's own order in torch
ops, for checks that want its bits.
"""

from __future__ import annotations

import torch

from sigma_tpu_torch.ops import _build

__all__ = [
    "level_sweep", "level_sweep_blocks", "level_sweep_reference", "level_sweep_slot_order",
]

# (values, vector) dtype pairs the kernel takes -> its dtype codes
_DTYPES = {
    (torch.float32, torch.float32): (0, 0),
    (torch.float64, torch.float64): (1, 1),
    (torch.float32, torch.float64): (0, 1),
}
# the ready flags' dtype: a word of x's width
_FLAG = {torch.float32: torch.int32, torch.float64: torch.int64}


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


def level_sweep_slot_order(rows, cols, vals, level_ptr, b):
    """:func:`level_sweep` in the kernel's own arithmetic, with torch ops
    on any device: a level at a time, a row's real slots added in slot
    order (a separate multiply and add each, in b's dtype; ``torch.where``
    skips the unused slots, which point at their own row), then
    subtracted from b.  On the card it gives the kernel's bits."""
    x = torch.zeros_like(b)
    bl = b[rows]  # b in level order
    bounds = level_ptr.tolist()
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        r, c = rows[lo:hi], cols[lo:hi]
        terms = vals[lo:hi].to(b.dtype) * x[c]
        real = c != r[:, None]
        acc = torch.zeros_like(bl[lo:hi])
        for j in range(c.shape[1]):
            acc = torch.where(real[:, j], acc + terms[:, j], acc)
        x[r] = bl[lo:hi] - acc
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
    grid (:func:`level_sweep_blocks`): at most the co-resident maximum,
    reached from ``max_rows = n``.  x is in b's dtype."""
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
    # row r's ready flag: 0, then the complement of x[r]'s bits
    flag = torch.zeros(n, dtype=_FLAG[b.dtype], device=b.device)
    dev = b.get_device()
    rc = _build.library().sigma_level_sweep(
        dev, *codes, rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), level_ptr.data_ptr(),
        b.data_ptr(), x.data_ptr(), flag.data_ptr(), level_ptr.shape[0] - 1, cols.shape[1],
        max_rows, torch._C._cuda_getCurrentRawStream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"sigma_level_sweep failed with CUDA error {rc}: "
                           f"{_build.library().sigma_error_string(rc).decode()}")
    level_sweep.launches += 1
    return x


level_sweep.launches = 0


def level_sweep_blocks(vdtype, xdtype, width: int, max_rows: int, device) -> int:
    """The blocks of 256 threads that :func:`level_sweep` launches on the
    CUDA ``device`` for values in ``vdtype``, a vector in ``xdtype``, rows
    of ``width`` slots and a widest level of ``max_rows`` rows."""
    import ctypes

    codes = _DTYPES.get((vdtype, xdtype))
    if codes is None:
        raise TypeError(f"no level sweep kernel for values {vdtype} with vector {xdtype}")
    blocks = ctypes.c_int64(0)
    rc = _build.library().sigma_level_sweep_blocks(torch.device(device).index or 0, *codes,
                                                   width, max_rows, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"sigma_level_sweep_blocks failed with CUDA error {rc}: "
                           f"{_build.library().sigma_error_string(rc).decode()}")
    return blocks.value

