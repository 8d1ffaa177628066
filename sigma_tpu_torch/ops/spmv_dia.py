"""DIA SpMV: kernel wrappers, their plain PyTorch versions, launch counts.

Ports of four Pallas TPU kernels (``sigma_tpu/ops/spmv_pallas.py``):

* :func:`dia_spmv` <- ``dia_spmv_pallas_blocked``: y = A x from
  full-storage DIA values, rectangular n x m;
* :func:`dia_sym_spmv` <- ``dia_sym_spmv_pallas_blocked``: y = A x from the
  upper diagonals of a symmetric matrix;
* :func:`dia_spmv_resident` <- the VMEM-resident body of
  ``dia_spmv_pallas``: the same y = A x for an x that fits one block's
  shared memory, each block staging the columns its row tile reads;
* :func:`dia_spmv_window` <- the manual-DMA body of ``dia_spmv_pallas``:
  the same with each row tile's x window copied into shared memory by
  asynchronous copies.

:func:`dia_spmv_staged` is the counterpart of the public
``dia_spmv_pallas`` entry and routes between the last two and
:func:`dia_spmv` as it does.  ``DIAMatrix`` keeps calling :func:`dia_spmv`,
as the JAX ``DIAMatrix`` never calls ``dia_spmv_pallas``.

The CUDA kernels live in ``sigma_tpu_torch/csrc/dia_spmv.cu`` (design and
traffic notes there).  Values are stored ``(D, stride)`` contiguous; the
TPU's ``(D, S, 128)`` tiles, VMEM tile picks and ``chunk_plan`` slabs are
gone because the GPU kernel loops over a runtime offset array, so any
band width runs in one launch.

Routing is by the device of the tensors, and nothing else: a CPU tensor
goes to the plain version (``*_reference``), a CUDA tensor to the kernel,
and anything the kernel does not take raises.  There is no size
threshold and no fallback.  Each wrapper counts its kernel launches in
its ``launches`` attribute, in Python where it launches; a replayed CUDA
graph runs no Python, so a graphed solve adds its replays' launches
(:func:`sigma_tpu_torch.ops.add_launch_counts`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sigma_tpu_torch.ops import _build

__all__ = [
    "KERNEL_DTYPES",
    "STAGED_SMEM_BYTES",
    "dia_spmv",
    "dia_spmv_operator",
    "dia_spmv_reference",
    "dia_spmv_resident",
    "dia_spmv_staged",
    "dia_spmv_window",
    "dia_sym_spmv",
    "dia_sym_spmv_operator",
    "dia_sym_spmv_reference",
    "staged_route",
    "window_plan",
]

_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
# (value dtype, vector dtype) pairs the kernels are instantiated for
KERNEL_DTYPES = frozenset(
    {
        (torch.float32, torch.float32),
        (torch.bfloat16, torch.float32),
        (torch.float64, torch.float64),
        (torch.float32, torch.float64),
        (torch.bfloat16, torch.float64),
    }
)


def dia_spmv_reference(data, x, offsets, n, m):
    """Plain PyTorch version of :func:`dia_spmv`: one sliced
    multiply-add per diagonal, in x's dtype."""
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    for d, o in enumerate(offsets.tolist()):
        lo, hi = max(0, -o), min(n, m - o)
        if hi > lo:
            y[lo:hi] += data[d, lo:hi].to(x.dtype) * x[lo + o : hi + o]
    return y


def dia_sym_spmv_reference(data, x, offsets, n):
    """Plain PyTorch version of :func:`dia_sym_spmv`: per stored diagonal
    the upper term ``data_o[i] * x[i+o]`` and, for o > 0, the mirror term
    ``data_o[i-o] * x[i-o]``, in x's dtype."""
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    for d, o in enumerate(offsets.tolist()):
        if o < 0:
            raise ValueError(f"symmetric DIA takes offsets >= 0, got {o}")
        if o >= n:
            continue
        row = data[d, : n - o].to(x.dtype)
        y[: n - o] += row * x[o:]
        if o > 0:
            y[o:] += row * x[: n - o]
    return y


def _check(data, x, offsets, n, m):
    if data.ndim != 2 or x.ndim != 1 or offsets.ndim != 1:
        raise ValueError(
            f"want data (D, stride), x (m,), offsets (D,); got "
            f"{tuple(data.shape)}, {tuple(x.shape)}, {tuple(offsets.shape)}"
        )
    if offsets.dtype != torch.int64:
        raise TypeError(f"offsets must be int64, got {offsets.dtype}")
    if data.shape[0] != offsets.shape[0]:
        raise ValueError(
            f"{data.shape[0]} value rows for {offsets.shape[0]} offsets"
        )
    if x.shape[0] != m:
        raise ValueError(f"x has {x.shape[0]} entries, want {m}")
    if data.shape[1] < n:
        raise ValueError(f"value stride {data.shape[1]} is shorter than the {n} rows")
    if not (data.device == x.device == offsets.device):
        raise ValueError(
            f"operands on different devices: data {data.device}, "
            f"x {x.device}, offsets {offsets.device}"
        )


def _check_kernel_operands(data, x, offsets):
    """Raise unless the kernel takes these operands: a CUDA device, a dtype
    pair of KERNEL_DTYPES, contiguous tensors."""
    if x.device.type != "cuda":
        raise ValueError(f"no DIA kernel for device {x.device}")
    if (data.dtype, x.dtype) not in KERNEL_DTYPES:
        raise TypeError(
            f"no DIA kernel for values {data.dtype} with vector {x.dtype}"
        )
    for name, t in (("data", data), ("x", x), ("offsets", offsets)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(entry, data, x, offsets, y_shape, n, *extra):
    """Launch one kernel on the current stream; returns y of ``y_shape``
    in x's dtype.  Raises on anything the kernel does not take."""
    _check_kernel_operands(data, x, offsets)
    return _launch_checked(entry, data, x, offsets, y_shape, n, *extra)


def _launch_checked(entry, data, x, offsets, y_shape, n, *extra):
    """:func:`_launch` on operands already checked."""
    y = x.new_empty(y_shape)
    dev = x.get_device()
    rc = getattr(_build.library(), entry)(
        dev, _CODES[data.dtype], _CODES[x.dtype],
        data.data_ptr(), x.data_ptr(), offsets.data_ptr(), y.data_ptr(),
        data.shape[0], data.shape[1], n, *extra,
        # the current stream's handle without building a Stream object
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"{entry} failed with CUDA error {rc}")
    return y


def dia_spmv(data, x, offsets, n, m):
    """y = A x for the n x m DIA matrix ``data[d, i] = A[i, i + offsets[d]]``.

    ``data`` is (D, stride >= n), ``x`` is (m,), ``offsets`` an int64
    tensor of D offsets on the same device; y is (n,) in x's dtype.
    Checks every operand on every call (:meth:`DIAMatrix.matvec` checks
    its fixed arrays once, at construction, and calls
    :func:`dia_spmv_operator`)."""
    _check(data, x, offsets, n, m)
    if x.device.type == "cpu":
        return dia_spmv_reference(data, x, offsets, n, m)
    return _spmv_launch(data, x, offsets, n, m, checked=False)


dia_spmv.launches = 0


def _spmv_launch(data, x, offsets, n, m, checked):
    if n == 0:
        return torch.empty(0, dtype=x.dtype, device=x.device)
    y = (_launch_checked if checked else _launch)("sigma_dia_spmv", data, x, offsets, (n,), n, m)
    dia_spmv.launches += 1
    return y


def dia_spmv_operator(data, x, offsets, n, m, kernel_ready):
    """:func:`dia_spmv` for an operator whose ``data`` and ``offsets`` were
    checked once (shapes, devices, offsets int64; ``kernel_ready``: both
    contiguous on a CUDA device): checks x alone, then runs the plain
    version for a CPU x or launches the kernel, counted in
    ``dia_spmv.launches``."""
    if _check_x(data, x, m):
        return dia_spmv_reference(data, x, offsets, n, m)
    checked = kernel_ready and (data.dtype, x.dtype) in KERNEL_DTYPES and x.is_contiguous()
    return _spmv_launch(data, x, offsets, n, m, checked)


def _check_x(data, x, m):
    """Raise unless x is (m,) on data's device; True for a CPU x."""
    if x.ndim != 1 or x.shape[0] != m:
        raise ValueError(f"x has shape {tuple(x.shape)}, want ({m},)")
    if x.device != data.device:
        raise ValueError(f"operands on different devices: data {data.device}, x {x.device}")
    return x.device.type == "cpu"


def dia_sym_spmv(data, x, offsets, n):
    """y = A x for the symmetric n x n matrix whose upper diagonals are
    ``data[d, i] = A[i, i + offsets[d]] = A[i + offsets[d], i]`` (offsets
    >= 0, validated by :class:`SymmetricDIAMatrix`).  Checks every operand
    on every call (:meth:`SymmetricDIAMatrix.matvec` checks its fixed
    arrays once, at construction, and calls
    :func:`dia_sym_spmv_operator`)."""
    _check(data, x, offsets, n, n)
    if x.device.type == "cpu":
        return dia_sym_spmv_reference(data, x, offsets, n)
    return _sym_launch(data, x, offsets, n, checked=False)


dia_sym_spmv.launches = 0


def _sym_launch(data, x, offsets, n, checked):
    if n == 0:
        return torch.empty(0, dtype=x.dtype, device=x.device)
    y = (_launch_checked if checked else _launch)("sigma_dia_sym_spmv", data, x, offsets, (n,), n)
    dia_sym_spmv.launches += 1
    return y


def dia_sym_spmv_operator(data, x, offsets, n, kernel_ready):
    """:func:`dia_sym_spmv` for an operator whose ``data`` and ``offsets``
    were checked once (as :func:`dia_spmv_operator`'s): checks x alone,
    then runs the plain version for a CPU x or launches the kernel, counted
    in ``dia_sym_spmv.launches``."""
    if _check_x(data, x, n):
        return dia_sym_spmv_reference(data, x, offsets, n)
    checked = kernel_ready and (data.dtype, x.dtype) in KERNEL_DTYPES and x.is_contiguous()
    return _sym_launch(data, x, offsets, n, checked)


# -- staged-x SpMV: kernels #5 and #6 -------------------------------------
# The shared memory one block may hold on an H100: 232,448 bytes with the
# opt-in above 48 KB (sharedMemPerBlockOptin), less 2,048 bytes beside x
# (the resident kernel's offsets and value-row bases, and its window's
# alignment slack; the windowed kernel's offsets, row bases and window
# places take 1,536).  So the resident route takes x of up to 57,600 f32 or
# 28,800 f64 values; the windowed kernel a union window of as many, its
# alignment padding counted.
STAGED_SMEM_BYTES = 232_448 - 2_048


def staged_route(m, itemsize, allow_dma_path=False) -> str:
    """The route :func:`dia_spmv_staged` takes for x of ``m`` values of
    ``itemsize`` bytes: ``"resident"`` when x fits one block's shared
    memory (``m * itemsize <= STAGED_SMEM_BYTES``), else ``"window"`` with
    ``allow_dma_path`` and ``"blocked"`` (:func:`dia_spmv`) without, as
    ``dia_spmv_pallas`` sends an x too large for VMEM to its blocked
    kernel.  The JAX gate counts x padded by the band's span; the resident
    kernel stages x itself and bounds-checks each column as every DIA
    kernel does, so the padding is not staged."""
    if m * itemsize <= STAGED_SMEM_BYTES:
        return "resident"
    return "window" if allow_dma_path else "blocked"


def window_plan(offsets, tile_rows, align=1):
    """The shared-memory layout of one row tile's x window for the
    windowed kernel: ``(starts, bases, pos)`` as int64 numpy arrays.  Row
    t of a tile starting at row i0 reads diagonal d's x value
    ``x[i0 + t + offsets[d]]``, so each diagonal needs the window
    ``[i0 + o, i0 + o + tile_rows)``; the union of these windows is staged
    as disjoint pieces, piece p covering columns ``i0 + starts[p]`` on
    from shared-memory index ``bases[p]`` (``bases[-1]`` is the total
    length).  ``pos[d]`` is where diagonal d's window begins.  A 7-point
    stencil at nx=216 gives 3 pieces for 256-row tiles (the JAX kernel's one
    window of tile + span would be 93,568 values, past a block's shared
    memory), a band of offsets -122..122 one piece of tile_rows + 244.

    ``align`` (the kernel's: 16 bytes over x's item size) widens each
    window to whole multiples of ``align`` columns, so every start and
    base is a multiple of it and, for i0 a multiple of it, column c lies
    at an index congruent to c modulo ``align``: the kernel copies and
    reads x in aligned 16-byte pieces.  ``align=1`` is the plain union."""
    offs = np.asarray(offsets, dtype=np.int64)
    order = np.argsort(offs, kind="stable")
    starts, ends, piece_of = [], [], np.empty(offs.size, dtype=np.int64)
    for d in order:
        o = int(offs[d])
        lo, hi = o - o % align, o + tile_rows + (-(o + tile_rows)) % align
        if starts and lo <= ends[-1]:
            ends[-1] = max(ends[-1], hi)
        else:
            starts.append(lo)
            ends.append(hi)
        piece_of[d] = len(starts) - 1
    starts = np.asarray(starts, dtype=np.int64)
    bases = np.concatenate([[0], np.cumsum(np.asarray(ends, np.int64) - starts)]).astype(np.int64)
    pos = bases[piece_of] + offs - starts[piece_of]
    return starts, bases, pos


@functools.lru_cache(maxsize=64)
def _staged_operands(offsets, tile_rows, align, device):
    """(offsets tensor, window plan tensor ``[starts, bases, pos]``, number
    of pieces, window length) on ``device``, made once per offset tuple,
    tile and alignment (:func:`window_plan`)."""
    starts, bases, pos = window_plan(offsets, tile_rows, align)
    offs = torch.tensor(offsets, dtype=torch.int64, device=device)
    plan = torch.from_numpy(np.concatenate([starts, bases, pos])).to(device)
    return offs, plan, int(starts.size), int(bases[-1])


@functools.lru_cache(maxsize=64)
def _resident_operands(offsets, device):
    """(offsets tensor on ``device``, least offset, greatest offset), made
    once per offset tuple: the resident kernel's window bounds."""
    offs = torch.tensor(offsets, dtype=torch.int64, device=device)
    return offs, min(offsets, default=0), max(offsets, default=0)


def _offset_tuple(offsets):
    if type(offsets) is tuple:
        return offsets
    if isinstance(offsets, torch.Tensor):
        return tuple(offsets.tolist())
    return tuple(int(o) for o in offsets)


def dia_spmv_resident(data, x, offsets, n, m):
    """y = A x as :func:`dia_spmv` computes it, by the kernel for an x that
    fits one block's shared memory: each block stages the columns its row
    tile reads (at most m values) and computes from there.  ``offsets`` is
    a sequence of ints (or an int64 tensor, read back once).  Raises
    ValueError when x does not fit (``m * itemsize > STAGED_SMEM_BYTES``),
    as the JAX package routes such an x away from its resident body."""
    dev = x.device
    offs, lo, hi = _resident_operands(_offset_tuple(offsets), dev)
    _check(data, x, offs, n, m)
    if m * x.element_size() > STAGED_SMEM_BYTES:
        raise ValueError(
            f"x of {m} {x.dtype} values ({m * x.element_size()} bytes) does not fit "
            f"one block's shared memory ({STAGED_SMEM_BYTES} bytes)"
        )
    if dev.type == "cpu":
        return dia_spmv_reference(data, x, offs, n, m)
    if n == 0:
        return torch.empty(0, dtype=x.dtype, device=x.device)
    y = _launch("sigma_dia_spmv_resident", data, x, offs, (n,), n, m, lo, hi)
    dia_spmv_resident.launches += 1
    return y


dia_spmv_resident.launches = 0


def dia_spmv_window(data, x, offsets, n, m, tile_rows=256):
    """y = A x as :func:`dia_spmv` computes it, by the kernel that copies
    each ``tile_rows``-row tile's x window (:func:`window_plan`) into
    shared memory with asynchronous copies and computes from there.
    ``tile_rows`` is the block's row count (the JAX kernel counted its
    tile in 128-lane rows), a multiple of 32 up to 1024.  Raises
    ValueError when the window, its pieces aligned to 16 bytes, does not
    fit one block's shared memory."""
    if tile_rows % 32 or not 32 <= tile_rows <= 1024:
        raise ValueError(f"tile_rows must be a multiple of 32 in [32, 1024], got {tile_rows}")
    offs, plan, pieces, length = _staged_operands(_offset_tuple(offsets), tile_rows,
                                                  16 // x.element_size(), x.device)
    _check(data, x, offs, n, m)
    if length * x.element_size() > STAGED_SMEM_BYTES:
        raise ValueError(
            f"the x window of a {tile_rows}-row tile ({length} values in {pieces} pieces) "
            f"does not fit one block's shared memory ({STAGED_SMEM_BYTES} bytes)"
        )
    if x.device.type == "cpu":
        return dia_spmv_reference(data, x, offs, n, m)
    if n == 0:
        return torch.empty(0, dtype=x.dtype, device=x.device)
    y = _launch("sigma_dia_spmv_window", data, x, offs, (n,), n, m,
                plan.data_ptr(), pieces, tile_rows, length)
    dia_spmv_window.launches += 1
    return y


dia_spmv_window.launches = 0


def dia_spmv_staged(data, x, offsets, n, m, tile_rows=256, allow_dma_path=False):
    """y = A x for the n x m DIA matrix ``data[d, i] = A[i, i + offsets[d]]``
    through the staged-x kernels, routed as the JAX package's
    ``dia_spmv_pallas`` routes (:func:`staged_route`): the resident kernel
    when x fits shared memory, else the windowed kernel with
    ``allow_dma_path`` and :func:`dia_spmv` without.  ``offsets`` is a
    sequence of ints, as the JAX entry's static offsets (an int64 tensor is
    read back once)."""
    route = staged_route(m, x.element_size(), allow_dma_path)
    if route == "resident":
        return dia_spmv_resident(data, x, offsets, n, m)
    if route == "window":
        return dia_spmv_window(data, x, offsets, n, m, tile_rows)
    offs = _resident_operands(_offset_tuple(offsets), x.device)[0]
    return dia_spmv(data, x, offs, n, m)
