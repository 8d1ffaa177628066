"""DIA SpMV: kernel wrappers, their plain PyTorch versions, launch counts.

Ports of the two Pallas TPU kernels on the stencil main path
(``sigma_tpu/ops/spmv_pallas.py``):

* :func:`dia_spmv` <- ``dia_spmv_pallas_blocked``: y = A x from
  full-storage DIA values, rectangular n x m;
* :func:`dia_sym_spmv` <- ``dia_sym_spmv_pallas_blocked``: y = A x from the
  upper diagonals of a symmetric matrix.

The CUDA kernels live in ``sigma_tpu_torch/csrc/dia_spmv.cu`` (design and
traffic notes there).  Values are stored ``(D, stride)`` contiguous; the
TPU's ``(D, S, 128)`` tiles, VMEM tile picks and ``chunk_plan`` slabs are
gone because the GPU kernel loops over a runtime offset array, so any
band width runs in one launch.

Routing is by the device of the tensors, and nothing else: a CPU tensor
goes to the plain version (``*_reference``), a CUDA tensor to the kernel,
and anything the kernel does not take raises.  There is no size
threshold and no fallback.  Each wrapper counts its kernel launches in
its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from sigma_tpu_torch.ops import _build

__all__ = [
    "KERNEL_DTYPES",
    "dia_spmv",
    "dia_spmv_reference",
    "dia_sym_spmv",
    "dia_sym_spmv_reference",
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


def _launch(entry, data, x, offsets, n, *extra):
    """Launch one kernel on the current stream; returns y (n,) in x's
    dtype.  Raises on anything the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"no DIA kernel for device {x.device}")
    if (data.dtype, x.dtype) not in KERNEL_DTYPES:
        raise TypeError(
            f"no DIA kernel for values {data.dtype} with vector {x.dtype}"
        )
    for name, t in (("data", data), ("x", x), ("offsets", offsets)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(_build.library(), entry)(
        x.device.index, _CODES[data.dtype], _CODES[x.dtype],
        data.data_ptr(), x.data_ptr(), offsets.data_ptr(), y.data_ptr(),
        data.shape[0], data.shape[1], n, *extra, stream,
    )
    if rc != 0:
        raise RuntimeError(f"{entry} failed with CUDA error {rc}")
    return y


def dia_spmv(data, x, offsets, n, m):
    """y = A x for the n x m DIA matrix ``data[d, i] = A[i, i + offsets[d]]``.

    ``data`` is (D, stride >= n), ``x`` is (m,), ``offsets`` an int64
    tensor of D offsets on the same device; y is (n,) in x's dtype."""
    _check(data, x, offsets, n, m)
    if x.device.type == "cpu":
        return dia_spmv_reference(data, x, offsets, n, m)
    if n == 0:
        return torch.empty(0, dtype=x.dtype, device=x.device)
    y = _launch("sigma_dia_spmv", data, x, offsets, n, m)
    dia_spmv.launches += 1
    return y


dia_spmv.launches = 0


def dia_sym_spmv(data, x, offsets, n):
    """y = A x for the symmetric n x n matrix whose upper diagonals are
    ``data[d, i] = A[i, i + offsets[d]] = A[i + offsets[d], i]`` (offsets
    >= 0, validated by :class:`SymmetricDIAMatrix`)."""
    _check(data, x, offsets, n, n)
    if x.device.type == "cpu":
        return dia_sym_spmv_reference(data, x, offsets, n)
    if n == 0:
        return torch.empty(0, dtype=x.dtype, device=x.device)
    y = _launch("sigma_dia_sym_spmv", data, x, offsets, n)
    dia_sym_spmv.launches += 1
    return y


dia_sym_spmv.launches = 0
