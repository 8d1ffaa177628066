"""DIA SpMM: Y = A X for k panels; kernel wrappers, their plain PyTorch
versions, panel layouts and launch counts.

Ports of five Pallas TPU kernels (``sigma_tpu/ops/spmv_pallas.py``):

* :func:`dia_spmm` <- ``_dia_spmm_core`` (RHS-major panels, and the (m, k)
  entry ``dia_spmm_pallas_blocked``) and ``dia_spmm_interleaved``:
  Y = A X from full-storage DIA values, rectangular n x m;
* :func:`dia_sym_spmm` <- ``dia_sym_spmm_rhs_major`` and
  ``dia_sym_spmm_interleaved``: the same from the upper diagonals of a
  symmetric matrix;
* :func:`dia_spmm_grouped` <- ``dia_spmm_grouped`` and
  ``dia_spmm_grouped_chunked``: Y = A X for any k from full-storage DIA
  (``DIAMatrix`` takes it for k > 16 on wide bands), RHS-major or column
  panels.  The TPU kernel's grouped-interleaved panel layout
  (``interleave_panels_grouped``) existed to cut the panels into DMA
  chunks; the CUDA kernel reads the port's own layouts, so it is gone.

The CUDA kernels live in ``sigma_tpu_torch/csrc/dia_spmm.cu`` and
``dia_spmm_grouped.cu``; :func:`dia_spmm` and :func:`dia_spmm_grouped`
share the staged-window machinery of ``dia_window.cuh`` (the block's x
window in shared memory, the values through a cp.async ring, a register
tile of 4 rows x up to 8 columns a thread with x carried along the band).
Each stored value is read once for all k panels (once per 32-column group
in the grouped kernel).  The panels lie in one of
three layouts, and the kernel reads and writes each directly (the layout
is a panel-block length B passed to the kernel, not a separate code
path):

* ``"rhs_major"``: (k, m) for x, (k, n) for y (B = the vector's length);
* ``"interleaved"``: (k * ceil(m/128), 128) from :func:`interleave_panels`,
  row ``s * k + j`` holding elements ``128 s .. 128 s + 127`` of panel j,
  zero past the vector's end (B = 128);
* ``"cols"``: (m, k) for x, (n, k) for y, the layout
  ``DIAMatrix.matmat`` takes (B = 1).

Routing is as in :mod:`sigma_tpu_torch.ops.spmv_dia`: a CPU tensor goes to
the plain version (``*_reference``), a CUDA tensor to the kernel, and
anything the kernel does not take raises.  Each wrapper counts its kernel
launches in ``launches`` and, per layout, in ``launches_by_layout``.
"""

from __future__ import annotations

import torch

from sigma_tpu_torch.ops.spmv_dia import _CODES, _launch

__all__ = [
    "GROUPED_LAYOUTS",
    "LAYOUTS",
    "MAX_PANELS",
    "deinterleave_panels",
    "dia_spmm",
    "dia_spmm_grouped",
    "dia_spmm_grouped_reference",
    "dia_spmm_reference",
    "dia_sym_spmm",
    "dia_sym_spmm_reference",
    "interleave_panels",
]

LAYOUTS = ("rhs_major", "interleaved", "cols")
GROUPED_LAYOUTS = ("rhs_major", "cols")  # the layouts dia_spmm_grouped takes
MAX_PANELS = 16  # the most panels one launch takes (the TPU kernels' bound)
_LANES = 128  # panel-block length of the interleaved layout


def interleave_panels(XT, m=None):
    """(k, m) RHS-major panels -> interleaved (k * ceil(m/128), 128): row
    ``s * k + j`` holds elements ``128 s .. 128 s + 127`` of panel j, zero
    past the panel's end.  ``m`` (default: XT's width) may exceed XT's
    width, padding with zeros to ``ceil(m/128) * 128``."""
    k, m_in = XT.shape
    m = m_in if m is None else m
    if m < m_in:
        raise ValueError(f"m={m} smaller than the panel width {m_in}")
    sx = -(-m // _LANES)
    if sx * _LANES != m_in:
        XT = torch.cat([XT, XT.new_zeros((k, sx * _LANES - m_in))], dim=1)
    return XT.reshape(k, sx, _LANES).transpose(0, 1).reshape(k * sx, _LANES)


def deinterleave_panels(YI, k, n):
    """Inverse of :func:`interleave_panels`: (k * S, 128) -> (k, n)."""
    s = YI.shape[0] // k
    return (
        YI.reshape(s, k, _LANES).transpose(0, 1).reshape(k, s * _LANES)[:, :n].contiguous()
    )


def _block(layout, length):
    """Panel-block length B of ``layout`` for vectors of ``length``."""
    return {"rhs_major": length, "interleaved": _LANES, "cols": 1}[layout]


def _panels(X, layout, length):
    """Number of panels k that X holds in ``layout`` for vectors of
    ``length`` elements; raises on a shape the layout does not give."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown panel layout {layout!r}; want one of {LAYOUTS}")
    if X.ndim != 2:
        raise ValueError(f"panels must be 2-D, got shape {tuple(X.shape)}")
    if layout == "rhs_major":
        k, ok = X.shape[0], X.shape[1] == length
    elif layout == "cols":
        k, ok = X.shape[1], X.shape[0] == length
    else:
        s = -(-length // _LANES)
        ok = X.shape[1] == _LANES and s > 0 and X.shape[0] % s == 0
        k = X.shape[0] // max(s, 1)
    if not ok:
        raise ValueError(
            f"panels of shape {tuple(X.shape)} are not {layout} panels of "
            f"{length} elements"
        )
    return k


def _out_shape(layout, k, length):
    if layout == "rhs_major":
        return (k, length)
    if layout == "cols":
        return (length, k)
    return (k * -(-length // _LANES), _LANES)


def _to_rhs_major(X, layout, k, length):
    if layout == "cols":
        return X.T
    if layout == "interleaved":
        return deinterleave_panels(X, k, length)
    return X


def _from_rhs_major(YT, layout, length):
    if layout == "cols":
        return YT.T.contiguous()
    if layout == "interleaved":
        return interleave_panels(YT, length)
    return YT


def dia_spmm_reference(data, X, offsets, n, m, layout):
    """Plain PyTorch version of :func:`dia_spmm`: the panels to RHS-major,
    one sliced multiply-add per diagonal in X's dtype, and back to
    ``layout``."""
    k = _panels(X, layout, m)
    XT = _to_rhs_major(X, layout, k, m)
    YT = torch.zeros((k, n), dtype=X.dtype, device=X.device)
    for d, o in enumerate(offsets.tolist()):
        lo, hi = max(0, -o), min(n, m - o)
        if hi > lo:
            YT[:, lo:hi] += data[d, lo:hi].to(X.dtype) * XT[:, lo + o : hi + o]
    return _from_rhs_major(YT, layout, n)


def dia_sym_spmm_reference(data, X, offsets, n, layout):
    """Plain PyTorch version of :func:`dia_sym_spmm`: per stored diagonal
    the upper term ``data_o[i] * X[j, i+o]`` and, for o > 0, the mirror
    term ``data_o[i-o] * X[j, i-o]``, in RHS-major form and X's dtype."""
    k = _panels(X, layout, n)
    XT = _to_rhs_major(X, layout, k, n)
    YT = torch.zeros((k, n), dtype=X.dtype, device=X.device)
    for d, o in enumerate(offsets.tolist()):
        if o < 0:
            raise ValueError(f"symmetric DIA takes offsets >= 0, got {o}")
        if o >= n:
            continue
        row = data[d, : n - o].to(X.dtype)
        YT[:, : n - o] += row * XT[:, o:]
        if o > 0:
            YT[:, o:] += row * XT[:, : n - o]
    return _from_rhs_major(YT, layout, n)


def dia_spmm_grouped_reference(data, X, offsets, n, m, layout):
    """Plain PyTorch version of :func:`dia_spmm_grouped`: the plain
    :func:`dia_spmm_reference` over groups of up to 16 panels, joined."""
    k = _panels(X, layout, m)
    XT = _to_rhs_major(X, layout, k, m)
    YT = torch.cat([
        dia_spmm_reference(data, XT[j0 : j0 + MAX_PANELS], offsets, n, m, "rhs_major")
        for j0 in range(0, k, MAX_PANELS)
    ]) if k else XT.new_zeros((0, n))
    return _from_rhs_major(YT, layout, n)


def _check(data, X, offsets, n, m, layout, max_panels=MAX_PANELS):
    """Validate the operands; returns the panel count k (at most
    ``max_panels``, or any positive k when it is None)."""
    if data.ndim != 2 or offsets.ndim != 1:
        raise ValueError(
            f"want data (D, stride), offsets (D,); got {tuple(data.shape)}, "
            f"{tuple(offsets.shape)}"
        )
    if offsets.dtype != torch.int64:
        raise TypeError(f"offsets must be int64, got {offsets.dtype}")
    if data.shape[0] != offsets.shape[0]:
        raise ValueError(f"{data.shape[0]} value rows for {offsets.shape[0]} offsets")
    if data.shape[1] < n:
        raise ValueError(f"value stride {data.shape[1]} is shorter than the {n} rows")
    if not (data.device == X.device == offsets.device):
        raise ValueError(
            f"operands on different devices: data {data.device}, "
            f"X {X.device}, offsets {offsets.device}"
        )
    k = _panels(X, layout, m)
    if k < 1 or (max_panels is not None and k > max_panels):
        raise ValueError(f"{k} panels: the SpMM takes 1 to {max_panels} per call")
    return k


def _count(fn, layout):
    fn.launches += 1
    fn.launches_by_layout[layout] += 1


def dia_spmm(data, X, offsets, n, m, layout):
    """Y = A X for the n x m DIA matrix ``data[d, i] = A[i, i + offsets[d]]``
    and 1 <= k <= 16 panels X in ``layout`` (see the module docstring);
    Y comes back in the same layout, in X's dtype.  ``data`` is
    (D, stride >= n), ``offsets`` an int64 tensor of D offsets on the same
    device."""
    k = _check(data, X, offsets, n, m, layout)
    if X.device.type == "cpu":
        return dia_spmm_reference(data, X, offsets, n, m, layout)
    shape = _out_shape(layout, k, n)
    if n == 0 or m == 0:
        return X.new_zeros(shape)
    Y = _launch(
        "sigma_dia_spmm", data, X, offsets, shape, n, m, k,
        _block(layout, m), _block(layout, n),
    )
    _count(dia_spmm, layout)
    return Y


dia_spmm.launches = 0
dia_spmm.launches_by_layout = dict.fromkeys(LAYOUTS, 0)

def dia_sym_spmm(data, X, offsets, n, layout):
    """Y = A X for the symmetric n x n matrix whose upper diagonals are
    ``data[d, i] = A[i, i + offsets[d]] = A[i + offsets[d], i]`` (offsets
    >= 0, validated by :class:`SymmetricDIAMatrix`), with X and Y
    1 <= k <= 16 panels in ``layout``."""
    k = _check(data, X, offsets, n, n, layout)
    if X.device.type == "cpu":
        return dia_sym_spmm_reference(data, X, offsets, n, layout)
    shape = _out_shape(layout, k, n)
    if n == 0:
        return X.new_zeros(shape)
    Y = _launch(
        "sigma_dia_sym_spmm", data, X, offsets, shape, n, k, _block(layout, n)
    )
    _count(dia_sym_spmm, layout)
    return Y


dia_sym_spmm.launches = 0
dia_sym_spmm.launches_by_layout = dict.fromkeys(LAYOUTS, 0)


def dia_spmm_grouped(data, X, offsets, n, m, layout):
    """Y = A X for the n x m DIA matrix ``data[d, i] = A[i, i + offsets[d]]``
    and any number k >= 1 of panels X in ``layout``, "rhs_major" or
    "cols" (see the module docstring), with each stored value read from
    device memory once for all k; Y comes back in the same layout, in X's
    dtype."""
    if layout not in GROUPED_LAYOUTS:
        raise ValueError(f"the grouped SpMM takes {GROUPED_LAYOUTS} panels, not {layout!r}")
    k = _check(data, X, offsets, n, m, layout, max_panels=None)
    if X.device.type == "cpu":
        return dia_spmm_grouped_reference(data, X, offsets, n, m, layout)
    shape = _out_shape(layout, k, n)
    if n == 0 or m == 0:
        return X.new_zeros(shape)
    Y = _launch(
        "sigma_dia_spmm_grouped", data, X, offsets, shape, n, m, k,
        _block(layout, m), _block(layout, n),
    )
    _count(dia_spmm_grouped, layout)
    return Y


dia_spmm_grouped.launches = 0
dia_spmm_grouped.launches_by_layout = dict.fromkeys(GROUPED_LAYOUTS, 0)


_CONFIG_KEYS = ("smem_bytes", "window_rows", "stage_diagonals", "stages", "block_columns",
                "min_blocks_per_sm")


def spmm_launch_config(vdtype, xdtype, k):
    """:func:`dia_spmm`'s launch shape for one (value, vector) dtype pair
    and k panels, as its library reports it: the keys of
    :func:`grouped_launch_config` and the rows a block.  Builds and loads
    the kernel library (a machine with nvcc)."""
    import ctypes

    from sigma_tpu_torch.ops._build import library

    keys = (*_CONFIG_KEYS, "block_rows")
    out = (ctypes.c_int64 * len(keys))()
    if library().sigma_dia_spmm_config(_CODES[vdtype], _CODES[xdtype], k, out) != 0:
        raise TypeError(f"no DIA SpMM kernel for values {vdtype} with vector {xdtype} at k={k}")
    return dict(zip(keys, out))


def grouped_launch_config(vdtype, xdtype):
    """The grouped kernel's launch shape for one (value, vector) dtype pair,
    as its library reports it: dynamic shared memory a block, window rows,
    diagonals a ring stage, ring stages, columns a block and the blocks an
    SM its register bound allows.  Builds and loads the kernel library (a
    machine with nvcc)."""
    import ctypes

    from sigma_tpu_torch.ops._build import library

    keys = _CONFIG_KEYS
    out = (ctypes.c_int64 * len(keys))()
    if library().sigma_dia_spmm_grouped_config(_CODES[vdtype], _CODES[xdtype], out) != 0:
        raise TypeError(f"no grouped kernel for values {vdtype} with vector {xdtype}")
    return dict(zip(keys, out))
