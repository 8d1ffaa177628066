"""Pruned block-DIA SpMV and SpMM: the plan, the kernel wrappers, their plain
PyTorch versions and launch counts.

After a reverse Cuthill-McKee reorder an irregular mesh has a band that is
wide globally (245 diagonals at the 10M-row north star) but narrow
locally: most (row tile x diagonal) blocks of the band are empty.  The
pruned layout keeps only the active blocks:

- ``data`` is ``(n_slots, tile_rows)``: one slot per active (tile,
  diagonal) pair, each a contiguous stripe of ``tile_rows`` values
  (``data[s, r] = A[t * tile_rows + r, t * tile_rows + r + offsets[s]]``
  for the slot's tile t), slots in (tile, offset) order, each tile padded
  with zero slots (offset 0) to a multiple of ``group``, and a tile with no
  active pair given one padding step.  This is the JAX package's packed
  value layout, so a plan carried across from it is a reshape of its
  ``(L, C, T, 128)`` array and ``stored_slots`` agree.
- ``offsets`` is one signed column offset per slot and ``tile_ptr`` the
  first slot of each tile (G + 1 entries).  They replace the TPU kernels'
  window positions into a haloed VMEM frame (``rowoff``/``laneoff``) and
  first-step flags; the halo ``E`` (sublane rows of 128) survives only as
  the length ``E * 128`` of the symmetric kernels' spill.
- ``tile_end`` (G,) is the end of each tile's active slots
  (:func:`active_tile_ends`, computed once with the plan), so the kernels
  walk no padding slot.

Ports of the four Pallas TPU kernels of ``sigma_tpu/ops/spmv_pruned.py``:

* :func:`pruned_spmv` <- ``dia_spmv_pallas_pruned``: y = A x;
* :func:`pruned_spmm` <- ``dia_spmm_pruned_rhs_major``: Y = A X for
  1 <= k <= 16 panels, values read once for all of them;
* :func:`pruned_sym_spmv` <- ``dia_sym_spmv_pallas_pruned``: y = A x from
  the slots with offset >= ``sym_shift`` and their mirror, with the
  mirror terms past the last row returned as the spill;
* :func:`pruned_sym_spmm` <- ``dia_sym_spmm_pruned_rhs_major``: the same
  for k panels.

The CUDA kernels live in ``sigma_tpu_torch/csrc/pruned.cu``.  Routing is
as in :mod:`sigma_tpu_torch.ops.spmv_dia`: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, anything else raises; each wrapper
counts its launches in ``launches`` and the SpMMs, per layout, in
``launches_by_layout``.  Panels are RHS-major (k, m) or column (m, k)
blocks (``layout`` ``"rhs_major"`` or ``"cols"``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sigma_tpu_torch import native
from sigma_tpu_torch.ops import _build
from sigma_tpu_torch.ops.spmm_dia import (
    MAX_PANELS,
    _from_rhs_major,
    _out_shape,
    _count,
    _panels,
    _to_rhs_major,
)
from sigma_tpu_torch.ops.spmv_dia import _CODES, KERNEL_DTYPES
from sigma_tpu_torch.utils import ordered_sum

__all__ = [
    "PRUNED_LAYOUTS",
    "PrunedPlan",
    "active_tile_ends",
    "build_pruned_plan",
    "build_pruned_plan_reference",
    "pruned_matvec_reference",
    "pruned_spmm",
    "pruned_spmm_reference",
    "pruned_spmv",
    "pruned_sym_matvec_reference",
    "pruned_sym_spmm",
    "pruned_sym_spmm_reference",
    "pruned_sym_spmv",
]

_LANES = 128
PRUNED_LAYOUTS = ("rhs_major", "cols")
# slots the plain versions gather at once (bounds their scratch memory)
_PLAIN_CHUNK_ELEMS = 1 << 25


@dataclasses.dataclass(frozen=True, eq=False)
class PrunedPlan:
    """Host product of :func:`build_pruned_plan` (numpy arrays); the
    matrix classes move it to a device."""

    data: np.ndarray  # (n_slots, tile_rows) packed values
    offsets: np.ndarray  # (n_slots,) int64 column offset per slot
    tile_ptr: np.ndarray  # (G + 1,) int64 first slot per tile
    tile_end: np.ndarray  # (G,) int64 end of each tile's active slots
    tile_rows: int
    halo: int  # E: the symmetric spill is E * 128 rows
    group: int
    n: int
    m: int
    n_slots_active: int

    @property
    def n_steps(self) -> int:
        return self.data.shape[0] // self.group


def active_tile_ends(data, offsets, tile_ptr) -> np.ndarray:
    """(G,) int64 end of each tile's active slots, from the plan's host
    arrays alone.  A tile's active slots come first, in strictly
    ascending offset order, and the zero padding slots of offset 0 follow,
    so the active run is the tile's strictly ascending prefix of offsets;
    when that prefix ends in an all-zero slot of offset 0 (the first
    padding slot after negative offsets, or the one padding step of an
    empty tile) the slot is dropped.  Walking ``tile_ptr[t] .. tile_end[t]``
    instead of the whole tile removes only ``+ 0 * x`` terms."""
    starts, stops = tile_ptr[:-1], tile_ptr[1:]
    # slots that break their tile's ascending run (never a tile's first)
    brk = np.ones(offsets.size, dtype=bool)
    brk[1:] = offsets[1:] <= offsets[:-1]
    brk[starts[starts < offsets.size]] = False
    bpos = np.append(np.flatnonzero(brk), offsets.size)
    ends = np.minimum(bpos[np.searchsorted(bpos, starts)], stops)
    last = np.maximum(ends - 1, 0)
    cand = np.flatnonzero((ends > starts) & (offsets[last] == 0))
    ends[cand[~data[last[cand]].any(axis=1)]] -= 1
    return ends


def _pick_halo(T: int, hrows: int):
    """Halo height E (rows of 128): the smallest multiple of 8 that covers
    the band's one-sided reach and divides T, or T itself when the reach
    needs the whole tile; None when the reach exceeds one tile."""
    for e in range(8, T + 1, 8):
        if e >= hrows and T % e == 0:
            return e
    if T >= hrows:
        return T
    return None


def _geometry(n, rows, cols, tile_rows, min_reach=0):
    """(reach, tile rows, halo, tile count) of a plan.  The tile widens
    (doubling, as the JAX package's) until the band's reach fits one
    tile: the symmetric kernel's mirror terms then come from the row's own
    tile or the one before it.  ``min_reach`` raises the reach the tile and
    halo are sized for (a distributed layout gives every shard's plan the
    same geometry)."""
    if tile_rows % 1024:
        raise ValueError("tile_rows must be a multiple of 1024")
    offs = cols - rows
    reach = max(int(max(offs.max(initial=0), -offs.min(initial=0))), int(min_reach))
    hrows = reach // _LANES + 2
    T = tile_rows // _LANES
    while _pick_halo(T, hrows) is None:
        T *= 2
    E = _pick_halo(T, hrows)
    G = -(-(-(-n // _LANES)) // T)  # tiles of T rows of 128 over ceil(n / 128) rows
    return reach, T * _LANES, E, G


def _coo(n, m, rows, cols, vals):
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals = np.asarray(vals).ravel()
    return int(n), int(m if m is not None else n), rows, cols, vals


def build_pruned_plan(
    n, m, rows, cols, vals, *, tile_rows=16384, group=8, dtype=np.float32, min_reach=0,
) -> PrunedPlan:
    """Pack COO entries into the pruned layout (module docstring) with the
    port's host library: a radix sort by (tile, offset) and one fill pass,
    values in float32 or float64.  Duplicate entries: the last value wins.

    ``tile_rows`` is the pruning granularity (a multiple of 1024; widened
    when the band's reach exceeds it), ``group`` the padding multiple of
    each tile's slot count, ``min_reach`` a least reach to size the tile
    and halo for (see :func:`_geometry`)."""
    n, m, rows, cols, vals = _coo(n, m, rows, cols, vals)
    reach, TR, E, G = _geometry(n, rows, cols, tile_rows, min_reach)
    data, offsets, tile_ptr, n_active = native.pack_pruned(
        rows, cols, vals, tile_rows=TR, group=int(group), reach=reach,
        n_tiles=G, dtype=dtype,
    )
    return PrunedPlan(data=data, offsets=offsets, tile_ptr=tile_ptr,
                      tile_end=active_tile_ends(data, offsets, tile_ptr), tile_rows=TR,
                      halo=E, group=int(group), n=n, m=m, n_slots_active=n_active)


def build_pruned_plan_reference(
    n, m, rows, cols, vals, *, tile_rows=16384, group=8, dtype=np.float32,
) -> PrunedPlan:
    """Plain numpy version of :func:`build_pruned_plan` (the JAX package's
    numpy construction, writing the port's layout)."""
    n, m, rows, cols, vals = _coo(n, m, rows, cols, vals)
    reach, TR, E, G = _geometry(n, rows, cols, tile_rows)
    C = int(group)
    offs = cols - rows
    tile_of = rows // TR
    W = 4 * (reach + 1) + 1
    # unique (tile, offset) pairs in (tile, offset) order
    ukey, inv = np.unique(tile_of * W + (offs + reach), return_inverse=True)
    utile = ukey // W
    uoff = ukey % W - reach
    cnt = np.bincount(utile, minlength=G)
    steps = np.maximum(-(-cnt // C), 1)  # an empty tile keeps one step
    slot_base = np.concatenate([[0], np.cumsum(steps * C)])
    within = np.arange(ukey.size) - np.concatenate([[0], np.cumsum(cnt)])[:-1][utile]
    uslot = slot_base[utile] + within
    offsets = np.zeros(int(slot_base[-1]), dtype=np.int64)
    offsets[uslot] = uoff
    data = np.zeros((offsets.size, TR), dtype=dtype)
    data.reshape(-1)[uslot[inv] * TR + (rows - tile_of * TR)] = vals.astype(dtype)
    tile_ptr = slot_base.astype(np.int64)
    return PrunedPlan(data=data, offsets=offsets, tile_ptr=tile_ptr,
                      tile_end=active_tile_ends(data, offsets, tile_ptr), tile_rows=TR,
                      halo=E, group=C, n=n, m=m, n_slots_active=int(ukey.size))


# -- plain PyTorch versions ---------------------------------------------------
def _slot_chunks(data, tile_ptr, group):
    """Yield ``(s0, s1, rows)`` over runs of whole groups of slots:
    ``rows`` (s1 - s0, tile_rows) holds each slot element's global row."""
    TR = data.shape[1]
    counts = tile_ptr[1:] - tile_ptr[:-1]
    slot_tile = torch.repeat_interleave(
        torch.arange(counts.numel(), device=data.device), counts, output_size=data.shape[0]
    )
    step = max(1, _PLAIN_CHUNK_ELEMS // (TR * group)) * group
    lane = torch.arange(TR, device=data.device)
    for s0 in range(0, data.shape[0], step):
        s1 = min(s0 + step, data.shape[0])
        yield s0, s1, slot_tile[s0:s1, None] * TR + lane[None, :]


def _upper_plans(data, tile_ptr, group):
    """The fixed-order sums' plans of :func:`pruned_matvec_reference`, one
    a chunk of slots (its runs' tiles), built once a plan (off the CPU)."""
    TR = data.shape[1]
    return ordered_sum.cached((tile_ptr,), ("upper", *data.shape, group), lambda: [
        ordered_sum.sum_plan(rows[::group, 0] // TR, data.device)
        for _, _, rows in _slot_chunks(data, tile_ptr, group)
    ])


def pruned_matvec_reference(data, x, offsets, tile_ptr, n, m, *, group=1):
    """Plain PyTorch version of :func:`pruned_spmv`: gather ``x[row +
    offset]`` for every slot element (out-of-range columns give 0), sum
    each run of ``group`` slots, then add the runs into their tile's rows
    in order, in x's dtype.  That is the JAX package's reference order, so
    with the matrix's ``group`` the two agree bitwise; the kernel sums in
    slot order.  Off the CPU the runs add in the same order without
    atomics, which gives the CPU's bits."""
    TR = data.shape[1]
    G = tile_ptr.numel() - 1
    y = torch.zeros((G, TR), dtype=x.dtype, device=x.device)
    plans = _upper_plans(data, tile_ptr, group) if ordered_sum.fixed_order(x.device) else None
    for c, (s0, s1, rows) in enumerate(_slot_chunks(data, tile_ptr, group)):
        idx = rows + offsets[s0:s1, None]
        ok = (idx >= 0) & (idx < m)
        xg = torch.where(ok, x[idx.clamp(0, max(m - 1, 0))], 0)
        steps = (data[s0:s1].to(x.dtype) * xg).reshape(-1, group, TR).sum(1)
        ordered_sum.scatter_add_(y, rows[::group, 0] // TR, steps,
                                 None if plans is None else plans[c])
    return y.reshape(-1)[:n]


def _mirror_targets(rows, om, sym_shift, n, m, EL):
    """(x index, output row, in range) of a chunk's mirror terms: slot
    elements at ``rows`` with mirror offsets ``om`` (one a slot)."""
    zidx = rows + sym_shift
    out = rows + om[:, None]
    ok = (zidx >= 0) & (zidx < m) & (om[:, None] > 0) & (out >= 0) & (out < n + EL)
    return zidx, out, ok


def _mirror_plans(data, offsets, tile_ptr, n, m, group, sym_shift, EL):
    """The fixed-order sums' plans of the mirror pass, one a chunk of
    slots, built once a plan (off the CPU)."""
    def build():
        om = offsets - sym_shift
        return [ordered_sum.sum_plan(out[ok], data.device)
                for s0, s1, rows in _slot_chunks(data, tile_ptr, group)
                for _, out, ok in [_mirror_targets(rows, om[s0:s1], sym_shift, n, m, EL)]]

    return ordered_sum.cached((offsets, tile_ptr),
                              ("mirror", *data.shape, group, sym_shift, n, m, EL), build)


def _mirror_pass(data, X, offsets, tile_ptr, n, m, *, halo, sym_shift, group):
    """The mirror terms ``y[i + om] += d[i] * x[i + sym_shift]`` of every
    slot with mirror offset ``om = offset - sym_shift > 0``, added in slot
    order (on every device) into zeros of n + halo * 128 rows, for x (m,)
    or k columns X (m, k) at once (each column the same sums as alone)."""
    EL = halo * _LANES
    ym = torch.zeros((n + EL,) + tuple(X.shape[1:]), dtype=X.dtype, device=X.device)
    om = offsets - sym_shift
    plans = (_mirror_plans(data, offsets, tile_ptr, n, m, group, sym_shift, EL)
             if ordered_sum.fixed_order(X.device) else None)
    for c, (s0, s1, rows) in enumerate(_slot_chunks(data, tile_ptr, group)):
        zidx, out, ok = _mirror_targets(rows, om[s0:s1], sym_shift, n, m, EL)
        d = data[s0:s1].to(X.dtype)
        z = (d if X.ndim == 1 else d[..., None]) * X[zidx.clamp(0, max(m - 1, 0))]
        ordered_sum.scatter_add_(ym, out[ok], z[ok], None if plans is None else plans[c])
    return ym


def pruned_sym_matvec_reference(
    data, x, offsets, tile_ptr, n, m, *, halo, sym_shift=0, with_spill=False, group=1
):
    """Plain PyTorch version of :func:`pruned_sym_spmv`: the upper pass of
    :func:`pruned_matvec_reference` plus the mirror pass, a scatter-add
    ``y[i + om] += d[i] * x[i + sym_shift]`` for every slot with mirror
    offset ``om = offset - sym_shift > 0`` (in slot order, on every
    device).  Returns y, or ``(y, spill)`` with ``spill`` (halo * 128,) the
    mirror terms on rows n and past."""
    y = pruned_matvec_reference(data, x, offsets, tile_ptr, n, m, group=group)
    ym = _mirror_pass(data, x, offsets, tile_ptr, n, m, halo=halo, sym_shift=sym_shift,
                      group=group)
    if with_spill:
        return y + ym[:n], ym[n:]
    return y + ym[:n]


def pruned_spmm_reference(data, X, offsets, tile_ptr, n, m, layout, *, group=1):
    """Plain PyTorch version of :func:`pruned_spmm`: one
    :func:`pruned_matvec_reference` per panel."""
    k = _panels(X, layout, m)
    XT = _to_rhs_major(X, layout, k, m)
    YT = torch.stack([
        pruned_matvec_reference(data, XT[j], offsets, tile_ptr, n, m, group=group)
        for j in range(k)
    ])
    return _from_rhs_major(YT, layout, n)


def pruned_sym_spmm_reference(
    data, X, offsets, tile_ptr, n, m, layout, *, halo, sym_shift=0, with_spill=False,
    group=1,
):
    """Plain PyTorch version of :func:`pruned_sym_spmm`: per panel what
    :func:`pruned_sym_matvec_reference` computes, bit for bit (the upper
    pass panel by panel, the mirror pass for all panels at once); the spill
    comes back in the panels' layout, (k, halo * 128) or (halo * 128, k)."""
    k = _panels(X, layout, m)
    XT = _to_rhs_major(X, layout, k, m)
    up = torch.stack([
        pruned_matvec_reference(data, XT[j], offsets, tile_ptr, n, m, group=group)
        for j in range(k)
    ])
    ym = _mirror_pass(data, XT.T, offsets, tile_ptr, n, m, halo=halo, sym_shift=sym_shift,
                      group=group).T
    Y = _from_rhs_major(up + ym[:, :n], layout, n)
    if not with_spill:
        return Y
    return Y, _from_rhs_major(ym[:, n:].contiguous(), layout, halo * _LANES)


# -- kernel wrappers ------------------------------------------------------------
def _check(data, X, offsets, tile_ptr, n, m, layout):
    """Validate the operands; returns the panel count k (None for a
    vector)."""
    if data.ndim != 2 or offsets.ndim != 1 or tile_ptr.ndim != 1:
        raise ValueError(
            f"want data (n_slots, tile_rows), offsets (n_slots,), tile_ptr "
            f"(G + 1,); got {tuple(data.shape)}, {tuple(offsets.shape)}, "
            f"{tuple(tile_ptr.shape)}"
        )
    if offsets.dtype != torch.int64 or tile_ptr.dtype != torch.int64:
        raise TypeError(f"offsets and tile_ptr must be int64, got {offsets.dtype}, {tile_ptr.dtype}")
    if data.shape[0] != offsets.shape[0]:
        raise ValueError(f"{data.shape[0]} value slots for {offsets.shape[0]} offsets")
    if data.shape[1] % 1024:
        raise ValueError(f"tile_rows {data.shape[1]} is not a multiple of 1024")
    if (tile_ptr.shape[0] - 1) * data.shape[1] < n:
        raise ValueError(
            f"{tile_ptr.shape[0] - 1} tiles of {data.shape[1]} rows do not cover {n} rows"
        )
    if not (data.device == X.device == offsets.device == tile_ptr.device):
        raise ValueError(
            f"operands on different devices: data {data.device}, x {X.device}, "
            f"offsets {offsets.device}, tile_ptr {tile_ptr.device}"
        )
    if layout is None:
        if X.ndim != 1 or X.shape[0] != m:
            raise ValueError(f"x has shape {tuple(X.shape)}, want ({m},)")
        return None
    if layout not in PRUNED_LAYOUTS:
        raise ValueError(f"unknown panel layout {layout!r}; want one of {PRUNED_LAYOUTS}")
    k = _panels(X, layout, m)
    if not 1 <= k <= MAX_PANELS:
        raise ValueError(f"{k} panels: the SpMM takes 1 to {MAX_PANELS} per call")
    return k


def _block(layout, length):
    """Panel-block length B (see csrc/dia_spmm.cu) of a layout."""
    return 1 if layout == "cols" else length


def _tile_end(tile_end, tile_ptr):
    """The kernels' per-tile slot ends: the plan's active ends, or every
    tile's last slot (``tile_ptr[1:]``) when none are given."""
    if tile_end is None:
        return tile_ptr[1:]
    if tile_end.dtype != torch.int64 or tuple(tile_end.shape) != (tile_ptr.shape[0] - 1,):
        raise ValueError(
            f"tile_end must be int64 of shape ({tile_ptr.shape[0] - 1},), got "
            f"{tile_end.dtype} {tuple(tile_end.shape)}"
        )
    if tile_end.device != tile_ptr.device:
        raise ValueError(f"tile_end on {tile_end.device}, tile_ptr on {tile_ptr.device}")
    return tile_end


def _launch(entry, data, X, offsets, tile_ptr, outs, *sizes, tile_end=None):
    """Launch one kernel on the current stream into the preallocated
    outputs ``outs`` (the null pointer for None); ``tile_end`` goes after
    ``tile_ptr``.  Raises on anything the kernel does not take."""
    if X.device.type != "cuda":
        raise ValueError(f"no pruned kernel for device {X.device}")
    if (data.dtype, X.dtype) not in KERNEL_DTYPES:
        raise TypeError(f"no pruned kernel for values {data.dtype} with vectors {X.dtype}")
    for name, t in (("data", data), ("x", X), ("offsets", offsets), ("tile_ptr", tile_ptr)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if data.data_ptr() % 16:
        raise ValueError("data must start on a 16-byte boundary")
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = getattr(_build.library(), entry)(
        X.device.index, _CODES[data.dtype], _CODES[X.dtype],
        data.data_ptr(), X.data_ptr(), offsets.data_ptr(), tile_ptr.data_ptr(),
        *([] if tile_end is None else [tile_end.data_ptr()]),
        *[0 if o is None else o.data_ptr() for o in outs],
        data.shape[1], tile_ptr.shape[0] - 1, *sizes, stream,
    )
    if rc != 0:
        raise RuntimeError(f"{entry} failed with CUDA error {rc}")


def pruned_spmv(data, x, offsets, tile_ptr, n, m, *, group=1, tile_end=None):
    """y = A x for the n x m pruned matrix ``(data, offsets, tile_ptr)``
    (module docstring); y is (n,) in x's dtype.  ``group`` is the slot
    grouping of the plan, which orders the plain version's sums (the
    kernel sums in slot order); ``tile_end`` (:func:`active_tile_ends`)
    lets the kernel skip the padding slots, which the plain version sums
    as zeros."""
    _check(data, x, offsets, tile_ptr, n, m, None)
    tile_end = _tile_end(tile_end, tile_ptr)
    if x.device.type == "cpu":
        return pruned_matvec_reference(data, x, offsets, tile_ptr, n, m, group=group)
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    _launch("sigma_pruned_spmv", data, x, offsets, tile_ptr, (y,), n, m, tile_end=tile_end)
    pruned_spmv.launches += 1
    return y


pruned_spmv.launches = 0


def pruned_spmm(data, X, offsets, tile_ptr, n, m, layout, *, group=1, tile_end=None):
    """Y = A X for 1 <= k <= 16 panels X in ``layout`` (RHS-major (k, m) or
    columns (m, k)); Y comes back in the same layout, in X's dtype.
    ``group`` and ``tile_end`` as for :func:`pruned_spmv`."""
    k = _check(data, X, offsets, tile_ptr, n, m, layout)
    tile_end = _tile_end(tile_end, tile_ptr)
    if X.device.type == "cpu":
        return pruned_spmm_reference(data, X, offsets, tile_ptr, n, m, layout, group=group)
    Y = torch.empty(_out_shape(layout, k, n), dtype=X.dtype, device=X.device)
    if n == 0:
        return Y
    _launch("sigma_pruned_spmm", data, X, offsets, tile_ptr, (Y,), n, m, k,
            _block(layout, m), _block(layout, n), tile_end=tile_end)
    _count(pruned_spmm, layout)
    return Y


pruned_spmm.launches = 0
pruned_spmm.launches_by_layout = dict.fromkeys(PRUNED_LAYOUTS, 0)


def _check_sym(n, m, tile_rows, halo, sym_shift):
    if sym_shift < 0 or sym_shift % _LANES:
        raise ValueError(f"sym_shift must be a nonnegative multiple of 128, got {sym_shift}")
    if halo * _LANES > tile_rows:
        raise ValueError(f"halo {halo} x 128 exceeds the tile of {tile_rows} rows")
    if n % tile_rows and n != m:
        # the spill carries mirror rows past n; on a rectangular block
        # with an unaligned n, rows n .. the tile's end would be lost
        raise ValueError(
            f"symmetric pruned kernel on a rectangular block needs n ({n}) to "
            f"be a multiple of the tile ({tile_rows}) so the spill aligns with "
            "the block boundary"
        )


def pruned_sym_spmv(data, x, offsets, tile_ptr, n, m, *, halo, sym_shift=0,
                    with_spill=False, group=1, tile_end=None):
    """y = A x from the packed slots with offset >= ``sym_shift`` (the
    upper triangle and main diagonal; for a rectangular block of a
    distributed layout, the columns shifted by ``sym_shift``) and their
    mirror ``A[i + om, i] = data`` at mirror offset ``om = offset -
    sym_shift > 0``.  With ``with_spill`` returns ``(y, spill)``, spill the
    (halo * 128,) mirror terms on rows n, n + 1, ... (all zero for a square
    matrix).  ``group`` and ``tile_end`` as for :func:`pruned_spmv`."""
    _check(data, x, offsets, tile_ptr, n, m, None)
    _check_sym(n, m, data.shape[1], halo, sym_shift)
    tile_end = _tile_end(tile_end, tile_ptr)
    if x.device.type == "cpu":
        return pruned_sym_matvec_reference(data, x, offsets, tile_ptr, n, m, halo=halo,
                                           sym_shift=sym_shift, with_spill=with_spill,
                                           group=group)
    EL = halo * _LANES
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    spill = torch.empty(EL, dtype=x.dtype, device=x.device) if with_spill else None
    rows_out = n + (EL if with_spill else 0)
    if rows_out:
        _launch("sigma_pruned_sym_spmv", data, x, offsets, tile_ptr, (y, spill),
                n, m, sym_shift, EL, rows_out, tile_end=tile_end)
        pruned_sym_spmv.launches += 1
    return (y, spill) if with_spill else y


pruned_sym_spmv.launches = 0


def pruned_sym_spmm(data, X, offsets, tile_ptr, n, m, layout, *, halo, sym_shift=0,
                    with_spill=False, group=1, tile_end=None):
    """:func:`pruned_sym_spmv` for 1 <= k <= 16 panels X in ``layout``;
    the spill comes back in the same layout, (k, halo * 128) or
    (halo * 128, k)."""
    k = _check(data, X, offsets, tile_ptr, n, m, layout)
    _check_sym(n, m, data.shape[1], halo, sym_shift)
    tile_end = _tile_end(tile_end, tile_ptr)
    if X.device.type == "cpu":
        return pruned_sym_spmm_reference(data, X, offsets, tile_ptr, n, m, layout,
                                         halo=halo, sym_shift=sym_shift,
                                         with_spill=with_spill, group=group)
    EL = halo * _LANES
    Y = torch.empty(_out_shape(layout, k, n), dtype=X.dtype, device=X.device)
    spill = (
        torch.empty(_out_shape(layout, k, EL), dtype=X.dtype, device=X.device)
        if with_spill else None
    )
    rows_out = n + (EL if with_spill else 0)
    if rows_out:
        _launch("sigma_pruned_sym_spmm", data, X, offsets, tile_ptr, (Y, spill),
                n, m, k, _block(layout, m), _block(layout, n), _block(layout, EL),
                sym_shift, EL, rows_out, tile_end=tile_end)
        _count(pruned_sym_spmm, layout)
    return (Y, spill) if with_spill else Y


pruned_sym_spmm.launches = 0
pruned_sym_spmm.launches_by_layout = dict.fromkeys(PRUNED_LAYOUTS, 0)
