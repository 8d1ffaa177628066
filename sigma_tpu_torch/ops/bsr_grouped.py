"""Grouped-layout BSR SpMV/SpMM: the kernel wrapper, its plain PyTorch
version, and the :class:`GroupedBSR` operator.

Port of ``sigma_tpu/ops/bsr_pallas.py``.  The layout is the JAX package's:
each block row's blocks are padded to a multiple of ``group`` = B with zero
blocks that point at block column 0 (harmless in arithmetic), a block row
with no blocks gets one zero group, and group g stores

* ``gdata[g]``: (bh, B*bw), its B value blocks side by side;
* ``gcols[g, j]``: the block-column index of slice j (int32);
* ``grow[g]``: the owning block row (int32, ascending).

:func:`bsr_grouped_spmv` <- ``bsr_grouped_spmv`` (the scalar-prefetch Pallas
kernel).  The CUDA kernel lives in ``sigma_tpu_torch/csrc/bsr_grouped.cu``
(design and traffic notes there): one warp per block row (wide groups)
or one thread per output row (narrow groups), in the form
:func:`bsr_grouped_form` picks from the shape and dtype, walks the row's
contiguous run of groups through a group pointer and writes y once, in a
fixed summation order.

Routing is by the device of the tensors, and nothing else: a CPU tensor
goes to the plain version (:func:`bsr_grouped_spmv_reference`), a CUDA
tensor to the kernel, and anything the kernel does not take raises.  This
differs from the JAX package on purpose.  There the XLA form (gather,
einsum, segment sum) is the default and the Pallas kernel is opt-in
(``GroupedBSR.use_pallas_kernel = False``), gated on the backend, on the
dtype and on the index arrays fitting the TPU's scalar memory
(``4 * (gcols.size + grow.size) <= 800_000``).  The port has no such flag
and no such gate: the kernel reads its index arrays from device memory, so
an operator of any size runs it (the 10.1M-dof elasticity operator has 27M
column indices), and there is no fallback to the plain version.  The
wrapper counts its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple

import torch

from sigma_tpu_torch.operators.linear_operator import LinearOperator
from sigma_tpu_torch.ops import _build
from sigma_tpu_torch.utils import ordered_sum

__all__ = [
    "BSR_KERNEL_DTYPES",
    "GroupedBSR",
    "bsr_group_pointer",
    "bsr_grouped_form",
    "bsr_grouped_spmv",
    "bsr_grouped_spmv_reference",
]

_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
# (value dtype, vector dtype) pairs the kernel is instantiated for: the DIA
# kernels' five, and bf16 vectors (accumulated in f32, rounded on the store)
BSR_KERNEL_DTYPES = frozenset(
    {
        (torch.float32, torch.float32),
        (torch.bfloat16, torch.float32),
        (torch.float64, torch.float64),
        (torch.float32, torch.float64),
        (torch.bfloat16, torch.float64),
        (torch.bfloat16, torch.bfloat16),
        (torch.float32, torch.bfloat16),
    }
)


def bsr_group_pointer(grow, nb_rows) -> torch.Tensor:
    """(nb_rows + 1,) int64 pointer into the ascending ``grow``: block row
    r owns groups ``gptr[r] : gptr[r + 1]`` (none, for a row that no group
    names).  Takes the place of the TPU kernel's "first group of this row"
    flag."""
    rows = torch.arange(nb_rows + 1, dtype=grow.dtype, device=grow.device)
    return torch.searchsorted(grow, rows).to(torch.int64)


def bsr_grouped_form(block_shape, group: int, itemsize: int, aligned: bool = True) -> str:
    """The kernel form for groups of ``group`` blocks of ``block_shape``
    with values of ``itemsize`` bytes, in gdata that starts on a 16-byte
    boundary (``aligned``), as the kernel's source describes them:

    * ``"wide"``: one warp per block row, values in 16-byte pieces of P =
      16 / itemsize, each piece's x rows gathered once for the block row's
      output rows; when bw is a multiple of P and a group row holds at
      least 32 pieces (a warp's width), e.g. (8, 128) blocks in groups of 8;
    * ``"narrow"``: one thread per output row, its group row read in 16-byte
      pieces, when the group row is a multiple of 16 bytes wide, e.g.
      (3, 3) f32 blocks in groups of 8 (96 bytes);
    * ``"narrow_unaligned"``: the same, one value a load, for any other
      group row (or gdata off a 16-byte boundary)."""
    bw = int(block_shape[1])
    piece = 16 // itemsize
    width = int(group) * bw
    if not aligned or (width * itemsize) % 16:
        return "narrow_unaligned"
    if bw % piece == 0 and width >= 32 * piece:
        return "wide"
    return "narrow"


def bsr_grouped_spmv_reference(gdata, gcols, grow, x, nb_rows, nb_cols, block_shape, B):
    """Plain PyTorch version of :func:`bsr_grouped_spmv`: gather the B x
    blocks of every group, one batched (bh, B*bw) @ (B*bw, k) product, and
    a sum over ``grow`` (the JAX package's XLA form).  Values are cast up
    to x's dtype; bf16 vectors are computed in f32 and rounded once.  The
    sum adds a block row's groups in stored order on every device (off the
    CPU without atomics, its plan kept for ``grow``), with the CPU's bits."""
    bh, bw = block_shape
    k = x.shape[1]
    ct = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    X3 = x.to(ct).reshape(nb_cols, bw, k)
    gath = X3[gcols.long()].reshape(gdata.shape[0], B * bw, k)
    Yg = torch.einsum("ghc,gck->ghk", gdata.to(ct), gath)
    plan = (ordered_sum.cached((grow,), ("grow", nb_rows),
                               lambda: ordered_sum.sum_plan(grow, x.device))
            if ordered_sum.fixed_order(x.device) else None)
    Y = ordered_sum.scatter_sum(Yg, grow.long(), nb_rows, plan)
    return Y.reshape(nb_rows * bh, k).to(x.dtype)


# the kernel's forms, as the C entry numbers them
_FORMS = {"narrow_unaligned": 0, "narrow": 1, "wide": 2}


def _launch(gdata, gcols, gptr, x, nb_rows, bh, bw, B, form):
    """Launch the kernel on checked operands (x (nb_cols*bw,) or
    (nb_cols*bw, k), contiguous on a CUDA device, a dtype pair of
    BSR_KERNEL_DTYPES); count it.  Returns y (nb_rows*bh,) or
    (nb_rows*bh, k)."""
    k = x.shape[1] if x.ndim == 2 else 1
    y = torch.empty((nb_rows * bh, *x.shape[1:]), dtype=x.dtype, device=x.device)
    if nb_rows == 0 or k == 0:
        return y
    dev = x.device.index
    rc = _build.library().sigma_bsr_grouped_spmv(
        dev, _CODES[gdata.dtype], _CODES[x.dtype],
        gdata.data_ptr(), gcols.data_ptr(), gptr.data_ptr(), x.data_ptr(), y.data_ptr(),
        nb_rows, bh, bw, B, k, _FORMS[form],
        # the current stream's handle without building a Stream object (a
        # fifth of the product's host time through torch.cuda.current_stream)
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"sigma_bsr_grouped_spmv failed with CUDA error {rc}")
    bsr_grouped_spmv.launches += 1
    return y


def _check_arrays(gdata, gcols, grow, block_shape, B):
    """Raise unless the grouped layout's arrays have their shapes, int32
    indices and one device."""
    bh, bw = block_shape
    G = gdata.shape[0] if gdata.ndim else 0
    if gdata.ndim != 3 or tuple(gdata.shape[1:]) != (bh, B * bw):
        raise ValueError(f"want gdata (G, {bh}, {B * bw}), got {tuple(gdata.shape)}")
    if tuple(gcols.shape) != (G, B) or tuple(grow.shape) != (G,):
        raise ValueError(
            f"want gcols ({G}, {B}) and grow ({G},), got {tuple(gcols.shape)}, {tuple(grow.shape)}"
        )
    if gcols.dtype != torch.int32 or grow.dtype != torch.int32:
        raise TypeError(f"gcols and grow must be int32, got {gcols.dtype}, {grow.dtype}")
    if not gcols.device == grow.device == gdata.device:
        raise ValueError(f"arrays on different devices: gdata {gdata.device}, "
                         f"gcols {gcols.device}, grow {grow.device}")


def _check_kernel_operands(gdata, x):
    """Route check of a product: raises unless x is on gdata's device, a
    CPU tensor or a CUDA tensor of a dtype pair the kernel takes."""
    if x.device != gdata.device:
        raise ValueError(f"operands on different devices: gdata {gdata.device}, x {x.device}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"no grouped-BSR kernel for device {x.device}")
    if (gdata.dtype, x.dtype) not in BSR_KERNEL_DTYPES:
        raise TypeError(f"no grouped-BSR kernel for values {gdata.dtype} with vector {x.dtype}")


def bsr_grouped_spmv(gdata, gcols, grow, x, nb_rows, nb_cols, block_shape, B, gptr=None):
    """Y = grouped-BSR SpMV/SpMM.  ``gdata`` (G, bh, B*bw), ``gcols``
    (G, B) int32, ``grow`` (G,) int32 ascending, ``x`` (nb_cols*bw, k)
    contiguous; returns (nb_rows*bh, k) in x's dtype.  Pass a k=1 column
    for a plain matvec.  ``gptr`` is :func:`bsr_group_pointer` of ``grow``
    (made here when not given).  Checks every operand on every call
    (:class:`GroupedBSR` checks its fixed arrays once, at construction)."""
    bh, bw = (int(s) for s in block_shape)
    _check_arrays(gdata, gcols, grow, (bh, bw), B)
    if x.ndim != 2 or x.shape[0] != nb_cols * bw:
        raise ValueError(f"want x ({nb_cols * bw}, k), got {tuple(x.shape)}")
    _check_kernel_operands(gdata, x)
    if x.device.type == "cpu":
        return bsr_grouped_spmv_reference(gdata, gcols, grow, x, nb_rows, nb_cols, (bh, bw), B)
    if gptr is None:
        gptr = bsr_group_pointer(grow, nb_rows)
    if gptr.dtype != torch.int64 or tuple(gptr.shape) != (nb_rows + 1,) or gptr.device != x.device:
        raise ValueError(f"want gptr ({nb_rows + 1},) int64 on {x.device}")
    for name, t in (("gdata", gdata), ("gcols", gcols), ("gptr", gptr), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    form = bsr_grouped_form((bh, bw), B, gdata.element_size(), gdata.data_ptr() % 16 == 0)
    return _launch(gdata, gcols, gptr, x, nb_rows, bh, bw, B, form)


bsr_grouped_spmv.launches = 0


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class GroupedBSR(LinearOperator):
    """BSR matrix in the kernel's grouped layout (see the module's text).

    Built once from a :class:`~sigma_tpu_torch.matrix.formats.BSRMatrix`
    by :meth:`from_bsr`, or directly from its arrays; apply with
    ``matvec``/``matmat``.  A frozen dataclass holding tensors, as
    ``DIAMatrix`` is (the JAX package's is a registered pytree); a
    :class:`LinearOperator`, so it goes straight into ``cg_solve``.  On a
    CUDA tensor every product is one launch of :func:`bsr_grouped_spmv`;
    on a CPU tensor its plain version.  Products are computed in the
    operand's dtype, values cast up to it inside the kernel.
    """

    gdata: torch.Tensor  # (n_groups, bh, B*bw)
    gcols: torch.Tensor  # (n_groups, B) int32
    grow: torch.Tensor  # (n_groups,) int32, ascending
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]
    group: int
    # the run of groups of each block row, for the kernel
    gptr: torch.Tensor = dataclasses.field(init=False, repr=False)
    # the kernel's form (bsr_grouped_form), fixed by the arrays
    form: str = dataclasses.field(init=False, repr=False)

    format: ClassVar[str] = "bsr_grouped"

    def __post_init__(self):
        object.__setattr__(self, "shape", (int(self.shape[0]), int(self.shape[1])))
        object.__setattr__(
            self, "block_shape", (int(self.block_shape[0]), int(self.block_shape[1]))
        )
        object.__setattr__(self, "group", int(self.group))
        self._validate()
        object.__setattr__(self, "gptr", bsr_group_pointer(self.grow, self.nb_rows))
        object.__setattr__(self, "form", bsr_grouped_form(
            self.block_shape, self.group, self.gdata.element_size(),
            self.gdata.data_ptr() % 16 == 0))

    def _validate(self):
        """Check the fixed arrays once, so that a product checks only its
        operand: shapes, dtypes, one device, contiguity, and (off the meta
        device, with one read) grow ascending in [0, nb_rows) and gcols in
        [0, nb_cols), which the kernel indexes with."""
        gdata, gcols, grow = self.gdata, self.gcols, self.grow
        if min(*self.block_shape, self.group) < 1 or min(self.shape) < 0:
            raise ValueError(f"bad shape {self.shape}, block {self.block_shape}, "
                             f"group {self.group}")
        _check_arrays(gdata, gcols, grow, self.block_shape, self.group)
        for name, t in (("gdata", gdata), ("gcols", gcols), ("grow", grow)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if grow.numel() and gdata.device.type != "meta":
            bad = ((grow[1:] < grow[:-1]).any() | (grow[0] < 0) | (grow[-1] >= self.nb_rows)
                   | (gcols.min() < 0) | (gcols.max() >= self.nb_cols))
            if bool(bad):
                raise ValueError(f"want grow ascending in [0, {self.nb_rows}) and gcols in "
                                 f"[0, {self.nb_cols})")

    @property
    def nb_rows(self) -> int:
        return -(-self.shape[0] // self.block_shape[0])

    @property
    def nb_cols(self) -> int:
        return -(-self.shape[1] // self.block_shape[1])

    @property
    def dtype(self):
        return self.gdata.dtype

    @property
    def stored_slots(self) -> int:
        """Stored values, padding blocks included."""
        return self.gdata.numel()

    @classmethod
    def from_bsr(cls, A, group: int = 8) -> "GroupedBSR":
        """Regroup a BSRMatrix on its device: the arrays of the JAX
        package's host loop, made with one scatter (the 10.1M-dof
        elasticity operator has 23.6M blocks)."""
        g = A.graph
        bh, bw = g.block_shape
        nbr, nnzb, group = g.nb_rows, g.nnzb, int(group)
        dev = A.data.device
        brows = g.block_rows[:nnzb]
        deg = g.indptr[1:] - g.indptr[:-1]
        groups_per_row = torch.clamp(-(-deg // group), min=1)
        row_gstart = torch.zeros(nbr + 1, dtype=torch.int64, device=dev)
        torch.cumsum(groups_per_row, 0, out=row_gstart[1:])
        n_groups = int(row_gstart[-1])
        grow = torch.repeat_interleave(
            torch.arange(nbr, dtype=torch.int32, device=dev), groups_per_row,
            output_size=n_groups,
        )
        # slot of each block within its row (block_rows is sorted)
        slot = torch.arange(nnzb, dtype=torch.int64, device=dev) - g.indptr[brows]
        dest = (row_gstart[brows] + slot // group) * group + slot % group  # (group, lane) flat
        gcols = torch.zeros(n_groups * group, dtype=torch.int32, device=dev)
        gcols[dest] = g.indices[:nnzb].to(torch.int32)
        # value blocks: gdata viewed (n_groups, bh, group, bw) takes block b at [gidx, :, lane, :]
        gdata = torch.zeros((n_groups * group, bh, bw), dtype=A.data.dtype, device=dev)
        gdata[dest] = A.data[:nnzb]
        gdata = (
            gdata.view(n_groups, group, bh, bw).permute(0, 2, 1, 3)
            .reshape(n_groups, bh, group * bw)
        )
        return cls(gdata, gcols.view(n_groups, group), grow, A.shape, (bh, bw), group)

    def _pad_x(self, x):
        mp = self.nb_cols * self.block_shape[1]
        if x.shape[0] != mp:
            pad = x.new_zeros((mp - x.shape[0],) + tuple(x.shape[1:]))
            x = torch.cat([x, pad])
        return x

    def _apply(self, X):
        """One product on X, (m,) or (m, k): checks X alone (the arrays
        were checked at construction) and launches, or on the CPU runs the
        plain version."""
        _check_kernel_operands(self.gdata, X)
        (bh, bw), n = self.block_shape, self.shape[0]
        if X.shape[0] not in (self.shape[1], self.nb_cols * bw):
            raise ValueError(f"want x ({self.shape[1]}, k), got {tuple(X.shape)}")
        if X.device.type == "cpu":
            X2 = X[:, None] if X.ndim == 1 else X
            Y = bsr_grouped_spmv_reference(
                self.gdata, self.gcols, self.grow, self._pad_x(X2).contiguous(), self.nb_rows,
                self.nb_cols, self.block_shape, self.group,
            )[:n]
            return Y[:, 0] if X.ndim == 1 else Y
        Y = _launch(self.gdata, self.gcols, self.gptr, self._pad_x(X).contiguous(), self.nb_rows,
                    bh, bw, self.group, self.form)
        return Y if Y.shape[0] == n else Y[:n]

    def matvec(self, x):
        return self._apply(x)

    def matmat(self, X):
        return self._apply(X)

    def __repr__(self) -> str:
        return (
            f"GroupedBSR(shape={self.shape}, block={self.block_shape}, "
            f"groups={self.gdata.shape[0]} x {self.group}, device={self.gdata.device})"
        )
