"""Hand-written GPU kernels for the hot SpMV and SpMM paths.

* :mod:`sigma_tpu_torch.ops.spmv_dia` — the DIA (stencil) SpMV kernels,
  full storage and symmetric storage, with their plain PyTorch versions;
  :class:`~sigma_tpu_torch.matrix.formats.DIAMatrix` and
  :class:`~sigma_tpu_torch.matrix.symmetric.SymmetricDIAMatrix` call them
  for every matvec.  Beside them the staged-x SpMV entry
  ``dia_spmv_staged`` and its two kernels (x resident in shared memory, or
  each tile's x window copied in).
* :mod:`sigma_tpu_torch.ops.spmm_dia` — the DIA SpMM kernels (Y = A X for
  up to 16 panels, in the RHS-major, interleaved or column layout, and the
  grouped kernel for any number of panels) with their plain versions and
  the panel (de-)interleaving; the same classes call them for every
  ``matmat``, ``matmat_rhs_major`` and ``matmat_interleaved``.
* :mod:`sigma_tpu_torch.ops.spmv_pruned` — the pruned block-DIA plan and
  its four kernels (SpMV and SpMM, full and symmetric storage, the
  symmetric ones with the spill past the last row) with their plain
  versions; :class:`~sigma_tpu_torch.matrix.pruned.PrunedDIAMatrix` and
  :class:`~sigma_tpu_torch.matrix.pruned.SymmetricPrunedDIAMatrix` call
  them for every product.
* :mod:`sigma_tpu_torch.ops.bsr_grouped` — the grouped block-sparse-row
  SpMV/SpMM kernel with its plain version and the
  :class:`~sigma_tpu_torch.ops.bsr_grouped.GroupedBSR` operator, which
  calls it for every product; the kernel path of
  :class:`~sigma_tpu_torch.matrix.formats.BSRMatrix` (``.grouped()``).
"""

import torch

from sigma_tpu_torch.ops.bsr_grouped import (
    BSR_KERNEL_DTYPES,
    GroupedBSR,
    bsr_group_pointer,
    bsr_grouped_lanes,
    bsr_grouped_spmv,
    bsr_grouped_spmv_reference,
)
from sigma_tpu_torch.ops.spmm_dia import (
    GROUPED_LAYOUTS,
    LAYOUTS,
    MAX_PANELS,
    deinterleave_panels,
    dia_spmm,
    dia_spmm_grouped,
    dia_spmm_grouped_reference,
    dia_spmm_reference,
    dia_sym_spmm,
    dia_sym_spmm_reference,
    interleave_panels,
)
from sigma_tpu_torch.ops.spmv_pruned import (
    PRUNED_LAYOUTS,
    PrunedPlan,
    build_pruned_plan,
    build_pruned_plan_reference,
    pruned_matvec_reference,
    pruned_spmm,
    pruned_spmm_reference,
    pruned_spmv,
    pruned_sym_matvec_reference,
    pruned_sym_spmm,
    pruned_sym_spmm_reference,
    pruned_sym_spmv,
)
from sigma_tpu_torch.ops.spmv_dia import (
    KERNEL_DTYPES,
    STAGED_SMEM_BYTES,
    dia_spmv,
    dia_spmv_reference,
    dia_spmv_resident,
    dia_spmv_staged,
    dia_spmv_window,
    dia_sym_spmv,
    dia_sym_spmv_reference,
    staged_route,
    window_plan,
)


def cuda_available() -> bool:
    """True when a CUDA device is present: the counterpart of the JAX
    package's ``pallas_supported``.  A gate for callers such as tests and
    scripts only; the kernels themselves route by the device of the tensor
    they are given."""
    return torch.cuda.is_available()


__all__ = [
    "BSR_KERNEL_DTYPES",
    "GROUPED_LAYOUTS",
    "GroupedBSR",
    "KERNEL_DTYPES",
    "LAYOUTS",
    "MAX_PANELS",
    "PRUNED_LAYOUTS",
    "PrunedPlan",
    "STAGED_SMEM_BYTES",
    "bsr_group_pointer",
    "bsr_grouped_lanes",
    "bsr_grouped_spmv",
    "bsr_grouped_spmv_reference",
    "build_pruned_plan",
    "build_pruned_plan_reference",
    "cuda_available",
    "deinterleave_panels",
    "dia_spmm",
    "dia_spmm_grouped",
    "dia_spmm_grouped_reference",
    "dia_spmm_reference",
    "dia_spmv",
    "dia_spmv_reference",
    "dia_spmv_resident",
    "dia_spmv_staged",
    "dia_spmv_window",
    "dia_sym_spmm",
    "dia_sym_spmm_reference",
    "dia_sym_spmv",
    "dia_sym_spmv_reference",
    "interleave_panels",
    "pruned_matvec_reference",
    "pruned_spmm",
    "pruned_spmm_reference",
    "pruned_spmv",
    "pruned_sym_matvec_reference",
    "pruned_sym_spmm",
    "pruned_sym_spmm_reference",
    "pruned_sym_spmv",
    "staged_route",
    "window_plan",
]
