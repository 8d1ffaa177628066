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
* :mod:`sigma_tpu_torch.ops.givens` — GMRES's scalar tail of one Arnoldi
  step, the CGS2 column's assembly and breakdown test and the Givens
  update, in one one-warp launch (no Pallas kernel: the device form of the
  JAX package's ``_cgs2_column`` tail and ``_givens_update``) with its
  plain version; every GMRES and FGMRES step calls it.
* :mod:`sigma_tpu_torch.ops.ildu_sweep` — ILDU's level-scheduled
  triangular sweep, one cooperative launch a sweep (no Pallas kernel: the
  device form of the JAX package's ``fori_loop`` over the levels in
  ``TriangularLevels.solve`` and the block ILDU's ``shard_map`` sweep) with
  its plain version; every ILDU, ILU(k) and block-ILDU apply calls it.
"""

import torch

from sigma_tpu_torch.ops.bsr_grouped import (
    BSR_KERNEL_DTYPES,
    GroupedBSR,
    bsr_group_pointer,
    bsr_grouped_form,
    bsr_grouped_spmv,
    bsr_grouped_spmv_reference,
)
from sigma_tpu_torch.ops.givens import (
    empty_warp,
    givens_small_dtype,
    givens_update,
    givens_update_reference,
)
from sigma_tpu_torch.ops.ildu_sweep import (
    level_sweep,
    level_sweep_blocks,
    level_sweep_reference,
    level_sweep_slot_order,
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


# every wrapper that counts its kernel launches in ``launches`` (the SpMMs
# also per panel layout, in ``launches_by_layout``)
COUNTED = (
    "dia_spmv", "dia_sym_spmv", "dia_spmv_resident", "dia_spmv_window", "dia_spmm",
    "dia_sym_spmm", "dia_spmm_grouped", "pruned_spmv", "pruned_sym_spmv", "pruned_spmm",
    "pruned_sym_spmm", "bsr_grouped_spmv", "givens_update", "level_sweep",
)


def launch_counts() -> dict:
    """Every counted wrapper's launches: ``{name: (launches, {layout:
    launches})}``, the layouts empty for a wrapper that keeps none."""
    g = globals()
    return {k: (g[k].launches, dict(getattr(g[k], "launches_by_layout", {}))) for k in COUNTED}


def launch_difference(after: dict, before: dict) -> dict:
    """The launches between two :func:`launch_counts` snapshots."""
    return {k: (n - before[k][0], {lay: c - before[k][1][lay] for lay, c in by.items()})
            for k, (n, by) in after.items()}


def add_launch_counts(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a :func:`launch_difference`) to the
    wrappers' counts: how a replayed CUDA graph, which runs no Python,
    keeps them equal to the launches its kernels made."""
    g = globals()
    for k, (n, by) in delta.items():
        g[k].launches += n * times
        for lay, c in by.items():
            g[k].launches_by_layout[lay] += c * times


def cuda_available() -> bool:
    """True when a CUDA device is present: the counterpart of the JAX
    package's ``pallas_supported``.  A gate for callers such as tests and
    scripts only; the kernels themselves route by the device of the tensor
    they are given."""
    return torch.cuda.is_available()


__all__ = [
    "BSR_KERNEL_DTYPES",
    "COUNTED",
    "GROUPED_LAYOUTS",
    "GroupedBSR",
    "KERNEL_DTYPES",
    "LAYOUTS",
    "MAX_PANELS",
    "PRUNED_LAYOUTS",
    "PrunedPlan",
    "STAGED_SMEM_BYTES",
    "add_launch_counts",
    "bsr_group_pointer",
    "bsr_grouped_form",
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
    "empty_warp",
    "givens_small_dtype",
    "givens_update",
    "givens_update_reference",
    "interleave_panels",
    "launch_counts",
    "launch_difference",
    "level_sweep",
    "level_sweep_blocks",
    "level_sweep_reference",
    "level_sweep_slot_order",
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
