"""Hand-written GPU kernels for the hot SpMV and SpMM paths.

* :mod:`sigma_tpu_torch.ops.spmv_dia` — the DIA (stencil) SpMV kernels,
  full storage and symmetric storage, with their plain PyTorch versions;
  :class:`~sigma_tpu_torch.matrix.formats.DIAMatrix` and
  :class:`~sigma_tpu_torch.matrix.symmetric.SymmetricDIAMatrix` call them
  for every matvec.
* :mod:`sigma_tpu_torch.ops.spmm_dia` — the DIA SpMM kernels (Y = A X for
  up to 16 panels, in the RHS-major, interleaved or column layout) with
  their plain versions and the panel (de-)interleaving; the same classes
  call them for every ``matmat``, ``matmat_rhs_major`` and
  ``matmat_interleaved``.
"""

import torch

from sigma_tpu_torch.ops.spmm_dia import (
    LAYOUTS,
    MAX_PANELS,
    deinterleave_panels,
    dia_spmm,
    dia_spmm_reference,
    dia_sym_spmm,
    dia_sym_spmm_reference,
    interleave_panels,
)
from sigma_tpu_torch.ops.spmv_dia import (
    KERNEL_DTYPES,
    dia_spmv,
    dia_spmv_reference,
    dia_sym_spmv,
    dia_sym_spmv_reference,
)


def cuda_available() -> bool:
    """True when a CUDA device is present: the counterpart of the JAX
    package's ``pallas_supported``.  A gate for callers such as tests and
    scripts only; the kernels themselves route by the device of the tensor
    they are given."""
    return torch.cuda.is_available()


__all__ = [
    "KERNEL_DTYPES",
    "LAYOUTS",
    "MAX_PANELS",
    "cuda_available",
    "deinterleave_panels",
    "dia_spmm",
    "dia_spmm_reference",
    "dia_spmv",
    "dia_spmv_reference",
    "dia_sym_spmm",
    "dia_sym_spmm_reference",
    "dia_sym_spmv",
    "dia_sym_spmv_reference",
    "interleave_panels",
]
