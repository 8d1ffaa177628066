"""Hand-written GPU kernels for the hot SpMV paths.

* :mod:`sigma_tpu_torch.ops.spmv_dia` — the DIA (stencil) SpMV kernels,
  full storage and symmetric storage, with their plain PyTorch versions;
  :class:`~sigma_tpu_torch.matrix.formats.DIAMatrix` and
  :class:`~sigma_tpu_torch.matrix.symmetric.SymmetricDIAMatrix` call them
  for every matvec.
"""

import torch

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
    "cuda_available",
    "dia_spmv",
    "dia_spmv_reference",
    "dia_sym_spmv",
    "dia_sym_spmv_reference",
]
