"""Small utilities: port of :mod:`sigma_tpu.utils.util` (the reference's
``util.f90``).

* :func:`order` (``order:18``): the stable sorting permutation.
* :func:`determinant` (``determinant:49``): through
  ``torch.linalg.slogdet`` (LU with partial pivoting).
* :func:`init_seed` (``init_seed:72``): a seeded ``torch.Generator`` on a
  device, clock-seeded when no seed is given.  Random draws in the port
  come from such an explicit generator; nothing seeds a global stream.

The JAX package's ``enable_transparent_hugepages`` and
``enable_warm_heap`` are workarounds for its TPU host's page faults on
fresh large allocations; they tune that machine, not the library, and are
left out here.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sigma_tpu_torch.utils.device import resolve_device

__all__ = ["determinant", "init_seed", "order"]


def order(x) -> np.ndarray:
    """Stable sorting permutation p with x[p] ascending."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.argsort(np.asarray(x), kind="stable")


def determinant(A) -> float:
    """Determinant of a square array or tensor, as sign * exp(log|det|)."""
    A = A if isinstance(A, torch.Tensor) else torch.from_numpy(np.asarray(A, dtype=np.float64))
    sign, logabs = torch.linalg.slogdet(A)
    return float(sign * torch.exp(logabs))


def init_seed(seed: int | None = None, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (None: CUDA) seeded with
    ``seed``; clock-seeded when ``seed`` is None."""
    if seed is None:
        seed = time.time_ns() % (2**31)
    return torch.Generator(resolve_device(device)).manual_seed(int(seed))
