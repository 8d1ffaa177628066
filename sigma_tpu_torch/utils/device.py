"""The device a constructor builds on.

Entry points that make tensors from host data (COO triples, numpy arrays,
a grid size) build on the card unless the caller asks for another device:
``device=None`` means CUDA.  The CPU runs the kernels' plain versions and
is used only when asked for, as the tests do with ``device="cpu"``.
Operations on tensors that exist already route by those tensors' device.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; None means CUDA, and raises
    when there is no CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device; pass device="cpu" to run the plain versions')
    return torch.device("cuda")
