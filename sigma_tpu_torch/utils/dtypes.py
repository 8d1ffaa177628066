"""Dtype policy helpers.

Everything in sigma_tpu_torch is dtype-generic; these helpers only pick
defaults and translate between numpy and torch dtypes.  The default real
dtype is float32 unless the caller gives one (the JAX package keys its
default off ``jax_enable_x64``; torch has no such global switch here).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "index_dtype",
    "default_real_dtype",
    "round_up",
    "torch_dtype",
    "to_numpy",
]

# Index dtype: int64.  Flat DIA positions ``d * stride + i`` pass 2**31 on
# wide bands at the 10M-row scale, so GPU-side offsets are 64-bit.
index_dtype = torch.int64


def default_real_dtype() -> torch.dtype:
    return torch.float32


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype for a torch or numpy dtype (or numpy type name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy of a tensor; bfloat16 (which numpy lacks) widens
    exactly to float32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
