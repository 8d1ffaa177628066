from sigma_tpu_torch.utils.device import resolve_device
from sigma_tpu_torch.utils.dtypes import (
    default_real_dtype,
    index_dtype,
    round_up,
    to_numpy,
    torch_dtype,
)

__all__ = [
    "default_real_dtype",
    "index_dtype",
    "resolve_device",
    "round_up",
    "to_numpy",
    "torch_dtype",
]
