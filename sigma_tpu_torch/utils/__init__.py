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
    "round_up",
    "to_numpy",
    "torch_dtype",
]
