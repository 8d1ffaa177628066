from sigma_tpu_torch.apps.generators import (
    irregular_mesh_laplacian,
    irregular_mesh_laplacian_coo,
)

__all__ = ["irregular_mesh_laplacian", "irregular_mesh_laplacian_coo"]
