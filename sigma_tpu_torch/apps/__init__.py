from sigma_tpu_torch.apps.generators import (
    barabasi_albert,
    erdos_renyi,
    flower_snark,
    hypercube,
    irregular_mesh_laplacian,
    irregular_mesh_laplacian_coo,
    named_graph,
    petersen,
    torus,
    watts_strogatz,
)
from sigma_tpu_torch.apps.ising import ising_metropolis
from sigma_tpu_torch.apps.saw import self_avoiding_walks

__all__ = [
    "torus",
    "petersen",
    "flower_snark",
    "hypercube",
    "erdos_renyi",
    "watts_strogatz",
    "barabasi_albert",
    "irregular_mesh_laplacian",
    "irregular_mesh_laplacian_coo",
    "named_graph",
    "ising_metropolis",
    "self_avoiding_walks",
]
