from sigma_tpu_torch.graph.graph import DIAGraph, Graph
from sigma_tpu_torch.graph.permutations import (
    reverse_cuthill_mckee,
    reverse_cuthill_mckee_reference,
)

__all__ = [
    "DIAGraph",
    "Graph",
    "reverse_cuthill_mckee",
    "reverse_cuthill_mckee_reference",
]
