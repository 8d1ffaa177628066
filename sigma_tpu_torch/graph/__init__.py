from sigma_tpu_torch.graph.graph import COOGraph, CSRGraph, DIAGraph, Graph
from sigma_tpu_torch.graph.permutations import (
    reverse_cuthill_mckee,
    reverse_cuthill_mckee_reference,
)

__all__ = [
    "COOGraph",
    "CSRGraph",
    "DIAGraph",
    "Graph",
    "reverse_cuthill_mckee",
    "reverse_cuthill_mckee_reference",
]
