from sigma_tpu_torch.graph.builder import GraphBuilder
from sigma_tpu_torch.graph.factory import (
    GRAPH_FORMATS,
    build_graph,
    choose_graph_type,
    convert_graph,
    num_graph_types,
)
from sigma_tpu_torch.graph.graph import (
    BSRGraph,
    COOGraph,
    CSCGraph,
    CSRGraph,
    DIAGraph,
    ELLGraph,
    Graph,
)
from sigma_tpu_torch.graph.permutations import (
    reverse_cuthill_mckee,
    reverse_cuthill_mckee_reference,
)

__all__ = [
    "BSRGraph",
    "COOGraph",
    "CSCGraph",
    "CSRGraph",
    "DIAGraph",
    "ELLGraph",
    "GRAPH_FORMATS",
    "Graph",
    "GraphBuilder",
    "build_graph",
    "choose_graph_type",
    "convert_graph",
    "num_graph_types",
    "reverse_cuthill_mckee",
    "reverse_cuthill_mckee_reference",
]
