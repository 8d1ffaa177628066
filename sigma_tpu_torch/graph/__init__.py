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
    compress_coo,
)
from sigma_tpu_torch.graph.permutations import (
    breadth_first_search,
    breadth_first_search_reference,
    greedy_color_ordering,
    greedy_coloring,
    greedy_coloring_reference,
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
    "breadth_first_search",
    "breadth_first_search_reference",
    "build_graph",
    "choose_graph_type",
    "compress_coo",
    "convert_graph",
    "greedy_color_ordering",
    "greedy_coloring",
    "greedy_coloring_reference",
    "num_graph_types",
    "reverse_cuthill_mckee",
    "reverse_cuthill_mckee_reference",
]
