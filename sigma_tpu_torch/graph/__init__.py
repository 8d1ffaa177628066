from sigma_tpu_torch.graph.graph import DIAGraph, Graph

__all__ = ["DIAGraph", "Graph"]
