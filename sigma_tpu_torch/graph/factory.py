"""Graph construction and conversion by format name.

Port of :mod:`sigma_tpu.graph.factory`.  Formats are immutable, so a
conversion re-freezes the edge set.  Keyword arguments go to the format's
``from_coo`` (``block_shape`` and ``device`` for ``"bsr"``, whose arrays
are tensors; ``min_width`` for ``"ell"``).
"""

from __future__ import annotations

from typing import Type, Union

from sigma_tpu_torch.graph.builder import GraphBuilder
from sigma_tpu_torch.graph.graph import (
    BSRGraph,
    COOGraph,
    CSCGraph,
    CSRGraph,
    DIAGraph,
    ELLGraph,
    Graph,
)

__all__ = [
    "GRAPH_FORMATS",
    "num_graph_types",
    "choose_graph_type",
    "convert_graph",
    "build_graph",
]

GRAPH_FORMATS: dict[str, Type[Graph]] = {
    "coo": COOGraph,
    "csr": CSRGraph,
    "csc": CSCGraph,
    "ell": ELLGraph,
    "ellpack": ELLGraph,
    "cs": CSRGraph,
    "bsr": BSRGraph,
    "dia": DIAGraph,
}

# "dia" is chosen by name only, not by int code: a DIA topology stores whole
# diagonals, so it cannot round-trip an arbitrary edge set as the five
# pattern-exact formats do.
num_graph_types = 5  # coo, csr, csc, ell, bsr
_BY_INT = ["coo", "csr", "csc", "ell", "bsr"]


def choose_graph_type(frmt: Union[str, int]) -> Type[Graph]:
    if isinstance(frmt, int):
        if not 1 <= frmt <= num_graph_types:
            raise ValueError(f"graph format code {frmt} not in 1..{num_graph_types}")
        frmt = _BY_INT[frmt - 1]
    cls = GRAPH_FORMATS.get(str(frmt).lower())
    if cls is None:
        raise ValueError(
            f"unknown graph format {frmt!r}; choose from {sorted(GRAPH_FORMATS)}"
        )
    return cls


def build_graph(
    source: Union[GraphBuilder, Graph], frmt: Union[str, int] = "csr", **kwargs
) -> Graph:
    """Freeze a builder (or re-freeze a graph) into the named format."""
    cls = choose_graph_type(frmt)
    if isinstance(source, GraphBuilder):
        rows, cols = source.edges()
        return cls.from_coo(source.n, source.m, rows, cols, **kwargs)
    rows, cols = source.edges_numpy()
    return cls.from_coo(source.shape[0], source.shape[1], rows, cols, **kwargs)


def convert_graph(g: Graph, frmt: Union[str, int], **kwargs) -> Graph:
    """Format conversion: re-freeze ``g``'s edges as ``frmt``."""
    return build_graph(g, frmt, **kwargs)
