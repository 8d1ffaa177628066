#!/usr/bin/env python
"""Graph basics: build, connectivity, degrees (after the reference's
examples/graphs/graph_example_1.f90).

Constructs an Erdos-Renyi random graph with the mutable builder, freezes
it, and estimates the connection probability from degree statistics.
Graphs are host structures in the port (numpy index arrays, as the
reference's are); the device is resolved all the same, so the example
asks for a card unless given ``--device cpu``.

    python -m sigma_tpu_torch.examples.graphs.graph_example_1 [--device cpu]
"""

import numpy as np

from sigma_tpu_torch import GraphBuilder, build_graph
from sigma_tpu_torch.examples._common import cli
from sigma_tpu_torch.utils.device import resolve_device


def main(device=None) -> dict:
    resolve_device(device)
    rng = np.random.default_rng(0)
    n, p = 512, 0.02

    # mutable stage: add edges one batch at a time (ll_graph idiom)
    b = GraphBuilder(n)
    mask = np.triu(rng.random((n, n)) < p, 1)
    rows, cols = np.nonzero(mask | mask.T)
    b.add_edges(rows, cols)

    # queries on the builder
    out = {"connected_0_1": bool(b.has_edge(0, 1)), "degree_0": int(b.degree(0))}
    print("connected(0, 1):", out["connected_0_1"])
    print("degree(0):", out["degree_0"])

    # freeze into a compute format
    g = build_graph(b, "csr")
    d = g.degrees_numpy()
    est = d.mean() / (n - 1)
    out.update(edges=int(g.num_edges), max_degree=int(g.max_degree), estimated_p=float(est))
    print(f"edges: {g.num_edges}  max degree: {g.max_degree}")
    print(f"estimated p: {est:.4f} (true {p})")
    return out


if __name__ == "__main__":
    main(**cli(__doc__))
