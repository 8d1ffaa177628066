#!/usr/bin/env python
"""Greedy coloring and the multicolor ordering (after graph_example_4.f90;
permutations.f90:83,167) — the seam that parallelizes triangular sweeps
and Metropolis dynamics on the card.

    python -m sigma_tpu_torch.examples.graphs.graph_example_4 [--device cpu]
"""

import numpy as np

from sigma_tpu_torch import greedy_color_ordering, greedy_coloring
from sigma_tpu_torch.apps import torus
from sigma_tpu_torch.examples._common import cli
from sigma_tpu_torch.utils.device import resolve_device


def main(device=None) -> dict:
    resolve_device(device)
    g = torus(16, 16)
    colors, nc = greedy_coloring(g)
    print(f"colors: {nc} (a torus is 2-colorable: checkerboard)")

    p, ptr = greedy_color_ordering(g)
    sizes = np.diff(ptr)
    print("color block sizes:", sizes)

    # within a color block, no two vertices are adjacent
    rows, cols = g.edges_numpy()
    same_color = colors[rows] == colors[cols]
    off_diag = rows != cols
    conflicts = int((same_color & off_diag).sum())
    print("conflicting edges:", conflicts)
    return {"colors": int(nc), "color_block_sizes": [int(s) for s in sizes],
            "conflicting_edges": conflicts}


if __name__ == "__main__":
    main(**cli(__doc__))
