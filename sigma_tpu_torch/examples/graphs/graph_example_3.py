#!/usr/bin/env python
"""Bandwidth reduction by BFS (Cuthill-McKee-style) reordering (after
graph_example_3.f90's permutation theme; permutations.f90:22).  The
ordering runs in the port's host library.

    python -m sigma_tpu_torch.examples.graphs.graph_example_3 [--device cpu]
"""

import numpy as np

from sigma_tpu_torch import breadth_first_search
from sigma_tpu_torch.apps import watts_strogatz
from sigma_tpu_torch.examples._common import cli
from sigma_tpu_torch.utils.device import resolve_device


def bandwidth(g):
    rows, cols = g.edges_numpy()
    return int(np.abs(rows - cols).max()) if rows.size else 0


def main(device=None) -> dict:
    resolve_device(device)
    rng = np.random.default_rng(1)
    g = watts_strogatz(256, 3, 0.05, rng)
    out = {"original_bandwidth": bandwidth(g)}
    print("original bandwidth:", out["original_bandwidth"])
    p = breadth_first_search(g)
    h = g.permute_rows(p).permute_cols(p)
    out["bfs_bandwidth"] = bandwidth(h)
    print("BFS-reordered bandwidth:", out["bfs_bandwidth"])
    return out


if __name__ == "__main__":
    main(**cli(__doc__))
