#!/usr/bin/env python
"""Format conversion and whole-array edge export (after
graph_example_2.f90's iterator/conversion theme).

The reference iterates cursors in batches of 64; here the iterator protocol
is a single vectorized edges_numpy() export, identical across formats.  The
BSR graph's index tensors live on the device.

    python -m sigma_tpu_torch.examples.graphs.graph_example_2 [--device cpu]
"""

import numpy as np

from sigma_tpu_torch import convert_graph
from sigma_tpu_torch.apps import torus
from sigma_tpu_torch.examples._common import cli
from sigma_tpu_torch.utils.device import resolve_device


def main(device=None) -> dict:
    device = resolve_device(device)
    g = torus(8, 8, frmt="csr")
    print("csr:", g)
    out = {"csr": {"shape": tuple(g.shape), "nnz": int(g.nnz)}}
    r1, c1 = g.edges_numpy()
    key1 = np.sort(r1 * g.shape[1] + c1)
    for frmt in ("coo", "ell", "csc", "bsr"):
        h = convert_graph(g, frmt, **({"device": device} if frmt == "bsr" else {}))
        r2, c2 = h.edges_numpy()
        same = np.array_equal(key1, np.sort(r2 * h.shape[1] + c2))
        print(f"{frmt}: {h} edges-preserved={same}")
        out[frmt] = {"shape": tuple(h.shape), "nnz": int(h.nnz), "edges_preserved": bool(same)}
    return out


if __name__ == "__main__":
    main(**cli(__doc__))
