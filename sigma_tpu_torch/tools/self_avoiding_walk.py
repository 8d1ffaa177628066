#!/usr/bin/env python3
"""Self-avoiding walk driver (the flags of the reference's
``apps/self_avoiding_walk.f90``).

    python -m sigma_tpu_torch.tools.self_avoiding_walk [--graph torus]
        [--n 32] [--k 4] [--p 0.25] [--iter 10000] [--seed 0] [--verbose]
        [--device cuda]

Builds the named graph family in ELL format from ``default_rng(seed)``,
runs ``--iter`` walks with ``self_avoiding_walks``, its tensors on
``--device`` (default CUDA), and prints the mean
and longest length, then each length that occurred with its count, as the
JAX package's ``apps/self_avoiding_walk.py`` does.
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", "-g", default="torus")
    ap.add_argument("--n", "-n", type=int, default=32)
    ap.add_argument("--k", "-k", type=int, default=4)
    ap.add_argument("--p", "-p", type=float, default=0.25)
    ap.add_argument("--iter", "-i", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", "-v", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from sigma_tpu_torch.apps import named_graph, self_avoiding_walks

    rng = np.random.default_rng(args.seed)
    g = named_graph(args.graph, args.n, args.k, args.p, rng, frmt="ell")
    if args.verbose:
        print(f"graph: {args.graph}, {g.shape[0]} vertices, {g.nnz} edges")

    res = self_avoiding_walks(g, walkers=args.iter, seed=args.seed, device=args.device)
    lengths = res.lengths.cpu().numpy()
    print(f"walks: {args.iter}  mean length: {lengths.mean():.2f}  max: {lengths.max()}")
    for length in np.nonzero(res.histogram)[0]:
        print(length, int(res.histogram[length]))


if __name__ == "__main__":
    main()
