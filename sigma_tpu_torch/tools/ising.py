#!/usr/bin/env python3
"""Ising model driver (the flags of the reference's ``apps/ising.f90``).

    python -m sigma_tpu_torch.tools.ising [--graph torus] [--n 32] [--k 4]
        [--p 0.25] [--beta 1.0] [--sweeps 100] [--seed 0] [--verbose]
        [--device cuda]

Builds the named graph family in ELL format from ``default_rng(seed)``,
runs ``ising_metropolis`` with its tensors on ``--device`` (default CUDA)
and prints the sweep index and the magnetization every
``sweeps // 20`` sweeps, then the final magnetization, as the JAX
package's ``apps/ising.py`` does.
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", "-g", default="torus")
    ap.add_argument("--n", "-n", type=int, default=32)
    ap.add_argument("--k", "-k", type=int, default=4)
    ap.add_argument("--p", "-p", type=float, default=0.25)
    ap.add_argument("--beta", "-b", type=float, default=1.0)
    ap.add_argument("--sweeps", "-i", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", "-v", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from sigma_tpu_torch.apps import ising_metropolis, named_graph

    rng = np.random.default_rng(args.seed)
    g = named_graph(args.graph, args.n, args.k, args.p, rng, frmt="ell")
    if args.verbose:
        print(f"graph: {args.graph}, {g.shape[0]} vertices, {g.nnz} edges")

    res = ising_metropolis(g, beta=args.beta, sweeps=args.sweeps, seed=args.seed,
                           device=args.device)
    if args.verbose:
        print(f"multicolor sweep: {res.num_colors} colors")
    mags = res.magnetization.cpu().numpy()
    stride = max(1, args.sweeps // 20)
    for s in range(0, args.sweeps, stride):
        print(s + 1, float(mags[s]))
    print(f"final magnetization: {float(mags[-1]):.6f}")


if __name__ == "__main__":
    main()
