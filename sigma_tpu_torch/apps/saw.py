"""Self-avoiding walks, all walkers at once.

Port of :mod:`sigma_tpu.apps.saw` (the reference's
``apps/self_avoiding_walk.f90``: from a random start, step to a uniformly
chosen unvisited neighbour until stuck, and histogram the lengths).  The
walks are independent, so they advance together: the state is a
``(walkers, n)`` boolean visited mask, the current vertices, the lengths
and the alive flags, and a step is one batched gather of the current
vertices' ELL rows plus a Gumbel-argmax pick among their unvisited real
slots.  The visited mask takes ``walkers * n`` bytes of device memory
(10,000 walkers on a 512 x 512 torus: 2.6 GB), which is what sizes a run.

The loop runs until no walker is alive or n steps were taken, and reads
that condition back to the host once a step, as the port's Krylov loops
read their residual once an iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sigma_tpu_torch.graph.graph import ELLGraph
from sigma_tpu_torch.utils.device import resolve_device

__all__ = ["SAWResult", "self_avoiding_walks"]


class SAWResult(NamedTuple):
    lengths: torch.Tensor  # (walkers,) int32 steps before each walker got stuck
    histogram: np.ndarray  # (n + 1,) counts of walk lengths


def _run(cols, degrees, starts, gumbel, n: int, max_steps: int):
    """Walk from ``starts`` over the ELL rows ``cols`` (n, width) with
    ``degrees`` real slots each; ``gumbel(shape)`` returns the next
    standard Gumbel draws of that shape on the walkers' device.  Returns
    the (walkers,) int32 lengths."""
    W = starts.shape[0]
    width = cols.shape[1]
    device = starts.device
    walker = torch.arange(W, device=device)
    slot = torch.arange(width, device=device)
    visited = torch.zeros((W, n), dtype=torch.bool, device=device)
    visited[walker, starts] = True
    cur = starts
    lengths = torch.zeros(W, dtype=torch.int32, device=device)
    alive = torch.ones(W, dtype=torch.bool, device=device)
    step = 0
    while step < max_steps and bool(alive.any()):
        nbrs = cols[cur]  # (W, width) candidates
        ok = (slot[None, :] < degrees[cur][:, None]) & ~visited[walker[:, None], nbrs]
        pick = torch.argmax(torch.where(ok, gumbel((W, width)), -torch.inf), dim=1)
        move = alive & ok.any(dim=1)
        cur = torch.where(move, nbrs[walker, pick], cur)
        visited[walker, cur] = True
        lengths += move.to(torch.int32)
        alive = move
        step += 1
    return lengths


def self_avoiding_walks(g, walkers: int = 10000, seed: int = 0, device=None) -> SAWResult:
    """``walkers`` independent self-avoiding walks on the graph ``g`` (any
    format) on ``device`` (None: CUDA): each walker's length and the
    length histogram (the reference's output).  Starts and steps draw
    from a ``torch.Generator`` on the device seeded with ``seed``."""
    device = resolve_device(device)
    n = g.shape[0]
    ell = g if isinstance(g, ELLGraph) else ELLGraph.from_coo(n, n, *g.edges_numpy())
    gen = torch.Generator(device).manual_seed(int(seed))
    tiny = torch.finfo(torch.float32).tiny

    def gumbel(shape):
        u = torch.rand(shape, generator=gen, device=device).clamp_(min=tiny)
        return -torch.log(-torch.log(u))

    starts = torch.randint(0, n, (int(walkers),), generator=gen, device=device)
    lengths = _run(torch.from_numpy(ell.cols).to(device), torch.from_numpy(ell.degrees).to(device),
                   starts, gumbel, int(n), int(n))
    hist = np.bincount(lengths.cpu().numpy(), minlength=n + 1)
    return SAWResult(lengths=lengths, histogram=hist)
