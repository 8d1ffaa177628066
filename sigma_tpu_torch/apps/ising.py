"""The Ising model by multicolour Metropolis sweeps.

Port of :mod:`sigma_tpu.apps.ising` (the reference's ``apps/ising.f90``:
single-site Metropolis sweeps over a graph, the magnetization reported
after each sweep).  Sites of one colour of a greedy colouring are never
neighbours, so updating all of them at once is a valid Metropolis step.
One sweep is, for each colour c:

    h = A s                   (ELL product with a matrix of ones: the local fields)
    dE = 2 s h
    flip the sites of colour c where U < exp(-beta dE)

with one uniform draw per site (all n sites, every colour), as the JAX
package draws them.  The spins stay on the device for all sweeps; the
per-sweep mean spins are stacked there and read once at the end.  The
ELL product is a gather and a row sum in plain PyTorch, as it is plain
``jnp`` in the JAX package (which has no kernel for it).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sigma_tpu_torch.graph.graph import ELLGraph
from sigma_tpu_torch.graph.permutations import greedy_coloring
from sigma_tpu_torch.matrix.formats import ELLMatrix
from sigma_tpu_torch.utils.device import resolve_device

__all__ = ["IsingResult", "ising_metropolis"]


class IsingResult(NamedTuple):
    spins: torch.Tensor  # (n,) final +-1 configuration, float32
    magnetization: torch.Tensor  # (sweeps,) mean spin after each sweep
    num_colors: int


def _ones_ell(g, device) -> ELLMatrix:
    """The adjacency of ``g`` as an ELL matrix of float32 ones (0 in the
    padding slots) on ``device``."""
    n = g.shape[0]
    ell = g if isinstance(g, ELLGraph) else ELLGraph.from_coo(n, n, *g.edges_numpy())
    valid = np.arange(ell.width)[None, :] < ell.degrees[:, None]
    return ELLMatrix.from_graph(
        ell, data=torch.from_numpy(valid).to(device=device, dtype=torch.float32), device=device)


def _spins0(n, hot_start: bool, draw, device):
    """The start: all spins up, or (hot) -1 where ``draw(n) < 0.5``."""
    if hot_start:
        return torch.where(draw(n) < 0.5, -1.0, 1.0).to(torch.float32)
    return torch.ones(n, dtype=torch.float32, device=device)


def _run(A, colors, beta, spins0, draw, sweeps: int, n_colors: int):
    """``sweeps`` multicolour sweeps from ``spins0``; ``draw(n)`` returns
    the next n uniform numbers in [0, 1) on the spins' device.  Returns
    the final spins and the (sweeps,) mean spins."""
    n = spins0.shape[0]
    beta = torch.as_tensor(beta, dtype=spins0.dtype, device=spins0.device)
    spins = spins0
    inv_n = torch.tensor(1.0 / n, dtype=spins0.dtype)
    mags = []
    for _ in range(sweeps):
        for c in range(n_colors):
            dE = 2.0 * spins * A.matvec(spins)
            accept = draw(n) < torch.exp(-beta * dE)
            spins = torch.where((colors == c) & accept, -spins, spins)
        # the sum of n <= 2**24 spins is exact in float32; times the
        # float32 1/n, as XLA computes the JAX package's mean
        mags.append(spins.sum() * inv_n)
    return spins, torch.stack(mags) if mags else spins.new_zeros(0)


def ising_metropolis(
    g, beta: float = 1.0, sweeps: int = 100, seed: int = 0, hot_start: bool = False,
    device=None,
) -> IsingResult:
    """``sweeps`` multicolour Metropolis sweeps of the Ising model on the
    graph ``g`` (any format) at inverse temperature ``beta``, on
    ``device`` (None: CUDA).  ``hot_start=False`` starts from all spins
    up, as the reference does (``ising.f90:131-137``); ``hot_start=True``
    from a fair coin per site.  The draws come from a
    ``torch.Generator`` on the device seeded with ``seed`` (the JAX
    package's threefry stream is not reproducible in torch; the same seed
    on the same device gives the same run)."""
    device = resolve_device(device)
    n = g.shape[0]
    colors, n_colors = greedy_coloring(g)
    A = _ones_ell(g, device)
    gen = torch.Generator(device).manual_seed(int(seed))

    def draw(k):
        return torch.rand(k, generator=gen, device=device)

    spins, mags = _run(A, torch.from_numpy(colors).to(device), float(beta),
                       _spins0(n, hot_start, draw, device), draw, int(sweeps), int(n_colors))
    return IsingResult(spins=spins, magnetization=mags, num_colors=int(n_colors))
