"""Chebyshev polynomial smoother / preconditioner.

Port of :mod:`sigma_tpu.solvers.chebyshev`: the classic three-term
Chebyshev iteration targeting the eigenvalue interval ``[lmin, lmax]``
(for smoothing, ``[lmax/alpha, lmax]`` with alpha ~ 4-30 damps the high end
only).  One application is ``degree - 1`` matvecs and axpys with no inner
products.  The interval's scalars are Python floats (or 0-d tensors from
:func:`estimate_lmax`), so the recurrence's coefficients are host
arithmetic and every vector keeps the residual's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sigma_tpu_torch.operators.linear_operator import LinearOperator
from sigma_tpu_torch.utils.device import resolve_device

__all__ = ["ChebyshevSmoother", "chebyshev", "estimate_lmax"]


def estimate_lmax(A: LinearOperator, iters: int = 20, generator: Optional[torch.Generator] = None,
                  safety: float = 1.05):
    """Largest-eigenvalue estimate by ``iters`` power iterations from a
    normal start vector drawn with ``generator`` (default: one seeded with
    0 on A's device, or on CUDA for an operator that holds no tensors, as
    the JAX package's ``PRNGKey(0)``; the two draw different numbers),
    times ``safety``; a 0-d tensor."""
    n = A.shape[0]
    device = A.device if A.device is not None else resolve_device(None)
    dtype = getattr(A, "dtype", torch.float32)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    v = torch.randn(n, generator=generator, dtype=dtype, device=device)
    v = v / torch.linalg.vector_norm(v)
    lam = torch.zeros((), dtype=dtype, device=device)
    tiny = torch.finfo(dtype).tiny
    for _ in range(iters):
        w = A.matvec(v)
        lam = torch.linalg.vector_norm(w)
        v = w / lam.clamp_min(tiny)
    return lam * safety


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class ChebyshevSmoother(LinearOperator):
    """Applies z = p(A) r with p the degree-``degree`` Chebyshev polynomial
    approximating A^{-1} on [lmin, lmax].  Use as ``M=`` anywhere; it is a
    fixed linear operator, but flexible CG is the safe pairing when the
    interval does not enclose the spectrum."""

    op: LinearOperator
    lmin: float
    lmax: float
    degree: int = 4

    @property
    def shape(self):
        return self.op.shape

    def matvec(self, r):
        theta = 0.5 * (self.lmax + self.lmin)
        delta = 0.5 * (self.lmax - self.lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        # three-term recurrence on the correction z (x0 = 0)
        z = r / theta
        prev_z = torch.zeros_like(r)
        for _ in range(self.degree - 1):
            rho_next = 1.0 / (2.0 * sigma - rho)
            resid = r - self.op.matvec(z)
            z, prev_z = rho_next * (2.0 * resid / delta + rho * (z - prev_z)) + z, z
            rho = rho_next
        return z

    def rmatvec(self, r):
        """p(A^T) r: the transposed operator's matvecs (equal to
        :meth:`matvec` for a symmetric A)."""
        return ChebyshevSmoother(op=self.op.T, lmin=self.lmin, lmax=self.lmax,
                                 degree=self.degree).matvec(r)


def chebyshev(A: LinearOperator, degree: int = 4, lmax=None, lmin=None,
              smoothing_fraction: float = 1.0 / 30.0,
              generator: Optional[torch.Generator] = None) -> ChebyshevSmoother:
    """Build a Chebyshev smoother for A.

    Defaults: ``lmax`` is the Gershgorin bound (the largest absolute row
    sum) when the operator exposes its triples (``entries()``), since a
    power-iteration underestimate lets modes above the interval grow; for
    matvec-only operators it is :func:`estimate_lmax` with a 1.25 safety
    margin.  ``lmin = smoothing_fraction * lmax``.  A wide DIA band's
    ``entries()`` enumerates every slot, so pass ``lmax`` there (for
    example the value rows' absolute sums, ``A.data.abs().sum(0).max()``).
    Pass both bounds to target the whole spectrum as a solver-grade
    polynomial preconditioner."""
    if lmax is None:
        if hasattr(A, "entries"):
            r, _c, v = A.entries()
            rs = np.bincount(np.asarray(r), weights=np.abs(np.asarray(v, np.float64)),
                             minlength=A.shape[0])
            lmax = float(rs.max()) if rs.size else 1.0
        else:
            lmax = estimate_lmax(A, generator=generator, safety=1.25)
    lmin = lmin if lmin is not None else smoothing_fraction * lmax
    return ChebyshevSmoother(op=A, lmin=lmin, lmax=lmax, degree=int(degree))
