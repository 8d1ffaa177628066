"""Mixed-precision iterative refinement with a fixed number of sweeps.

Port of ``refined_solve_fixed`` of :mod:`sigma_tpu.solvers.refine`:

    repeat sweeps times:  r = b - A x        (working precision)
                          solve A_lo d = r   (inner Krylov, low precision)
                          x = x + d

The canonical use is a bf16-valued ``A_lo`` (``A.astype(torch.bfloat16)``)
with f32 vectors: every inner matvec streams half the value bytes, and
each sweep contracts the error by about max(inner_rtol, the bf16 rounding
of the values).  The JAX package runs the sweeps as one device program to
avoid a host dispatch per step; here the loop is eager either way.

``refined_solve``, the host loop that stops on a working-precision
tolerance, waits.
"""

from __future__ import annotations

import dataclasses

import torch

from sigma_tpu_torch.operators.linear_operator import LinearOperator
from sigma_tpu_torch.solvers.krylov import cg_solve
from sigma_tpu_torch.utils.dtypes import torch_dtype

__all__ = ["refined_solve_fixed"]


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class _DtypePinned(LinearOperator):
    """Preconditioner adapter that casts each application to ``dtype``: a
    working-precision M inside a low-precision inner solve would otherwise
    promote every inner Krylov vector to the working precision."""

    inner: LinearOperator
    dtype: torch.dtype

    @property
    def shape(self):
        return self.inner.shape

    def matvec(self, r):
        return self.inner.matvec(r).to(self.dtype)


def refined_solve_fixed(A, b, A_lo=None, *, sweeps: int = 3, inner_rtol: float = 1e-3,
                        inner_maxiter: int = 200, M=None, inner_solver=cg_solve,
                        inner_dtype=None):
    """Fixed-sweep iterative refinement: returns x only.

    Each sweep scales the working-precision residual to unit norm, solves
    ``A_lo d = r`` with ``inner_solver`` (CG by default; any solver with
    the ``(A, b, *, tol, rtol, maxiter, M) -> (x, info)`` contract) to
    ``inner_rtol``, and adds the rescaled correction.  ``A_lo`` defaults to
    A (or A cast to ``inner_dtype``).  ``inner_dtype`` also casts the inner
    Krylov vectors; ``M`` is the inner preconditioner, dtype-pinned to
    ``inner_dtype`` when that is set.  Without ``inner_dtype`` the inner
    vectors keep b's dtype and only the operator values are low precision.
    On bf16-rounded values that are not exactly representable (random mesh
    weights) the sweeps stall at a residual floor (the JAX package measured
    3-5e-5 at condition number ~1e3); exactly representable values reach
    working precision."""
    if inner_dtype is not None:
        inner_dtype = torch_dtype(inner_dtype)
    if A_lo is None:
        A_lo = A if inner_dtype is None else A.astype(inner_dtype)
    if M is not None and inner_dtype is not None:
        M = _DtypePinned(inner=M, dtype=inner_dtype)
    x = torch.zeros_like(b)
    for _ in range(sweeps):
        r = b - A.matvec(x)
        rn = torch.linalg.vector_norm(r)
        scale = torch.where(rn > 0, rn, torch.ones_like(rn))
        r_lo = r / scale
        if inner_dtype is not None:
            r_lo = r_lo.to(inner_dtype)
        d, _ = inner_solver(A_lo, r_lo, tol=0.0, rtol=inner_rtol, maxiter=inner_maxiter, M=M)
        x = x + scale * d.to(b.dtype)
    return x
