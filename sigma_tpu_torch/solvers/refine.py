"""Mixed-precision iterative refinement.

Port of :mod:`sigma_tpu.solvers.refine`:

    repeat:  r = b - A x        (working precision)
             solve A_lo d = r   (inner Krylov, low precision)
             x = x + d

:func:`refined_solve_fixed` runs a fixed number of sweeps;
:func:`refined_solve` is the host loop that stops on a working-precision
tolerance (one read of the residual norm a sweep).  The canonical uses are
f64 working precision with an f32 inner solve, and a bf16-valued ``A_lo``
with f32 inner vectors: every inner matvec then streams half the value
bytes, and each sweep contracts the error by about max(inner tolerance,
the bf16 rounding of the values).  The JAX package runs the fixed sweeps
as one device program and jit-compiles the inner solve; here both loops
are eager.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from sigma_tpu_torch.operators.linear_operator import LinearOperator
from sigma_tpu_torch.solvers.krylov import SolveInfo, cg_solve
from sigma_tpu_torch.utils.dtypes import torch_dtype

__all__ = ["refined_solve", "refined_solve_fixed"]


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


def refined_solve(A, b, *, tol: float = 1e-12, rtol: float = 0.0, max_outer: int = 20,
                  inner_dtype=torch.float32, inner_solve=None, inner_tol: float = 1e-6,
                  inner_maxiter: int = 400, M_lo=None, A_lo=None, inner_solver=cg_solve):
    """Solve A x = b to the working-precision tolerance ``max(tol, rtol *
    ||b||)`` with low-precision inner solves; returns ``(x, SolveInfo)``
    with ``info.iterations`` the count of outer sweeps.

    Each sweep computes r = b - A x in b's dtype and stops on a residual
    norm at the tolerance or not finite; otherwise it scales r to unit
    norm (an unscaled f32 inner solve underflows its inner products once
    ||r|| falls below ~1e-12), casts it to ``inner_dtype``, solves and adds
    the rescaled correction.  The inner solve is ``inner_solve(r_lo) ->
    d_lo`` if given, else ``inner_solver`` (CG by default; pass
    ``bicgstab_solve`` or ``gmres_solve`` for a nonsymmetric A) on
    ``A_lo`` to ``inner_tol`` with ``M_lo``.  ``A_lo`` defaults to
    ``A.astype(inner_dtype)`` and is independent of the inner vector dtype:
    a bf16-valued ``A_lo`` with f32 vectors streams half the value bytes."""
    work_dtype = b.dtype
    inner_dtype = torch_dtype(inner_dtype)
    if inner_solve is None:
        if A_lo is None:
            A_lo = A.astype(inner_dtype)

        def inner_solve(r_lo):
            return inner_solver(A_lo, r_lo, tol=0.0, rtol=inner_tol, maxiter=inner_maxiter,
                                M=M_lo)[0]

    x = torch.zeros_like(b)
    tol_eff = max(tol, rtol * float(torch.linalg.vector_norm(b)))
    k = 0
    for k in range(1, max_outer + 1):
        r = b - A.matvec(x)  # working precision
        resn = float(torch.linalg.vector_norm(r))
        if not math.isfinite(resn) or resn <= tol_eff:
            break
        d = inner_solve((r / resn).to(inner_dtype))
        x = x + resn * d.to(work_dtype)
    else:
        resn = float(torch.linalg.vector_norm(b - A.matvec(x)))
    return x, SolveInfo(k, torch.tensor(resn, dtype=work_dtype, device=b.device),
                        resn <= tol_eff)
