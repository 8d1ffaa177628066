"""Solver objects: frozen configs wrapping the functional Krylov solvers.

Port of :mod:`sigma_tpu.solvers.base`.  The factories ``cg(tolerance)``,
``bicgstab(tolerance)``, ``gmres(...)``, ``cgls(...)`` and ``jacobi()``
return solver objects with the ``setup`` / ``solve`` / ``solve_info``
contract.  There is no class distinction between solvers and
preconditioners: anything with ``setup(A) -> LinearOperator applying
M^{-1}`` can precondition anything else.

Solver objects are frozen dataclasses of configuration only; ``setup``
makes the preconditioner's tensors on A's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sigma_tpu_torch.operators.linear_operator import (
    AdjointOperator,
    DiagonalOperator,
    LinearOperator,
)
from sigma_tpu_torch.solvers.krylov import (
    SolveInfo,
    bicgstab_solve,
    cg_solve,
    cgls_solve,
    gmres_solve,
)

__all__ = [
    "BiCGStabSolver",
    "CGLSSolver",
    "CGSolver",
    "GMRESSolver",
    "JacobiSolver",
    "LinearSolver",
    "bicgstab",
    "cg",
    "cgls",
    "gmres",
    "jacobi",
    "prepare_preconditioner",
]


def prepare_preconditioner(M, A) -> Optional[LinearOperator]:
    """Accept a LinearOperator (applies M^{-1} directly) or a solver-like
    object with ``setup``; returns an operator or None."""
    if M is None:
        return None
    if isinstance(M, LinearOperator):
        return M
    if hasattr(M, "setup"):
        return M.setup(A)
    raise TypeError(f"cannot use {M!r} as a preconditioner")


class LinearSolver:
    """Abstract solver: ``solve(A, b, x0=None, M=None)`` returns x;
    ``solve_info`` also returns the :class:`SolveInfo`."""

    def solve(self, A, b, x0=None, M=None):
        return self.solve_info(A, b, x0=x0, M=M)[0]

    def solve_info(self, A, b, x0=None, M=None):
        raise NotImplementedError

    def setup(self, A) -> LinearOperator:
        """Any solver can serve as a preconditioner: the returned operator
        applies z = (approximate A^{-1}) r by running this solver.  A
        truncated inner Krylov solve is a variable operator, so the outer
        solver should be flexible (``cg_solve(..., flexible=True)``,
        :func:`~sigma_tpu_torch.solvers.krylov.fgmres_solve`)."""
        return _SolverApply(op=A, config=self)


def _normalised_solve(config, op, r):
    """config.solve(op, r / ||r||) * ||r||, and 0 for r = 0: the inner
    solver's absolute tolerance then acts relatively (a shrinking outer
    residual would otherwise satisfy it at x0 = 0 and make z = 0)."""
    nrm = torch.linalg.vector_norm(r)
    safe = torch.clamp(nrm, min=torch.finfo(r.dtype).tiny)
    z = config.solve(op, r / safe)
    return torch.where(nrm > 0, z * safe, torch.zeros_like(z))


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class _SolverApply(LinearOperator):
    """z = M^{-1} r as an inner solve (nested-Krylov preconditioner); the
    right-hand side is normalised before the inner solve."""

    op: LinearOperator
    config: LinearSolver

    @property
    def shape(self):
        return self.op.shape

    def matvec(self, r):
        return _normalised_solve(self.config, self.op, r)

    def rmatvec(self, r):
        # the adjoint preconditioner solves against A^T
        return _normalised_solve(self.config, AdjointOperator(self.op), r)


@dataclasses.dataclass(frozen=True)
class CGSolver(LinearSolver):
    """Conjugate gradients (factory :func:`cg`)."""

    tolerance: float = 1e-15
    rtol: float = 0.0
    maxiter: Optional[int] = None

    def solve_info(self, A, b, x0=None, M=None):
        M = prepare_preconditioner(M, A)
        return cg_solve(A, b, x0, tol=self.tolerance, rtol=self.rtol, maxiter=self.maxiter, M=M)


@dataclasses.dataclass(frozen=True)
class BiCGStabSolver(LinearSolver):
    """BiCG-stab (factory :func:`bicgstab`)."""

    tolerance: float = 1e-12
    rtol: float = 0.0
    maxiter: Optional[int] = None

    def solve_info(self, A, b, x0=None, M=None):
        M = prepare_preconditioner(M, A)
        return bicgstab_solve(A, b, x0, tol=self.tolerance, rtol=self.rtol,
                              maxiter=self.maxiter, M=M)


@dataclasses.dataclass(frozen=True)
class GMRESSolver(LinearSolver):
    """Restarted GMRES (factory :func:`gmres`)."""

    tolerance: float = 1e-12
    rtol: float = 0.0
    restart: int = 32
    maxiter: Optional[int] = None

    def solve_info(self, A, b, x0=None, M=None):
        M = prepare_preconditioner(M, A)
        return gmres_solve(A, b, x0, tol=self.tolerance, rtol=self.rtol, restart=self.restart,
                           maxiter=self.maxiter, M=M)


@dataclasses.dataclass(frozen=True)
class CGLSSolver(LinearSolver):
    """Least-squares CG on the normal equations (factory :func:`cgls`):
    ``solve`` returns the minimiser of ||b - A x||; the tolerance applies
    to ||A^T r||."""

    tolerance: float = 1e-12
    rtol: float = 0.0
    maxiter: Optional[int] = None

    def solve_info(self, A, b, x0=None, M=None):
        M = prepare_preconditioner(M, A)
        return cgls_solve(A, b, x0, tol=self.tolerance, rtol=self.rtol, maxiter=self.maxiter,
                          M=M)


@dataclasses.dataclass(frozen=True)
class JacobiSolver(LinearSolver):
    """Diagonal (Jacobi) preconditioner and solver: ``setup`` stores
    1 / A_ii, and ``solve`` is one diagonal scaling D^{-1} b; use
    :func:`~sigma_tpu_torch.solvers.krylov.stationary_solve` for the
    Richardson iteration."""

    def setup(self, A) -> LinearOperator:
        if hasattr(A, "diagonal"):
            d = A.diagonal()
        else:
            d = torch.tensor([A.get_value(i, i) for i in range(A.shape[0])],
                             dtype=torch.float64, device=A.device)
        # zero diagonals (padded rows) pass through unscaled instead of
        # poisoning the solve with inf
        safe = torch.where(d != 0, d, torch.ones_like(d))
        return DiagonalOperator(1.0 / safe)

    def solve_info(self, A, b, x0=None, M=None):
        x = self.setup(A).matvec(b)
        rn = torch.linalg.vector_norm(b - A.matvec(x))
        return x, SolveInfo(1, rn, bool(torch.isfinite(rn)))


def cg(tolerance: float = 1e-15, rtol: float = 0.0, maxiter=None) -> CGSolver:
    return CGSolver(tolerance=tolerance, rtol=rtol, maxiter=maxiter)


def bicgstab(tolerance: float = 1e-12, rtol: float = 0.0, maxiter=None) -> BiCGStabSolver:
    return BiCGStabSolver(tolerance=tolerance, rtol=rtol, maxiter=maxiter)


def gmres(tolerance: float = 1e-12, rtol: float = 0.0, restart: int = 32,
          maxiter=None) -> GMRESSolver:
    return GMRESSolver(tolerance=tolerance, rtol=rtol, restart=restart, maxiter=maxiter)


def cgls(tolerance: float = 1e-12, rtol: float = 0.0, maxiter=None) -> CGLSSolver:
    return CGLSSolver(tolerance=tolerance, rtol=rtol, maxiter=maxiter)


def jacobi() -> JacobiSolver:
    return JacobiSolver()
