"""Conjugate-gradient solvers on torch tensors.

Port of ``cg_solve`` and ``cg_fused_solve`` from
:mod:`sigma_tpu.solvers.krylov`.  The JAX solve is one on-device
``lax.while_loop``; here the loop runs on the host and reads the residual
norm back once per iteration (one device synchronisation each) to apply
the same stopping rule, so iteration counts match the JAX package.  All
vectors stay on the device of ``b``; dot products are ``torch.dot``.

Both take ``A`` and optional ``M`` as LinearOperators (``M`` applies the
*inverse* preconditioner, z = M^{-1} r).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["SolveInfo", "cg_solve", "cg_fused_solve"]


class SolveInfo(NamedTuple):
    iterations: int
    residual_norm: torch.Tensor  # 0-d, b's dtype and device
    converged: bool
    history: Optional[torch.Tensor] = None  # (maxiter,) per-iteration
    # residual norms when the solve was called with history=True (NaN
    # beyond the final iteration); None otherwise


def _identity_apply(x):
    return x


def _apply(M):
    return M.matvec if M is not None else _identity_apply


def _tol_eff(b, tol, rtol):
    """max(tol, rtol * ||b||) in b's dtype (``krylov.py`` stopping rule)."""
    return torch.maximum(
        torch.tensor(tol, dtype=b.dtype, device=b.device),
        rtol * torch.linalg.vector_norm(b),
    )


def cg_solve(
    A, b, x0=None, *, tol=1e-15, rtol=0.0, maxiter=None, M=None, history=False,
    flexible=False,
):
    """Preconditioned conjugate gradients (SPD A).

    Left preconditioning with z = M^{-1} r; the loop runs while
    ``||r|| > max(tol, rtol * ||b||)`` and fewer than ``maxiter`` (default
    10 n) iterations were taken.  ``history=True`` records the residual
    norm after every iteration into ``info.history``.

    ``flexible=True`` uses the Polak-Ribiere beta
    ``z_{k+1}^T (r_{k+1} - r_k) / z_k^T r_k`` (flexible CG), required when
    M is a variable preconditioner.
    """
    n = A.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    maxiter = 10 * n if maxiter is None else int(maxiter)
    apply_M = _apply(M)
    matvec = A.matvec
    tol_eff = _tol_eff(b, tol, rtol)

    r = b - matvec(x)
    z = apply_M(r)
    p = z
    rho = torch.dot(r, z)
    res2 = torch.dot(r, r)
    hist = (
        torch.full((maxiter,), float("nan"), dtype=b.dtype, device=b.device)
        if history
        else None
    )
    k = 0
    while k < maxiter and bool(torch.sqrt(res2) > tol_eff):
        q = matvec(p)
        alpha = rho / torch.dot(p, q)
        x = x + alpha * p
        r_new = r - alpha * q
        z = apply_M(r_new)
        rho_new = torch.dot(r_new, z)
        if flexible:
            beta = torch.dot(z, r_new - r) / rho
        else:
            beta = rho_new / rho
        p = z + beta * p
        r, rho = r_new, rho_new
        res2 = torch.dot(r, r)
        if hist is not None:
            hist[k] = torch.sqrt(res2)
        k += 1
    resn = torch.sqrt(res2)
    return x, SolveInfo(k, resn, bool(resn <= tol_eff), hist)


def cg_fused_solve(
    A, b, x0=None, *, tol=1e-15, rtol=0.0, maxiter=None, M=None, history=False
):
    """Chronopoulos-Gear (single-reduction) preconditioned CG.

    The same Krylov iterates as :func:`cg_solve`, reorganised so one
    iteration is one matvec (on z, the freshest vector), then all dot
    products, then one elementwise block: the search-direction matvec is
    replaced by the recurrence ``s_{k+1} = w_{k+1} + beta s_k`` with
    ``w = A z``.  The first step is steepest descent (alpha = gamma/delta,
    beta = 0); later steps use ``alpha = gamma / (delta - beta gamma /
    alpha_prev)``.
    """
    n = A.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    maxiter = 10 * n if maxiter is None else int(maxiter)
    apply_M = _apply(M)
    matvec = A.matvec
    tol_eff = _tol_eff(b, tol, rtol)

    r = b - matvec(x)
    z = apply_M(r)
    w = matvec(z)
    gamma = torch.dot(r, z)
    delta = torch.dot(w, z)
    res2 = torch.dot(r, r)
    alpha = gamma / delta
    p, s = z, w
    hist = (
        torch.full((maxiter,), float("nan"), dtype=b.dtype, device=b.device)
        if history
        else None
    )
    k = 0
    while k < maxiter and bool(torch.sqrt(res2) > tol_eff):
        x = x + alpha * p
        r = r - alpha * s
        z = apply_M(r)
        w = matvec(z)
        gamma_new = torch.dot(r, z)
        delta = torch.dot(w, z)
        res2 = torch.dot(r, r)
        beta = gamma_new / gamma
        alpha = gamma_new / (delta - beta * gamma_new / alpha)
        gamma = gamma_new
        p = z + beta * p
        s = w + beta * s
        if hist is not None:
            hist[k] = torch.sqrt(res2)
        k += 1
    resn = torch.sqrt(res2)
    return x, SolveInfo(k, resn, bool(resn <= tol_eff), hist)
