"""Krylov solvers on torch tensors.

Port of ``cg_solve``, ``cg_fused_solve``, ``bicgstab_solve`` and
``block_cg_solve`` from :mod:`sigma_tpu.solvers.krylov`.  The JAX solve is one on-device
``lax.while_loop``; here the loop runs on the host and reads the residual
norm back once per iteration (one device synchronisation each) to apply
the same stopping rule, so iteration counts match the JAX package.  All
vectors stay on the device of ``b``; dot products are ``torch.dot``.

All take ``A`` and optional ``M`` as LinearOperators (``M`` applies the
*inverse* preconditioner, z = M^{-1} r).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

__all__ = ["SolveInfo", "bicgstab_solve", "block_cg_solve", "cg_solve", "cg_fused_solve"]


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


def bicgstab_solve(
    A, b, x0=None, *, tol=1e-12, rtol=0.0, maxiter=None, M=None, history=False
):
    """Preconditioned BiCG-stab for nonsymmetric A.

    The shadow residual is the initial residual; the loop runs while
    ``||r|| > max(tol, rtol * ||b||)`` and fewer than ``maxiter`` (default
    10 n) iterations were taken.  A non-finite omega (t = A M^{-1} s = 0,
    the method's breakdown) becomes 0, as in the reference.
    ``history=True`` records the residual norm after every iteration.
    """
    n = A.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    maxiter = 10 * n if maxiter is None else int(maxiter)
    apply_M = _apply(M)
    matvec = A.matvec
    tol_eff = _tol_eff(b, tol, rtol)

    r = b - matvec(x)
    rhat = r
    p = v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    resn = torch.linalg.vector_norm(r)
    hist = (
        torch.full((maxiter,), float("nan"), dtype=b.dtype, device=b.device)
        if history
        else None
    )
    k = 0
    while k < maxiter and bool(resn > tol_eff):
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = apply_M(p)
        v = matvec(phat)
        alpha = rho_new / torch.dot(rhat, v)
        s = r - alpha * v
        shat = apply_M(s)
        t = matvec(shat)
        omega = torch.dot(t, s) / torch.dot(t, t)
        omega = torch.where(torch.isfinite(omega), omega, torch.zeros_like(omega))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        resn = torch.linalg.vector_norm(r)
        if hist is not None:
            hist[k] = resn
        k += 1
    return x, SolveInfo(k, resn, bool(resn <= tol_eff), hist)


def _panel_algebra(n, s, interleaved):
    """(gram, comb, scale_cols, colnorms) for (n, s) column blocks or, with
    ``interleaved``, for their (s * ceil(n/128), 128) interleaved layout,
    whose zero padding rows drop out of every product."""
    if not interleaved:
        return (
            lambda X, Y: X.T @ Y,
            lambda X, C: X @ C.to(X.dtype),
            lambda X, w: X * w[None, :],
            lambda X: torch.linalg.vector_norm(X, dim=0),
        )
    sy = -(-n // 128)

    def p3(X):
        return X.reshape(sy, s, 128)

    def gram(X, Y):
        # sum over row blocks of (s, 128) @ (128, s): no copy of the panels
        return (p3(X) @ p3(Y).transpose(1, 2)).sum(0)

    def comb(X, C):
        return (C.T.to(X.dtype) @ p3(X)).reshape(sy * s, 128)

    def scale_cols(X, w):
        return (p3(X) * w[None, :, None]).reshape(sy * s, 128)

    def colnorms(X):
        return torch.linalg.vector_norm(p3(X), dim=(0, 2))

    return gram, comb, scale_cols, colnorms


def block_cg_solve(
    A, B, X0=None, *, tol=1e-12, rtol=0.0, maxiter=None, M=None, panels="auto"
):
    """Block (multi-RHS) conjugate gradients: solve A X = B for an (n, s)
    block of right-hand sides at once, one SpMM (``A.matmat``) per
    iteration instead of s SpMVs, plus small (s, s) Gram solves.

    ``panels`` selects the panel layout the loop keeps:

    - ``"cols"``: column-major (n, s) blocks;
    - ``"interleaved"``: the interleaved layout of
      :func:`~sigma_tpu_torch.ops.interleave_panels`, applied through
      ``A.matmat_interleaved``; the Gram and panel-combination algebra runs
      on the layout, so the (n, s) conversions are paid once at entry and
      exit;
    - ``"auto"``: interleaved when ``A.interleaved_profitable(s)`` (A on a
      CUDA device, s <= 16) and M, if any, applies in the layout.

    Breakdown-free recurrences: the direction block P is kept
    column-orthonormal by a column-normalised, shifted Cholesky-QR, so the
    Gram matrix W = P^T A P keeps A's conditioning as columns converge.
    Stops on the Frobenius norm of the block residual, on a non-finite
    residual, or when it grows 1e4-fold past the best one seen; returns
    the best iterate.  SPD A and M assumed.  The loop runs on the host and
    reads the residual norm back once per iteration, as :func:`cg_solve`
    does, so iteration counts match the JAX package.
    """
    n, s = B.shape
    X0 = torch.zeros_like(B) if X0 is None else X0
    maxiter = 10 * n if maxiter is None else int(maxiter)

    if panels == "auto":
        use_int = getattr(A, "interleaved_profitable", lambda k: False)(s) and (
            M is None or hasattr(M, "matmat_interleaved")
        )
    elif panels == "interleaved":
        use_int = True
    elif panels == "cols":
        use_int = False
    else:
        raise ValueError(f"panels must be auto|cols|interleaved: {panels!r}")

    if use_int:
        from sigma_tpu_torch.ops.spmm_dia import deinterleave_panels, interleave_panels

        def to_layout(Z):
            return interleave_panels(Z.T, n)

        def from_layout(Zp):
            return deinterleave_panels(Zp, s, n).T

        matmat = A.matmat_interleaved
        if M is None:
            apply_M = _identity_apply
        elif hasattr(M, "matmat_interleaved"):
            apply_M = M.matmat_interleaved
        else:
            def apply_M(R):
                return to_layout(M.matmat(from_layout(R)))
    else:
        to_layout = from_layout = _identity_apply
        matmat = A.matmat
        apply_M = M.matmat if M is not None else _identity_apply
    gram, comb, scale_cols, colnorms = _panel_algebra(n, s, use_int)

    fi = torch.finfo(B.dtype)
    tol_eff = float(_tol_eff(B, tol, rtol))
    eps = torch.tensor(fi.eps, dtype=B.dtype, device=B.device)
    tiny = torch.tensor(fi.tiny, dtype=B.dtype, device=B.device)
    shift = torch.sqrt(eps)  # shifted CholQR ridge
    eye = torch.eye(s, dtype=B.dtype, device=B.device)

    def orth(P):
        # unit columns first (a scale-disparate panel would otherwise lose
        # its small columns below the ridge), then P <- P L^{-T} through
        # the explicit (s, s) triangular inverse: a panel combination in
        # either layout
        cn = colnorms(P)
        P = scale_cols(P, 1.0 / torch.where(cn > tiny, cn, torch.ones_like(cn)))
        L = torch.linalg.cholesky(gram(P, P) + shift * eye)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        return comb(P, Linv.T)

    def solve_w(W, C):
        scale = torch.diagonal(W).abs().max() + tiny
        return torch.linalg.solve(W + (eps * scale) * eye, C)

    Bp = to_layout(B)
    X = to_layout(X0)
    R = Bp - matmat(X)
    P = orth(apply_M(R))
    resn_t = torch.linalg.vector_norm(R)
    resn = float(resn_t)
    Xb, rb, rb_t = X, resn, resn_t
    big = 1e4
    k = 0
    # stop on convergence, breakdown (non-finite residual) or runaway
    # divergence past any hope of recovery; the best iterate is returned
    while (
        math.isfinite(resn) and resn < big * (rb + tol_eff)
        and resn > tol_eff and k < maxiter
    ):
        Q = matmat(P)
        W = gram(P, Q)
        alpha = solve_w(W, gram(P, R))
        X = X + comb(P, alpha)
        R = R - comb(Q, alpha)
        resn_t = torch.linalg.vector_norm(R)
        resn = float(resn_t)  # the one host read of the iteration
        if math.isfinite(resn) and resn < rb:
            Xb, rb, rb_t = X, resn, resn_t
        Z = apply_M(R)
        beta = solve_w(W, gram(Q, Z))
        P = orth(Z - comb(P, beta))
        k += 1
    if not (math.isfinite(resn) and resn <= rb):
        X, resn, resn_t = Xb, rb, rb_t
    return from_layout(X), SolveInfo(k, resn_t, resn <= tol_eff)
