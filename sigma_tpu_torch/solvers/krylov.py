"""Krylov solvers on torch tensors.

Port of every solver of :mod:`sigma_tpu.solvers.krylov`: CG, fused CG,
BiCG-stab, MINRES, GMRES, flexible GMRES, CGLS, the stationary iteration
and block CG.  The JAX solve is one on-device ``lax.while_loop``; here the
loop runs on the host and reads the stopping quantity back once per
iteration (one device synchronisation each) to apply the same stopping
rule, so iteration counts match the JAX package.  CG and fused CG are
written as that loop's init / cond / body (:func:`cg_loop`,
:func:`cg_fused_loop`, with a device iteration counter), which
:func:`~sigma_tpu_torch.solvers.graphed.graphed` captures into one CUDA
graph whose iterations sit under device-side if-nodes, one host read a
block of iterations: the counterpart of ``jax.jit`` of the solve.  All
vectors stay on the device of ``b``; dot products are ``torch.dot``.  ``b`` may be a vector
sharded over ranks (a DTensor, :mod:`sigma_tpu_torch.parallel.ranks`):
the work arrays are then made like it (:mod:`sigma_tpu_torch.utils.sharded`)
and each dot is the ranks' local dots all-reduced at once (``dot``).

All take ``A`` and optional ``M`` as LinearOperators (``M`` applies the
*inverse* preconditioner, z = M^{-1} r).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from sigma_tpu_torch.utils.sharded import (
    dot, gathered, is_sharded, like, local, reduced, rows_like,
)

__all__ = [
    "SolveInfo",
    "bicgstab_solve",
    "block_cg_solve",
    "cg_fused_solve",
    "cg_solve",
    "cgls_solve",
    "fgmres_solve",
    "gmres_solve",
    "minres_solve",
    "stationary_solve",
]


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


def _counter(b):
    """The iteration counter a loop carries: 0-d int64 on b's device."""
    return torch.zeros((), dtype=torch.int64, device=b.device)


def _history(history, maxiter, b):
    """The (maxiter,) residual-norm history, NaN until written, when
    ``history`` is set; else None."""
    return (
        like(torch.full((maxiter,), float("nan"), dtype=b.dtype, device=b.device), b)
        if history
        else None
    )


class Loop(NamedTuple):
    """A solve split as the JAX package splits it for ``lax.while_loop``:
    the carried ``state`` after set-up, ``cond(state)``, a 0-d bool tensor
    on b's device, and ``body(state, out=None)``, the next state.  With
    ``out`` (a state of buffers, as :mod:`~sigma_tpu_torch.solvers.graphed`
    keeps them) the body writes each new vector and scalar into ``out``'s
    tensors instead of fresh ones, with the same arithmetic.  The history
    is written in place at the device index ``k`` (a captured loop shares
    one counter and one history between its buffer sets).  ``tol_eff`` is
    the stopping threshold ``cond`` compares with and ``maxiter`` the most
    iterations it allows."""

    state: NamedTuple
    cond: Callable
    body: Callable
    tol_eff: torch.Tensor
    maxiter: int


class CGState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor  # r.z
    res2: torch.Tensor  # r.r
    k: torch.Tensor  # 0-d int64: iterations taken
    hist: Optional[torch.Tensor]


class FusedCGState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    s: torch.Tensor  # A p, carried by its recurrence
    gamma: torch.Tensor  # r.z
    alpha: torch.Tensor  # the next step length
    res2: torch.Tensor
    k: torch.Tensor
    hist: Optional[torch.Tensor]


# the ``out`` of an eager body: every result a fresh tensor
_NO_OUT_CG = CGState(*[None] * len(CGState._fields))
_NO_OUT_FUSED = FusedCGState(*[None] * len(FusedCGState._fields))


def _put(value, out):
    """``value`` itself, or written into the buffer ``out`` (a 0-d copy)."""
    return value if out is None else out.copy_(value)


def _record(hist, k, value):
    """``hist[k] = value`` at the device index ``k`` (an index tensor, no
    host read): the write a captured loop replays.  A history of a sharded
    solve is the same on every rank, and each rank writes its own copy.
    An assignment, not ``index_copy_``, whose result (the whole history,
    NaN beyond ``k``) the float checks of ``utils.checks`` would test."""
    if is_sharded(hist):
        hist, value = hist.to_local(), value.to_local()
    hist[k.reshape(1)] = value.reshape(1)


def _stopper(tol_eff, maxiter):
    """The loop condition ``(sqrt(res2) > tol_eff) & (k < maxiter)`` of a
    state with ``res2`` and ``k``, computed on the device (a sharded solve's
    on each rank's copy of the replicated comparison)."""

    def cond(s):
        return local(torch.sqrt(s.res2) > tol_eff) & (s.k < maxiter)

    return cond


def run_loop(loop: Loop):
    """The eager solve: ``while bool(cond(state)): state = body(state)``,
    one host read of the stopping rule an iteration; returns ``(x, info)``."""
    s, k = loop.state, 0
    while bool(loop.cond(s)):
        s = loop.body(s)
        k += 1
    resn = torch.sqrt(s.res2)
    return s.x, SolveInfo(k, resn, bool(resn <= loop.tol_eff), s.hist)


def cg_loop(
    A, b, x0=None, *, tol=1e-15, rtol=0.0, maxiter=None, M=None, history=False,
    flexible=False,
) -> Loop:
    """:func:`cg_solve` as init / cond / body (``sigma_tpu/solvers/krylov.py``
    ``cg_solve``'s ``while_loop``); the set-up runs here."""
    n = A.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    maxiter = 10 * n if maxiter is None else int(maxiter)
    apply_M = _apply(M)
    matvec = A.matvec
    tol_eff = _tol_eff(b, tol, rtol)

    r = b - matvec(x)
    z = apply_M(r)
    state = CGState(x, r, z, dot(r, z), dot(r, r), _counter(b), _history(history, maxiter, b))

    def body(s, out=None):
        o = out or _NO_OUT_CG
        q = matvec(s.p)
        alpha = s.rho / dot(s.p, q)
        x = torch.add(s.x, alpha * s.p, out=o.x)
        r = torch.sub(s.r, alpha * q, out=o.r)
        z = apply_M(r)
        rho = dot(r, z)
        if flexible:
            beta = dot(z, r - s.r) / s.rho
        else:
            beta = rho / s.rho
        p = torch.add(z, beta * s.p, out=o.p)
        res2 = dot(r, r)
        if s.hist is not None:
            _record(s.hist, s.k, torch.sqrt(res2))
        return CGState(x, r, p, _put(rho, o.rho), _put(res2, o.res2),
                       torch.add(s.k, 1, out=o.k), s.hist)

    return Loop(state, _stopper(tol_eff, maxiter), body, tol_eff, maxiter)


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
    return run_loop(cg_loop(A, b, x0, tol=tol, rtol=rtol, maxiter=maxiter, M=M,
                            history=history, flexible=flexible))


def cg_fused_loop(
    A, b, x0=None, *, tol=1e-15, rtol=0.0, maxiter=None, M=None, history=False
) -> Loop:
    """:func:`cg_fused_solve` as init / cond / body (the JAX package's
    ``cg_fused_solve`` ``while_loop``); the set-up runs here."""
    n = A.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    maxiter = 10 * n if maxiter is None else int(maxiter)
    apply_M = _apply(M)
    matvec = A.matvec
    tol_eff = _tol_eff(b, tol, rtol)

    r = b - matvec(x)
    z = apply_M(r)
    w = matvec(z)
    gamma = dot(r, z)
    delta = dot(w, z)
    res2 = dot(r, r)
    # the first step is steepest descent: alpha = gamma/delta, beta = 0
    state = FusedCGState(x, r, z, w, gamma, gamma / delta, res2, _counter(b),
                         _history(history, maxiter, b))

    def body(s, out=None):
        o = out or _NO_OUT_FUSED
        x = torch.add(s.x, s.alpha * s.p, out=o.x)
        r = torch.sub(s.r, s.alpha * s.s, out=o.r)
        z = apply_M(r)
        w = matvec(z)
        gamma = dot(r, z)
        delta = dot(w, z)
        res2 = dot(r, r)
        beta = gamma / s.gamma
        alpha = gamma / (delta - beta * gamma / s.alpha)
        p = torch.add(z, beta * s.p, out=o.p)
        sv = torch.add(w, beta * s.s, out=o.s)
        if s.hist is not None:
            _record(s.hist, s.k, torch.sqrt(res2))
        return FusedCGState(x, r, p, sv, _put(gamma, o.gamma), _put(alpha, o.alpha),
                            _put(res2, o.res2), torch.add(s.k, 1, out=o.k), s.hist)

    return Loop(state, _stopper(tol_eff, maxiter), body, tol_eff, maxiter)


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
    return run_loop(cg_fused_loop(A, b, x0, tol=tol, rtol=rtol, maxiter=maxiter, M=M,
                                  history=history))


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
    hist = _history(history, maxiter, b)
    k = 0
    while k < maxiter and bool(resn > tol_eff):
        rho_new = dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = apply_M(p)
        v = matvec(phat)
        alpha = rho_new / dot(rhat, v)
        s = r - alpha * v
        shat = apply_M(s)
        t = matvec(shat)
        omega = dot(t, s) / dot(t, t)
        omega = torch.where(torch.isfinite(omega), omega, torch.zeros_like(omega))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        resn = torch.linalg.vector_norm(r)
        if hist is not None:
            hist[k] = resn
        k += 1
    return x, SolveInfo(k, resn, bool(resn <= tol_eff), hist)


def minres_solve(
    A, b, x0=None, *, tol=1e-12, rtol=0.0, maxiter=None, M=None, history=False
):
    """MINRES for symmetric (possibly indefinite) A, optional SPD M.

    A short-recurrence Lanczos process with an on-the-fly Givens QR of the
    tridiagonal: one matvec, one M-apply and three vector updates a step,
    no growing basis.  The running estimate ``phibar`` is the norm of the
    preconditioned residual; the loop runs while ``phibar > max(tol, rtol
    * ||b||)`` and fewer than ``maxiter`` (default 10 n) steps were taken,
    reading ``phibar`` back once a step.  ``info.residual_norm`` is
    ``phibar``; ``history=True`` records it after every step.
    """
    n = A.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    maxiter = 10 * n if maxiter is None else int(maxiter)
    apply_M = _apply(M)
    matvec = A.matvec
    tol_eff = _tol_eff(b, tol, rtol)
    tiny = torch.tensor(torch.finfo(b.dtype).tiny, dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    r1 = b - matvec(x)
    y = apply_M(r1)
    beta = phibar = torch.sqrt(torch.abs(dot(r1, y)))
    r2 = r1
    w = w2 = torch.zeros_like(b)
    oldb = dbar = epsln = sn = zero
    cs = -one
    hist = _history(history, maxiter, b)
    k = 0
    while k < maxiter and bool(phibar > tol_eff):
        v = y / torch.where(beta > tiny, beta, one)
        y = matvec(v)
        # the beta/oldb correction applies from the second step on
        if k > 0:
            y = y - (beta / torch.where(oldb > tiny, oldb, one)) * r1
        alfa = dot(v, y)
        y = y - (alfa / torch.where(beta > tiny, beta, one)) * r2
        r1, r2 = r2, y
        y = apply_M(r2)
        oldb, beta = beta, torch.sqrt(torch.abs(dot(r2, y)))
        # the previous rotation applied to the new tridiagonal column, then
        # the new Givens rotation annihilating beta
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.maximum(torch.sqrt(gbar * gbar + beta * beta), tiny)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = torch.abs(sn * phibar)
        w1, w2 = w2, w
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = x + phi * w
        if hist is not None:
            hist[k] = phibar
        k += 1
    return x, SolveInfo(k, phibar, bool(phibar <= tol_eff), hist)


def _host_dtype(dtype):
    """numpy dtype of the host-side Hessenberg arithmetic: b's, with the
    16-bit floats widened to float32 (numpy has no bfloat16)."""
    return np.float64 if dtype == torch.float64 else np.float32


_HOST_TORCH = {np.float64: torch.float64, np.float32: torch.float32}


def _cgs2_column(V, w, j, eps_break):
    """One CGS2 Arnoldi column: project ``w`` twice against the first
    ``j + 1`` basis vectors (the rows past j are zero, so the JAX
    package's masked (m + 1)-row products give the same h), append the
    normalised vector as row j + 1 of ``V``, and return the Hessenberg
    column h[0 .. j + 1] read back to the host: the step's one device
    synchronisation.  A breakdown (``||w|| <= 10 eps``) gives a zero
    column and a zero basis row.  Shared by GMRES and FGMRES."""
    Vj = V[: j + 1]
    h1 = reduced(Vj @ w)
    w = w - Vj.T @ h1
    h2 = reduced(Vj @ w)
    w = w - Vj.T @ h2
    wn = torch.linalg.vector_norm(w)
    h = torch.cat([gathered(h1 + h2), gathered(wn)[None]])
    h = h.to("cpu", _HOST_TORCH[_host_dtype(V.dtype)]).numpy()
    if h[j + 1] > eps_break * 10:
        V[j + 1] = w / wn
    else:
        V[j + 1] = torch.zeros_like(w)
        h[j + 1] = 0.0
    return h


def _givens_update(h, R, cs, sn, g, j):
    """Apply the j previous Givens rotations to the new Hessenberg column
    ``h`` (host, length j + 2), generate the rotation annihilating
    ``h[j + 1]``, and fold it into R, cs, sn and g in place.  ``|g[j+1]|``
    is then the running residual estimate."""
    for i in range(j):
        c, s = cs[i], sn[i]
        h[i], h[i + 1] = c * h[i] + s * h[i + 1], -s * h[i] + c * h[i + 1]
    denom = np.sqrt(h[j] * h[j] + h[j + 1] * h[j + 1])
    if denom > 0:
        cs[j], sn[j] = h[j] / denom, h[j + 1] / denom
    else:
        cs[j], sn[j] = 1.0, 0.0
    gj = g[j]
    g[j], g[j + 1] = cs[j] * gj, -sn[j] * gj
    R[:j, j] = h[:j]
    R[j, j] = denom


def _solve_hessenberg(R, g, j, m):
    """Back-substitute on the first ``j`` triangularised columns; the
    unused columns are padded with a unit diagonal and a zero right-hand
    side, so their entries of y are exactly 0."""
    used = np.arange(m) < j
    Rp = np.where(used[None, :] & used[:, None], R, np.eye(m, dtype=R.dtype))
    rhs = np.where(used, g[:m], 0.0).astype(R.dtype)
    y = torch.linalg.solve_triangular(
        torch.from_numpy(Rp), torch.from_numpy(rhs)[:, None], upper=True
    )
    return y[:j, 0]


def _arnoldi(A, b, x0, *, tol, rtol, restart, maxiter, precondition, flexible):
    """The restarted Arnoldi loop of GMRES(m) and FGMRES(m), right
    preconditioned by ``precondition``: GMRES updates x by M(V y), FGMRES by
    Z y from the stored preconditioned basis Z.  A cycle's inner steps stop
    on ``|g[j+1]| <= tol_eff`` or ``k_total + j >= maxiter``; the outer loop
    stops on the recomputed residual norm, on maxiter, or on a cycle that
    took no Arnoldi step."""
    # b's length sizes the basis, as in the JAX package (a distributed
    # operator's shape is the unpadded n)
    n = b.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    m = min(restart, n)
    maxiter = 10 * n if maxiter is None else int(maxiter)
    matvec = A.matvec
    tol_eff = float(_tol_eff(b, tol, rtol))
    hdt = _host_dtype(b.dtype)
    eps_break = hdt(torch.finfo(b.dtype).eps)
    V = rows_like(b, m + 1)
    Z = rows_like(b, m) if flexible else None

    r = b - matvec(x)
    beta = torch.linalg.vector_norm(r)
    beta_h = float(gathered(beta))
    k = 0
    progress = True
    while beta_h > tol_eff and k < maxiter and progress:
        # rows of V and Z are written before they are read
        V[0] = r / torch.where(beta > 0, beta, torch.ones_like(beta))
        R = np.zeros((m, m), dtype=hdt)  # the triangularised Hessenberg
        cs = np.zeros(m, dtype=hdt)
        sn = np.zeros(m, dtype=hdt)
        g = np.zeros(m + 1, dtype=hdt)
        g[0] = hdt(beta_h)
        j, est = 0, beta_h
        while est > tol_eff and j < m and k + j < maxiter:
            z = precondition(V[j])
            if flexible:
                Z[j] = z
            h = _cgs2_column(V, matvec(z), j, eps_break)
            _givens_update(h, R, cs, sn, g, j)
            j += 1
            est = abs(float(g[j]))
        y = like(_solve_hessenberg(R, g, j, m).to(device=b.device, dtype=b.dtype), b)
        if flexible:
            x = x + Z[:j].T @ y
        else:
            x = x + precondition(V[:j].T @ y)
        progress = j > 0
        k += j
        r = b - matvec(x)
        beta = torch.linalg.vector_norm(r)
        beta_h = float(gathered(beta))
    return x, SolveInfo(k, beta, beta_h <= tol_eff)


def gmres_solve(
    A, b, x0=None, *, tol=1e-12, rtol=0.0, restart=32, maxiter=None, M=None
):
    """Restarted GMRES(m) with right preconditioning.

    Arnoldi by CGS2 (classical Gram-Schmidt with one full
    reorthogonalisation pass: two products with the basis a pass), the
    Hessenberg column triangularised on the fly by Givens rotations on the
    host, so each step has a running residual estimate and the inner loop
    stops at convergence.  ``info.iterations`` is the true count of
    Arnoldi steps, not cycles * m.  The basis is (m + 1, n) in b's dtype
    on b's device (1.33 GB at m = 32 for 10.1M f32 rows).
    """
    return _arnoldi(A, b, x0, tol=tol, rtol=rtol, restart=restart, maxiter=maxiter,
                    precondition=_apply(M), flexible=False)


def fgmres_solve(
    A, b, x0=None, *, tol=1e-12, rtol=0.0, restart=32, maxiter=None, M=None
):
    """Flexible GMRES(m): right preconditioning with a preconditioner that
    may change between Arnoldi steps.  Each z_j = M(v_j) is kept in a
    second (m, n) basis Z and the update is ``x += Z y`` (Saad '93), so M
    can be an inner iterative solve.  With a fixed linear M it reproduces
    :func:`gmres_solve` up to rounding.

    ``M`` may be (dispatched in this order):

    - an :class:`~sigma_tpu_torch.operators.linear_operator.OperatorWithSolver`
      (``attach_solver(A_inner, bicgstab(...))``): its ``solve`` is the
      preconditioner application (``matvec`` would apply the bare inner
      operator);
    - a plain callable ``z = M(v)``;
    - any LinearOperator (its ``matvec``: a fixed linear M).
    """
    if M is not None and hasattr(M, "solve") and hasattr(M, "solver"):
        precondition = M.solve
    elif callable(M) and not hasattr(M, "matvec"):
        precondition = M
    else:
        precondition = _apply(M)
    return _arnoldi(A, b, x0, tol=tol, rtol=rtol, restart=restart, maxiter=maxiter,
                    precondition=precondition, flexible=True)


def cgls_solve(
    A, b, x0=None, *, tol=1e-12, rtol=0.0, maxiter=None, M=None, history=False
):
    """CGLS: conjugate gradients on the normal equations A^T A x = A^T b
    without forming A^T A, for rectangular (or square nonsymmetric) A.
    Minimises ``||b - A x||``; from x0 = 0 on a consistent underdetermined
    system it reaches the minimum-norm solution.  One ``matvec`` and one
    ``rmatvec`` an iteration.

    ``M``, if given, is a symmetric positive preconditioner on the column
    space (z = M s with s = A^T r).  The loop stops on the normal-equations
    residual ``||A^T r|| <= max(tol, rtol * ||A^T b||)`` or after
    ``maxiter`` (default 10 A.shape[1]) iterations; ``info.residual_norm``
    reports ``||A^T r||``.
    """
    maxiter = 10 * A.shape[1] if maxiter is None else int(maxiter)
    apply_M = _apply(M)
    matvec, rmatvec = A.matvec, A.rmatvec
    # the domain vector's template comes from rmatvec(b), as in the JAX
    # package (a distributed operator's domain vector is padded)
    Atb = rmatvec(b)
    x = torch.zeros_like(Atb) if x0 is None else x0
    r = b - matvec(x)
    s = rmatvec(r)
    p = apply_M(s)
    gamma = dot(s, p)
    tol_eff = _tol_eff(Atb, tol, rtol)
    snorm = torch.sqrt(torch.abs(dot(s, s)))
    hist = _history(history, maxiter, b)
    k = 0
    while k < maxiter and bool(snorm > tol_eff):
        q = matvec(p)
        alpha = gamma / dot(q, q)
        x = x + alpha * p
        r = r - alpha * q
        s = rmatvec(r)
        z = apply_M(s)
        gamma_new = dot(s, z)
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
        snorm = torch.sqrt(torch.abs(dot(s, s)))
        if hist is not None:
            hist[k] = snorm
        k += 1
    return x, SolveInfo(k, snorm, bool(snorm <= tol_eff), hist)


def stationary_solve(A, b, M, x0=None, *, steps: int):
    """Fixed-count stationary (Richardson) iteration x += M^{-1}(b - A x),
    how the reference tests run Jacobi as a standalone solver.  There is no
    tolerance: ``info.iterations`` is ``steps`` and ``converged`` only says
    that the final residual is finite."""
    x = torch.zeros_like(b) if x0 is None else x0
    apply_M = _apply(M)
    for _ in range(steps):
        x = x + apply_M(b - A.matvec(x))
    resn = torch.linalg.vector_norm(b - A.matvec(x))
    return x, SolveInfo(int(steps), resn, bool(torch.isfinite(resn)))


def _panel_algebra(n, s, interleaved):
    """(gram, comb, scale_cols, colnorms) for (n, s) column blocks or, with
    ``interleaved``, for their (s * ceil(n/128), 128) interleaved layout,
    whose zero padding rows drop out of every product.  The (s, s) and
    (s,) results are plain tensors, sharded blocks' gathered."""
    if not interleaved:
        return (
            lambda X, Y: gathered(X.T @ Y),
            lambda X, C: X @ like(C.to(X.dtype), X),
            lambda X, w: X * like(w, X)[None, :],
            lambda X: gathered(torch.linalg.vector_norm(X, dim=0)),
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
    resn = float(gathered(resn_t))
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
        resn = float(gathered(resn_t))  # the one host read of the iteration
        if math.isfinite(resn) and resn < rb:
            Xb, rb, rb_t = X, resn, resn_t
        Z = apply_M(R)
        beta = solve_w(W, gram(Q, Z))
        P = orth(Z - comb(P, beta))
        k += 1
    if not (math.isfinite(resn) and resn <= rb):
        X, resn, resn_t = Xb, rb, rb_t
    return from_layout(X), SolveInfo(k, resn_t, resn <= tol_eff)
