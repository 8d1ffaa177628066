"""Krylov solvers on torch tensors.

Port of every solver of :mod:`sigma_tpu.solvers.krylov`: CG, fused CG,
BiCG-stab, MINRES, GMRES, flexible GMRES, CGLS, the stationary iteration
and block CG.  The JAX solve is one on-device ``lax.while_loop`` (a
``fori_loop`` for the stationary iteration); here the loop runs on the
host and reads the stopping quantity back once per iteration (one device
synchronisation each) to apply the same stopping rule, so iteration
counts match the JAX package.  CG, fused CG, BiCG-stab, MINRES, CGLS, the
stationary iteration and block CG are written as that loop's init / cond
/ body (:func:`cg_loop`, :func:`cg_fused_loop`, :func:`bicgstab_loop`,
:func:`minres_loop`, :func:`cgls_loop`, :func:`stationary_loop`,
:func:`block_cg_loop`, each with a device iteration counter and its stopping
rule computed on the device), GMRES and FGMRES as the JAX package's two
nested loops split at a restart cycle (:func:`arnoldi_loop`: a cycle's
init, Arnoldi step j with its Givens update on the device, the cycle's
end with the Hessenberg solve on the device).
:func:`~sigma_tpu_torch.solvers.graphed.graphed` captures any of the nine
into one CUDA graph whose bodies sit under device-side if-nodes, one host
read a block of iterations or a restart cycle: the counterpart of
``jax.jit`` of the solve.  All vectors stay on the device of ``b``; dot
products are ``torch.dot``.  ``b`` may be a vector sharded over ranks (a
DTensor, :mod:`sigma_tpu_torch.parallel.ranks`): the work arrays are then
made like it (:mod:`sigma_tpu_torch.utils.sharded`) and each dot is the
ranks' local dots all-reduced at once (``dot``).

All take ``A`` and optional ``M`` as LinearOperators (``M`` applies the
*inverse* preconditioner, z = M^{-1} r).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from sigma_tpu_torch.ops.givens import givens_small_dtype, givens_update
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


def _solution_x(s):
    return s.x


class Loop(NamedTuple):
    """A solve split as the JAX package splits it for ``lax.while_loop``:
    the carried ``state`` after set-up, ``cond(state)``, a 0-d bool tensor
    on b's device, and ``body(state, out=None)``, the next state.  With
    ``out`` (a state of buffers, as :mod:`~sigma_tpu_torch.solvers.graphed`
    keeps them) the body writes each new vector and scalar into ``out``'s
    tensors instead of fresh ones, with the same arithmetic.  The history
    is written in place at the device index ``k`` (a captured loop shares
    one counter and one history between its buffer sets, and the state's
    other ``SHARED`` fields, which the body passes on unchanged or updates
    in place).  A state's ``CROSSED`` pairs are fields whose roles swap
    every iteration (MINRES's two last residuals and directions): the
    second buffer set holds each pair's buffers the other way round, so
    the swap needs no copy.  ``tol_eff`` is the stopping threshold
    ``cond`` compares with (None for the stationary iteration, which has
    none) and ``maxiter`` the most iterations it allows.

    The finishing hook turns a final state into the solve's result, each
    loop its own: ``finish(state)`` gives the residual norm ``info``
    reports and whether the solve converged, 0-d tensors computed on the
    device without a launch of the port's kernels (it is the status a
    captured loop reads), and ``solution(state)`` the x returned (block
    CG's best iterate, out of the panel layout)."""

    state: NamedTuple
    cond: Callable
    body: Callable
    tol_eff: Optional[torch.Tensor]
    maxiter: int
    finish: Callable
    solution: Callable = _solution_x

    def result(self, s, k):
        """``(x, info)`` of the final state ``s`` after ``k`` iterations."""
        resn, converged = self.finish(s)
        return self.solution(s), SolveInfo(k, resn, bool(converged), s.hist)


class CGState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor  # r.z
    res2: torch.Tensor  # r.r
    k: torch.Tensor  # 0-d int64: iterations taken
    hist: Optional[torch.Tensor]
    SHARED = ("k", "hist")


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
    SHARED = ("k", "hist")


class BiCGStabState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor  # A M^{-1} p
    rho: torch.Tensor  # rhat.r
    alpha: torch.Tensor
    omega: torch.Tensor
    resn: torch.Tensor  # ||r||
    k: torch.Tensor
    hist: Optional[torch.Tensor]
    rhat: torch.Tensor  # the shadow residual, fixed after set-up
    SHARED = ("k", "hist", "rhat")


# the ``out`` of an eager body: every result a fresh tensor
_NO_OUT_CG = CGState(*[None] * len(CGState._fields))
_NO_OUT_FUSED = FusedCGState(*[None] * len(FusedCGState._fields))
_NO_OUT_BICG = BiCGStabState(*[None] * len(BiCGStabState._fields))


def _put(value, out):
    """``value`` itself, or written into the buffer ``out`` (a copy; none
    where ``out`` is ``value``, a crossed or shared buffer)."""
    return value if out is None or out is value else out.copy_(value)


def _record(hist, k, value):
    """``hist[k] = value`` at the device index ``k`` (an index tensor, no
    host read): the write a captured loop replays.  A history of a sharded
    solve is the same on every rank, and each rank writes its own copy.
    An assignment, not ``index_copy_``, whose result (the whole history,
    NaN beyond ``k``) the float checks of ``utils.checks`` would test."""
    if is_sharded(hist):
        hist, value = hist.to_local(), local(value)
    hist[k.reshape(1)] = value.reshape(1)


def _until_tolerance(state, body, tol_eff, maxiter, field, norm=_identity_apply) -> Loop:
    """The :class:`Loop` of a solve whose residual norm is ``norm`` of its
    state's ``field``: it runs while that is above ``tol_eff`` and fewer
    than ``maxiter`` iterations were taken, the comparison computed on the
    device (a sharded solve's on each rank's copy of the replicated
    value), and converged when that is at most ``tol_eff``."""

    def resn(s):
        return norm(getattr(s, field))

    def cond(s):
        return local(resn(s) > tol_eff) & (s.k < maxiter)

    def finish(s):
        r = resn(s)
        return r, r <= tol_eff

    return Loop(state, cond, body, tol_eff, maxiter, finish)


def run_loop(loop: Loop):
    """The eager solve: ``while bool(cond(state)): state = body(state)``,
    one host read of the stopping rule an iteration; returns ``(x, info)``."""
    s, k = loop.state, 0
    while bool(loop.cond(s)):
        s = loop.body(s)
        k += 1
    return loop.result(s, k)


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

    return _until_tolerance(state, body, tol_eff, maxiter, "res2", torch.sqrt)


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

    return _until_tolerance(state, body, tol_eff, maxiter, "res2", torch.sqrt)


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


def bicgstab_loop(
    A, b, x0=None, *, tol=1e-12, rtol=0.0, maxiter=None, M=None, history=False
) -> Loop:
    """:func:`bicgstab_solve` as init / cond / body (the JAX package's
    ``bicgstab_solve`` ``while_loop``); the set-up runs here.  The state
    carries ``||r||``, which ``cond`` tests."""
    n = A.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    maxiter = 10 * n if maxiter is None else int(maxiter)
    apply_M = _apply(M)
    matvec = A.matvec
    tol_eff = _tol_eff(b, tol, rtol)

    r = b - matvec(x)
    p = v = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    state = BiCGStabState(x, r, p, v, one, one, one, torch.linalg.vector_norm(r), _counter(b),
                          _history(history, maxiter, b), r)

    def body(s, out=None):
        o = out or _NO_OUT_BICG
        rho = dot(s.rhat, s.r)
        beta = (rho / s.rho) * (s.alpha / s.omega)
        p = torch.add(s.r, beta * (s.p - s.omega * s.v), out=o.p)
        phat = apply_M(p)
        v = _put(matvec(phat), o.v)
        alpha = rho / dot(s.rhat, v)
        sv = s.r - alpha * v
        shat = apply_M(sv)
        t = matvec(shat)
        omega = dot(t, sv) / dot(t, t)
        omega = torch.where(torch.isfinite(omega), omega, torch.zeros_like(omega))
        x = torch.add(s.x + alpha * phat, omega * shat, out=o.x)
        r = torch.sub(sv, omega * t, out=o.r)
        resn = torch.linalg.vector_norm(r)
        if s.hist is not None:
            _record(s.hist, s.k, resn)
        return BiCGStabState(x, r, p, v, _put(rho, o.rho), _put(alpha, o.alpha),
                             _put(omega, o.omega), _put(resn, o.resn),
                             torch.add(s.k, 1, out=o.k), s.hist, s.rhat)

    return _until_tolerance(state, body, tol_eff, maxiter, "resn")


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
    return run_loop(bicgstab_loop(A, b, x0, tol=tol, rtol=rtol, maxiter=maxiter, M=M,
                                  history=history))


class MinresState(NamedTuple):
    x: torch.Tensor
    y: Optional[torch.Tensor]  # M^{-1} r2; None without M (then y is r2)
    r1: torch.Tensor  # the residual before r2
    r2: torch.Tensor  # the newest Lanczos residual
    w: torch.Tensor  # the newest update direction
    w2: torch.Tensor  # the one before
    oldb: torch.Tensor  # beta of the step before
    beta: torch.Tensor
    phibar: torch.Tensor  # |the preconditioned residual norm estimate|
    dbar: torch.Tensor
    epsln: torch.Tensor
    cs: torch.Tensor  # the last Givens rotation
    sn: torch.Tensor
    k: torch.Tensor
    hist: Optional[torch.Tensor]
    SHARED = ("k", "hist")
    # r1, r2 = r2, y and w2, w = w, w_new: each pair held crosswise by the
    # second buffer set, so a step writes its new vector over the one it
    # retires
    CROSSED = (("r1", "r2"), ("w", "w2"))


_NO_OUT_MINRES = MinresState(*[None] * len(MinresState._fields))


def minres_loop(
    A, b, x0=None, *, tol=1e-12, rtol=0.0, maxiter=None, M=None, history=False
) -> Loop:
    """:func:`minres_solve` as init / cond / body (the JAX package's
    ``minres_solve`` ``while_loop``); the set-up runs here.  The first
    step's beta/oldb correction is selected on the device (a zero
    coefficient at k = 0), as the JAX package selects it."""
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
    beta = torch.sqrt(torch.abs(dot(r1, y)))
    w = torch.zeros_like(b)
    state = MinresState(x, None if M is None else y, r1, r1, w, w, zero, beta, beta, zero, zero,
                        -one, zero, _counter(b), _history(history, maxiter, b))

    def body(s, out=None):
        o = out or _NO_OUT_MINRES
        y = s.r2 if s.y is None else s.y
        v = y / torch.where(s.beta > tiny, s.beta, one)
        y = matvec(v)
        # the beta/oldb correction applies from the second step on
        y = y - torch.where(s.k > 0, s.beta / torch.where(s.oldb > tiny, s.oldb, one), zero) * s.r1
        alfa = dot(v, y)
        # r1, r2 = r2, y (r1's buffer is retired: s.r1 is read no more)
        r2 = torch.sub(y, (alfa / torch.where(s.beta > tiny, s.beta, one)) * s.r2, out=o.r2)
        y = apply_M(r2)
        beta = torch.sqrt(torch.abs(dot(r2, y)))
        # the previous rotation applied to the new tridiagonal column, then
        # the new Givens rotation annihilating beta
        delta = s.cs * s.dbar + s.sn * alfa
        gbar = s.sn * s.dbar - s.cs * alfa
        epsln = s.sn * beta
        dbar = -s.cs * beta
        gamma = torch.maximum(torch.sqrt(gbar * gbar + beta * beta), tiny)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * s.phibar
        phibar = torch.abs(sn * s.phibar)
        # w1, w2 = w2, w; w = (v - oldeps w1 - delta w2) / gamma, over w1
        w = torch.div(v - s.epsln * s.w2 - delta * s.w, gamma, out=o.w)
        x = torch.add(s.x, phi * w, out=o.x)
        if s.hist is not None:
            _record(s.hist, s.k, phibar)
        return MinresState(
            x, None if s.y is None else _put(y, o.y), _put(s.r2, o.r1), r2, w, _put(s.w, o.w2),
            _put(s.beta, o.oldb), _put(beta, o.beta), _put(phibar, o.phibar), _put(dbar, o.dbar),
            _put(epsln, o.epsln), _put(cs, o.cs), _put(sn, o.sn), torch.add(s.k, 1, out=o.k),
            s.hist)

    return _until_tolerance(state, body, tol_eff, maxiter, "phibar")


def minres_solve(
    A, b, x0=None, *, tol=1e-12, rtol=0.0, maxiter=None, M=None, history=False
):
    """MINRES for symmetric (possibly indefinite) A, optional SPD M.

    A short-recurrence Lanczos process with an on-the-fly Givens QR of the
    tridiagonal: one matvec, one M-apply and three vector updates a step,
    no growing basis.  The running estimate ``phibar`` is the norm of the
    preconditioned residual; the loop runs while ``phibar > max(tol, rtol
    * ||b||)`` and fewer than ``maxiter`` (default 10 n) steps were taken,
    reading the stopping rule back once a step.  ``info.residual_norm`` is
    ``phibar``; ``history=True`` records it after every step.
    """
    return run_loop(minres_loop(A, b, x0, tol=tol, rtol=rtol, maxiter=maxiter, M=M,
                                history=history))


def _cgs2_column(V, w, j):
    """One CGS2 Arnoldi column: project ``w`` twice against the first
    ``j + 1`` basis vectors (the rows past j are not read, so the JAX
    package's masked (m + 1)-row products give the same h).  Returns the
    two projections and ``||w||`` as plain tensors in b's dtype (summed
    over the ranks) and the projected ``w``; the column's assembly, its
    breakdown test and the divisor of the next basis row are the Givens
    kernel's (:func:`~sigma_tpu_torch.ops.givens.givens_update`).  Shared
    by GMRES and FGMRES."""
    Vj = V[: j + 1]
    h1 = reduced(Vj @ w)
    w = w - Vj.T @ h1
    h2 = reduced(Vj @ w)
    w = w - Vj.T @ h2
    return gathered(h1), gathered(h2), gathered(torch.linalg.vector_norm(w)), w


class ArnoldiState(NamedTuple):
    """What a restarted Arnoldi loop carries from one cycle to the next."""

    x: torch.Tensor
    b: torch.Tensor
    r: torch.Tensor  # b - A x
    beta: torch.Tensor  # ||r||, in b's dtype
    k: torch.Tensor  # 0-d int64: Arnoldi steps taken
    progress: torch.Tensor  # 0-d bool: the last cycle took a step


class ArnoldiWork(NamedTuple):
    """A restart cycle's workspace, written before it is read in every
    cycle; the small arrays are in
    :func:`~sigma_tpu_torch.ops.givens.givens_small_dtype`."""

    V: torch.Tensor  # (m + 1, n) basis, b's dtype
    Z: Optional[torch.Tensor]  # (m, n) preconditioned basis of FGMRES
    R: torch.Tensor  # (m, m) triangularised Hessenberg
    cs: torch.Tensor  # (m,) rotations
    sn: torch.Tensor
    g: torch.Tensor  # (m + 1,) rotated right-hand side
    est: torch.Tensor  # |g[j]|: the running residual estimate
    j: torch.Tensor  # 0-d int64: the cycle's steps
    inner: torch.Tensor  # 0-d bool: the next step runs
    eye: torch.Tensor  # (m, m) identity, the padding of R
    steps: torch.Tensor  # arange(m)
    h: torch.Tensor  # (m + 1,) the step's Hessenberg column, breakdown applied
    d: torch.Tensor  # 0-d divisor of the next basis row, b's dtype: ||w|| or inf


class Cycles(NamedTuple):
    """A restarted Arnoldi solve split as the JAX package's two nested
    ``lax.while_loop``s: the carried ``state`` after set-up, ``work()``
    the cycle's workspace, ``cond(state)`` the outer predicate ``(beta >
    tol_eff) & (k < maxiter) & progress``, ``init(state, work)`` a cycle's
    start (V[0] = r / beta, R, cs, sn and g cleared, g[0] = beta),
    ``step(state, work, j)`` Arnoldi step j (a Python int) writing the
    inner predicate ``work.inner``, and ``end(state, work)`` the cycle's
    end (the Hessenberg solve over all m columns, x, k, progress, the new
    r and beta).  Every write is in place, at a place fixed by j, so a
    step's capture can be replayed.  ``tol_eff`` is in the small
    arrays' dtype."""

    state: ArnoldiState
    work: Callable
    cond: Callable
    init: Callable
    step: Callable
    end: Callable
    tol_eff: torch.Tensor
    maxiter: int
    m: int


def arnoldi_loop(A, b, x0=None, *, tol, rtol, restart, maxiter, precondition,
                 flexible) -> Cycles:
    """The restarted Arnoldi loop of GMRES(m) and FGMRES(m), right
    preconditioned by ``precondition``: GMRES updates x by M(V y), FGMRES
    by Z y from the stored preconditioned basis Z.  A cycle's steps stop
    on ``|g[j+1]| <= tol_eff`` or ``k + j >= maxiter``; the outer loop
    stops on the recomputed residual norm, on maxiter, or on a cycle that
    took no Arnoldi step (``sigma_tpu/solvers/krylov.py`` ``gmres_solve``,
    with the Givens update and the triangular solve on the device)."""
    # b's length sizes the basis, as in the JAX package (a distributed
    # operator's shape is the unpadded n)
    n = b.shape[0]
    m = min(restart, n)
    maxiter = 10 * n if maxiter is None else int(maxiter)
    matvec = A.matvec
    sdt = givens_small_dtype(b.dtype)
    dev = b.device
    tol_eff = local(_tol_eff(b, tol, rtol)).to(sdt)
    eps10 = torch.tensor(torch.finfo(b.dtype).eps, dtype=sdt, device=dev) * 10

    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - matvec(x)
    state = ArnoldiState(x, b, r, reduced(torch.linalg.vector_norm(r)), _counter(b),
                         torch.ones((), dtype=torch.bool, device=dev))

    def work():
        def small(*shape):
            return torch.zeros(shape, dtype=sdt, device=dev)

        return ArnoldiWork(
            rows_like(b, m + 1), rows_like(b, m) if flexible else None, small(m, m),
            small(m), small(m), small(m + 1), small(), _counter(b),
            torch.zeros((), dtype=torch.bool, device=dev),
            torch.eye(m, dtype=sdt, device=dev), torch.arange(m, device=dev), small(m + 1),
            torch.zeros((), dtype=b.dtype, device=dev))

    def cond(s):
        return (local(s.beta) > tol_eff) & (s.k < maxiter) & s.progress

    def init(s, w):
        w.V[0] = s.r / torch.where(s.beta > 0, s.beta, torch.ones_like(s.beta))
        for t in (w.R, w.cs, w.sn, w.g):
            t.zero_()
        w.g[0] = local(s.beta)

    def step(s, w, j):
        z = precondition(w.V[j])
        if flexible:
            w.Z[j] = z
        h1, h2, wn, v = _cgs2_column(w.V, matvec(z), j)
        givens_update(h1, h2, wn, eps10, w.h, w.d, w.R, w.cs, w.sn, w.g, w.est, w.inner, w.j,
                      s.k, tol_eff, j, maxiter)
        # v / ||v||, or zeros (v / inf) on a breakdown, with no host read
        if is_sharded(v):
            w.V[j + 1] = v / like(w.d, v)
        else:
            torch.div(v, w.d, out=w.V[j + 1])

    def end(s, w):
        # the padded triangular system: the unused columns keep a unit
        # diagonal and a zero right-hand side, so their entries of y are
        # exactly 0 and the update may run over every basis row
        used = w.steps < w.j
        Rp = torch.where(used[None, :] & used[:, None], w.R, w.eye)
        rhs = torch.where(used, w.g[:m], torch.zeros_like(w.g[:m]))
        y = like(torch.linalg.solve_triangular(Rp, rhs[:, None], upper=True)[:, 0]
                 .to(b.dtype), b)
        s.x.add_(w.Z.T @ y if flexible else precondition(w.V[:m].T @ y))
        s.progress.copy_(w.j > 0)
        s.k.add_(w.j)
        s.r.copy_(s.b - matvec(s.x))
        s.beta.copy_(reduced(torch.linalg.vector_norm(s.r)))

    return Cycles(state, work, cond, init, step, end, tol_eff, maxiter, m)


def run_cycles(loop: Cycles):
    """The eager restarted solve: one host read of ``cond`` a cycle and one
    of the inner predicate a step; returns ``(x, info)``."""
    s, w, k = loop.state, loop.work(), 0
    while bool(loop.cond(s)):
        loop.init(s, w)
        # the outer predicate implies the first step's
        for j in range(loop.m):
            loop.step(s, w, j)
            k += 1
            if not bool(w.inner):
                break
        loop.end(s, w)
    return s.x, SolveInfo(k, s.beta, bool(local(s.beta) <= loop.tol_eff))


def gmres_loop(A, b, x0=None, *, tol=1e-12, rtol=0.0, restart=32, maxiter=None,
               M=None) -> Cycles:
    """:func:`gmres_solve` as :class:`Cycles`; the set-up runs here."""
    return arnoldi_loop(A, b, x0, tol=tol, rtol=rtol, restart=restart, maxiter=maxiter,
                        precondition=_apply(M), flexible=False)


def gmres_solve(
    A, b, x0=None, *, tol=1e-12, rtol=0.0, restart=32, maxiter=None, M=None
):
    """Restarted GMRES(m) with right preconditioning.

    Arnoldi by CGS2 (classical Gram-Schmidt with one full
    reorthogonalisation pass: two products with the basis a pass), the
    Hessenberg column triangularised on the fly by Givens rotations on the
    device (:func:`~sigma_tpu_torch.ops.givens.givens_update`), so each
    step has a running residual estimate and the inner loop stops at
    convergence.  ``info.iterations`` is the true count of Arnoldi steps,
    not cycles * m.  The basis is (m + 1, n) in b's dtype on b's device
    (1.33 GB at m = 32 for 10.1M f32 rows).
    """
    return run_cycles(gmres_loop(A, b, x0, tol=tol, rtol=rtol, restart=restart,
                                 maxiter=maxiter, M=M))


def attached(M) -> bool:
    """True for an ``attach_solver`` operator
    (:class:`~sigma_tpu_torch.operators.linear_operator.OperatorWithSolver`),
    whose ``solve`` FGMRES runs as its preconditioner."""
    return M is not None and hasattr(M, "solve") and hasattr(M, "solver")


def _flexible_precondition(M):
    """FGMRES's preconditioner application, dispatched in this order: an
    ``OperatorWithSolver``'s ``solve`` (``attach_solver``: ``matvec``
    would apply the bare inner operator), a plain callable ``z = M(v)``,
    any LinearOperator's ``matvec``."""
    if attached(M):
        return M.solve
    if callable(M) and not hasattr(M, "matvec"):
        return M
    return _apply(M)


def fgmres_loop(A, b, x0=None, *, tol=1e-12, rtol=0.0, restart=32, maxiter=None,
                M=None) -> Cycles:
    """:func:`fgmres_solve` as :class:`Cycles` (the basis Z of the
    preconditioned vectors in the cycle's workspace); the set-up runs
    here."""
    return arnoldi_loop(A, b, x0, tol=tol, rtol=rtol, restart=restart, maxiter=maxiter,
                        precondition=_flexible_precondition(M), flexible=True)


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

    Under :func:`~sigma_tpu_torch.solvers.graphed.graphed` M must not read
    back to the host: an attached inner solve does, and is refused there.
    """
    return run_cycles(fgmres_loop(A, b, x0, tol=tol, rtol=rtol, restart=restart,
                                  maxiter=maxiter, M=M))


class CGLSState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor  # b - A x
    p: torch.Tensor
    gamma: torch.Tensor  # s.z with s = A^T r
    snorm: torch.Tensor  # ||A^T r||
    k: torch.Tensor
    hist: Optional[torch.Tensor]
    SHARED = ("k", "hist")


_NO_OUT_CGLS = CGLSState(*[None] * len(CGLSState._fields))


def cgls_loop(
    A, b, x0=None, *, tol=1e-12, rtol=0.0, maxiter=None, M=None, history=False
) -> Loop:
    """:func:`cgls_solve` as init / cond / body (the JAX package's
    ``cgls_solve`` ``while_loop``); the set-up runs here."""
    maxiter = 10 * A.shape[1] if maxiter is None else int(maxiter)
    apply_M = _apply(M)
    matvec, rmatvec = A.matvec, A.rmatvec
    # the domain vector's template comes from rmatvec(b), as in the JAX
    # package (a distributed operator's domain vector is padded)
    Atb = rmatvec(b)
    x = torch.zeros_like(Atb) if x0 is None else x0
    r = b - matvec(x)
    s0 = rmatvec(r)
    p = apply_M(s0)
    tol_eff = _tol_eff(Atb, tol, rtol)
    state = CGLSState(x, r, p, dot(s0, p), torch.sqrt(torch.abs(dot(s0, s0))), _counter(b),
                      _history(history, maxiter, b))

    def body(s, out=None):
        o = out or _NO_OUT_CGLS
        q = matvec(s.p)
        alpha = s.gamma / dot(q, q)
        x = torch.add(s.x, alpha * s.p, out=o.x)
        r = torch.sub(s.r, alpha * q, out=o.r)
        sv = rmatvec(r)
        z = apply_M(sv)
        gamma = dot(sv, z)
        p = torch.add(z, (gamma / s.gamma) * s.p, out=o.p)
        snorm = torch.sqrt(torch.abs(dot(sv, sv)))
        if s.hist is not None:
            _record(s.hist, s.k, snorm)
        return CGLSState(x, r, p, _put(gamma, o.gamma), _put(snorm, o.snorm),
                         torch.add(s.k, 1, out=o.k), s.hist)

    return _until_tolerance(state, body, tol_eff, maxiter, "snorm")


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
    return run_loop(cgls_loop(A, b, x0, tol=tol, rtol=rtol, maxiter=maxiter, M=M,
                              history=history))


class StationaryState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor  # b - A x
    k: torch.Tensor
    hist: None  # no history
    b: torch.Tensor  # the right-hand side, fixed
    SHARED = ("k", "hist", "b")


_NO_OUT_STATIONARY = StationaryState(*[None] * len(StationaryState._fields))


def _finite_residual(s):
    resn = torch.linalg.vector_norm(s.r)
    return resn, torch.isfinite(resn)


def stationary_loop(A, b, M, x0=None, *, steps: int) -> Loop:
    """:func:`stationary_solve` as init / cond / body (the JAX package's
    ``fori_loop``: the condition ``k < steps`` reads no data).  The state
    carries the residual ``b - A x`` of its x, so a step is x += M^{-1} r,
    then r = b - A x: the same products in the same order as x += M^{-1}(b
    - A x), the last one the final residual's."""
    x = torch.zeros_like(b) if x0 is None else x0
    steps = int(steps)
    apply_M = _apply(M)
    matvec = A.matvec
    state = StationaryState(x, b - matvec(x), _counter(b), None, b)

    def cond(s):
        return s.k < steps

    def body(s, out=None):
        o = out or _NO_OUT_STATIONARY
        x = torch.add(s.x, apply_M(s.r), out=o.x)
        r = torch.sub(s.b, matvec(x), out=o.r)
        return StationaryState(x, r, torch.add(s.k, 1, out=o.k), s.hist, s.b)

    return Loop(state, cond, body, None, max(steps, 0), _finite_residual)


def stationary_solve(A, b, M, x0=None, *, steps: int):
    """Fixed-count stationary (Richardson) iteration x += M^{-1}(b - A x),
    how the reference tests run Jacobi as a standalone solver.  There is no
    tolerance: ``info.iterations`` is ``steps`` and ``converged`` only says
    that the final residual is finite."""
    return run_loop(stationary_loop(A, b, M, x0, steps=steps))


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


class BlockCGState(NamedTuple):
    X: torch.Tensor  # the iterate, in the panel layout
    R: torch.Tensor  # B - A X
    P: torch.Tensor  # the column-orthonormal direction block
    resn: torch.Tensor  # ||R||_F, in B's dtype
    rb: torch.Tensor  # the best ||R||_F so far
    k: torch.Tensor
    Xb: torch.Tensor  # the best iterate so far
    hist: None  # no history
    # a captured loop keeps one best iterate, updated in place
    SHARED = ("k", "hist", "Xb", "rb")


_NO_OUT_BLOCK_CG = BlockCGState(*[None] * len(BlockCGState._fields))


def block_cg_loop(
    A, B, X0=None, *, tol=1e-12, rtol=0.0, maxiter=None, M=None, panels="auto"
) -> Loop:
    """:func:`block_cg_solve` as init / cond / body (the JAX package's
    ``block_cg_solve`` ``while_loop``); the set-up, the layout's choice and
    the conversion into it run here, the conversion out of it in
    ``solution``.  The stopping rule, the best iterate and its residual are
    kept on the device in B's dtype, as the JAX package keeps them (a
    ``where`` over the panel an iteration); the small factorisations are
    the ``_ex`` forms, which leave their status on the device."""
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
    tol_eff = local(_tol_eff(B, tol, rtol))
    eps = torch.tensor(fi.eps, dtype=B.dtype, device=B.device)
    tiny = torch.tensor(fi.tiny, dtype=B.dtype, device=B.device)
    shift = torch.sqrt(eps)  # shifted CholQR ridge
    eye = torch.eye(s, dtype=B.dtype, device=B.device)
    big = torch.tensor(1e4, dtype=B.dtype, device=B.device)

    def orth(P):
        # unit columns first (a scale-disparate panel would otherwise lose
        # its small columns below the ridge), then P <- P L^{-T} through
        # the explicit (s, s) triangular inverse: a panel combination in
        # either layout
        cn = colnorms(P)
        P = scale_cols(P, 1.0 / torch.where(cn > tiny, cn, torch.ones_like(cn)))
        L = torch.linalg.cholesky_ex(gram(P, P) + shift * eye)[0]
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        return comb(P, Linv.T)

    def solve_w(W, C):
        scale = torch.diagonal(W).abs().max() + tiny
        return torch.linalg.solve_ex(W + (eps * scale) * eye, C)[0]

    def norm(R):
        return gathered(torch.linalg.vector_norm(R))

    X = to_layout(X0)
    R = to_layout(B) - matmat(X)
    resn = norm(R)
    state = BlockCGState(X, R, orth(apply_M(R)), resn, resn, _counter(B), X, None)

    def cond(s):
        # stop on convergence, breakdown (non-finite residual) or runaway
        # divergence past any hope of recovery; the best iterate is returned
        alive = torch.isfinite(s.resn) & (s.resn < big * (s.rb + tol_eff))
        return alive & (s.resn > tol_eff) & (s.k < maxiter)

    def body(s, out=None):
        o = out or _NO_OUT_BLOCK_CG
        Q = matmat(s.P)
        W = gram(s.P, Q)
        alpha = solve_w(W, gram(s.P, s.R))
        X = torch.add(s.X, comb(s.P, alpha), out=o.X)
        R = torch.sub(s.R, comb(Q, alpha), out=o.R)
        resn = norm(R)
        better = torch.isfinite(resn) & (resn < s.rb)
        Xb = torch.where(like(better, X), X, s.Xb, out=o.Xb)
        rb = torch.where(better, resn, s.rb)
        Z = apply_M(R)
        beta = solve_w(W, gram(Q, Z))
        P = orth(Z - comb(s.P, beta))
        return BlockCGState(X, R, _put(P, o.P), _put(resn, o.resn), _put(rb, o.rb),
                            torch.add(s.k, 1, out=o.k), Xb, s.hist)

    def final(s):
        return torch.isfinite(s.resn) & (s.resn <= s.rb)

    def finish(s):
        resn = torch.where(final(s), s.resn, s.rb)
        return resn, resn <= tol_eff

    def solution(s):
        return from_layout(torch.where(like(final(s), s.X), s.X, s.Xb))

    return Loop(state, cond, body, tol_eff, maxiter, finish, solution)


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
    the best iterate.  SPD A and M assumed.  The stopping rule is computed
    on the device in B's dtype and read back once per iteration, as
    :func:`cg_solve` reads its own, so iteration counts match the JAX
    package.
    """
    return run_loop(block_cg_loop(A, B, X0, tol=tol, rtol=rtol, maxiter=maxiter, M=M,
                                  panels=panels))
