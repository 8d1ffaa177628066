"""Mixed-precision eigenpair refinement: inverse iteration through the
working-precision-residual / low-precision-Krylov ladder, then an exact
Rayleigh-Ritz.

Port of :mod:`sigma_tpu.eigen.refine`.  An f32 eigensolver (LOBPCG on the
10M-row Dirichlet Laplacian) stagnates with eigenvalue errors set by f32
vectors, and its own f32 Ritz values can understate that error.  One
refined inverse-iteration step per vector (``y = A^{-1} x`` amplifies mode
q by ``1/lambda_q``) followed by a working-precision Rayleigh-Ritz on the
block recovers the lost digits, with all Krylov work in the low
precision (:func:`sigma_tpu_torch.solvers.refine.refined_solve_fixed`).

The JAX package jit-compiles the column solve, the Rayleigh quotient and
the Gram pair once per module (``_fixed_col_jit``, ``_rq_jit``,
``_gram_jit``) so that a second call does not trace again; eager PyTorch
has no trace to cache, so they are plain calls here.  The f64 block
products are ``A.matmat`` (the DIA SpMM kernel on a CUDA DIA operator);
only the m x m Gram pair comes to the host for ``scipy.linalg.eigh``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sigma_tpu_torch.solvers.refine import refined_solve, refined_solve_fixed

__all__ = ["refine_eigenpairs", "RefinedEigenpairs"]


class RefinedEigenpairs(NamedTuple):
    eigenvalues: np.ndarray  # (m,) ascending, working precision
    eigenvectors: torch.Tensor  # (n, m) working precision, on A's device
    rayleigh_before: np.ndarray  # working-precision RQ of the INPUT block


def refine_eigenpairs(
    A,
    V,
    *,
    M_lo=None,
    inner_solve=None,
    steps: int = 1,
    rtol: float = 1e-12,
    max_outer: int = 8,
    inner_tol: float = 1e-6,
    inner_maxiter: int = 300,
    A_lo=None,
    inner_dtype=torch.float32,
    use_fixed: bool = True,
) -> RefinedEigenpairs:
    """Refine approximate eigenvectors ``V`` (n, m) of SPD ``A`` toward
    the lowest eigenpairs.

    ``A`` is the working-precision operator (e.g. f64); each of the
    ``steps`` sweeps applies one inverse-iteration step per column via
    the mixed-precision refinement ladder (low-precision inner CG,
    optionally preconditioned by ``M_lo``; or a custom
    ``inner_solve(r_lo) -> d_lo``), then a working-precision
    Rayleigh-Ritz on the refined block separates the low cluster.

    By default (``use_fixed=True``, no ``inner_solve``) each column runs
    :func:`refined_solve_fixed` for a sweep count that follows from the
    tolerances, ``min(max_outer, ceil(log rtol / log min(inner_tol, 0.5))
    + 1)`` (``max_outer`` when ``rtol <= 0``); ``use_fixed=False`` runs the
    early-exit :func:`refined_solve`.  ``A_lo`` reuses a low-precision
    operator instead of casting ``A`` to ``inner_dtype``.

    Returns working-precision eigenvalues (ascending, numpy), the Ritz
    vectors (on A's device) and the Rayleigh quotients of the input
    block, the honest accuracy of what was passed in."""
    import scipy.linalg as sla

    V = torch.as_tensor(V).to(device=A.device, dtype=getattr(A, "dtype", torch.float64))
    n, m = V.shape

    fixed = inner_solve is None and use_fixed
    if fixed:
        if A_lo is None:
            A_lo = A.astype(inner_dtype)
        # each sweep contracts the residual by ~inner_tol, so the sweep
        # count follows from the tolerance ratio (+1 margin); rtol <= 0 is
        # the solver layer's "absolute tol only" sentinel (log(0) would
        # overflow): the full budget
        if rtol <= 0.0:
            sweeps = max_outer
        else:
            sweeps = min(max_outer,
                         int(np.ceil(np.log(rtol) / np.log(min(inner_tol, 0.5)))) + 1)

    AV = A.matmat(V)
    rq_before = np.sort(((V * AV).sum(0) / (V * V).sum(0)).cpu().numpy())

    for _ in range(max(steps, 1)):
        cols = []
        for j in range(m):
            b = V[:, j].contiguous()
            if fixed:
                y = refined_solve_fixed(A, b, A_lo=A_lo, sweeps=sweeps, inner_rtol=inner_tol,
                                        inner_maxiter=inner_maxiter, M=M_lo,
                                        inner_dtype=inner_dtype)
            else:
                y, _ = refined_solve(A, b, tol=0.0, rtol=rtol, M_lo=M_lo, A_lo=A_lo,
                                     inner_dtype=inner_dtype, inner_solve=inner_solve,
                                     max_outer=max_outer, inner_tol=inner_tol,
                                     inner_maxiter=inner_maxiter)
            cols.append(y / torch.linalg.vector_norm(y))
        V = torch.stack(cols, dim=1)
        if steps > 1:
            # reorthogonalize between sweeps: per-column inverse iteration
            # collapses the block toward the lowest mode, and a singular
            # V^T V breaks the final generalized Rayleigh-Ritz
            V, _ = torch.linalg.qr(V)

    # working-precision Rayleigh-Ritz on the refined block; only the m x m
    # Gram pair comes to the host
    G = (V.T @ V).cpu().numpy()
    H = (V.T @ A.matmat(V)).cpu().numpy()
    H = 0.5 * (H + H.T)
    w, Q = sla.eigh(H, G)
    order = np.argsort(w)
    Vr = V @ torch.from_numpy(Q[:, order]).to(device=V.device, dtype=V.dtype)
    Vr = Vr / torch.linalg.vector_norm(Vr, dim=0, keepdim=True)
    return RefinedEigenpairs(eigenvalues=w[order], eigenvectors=Vr, rayleigh_before=rq_before)
