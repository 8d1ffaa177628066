"""LOBPCG: locally optimal block preconditioned conjugate gradient
eigensolver.

Port of :mod:`sigma_tpu.eigen.lobpcg`: the multi-vector eigensolver.  Each
iteration is one SpMM over the whole trial basis (``A.matmat``, the DIA
SpMM kernel on a CUDA device) plus small dense Rayleigh-Ritz algebra, and
it takes any preconditioner (``M.matmat``), such as the structured
multigrid V-cycle.  Finds the lowest m eigenpairs of symmetric A.

QR, ``eigh`` and the small Gram products are plain ``torch.linalg``, as
the JAX package leaves them to XLA.  The loop runs on the host and reads
the largest residual norm back once per iteration, so the iteration count
matches the JAX package's ``lax.while_loop``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sigma_tpu_torch.operators.linear_operator import LinearOperator

__all__ = ["LOBPCGResult", "lobpcg"]


class LOBPCGResult(NamedTuple):
    eigenvalues: torch.Tensor  # (m,) ascending
    eigenvectors: torch.Tensor  # (n, m)
    iterations: int
    residual_norms: torch.Tensor  # (m,), of the RETURNED eigenvectors
    converged: bool  # max residual <= tol at exit


def _orthonormalize(S):
    """QR with the signs fixed so that R has a nonnegative diagonal;
    degenerate columns stay (harmless in Rayleigh-Ritz)."""
    Q, R = torch.linalg.qr(S)
    signs = torch.sign(torch.diagonal(R))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return Q * signs[None, :]


def lobpcg(
    A: LinearOperator,
    X0=None,
    m: int = 4,
    *,
    M: Optional[LinearOperator] = None,
    tol: float = 1e-6,
    maxiter: int = 200,
    generator: Optional[torch.Generator] = None,
) -> LOBPCGResult:
    """Lowest-m eigenpairs of symmetric A; ``M`` is an (approximate)
    inverse preconditioner applied blockwise to the residuals.

    ``X0`` (n, m) is the starting block (its width sets m); without it the
    block is drawn from a normal distribution with ``generator`` (default:
    a generator on A's device seeded with 0), in A's dtype on A's device.

    Check ``result.converged``: without soft locking the basic iteration
    stagnates near residual ~1e-8 in float64 (converged columns make the
    [X, W, P] trial basis numerically rank-deficient), so tolerances much
    below ~1e-7 typically exhaust ``maxiter``.
    """
    n = A.shape[0]
    if X0 is None:
        dtype = getattr(A, "dtype", torch.float64)
        device = A.device
        if generator is None:
            generator = torch.Generator(device=device or "cpu").manual_seed(0)
        X0 = torch.randn((n, m), generator=generator, dtype=dtype, device=device)
    else:
        X0 = torch.as_tensor(X0, device=A.device)
        m = X0.shape[1]
    if 3 * m >= n:
        raise ValueError(f"block size {m} too large for n={n} (need 3m < n)")

    def rayleigh_ritz(S):
        AS = A.matmat(S)
        G = S.T @ AS
        lam, C = torch.linalg.eigh((G + G.T) / 2)
        C = C[:, :m]
        return lam[:m], S @ C, AS @ C

    X = _orthonormalize(X0)
    lam, X, AX = rayleigh_ritz(X)
    P = torch.zeros_like(X)
    resn = torch.linalg.vector_norm(AX - X * lam[None, :], dim=0)
    k = 0
    while k < maxiter and float(resn.max()) > tol:
        # the residual of the incoming block: the stopping test reads it,
        # so the loop stops one iteration after the block converged, as
        # the JAX package's loop does
        R = AX - X * lam[None, :]
        resn = torch.linalg.vector_norm(R, dim=0)
        W = M.matmat(R) if M is not None else R  # blockwise preconditioner
        # subspace: current block, preconditioned residuals, prior direction
        S = _orthonormalize(torch.cat([X, W, P], dim=1))
        lam_new, X_new, AX_new = rayleigh_ritz(S)
        P = X_new - X @ (X.T @ X_new)
        X, AX, lam = X_new, AX_new, lam_new
        k += 1
    # residuals of the returned iterate
    resn = torch.linalg.vector_norm(AX - X * lam[None, :], dim=0)
    return LOBPCGResult(
        eigenvalues=lam,
        eigenvectors=X,
        iterations=k,
        residual_norms=resn,
        converged=bool(resn.max() <= tol),
    )
