"""Shift-invert Lanczos with mixed-precision ladder solves: f64-grade
extreme eigenpairs of large SPD operators whose fast solves are f32.

Port of :mod:`sigma_tpu.eigen.shift_invert`.  A float64 Lanczos recurrence
runs on ``B = (A - sigma)^{-1}``, where every application of ``B`` is an
iterative-refinement ladder: float64 residual sweeps through a CSR matvec
and float32 inner solves (typically pruned-multigrid CG over a shifted f32
operator).  The recurrence, the reorthogonalization and the final
Rayleigh quotients are double precision.

The JAX package keeps the f64 recurrence, the basis and both CSR matvecs
on the host (scipy), because float64 could not run on its TPU stack; that
is a TPU workaround.  Here they stay on ``device`` in f64: ``A`` and
``A - sigma I`` are the port's own f64 :class:`CSRMatrix` there, and
``inner_solve`` takes and returns f32 tensors on it.  Only the k x k
tridiagonal eigenproblem runs on the host.

Shift guidance (the JAX package's measurement on the 1M-row mesh):
against a near-continuum low spectrum, ``sigma = 0`` contracts at only
~0.81 a step and ``sigma ~ 0.99 lambda_1`` breaks the f32 inner solves
(kappa(M^-1 (A - sigma)) ~ 1 / (1 - sigma / lambda_1)); the working point
is ``sigma ~ 0.9 lambda_1`` from any safe lower bound.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from sigma_tpu_torch.matrix.formats import CSRMatrix
from sigma_tpu_torch.utils.device import resolve_device

__all__ = ["shift_invert_lanczos", "ShiftInvertResult"]


class ShiftInvertResult(NamedTuple):
    # m may be smaller than requested if the Lanczos recurrence broke
    # down (invariant subspace) before m steps: check `steps`
    eigenvalues: np.ndarray  # (m,) lowest, ascending, float64
    eigenvectors: torch.Tensor  # (n, m) float64 on the device, orthonormal
    residuals: np.ndarray  # (m,) ||A v - lambda v|| per pair
    steps: int  # Lanczos steps taken


def shift_invert_lanczos(
    n,
    rows,
    cols,
    vals,
    *,
    sigma: float,
    inner_solve: Callable[[torch.Tensor], torch.Tensor],
    m: int = 3,
    k: int = 64,
    sweeps: int = 3,
    v0: Optional[np.ndarray] = None,
    seed: int = 0,
    device=None,
) -> ShiftInvertResult:
    """Lowest ``m`` eigenpairs of the SPD operator given by COO triples.

    ``sigma``: the shift (a strict lower bound on lambda_1).
    ``inner_solve(r32) -> d32``: an f32 approximate solve of
    ``(A - sigma I) d = r`` on a unit-norm f32 tensor ``r`` on ``device``
    (None: CUDA); its relative accuracy only needs to be ~1e-4 or better,
    the ladder squares it a sweep.  ``k``: Lanczos steps.  The start
    vector is ``v0``, else ``np.random.default_rng(seed)``'s normal draw.

    The device holds the (k, n) f64 basis.  Triples must be
    duplicate-free: the CSR build sums duplicates, unlike the pruned and
    DIA classes' last-value-wins packing, and mixed semantics would
    change the operator."""
    device = resolve_device(device)
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals64 = np.asarray(vals, dtype=np.float64).ravel()
    n = int(n)
    A = CSRMatrix.from_coo(n, n, rows, cols, vals64, dtype=torch.float64, device=device)
    # A - sigma*I on every row: rows with no stored diagonal triple get an
    # appended (i, i, -sigma) entry; subtracting only from stored
    # diagonals would solve the wrong resolvent there
    shifted = vals64.copy()
    dm = rows == cols
    shifted[dm] -= sigma
    present = np.zeros(n, dtype=bool)
    present[rows[dm]] = True
    missing = np.nonzero(~present)[0]
    S = CSRMatrix.from_coo(
        n, n, np.concatenate([rows, missing]), np.concatenate([cols, missing]),
        np.concatenate([shifted, np.full(missing.size, -sigma)]),
        dtype=torch.float64, device=device)

    def solve64(b):
        x = torch.zeros_like(b)
        bn = float(torch.linalg.vector_norm(b))
        for _ in range(sweeps):
            r = b - S.matvec(x)
            rn = float(torch.linalg.vector_norm(r))
            if rn < 1e-13 * bn:
                break
            d = inner_solve((r / rn).to(torch.float32))
            x = x + rn * d.to(torch.float64)
        return x

    v = (np.asarray(v0, dtype=np.float64) if v0 is not None
         else np.random.default_rng(seed).standard_normal(n))
    v = torch.from_numpy(v / np.linalg.norm(v)).to(device)
    V = torch.zeros((k, n), dtype=torch.float64, device=device)
    al = np.zeros(k)
    be = np.zeros(k)
    steps = k
    eps = np.finfo(np.float64).eps
    for i in range(k):
        V[i] = v
        w = solve64(v)
        a = torch.dot(v, w)
        w = w - a * v
        if i:
            w = w - be[i - 1] * V[i - 1]
        # two-pass full reorthogonalization (the recurrence is f64 but
        # orthogonality still decays; CGS2 is two GEMVs a pass)
        Vi = V[: i + 1]
        w = w - Vi.T @ (Vi @ w)
        w = w - Vi.T @ (Vi @ w)
        al[i], be[i] = torch.stack([a, torch.linalg.vector_norm(w)]).tolist()
        # scale-free breakdown guard: eps * n * (|a| + beta_prev)
        beta_prev = be[i - 1] if i else 0.0
        if be[i] < eps * n * (abs(al[i]) + beta_prev):
            steps = i + 1
            break
        v = w / be[i]
    T = np.diag(al[:steps]) + np.diag(be[: steps - 1], 1) + np.diag(be[: steps - 1], -1)
    th, Q = np.linalg.eigh(T)
    # breakdown before m steps: the Krylov space holds only `steps` Ritz
    # pairs; return that many
    m = min(m, steps)
    idx = np.argsort(-th)[:m]  # largest theta of (A - sigma)^{-1}
    Y = V[:steps].T @ torch.from_numpy(np.ascontiguousarray(Q[:, idx])).to(device)
    Y = Y / torch.linalg.vector_norm(Y, dim=0, keepdim=True)
    AY = A.matmat(Y)
    lam_t = (Y * AY).sum(0)
    res_t = torch.linalg.vector_norm(AY - Y * lam_t[None, :], dim=0)
    lam, res = lam_t.cpu().numpy(), res_t.cpu().numpy()
    order = np.argsort(lam)
    return ShiftInvertResult(
        eigenvalues=lam[order],
        eigenvectors=Y[:, torch.from_numpy(order).to(device)],
        residuals=res[order],
        steps=steps,
    )
