"""Lanczos eigensolvers.

Port of :mod:`sigma_tpu.eigen.lanczos`: the k-step symmetric Lanczos
process with full reorthogonalization (:func:`lanczos`), its generalized
form for the pencil A x = lam B x with one ``B.solve`` a step
(:func:`generalized_lanczos`), and the tridiagonal eigensolve with Ritz
vectors (:func:`eigensolve`, :func:`generalized_eigensolve`).

The numerics are the JAX loops': two-pass classical Gram-Schmidt
reorthogonalization against the filled basis, the scale-free breakdown
threshold ``eps * n * (|a| + beta_prev)``, ``beta = 0`` on breakdown and a
fresh random direction built only then.  The JAX package runs the loop as
one ``lax.fori_loop`` over a dense ``(n, k + 1)`` basis whose unfilled
columns are zero, with the restart inside a ``lax.cond`` (a TPU program
has no host branch); here the loop runs on the host over a ``(k + 1, n)``
basis, projects only its filled rows (the zero columns add exact zeros
there) and reads ``a`` and ``b`` back once a step to take the breakdown
branch, the loop's one sync.  The restart directions come from a
``torch.Generator`` on the basis's device seeded 17 (:func:`lanczos`) or
23 (:func:`generalized_lanczos`), the JAX keys' numbers, drawn in turn;
the JAX package folds the step number into its key instead, so restart
vectors differ between the packages (the basis stays orthonormal and
the Ritz values are the same).  The products of the reorthogonalization
and the small ``eigh`` are ``torch`` GEMVs and ``torch.linalg.eigh``, as
the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sigma_tpu_torch.operators.linear_operator import LinearOperator
from sigma_tpu_torch.utils.device import resolve_device

__all__ = [
    "LanczosResult",
    "lanczos",
    "generalized_lanczos",
    "eigensolve",
    "generalized_eigensolve",
]

_BREAKDOWN = 1e-300  # guard against division by ~0 at invariant subspaces


class LanczosResult(NamedTuple):
    """Tridiagonal coefficients + orthonormal basis.

    ``alpha`` (k,): diagonal of T; ``beta`` (k,): off-diagonals, where
    ``beta[j]`` couples columns j and j+1 and ``beta[k-1]`` is the norm of
    the final residual; ``V`` (n, k): the Lanczos basis (a view of the
    basis rows, so ``V[:, j]`` is contiguous); ``v_next`` (n,): the
    (k+1)-th vector completing the three-term recurrence
    ``A V = V T + beta[k-1] v_next e_k^T``.
    """

    alpha: torch.Tensor
    beta: torch.Tensor
    V: torch.Tensor
    v_next: torch.Tensor

    def tridiagonal(self) -> torch.Tensor:
        """Materialize T as a dense (k, k) symmetric tridiagonal."""
        k = self.alpha.shape[0]
        T = torch.diag(self.alpha)
        if k > 1:
            T = T + torch.diag(self.beta[: k - 1], 1) + torch.diag(self.beta[: k - 1], -1)
        return T


def _setup(A, ops, k, v0, generator):
    """(k, v_start): the step count checked against n and the start
    vector in the working dtype on the operators' device.  The dtype is
    A's, else a given v0's, else float64; the device the first operator's
    that holds a tensor, else v0's, else the generator's, else CUDA
    (``resolve_device``: a matrix-free operator runs on the card unless
    given a start vector or a generator on another device)."""
    n = A.shape[0]
    if k is None:
        k = n
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range [1, {n}]")
    device = next((op.device for op in ops if op.device is not None), None)
    if v0 is not None:
        v0 = torch.as_tensor(v0)
        device = v0.device if device is None else device
    if device is None:
        device = generator.device if generator is not None else resolve_device(None)
    dtype = getattr(A, "dtype", None)
    if dtype is None:
        dtype = v0.dtype if v0 is not None and v0.is_floating_point() else torch.float64
    if v0 is not None:
        return int(k), v0.to(device=device, dtype=dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return int(k), torch.randn(n, generator=generator, dtype=dtype, device=device)


def _safe_normalize(w, norm):
    return w * (1.0 / norm if norm > _BREAKDOWN else 0.0)


def _tol_b(dtype, a, beta_prev, n):
    """Breakdown threshold scaled by the running recurrence magnitude
    |a| + beta_prev, not max(|a|, 1): an O(1) floor mistakes every step
    of a small-scaled operator (an h^3-scaled FEM mass pencil in f32,
    where a ~ 1e-4 < eps * n) for a breakdown and silently replaces the
    whole basis with random restarts."""
    return torch.finfo(dtype).eps * (abs(a) + beta_prev) * n


def _result(Vb, alpha, beta, k):
    t = dict(dtype=Vb.dtype, device=Vb.device)
    return LanczosResult(alpha=torch.tensor(alpha, **t), beta=torch.tensor(beta, **t),
                         V=Vb[:k].T, v_next=Vb[k])


def lanczos(
    A: LinearOperator,
    k: Optional[int] = None,
    v0=None,
    *,
    generator: Optional[torch.Generator] = None,
    reorth_passes: int = 2,
) -> LanczosResult:
    """k-step symmetric Lanczos process on operator A (default k = n).

    ``v0`` is the start vector; without it one is drawn from a normal
    distribution with ``generator`` (default: seeded 0 on the device)."""
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"lanczos needs a square operator, got {A.shape}")
    n = A.shape[0]
    k, v_start = _setup(A, (A,), k, v0, generator)
    dtype, device = v_start.dtype, v_start.device
    restart = torch.Generator(device=device).manual_seed(17)
    Vb = torch.zeros((k + 1, n), dtype=dtype, device=device)
    Vb[0] = v_start / torch.linalg.vector_norm(v_start)
    alpha, beta = [], []
    for j in range(k):
        Vf = Vb[: j + 1]  # the filled rows
        v = Vb[j]
        w = A.matvec(v)
        a = torch.dot(v, w)
        w = w - a * v
        for _ in range(reorth_passes):
            w = w - Vf.T @ (Vf @ w)
        b = torch.linalg.vector_norm(w)
        a, b = torch.stack([a, b]).tolist()  # the step's one sync
        beta_prev = beta[j - 1] if j else 0.0
        if b > _tol_b(dtype, a, beta_prev, n):
            Vb[j + 1] = _safe_normalize(w, b)
        else:
            # breakdown (invariant subspace): beta = 0, and the basis
            # restarts with a fresh orthogonalized random direction; zero
            # rows would surface as spurious eigenvalue-0 Ritz pairs
            fresh = torch.randn(n, generator=restart, dtype=dtype, device=device)
            for _ in range(reorth_passes):
                fresh = fresh - Vf.T @ (Vf @ fresh)
            Vb[j + 1] = fresh / max(float(torch.linalg.vector_norm(fresh)), _BREAKDOWN)
            b = 0.0
        alpha.append(a)
        beta.append(b)
    return _result(Vb, alpha, beta, k)


def generalized_lanczos(
    A: LinearOperator,
    B: LinearOperator,
    k: Optional[int] = None,
    v0=None,
    *,
    generator: Optional[torch.Generator] = None,
    reorth_passes: int = 2,
) -> LanczosResult:
    """k-step Lanczos for the pencil A x = lam B x (default k = n).

    Every step applies ``B.solve``: attach a solver with
    ``attach_solver(B, cg(...))`` to control it; a bare operator uses the
    default CG facade.  The basis is B-orthonormal, ``V^T B V = I``, and
    the recurrence is ``B^{-1} A V = V T + beta[k-1] v_next e_k^T``."""
    if A.shape != B.shape or A.shape[0] != A.shape[1]:
        raise ValueError(f"pencil shape mismatch A={A.shape}, B={B.shape}")
    n = A.shape[0]
    k, v_start = _setup(A, (A, B), k, v0, generator)
    dtype, device = v_start.dtype, v_start.device
    restart = torch.Generator(device=device).manual_seed(23)

    def b_norm(w):
        return torch.sqrt(torch.clamp(torch.dot(w, B.matvec(w)), min=0.0))

    Vb = torch.zeros((k + 1, n), dtype=dtype, device=device)
    Vb[0] = _safe_normalize(v_start, float(torch.sqrt(torch.dot(v_start, B.matvec(v_start)))))
    alpha, beta = [], []
    for j in range(k):
        Vf = Vb[: j + 1]
        v = Vb[j]
        u = A.matvec(v)
        a = torch.dot(u, v)  # <B^-1 A v, v>_B = v^T A v
        w = B.solve(u)
        w = w - a * v
        # full B-reorthogonalization: w -= V (V^T B w)
        for _ in range(reorth_passes):
            w = w - Vf.T @ (Vf @ B.matvec(w))
        b = b_norm(w)
        a, b = torch.stack([a, b]).tolist()
        beta_prev = beta[j - 1] if j else 0.0
        if b > _tol_b(dtype, a, beta_prev, n):
            Vb[j + 1] = _safe_normalize(w, b)
        else:
            # the restart costs reorth_passes + 1 more B products, paid
            # only on a breakdown
            fresh = torch.randn(n, generator=restart, dtype=dtype, device=device)
            for _ in range(reorth_passes):
                fresh = fresh - Vf.T @ (Vf @ B.matvec(fresh))
            Vb[j + 1] = _safe_normalize(fresh, float(b_norm(fresh)))
            b = 0.0
        alpha.append(a)
        beta.append(b)
    return _result(Vb, alpha, beta, k)


def _ritz(result: LanczosResult):
    """Tridiagonal eigendecomposition + Ritz vectors, each signed so that
    its largest-magnitude component is positive."""
    lam, Q = torch.linalg.eigh(result.tridiagonal())
    V = result.V @ Q
    idx = torch.argmax(V.abs(), dim=0)
    signs = torch.sign(V[idx, torch.arange(V.shape[1], device=V.device)])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return lam, V * signs


def eigensolve(A: LinearOperator, k: Optional[int] = None, v0=None, *, generator=None):
    """Eigenvalues + Ritz vectors of symmetric A via Lanczos: returns
    (lam ascending, V columns)."""
    return _ritz(lanczos(A, k, v0, generator=generator))


def generalized_eigensolve(A: LinearOperator, B: LinearOperator, k: Optional[int] = None,
                           v0=None, *, generator=None):
    """Generalized eigenvalues of A x = lam B x, with B-orthonormal Ritz
    vectors."""
    return _ritz(generalized_lanczos(A, B, k, v0, generator=generator))
