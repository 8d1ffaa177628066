"""Composable linear operators on torch tensors.

Port of :mod:`sigma_tpu.operators.linear_operator`.  The same small
algebra: ``A + B``, ``A @ B``, ``alpha * A`` and ``A.T`` build lazy
composite nodes whose ``matvec`` recurses into the children.

Operators are immutable values, so every class here is a frozen
dataclass rather than an ``nn.Module`` (nothing in them is trained).  An
operator keeps its tensors on one device; :attr:`LinearOperator.device`
reports it and :meth:`LinearOperator.to` returns a copy on another.
There is no jit, pytree or ``register_dataclass`` machinery: PyTorch runs
eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "LinearOperator",
    "SumOperator",
    "ProductOperator",
    "AdjointOperator",
    "ScaledOperator",
    "IdentityOperator",
    "DiagonalOperator",
    "DenseOperator",
    "MatvecOperator",
    "OperatorWithSolver",
    "aslinearoperator",
    "attach_solver",
    "move_to",
]


def move_to(value, device):
    """``value`` with every tensor inside it on ``device``: tensors, tuples
    and (frozen) dataclass instances, recursively; anything else as is."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, tuple):
        return tuple(move_to(v, device) for v in value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return dataclasses.replace(
            value,
            **{
                f.name: move_to(getattr(value, f.name), device)
                for f in dataclasses.fields(value)
                if f.init
            },
        )
    return value


def _find_device(value) -> Optional[torch.device]:
    if isinstance(value, torch.Tensor):
        return value.device
    if isinstance(value, tuple):
        children = value
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        children = [getattr(value, f.name) for f in dataclasses.fields(value)]
    else:
        return None
    for child in children:
        dev = _find_device(child)
        if dev is not None:
            return dev
    return None


class LinearOperator:
    """Protocol: anything with a shape, ``matvec`` and ``rmatvec``."""

    shape: Tuple[int, int]

    # -- device ----------------------------------------------------------------
    @property
    def device(self) -> Optional[torch.device]:
        """Device of the operator's tensors (None when it holds none)."""
        return _find_device(self)

    def to(self, device) -> "LinearOperator":
        """A copy of this operator with every tensor on ``device``."""
        return move_to(self, torch.device(device))

    # -- core products -------------------------------------------------------
    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """Transpose product A^T x (``matvec_t``)."""
        raise NotImplementedError

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Multi-vector product A @ X for X of shape (m, k), one column at
        a time."""
        return torch.stack(
            [self.matvec(X[:, j].contiguous()) for j in range(X.shape[1])], dim=1
        )

    def rmatmat(self, X: torch.Tensor) -> torch.Tensor:
        return torch.stack(
            [self.rmatvec(X[:, j].contiguous()) for j in range(X.shape[1])], dim=1
        )

    def dot(self, x: torch.Tensor) -> torch.Tensor:
        """matvec for 1-D x, matmat for 2-D x."""
        if x.ndim == 1:
            return self.matvec(x)
        if x.ndim == 2:
            return self.matmat(x)
        raise ValueError(f"operand must be 1- or 2-D, got shape {tuple(x.shape)}")

    # -- probes ----------------------------------------------------------------
    def get_value(self, i: int, j: int) -> float:
        """Entry probe by a matvec with the basis vector e_j (float64, as
        :meth:`to_dense`), the generic fallback; matrices override it
        with a direct lookup."""
        e = torch.zeros(self.shape[1], dtype=torch.float64, device=self.device)
        e[j] = 1.0
        return float(self.matvec(e)[i])

    def to_dense(self) -> np.ndarray:
        """Dense mirror, probed with a float64 identity (exact for float32
        and bfloat16 values under the operand-dtype convention)."""
        eye = torch.eye(self.shape[1], dtype=torch.float64, device=self.device)
        return self.matmat(eye).cpu().numpy()

    # -- algebra sugar ---------------------------------------------------------
    def __add__(self, other: "LinearOperator") -> "LinearOperator":
        return SumOperator.of(self, other)

    def __sub__(self, other: "LinearOperator") -> "LinearOperator":
        return SumOperator.of(self, ScaledOperator(-1.0, other))

    def __mul__(self, alpha) -> "LinearOperator":
        return ScaledOperator(alpha, self)

    __rmul__ = __mul__

    def __neg__(self) -> "LinearOperator":
        return ScaledOperator(-1.0, self)

    def __matmul__(self, other):
        if isinstance(other, LinearOperator):
            return ProductOperator.of(self, other)
        return self.dot(torch.as_tensor(other))

    @property
    def T(self) -> "LinearOperator":
        return AdjointOperator(self)

    adjoint = T

    # -- solve facade ----------------------------------------------------------
    def solve(self, b: torch.Tensor, solver=None, preconditioner=None, **kw):
        """Solve A x = b with ``solver`` (anything with ``solve(A, b,
        M=...)``, see :mod:`sigma_tpu_torch.solvers`), CG by default.
        ``**kw`` configures the default CG only: passing it with an
        explicit ``solver`` raises ``TypeError`` (dropping ``tol=`` or
        ``maxiter=`` silently would return an under-converged x)."""
        if solver is None:
            from sigma_tpu_torch.solvers.base import cg

            solver = cg(**kw)
        elif kw:
            raise TypeError(
                f"solver parameters {sorted(kw)} must be set on the passed solver "
                "object (they configure the default CG only)"
            )
        return solver.solve(self, b, M=preconditioner)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(shape={self.shape})"


def _check_same_shape(ops: Sequence[LinearOperator]) -> Tuple[int, int]:
    shape = ops[0].shape
    for op in ops[1:]:
        if op.shape != shape:
            raise ValueError(
                f"operator shape mismatch in sum: {shape} vs {op.shape}"
            )
    return shape


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class SumOperator(LinearOperator):
    """Lazy A + B (+ ...): matvec is the sequential accumulation of the
    children's matvecs."""

    terms: Tuple[LinearOperator, ...]

    @classmethod
    def of(cls, *ops: LinearOperator) -> "SumOperator":
        flat: list[LinearOperator] = []
        for op in ops:
            if isinstance(op, SumOperator):
                flat.extend(op.terms)
            else:
                flat.append(op)
        _check_same_shape(flat)
        return cls(terms=tuple(flat))

    @property
    def shape(self):
        return self.terms[0].shape

    def matvec(self, x):
        y = self.terms[0].matvec(x)
        for op in self.terms[1:]:
            y = y + op.matvec(x)
        return y

    def rmatvec(self, x):
        y = self.terms[0].rmatvec(x)
        for op in self.terms[1:]:
            y = y + op.rmatvec(x)
        return y

    def matmat(self, X):
        Y = self.terms[0].matmat(X)
        for op in self.terms[1:]:
            Y = Y + op.matmat(X)
        return Y

    def rmatmat(self, X):
        Y = self.terms[0].rmatmat(X)
        for op in self.terms[1:]:
            Y = Y + op.rmatmat(X)
        return Y


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class ProductOperator(LinearOperator):
    """Lazy A @ B (@ ...): matvec applies the factors right to left,
    rmatvec left to right."""

    factors: Tuple[LinearOperator, ...]

    @classmethod
    def of(cls, *ops: LinearOperator) -> "ProductOperator":
        flat: list[LinearOperator] = []
        for op in ops:
            if isinstance(op, ProductOperator):
                flat.extend(op.factors)
            else:
                flat.append(op)
        for a, b in zip(flat[:-1], flat[1:]):
            if a.shape[1] != b.shape[0]:
                raise ValueError(
                    f"operator product dimension mismatch: {a.shape} @ {b.shape}"
                )
        return cls(factors=tuple(flat))

    @property
    def shape(self):
        return (self.factors[0].shape[0], self.factors[-1].shape[1])

    def matvec(self, x):
        for op in reversed(self.factors):
            x = op.matvec(x)
        return x

    def rmatvec(self, x):
        for op in self.factors:
            x = op.rmatvec(x)
        return x

    def matmat(self, X):
        for op in reversed(self.factors):
            X = op.matmat(X)
        return X

    def rmatmat(self, X):
        for op in self.factors:
            X = op.rmatmat(X)
        return X


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class AdjointOperator(LinearOperator):
    """Lazy transpose: matvec and rmatvec trade places."""

    op: LinearOperator

    @property
    def shape(self):
        n, m = self.op.shape
        return (m, n)

    def matvec(self, x):
        return self.op.rmatvec(x)

    def rmatvec(self, x):
        return self.op.matvec(x)

    def matmat(self, X):
        return self.op.rmatmat(X)

    def rmatmat(self, X):
        return self.op.matmat(X)

    @property
    def T(self):
        return self.op


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class ScaledOperator(LinearOperator):
    """alpha * A, with alpha a Python number or a 0-d tensor."""

    alpha: Any
    op: LinearOperator

    @property
    def shape(self):
        return self.op.shape

    def matvec(self, x):
        return self.alpha * self.op.matvec(x)

    def rmatvec(self, x):
        return self.alpha * self.op.rmatvec(x)

    def matmat(self, X):
        return self.alpha * self.op.matmat(X)

    def rmatmat(self, X):
        return self.alpha * self.op.rmatmat(X)


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class IdentityOperator(LinearOperator):
    n: int

    @property
    def shape(self):
        return (self.n, self.n)

    def matvec(self, x):
        return x

    rmatvec = matvec

    def matmat(self, X):
        return X

    rmatmat = matmat


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class DiagonalOperator(LinearOperator):
    diag: torch.Tensor

    @property
    def shape(self):
        return (self.diag.shape[0], self.diag.shape[0])

    def matvec(self, x):
        return self.diag * x

    rmatvec = matvec

    def matmat(self, X):
        return self.diag[:, None] * X

    rmatmat = matmat


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class DenseOperator(LinearOperator):
    """Dense matrix as an operator (tests and oracles)."""

    mat: torch.Tensor

    @property
    def shape(self):
        return tuple(self.mat.shape)

    def matvec(self, x):
        return self.mat @ x

    def rmatvec(self, x):
        return self.mat.T @ x

    def matmat(self, X):
        return self.mat @ X

    def rmatmat(self, X):
        return self.mat.T @ X

    def to_dense(self):
        return self.mat.cpu().numpy()


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class MatvecOperator(LinearOperator):
    """Wrap arbitrary matvec/rmatvec callables ``f(params, x)``."""

    params: Any  # tensors (or a tuple/dataclass of them) the callables use
    mv: Callable
    rmv: Optional[Callable]
    shape: Tuple[int, int]

    def matvec(self, x):
        return self.mv(self.params, x)

    def rmatvec(self, x):
        if self.rmv is None:
            raise NotImplementedError("no rmatvec supplied")
        return self.rmv(self.params, x)


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class OperatorWithSolver(LinearOperator):
    """An operator with an attached solver and preconditioner: products
    are the operator's, :meth:`solve` runs the attached solver on it."""

    op: LinearOperator
    solver: Any
    preconditioner: Any = None

    # explicit-disable sentinel: preconditioner=None means "solve
    # unpreconditioned", not "fall back to the attached one"
    _UNSET = object()

    @property
    def shape(self):
        return self.op.shape

    def matvec(self, x):
        return self.op.matvec(x)

    def rmatvec(self, x):
        return self.op.rmatvec(x)

    def matmat(self, X):
        return self.op.matmat(X)

    def solve(self, b, solver=None, preconditioner=_UNSET):
        # no **kw: solver parameters live on the attached solver object
        M = self.preconditioner if preconditioner is OperatorWithSolver._UNSET else preconditioner
        return (self.solver if solver is None else solver).solve(self.op, b, M=M)


def attach_solver(op: LinearOperator, solver, preconditioner=None) -> OperatorWithSolver:
    return OperatorWithSolver(op=op, solver=solver, preconditioner=preconditioner)


def aslinearoperator(A) -> LinearOperator:
    if isinstance(A, LinearOperator):
        return A
    A = torch.as_tensor(A)
    if A.ndim != 2:
        raise ValueError("expected a 2-D array or LinearOperator")
    return DenseOperator(A)
