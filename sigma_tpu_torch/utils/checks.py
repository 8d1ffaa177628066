"""Numerical-safety instrumentation: NaN/Inf checks around a computation
and structural validation of a matrix.

Port of :mod:`sigma_tpu.utils.checks` (the reference's only sanitizers are
compiler flags, ``-fbounds-check``, and its error handling is ``print +
exit(1)``).  The JAX package wraps ``checkify``; torch has no counterpart,
so the float checks here are a ``torch.overrides.TorchFunctionMode``:
while it is on, every floating tensor that a torch function or tensor
method returns is tested with ``torch.isfinite(...).all()``, and the first
failure raises ``FloatingPointError`` naming the op and "nan" or "inf".
Allocations and explicit fills (``empty``, ``full`` and their kin) are not
tested: their values were not computed.
Each test reads one flag back to the host, so a checked run is slow (a
device synchronisation an op); it is for finding where a NaN starts.

The port's CUDA kernels are launched through ctypes, which the mode does
not see: a NaN a kernel writes is caught at the first torch op that reads
it (in a solver, the next dot product).

* :func:`checked`: wrap a function to run under the checks.
* :func:`checked_solve`: a solve (e.g. ``cg_solve``) under the checks.
* :func:`debug_nans`: the checks for a ``with`` block.
* :func:`validate_matrix`: host-side structural validation of a matrix.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from sigma_tpu_torch.matrix.formats import BSRMatrix, DIAMatrix, ELLMatrix
from sigma_tpu_torch.matrix.pruned import PrunedDIAMatrix
from sigma_tpu_torch.matrix.symmetric import SymmetricDIAMatrix

__all__ = ["checked", "checked_solve", "debug_nans", "validate_matrix"]


# ops whose values are not computed: uninitialized allocations (a kernel
# wrapper's output buffer before the launch) and explicit fills (a solve's
# NaN-filled residual history)
_NOT_COMPUTED = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                           "new_empty_strided", "full", "full_like", "new_full", "fill_"})


def _op_name(func) -> str:
    return getattr(func, "__qualname__", None) or getattr(func, "__name__", repr(func))


def _check(func, out):
    if isinstance(out, torch.Tensor):
        if (out.is_floating_point() or out.is_complex()) and not bool(torch.isfinite(out).all()):
            kind = "nan" if bool(torch.isnan(out).any()) else "inf"
            raise FloatingPointError(f"{kind} produced by {_op_name(func)}")
    elif isinstance(out, (tuple, list)):
        for o in out:
            _check(func, o)


class _FiniteMode(TorchFunctionMode):
    """Raises ``FloatingPointError`` at the first torch op whose floating
    output is not finite (the mode is off inside its own handler, so the
    test itself is not checked)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "__name__", None) not in _NOT_COMPUTED:
            _check(func, out)
        return out


def checked(fn, errors=None):
    """``fn`` wrapped to run under the float checks: a NaN or Inf that any
    torch op inside it produces raises ``FloatingPointError``.

    ``errors`` is the JAX package's ``checkify`` error set; None means the
    float checks, the one set the port runs.  Any other set (index or
    user checks) raises ``NotImplementedError``: torch has no counterpart
    to check it with."""
    if errors is not None:
        raise NotImplementedError(
            f"checked(errors={errors!r}): the port runs the float checks only (errors=None)"
        )

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _FiniteMode():
            return fn(*args, **kwargs)

    return wrapped


def checked_solve(solver_fn, A, b, *args, **kwargs):
    """Run a solve (e.g. ``cg_solve``) under the float checks: a NaN or Inf
    generated inside the iteration raises instead of silently reaching the
    result."""
    return checked(solver_fn)(A, b, *args, **kwargs)


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """The float checks for the ``with`` block when ``enable`` is true (the
    JAX package toggles ``jax_debug_nans`` here); a no-op otherwise."""
    if not enable:
        yield
        return
    with _FiniteMode():
        yield


def _true_slots(A) -> torch.Tensor:
    """Bool tensor shaped like ``A.data``: True at each stored slot that
    holds an entry of A, False at padding."""
    dev = A.data.device
    if isinstance(A, (DIAMatrix, SymmetricDIAMatrix)):
        n, m = A.shape
        i = torch.arange(A.data.shape[1], device=dev)[None, :]
        j = i + A.offsets_dev[:, None]
        return (i < n) & (j >= 0) & (j < m)
    if isinstance(A, ELLMatrix):
        g = A.graph
        return torch.from_numpy(np.arange(g.width)[None, :] < g.degrees[:, None]).to(dev)
    if isinstance(A, BSRMatrix):
        return A.graph.mask
    if isinstance(A, PrunedDIAMatrix):
        n, m = A.shape
        TR = A.tile_rows
        counts = A.tile_ptr[1:] - A.tile_ptr[:-1]
        tile = torch.repeat_interleave(torch.arange(counts.numel(), device=dev), counts)
        active = torch.arange(A.data.shape[0], device=dev) < A.tile_end[tile]
        row = tile[:, None] * TR + torch.arange(TR, device=dev)[None, :]
        col = row + A.offsets[:, None]
        return active[:, None] & (row < n) & (col >= 0) & (col < m)
    # CSR, COO, CSC: every stored value is an entry
    return torch.ones_like(A.data, dtype=torch.bool)


def validate_matrix(A) -> None:
    """Structural validation of a matrix: every entry's row and column in
    range, every stored value finite, and every padding slot (DIA slots
    outside the matrix, ELL slots past a row's degree, BSR padding blocks
    and block slots that are no edge, pruned padding slots and slots
    outside the matrix) exactly 0, checked slot by slot.  Raises
    ``ValueError`` naming the first violation."""
    n, m = A.shape
    rows, cols, _ = (A.to_dia() if isinstance(A, SymmetricDIAMatrix) else A).entries()
    if rows.size:
        if rows.min() < 0 or rows.max() >= n:
            raise ValueError(f"row index out of range [0, {n}): [{rows.min()}, {rows.max()}]")
        if cols.min() < 0 or cols.max() >= m:
            raise ValueError(f"column index out of range [0, {m}): [{cols.min()}, {cols.max()}]")
    finite = torch.isfinite(A.data)
    if not bool(finite.all()):
        raise ValueError(f"matrix holds {int((~finite).sum())} non-finite value slot(s)")
    bad = int(((A.data != 0) & ~_true_slots(A)).sum())
    if bad:
        raise ValueError(f"{bad} padded slot(s) carry nonzero values (padding invariant broken)")
