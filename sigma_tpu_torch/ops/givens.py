"""GMRES's scalar tail of one Arnoldi step: the kernel wrapper, its plain
PyTorch version, its launch count.

Replaces no Pallas kernel: it is the device form of the tail of the JAX
package's ``_cgs2_column`` and of its ``_givens_update``
(``sigma_tpu/solvers/krylov.py``), which XLA fuses inside the compiled
GMRES loop.  One Arnoldi step's two CGS2 projections and ``||w||`` become
the Hessenberg column (with the breakdown test) and the divisor of the
next basis row; the column goes through the earlier rotations, the new
rotation is made and folded into the triangular factor, the rotations and
the rotated right-hand side, and the next step's predicate is written to
the device, so that a captured step (:mod:`~sigma_tpu_torch.solvers.graphed`)
reads nothing back.

The CUDA kernel lives in ``sigma_tpu_torch/csrc/givens.cu`` (one warp, one
launch a step).  A CPU ``h1`` goes to :func:`givens_update_reference`, a
CUDA one to the kernel, and anything the kernel does not take raises.  The two do the same
correctly rounded operations in the same order, so they agree bit for bit.
"""

from __future__ import annotations

import math

import torch

from sigma_tpu_torch.ops import _build

__all__ = ["GIVENS_DTYPES", "empty_warp", "givens_small_dtype", "givens_update",
           "givens_update_reference"]

# b's dtypes, by the kernel's code; the small arrays are givens_small_dtype's
GIVENS_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2, torch.float16: 3}


def givens_small_dtype(dtype):
    """The dtype of GMRES's small arrays (the Hessenberg column, the
    rotations, the triangular factor) for b's ``dtype``: b's, with the
    16-bit floats widened to float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _rotate(h, R, cs, sn, g, est, inner, jdev, k, tol, j, maxiter):
    """The Givens update of the Hessenberg column ``h``, in place."""
    m = R.shape[0]
    cur = h[0]
    for i in range(j):
        c, s, nxt = cs[i], sn[i], h[i + 1]
        R[i, j] = c * cur + s * nxt
        cur = -s * cur + c * nxt
    low = h[j + 1]
    denom = torch.sqrt(cur * cur + low * low)
    safe = denom > 0
    one = torch.ones_like(denom)
    c = torch.where(safe, cur / torch.where(safe, denom, one), one)
    s = torch.where(safe, low / torch.where(safe, denom, one), torch.zeros_like(denom))
    cs[j] = c
    sn[j] = s
    gj = g[j].clone()
    g[j + 1] = -s * gj
    g[j] = c * gj
    R[j, j] = denom
    est.copy_(g[j + 1].abs())
    inner.copy_((est > tol) & (j + 1 < m) & (k + (j + 1) < maxiter))
    jdev.fill_(j + 1)


def givens_update_reference(h1, h2, wn, eps10, h, d, R, cs, sn, g, est, inner, jdev, k, tol,
                            j: int, maxiter: int):
    """The plain version of :func:`givens_update`, in place, with torch ops
    on any device."""
    # the CGS2 column: [h1 + h2, ||w||] in the small dtype; a breakdown
    # (||w|| <= eps10) zeroes h[j + 1] and makes the divisor inf
    col = torch.cat([h1 + h2, wn[None]]).to(eps10.dtype)
    ok = col[j + 1] > eps10
    d.copy_(torch.where(ok, wn, torch.full_like(wn, math.inf)))
    col[j + 1] *= ok
    h[: j + 2] = col
    _rotate(col, R, cs, sn, g, est, inner, jdev, k, tol, j, maxiter)


def givens_update(h1, h2, wn, eps10, h, d, R, cs, sn, g, est, inner, jdev, k, tol,
                  j: int, maxiter: int):
    """Step ``j``'s scalar tail of a restart cycle of m = ``R.shape[0]``
    steps, in place.

    ``h1`` and ``h2`` are the step's two CGS2 projections (j + 1 entries
    each) and ``wn`` (0-d) is ||w||, all in b's dtype, one of
    :data:`GIVENS_DTYPES`; ``d`` (0-d) is of that dtype too.  ``eps10``
    and ``tol`` (0-d), ``h`` (at least j + 2 entries), ``R`` (m, m), ``cs``,
    ``sn`` (m,), ``g`` (m + 1,) and ``est`` (0-d) are in
    :func:`givens_small_dtype` of it.  Writes h[:j + 2] = [h1 + h2, ||w||]
    (h1 + h2 rounded in b's dtype, then widened) with h[j + 1] = 0 where
    ||w|| <= eps10, ``d`` = ||w|| there or else inf, then R[:j + 1, j],
    cs[j], sn[j], g[j], g[j + 1], ``est`` = |g[j + 1]|, ``inner`` (0-d
    bool) = ``(est > tol) & (j + 1 < m) & (k + j + 1 < maxiter)`` with
    ``k`` the 0-d int64 count of the steps before this cycle, and ``jdev``
    (0-d int64) = j + 1."""
    m = R.shape[0]
    if not 0 <= j < m or h1.shape != (j + 1,) or h2.shape != (j + 1,):
        raise ValueError(f"step {j} of {m}: h1 has shape {tuple(h1.shape)}, "
                         f"h2 {tuple(h2.shape)}, want ({j + 1},)")
    if h.shape[0] < j + 2 or g.shape[0] < m + 1 or wn.dim() or d.dim():
        raise ValueError(f"step {j} of {m}: h has {h.shape[0]} entries, g {g.shape[0]}, "
                         f"wn and d must be 0-d")
    bdt = h1.dtype
    if bdt not in GIVENS_DTYPES or any(t.dtype != bdt for t in (h2, wn, d)):
        raise TypeError(f"want h1, h2, wn and d of one dtype of {list(GIVENS_DTYPES)}, "
                        f"got {h1.dtype}, {h2.dtype}, {wn.dtype}, {d.dtype}")
    sdt = givens_small_dtype(bdt)
    if any(t.dtype != sdt for t in (eps10, h, R, cs, sn, g, est, tol)):
        raise TypeError(f"want the small arrays in {sdt} for b's {bdt}, got R {R.dtype}, "
                        f"h {h.dtype}, eps10 {eps10.dtype}")
    if inner.dtype != torch.bool or jdev.dtype != torch.int64 or k.dtype != torch.int64:
        raise TypeError("inner must be bool, jdev and k int64")
    ts = (h1, h2, wn, eps10, h, d, R, cs, sn, g, est, inner, jdev, k, tol)
    if any(t.device != h1.device for t in ts):
        raise ValueError("operands on different devices")
    if h1.device.type == "cpu":
        return givens_update_reference(*ts, j, maxiter)
    if h1.device.type != "cuda":
        raise ValueError(f"no Givens kernel for device {h1.device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the Givens kernel takes contiguous tensors")
    dev = h1.get_device()
    rc = _build.library().sigma_givens_update(
        dev, GIVENS_DTYPES[bdt], *(t.data_ptr() for t in ts), j, m, maxiter,
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"sigma_givens_update failed with CUDA error {rc}")
    givens_update.launches += 1


givens_update.launches = 0


def empty_warp(device) -> None:
    """Launch an empty one-warp kernel on ``device``'s current stream: the
    floor of a one-warp launch, timed beside :func:`givens_update`.  Not
    counted."""
    dev = torch.device(device).index or 0
    rc = _build.library().sigma_empty_warp(dev, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"sigma_empty_warp failed with CUDA error {rc}")
