"""GMRES's Givens update: the kernel wrapper, its plain PyTorch version,
its launch count.

Replaces no Pallas kernel: it is the device form of the JAX package's
``_givens_update`` (``sigma_tpu/solvers/krylov.py``), which XLA runs inside
the compiled GMRES loop.  One Arnoldi step's new Hessenberg column goes
through the earlier rotations, the new rotation is made and folded into
the triangular factor, the rotations and the rotated right-hand side, and
the next step's predicate is written to the device, so that a captured
step (:mod:`~sigma_tpu_torch.solvers.graphed`) reads nothing back.

The CUDA kernel lives in ``sigma_tpu_torch/csrc/givens.cu``.  A CPU ``h``
goes to :func:`givens_update_reference`, a CUDA one to the kernel, and
anything the kernel does not take raises.  The two do the same correctly
rounded operations in the same order, so they agree bit for bit.
"""

from __future__ import annotations

import torch

from sigma_tpu_torch.ops import _build

__all__ = ["GIVENS_DTYPES", "givens_update", "givens_update_reference"]

# the dtypes of the small arrays (b's, with the 16-bit floats widened)
GIVENS_DTYPES = {torch.float32: 0, torch.float64: 1}


def givens_update_reference(h, R, cs, sn, g, est, inner, jdev, k, tol, j: int, maxiter: int):
    """The plain version of :func:`givens_update`, in place, with torch ops
    on any device."""
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


def givens_update(h, R, cs, sn, g, est, inner, jdev, k, tol, j: int, maxiter: int):
    """Step ``j``'s Givens update of a restart cycle of m = ``R.shape[0]``
    steps, in place.

    ``h`` is the new Hessenberg column (at least j + 2 entries), ``R`` the
    (m, m) triangular factor, ``cs``, ``sn`` (m,) and ``g`` (m + 1,) the
    rotations and the rotated right-hand side, all of one dtype of
    :data:`GIVENS_DTYPES`; ``tol`` a 0-d tensor of it.  Writes R[:j + 1, j],
    cs[j], sn[j], g[j], g[j + 1], ``est`` = |g[j + 1]|, ``inner`` (0-d
    bool) = ``(est > tol) & (j + 1 < m) & (k + j + 1 < maxiter)`` with ``k``
    the 0-d int64 count of the steps before this cycle, and ``jdev`` (0-d
    int64) = j + 1."""
    m = R.shape[0]
    if not 0 <= j < m or h.shape[0] < j + 2 or g.shape[0] < m + 1:
        raise ValueError(f"step {j} of {m}: h has {h.shape[0]} entries, g {g.shape[0]}")
    dt = R.dtype
    if dt not in GIVENS_DTYPES or any(t.dtype != dt for t in (h, cs, sn, g, est, tol)):
        raise TypeError(f"want one dtype of float32 or float64, got R {dt}, h {h.dtype}")
    if inner.dtype != torch.bool or jdev.dtype != torch.int64 or k.dtype != torch.int64:
        raise TypeError("inner must be bool, jdev and k int64")
    ts = (h, R, cs, sn, g, est, inner, jdev, k, tol)
    if any(t.device != R.device for t in ts):
        raise ValueError("operands on different devices")
    if R.device.type == "cpu":
        return givens_update_reference(h, R, cs, sn, g, est, inner, jdev, k, tol, j, maxiter)
    if R.device.type != "cuda":
        raise ValueError(f"no Givens kernel for device {R.device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the Givens kernel takes contiguous tensors")
    dev = R.get_device()
    rc = _build.library().sigma_givens_update(
        dev, GIVENS_DTYPES[dt], *(t.data_ptr() for t in ts), j, m, maxiter,
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"sigma_givens_update failed with CUDA error {rc}")
    givens_update.launches += 1


givens_update.launches = 0
