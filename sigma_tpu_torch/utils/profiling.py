"""Profiling and observability helpers.

Port of :mod:`sigma_tpu.utils.profiling` (the reference has no timers,
only solver iteration counters): a device synchronisation, a per-iteration
timer of a device loop (two-point slope to cancel launch and read-back
overhead), SpMV throughput in nonzeros a second, a ``torch.profiler``
trace, and a residual-history report of a solve.  On a CUDA operand the
timer reads CUDA events around each run; elsewhere the host clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch

__all__ = ["SolverLog", "spmv_throughput", "sync", "time_fn", "trace"]


def _first_tensor(y):
    if isinstance(y, torch.Tensor):
        return y
    if isinstance(y, (tuple, list)):
        for leaf in y:
            t = _first_tensor(leaf)
            if t is not None:
                return t
    if isinstance(y, dict):
        return _first_tensor(list(y.values()))
    return None


def sync(y) -> float:
    """Wait until ``y`` (a tensor or a nest of them) is computed:
    ``torch.cuda.synchronize`` on a CUDA operand.  Returns its first
    element."""
    t = _first_tensor(y)
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return float(t.reshape(-1)[0])


def _timer(args):
    """Seconds of one run of ``fn(*args)``, ended by a synchronisation:
    CUDA events when an argument is a CUDA tensor, else the host clock."""
    dev = next((a.device for a in args if isinstance(a, torch.Tensor) and a.is_cuda), None)
    if dev is None:
        def run(fn):
            t0 = time.perf_counter()
            sync(fn(*args))
            return time.perf_counter() - t0
        return run

    def run(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    return run


def time_fn(make_loop: Callable[[int], Callable], *args, k1=10, k2=50, reps=3) -> float:
    """Seconds per iteration of a device loop.

    ``make_loop(K)`` returns a callable that runs K iterations on
    ``args``.  The two-point slope (t(k2) - t(k1)) / (k2 - k1) cancels the
    launch and read-back overhead; the estimate is the median of ``reps``
    slopes, capped by t(k2) / k2 (what the longer chain provably
    sustained).  A k2 chain shorter than 0.1 s is lengthened first (a
    short chain reads impossibly fast)."""
    run = _timer(args)
    f1, f2 = make_loop(k1), make_loop(k2)
    run(f1)
    t2_warm = run(f2)
    if t2_warm < 0.1:
        k2 = max(k2 * int(np.ceil(0.1 / max(t2_warm, 1e-3))), k2 * 2)
        f2 = make_loop(k2)
        run(f2)
    slopes = []
    floor = float("inf")
    for _ in range(reps):
        t1 = run(f1)
        t2 = run(f2)
        slopes.append(max((t2 - t1) / (k2 - k1), 1e-12))
        floor = min(floor, t2 / k2)
    med = sorted(slopes)[len(slopes) // 2]
    return max(min(med, floor), 1e-12)


def spmv_throughput(A, k1=10, k2=50) -> float:
    """Measured SpMV throughput of the operator A in nonzeros a second:
    chains of ``x <- 0.5 A x`` from ones, timed by :func:`time_fn`."""
    x = torch.ones(A.shape[1], dtype=getattr(A, "dtype", torch.float32),
                   device=getattr(A, "device", None))

    def make(K):
        def many(x):
            for _ in range(K):
                x = A.matvec(x) * 0.5
            return x

        return many

    return A.nnz / time_fn(make, x, k1=k1, k2=k2)


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace(logdir) as prof:`` records a ``torch.profiler`` trace
    (CPU, and CUDA where there is a device) of the block and writes it to
    ``logdir/trace.json`` (Chrome trace format) at its end."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class SolverLog:
    """Report of a :class:`~sigma_tpu_torch.solvers.SolveInfo` and its
    residual history."""

    def __init__(self, info):
        self.info = info

    def residuals(self) -> np.ndarray:
        """The recorded residual norms (empty when the solve ran without
        ``history=True``)."""
        if self.info.history is None:
            return np.empty(0)
        h = self.info.history.detach().cpu().double().numpy()
        return h[~np.isnan(h)]

    def report(self, name: str = "solve") -> str:
        r = self.residuals()
        lines = [
            f"{name}: {int(self.info.iterations)} iterations, "
            f"final residual {float(self.info.residual_norm):.3e}, "
            f"converged={bool(self.info.converged)}"
        ]
        if r.size:
            drop = r[0] / max(r[-1], 1e-300)
            lines.append(f"  residual drop {drop:.2e} over {r.size} recorded steps")
        return "\n".join(lines)
