"""Graphed solves: the port's counterpart of ``jax.jit`` of a CG solve.

The JAX package compiles a whole solve into one XLA program: the loop is
a ``lax.while_loop`` whose ``cond`` runs on the device
(``sigma_tpu/solvers/krylov.py``).  The eager solvers of
:mod:`~sigma_tpu_torch.solvers.krylov` read the stopping rule back to the
host once an iteration.  ``graphed(cg_solve)`` and
``graphed(cg_fused_solve)`` return a callable with the solver's own
signature and results which, for a CUDA ``b``,

1. runs the solver's set-up eagerly (:func:`~sigma_tpu_torch.solvers.krylov.cg_loop`,
   :func:`~sigma_tpu_torch.solvers.krylov.cg_fused_loop`);
2. on its first call for an operator, a preconditioner, b's shape, dtype
   and device and the keywords, captures with ``torch.cuda.graph`` a head
   (the predicate ``cond`` of the starting state), the loop's body twice
   and a tail (the status the host reads), all in one memory pool.  The
   iterations ping-pong between two buffer sets, so the state is carried
   without a copy, as XLA aliases the loop carry; the counter and the
   history are shared.  ``csrc/graph_loop.cu`` links the four into one
   CUDA graph of ``min(BLOCK, maxiter)`` iterations, each under a
   conditional if-node that runs it only while the predicate the previous
   iteration wrote holds;
3. replays that graph until the predicate reads false: one host read a
   block, where the eager loop makes one an iteration.

The count is exact and the results are the eager solver's bit for bit:
the same operations in the same order on the same buffers' values.  A
later call with a new ``b`` or ``x0`` copies the new initial state into
the graph's buffers and replays without capturing again, as jit reuses
its compiled program; the callable keeps the last graph only.  The
set-up's own launches (one matvec, one preconditioner application, as
the eager solve makes them) come before the capture and prepare every
kernel the body launches.

PyTorch 2.11's ``CUDAGraph`` has no Python binding for capturing into an
if-node (``begin_capture_to_if_node``, which later releases bind), so
the if-nodes are added through the CUDA runtime.  The launch counters of
the port's kernels are bumped in Python, where a replay runs none: the
capture's launches are taken back out and each replay adds one body's
launches times the iterations it ran, so the counts equal the eager
solve's.

For a CPU ``b`` the same init / cond / body run eagerly, in the same
block schedule, with the same buffers: the plain version.  There is no
fallback: on CUDA a capture that fails raises.  Only ``cg_solve`` and
``cg_fused_solve`` are graphed, and only for a plain tensor ``b``; the
other solvers and the rank mesh run their eager loops (``ROADMAP.md``,
staged item A.2).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import inspect
import time
import weakref
from typing import Optional

import torch

from sigma_tpu_torch.ops import _build, add_launch_counts, launch_counts, launch_difference
from sigma_tpu_torch.solvers.krylov import (
    Loop,
    SolveInfo,
    cg_fused_loop,
    cg_fused_solve,
    cg_loop,
    cg_solve,
)
from sigma_tpu_torch.utils.sharded import is_sharded

__all__ = ["BLOCK", "GraphedSolve", "graphed"]

# Iterations a replay runs, each under an if-node.  A block costs one host
# read; past convergence a replay still walks the block's remaining
# if-nodes, each a one-thread kernel that reads the predicate and skips
# its body; and the graph, cloned body by body, grows with the block.  On
# an NVIDIA H100 80GB HBM3 at 700 W (``tools/graphed_block.py``, nx=216,
# f32) blocks of 8, 16, 32 and 64 gave the same seconds an iteration
# within 1% for plain CG on Poisson (288 iterations, 0.424-0.428 ms) and
# within 3% for GMG-CG (28 iterations, 1.56-1.61 ms), so the block is
# chosen by its reads: at 32 the main path's solves (13-28 iterations)
# end within one.  Even, so that a full block ends in the buffer set it
# began from.
BLOCK = 32

_LOOPS = {cg_solve: cg_loop, cg_fused_solve: cg_fused_loop}


def graphed(solve) -> "GraphedSolve":
    """``solve`` run as one captured CUDA graph a block of iterations: the
    counterpart of ``jax.jit(lambda A, b: solve(A, b, ...))``.  Takes
    :func:`~sigma_tpu_torch.solvers.krylov.cg_solve` or
    :func:`~sigma_tpu_torch.solvers.krylov.cg_fused_solve`; raises
    ``TypeError`` for any other solver."""
    loop = _LOOPS.get(solve)
    if loop is None:
        name = getattr(solve, "__name__", repr(solve))
        raise TypeError(
            f"graphed() takes cg_solve or cg_fused_solve, not {name}: the other "
            "solvers run their eager loops (ROADMAP.md, staged item A.2)"
        )
    return GraphedSolve(solve, loop)


@dataclasses.dataclass(eq=False)
class _Graph:
    """A captured block and the buffers it reads and writes."""

    refs: tuple  # weak references to A and M (None for no M)
    key: tuple  # b's shape, dtype and device and the bound keywords
    graphs: list  # the four torch captures: they hold the memory pool
    sets: tuple  # the two buffer sets the iterations ping-pong between
    pred: torch.Tensor  # 0-d bool: the next iteration runs
    status: torch.Tensor  # (pred, k, converged) as int64, read once a block
    tol_eff: torch.Tensor  # the threshold the captured cond reads
    per_iteration: dict  # one body's kernel launches (launch_difference)
    exec: int  # the executable CUDA graph's handle

    def matches(self, A, M, key) -> bool:
        return (self.key == key and self.refs[0]() is A
                and (self.refs[1] is None if M is None else self.refs[1]() is M))


class GraphedSolve:
    """The callable :func:`graphed` returns, with the solver's signature.

    After each call, ``host_reads`` is the number of status reads the solve
    made (one a block), ``captured`` whether the call captured a graph, and
    ``capture_seconds`` the host time of the last capture, the linking and
    instantiation of the graph included."""

    def __init__(self, solve, loop):
        functools.update_wrapper(self, solve)
        self._loop = loop
        self._signature = inspect.signature(solve)
        self._graph: Optional[_Graph] = None
        self.host_reads = 0
        self.captured = False
        self.capture_seconds = 0.0

    def __call__(self, A, b, x0=None, **kw):
        if is_sharded(b):
            raise NotImplementedError(
                f"graphed {self.__name__} takes a plain tensor b; a vector sharded over "
                "ranks runs the eager loop (ROADMAP.md, staged item A.2)"
            )
        bound = self._signature.bind(A, b, x0, **kw)
        bound.apply_defaults()
        kw = {k: v for k, v in bound.arguments.items() if k not in ("A", "b", "x0")}
        loop = self._loop(A, b, x0, **kw)
        self.captured = False
        if b.device.type == "cpu":
            return self._plain(loop)
        if b.device.type != "cuda":
            raise ValueError(f"graphed {self.__name__}: no graphed loop on {b.device}")
        M = kw.pop("M")
        key = (tuple(b.shape), b.dtype, b.device, tuple(sorted(kw.items())))
        g = self._graph
        if g is not None and g.matches(A, M, key):
            _load(g.sets[0], loop.state)
            g.tol_eff.copy_(loop.tol_eff)
        else:
            self._graph = None  # release the last graph before capturing
            g = self._graph = self._capture(loop, A, M, key, b.device)
        return self._replay(g, b.device)

    # -- the plain version ------------------------------------------------
    def _plain(self, loop: Loop):
        sets = _buffers(loop.state)
        pred = torch.zeros((), dtype=torch.bool, device=loop.tol_eff.device)
        status = torch.zeros(3, dtype=torch.int64, device=pred.device)
        block = min(BLOCK, loop.maxiter)
        self.host_reads = 0
        while True:
            _head(loop, sets, pred)
            for j in range(block):
                if bool(pred):  # the if-node
                    _step(loop, sets[j % 2], sets[(j + 1) % 2], pred)
            _tail(loop, sets, pred, status)
            more, k, converged = status.tolist()
            self.host_reads += 1
            if not more:
                return _result(sets, k, converged)

    # -- the graph on the card --------------------------------------------
    def _capture(self, loop: Loop, A, M, key, device) -> _Graph:
        t0 = time.perf_counter()
        lib = _build.library()
        sets = _buffers(loop.state)
        pred = torch.zeros((), dtype=torch.bool, device=device)
        status = torch.zeros(3, dtype=torch.int64, device=device)
        parts = (
            lambda: _head(loop, sets, pred),
            lambda: _step(loop, sets[0], sets[1], pred),
            lambda: _step(loop, sets[1], sets[0], pred),
            lambda: _tail(loop, sets, pred, status),
        )
        before = launch_counts()
        pool = torch.cuda.graph_pool_handle()
        graphs = []
        handle = ctypes.c_void_p()
        try:
            for i, part in enumerate(parts):
                graphs.append(torch.cuda.CUDAGraph(keep_graph=True))
                with torch.cuda.graph(graphs[-1], pool=pool):
                    part()
                if i == 1:
                    per_iteration = launch_difference(launch_counts(), before)
            rc = lib.sigma_loop_graph(
                device.index, *(g.raw_cuda_graph() for g in graphs), pred.data_ptr(),
                min(BLOCK, loop.maxiter), ctypes.byref(handle),
            )
            if rc != 0:
                raise RuntimeError(f"linking the if-nodes: {lib.sigma_error_string(rc).decode()}")
        except Exception as e:
            on = type(A).__name__ + ("" if M is None else f" with M={type(M).__name__}")
            raise RuntimeError(f"graphed {self.__name__} on {on}: capture failed: {e}") from e
        finally:
            # the captures ran no kernel
            add_launch_counts(launch_difference(launch_counts(), before), -1)
        g = _Graph((weakref.ref(A), None if M is None else weakref.ref(M)), key, graphs, sets,
                   pred, status, loop.tol_eff, per_iteration, handle.value)
        weakref.finalize(g, lib.sigma_loop_destroy, handle.value)
        torch.cuda.synchronize(device)
        self.captured = True
        self.capture_seconds = time.perf_counter() - t0
        return g

    def _replay(self, g: _Graph, device):
        lib = _build.library()
        stream = torch.cuda.current_stream(device).cuda_stream
        self.host_reads = 0
        while True:
            rc = lib.sigma_loop_launch(g.exec, stream)
            if rc != 0:
                raise RuntimeError(
                    f"graphed {self.__name__}: launch failed: {lib.sigma_error_string(rc).decode()}"
                )
            more, k, converged = g.status.tolist()
            self.host_reads += 1
            if not more:
                break
        add_launch_counts(g.per_iteration, k)
        return _result(g.sets, k, converged)


def _buffers(state):
    """The two buffer sets of a loop: the first a copy of ``state`` (the
    set-up's tensors may alias one another: CG's first direction is its
    preconditioned residual, the residual itself without M), the second
    alike; both share the counter and the history."""
    a = state._make(None if t is None else t.clone() for t in state)
    b = state._make(None if t is None else torch.zeros_like(t) for t in state)
    return a, b._replace(k=a.k, hist=a.hist)


def _load(buffers, state):
    """Copy a new set-up's state into the first buffer set."""
    for dst, src in zip(buffers, state):
        if dst is not None:
            dst.copy_(src)


def _head(loop: Loop, sets, pred):
    pred.copy_(loop.cond(sets[0]))


def _step(loop: Loop, src, dst, pred):
    """One iteration from ``src`` into ``dst``, then the next predicate."""
    loop.body(src, out=dst)
    pred.copy_(loop.cond(dst))


def _tail(loop: Loop, sets, pred, status):
    """``status`` = (pred, k, converged) of the set the count names."""
    k = sets[0].k
    res2 = torch.where(k % 2 == 0, sets[0].res2, sets[1].res2)
    converged = torch.sqrt(res2) <= loop.tol_eff
    torch.stack((pred.to(k.dtype), k, converged.to(k.dtype)), out=status)


def _result(sets, k, converged):
    """``(x, info)`` from the buffer set that ``k``'s parity names, copied
    out of the buffers a later call reuses."""
    s = sets[k % 2]
    hist = None if s.hist is None else s.hist.clone()
    return s.x.clone(), SolveInfo(k, torch.sqrt(s.res2), bool(converged), hist)
