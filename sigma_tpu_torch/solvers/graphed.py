"""Graphed solves: the port's counterpart of ``jax.jit`` of a Krylov solve.

The JAX package compiles a whole solve into one XLA program: the loop is
a ``lax.while_loop`` (the stationary iteration's a ``fori_loop``) whose
``cond`` runs on the device (``sigma_tpu/solvers/krylov.py``).  The eager
solvers of :mod:`~sigma_tpu_torch.solvers.krylov` read the stopping rule
back to the host once an iteration.  ``graphed(solve)``, for any of the
nine solvers of that module (``cg_solve``, ``cg_fused_solve``,
``bicgstab_solve``, ``minres_solve``, ``gmres_solve``, ``fgmres_solve``,
``cgls_solve``, ``stationary_solve``, ``block_cg_solve``), returns a
callable with the solver's own signature and results which, for a CUDA
right-hand side,

1. runs the solver's set-up eagerly (the solver's ``*_loop`` in
   :mod:`~sigma_tpu_torch.solvers.krylov`);
2. on its first call for an operator, a preconditioner, the right-hand
   side's shape, dtype and device and the keywords, captures with
   ``torch.cuda.graph`` a head, the bodies and a tail (the status the host
   reads), all in one memory pool, and ``csrc/graph_loop.cu`` links them
   into one CUDA graph whose bodies each sit under a conditional if-node
   that runs it only while the predicate it waits on holds:

   - CG, fused CG, BiCG-stab, MINRES, CGLS, the stationary iteration and
     block CG (a :class:`~sigma_tpu_torch.solvers.krylov.Loop`): the head
     writes the predicate ``cond`` of the starting state, and
     ``min(BLOCK, maxiter)`` iterations follow, the loop's body captured
     twice.  The iterations ping-pong between two buffer sets, so the
     state is carried without a copy, as XLA aliases the loop carry; the
     counter, the history and the state's other shared fields (BiCG-stab's
     shadow residual, the stationary iteration's b, block CG's best
     iterate) are one buffer, and MINRES's swapped pairs are held
     crosswise by the two sets;
   - GMRES(m) and FGMRES(m) (a :class:`~sigma_tpu_torch.solvers.krylov.Cycles`):
     one restart cycle.  The head writes the outer predicate and starts
     the cycle; the m Arnoldi steps follow, each captured at its own
     index j (the basis products' slices are fixed by j), the first on the
     outer predicate and step j on the inner predicate that step j - 1's
     Givens update wrote on the device; then the cycle's end (the
     Hessenberg solve, the update of x, the new residual) on the outer
     predicate.  Every write is in place: the basis, and FGMRES's basis Z
     of preconditioned vectors, are one buffer each;

3. replays that graph until the status reads false: one host read a block
   of iterations, or a restart cycle, where the eager loop makes one an
   iteration (GMRES and FGMRES: an Arnoldi step).  The loop's finishing
   hook then gives x and the residual norm from the buffers (block CG's
   best iterate, out of its panel layout).

Any preconditioner whose apply reads nothing back is captured with the
loop: the GMG and pruned multigrid V-cycles, Jacobi, Chebyshev, and ILDU,
ILU(k), the colour-ordered ILDU and the shard mesh's block ILDU (a
triangular sweep is one launch of the level-sweep kernel beside the
memset of its ready flags, which the graph repeats on every replay).

The count is exact and the results are the eager solver's bit for bit:
the same operations in the same order on the same buffers' values.  A
later call with new right-hand side or start copies the new initial
state into the graph's buffers and replays without capturing again, as
jit reuses its compiled program; the callable keeps the last graph only.
The set-up's own launches come before the capture (CG's and BiCG-stab's
make one matvec and one preconditioner application, as the eager solve
does).

PyTorch 2.11's ``CUDAGraph`` has no Python binding for capturing into an
if-node (``begin_capture_to_if_node``, which later releases bind), so
the if-nodes are added through the CUDA runtime.  The launch counters of
the port's kernels are bumped in Python, where a replay runs none: the
capture's launches are taken back out and each replay adds the launches
of each part it ran, so the counts equal the eager solve's.

For a CPU right-hand side the same parts run eagerly, in the same
schedule, with the same buffers: the plain version.  There is no
fallback: on CUDA a capture that fails raises, and FGMRES with an
``attach_solver`` preconditioner (whose inner solve reads its stopping
rule back to the host) is refused at capture, naming M's type.  Only a
plain tensor right-hand side is graphed; the rank mesh runs the eager
loops (``ROADMAP.md``, queue 1: nested and sharded graphed solves).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import inspect
import time
import weakref
from typing import Callable, Optional

import torch

from sigma_tpu_torch.ops import _build, add_launch_counts, launch_counts, launch_difference
from sigma_tpu_torch.solvers.krylov import (
    Cycles,
    Loop,
    SolveInfo,
    attached,
    bicgstab_loop,
    bicgstab_solve,
    block_cg_loop,
    block_cg_solve,
    cg_fused_loop,
    cg_fused_solve,
    cg_loop,
    cg_solve,
    cgls_loop,
    cgls_solve,
    fgmres_loop,
    fgmres_solve,
    gmres_loop,
    gmres_solve,
    minres_loop,
    minres_solve,
    stationary_loop,
    stationary_solve,
)
from sigma_tpu_torch.utils.sharded import is_sharded, local

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

_LOOPS = {cg_solve: cg_loop, cg_fused_solve: cg_fused_loop, bicgstab_solve: bicgstab_loop,
          minres_solve: minres_loop, gmres_solve: gmres_loop, fgmres_solve: fgmres_loop,
          cgls_solve: cgls_loop, stationary_solve: stationary_loop,
          block_cg_solve: block_cg_loop}


def graphed(solve) -> "GraphedSolve":
    """``solve`` run as one captured CUDA graph a block of iterations (a
    restart cycle for GMRES and FGMRES): the counterpart of
    ``jax.jit(lambda A, b: solve(A, b, ...))``.  Takes any solver of
    :mod:`~sigma_tpu_torch.solvers.krylov`: ``cg_solve``,
    ``cg_fused_solve``, ``bicgstab_solve``, ``minres_solve``,
    ``gmres_solve``, ``fgmres_solve``, ``cgls_solve``, ``stationary_solve``
    or ``block_cg_solve``; raises ``TypeError`` for any other callable."""
    loop = _LOOPS.get(solve)
    if loop is None:
        name = getattr(solve, "__name__", repr(solve))
        raise TypeError(
            f"graphed() takes the solvers of sigma_tpu_torch.solvers.krylov (cg_solve, "
            f"cg_fused_solve, bicgstab_solve, minres_solve, gmres_solve, fgmres_solve, "
            f"cgls_solve, stationary_solve, block_cg_solve), not {name}: the other solves run "
            f"their eager loops (ROADMAP.md, queue 1: the compiled loops still to port)"
        )
    return GraphedSolve(solve, loop)


@dataclasses.dataclass(eq=False)
class _Plan:
    """A loop laid out for replay: the parts a capture takes (the head,
    the distinct bodies, the tail), the if-nodes in graph order, each a
    part's index and the predicate it waits on, and the status the tail
    writes."""

    parts: list  # callables: parts[0] the head, parts[-1] the tail
    nodes: list  # (part index, predicate) an if-node
    status: torch.Tensor  # (more, k, converged) as int64, read once a replay
    tol_eff: Optional[torch.Tensor]  # the threshold the captured parts read
    load: Callable  # (loop): a new set-up's state into the buffers
    result: Callable  # (k, converged): (x, info) copied out of the buffers
    ran: Callable  # (steps a replay took): the indices of the nodes that ran


def _block_plan(loop: Loop) -> _Plan:
    """CG, fused CG, BiCG-stab, MINRES, CGLS, the stationary iteration and
    block CG: ``min(BLOCK, maxiter)`` iterations, the even and the odd body
    in turn, all on the loop's predicate."""
    sets = _buffers(loop.state)
    pred = torch.zeros((), dtype=torch.bool, device=loop.state.k.device)
    status = torch.zeros(3, dtype=torch.int64, device=pred.device)
    parts = [
        lambda: pred.copy_(loop.cond(sets[0])),
        lambda: _step(loop, sets[0], sets[1], pred),
        lambda: _step(loop, sets[1], sets[0], pred),
        lambda: _tail(loop, sets, pred, status),
    ]
    nodes = [(1 + j % 2, pred) for j in range(min(BLOCK, loop.maxiter))]
    return _Plan(parts, nodes, status, loop.tol_eff,
                 lambda new: _load(sets[0], new.state),
                 lambda k, converged: _result(loop, sets, k, converged), range)


def _cycle_plan(loop: Cycles) -> _Plan:
    """GMRES: one restart cycle, its m steps and its end."""
    s = loop.state._make(t.clone() for t in loop.state)
    w = loop.work()
    outer = torch.zeros((), dtype=torch.bool, device=loop.tol_eff.device)
    status = torch.zeros(3, dtype=torch.int64, device=outer.device)
    m = loop.m

    def head():
        # inner needs no reset: every cycle's last step leaves it false
        outer.copy_(loop.cond(s))
        loop.init(s, w)

    def tail():
        converged = local(s.beta) <= loop.tol_eff
        torch.stack((loop.cond(s).to(s.k.dtype), s.k, converged.to(s.k.dtype)), out=status)

    def result(k, converged):
        return s.x.clone(), SolveInfo(k, s.beta.clone(), bool(converged))

    parts = [head, *(functools.partial(loop.step, s, w, j) for j in range(m)),
             lambda: loop.end(s, w), tail]
    nodes = [(1 + j, outer if j == 0 else w.inner) for j in range(m)] + [(m + 1, outer)]
    return _Plan(parts, nodes, status, loop.tol_eff, lambda new: _load(s, new.state), result,
                 lambda steps: [*range(steps), m] if steps else [])


@dataclasses.dataclass(eq=False)
class _Graph:
    """A captured plan and the executable graph that links it."""

    refs: tuple  # weak references to A and M (None for no M)
    key: tuple  # b's shape, dtype and device and the bound keywords
    graphs: list  # the torch captures, one a part: they hold the memory pool
    plan: _Plan
    launches: list  # each part's kernel launches (launch_difference)
    exec: int  # the executable CUDA graph's handle

    def matches(self, A, M, key) -> bool:
        return (self.key == key and self.refs[0]() is A
                and (self.refs[1] is None if M is None else self.refs[1]() is M))


class GraphedSolve:
    """The callable :func:`graphed` returns, with the solver's signature.

    After each call, ``host_reads`` is the number of status reads the solve
    made (one a replay), ``captured`` whether the call captured a graph,
    and ``capture_seconds`` the host time of the last capture, the linking
    and instantiation of the graph included."""

    def __init__(self, solve, loop):
        functools.update_wrapper(self, solve)
        self._loop = loop
        self._signature = inspect.signature(solve)
        self._graph: Optional[_Graph] = None
        self.host_reads = 0
        self.captured = False
        self.capture_seconds = 0.0

    def __call__(self, *args, **kw):
        bound = self._signature.bind(*args, **kw)
        bound.apply_defaults()
        A, b = bound.args[:2]  # the operator and the right-hand side (b or B)
        if is_sharded(b):
            raise NotImplementedError(
                f"graphed {self.__name__} takes a plain tensor right-hand side; a vector sharded "
                "over ranks runs the eager loop (ROADMAP.md, queue 1: nested and sharded graphed "
                "solves)"
            )
        loop = self._loop(*bound.args, **bound.kwargs)
        self.captured = False
        if b.device.type == "cpu":
            return self._plain(_plan(loop))
        if b.device.type != "cuda":
            raise ValueError(f"graphed {self.__name__}: no graphed loop on {b.device}")
        M = bound.arguments.get("M")
        operands = (*list(self._signature.parameters)[:2], "x0", "X0", "M")
        key = (tuple(b.shape), b.dtype, b.device,
               tuple(sorted((k, v) for k, v in bound.arguments.items() if k not in operands)))
        g = self._graph
        if g is not None and g.matches(A, M, key):
            g.plan.load(loop)
            if g.plan.tol_eff is not None:
                g.plan.tol_eff.copy_(loop.tol_eff)
        else:
            self._graph = None  # release the last graph before capturing
            g = self._graph = self._capture(loop, A, M, key, b.device)
        return self._replay(g)

    # -- the plain version ------------------------------------------------
    def _plain(self, plan: _Plan):
        self.host_reads = 0
        while True:
            plan.parts[0]()
            for i, pred in plan.nodes:
                if bool(pred):  # the if-node
                    plan.parts[i]()
            plan.parts[-1]()
            more, k, converged = plan.status.tolist()
            self.host_reads += 1
            if not more:
                return plan.result(k, converged)

    # -- the graph on the card --------------------------------------------
    def _capture(self, loop, A, M, key, device) -> _Graph:
        on = type(A).__name__ + ("" if M is None else f" with M={type(M).__name__}")
        if self.__wrapped__ is fgmres_solve and attached(M):
            raise RuntimeError(
                f"graphed {self.__name__} on {on}: capture refused: the attached solver's inner "
                "solve reads its stopping rule back to the host, which a captured graph cannot "
                "(an inner graphed solve is ROADMAP.md's later work); call fgmres_solve itself"
            )
        t0 = time.perf_counter()
        lib = _build.library()
        plan = _plan(loop)
        start = launch_counts()
        pool = torch.cuda.graph_pool_handle()
        graphs, launches = [], []
        handle = ctypes.c_void_p()
        try:
            for part in plan.parts:
                graphs.append(torch.cuda.CUDAGraph(keep_graph=True))
                before = launch_counts()
                with torch.cuda.graph(graphs[-1], pool=pool):
                    part()
                launches.append(launch_difference(launch_counts(), before))
            n = len(plan.nodes)
            bodies = (ctypes.c_void_p * n)(*(graphs[i].raw_cuda_graph() for i, _ in plan.nodes))
            preds = (ctypes.c_void_p * n)(*(p.data_ptr() for _, p in plan.nodes))
            rc = lib.sigma_loop_graph(device.index, graphs[0].raw_cuda_graph(), bodies, preds, n,
                                      graphs[-1].raw_cuda_graph(), ctypes.byref(handle))
            if rc != 0:
                raise RuntimeError(f"linking the if-nodes: {lib.sigma_error_string(rc).decode()}")
        except Exception as e:
            raise RuntimeError(f"graphed {self.__name__} on {on}: capture failed: {e}") from e
        finally:
            # the captures ran no kernel
            add_launch_counts(launch_difference(launch_counts(), start), -1)
        g = _Graph((weakref.ref(A), None if M is None else weakref.ref(M)), key, graphs, plan,
                   launches, handle.value)
        weakref.finalize(g, lib.sigma_loop_destroy, handle.value)
        torch.cuda.synchronize(device)
        self.captured = True
        self.capture_seconds = time.perf_counter() - t0
        return g

    def _replay(self, g: _Graph):
        lib = _build.library()
        stream = torch.cuda.current_stream(g.plan.status.device).cuda_stream
        runs = [0] * len(g.plan.parts)
        self.host_reads, k = 0, 0
        while True:
            rc = lib.sigma_loop_launch(g.exec, stream)
            if rc != 0:
                raise RuntimeError(
                    f"graphed {self.__name__}: launch failed: {lib.sigma_error_string(rc).decode()}"
                )
            more, k_new, converged = g.plan.status.tolist()
            self.host_reads += 1
            runs[0] += 1
            runs[-1] += 1
            for node in g.plan.ran(k_new - k):
                runs[g.plan.nodes[node][0]] += 1
            k = k_new
            if not more:
                break
        for delta, times in zip(g.launches, runs):
            add_launch_counts(delta, times)
        return g.plan.result(k, converged)


def _plan(loop) -> _Plan:
    return _cycle_plan(loop) if isinstance(loop, Cycles) else _block_plan(loop)


def _buffers(state):
    """The two buffer sets of a loop: the first a copy of ``state`` (the
    set-up's tensors may alias one another: CG's first direction is its
    preconditioned residual, the residual itself without M), the second
    alike; both share the state's ``SHARED`` fields (the counter, the
    history, BiCG-stab's shadow residual, ...), and the second holds each
    of its ``CROSSED`` pairs the other way round."""
    a = state._make(None if t is None else t.clone() for t in state)
    b = state._make(None if t is None else torch.zeros_like(t) for t in state)
    b = b._replace(**{f: getattr(a, f) for f in state.SHARED})
    for f, g in getattr(state, "CROSSED", ()):
        b = b._replace(**{f: getattr(a, g), g: getattr(a, f)})
    return a, b


def _load(buffers, state):
    """Copy a new set-up's state into the buffers."""
    for dst, src in zip(buffers, state):
        if dst is not None:
            dst.copy_(src)


def _step(loop: Loop, src, dst, pred):
    """One iteration from ``src`` into ``dst``, then the next predicate."""
    loop.body(src, out=dst)
    pred.copy_(loop.cond(dst))


def _tail(loop: Loop, sets, pred, status):
    """``status`` = (pred, k, converged) of the set the count names."""
    k = sets[0].k
    converged = torch.where(k % 2 == 0, loop.finish(sets[0])[1], loop.finish(sets[1])[1])
    torch.stack((pred.to(k.dtype), k, converged.to(k.dtype)), out=status)


def _result(loop: Loop, sets, k, converged):
    """``(x, info)`` from the buffer set that ``k``'s parity names, copied
    out of the buffers a later call reuses."""
    s = sets[k % 2]
    x = loop.solution(s)
    if any(x is t for t in s):
        x = x.clone()
    hist = None if s.hist is None else s.hist.clone()
    return x, SolveInfo(k, loop.finish(s)[0].clone(), bool(converged), hist)
