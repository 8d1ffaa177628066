"""The rank-per-device form of the distributed layer: one process a card.

The JAX package runs one program over a mesh of devices and gives each
solver vector a ``NamedSharding``, so its unchanged solvers run
distributed.  Here each rank of a ``torch.distributed`` process group is
one process holding its own block of rows, of every vector and of every
layout (:class:`RankMesh`):

* a vector is a ``torch.distributed.tensor.DTensor`` of length ``n_pad``
  sharded by rows (``Shard(0)``) over a 1-D ``DeviceMesh`` of the mesh's
  axis name: its reductions (``torch.dot``, norms) are the local ones
  plus an all-reduce, so the port's solvers run on it as they are;
* a ring shift sends the rank's block to rank ``(r - k) mod D`` and
  receives rank ``(r + k) mod D``'s (the JAX package's ``ppermute``); the
  reversed ring ships a block back to the owner of its columns; the halo
  exchange of the pruned layout sends edge rows to the neighbours, and
  the symmetric spill goes to the next rank.  Each is one
  ``torch.distributed.batch_isend_irecv``, posted before the local
  product and awaited after it where the product allows.

Backends:

* ``"nccl"``: rank r runs on ``cuda:LOCAL_RANK``, one card a rank on one
  host (more ranks than cards raises); sends and collectives go between
  the cards;
* ``"gloo"``: on an explicit device, ``"cpu"`` (the tests) or a card that
  several ranks share (NCCL refuses two ranks on one card).  Gloo sends
  host memory only, so on a card every exchanged block is copied through
  pinned host memory (:attr:`RankMesh.transport` says so); its
  all-reduces take device tensors.

No default picks the CPU: a mesh without a device runs on the card.

:func:`launch` spawns the ranks on this host (a free localhost port,
``torch.multiprocessing``), runs a function on each with its mesh and
returns the ranks' results; it joins with a timeout and re-raises any
rank's exception in the parent.  Under ``torchrun --nproc-per-node N``
each process builds its mesh with :func:`rank_mesh` (or ``make_mesh(...,
ranks=True)``), which reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch

from sigma_tpu_torch.utils.device import resolve_device

__all__ = ["RankMesh", "launch", "rank_mesh"]

STAGED = "gloo, staged through pinned host memory"
JOIN_TIMEOUT = 600.0  # seconds launch() waits for its ranks
_POOL_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


class _Posted:
    """The receives of one posted exchange, by key: the first read waits
    for the whole exchange."""

    def __init__(self, keys, works, bufs, finish):
        self._keys, self._works, self._bufs, self._finish = keys, works, bufs, finish
        self._got = None

    def _wait(self):
        if self._got is None:
            for w in self._works:
                w.wait()
            self._got = {k: self._finish(b) for k, b in zip(self._keys, self._bufs)}
        return self._got

    def __getitem__(self, key):
        return self._wait()[key]

    def get(self, key, default=None):
        return self._wait().get(key, default)


@dataclasses.dataclass(frozen=True, eq=False)
class RankMesh:
    """A 1-D mesh of ``n_shards`` ranks, this process being ``rank``; its
    vectors, layouts and exchanges are the rank's own (module docstring).
    ``shape`` maps the axis name to the rank count, as a JAX mesh's does."""

    n_shards: int
    axis: str
    device: torch.device
    rank: int
    backend: str
    device_mesh: Any = dataclasses.field(default=None, repr=False)

    @property
    def shape(self):
        return {self.axis: self.n_shards}

    @property
    def transport(self) -> str:
        """How blocks travel: ``"nccl"``, ``"gloo"`` or, for gloo ranks on
        a card, through pinned host memory."""
        if self.backend == "gloo" and self.device.type != "cpu":
            return STAGED
        return self.backend

    @property
    def shard_ids(self) -> tuple:
        """The shards this process holds: its own."""
        return (self.rank,)

    # -- vectors -------------------------------------------------------------
    def local_shards(self, arr):
        """This rank's slice of a (D, ...) array of every shard's parts."""
        return arr[self.rank : self.rank + 1]

    def blocks(self, x) -> torch.Tensor:
        """(1, block, ...) view of the rank's block of a sharded vector."""
        from torch.distributed.tensor import DTensor, Shard

        if not isinstance(x, DTensor):
            raise TypeError(
                "a rank mesh's vectors are DTensors sharded by rows: make them with "
                "shard_vector / distribute_vector"
            )
        if tuple(x.placements) != (Shard(0),):  # a replicated or partial vector
            nb = x.shape[0] // self.n_shards
            return x.full_tensor()[self.rank * nb : (self.rank + 1) * nb][None]
        return x.to_local()[None]

    def join(self, Y) -> torch.Tensor:
        """The sharded vector whose rank block is ``Y[0]`` ((1, block, ...)
        or a list of one block)."""
        from torch.distributed.tensor import DTensor, Shard

        local = Y[0].contiguous()
        shape = (self.n_shards * local.shape[0],) + tuple(local.shape[1:])
        stride, acc = [], 1
        for e in reversed(shape):
            stride.insert(0, acc)
            acc *= e
        return DTensor.from_local(local, self.device_mesh, [Shard(0)], run_check=False,
                                  shape=torch.Size(shape), stride=tuple(stride))

    def distribute(self, full: torch.Tensor, n_pad: int) -> torch.Tensor:
        """``full`` (every rank's same host or device array, n rows or
        more) zero-padded to ``n_pad`` rows: the rank keeps its block."""
        nb = n_pad // self.n_shards
        lo = self.rank * nb
        out = torch.zeros((nb,) + tuple(full.shape[1:]), dtype=full.dtype, device=self.device)
        part = full[lo : min(lo + nb, full.shape[0])]
        out[: part.shape[0]] = part
        return self.join(out[None])

    # -- exchanges -----------------------------------------------------------
    def _post(self, sends, recvs) -> _Posted:
        """Post ``sends`` [(tensor, peer)] and ``recvs`` [(key, template,
        peer)] as one batch; the receives come back by key, on the
        device."""
        import torch.distributed as dist

        staged = self.transport == STAGED

        def host(t):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            return h

        ops, bufs = [], []
        for t, peer in sends:
            t = t.contiguous()
            ops.append(dist.P2POp(dist.isend, host(t) if staged else t, peer))
        for key, t, peer in recvs:
            b = (torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if staged
                 else torch.empty(t.shape, dtype=t.dtype, device=self.device))
            bufs.append(b)
            ops.append(dist.P2POp(dist.irecv, b, peer))
        works = dist.batch_isend_irecv(ops) if ops else []

        def finish(b):
            return b.to(self.device, non_blocking=True) if staged else b

        return _Posted([key for key, _, _ in recvs], works, bufs, finish)

    def ring_shift(self, X, ks: Sequence[int]):
        """Post the ring shifts of ``X`` (1, block, ...): for each offset k
        the rank's block goes to rank ``(r - k) mod D`` and rank ``(r + k)
        mod D``'s arrives.  Returns a mapping k -> (1, block, ...) whose
        first read waits."""
        D, r = self.n_shards, self.rank
        ks = [k for k in ks if k % D]
        return self._post([(X, (r - k) % D) for k in ks], [(k, X, (r + k) % D) for k in ks])

    def ship(self, parts: dict):
        """The reversed ring: ``parts[k]`` (1, ...) goes to rank ``(r + k)
        mod D``, the owner of its columns, and rank ``(r - k) mod D``'s
        arrives.  Returns a mapping like :meth:`ring_shift`."""
        D, r = self.n_shards, self.rank
        return self._post([(p, (r + k) % D) for k, p in parts.items()],
                          [(k, p, (r - k) % D) for k, p in parts.items()])

    def neighbours(self, to_prev, to_next):
        """Edge blocks to the previous and the next rank (lists of one
        tensor, or None when nothing goes that way on any rank); returns
        ``(from_next, from_prev)``, lists of one tensor or None past the
        first and last rank.  Every rank sends the same shapes."""
        D, r = self.n_shards, self.rank
        sends, recvs = [], []
        if to_prev is not None:
            if r > 0:
                sends.append((to_prev[0], r - 1))
            if r + 1 < D:
                recvs.append(("next", to_prev[0], r + 1))
        if to_next is not None:
            if r + 1 < D:
                sends.append((to_next[0], r + 1))
            if r > 0:
                recvs.append(("prev", to_next[0], r - 1))
        got = self._post(sends, recvs)
        return [got.get("next")], [got.get("prev")]

    def halos(self, X, Hw: int, forward_only: bool = False) -> torch.Tensor:
        """(1, block + 2 Hw, ...) buffer ``[left | x_r | right]``: the
        previous rank's last and the next rank's first ``Hw`` rows (zeros
        past the edge ranks; no left halo with ``forward_only``)."""
        blk = X.shape[1]
        from_next, from_prev = self.neighbours(
            [X[0, :Hw]], None if forward_only else [X[0, blk - Hw :]])
        ext = X.new_zeros((1, blk + 2 * Hw) + tuple(X.shape[2:]))
        ext[:, Hw : Hw + blk] = X
        if from_prev[0] is not None:
            ext[0, :Hw] = from_prev[0]
        if from_next[0] is not None:
            ext[0, Hw + blk :] = from_next[0]
        return ext

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` summed, on every rank (a set-up utility)."""
        import torch.distributed as dist

        t = t.to(self.device, copy=True)
        dist.all_reduce(t)
        return t


def _env_int(name: str, given: Optional[int]) -> Optional[int]:
    if given is not None:
        return int(given)
    v = os.environ.get(name)
    return None if v is None else int(v)


def rank_mesh(axis: str = "rows", *, backend: Optional[str] = None, device=None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              local_rank: Optional[int] = None, init_method: Optional[str] = None) -> RankMesh:
    """This process's rank mesh over the default process group.

    Without an initialised group, one is initialised from ``rank`` and
    ``world_size`` (else ``RANK`` and ``WORLD_SIZE``, as ``torchrun`` sets
    them) with ``init_method`` (default ``env://``: ``MASTER_ADDR`` and
    ``MASTER_PORT``).  ``backend`` defaults to the group's, else NCCL.

    With NCCL the rank runs on ``cuda:LOCAL_RANK`` (``local_rank``, else
    the variable, else the rank); a group of more ranks than this host has
    cards raises.  With gloo the rank runs on ``device`` (None: the card,
    raising where there is none)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        rank, world_size = _env_int("RANK", rank), _env_int("WORLD_SIZE", world_size)
        if rank is None or world_size is None:
            raise RuntimeError("no process group: pass rank and world_size, or run under "
                               "torchrun (RANK, WORLD_SIZE)")
        backend = backend or "nccl"
        _check_backend(backend, world_size, device)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank)
    backend = backend or dist.get_backend()
    rank, world_size = dist.get_rank(), dist.get_world_size()
    _check_backend(backend, world_size, device)
    if backend == "nccl":
        local = _env_int("LOCAL_RANK", local_rank)
        dev = torch.device("cuda", rank if local is None else local)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.empty(0, device=dev)  # the context, before the DeviceMesh picks a card
    dm = init_device_mesh(dev.type, (world_size,), mesh_dim_names=(axis,))
    return RankMesh(n_shards=world_size, axis=axis, device=dev, rank=rank, backend=backend,
                    device_mesh=dm)


def _check_backend(backend: str, world_size: int, device) -> None:
    if backend == "nccl":
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError(f"NCCL ranks run on cards, not {device}")
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world_size > cards:
            raise ValueError(
                f"{world_size} NCCL ranks need {world_size} cards on this host, which has "
                f"{cards}: NCCL refuses two ranks on one card (share one with backend='gloo')"
            )
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, backend, device, port, tasks, results, threads):
    import faulthandler

    faulthandler.enable()  # a rank that crashes prints its stack
    try:
        fn, args = pickle.loads(tasks.get())
        if threads is not None:
            torch.set_num_threads(threads)
        # LOCAL_RANK: the card of an NCCL rank; gloo ranks share theirs
        local = rank if backend == "nccl" else (torch.device(device).index or 0)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(local),
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        mesh = rank_mesh(backend=backend, device=device, rank=rank, world_size=world_size,
                         init_method=f"tcp://localhost:{port}")
        # plain pickle: a tensor travels by value, not as a shared-memory
        # handle that dies with this process
        results.put((rank, True, pickle.dumps(fn(mesh, *args))))
    except BaseException:  # noqa: BLE001 - every failure goes to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world_size: int, backend: str = "gloo", device=None, args=(), *,
           threads: Optional[int] = None) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` ranks of this host, each a
    spawned process with its :class:`RankMesh`; return the ranks' results
    in rank order.

    ``fn`` and ``args`` must pickle (``fn`` a module-level function).  The
    ranks meet on a free localhost port.  ``device`` is the gloo ranks'
    device (None: the card); NCCL ranks take a card each.  ``threads`` sets
    each rank's torch, BLAS and OpenMP thread counts.  If a rank raises, or
    dies, or the ranks take longer than ``JOIN_TIMEOUT`` seconds, the
    others are killed and the parent raises with the rank's traceback."""
    _check_backend(backend, world_size, device)
    if backend == "gloo":
        device = resolve_device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for ranks on {device}; pass device=\"cpu\" "
                               "to run them on the CPU")
        device = str(device)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    # fn and args go by queue once the ranks run: a process's own
    # arguments would hold its start() until it had booted and read them,
    # one rank after another
    task, tasks = pickle.dumps((fn, args)), ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, backend, device, port, tasks, results, threads))
             for r in range(world_size)]
    # the ranks' BLAS and OpenMP pools read their size when they load
    pools = {k: str(threads) for k in _POOL_VARS} if threads is not None else {}
    saved = {k: os.environ.get(k) for k in pools}
    os.environ.update(pools)
    try:
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    for _ in procs:
        tasks.put(task)
    out, deadline = {}, time.monotonic() + JOIN_TIMEOUT
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"the {world_size} ranks did not finish in {JOIN_TIMEOUT} s "
                                   f"(done: {sorted(out)})")
            try:
                r, ok, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died (exit code "
                                       f"{procs[dead[0]].exitcode}) without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} of {world_size} raised:\n{payload}")
            out[r] = pickle.loads(payload)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 5.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
    return [out[r] for r in range(world_size)]
