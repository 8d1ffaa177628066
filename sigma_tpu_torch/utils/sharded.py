"""Vectors sharded over ranks, as the solvers meet them.

A distributed operator on a rank mesh
(:func:`~sigma_tpu_torch.parallel.ranks.rank_mesh`) takes and returns
``torch.distributed.tensor.DTensor`` vectors sharded by rows (``Shard(0)``):
each rank holds its own block, and a reduction such as ``torch.dot`` is
the local dot plus an all-reduce.  The solvers run on them unchanged
except where they reduce, make work arrays or read small results back to
the host; these helpers do that for a plain tensor and a sharded one
alike.
On a plain tensor each helper is the identity or the plain allocation, so
single-device results keep their bits.

``torch.distributed.tensor`` is not imported here: a tensor can be a
DTensor only once that module is loaded.
"""

from __future__ import annotations

import sys

import torch

__all__ = ["as_like", "dense_apply", "dot", "gathered", "is_sharded", "like", "local",
           "reduced", "rows_like"]


def _dtensor_module():
    return sys.modules.get("torch.distributed.tensor")


def is_sharded(t) -> bool:
    """True for a DTensor (a vector spread over the ranks of a mesh)."""
    mod = _dtensor_module()
    return mod is not None and isinstance(t, mod.DTensor)


def reduced(t):
    """A reduction over sharded vectors (``torch.dot``, ``V @ w``) summed
    over the ranks now, so every rank holds the same value.  DTensor keeps
    such a result a partial sum, and on short blocks it then all-gathers
    the whole vector that the partial sum multiplies and reduce-scatters
    the product (two collectives of the vector's size where one of the
    scalar's does)."""
    if not is_sharded(t):
        return t
    mod = _dtensor_module()
    if not any(isinstance(p, mod.Partial) for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [mod.Replicate()] * t.device_mesh.ndim)


def dot(a, b):
    """``torch.dot(a, b)``, summed over the ranks for sharded vectors
    (:func:`reduced`)."""
    return reduced(torch.dot(a, b))


def local(t):
    """A small result reduced over the ranks (:func:`reduced`) as the plain
    tensor every rank holds the same of: no communication once it is
    replicated, and the ops that follow run without DTensor's dispatch."""
    if not is_sharded(t):
        return t
    return reduced(t).to_local()


def gathered(t):
    """``t`` as a plain tensor holding every rank's part: a small result
    (a reduction, a Gram matrix) about to be read on the host, or a whole
    vector.  A tensor sharded over a 1-D mesh is gathered as an all-reduce
    of its zero-padded blocks (adding zeros is exact): gloo all-gathers no
    tensor on a card, and all-reduces it."""
    if not is_sharded(t):
        return t
    mod = _dtensor_module()
    shard = [p for p in t.placements if isinstance(p, mod.Shard)]
    if not shard:
        return t.full_tensor()
    dim, local = shard[0].dim, t.to_local()
    D = t.device_mesh.size()
    offset = t.device_mesh.get_coordinate()[0] * -(-t.shape[dim] // D)
    full = local.new_zeros(t.shape)
    full.narrow(dim, offset, local.shape[dim]).copy_(local)
    return mod.DTensor.from_local(full, t.device_mesh, [mod.Partial()],
                                  run_check=False).full_tensor()


def like(t, ref):
    """A plain (replicated) tensor ``t`` as ``ref`` needs it in a product:
    the same tensor on every rank of ``ref``'s mesh when ``ref`` is
    sharded, else ``t`` itself."""
    if not is_sharded(ref):
        return t
    mod = _dtensor_module()
    return mod.DTensor.from_local(t, ref.device_mesh, [mod.Replicate()] * ref.device_mesh.ndim,
                                  run_check=False)


def as_like(full, ref):
    """A plain tensor ``full`` of ``ref``'s global shape laid out as
    ``ref`` is: each rank keeps its own rows (no communication)."""
    if not is_sharded(ref):
        return full
    return like(full, ref).redistribute(ref.device_mesh, ref.placements)


def rows_like(ref, rows: int) -> torch.Tensor:
    """A zero (rows, n) basis whose rows are vectors laid out as the
    length-n vector ``ref``: a plain tensor, or one sharded along its
    columns when ``ref`` is sharded."""
    shape = (rows,) + tuple(ref.shape)
    if not is_sharded(ref):
        return torch.zeros(shape, dtype=ref.dtype, device=ref.device)
    mod = _dtensor_module()
    placements = [mod.Shard(p.dim + 1) if isinstance(p, mod.Shard) else p
                  for p in ref.placements]
    return mod.zeros(shape, dtype=ref.dtype, device_mesh=ref.device_mesh,
                     placements=placements)


def dense_apply(C: torch.Tensor, r):
    """``C @ r`` in C's dtype, returned in r's: a dense coarse-grid solve.
    A sharded ``r`` is gathered, every rank forms the whole product (the
    single-device arithmetic) and keeps its own rows."""
    if not is_sharded(r):
        return (C @ r.to(C.dtype)).to(r.dtype)
    return as_like((C @ gathered(r).to(C.dtype)).to(r.dtype), r)
