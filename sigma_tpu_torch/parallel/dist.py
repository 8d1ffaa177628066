"""Row-partitioned sparse matrices on a shard mesh: cyclic ring layouts.

Port of :mod:`sigma_tpu.parallel.dist`.  The JAX package runs one program
over a device mesh under ``shard_map``: every shard owns a contiguous
block of rows and the matching block of x and y, off-diagonal blocks are
grouped by their **cyclic block offset** ``k = (col_block - row_block) mod
D``, and the x block a shard needs from k steps round the ring arrives by
one ``ppermute``.  Only offsets that hold entries are stored or
exchanged: a banded matrix does two neighbour shifts, not an all-gather.

The port keeps that layout and replaces the SPMD program by one
controller over D shards (:class:`Mesh`):

* every array carries a leading shard axis, so shard d's block tensors
  are ``array[d]``, contiguous and its own;
* a ring shift is an explicit copy of every shard's block into the
  receiving shard's buffer (``torch.roll`` along the shard axis: buffer d
  receives block ``(d + k) mod D``), issued before the local product;
* a distributed vector is a plain tensor of length ``n_pad = D * block``
  whose d-th slice is shard d's block, so the port's unchanged solvers
  (their dot products are the sum over all shards) run distributed.

The D shards share one device: on one card they are the counterpart of
the JAX package's virtual CPU devices, and run the real layout, the halo
copies and the per-shard kernels.

The form for several cards is the rank mesh
(:mod:`sigma_tpu_torch.parallel.ranks`): one ``torch.distributed`` rank a
card, chosen by the mesh the caller builds (``make_mesh(...,
ranks=True)``).  Each rank keeps only its shard of every layout (leading
axis 1), a vector is a DTensor sharded by rows, and the copies above
become point-to-point sends.  The layouts below are written once for
both meshes: a product takes the mesh's local blocks (``mesh.blocks``),
posts its exchanges (``ring_shift``, ``ship``, ``neighbours``), runs the
per-shard kernels of the shards it holds and joins the result
(``mesh.join``), so every rank repeats the shard mesh's per-shard
arithmetic.

:class:`DistributedMatrix` keeps ELL blocks, one per ring offset, and
computes its gather-reduce in plain PyTorch, as the JAX package computes
it in no Pallas kernel.  :class:`DistributedDIAMatrix` keeps gather-free
diagonals and runs each shard's terms through the DIA SpMV kernel
(:func:`~sigma_tpu_torch.ops.spmv_dia.dia_spmv`, which replaces
``dia_spmv_pallas_blocked``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from sigma_tpu_torch.matrix.formats import DIAMatrix
from sigma_tpu_torch.operators.linear_operator import LinearOperator
from sigma_tpu_torch.ops.spmv_dia import dia_spmv
from sigma_tpu_torch.utils import ordered_sum
from sigma_tpu_torch.utils.device import resolve_device
from sigma_tpu_torch.utils.dtypes import to_numpy, torch_dtype
from sigma_tpu_torch.utils.sharded import gathered

__all__ = [
    "DistributedMatrix",
    "DistributedDIAMatrix",
    "distribute_matrix_dia",
    "distribute_matrix",
    "distribute_vector",
    "undistribute_vector",
    "make_mesh",
    "balance_rows",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ``n_shards`` shards on one ``device``; ``shape`` maps
    the axis name to the shard count, as a JAX mesh's does.  This process
    holds every shard, and an exchange is a copy between shard buffers;
    :class:`~sigma_tpu_torch.parallel.ranks.RankMesh` has the same methods
    with a rank a process."""

    n_shards: int
    axis: str
    device: torch.device

    @property
    def shape(self):
        return {self.axis: self.n_shards}

    @property
    def shard_ids(self) -> tuple:
        """The shards this process holds: all of them."""
        return tuple(range(self.n_shards))

    def local_shards(self, arr):
        """This process's part of a (D, ...) array of every shard's parts."""
        return arr

    def blocks(self, x) -> torch.Tensor:
        """(D, block, ...) view of a distributed vector."""
        return _shards(x, self.n_shards)

    def join(self, Y) -> torch.Tensor:
        """The distributed vector of the shards' blocks ((D, block, ...) or
        a list of D blocks)."""
        if isinstance(Y, (list, tuple)):
            return torch.cat(Y)
        return Y.reshape((-1,) + tuple(Y.shape[2:]))

    def distribute(self, full: torch.Tensor, n_pad: int) -> torch.Tensor:
        """``full`` zero-padded to ``n_pad`` rows on the mesh's device."""
        out = torch.zeros((n_pad,) + tuple(full.shape[1:]), dtype=full.dtype, device=self.device)
        out[: full.shape[0]] = full
        return out

    def ring_shift(self, X, ks):
        """k -> every shard's receive buffer for ring offset k."""
        return {k: _ring_shift(X, k) for k in ks}

    def ship(self, parts: dict):
        """k -> ``parts[k]`` shipped back on the reversed ring."""
        return {k: _ship(p, k) for k, p in parts.items()}

    def neighbours(self, to_prev, to_next):
        """``(from_next, from_prev)``: shard d receives what shard d + 1
        sends back and what shard d - 1 sends forward (None past the
        edges, or when nothing goes that way)."""
        D = self.n_shards
        from_next = [to_prev[d + 1] if to_prev is not None and d + 1 < D else None
                     for d in range(D)]
        from_prev = [to_next[d - 1] if to_next is not None and d > 0 else None
                     for d in range(D)]
        return from_next, from_prev

    def halos(self, X, Hw: int, forward_only: bool = False) -> torch.Tensor:
        """(D, block + 2 Hw, ...) buffers ``[left | x_d | right]``."""
        return _halo_buffers(X, Hw, forward_only)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Every process's ``t`` summed: this one's."""
        return t


def make_mesh(n_devices: Optional[int] = None, axis: str = "rows", *, device=None,
              ranks: bool = False):
    """A 1-D mesh of ``n_devices`` shards on ``device`` (None: CUDA).

    Unlike the JAX package's ``make_mesh``, which takes the first
    ``n_devices`` visible devices, the shards share one device: asking for
    4 shards on a host with one card gives 4 shards, not 1.  ``n_devices``
    None gives one shard per visible card (one on the CPU).

    ``ranks=True`` asks for the rank mesh instead
    (:func:`~sigma_tpu_torch.parallel.ranks.rank_mesh`): this process is
    one rank of the initialised process group (or of the one ``torchrun``
    describes), holding its own shard; ``n_devices``, if given, must be
    the group's size."""
    if ranks:
        from sigma_tpu_torch.parallel.ranks import rank_mesh

        mesh = rank_mesh(axis, device=device)
        if n_devices is not None and int(n_devices) != mesh.n_shards:
            raise ValueError(f"asked for {n_devices} shards on a group of {mesh.n_shards} ranks")
        return mesh
    device = resolve_device(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    if int(n_devices) < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_devices}")
    return Mesh(int(n_devices), axis, device)


def _ring_shift(X, k: int):
    """Every shard's receive buffer for ring offset k: row d of the result
    is a copy of block ``(d + k) mod D`` of ``X`` (D, ...), the block
    owner s sends to shard ``(s - k) mod D``."""
    return X.roll(-k, 0)


def _ship(X, k: int):
    """The reversed ring: row ``(s + k) mod D`` of the result is a copy of
    shard s's block, sent back to the owner of its columns."""
    return X.roll(k, 0)


def _shards(x, D: int):
    """(D, block, ...) view of a distributed vector or block of vectors."""
    return x.reshape((D, x.shape[0] // D) + tuple(x.shape[1:]))


def _halo_buffers(X, Hw: int, forward_only: bool = False):
    """(D, block + 2 * Hw, ...) buffers ``[left | x_d | right]`` of the
    shards' blocks X: shard d's own block and copies of the previous
    shard's last and the next shard's first ``Hw`` rows (zeros past the
    edge shards; with ``forward_only``, symmetric storage whose upper
    slots never read backwards, no left halo at all)."""
    D, blk = X.shape[0], X.shape[1]
    ext = X.new_empty((D, blk + 2 * Hw) + tuple(X.shape[2:]))
    ext[:, Hw : Hw + blk] = X
    ext[:, :Hw] = 0
    if not forward_only:
        ext[1:, :Hw] = X[:-1, blk - Hw :]
    ext[:, Hw + blk :] = 0
    ext[:-1, Hw + blk :] = X[1:, :Hw]
    return ext


def _local_first(offsets):
    """Iteration order with the local (offset-0) block first."""
    return sorted(range(len(offsets)), key=lambda i: offsets[i] != 0)


class _Distributed(LinearOperator):
    """What the distributed layouts share: the mesh and the vector
    plumbing."""

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def n_pad(self) -> int:
        return self.block * self.n_shards

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def n_local(self) -> int:
        """The shards this process holds (D on the shard mesh, 1 a rank)."""
        return len(self.mesh.shard_ids)

    def shard_vector(self, x) -> torch.Tensor:
        """Range-side vector (length n): rmatvec input / matvec output."""
        return distribute_vector(x, self.mesh, self.axis, self.n_pad)

    def unshard_vector(self, x) -> np.ndarray:
        return undistribute_vector(x, self.n)


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class DistributedMatrix(_Distributed):
    """Row-partitioned sparse matrix over a shard mesh.

    ``nodes[i]`` / ``vals[i]`` are the ELL blocks of cyclic offset
    ``offsets[i]``, (D, block, width_i): shard d's rows, their columns
    local to the owning shard's block of ``bcols`` columns (padding slots:
    column 0, value 0).  Rectangular matrices partition rows and columns
    over the same axis, each with its own block size (``block_cols``)."""

    nodes: Tuple[torch.Tensor, ...]
    vals: Tuple[torch.Tensor, ...]
    offsets: Tuple[int, ...]
    mesh: Mesh
    axis: str
    n: int
    m: int
    block: int
    block_cols: Optional[int] = None

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.m)

    @property
    def bcols(self) -> int:
        return self.block if self.block_cols is None else self.block_cols

    @property
    def m_pad(self) -> int:
        return self.bcols * self.n_shards

    @property
    def dtype(self):
        return self.vals[0].dtype if self.vals else torch.float64

    @property
    def nnz(self) -> int:
        local = sum(int(torch.count_nonzero(v)) for v in self.vals)
        return int(self.mesh.all_sum(torch.tensor(local, device=self.device)))

    def _shifted(self, X):
        """Every nonzero ring offset's receive buffers, posted up front."""
        return self.mesh.ring_shift(X, [k for k in dict.fromkeys(self.offsets) if k != 0])

    def matvec(self, x):
        X = self.mesh.blocks(x)
        L = X.shape[0]
        y = X.new_zeros((L, self.block))
        shifted = self._shifted(X)
        for i in _local_first(self.offsets):
            xk = X if self.offsets[i] == 0 else shifted[self.offsets[i]]
            node = self.nodes[i]
            g = torch.gather(xk, 1, node.reshape(L, -1)).reshape(node.shape)
            y = y + (self.vals[i].to(x.dtype) * g).sum(-1)
        return self.mesh.join(y)

    def matmat(self, X):
        """Multi-vector product: the same ring, whole (block, k) panels
        gathered."""
        Xs = self.mesh.blocks(X)
        L = Xs.shape[0]
        Y = Xs.new_zeros((L, self.block, X.shape[1]))
        shifted = self._shifted(Xs)
        shard = torch.arange(L, device=Xs.device)[:, None, None]
        for i in _local_first(self.offsets):
            Xk = Xs if self.offsets[i] == 0 else shifted[self.offsets[i]]
            Y = Y + torch.einsum("dnw,dnwk->dnk", self.vals[i].to(X.dtype),
                                 Xk[shard, self.nodes[i]])
        return self.mesh.join(Y)

    def _scatter(self, i):
        """(slots, targets, plan) of offset block i's transpose scatter,
        built once: the slots that hold a value (ELL padding, column 0 with
        value 0, would pile every short row's pad slots onto one target of
        the fixed-order sum; leaving zeros out changes no sum), their
        targets in the (D * bcols,) owner-block frame, and the fixed-order
        sum plan off the CPU."""
        node, val = self.nodes[i], self.vals[i]

        def build():
            L, bc = node.shape[0], self.bcols
            slots = torch.nonzero(val.reshape(-1)).squeeze(1)
            idx = (node + bc * torch.arange(L, device=node.device)[:, None, None]).reshape(-1)
            idx = idx[slots]
            plan = ordered_sum.sum_plan(idx, node.device) if ordered_sum.fixed_order(
                node.device) else None
            return slots, idx, plan

        return ordered_sum.cached((node, val), ("dist_rmatvec",), build)

    def _rapply(self, src_of, extra):
        L, bc = self.n_local, self.bcols
        parts = []
        for i in range(len(self.offsets)):
            slots, idx, plan = self._scatter(i)
            src = src_of(i).reshape((-1,) + extra)[slots]
            parts.append(ordered_sum.scatter_sum(src, idx, L * bc, plan).reshape((L, bc) + extra))
        ring = self.n_shards > 1
        shipped = self.mesh.ship({k: parts[i] for i, k in enumerate(self.offsets)
                                  if k != 0 and ring})
        Y = None
        for i, k in enumerate(self.offsets):
            contrib = shipped[k] if k != 0 and ring else parts[i]
            Y = contrib if Y is None else Y + contrib
        return self.mesh.join(Y)

    def rmatvec(self, x):
        """Transpose product: each shard scatter-adds its products into the
        owner blocks' columns, shipped back on the reversed ring (a
        fixed-order sum off the CPU)."""
        X = self.mesh.blocks(x)
        if not self.nodes:
            return self.mesh.join(X.new_zeros((X.shape[0], self.bcols)))
        return self._rapply(lambda i: self.vals[i].to(x.dtype) * X[:, :, None], ())

    def rmatmat(self, X):
        Xs = self.mesh.blocks(X)
        if not self.nodes:
            return self.mesh.join(Xs.new_zeros((Xs.shape[0], self.bcols, X.shape[1])))
        return self._rapply(lambda i: self.vals[i].to(X.dtype)[..., None] * Xs[:, :, None, :],
                            (X.shape[1],))

    def diagonal(self):
        """Main diagonal as a distributed vector (the offset-0 block's
        entries in their own column)."""
        if self.block_cols is not None and self.block_cols != self.block:
            raise ValueError("diagonal() requires a square block structure")
        if 0 not in self.offsets:
            return self.mesh.join(torch.zeros((self.n_local, self.block), dtype=self.dtype,
                                              device=self.device))
        i = self.offsets.index(0)
        node, val = self.nodes[i], self.vals[i]
        rows = torch.arange(self.block, device=node.device)
        return self.mesh.join((val * (node == rows[:, None])).sum(-1))

    def shard_domain_vector(self, x) -> torch.Tensor:
        """Domain-side vector (length m): matvec input / rmatvec output."""
        return distribute_vector(x, self.mesh, self.axis, self.m_pad)

    def unshard_domain_vector(self, x) -> np.ndarray:
        return undistribute_vector(x, self.m)

    def to_dense(self) -> np.ndarray:
        """The dense matrix (on a rank mesh, every rank's rows summed onto
        every rank: a collective)."""
        d = np.zeros((self.n_pad, self.m_pad))
        D, nb, nc = self.n_shards, self.block, self.bcols
        for i, k in enumerate(self.offsets):
            node, val = to_numpy(self.nodes[i]), to_numpy(self.vals[i])
            for j, s in enumerate(self.mesh.shard_ids):
                rows = np.repeat(np.arange(s * nb, (s + 1) * nb), node.shape[2])
                cols = (node[j] + ((s + k) % D) * nc).ravel()
                np.add.at(d, (rows, cols), val[j].ravel())
        d = to_numpy(self.mesh.all_sum(torch.from_numpy(d)))
        return d[: self.n, : self.m]

    def __repr__(self) -> str:
        return (
            f"DistributedMatrix(shape={self.shape}, shards={self.n_shards}, "
            f"offsets={self.offsets}, widths={tuple(v.shape[2] for v in self.vals)})"
        )


def distribute_vector(x, mesh: Mesh, axis: str, n_pad: int) -> torch.Tensor:
    """``x`` (a host array or a tensor, one or two dimensions) zero-padded
    to ``n_pad`` rows on the mesh's device.  On a rank mesh every rank
    passes the whole ``x`` and keeps its block: the result is a DTensor
    sharded by rows, the counterpart of the JAX package's
    ``NamedSharding``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return mesh.distribute(t, n_pad)


def undistribute_vector(x, n: int) -> np.ndarray:
    """The first n rows of a distributed vector, as host numpy (a sharded
    one gathered from every rank: a collective)."""
    return to_numpy(gathered(x))[:n]


def distribute_matrix(A, mesh: Mesh, axis: str = "rows") -> DistributedMatrix:
    """Partition a sparse matrix by rows over the mesh axis.

    Host symbolic step, as the JAX package's: pad n (and m, independently)
    to a multiple of D, bucket the entries by cyclic block offset, and
    build one ELL block per present offset with owner-local column
    indices.  Rectangular matrices (AMG prolongators) partition both
    dimensions over the same axis, each with its own block size."""
    D = mesh.shape[axis]
    n, m = A.shape
    nb = -(-n // D)  # rows per shard
    nc = -(-m // D)  # columns per shard
    n_pad = nb * D

    rows, cols, vals = A.entries()
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    rb, cb = rows // nb, cols // nc
    k_all = (cb - rb) % D
    offsets = tuple(int(k) for k in np.unique(k_all))
    dt = torch_dtype(A.dtype)
    host_dt = np.float64 if dt == torch.float64 else np.float32

    nodes, vblocks = [], []
    for k in offsets:
        sel = k_all == k
        r, c, v = rows[sel], cols[sel], vals[sel]
        c_local = c - (c // nc) * nc
        # ELL width per offset: the most entries of any row in this block
        cnt = np.bincount(r, minlength=n_pad)
        w = max(int(cnt.max()), 1)
        node = np.zeros((n_pad, w), dtype=np.int64)
        val = np.zeros((n_pad, w), dtype=host_dt)
        order = np.lexsort((c_local, r))
        r, c_local, v = r[order], c_local[order], v[order]
        slot = np.arange(r.size) - np.concatenate([[0], np.cumsum(cnt)[:-1]])[r]
        node[r, slot] = c_local
        val[r, slot] = v
        node, val = (mesh.local_shards(a.reshape(D, nb, w)) for a in (node, val))
        nodes.append(torch.from_numpy(np.ascontiguousarray(node)).to(mesh.device))
        vblocks.append(torch.from_numpy(np.ascontiguousarray(val)).to(device=mesh.device,
                                                                       dtype=dt))

    return DistributedMatrix(
        nodes=tuple(nodes), vals=tuple(vblocks), offsets=offsets, mesh=mesh, axis=axis,
        n=n, m=m, block=nb, block_cols=None if n == m else nc,
    )


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class DistributedDIAMatrix(_Distributed):
    """Row-partitioned matrix with gather-free DIA local blocks.

    Each global diagonal offset o splits per shard into a ring offset
    ``k = (col_block - row_block) mod D`` and a local offset ``lo = o -
    q * block`` (q the signed block difference), so each shard's product
    is the DIA SpMV of its diagonals over its own or a received x block.
    ``terms`` is the sorted tuple of (k, lo); ``data`` is (D, len(terms),
    block): shard d's values of term i are ``data[d, i]`` (0 where the
    column falls outside the owner block), so one ring's terms are
    contiguous rows of a shard's block.  On a rank mesh ``data`` holds the
    rank's shard only, (1, len(terms), block).

    ``matvec`` copies every nonzero ring's x blocks into the receiving
    shards' buffers first, then launches, per shard, the DIA SpMV once for
    the ring-0 terms and once for each received ring block, with the
    terms' local offsets.  The JAX package sends the ring-0 terms to its
    Pallas kernel only on a TPU, with at least 24 of them, blocks of at
    least 65,536 rows and f32 or bf16 values: those gates are limits of
    the TPU's VMEM and are not carried over, so every shard's every term
    runs the kernel on a CUDA device, f64 included."""

    data: torch.Tensor
    terms: Tuple[Tuple[int, int], ...]
    mesh: Mesh
    axis: str
    n: int
    block: int
    # (k, first term, end term, local offsets) of each ring, ring 0 first
    _rings: tuple = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        rings = {}
        for i, (k, lo) in enumerate(self.terms):
            rings.setdefault(k, []).append((i, lo))
        out = []
        for k in sorted(rings, key=lambda k: k != 0):
            idx = [i for i, _ in rings[k]]
            lo = torch.tensor([lo for _, lo in rings[k]], dtype=torch.int64,
                              device=self.data.device)
            out.append((k, idx[0], idx[-1] + 1, lo))
        object.__setattr__(self, "_rings", tuple(out))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def vals(self) -> Tuple[torch.Tensor, ...]:
        """The JAX package's per-term (n_pad,) diagonals (a rank's block of
        them on a rank mesh)."""
        return tuple(self.data[:, i].reshape(-1) for i in range(len(self.terms)))

    @property
    def nnz(self) -> int:
        return int(self.mesh.all_sum(torch.count_nonzero(self.data)))

    def astype(self, dtype) -> "DistributedDIAMatrix":
        """Cast the values only (iterate vectors keep the caller's dtype:
        the kernel reads bf16 values into f32 or f64 sums)."""
        return dataclasses.replace(self, data=self.data.to(torch_dtype(dtype)))

    def matvec(self, x):
        nb = self.block
        X = self.mesh.blocks(x)
        # the ring sends posted first, the local (ring-0) products meanwhile
        recv = self.mesh.ring_shift(X, [k for k, *_ in self._rings if k != 0])
        ys = [None] * X.shape[0]
        for k, a, b, lo in self._rings:
            Xk = X if k == 0 else recv[k]
            for d, y in enumerate(ys):
                t = dia_spmv(self.data[d, a:b], Xk[d], lo, nb, nb)
                ys[d] = t if y is None else y + t
        return self.mesh.join([X.new_zeros(nb) if y is None else y for y in ys])

    def rmatvec(self, x):
        """Transpose product: per term, the local product shifted by -lo
        into the owner block's frame and shipped on the reversed ring (one
        ring's terms together), in plain PyTorch (the JAX package runs it
        in no Pallas kernel)."""
        nb = self.block
        X = self.mesh.blocks(x)
        ws = []
        for i, (k, lo) in enumerate(self.terms):
            z = self.data[:, i].to(x.dtype) * X
            w = torch.zeros_like(z)  # w[:, j] = z[:, j - lo], 0 outside the block
            if 0 <= lo < nb:
                w[:, lo:] = z[:, : nb - lo]
            elif -nb < lo < 0:
                w[:, : nb + lo] = z[:, -lo:]
            ws.append(w)
        ring = self.n_shards > 1
        shipped = self.mesh.ship({k: torch.stack(ws[a:b], 1) for k, a, b, _ in self._rings
                                  if k != 0 and ring})
        y = X.new_zeros(X.shape)
        for k, a, b, _ in sorted(self._rings, key=lambda r: r[1]):  # term order
            for i in range(a, b):
                y = y + (shipped[k][:, i - a] if k != 0 and ring else ws[i])
        return self.mesh.join(y)

    def diagonal(self):
        for i, t in enumerate(self.terms):
            if t == (0, 0):
                return self.mesh.join(self.data[:, i])
        return self.mesh.join(torch.zeros((self.n_local, self.block), dtype=self.dtype,
                                          device=self.device))

    def __repr__(self) -> str:
        return f"DistributedDIAMatrix(n={self.n}, shards={self.n_shards}, terms={self.terms})"


def _dia_terms(A, D: int, nb: int, n_pad: int):
    """(terms, (T, n_pad) values) of a DIAMatrix, computed on its device
    diagonal by diagonal: the entries of every stored diagonal's in-range
    slots (what ``A.entries()`` lists), split by the block difference q
    of their rows and columns, without a host pass over the entries.
    Within a valid row no two entries share a term (their columns would
    differ by a multiple of n_pad), so the values equal the host path's."""
    n = A.shape[0]
    parts = {}
    for d, o in enumerate(A.graph.offsets):
        lo, hi = max(0, -o), min(n, n - o)
        if hi <= lo:
            continue
        i = torch.arange(lo, hi, device=A.data.device)
        q = torch.div(i + o, nb, rounding_mode="floor") - torch.div(i, nb, rounding_mode="floor")
        for qv in torch.unique(q).tolist():
            parts.setdefault((qv % D, o - qv * nb), []).append((d, i[q == qv]))
    terms = sorted(parts)
    buf = torch.zeros((len(terms), n_pad), dtype=A.dtype, device=A.data.device)
    for t, key in enumerate(terms):
        for d, rows in parts[key]:
            buf[t, rows] = A.data[d, rows]
    return terms, buf


def _coo_terms(A, D: int, nb: int, n_pad: int):
    """(terms, (T, n_pad) host values) from ``A.entries()``: the JAX
    package's host path, with one sort of the (k, lo) keys."""
    rows, cols, vals = A.entries()
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    q = cols // nb - rows // nb  # signed block difference
    k_all = q % D
    lo_all = (cols - rows) - q * nb  # local offset within the received block
    span = int(np.abs(lo_all).max(initial=0))
    W = 2 * span + 1
    ukey, inv = np.unique(k_all * W + (lo_all + span), return_inverse=True)
    terms = [(int(u // W), int(u % W) - span) for u in ukey]
    buf = np.zeros((len(terms), n_pad), dtype=np.float64 if A.dtype == torch.float64
                   else np.float32)
    buf[inv.reshape(-1), rows] = vals
    return terms, torch.from_numpy(buf)


def distribute_matrix_dia(A, mesh: Mesh, axis: str = "rows") -> DistributedDIAMatrix:
    """Partition a square matrix by rows with DIA (gather-free) local
    storage.  A DIAMatrix is split on its own device, diagonal by
    diagonal; any other matrix through its host entries, as the JAX
    package does.  On a rank mesh every rank splits the same global A and
    keeps its shard."""
    if A.shape[0] != A.shape[1]:
        raise ValueError("distribute_matrix_dia expects a square matrix")
    D = mesh.shape[axis]
    n = A.shape[0]
    nb = -(-n // D)
    n_pad = nb * D
    split = _dia_terms if isinstance(A, DIAMatrix) else _coo_terms
    terms, buf = split(A, D, nb, n_pad)
    data = mesh.local_shards(buf.reshape(len(terms), D, nb).transpose(0, 1))
    data = data.to(device=mesh.device, dtype=torch_dtype(A.dtype)).contiguous()
    return DistributedDIAMatrix(data=data, terms=tuple(terms), mesh=mesh, axis=axis, n=n,
                                block=nb)


def balance_rows(A, n_shards: int) -> np.ndarray:
    """Load-balancing row permutation for distribution: rows sorted by
    degree are dealt round-robin across shard-sized strides, so every
    shard receives the same mix of heavy and light rows and the per-shard
    ELL width (the most entries of a row) evens out.

    Returns ``p`` in scatter form (new = p[old]); distribute
    ``A.permute_rows(p).permute_cols(p)`` and permute vectors alike.  A
    host set-up utility, like every reordering."""
    n = A.shape[0]
    deg = A.graph.degrees_numpy() if hasattr(A, "graph") else np.bincount(
        A.entries()[0], minlength=n
    )
    nb = -(-n // n_shards)
    order = np.argsort(-deg, kind="stable")  # heavy rows first
    # the n valid positions round-robin across shards (slot j of shard s
    # is s*nb + j; positions >= n do not exist, so shards whose trailing
    # slots fall past n drop out of the rotation): a bijection onto
    # [0, n) for any n
    shard_grid, slot_grid = np.meshgrid(np.arange(n_shards), np.arange(nb), indexing="ij")
    positions = (shard_grid * nb + slot_grid).T.ravel()  # slot-major
    positions = positions[positions < n]
    p = np.empty(n, dtype=np.int64)
    p[order] = positions
    return p
