"""The distributed layer: row-partitioned operators and preconditioners on
a mesh of shards (port of :mod:`sigma_tpu.parallel`; design in
:mod:`sigma_tpu_torch.parallel.dist`).  The same names run on a mesh of D
shards in one process, or on the rank mesh of
:mod:`sigma_tpu_torch.parallel.ranks` (``make_mesh(ranks=True)``: a
``torch.distributed`` process a rank, DTensor vectors); ``ranks`` also
holds ``rank_mesh`` and the ``launch`` of ranks on one host."""

from sigma_tpu_torch.parallel.precond import DistributedBlockILDU, distributed_block_ildu
from sigma_tpu_torch.parallel.amg import (
    distribute_amg,
    distribute_structured_amg,
    distributed_amg,
)
from sigma_tpu_torch.parallel.pruned import (
    DistributedPrunedMatrix,
    distribute_pruned,
    distributed_pruned_pair_amg,
)
from sigma_tpu_torch.parallel.dist import (
    balance_rows,
    DistributedDIAMatrix,
    DistributedMatrix,
    distribute_matrix_dia,
    distribute_matrix,
    distribute_vector,
    make_mesh,
    undistribute_vector,
)

__all__ = [
    "DistributedBlockILDU",
    "distributed_block_ildu",
    "distribute_amg",
    "distribute_structured_amg",
    "distributed_amg",
    "DistributedMatrix",
    "DistributedDIAMatrix",
    "DistributedPrunedMatrix",
    "distribute_pruned",
    "distributed_pruned_pair_amg",
    "distribute_matrix_dia",
    "distribute_matrix",
    "distribute_vector",
    "undistribute_vector",
    "make_mesh",
    "balance_rows",
]
