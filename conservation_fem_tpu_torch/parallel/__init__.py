"""Decompositions of a problem over several blocks of one device or over
the ranks of a ``torch.distributed`` process group (the JAX package's
``parallel/``, which shards over a device mesh)."""

from conservation_fem_tpu_torch.parallel.blocked_advection_sharded import \
    DistributedBlockedAdvection
from conservation_fem_tpu_torch.parallel.blocked_pk_sharded import \
    DistributedBlockedPk
from conservation_fem_tpu_torch.parallel.blocked_sharded import \
    DistributedBlocked
from conservation_fem_tpu_torch.parallel.comm import (LocalBlocks,
                                                      ProcessGroupBlocks)
from conservation_fem_tpu_torch.parallel.euler_sharded import (
    ShardedStructuredEuler, shard_euler)
from conservation_fem_tpu_torch.parallel.partition import (
    CellPartition, Partition, build_cell_partition, build_partition)
from conservation_fem_tpu_torch.parallel.sharded import (
    ShardedHyperbolicProblem, shard_problem)
from conservation_fem_tpu_torch.parallel.stokes_sharded import ShardedStokes
from conservation_fem_tpu_torch.parallel.structured_fused_sharded import (
    ShardedFusedStructured, shard_structured_fused)
from conservation_fem_tpu_torch.parallel.structured_sharded import (
    ShardedStructuredKPP, shard_structured)
from conservation_fem_tpu_torch.parallel.unstructured_sharded import (
    DistributedAdvection, DistributedELL, DistributedHyperbolic,
    DistributedKPP, DistributedUnstructured, distributed_poisson_demo)

__all__ = ["CellPartition", "DistributedAdvection", "DistributedBlocked",
           "DistributedBlockedAdvection", "DistributedBlockedPk",
           "DistributedELL", "DistributedHyperbolic", "DistributedKPP",
           "DistributedUnstructured", "LocalBlocks", "Partition",
           "ProcessGroupBlocks", "ShardedFusedStructured",
           "ShardedHyperbolicProblem", "ShardedStokes",
           "ShardedStructuredEuler",
           "ShardedStructuredKPP", "build_cell_partition", "build_partition",
           "distributed_poisson_demo", "shard_euler", "shard_problem",
           "shard_structured", "shard_structured_fused"]
