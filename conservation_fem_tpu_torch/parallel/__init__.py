"""Decompositions of a problem over several blocks of one device or over
the ranks of a ``torch.distributed`` process group (the JAX package's
``parallel/``, which shards over a device mesh)."""

from conservation_fem_tpu_torch.parallel.comm import (LocalBlocks,
                                                      ProcessGroupBlocks)
from conservation_fem_tpu_torch.parallel.euler_sharded import (
    ShardedStructuredEuler, shard_euler)
from conservation_fem_tpu_torch.parallel.structured_fused_sharded import (
    ShardedFusedStructured, shard_structured_fused)
from conservation_fem_tpu_torch.parallel.structured_sharded import (
    ShardedStructuredKPP, shard_structured)

__all__ = ["LocalBlocks", "ProcessGroupBlocks", "ShardedFusedStructured",
           "ShardedStructuredEuler", "ShardedStructuredKPP", "shard_euler",
           "shard_structured", "shard_structured_fused"]
