"""Multi-rank parallelism for cuzk_tpu_torch.

The counterpart of ``cuzk_tpu.parallel``: batches and tree leaves sharded
over ``torch.distributed`` ranks, one device a rank, with one all-gather
collapsing the shrinking upper Merkle levels.
"""

from cuzk_tpu_torch.parallel.distributed import (
    initialize_multiprocess,
    make_mesh,
    shard_batch,
    sharded_build_levels,
    sharded_generate_proofs,
    sharded_hash_pairs,
    sharded_hash_single,
    sharded_merkle_root,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "sharded_hash_pairs",
    "sharded_hash_single",
    "sharded_merkle_root",
    "sharded_build_levels",
    "sharded_generate_proofs",
    "initialize_multiprocess",
]
