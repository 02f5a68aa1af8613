"""fleet.meta_parallel: the per-strategy model wrappers and the
GroupSharded stages. Counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/__init__.py``; the pipeline
layers and the model-parallel layers stay with ROADMAP Queue 1 item
10(e)."""
from .parallel_layers import MetaParallelBase, ShardingParallel, TensorParallel
from .sharding.group_sharded import (GroupShardedOptimizerStage2,
                                     GroupShardedStage2, GroupShardedStage3)

__all__ = ["MetaParallelBase", "TensorParallel", "ShardingParallel",
           "GroupShardedStage2", "GroupShardedStage3",
           "GroupShardedOptimizerStage2"]
