"""fleet.meta_parallel: the per-strategy model wrappers, the pipeline
layers and schedules, fleet's model-parallel layers and random stream,
and the GroupSharded stages. Counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/__init__.py``."""
from ..layers.mpu.mp_layers import (ColumnParallelLinear,
                                    ParallelCrossEntropy, RowParallelLinear,
                                    VocabParallelEmbedding)
from ..layers.mpu.random import (RNGStatesTracker, get_rng_state_tracker,
                                 model_parallel_random_seed)
from .parallel_layers import MetaParallelBase, ShardingParallel, TensorParallel
from .pipeline_parallel import (PipelineParallel,
                                PipelineParallelWithInterleave)
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc
from .sharding.group_sharded import (GroupShardedOptimizerStage2,
                                     GroupShardedStage2, GroupShardedStage3)

__all__ = ["MetaParallelBase", "TensorParallel", "ShardingParallel",
           "LayerDesc", "SharedLayerDesc", "PipelineLayer",
           "PipelineParallel", "PipelineParallelWithInterleave",
           "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "GroupShardedStage2",
           "GroupShardedStage3", "GroupShardedOptimizerStage2"]
