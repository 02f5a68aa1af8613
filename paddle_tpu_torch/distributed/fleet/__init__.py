"""Fleet facade. Counterpart of ``paddle_tpu/distributed/fleet/__init__.py``:
``fleet.init`` builds the hybrid topology that ``parallel.current_mesh()``
returns. Launched as one process with ``mp_degree`` above 1 and every
other degree 1, it is the single-controller mesh the serving engine and
``generate`` shard over (PR 22); otherwise it is a process group per
axis over the launched processes (one a rank: LLaMA's ring or Ulysses
attention runs over sep, the GroupSharded stages over sharding, fleet's
model-parallel layers over mp and the pipeline's point-to-point calls
over pp). ``distributed_model`` and ``distributed_optimizer`` wrap by
the topology, as JAX's do, and the worker API reads the process group.
"""
from __future__ import annotations

import sys

from . import meta_parallel
from .base.distributed_strategy import DistributedStrategy
from .base.topology import (CommunicateTopology, HybridCommunicateGroup,
                            check_world, launched_world, serving_degrees)
from .utils import recompute_mod
from .utils.recompute_mod import recompute, recompute_sequential

__all__ = ["DistributedStrategy", "init", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "worker_index", "worker_num", "is_first_worker", "barrier_worker",
           "recompute", "CommunicateTopology", "HybridCommunicateGroup"]

_fleet_state = {"strategy": None, "hcg": None}


def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO", *, device=None, devices=None):
    """Initialise the parallel environment on ``device`` (default the
    card; see ``distributed.init_parallel_env``) and the hybrid topology
    of ``strategy.hybrid_configs``. One process with a model degree above
    1 and every other degree 1 gets the serving mesh over ``devices``
    (default the first ``mp_degree`` devices of ``device``'s type) and
    no process group; any other topology joins the process group of the
    launched world, one process a rank. With a model degree over
    processes, the model-parallel random stream is seeded as JAX seeds
    it (``tensor_parallel_configs["tensor_init_seed"]``, else 100).
    Returns the fleet module."""
    from ...device import resolve_device
    from ..parallel import init_parallel_env
    strategy = strategy or DistributedStrategy()
    hc = strategy.hybrid_configs
    dims = (hc.get("dp_degree", 1), hc.get("pp_degree", 1),
            hc.get("sharding_degree", 1), hc.get("sep_degree", 1),
            hc.get("mp_degree", 1))
    degrees = dict(zip(("dp", "pp", "sharding", "sep", "mp"), dims))
    world = launched_world()
    check_world(degrees, world)
    serving = serving_degrees(degrees, world)
    dev = resolve_device(device) if serving else init_parallel_env(
        device=device)
    topo = CommunicateTopology(
        hybrid_group_names=("data", "pipe", "sharding", "sep", "model"),
        dims=dims)
    hcg = HybridCommunicateGroup(topo, device_type=dev.type,
                                 devices=devices)
    _fleet_state.update(strategy=strategy, hcg=hcg)
    if degrees["mp"] > 1 and not serving:
        from ...core.rng import model_parallel_random_seed
        seed = strategy.tensor_parallel_configs.get("tensor_init_seed", -1)
        model_parallel_random_seed(seed if seed > 0 else 100)
    return sys.modules[__name__]


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    if _fleet_state["hcg"] is None:
        init()
    return _fleet_state["hcg"]


def _get_strategy() -> DistributedStrategy:
    return _fleet_state["strategy"] or DistributedStrategy()


def distributed_model(model):
    """``model`` wrapped for the topology, as JAX's branches do:
    ``PipelineParallel`` (``...WithInterleave`` for a model of more than
    one virtual stage) for a pipeline degree above 1 or a
    ``PipelineLayer``; a model that a GroupSharded stage already wraps
    as it is; then by the parallel mode, ``TensorParallel``,
    ``ShardingParallel``, or ``DataParallel`` over the dp group (dp above
    1); else the model as it is."""
    from ...framework.layer_helpers import DataParallel
    from .meta_parallel.parallel_layers import (ShardingParallel,
                                                TensorParallel)
    from .meta_parallel.pipeline_parallel import (
        PipelineParallel, PipelineParallelWithInterleave)
    from .meta_parallel.pp_layers import PipelineLayer
    from .meta_parallel.sharding.group_sharded import (GroupShardedStage2,
                                                       GroupShardedStage3)
    hcg = get_hybrid_communicate_group()
    strategy = _get_strategy()
    inner = model._layers if isinstance(
        model, (GroupShardedStage2, GroupShardedStage3)) else model
    if hcg.get_pipe_parallel_world_size() > 1 or isinstance(inner,
                                                           PipelineLayer):
        if (getattr(inner, "_num_virtual_pipeline_stages", None) or 1) > 1:
            return PipelineParallelWithInterleave(inner, hcg, strategy)
        return PipelineParallel(inner, hcg, strategy)
    if inner is not model:
        return model
    mode = hcg.get_parallel_mode()
    if mode == "tensor_parallel":
        return TensorParallel(model, hcg, strategy)
    if mode == "sharding_parallel":
        return ShardingParallel(model, hcg, strategy)
    if hcg.get_data_parallel_world_size() > 1:
        return DataParallel(model, group=hcg.get_data_parallel_group())
    return model


def distributed_optimizer(optimizer, strategy=None):
    """``optimizer`` as a ``HybridParallelOptimizer`` over the topology."""
    from .meta_optimizers.dygraph_optimizer.hybrid_parallel_optimizer import \
        HybridParallelOptimizer
    return HybridParallelOptimizer(optimizer, get_hybrid_communicate_group(),
                                   strategy or _get_strategy())


def worker_index() -> int:
    from ..parallel import get_rank
    return get_rank()


def worker_num() -> int:
    from ..parallel import get_world_size
    return get_world_size()


def is_first_worker() -> bool:
    return worker_index() == 0


def barrier_worker():
    from ..communication.ops import barrier
    barrier()
