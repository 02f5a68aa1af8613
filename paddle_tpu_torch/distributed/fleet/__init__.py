"""Fleet facade. Counterpart of ``paddle_tpu/distributed/fleet/__init__.py``:
``fleet.init`` builds the hybrid topology that ``parallel.current_mesh()``
returns: a data / sharding / sep mesh over the process group (LLaMA's
ring or Ulysses attention runs over its sep axis, the GroupSharded
stages over its sharding axis), or (``mp_degree`` above 1, every other
degree 1) the single-controller mesh the serving engine and ``generate``
shard over. ``distributed_model`` and ``distributed_optimizer`` wrap by
the topology's parallel mode, as JAX's do, and the worker API reads the
process group. Pipeline and tensor-parallel training stay with ROADMAP
Queue 1 item 10(e).
"""
from __future__ import annotations

import sys

from .base.distributed_strategy import DistributedStrategy
from .base.topology import CommunicateTopology, HybridCommunicateGroup

__all__ = ["DistributedStrategy", "init", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "worker_index", "worker_num", "is_first_worker", "barrier_worker",
           "CommunicateTopology", "HybridCommunicateGroup"]

_fleet_state = {"strategy": None, "hcg": None}


def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO", *, device=None, devices=None):
    """Initialise the parallel environment on ``device`` (default the
    card; see ``distributed.init_parallel_env``) and the hybrid mesh of
    ``strategy.hybrid_configs``; a model degree above 1 shards over
    ``devices`` (default the first ``mp_degree`` devices of ``device``'s
    type). Returns the fleet module."""
    from ...device import resolve_device
    from ..parallel import init_parallel_env
    strategy = strategy or DistributedStrategy()
    hc = strategy.hybrid_configs
    # a model degree is one controller over its mesh: no process group
    dev = (resolve_device(device) if hc.get("mp_degree", 1) > 1
           else init_parallel_env(device=device))
    topo = CommunicateTopology(
        hybrid_group_names=("data", "pipe", "sharding", "sep", "model"),
        dims=(hc.get("dp_degree", 1), hc.get("pp_degree", 1),
              hc.get("sharding_degree", 1), hc.get("sep_degree", 1),
              hc.get("mp_degree", 1)))
    hcg = HybridCommunicateGroup(topo, device_type=dev.type,
                                 devices=devices)
    _fleet_state.update(strategy=strategy, hcg=hcg)
    return sys.modules[__name__]


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    if _fleet_state["hcg"] is None:
        init()
    return _fleet_state["hcg"]


def _get_strategy() -> DistributedStrategy:
    return _fleet_state["strategy"] or DistributedStrategy()


def distributed_model(model):
    """``model`` wrapped for the topology's parallel mode: ``DataParallel``
    over the dp group (dp above 1), ``ShardingParallel`` under a sharding
    degree; a model that a GroupSharded stage already wraps, or a world
    of one data-parallel rank, as it is. Pipeline and tensor parallelism
    raise (ROADMAP Queue 1 item 10(e))."""
    from ...framework.layer_helpers import DataParallel
    from .meta_parallel.parallel_layers import (ShardingParallel,
                                                TensorParallel)
    from .meta_parallel.sharding.group_sharded import (GroupShardedStage2,
                                                       GroupShardedStage3)
    hcg = get_hybrid_communicate_group()
    strategy = _get_strategy()
    if hcg.get_pipe_parallel_world_size() > 1:
        raise NotImplementedError(
            "fleet.distributed_model: pipeline parallelism is not ported "
            "yet (ROADMAP Queue 1 item 10(e))")
    if isinstance(model, (GroupShardedStage2, GroupShardedStage3)):
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
