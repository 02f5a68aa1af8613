"""Fleet facade. Counterpart of ``paddle_tpu/distributed/fleet/__init__.py``
for hybrid data and sep (context) parallelism and the serving mesh:
``fleet.init`` builds the hybrid mesh that ``parallel.current_mesh()``
returns, which ``LlamaForCausalLM(context_parallel=...)`` runs its ring or
Ulysses attention over, or (``mp_degree`` above 1, every other degree 1)
the single-controller mesh the serving engine and ``generate`` shard
over. ``distributed_model``, ``distributed_optimizer`` and the
worker API stay with ROADMAP Queue 1 item 10(e).
"""
from __future__ import annotations

import sys

from .base.distributed_strategy import DistributedStrategy
from .base.topology import CommunicateTopology, HybridCommunicateGroup

__all__ = ["DistributedStrategy", "init", "get_hybrid_communicate_group",
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
