"""paddle.distributed's surface in the port: the parallel environment,
groups and collectives on ``torch.distributed`` (NCCL on the card, gloo
on the CPU), ``spawn``, ``fleet``'s hybrid topology and wrappers, and
the GroupSharded stages (``sharding``).

Counterpart of ``paddle_tpu/distributed/__init__.py``; auto-parallel,
checkpointing, resilience and rpc stay with ROADMAP Queue 1 item 10(e).
"""
from __future__ import annotations

from . import fleet, sharding
from .communication.all_reduce import all_reduce
from .communication.group import (Group, ReduceOp, destroy_process_group,
                                  get_group, is_initialized, new_group)
from .communication.ops import (P2POp, all_gather, all_gather_object,
                                alltoall, alltoall_single, barrier,
                                batch_isend_irecv, broadcast,
                                broadcast_object_list, gather, get_backend,
                                irecv, isend, recv, reduce, reduce_scatter,
                                scatter, scatter_object_list, send, stream)
from .parallel import (ParallelEnv, all_reduce_gradients, get_rank,
                       get_world_size, init_parallel_env)
from .spawn_mod import spawn

__all__ = [
    "init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
    "all_reduce", "all_gather", "broadcast", "reduce", "scatter", "alltoall",
    "alltoall_single", "send", "recv", "isend", "irecv", "barrier",
    "reduce_scatter", "new_group", "get_group", "ReduceOp", "fleet",
    "sharding", "spawn", "is_initialized", "destroy_process_group", "Group",
    "all_gather_object", "broadcast_object_list", "scatter_object_list",
    "gather", "P2POp", "batch_isend_irecv", "get_backend", "stream",
    "all_reduce_gradients",
]
