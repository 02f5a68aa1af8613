"""paddle.distributed.sharding: ``group_sharded_parallel`` and
``save_group_sharded_model``. Counterpart of
``paddle_tpu/distributed/sharding/__init__.py``; the stages are
``fleet.meta_parallel.sharding.group_sharded``'s.
"""
from __future__ import annotations

from ..fleet.meta_parallel.sharding.group_sharded import (
    DygraphShardingOptimizer, GroupShardedOptimizerStage2,
    GroupShardedStage2, GroupShardedStage3, gather_optimizer_state)

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """``(model, optimizer, scaler)`` sharded at ``level``: "os" (stage 1:
    the optimizer wrapped), "os_g" (stage 2: both wrapped) or "p_g_os"
    (stage 3: the model wrapped, the optimizer pointed at the shards and
    returned). ``group`` / ``dp_group`` default to the fleet topology's
    sharding / dp groups (else every process and no dp)."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError(f"bad sharding level {level}")
    if offload:
        raise NotImplementedError(
            "group_sharded_parallel(offload=True): CPU offload is not "
            "implemented in the port (the sharded state stays on the "
            "parameters' device)")
    if level == "os":
        return model, DygraphShardingOptimizer(
            optimizer, group=group, dp_group=dp_group), scaler
    if level == "os_g":
        opt = GroupShardedOptimizerStage2(model.parameters(), optimizer,
                                          group=group, offload=offload,
                                          dp_group=dp_group)
        wrapped = GroupShardedStage2(model, opt, group=group,
                                     sync_buffers=sync_buffers,
                                     buffer_max_size=buffer_max_size,
                                     dp_group=dp_group)
        return wrapped, opt, scaler
    wrapped = GroupShardedStage3(model, optimizer=optimizer, group=group,
                                 sync_buffers=sync_buffers,
                                 segment_size=segment_size, offload=offload,
                                 sync_comm=sync_comm, dp_group=dp_group,
                                 exclude_layer=exclude_layer)
    return wrapped, optimizer, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """Write the model's full state (stage 3's gathered) to
    ``output/model.pdparams`` and, given ``optimizer``, its full state
    (``gather_optimizer_state``: the shards all-gathered) to
    ``output/model.pdopt``, in ``framework.io``'s pickle format. Every
    rank of the groups calls it (the gathers are collectives); the first
    process writes."""
    import os

    import torch.distributed as dist

    from ...framework.io import save
    state = model.state_dict()
    opt_state = (None if optimizer is None
                 else gather_optimizer_state(optimizer))
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    os.makedirs(output, exist_ok=True)
    save(state, os.path.join(output, "model.pdparams"))
    if opt_state is not None:
        save(opt_state, os.path.join(output, "model.pdopt"))
