"""Per-strategy model wrappers. Counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/parallel_layers.py``.

``ShardingParallel`` is what ``fleet.distributed_model`` returns under a
sharding degree: the model broadcast from the first rank of the sharding
group and then of the dp group (every rank starts from global rank 0's
parameters and buffers); the sharded state is the optimizer's
(``fleet.distributed_optimizer`` or ``group_sharded_parallel``).
``TensorParallel`` (a model degree over processes) broadcasts the
parameters that are not split over mp (those without ``is_distributed``)
from the mp group's first rank, then every parameter and floating buffer
from the dp group's first rank: each mp rank keeps its own slice of a
distributed parameter, the same across dp.
"""
from __future__ import annotations

import torch.nn as nn

__all__ = ["MetaParallelBase", "TensorParallel", "ShardingParallel"]


class MetaParallelBase(nn.Module):
    def __init__(self, layers, hcg, strategy):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self._prepare_for_model()

    def _prepare_for_model(self):
        pass

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.load_state_dict(sd, *a, **k)

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)


class TensorParallel(MetaParallelBase):
    def _prepare_for_model(self):
        from ..utils.hybrid_parallel_util import (broadcast_dp_parameters,
                                                  broadcast_mp_parameters)
        broadcast_mp_parameters(self._layers, self._hcg)
        broadcast_dp_parameters(self._layers, self._hcg)


class ShardingParallel(MetaParallelBase):
    def _prepare_for_model(self):
        from ..utils.hybrid_parallel_util import (broadcast_dp_parameters,
                                                  broadcast_sharding_parameters)
        broadcast_sharding_parameters(self._layers, self._hcg)
        broadcast_dp_parameters(self._layers, self._hcg)
