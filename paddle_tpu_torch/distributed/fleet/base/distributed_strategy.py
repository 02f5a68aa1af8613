"""DistributedStrategy. Counterpart of
``paddle_tpu/distributed/fleet/base/distributed_strategy.py``: the hybrid
degrees that ``fleet.init`` reads (the other strategy fields, AMP,
recompute, sharding and the pipeline's, stay with ROADMAP Queue 1 item
10(e))."""
from __future__ import annotations

__all__ = ["DistributedStrategy"]


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
            "order": ["dp", "pp", "sharding", "sep", "mp"],
        }
