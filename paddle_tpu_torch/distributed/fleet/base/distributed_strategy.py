"""DistributedStrategy. Counterpart of
``paddle_tpu/distributed/fleet/base/distributed_strategy.py``: a typed
bag of Paddle's strategy fields with JAX's defaults. ``fleet.init`` reads
``hybrid_configs``; as in JAX's dygraph path, nothing else reads the rest
(JAX's static-graph ``StaticMetaOptimizer`` does, and waits for ROADMAP
Queue 1 item 10(e)'s ``static``).
"""
from __future__ import annotations

__all__ = ["DistributedStrategy"]


class _Config(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
            "order": ["dp", "pp", "sharding", "sep", "mp"],
            "mp_configs": _Config(),
            "pp_configs": _Config({
                "micro_batch_size": 1,
                "accumulate_steps": 1,
                "delay_scale_loss": False,
                "enable_partial_send_recv": True,
            }),
        }
        self.amp = False
        self.amp_configs = _Config({
            "init_loss_scaling": 32768.0,
            "use_dynamic_loss_scaling": True,
            "custom_white_list": [],
            "custom_black_list": [],
            "use_pure_fp16": False,
            "use_fp16_guard": True,
            "dtype": "bfloat16",
            "level": "O1",
        })
        self.recompute = False
        self.recompute_configs = _Config({
            "checkpoints": [],
            "enable_offload": False,
        })
        self.sharding = False
        self.sharding_configs = _Config({
            "sharding_degree": 1,
            "stage": 1,
            "offload": False,
        })
        self.gradient_merge = False
        self.gradient_merge_configs = _Config({"k_steps": 1, "avg": True})
        self.pipeline = False
        self.pipeline_configs = _Config({
            "micro_batch_size": 1,
            "accumulate_steps": 1,
        })
        self.tensor_parallel = False
        self.tensor_parallel_configs = _Config({
            "tensor_parallel_degree": 1,
            "tensor_init_seed": -1,
        })
        self.lamb = False
        self.lars = False
        self.dgc = False
        self.localsgd = False
        self.a_sync = False
        self.heter_ccl_mode = False
        self.find_unused_parameters = False
        self.fuse_grad_size_in_MB = 32
        self.last_comm_group_size_MB = 1
        self.fuse_all_reduce_ops = True
        self.nccl_comm_num = 1

    def __repr__(self):
        lines = ["DistributedStrategy("]
        hc = self.hybrid_configs
        lines.append(f"  hybrid: dp={hc['dp_degree']} mp={hc['mp_degree']} "
                     f"pp={hc['pp_degree']} sharding={hc['sharding_degree']} "
                     f"sep={hc.get('sep_degree', 1)}")
        lines.append(")")
        return "\n".join(lines)
