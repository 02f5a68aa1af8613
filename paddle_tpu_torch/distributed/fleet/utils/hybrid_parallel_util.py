"""Hybrid-parallel gradient and parameter helpers. Counterpart of
``paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py``.

JAX's broadcasts are no-ops (on its single-controller mesh a replicated
tensor is one value); here each rank is a process, so they are real:
without them, ranks built from different seeds would train different
models. The gradient reductions are ``communication.reducer``'s, run
once: the gradients of one dtype in 32 MB buckets, one mean all-reduce
a bucket.
"""
from __future__ import annotations

from ...communication.group import as_group
from ...communication.ops import _sync_model
from ...communication.reducer import Entry, Reducer

__all__ = ["fused_allreduce_gradients", "broadcast_mp_parameters",
           "broadcast_dp_parameters", "broadcast_sharding_parameters",
           "sharding_reduce_gradients"]


def _fused_mean(params, group):
    """The reducer's bucketed mean all-reduce of ``params``' gradients
    over ``group``, run once (no hooks)."""
    g = as_group(group)
    Reducer([Entry(p) for p in params if p.requires_grad], g,
            hooks=False).sync_now()


def fused_allreduce_gradients(parameter_list, hcg):
    """Mean-all-reduce the gradients over the dp group (nothing at one
    rank)."""
    if hcg is None or hcg.get_data_parallel_world_size() <= 1:
        return
    _fused_mean(parameter_list, hcg.get_data_parallel_group())


def sharding_reduce_gradients(parameter_list, hcg):
    """Mean-all-reduce the gradients over the sharding group."""
    if hcg is None or hcg.get_sharding_parallel_world_size() <= 1:
        return
    _fused_mean(parameter_list, hcg.get_sharding_parallel_group())


def broadcast_mp_parameters(model, hcg):
    """Nothing: the port's model degree is one process over its mesh
    (across processes it is refused, ROADMAP Queue 1 item 10(e))."""


def broadcast_dp_parameters(model, hcg):
    """The model's parameters and floating buffers from the dp group's
    first rank."""
    if hcg is not None:
        _sync_model(model, as_group(hcg.get_data_parallel_group()))


def broadcast_sharding_parameters(model, hcg):
    """The same over the sharding group."""
    if hcg is not None:
        _sync_model(model, as_group(hcg.get_sharding_parallel_group()))
