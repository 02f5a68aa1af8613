"""Hybrid-parallel gradient and parameter helpers. Counterpart of
``paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py``.

JAX's broadcasts are no-ops (on its single-controller mesh a replicated
tensor is one value); here each rank is a process, so they are real:
without them, ranks built from different seeds would train different
models. ``allreduce_shared_weight_gradients`` sums the gradient of a
pipeline's shared weight (a ``SharedLayerDesc`` built on each stage that
uses it) over those stages, as Paddle's shared-weight all-reduce does. The gradient reductions are ``communication.reducer``'s, run
once: the gradients of one dtype in 32 MB buckets, one mean all-reduce
a bucket.
"""
from __future__ import annotations

import torch

from ...communication.group import as_group
from ...communication.group import ReduceOp
from ...communication.ops import _all_reduce, _sync_from_first
from ...communication.reducer import Entry, Reducer

__all__ = ["fused_allreduce_gradients", "broadcast_mp_parameters",
           "broadcast_dp_parameters", "broadcast_sharding_parameters",
           "sharding_reduce_gradients", "allreduce_shared_weight_gradients"]


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


def _process_mp(hcg):
    return hcg is not None and not hcg.is_serving_mesh() and \
        hcg.get_model_parallel_world_size() > 1


def _tensors(model, keep=lambda p: True, stage3_shards=True):
    """The model's parameters that ``keep`` admits and its floating
    buffers, a stage-3 parameter at rest as its shard (or left out)."""
    out = []
    for p in model.parameters():
        if not keep(p):
            continue
        if getattr(p, "_stage3", False):
            if stage3_shards:
                out.append(p._shard)
        else:
            out.append(p)
    return out + [b for b in model.buffers() if b.is_floating_point()]


def broadcast_mp_parameters(model, hcg):
    """The parameters not split over mp (no ``is_distributed``) and the
    floating buffers from the mp group's first rank (nothing under the
    serving mesh, whose controller holds every shard). A stage-3
    parameter at rest goes as its shard (the mp ranks of a sharding
    coordinate hold the same chunk)."""
    if not _process_mp(hcg):
        return
    from ..layers.mpu.mp_layers import mp_split
    _sync_from_first(_tensors(model, lambda p: mp_split(p) is None),
                     as_group(hcg.get_model_parallel_group()))


def broadcast_dp_parameters(model, hcg):
    """The model's parameters and floating buffers from the dp group's
    first rank (a stage-3 parameter at rest as its shard)."""
    if hcg is not None:
        _sync_from_first(_tensors(model),
                         as_group(hcg.get_data_parallel_group()))


def broadcast_sharding_parameters(model, hcg):
    """The same over the sharding group (a stage-3 parameter at rest is
    left out: its shards differ by rank)."""
    if hcg is not None:
        _sync_from_first(_tensors(model, stage3_shards=False),
                         as_group(hcg.get_sharding_parallel_group()))


def grad_holder(p):
    """The tensor whose gradient the optimizer steps for ``p``: the shard
    a GroupSharded stage made of it, else ``p``."""
    shard = getattr(p, "_shard", None)
    return shard if shard is not None else p


@torch.no_grad()
def allreduce_shared_weight_gradients(shared):
    """SUM-all-reduce the gradient of each shared weight over its group:
    ``shared`` is a list of (parameters, ``Group``) (a
    ``PipelineLayer``'s ``shared_weight_groups()``); one all-reduce a
    parameter (zeros where a stage made no gradient)."""
    for params, group in shared:
        for p in params:
            t = grad_holder(p)
            if t.grad is None:
                t.grad = torch.zeros_like(t)
            _all_reduce(t.grad, ReduceOp.SUM, group)
