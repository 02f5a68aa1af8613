"""The model-parallel collectives of fleet's layers. Counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/mp_ops.py``.

JAX leaves these to GSPMD: its layers keep the full parameter with a
``PartitionSpec`` and XLA inserts each collective and derives the
backward one from its transpose rule. Here every mp rank is a process
holding its slice, so each op is a ``torch.autograd.Function`` whose
forward and backward collectives are written out, over the model-parallel
group (``COLLECTIVES`` counts each):

- ``_c_identity``: forward the identity, backward a SUM all-reduce (a
  replicated input feeding a column-split layer);
- ``_mp_allreduce``: forward a SUM all-reduce, backward the identity (the
  partial sums of a row-split layer);
- ``_c_split``: forward this rank's chunk of the last axis, backward an
  all-gather of it;
- ``_c_concat``: forward an all-gather along the last axis, backward this
  rank's chunk.

``group`` is a ``Group`` or a torch ProcessGroup; None takes the active
fleet topology's model-parallel group where it is one of processes. A
group of one rank, or none, makes each op a clone, as in JAX.
"""
from __future__ import annotations

import torch

from ....communication.group import ReduceOp, as_group
from ....communication.ops import _all_gather_flat, _all_reduce

__all__ = ["_c_identity", "_c_concat", "_c_split", "_mp_allreduce", "split",
           "mp_group"]


def mp_group(group=None):
    """``group`` (or, for None, the fleet topology's model-parallel group
    over processes) as a ``Group``; None where it has one rank, where no
    topology is active, or where the topology is the single-controller
    serving mesh (whose shards are not processes)."""
    if group is None:
        from ...base.topology import _HYBRID_GROUP
        hcg = _HYBRID_GROUP[0]
        if hcg is None or hcg.is_serving_mesh() or \
                hcg.get_model_parallel_world_size() == 1:
            return None
        group = hcg.get_model_parallel_group()
    g = as_group(group)
    return g if g.nranks > 1 else None


def _gather_last(x, g):
    """Every rank's ``x`` side by side along the last axis, in rank
    order."""
    buf = x.new_empty((g.nranks, *x.shape))
    _all_gather_flat(buf, x.contiguous(), g)
    return torch.cat(buf.unbind(0), dim=-1)


def _chunk_last(x, g):
    """This rank's chunk of ``x``'s last axis (it must divide)."""
    n = x.shape[-1]
    if n % g.nranks:
        raise ValueError(f"mp split: the last axis ({n}) is not divisible "
                         f"by the model-parallel degree {g.nranks}")
    c = n // g.nranks
    return x[..., g.rank * c:(g.rank + 1) * c].contiguous()


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        _all_reduce(grad, ReduceOp.SUM, ctx.g)
        return grad, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        out = x.contiguous().clone()
        _all_reduce(out, ReduceOp.SUM, g)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _chunk_last(x, g)

    @staticmethod
    def backward(ctx, grad):
        return _gather_last(grad, ctx.g), None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _gather_last(x, g)

    @staticmethod
    def backward(ctx, grad):
        return _chunk_last(grad, ctx.g), None


def _run(fn, tensor, g):
    return tensor.clone() if g is None else fn.apply(tensor, g)


def _c_identity(tensor, group=None, skip_c_identity_dynamic=False):
    """Forward identity, backward SUM all-reduce over the mp group."""
    return _run(_Identity, tensor, mp_group(group))


def _c_concat(tensor, group=None):
    """The mp ranks' tensors side by side along the last axis (backward:
    this rank's chunk of the gradient)."""
    return _run(_Concat, tensor, mp_group(group))


def _c_split(tensor, group=None):
    """This rank's chunk of the last axis (backward: the all-gather)."""
    return _run(_Split, tensor, mp_group(group))


def _mp_allreduce(tensor, op=None, group=None, use_calc_stream=True,
                  use_model_parallel=True):
    """SUM all-reduce over the mp group (backward: the identity). Only the
    sum is defined, as in Paddle."""
    if op not in (None, ReduceOp.SUM):
        raise ValueError(f"_mp_allreduce: only ReduceOp.SUM, got {op}")
    return _run(_AllReduce, tensor, mp_group(group))


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """``paddle.distributed.split``: build the model-parallel linear
    (``axis`` 0: row-split, else column-split) or embedding of ``size``
    and apply it to ``x``."""
    from .mp_layers import (ColumnParallelLinear, RowParallelLinear,
                            VocabParallelEmbedding)
    if operation == "linear":
        if axis == 0:
            layer = RowParallelLinear(size[0], size[1],
                                      weight_attr=weight_attr,
                                      has_bias=bias_attr is not False)
        else:
            layer = ColumnParallelLinear(size[0], size[1],
                                         weight_attr=weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out)
        return layer(x)
    if operation == "embedding":
        layer = VocabParallelEmbedding(size[0], size[1],
                                       weight_attr=weight_attr)
        return layer(x)
    raise ValueError(f"unsupported operation {operation}")
