"""Gradient clipping. Counterpart of ``paddle_tpu/nn/clip.py``.

A clip is a callable on a list of ``(param, grad)`` pairs returning the
clipped pairs; the optimizer applies its ``grad_clip`` before anything
else of its step. The norms and factors stay on the gradients' device
(no host sync), are taken in fp32, and each clipped gradient is rounded
back to its own dtype, as in the JAX package. A parameter whose
``need_clip`` is False (``ParamAttr(need_clip=False)``) keeps its
gradient as it is and, under ``ClipGradByGlobalNorm``, adds nothing to
the norm.

A gradient of a shard (its parameter carries ``_shard_info``, as the
GroupSharded stages' shards do) adds its squares to the norm of the whole
parameter: the shards' partials are summed over their group with one
all-reduce a group a call, and a whole (replicated) gradient is counted
once. Likewise a gradient of an mp slice (``is_distributed``, from
fleet's model-parallel layers) is summed over its model-parallel group,
one all-reduce a group a call, while a parameter replicated over mp is
counted once, not mp times. Under a pipeline of more than one stage the
global norm's square is summed over the pipe group (one all-reduce), a
shared weight's copy off its owner stage (``_pp_shared_copy``) adding
nothing, so every stage clips by the same factor.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)


class ClipGradByValue(ClipGradBase):
    """Each element into [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def _dygraph_clip(self, params_grads):
        return [(p, g.clamp(self.min, self.max) if _clipped(p, g) else g)
                for p, g in params_grads]


def _scaled(g, factor):
    return (g.float() * factor).to(g.dtype)


def _factor(norm, clip_norm):
    """clip_norm / max(norm, 1e-12) where norm exceeds clip_norm, else 1."""
    return torch.where(norm > clip_norm,
                       clip_norm / torch.clamp(norm, min=1e-12),
                       torch.ones((), device=norm.device))


def _groups(p):
    """(sharding ``Group`` or None, mp ``Group`` or None) over which
    ``p``'s gradient's partials are summed."""
    from ..distributed.fleet.layers.mpu.mp_layers import mp_split
    info = getattr(p, "_shard_info", None)
    return (info.group if info is not None else None), mp_split(p)


def _psum_by(values, groups):
    """``values`` (fp32 scalars) with each one that has a group summed
    over it: one all-reduce a distinct group, of its values stacked."""
    from ..distributed.communication.group import ReduceOp
    from ..distributed.communication.ops import _all_reduce
    out = list(values)
    by: dict = {}
    for i, g in enumerate(groups):
        if g is not None:       # one entry a process group
            by.setdefault(id(g.pg), (g, []))[1].append(i)
    for g, idx in by.values():
        summed = torch.stack([out[i] for i in idx])
        _all_reduce(summed, ReduceOp.SUM, g)
        for k, i in enumerate(idx):
            out[i] = summed[k]
    return out


def _sum_shards(partials):
    """Sum each partial over its parameter's sharding group, then over
    its mp group where it is an mp slice: ``partials`` is a list of
    (param, fp32 tensor)."""
    groups = [_groups(p) for p, _ in partials]
    out = _psum_by([t for _, t in partials], [g[0] for g in groups])
    return _psum_by(out, [g[1] for g in groups])


def _pipe_group():
    """The pipe group where a pipeline of more than one stage runs."""
    from ..distributed.fleet.base.topology import _HYBRID_GROUP
    hcg = _HYBRID_GROUP[0]
    if hcg is None or hcg.is_serving_mesh() or \
            hcg.get_pipe_parallel_world_size() == 1:
        return None
    from ..distributed.communication.group import as_group
    return as_group(hcg.get_pipe_parallel_group())


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled down to an L2 norm of at most clip_norm."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _dygraph_clip(self, params_grads):
        sq = _sum_shards([(p, g.float().square().sum())
                          for p, g in params_grads if _clipped(p, g)])
        sq = iter(sq)
        out = []
        for p, g in params_grads:
            if _clipped(p, g):
                g = _scaled(g, _factor(next(sq).sqrt(), self.clip_norm))
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients scaled by one factor, so that their joint L2 norm
    (the fp32 squares summed in parameter order) is at most clip_norm.
    ``group_name`` and ``auto_skip_clip`` are taken and, as in JAX,
    unused."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def _global_norm_sq(self, params_grads):
        """The square of the global norm: every clipped gradient's fp32
        squares, each partial summed over its groups (``_sum_shards``),
        then over the pipe group; None where there is nothing to clip
        and no pipeline."""
        kept = [(p, g.float().square().sum()) for p, g in params_grads
                if _clipped(p, g) and not getattr(p, "_pp_shared_copy",
                                                  False)]
        sq = None
        for t in _sum_shards(kept):
            sq = t if sq is None else sq + t
        pipe = _pipe_group()
        if pipe is not None:
            from ..distributed.communication.group import ReduceOp
            from ..distributed.communication.ops import _all_reduce
            if sq is None:
                sq = torch.zeros((), device=params_grads[0][0].device)
            _all_reduce(sq, ReduceOp.SUM, pipe)
        return sq

    def _dygraph_clip(self, params_grads):
        sq = self._global_norm_sq(params_grads)
        if sq is None:
            return list(params_grads)
        factor = _factor(sq.sqrt(), self.clip_norm)
        return [(p, _scaled(g, factor) if _clipped(p, g) else g)
                for p, g in params_grads]
