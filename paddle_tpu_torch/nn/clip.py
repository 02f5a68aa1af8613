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
once.
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


def _sum_shards(partials):
    """Sum each shard's partial over its group: ``partials`` is a list of
    (param, fp32 tensor); one all-reduce per group, over the partials
    stacked, in place of each."""
    by_group: dict = {}
    for i, (p, _) in enumerate(partials):
        info = getattr(p, "_shard_info", None)
        if info is not None:
            by_group.setdefault(id(info.group), (info, []))[1].append(i)
    out = [t for _, t in partials]
    for info, idx in by_group.values():
        summed = info.psum(torch.stack([out[i] for i in idx]))
        for k, i in enumerate(idx):
            out[i] = summed[k]
    return out


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
        sq = shard = None
        for p, g in params_grads:
            if _clipped(p, g):
                s = g.float().square().sum()
                if getattr(p, "_shard_info", None) is not None:
                    shard = s if shard is None else shard + s
                    info = p._shard_info
                else:
                    sq = s if sq is None else sq + s
        if shard is not None:
            shard = info.psum(shard)
            sq = shard if sq is None else sq + shard
        return sq

    def _dygraph_clip(self, params_grads):
        sq = self._global_norm_sq(params_grads)
        if sq is None:
            return list(params_grads)
        factor = _factor(sq.sqrt(), self.clip_norm)
        return [(p, _scaled(g, factor) if _clipped(p, g) else g)
                for p, g in params_grads]
