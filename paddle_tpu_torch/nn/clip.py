"""Gradient clipping. Counterpart of ``paddle_tpu/nn/clip.py``.

A clip is a callable on a list of ``(param, grad)`` pairs returning the
clipped pairs; the optimizer applies its ``grad_clip`` before anything
else of its step. The norms and factors stay on the gradients' device
(no host sync), are taken in fp32, and each clipped gradient is rounded
back to its own dtype, as in the JAX package. A parameter whose
``need_clip`` is False (``ParamAttr(need_clip=False)``) keeps its
gradient as it is and, under ``ClipGradByGlobalNorm``, adds nothing to
the norm.
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


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled down to an L2 norm of at most clip_norm."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _dygraph_clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clipped(p, g):
                norm = g.float().square().sum().sqrt()
                g = _scaled(g, _factor(norm, self.clip_norm))
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
        sq = None
        for p, g in params_grads:
            if _clipped(p, g):
                s = g.float().square().sum()
                sq = s if sq is None else sq + s
        return sq

    def _dygraph_clip(self, params_grads):
        sq = self._global_norm_sq(params_grads)
        if sq is None:
            return list(params_grads)
        factor = _factor(sq.sqrt(), self.clip_norm)
        return [(p, _scaled(g, factor) if _clipped(p, g) else g)
                for p, g in params_grads]
