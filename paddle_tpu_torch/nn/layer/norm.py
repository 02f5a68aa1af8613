"""LayerNorm and RMSNorm. Counterparts of ``paddle_tpu/nn/layer/norm.py``'s
``LayerNorm`` (weight ones and bias zeros over ``normalized_shape``) and
``RMSNorm`` (weight ones), all trainable."""
from __future__ import annotations

import torch
from torch import nn

from ..functional import norm

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    """JAX's parameter order; ``weight_attr=False`` / ``bias_attr=False``
    drop that parameter, as there (any other attr is ignored there too:
    the scale starts at one, the bias at zero). ``dtype`` and ``device``
    are the port's own, keyword-only."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(self.normalized_shape, dtype=dtype, device=device))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(self.normalized_shape, dtype=dtype, device=device))

    def forward(self, x):
        return norm.layer_norm(x, self.normalized_shape, self.weight,
                               self.bias, self.epsilon)


class RMSNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-6, name=None, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(self.normalized_shape, dtype=dtype, device=device))

    def forward(self, x):
        return norm.rms_norm(x, self.weight, self.epsilon)
