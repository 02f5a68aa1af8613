"""Embedding, Linear and Dropout in Paddle's layout and semantics.

Counterparts of ``paddle_tpu/nn/layer/common.py``: ``Linear`` keeps its
weight as ``[in, out]`` and computes ``y = x @ W + b`` (not
``nn.Linear``'s ``[out, in]``), so weights cross from the JAX package
without a transpose. Parameters are allocated uninitialised (nothing at
all on ``device="meta"``); serving fills them through
``paddle_tpu_torch.weights.from_jax_state`` and keeps them frozen, while
a training model (``models.gpt``) asks for ``trainable=True`` and
initialises them itself.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ..functional import common as pf

__all__ = ["Dropout", "Embedding", "Linear"]


def _param(shape, dtype, device, trainable=False):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=trainable)


class Embedding(nn.Module):
    """Token embedding, weight ``[num_embeddings, embedding_dim]``."""

    def __init__(self, num_embeddings, embedding_dim, dtype=torch.float32,
                 device=None, trainable=False):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = _param((num_embeddings, embedding_dim), dtype, device,
                             trainable)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class Linear(nn.Module):
    """``y = x @ W + b`` with ``W: [in_features, out_features]``;
    ``bias_attr=False`` drops the bias, as in Paddle."""

    def __init__(self, in_features, out_features, bias_attr=None,
                 dtype=torch.float32, device=None, trainable=False):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _param((in_features, out_features), dtype, device,
                             trainable)
        self.bias = (None if bias_attr is False
                     else _param((out_features,), dtype, device, trainable))

    def forward(self, x):
        return pf.linear(x, self.weight, self.bias)


class Dropout(nn.Module):
    """``functional.dropout`` with the layer's ``axis`` and ``mode``
    (JAX's arguments), applied as ``self.training`` says; its masks are
    drawn from ``generator`` (a CPU ``torch.Generator``)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 generator=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return pf.dropout(x, self.p, axis=self.axis, training=self.training,
                          mode=self.mode, generator=self.generator)
