"""Embedding and Linear in Paddle's layout.

Counterparts of ``paddle_tpu/nn/layer/common.py``: ``Linear`` keeps its
weight as ``[in, out]`` and computes ``y = x @ W + b`` (not
``nn.Linear``'s ``[out, in]``), so weights cross from the JAX package
without a transpose. Parameters are allocated uninitialised (nothing at
all on ``device="meta"``); their values arrive through
``paddle_tpu_torch.weights.from_jax_state``.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

__all__ = ["Embedding", "Linear"]


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Embedding(nn.Module):
    """Token embedding, weight ``[num_embeddings, embedding_dim]``."""

    def __init__(self, num_embeddings, embedding_dim, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = _param((num_embeddings, embedding_dim), dtype, device)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class Linear(nn.Module):
    """``y = x @ W + b`` with ``W: [in_features, out_features]``;
    ``bias_attr=False`` drops the bias, as in Paddle."""

    def __init__(self, in_features, out_features, bias_attr=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _param((in_features, out_features), dtype, device)
        self.bias = (None if bias_attr is False
                     else _param((out_features,), dtype, device))

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias
