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


def _no_initializer(layer, what, attr):
    """Refuse a ``ParamAttr`` that names an initializer (JAX's layers draw
    from it; the port's parameters get their values from
    ``weights.from_jax_state`` or a model's own init)."""
    if getattr(attr, "initializer", None) is not None:
        raise NotImplementedError(
            f"{layer}: {what} with an initializer is not ported yet "
            "(ROADMAP Queue 1 item 10(e))")


class Embedding(nn.Module):
    """Token embedding, weight ``[num_embeddings, embedding_dim]``, in
    JAX's parameter order. ``padding_idx``: that row starts at zero and
    those ids give zeros (no gradient reaches the row from them), as in
    JAX. ``sparse=True`` is not ported yet."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *,
                 dtype=torch.float32, device=None, trainable=False):
        super().__init__()
        if sparse:
            raise NotImplementedError(
                "Embedding: sparse=True is not ported yet (ROADMAP Queue 1 "
                "item 10(e))")
        _no_initializer("Embedding", "weight_attr", weight_attr)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = _param((num_embeddings, embedding_dim), dtype, device,
                             trainable)
        if padding_idx is not None and self.weight.device.type != "meta":
            with torch.no_grad():
                self.weight[padding_idx] = 0

    def forward(self, x):
        out = F.embedding(x, self.weight)
        if self.padding_idx is None:
            return out
        return out.masked_fill((x == self.padding_idx)[..., None], 0)


class Linear(nn.Module):
    """``y = x @ W + b`` with ``W: [in_features, out_features]``, in JAX's
    parameter order; ``bias_attr=False`` drops the bias, as in Paddle."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, dtype=torch.float32,
                 device=None, trainable=False):
        super().__init__()
        _no_initializer("Linear", "weight_attr", weight_attr)
        _no_initializer("Linear", "bias_attr", bias_attr)
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
    (JAX's arguments; ``name`` is taken and, as there, unused), applied
    as ``self.training`` says; its masks are drawn from ``generator`` (a
    CPU ``torch.Generator``, the port's own, keyword-only)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return pf.dropout(x, self.p, axis=self.axis, training=self.training,
                          mode=self.mode, generator=self.generator)
