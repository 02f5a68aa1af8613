"""Embedding, Linear and Dropout in Paddle's layout and semantics.

Counterparts of ``paddle_tpu/nn/layer/common.py``: ``Linear`` keeps its
weight as ``[in, out]`` and computes ``y = x @ W + b`` (not
``nn.Linear``'s ``[out, in]``), so weights cross from the JAX package
without a transpose.

A parameter is drawn from its ``ParamAttr``'s initializer, or, when the
caller passes a ``generator`` (keyword-only, a CPU ``torch.Generator``),
from JAX's default (``XavierNormal`` weights and zero biases for
``Linear``, ``Normal(0, 1)`` for ``Embedding``), on the CPU from that
generator. Otherwise it is allocated uninitialised (nothing at all on
``device="meta"``): serving fills it through
``paddle_tpu_torch.weights.from_jax_state`` and keeps it frozen, while a
training model asks for ``trainable=True`` and initialises it itself. A
``ParamAttr``'s ``learning_rate``, ``regularizer`` and ``need_clip`` go
onto the ``nn.Parameter`` (``optimize_attr``, ``regularizer``,
``need_clip``: what the optimizers and clips read), and its
``trainable=False`` freezes it.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ..functional import common as pf
from ..initializer import Constant, Normal, XavierNormal
from ..utils_ import ParamAttr

__all__ = ["Dropout", "Embedding", "Linear"]


def make_param(shape, attr, default_init, dtype, device, trainable=False,
               generator=None):
    """The parameter ``attr`` (a ``ParamAttr``, None or True) describes:
    drawn from its initializer, or from ``default_init`` when a
    ``generator`` is given, else uninitialised (nothing on meta)."""
    init = getattr(attr, "initializer", None)
    meta = torch.device(device).type == "meta" if device else False
    if meta or (init is None and generator is None):
        data = torch.empty(shape, dtype=dtype, device=device)
    else:
        data = (init or default_init)(shape, dtype, generator=generator,
                                      device=device)
    p = nn.Parameter(data, requires_grad=trainable and getattr(
        attr, "trainable", True))
    if isinstance(attr, ParamAttr):
        p.regularizer = attr.regularizer
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.need_clip = attr.need_clip
        if attr.name:
            p.name = attr.name
    return p


class Embedding(nn.Module):
    """Token embedding, weight ``[num_embeddings, embedding_dim]``, in
    JAX's parameter order. ``padding_idx``: that row starts at zero and
    those ids give zeros (no gradient reaches the row from them), as in
    JAX. ``sparse=True`` is not ported yet."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *,
                 dtype=torch.float32, device=None, trainable=False,
                 generator=None):
        super().__init__()
        if sparse:
            raise NotImplementedError(
                "Embedding: sparse=True is not ported yet (ROADMAP Queue 1 "
                "item 10(e))")
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = make_param((num_embeddings, embedding_dim),
                                 weight_attr, Normal(0.0, 1.0), dtype, device,
                                 trainable, generator)
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
                 device=None, trainable=False, generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = make_param((in_features, out_features), weight_attr,
                                 XavierNormal(), dtype, device, trainable,
                                 generator)
        self.bias = (None if bias_attr is False
                     else make_param((out_features,), bias_attr,
                                     Constant(0.0), dtype, device, trainable,
                                     generator))

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
