"""Activations. Counterpart of ``paddle_tpu/nn/functional/activation.py``
(``gelu`` and ``relu``: GPT's and ``fused_feedforward``'s default;
``silu`` / ``swish``: LLaMA's SwiGLU)."""
from __future__ import annotations

import torch.nn.functional as F

__all__ = ["gelu", "relu", "silu", "swish"]


def gelu(x, approximate=False, name=None):
    """GELU; ``approximate=True`` is the tanh form
    0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))), as ``jax.nn.gelu``
    computes it."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    """max(x, 0)."""
    return F.relu(x)


def silu(x, name=None):
    """x * sigmoid(x)."""
    return F.silu(x)


def swish(x, name=None):
    """``silu``, as in the JAX package."""
    return silu(x)
