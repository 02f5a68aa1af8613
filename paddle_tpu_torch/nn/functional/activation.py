"""Activations. Counterpart of ``paddle_tpu/nn/functional/activation.py``:
every name it exports, with its parameters and its formulas (where JAX
writes its own, e.g. ``selu``, ``hardsigmoid``, ``softplus``, the same
expression here). The two that draw (``rrelu`` in training,
``gumbel_softmax``) take the port's ``generator`` keyword-only, a CPU
``torch.Generator`` (None: PyTorch's default), and draw on the CPU."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["relu", "relu_", "relu6", "elu", "selu", "celu", "gelu", "silu",
           "swish", "sigmoid", "hardsigmoid", "hardswish", "hardtanh",
           "hardshrink", "softshrink", "tanhshrink", "leaky_relu", "prelu",
           "rrelu", "log_sigmoid", "log_softmax", "softmax", "softmax_",
           "softplus", "softsign", "mish", "maxout", "tanh", "tanh_",
           "thresholded_relu", "glu", "gumbel_softmax"]


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def relu(x, name=None):
    """max(x, 0)."""
    return F.relu(x)


def relu_(x, name=None):
    return x.relu_()


def relu6(x, name=None):
    return F.relu6(x)


def elu(x, alpha=1.0, name=None):
    return F.elu(x, alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return F.celu(x, alpha)


def gelu(x, approximate=False, name=None):
    """GELU; ``approximate=True`` is the tanh form
    0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))), as ``jax.nn.gelu``
    computes it."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x, name=None):
    """x * sigmoid(x)."""
    return F.silu(x)


def swish(x, name=None):
    """``silu``, as in the JAX package."""
    return silu(x)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, _zero(x))


def softshrink(x, threshold=0.5, name=None):
    return torch.where(x > threshold, x - threshold, torch.where(
        x < -threshold, x + threshold, _zero(x)))


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return F.leaky_relu(x, negative_slope)


def prelu(x, weight, data_format="NCHW", name=None):
    """where(x > 0, x, w x): one slope, or one per channel (axis 1 for
    an NC* layout, else the last)."""
    if weight.numel() == 1:
        return torch.where(x > 0, x, weight.reshape(()) * x)
    shape = [1] * x.dim()
    shape[1 if data_format.startswith("NC") else x.dim() - 1] = \
        weight.numel()
    return torch.where(x > 0, x, weight.reshape(shape) * x)


def rrelu(x, lower=0.125, upper=0.333, training=False, name=None, *,
          generator=None):
    """A leaky ReLU whose slope is drawn uniform in [lower, upper] per
    element in training, (lower + upper) / 2 otherwise."""
    if training:
        slope = torch.empty(x.shape).uniform_(
            lower, upper, generator=generator).to(x.device, x.dtype)
    else:
        slope = (lower + upper) / 2.0
    return torch.where(x >= 0, x, slope * x)


def log_sigmoid(x, name=None):
    return F.logsigmoid(x)


def log_softmax(x, axis=-1, dtype=None, name=None):
    """``dtype`` is taken and, as in JAX, unused."""
    return torch.log_softmax(x, axis)


def softmax(x, axis=-1, dtype=None, name=None):
    """``dtype`` is taken and, as in JAX, unused."""
    return torch.softmax(x, axis)


def softmax_(x, axis=-1, dtype=None, name=None):
    return x.copy_(torch.softmax(x, axis))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return torch.where(x * beta > threshold, x,
                       torch.log1p(torch.exp(beta * x)) / beta)


def softsign(x, name=None):
    return x / (1 + x.abs())


def mish(x, name=None):
    return x * torch.tanh(torch.logaddexp(x, _zero(x)))


def maxout(x, groups, axis=1, name=None):
    """The max over each run of ``groups`` channels along ``axis``."""
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(ax + 1)


def tanh(x, name=None):
    return torch.tanh(x)


def tanh_(x, name=None):
    return x.tanh_()


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x,
                       torch.full((), value, dtype=x.dtype, device=x.device))


def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, axis)
    return a * torch.sigmoid(b)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None, *,
                   generator=None):
    """softmax((x + g) / temperature) with g standard Gumbel noise; with
    ``hard`` the one-hot of its argmax in the forward and the soft
    values' gradient (straight through)."""
    u = torch.empty(x.shape).uniform_(generator=generator)
    g = (-torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny))))
    y = torch.softmax((x + g.to(x.device, x.dtype)) / temperature, axis)
    if not hard:
        return y
    onehot = torch.zeros_like(y).scatter_(axis, y.argmax(axis, True), 1.0)
    return onehot + y - y.detach()
