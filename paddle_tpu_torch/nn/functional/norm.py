"""``layer_norm`` and ``rms_norm``. Counterpart of
``paddle_tpu/nn/functional/norm.py``.

A last-dim norm whose weight (and, for ``layer_norm``, bias) is in x's
dtype goes through ``ops.layer_norm.layer_norm`` or ``.rms_norm``: the
LayerNorm or RMSNorm kernels on the card, their plain versions on the
CPU. The TPU makes its kernels opt-in (``PADDLE_TPU_PALLAS_LN``) only
because a ``pallas_call`` breaks XLA's fusion of the composite; eager
PyTorch has no such fusion to lose, so here the kernels are the default.
Any other call takes the composite.
"""
from __future__ import annotations

import torch

from ...ops import layer_norm as ln

__all__ = ["layer_norm", "rms_norm"]


def _kernel_ok(x, normalized_shape, weight, bias) -> bool:
    """The kernel's gate: last-dim norm, affine parameters in x's dtype."""
    return (len(normalized_shape) == 1 and weight is not None
            and bias is not None and weight.dtype == x.dtype
            and bias.dtype == x.dtype
            and tuple(normalized_shape) == (x.shape[-1],)
            and ln.is_supported(tuple(x.shape), x.dtype))


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    normalized_shape = tuple(normalized_shape)
    if _kernel_ok(x, normalized_shape, weight, bias):
        return ln.layer_norm(x, weight, bias, epsilon)
    axes = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    a = x.float()
    mean = a.mean(axes, keepdim=True)
    var = a.var(axes, unbiased=False, keepdim=True)
    out = ((a - mean) * torch.reciprocal(torch.sqrt(var + epsilon))).to(
        x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the last dim (LLaMA's), statistics in fp32. A weight
    [D] in x's dtype takes the kernel (x * rstd * weight in fp32, rounded
    once); otherwise the JAX package's composite, which rounds x * rstd to
    x's dtype before multiplying by the weight (promoting to its dtype)."""
    if weight is not None and weight.dtype == x.dtype \
            and tuple(weight.shape) == (x.shape[-1],) and x.numel() > 0 \
            and ln.is_supported(tuple(x.shape), x.dtype):
        return ln.rms_norm(x, weight, epsilon)
    a = x.float()
    out = (a * torch.reciprocal(torch.sqrt(
        (a * a).mean(-1, keepdim=True) + epsilon))).to(x.dtype)
    return out if weight is None else out * weight
