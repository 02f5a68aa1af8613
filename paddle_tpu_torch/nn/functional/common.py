"""``linear``, ``fused_concat_linear`` and ``dropout`` in Paddle's
semantics. Counterpart of ``paddle_tpu/nn/functional/common.py``; the
first two are where O1's casts happen, as there
(``amp.auto_cast.cast_if_amp``).

Every random draw takes an explicit ``torch.Generator`` (None: PyTorch's
default CPU generator). A draw is one 63-bit seed taken from that
generator on the host (``draw_seed``), so no draw waits for the card;
a dropout mask is then drawn on the tensor's device from a generator
seeded with it, and attention dropout hands the seed to its kernels.
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_if_amp

__all__ = ["draw_seed", "dropout", "fused_concat_linear", "keep_mask",
           "linear"]


def draw_seed(generator=None) -> int:
    """One seed in [0, 2**63 - 1) from ``generator`` (a CPU generator)."""
    return int(torch.randint(0, 2 ** 63 - 1, (), generator=generator))


def keep_mask(shape, p, generator, device):
    """A bool mask of ``shape`` on ``device``, each entry kept (True) with
    probability 1 - p, drawn from one seed of ``generator``."""
    g = torch.Generator(device=device)
    g.manual_seed(draw_seed(generator))
    return torch.rand(shape, generator=g, device=device) >= p


def linear(x, weight, bias=None, name=None):
    """``y = x @ W + b`` with W ``[in, out]`` (Paddle's layout). Inside
    ``amp.auto_cast`` x and W are cast to the amp dtype first (O1), and
    the bias is added in the product's dtype."""
    x, weight = cast_if_amp("linear", x, weight)
    y = x @ weight
    return y if bias is None else y + bias.to(y.dtype)


def fused_concat_linear(x, weights, biases=None):
    """One matmul over ``weights`` ([in, out_i] each) concatenated on dim
    1: the outputs side by side, ``[..., sum(out_i)]``. The parameters
    stay separate and autograd splits their gradients through the
    concatenation (LLaMA's fused q/k/v and gate/up). ``biases`` is None,
    or one per weight; a list mixing None and tensors raises ValueError
    (pass zeros for the bias-less ones), as in the JAX package. Under
    ``amp.auto_cast`` it casts as ``linear`` does."""
    if biases is not None:
        n_none = sum(b is None for b in biases)
        if n_none == len(biases):
            biases = None
        elif n_none:
            raise ValueError(
                "fused_concat_linear: biases must be all None or all set, "
                f"got {n_none}/{len(biases)} None. Pass explicit zero "
                "biases for the bias-less projections.")
    return linear(x, torch.cat(list(weights), 1),
                  None if biases is None else torch.cat(list(biases)))


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """Paddle's dropout, in the JAX package's parameter order. In
    training, each element (or, with ``axis``, each slice along those
    dims: the mask is broadcast over the others) is zeroed with
    probability p; ``upscale_in_train`` scales the kept ones by
    1 / (1 - p), any other mode keeps them as they are. In inference
    ``downscale_in_infer`` scales by 1 - p and ``upscale_in_train`` is
    the identity."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if axis is None:
        mask_shape = x.shape
    else:
        axes = [a % x.dim() for a in ((axis,) if isinstance(axis, int)
                                      else tuple(axis))]
        mask_shape = tuple(s if i in axes else 1
                           for i, s in enumerate(x.shape))
    keep = keep_mask(mask_shape, p, generator, x.device)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept,
                       torch.zeros((), dtype=x.dtype, device=x.device))
