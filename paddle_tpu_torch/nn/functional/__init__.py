"""Functional forms of the layers the port's models use, in Paddle's
semantics. Counterpart of ``paddle_tpu/nn/functional/``: every
activation, ``cross_entropy``, the attention functionals, ``linear``,
``fused_concat_linear``, ``dropout`` and the norms (ROADMAP Queue 1
item 10(e) lists the rest)."""
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .attention import (flash_attention, flash_attn_unpadded,
                        scaled_dot_product_attention, sdp_kernel)
from .common import draw_seed, dropout, fused_concat_linear, linear
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = sorted([*_activation, "cross_entropy", "draw_seed", "dropout",
                  "flash_attention", "flash_attn_unpadded",
                  "fused_concat_linear", "layer_norm", "linear", "rms_norm",
                  "scaled_dot_product_attention", "sdp_kernel"])
