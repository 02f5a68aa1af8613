"""Functional forms of the layers GPT-2 training uses, in Paddle's
semantics. Counterpart of ``paddle_tpu/nn/functional/``; only what
``models/gpt.py`` reaches is ported (ROADMAP Queue 1 item 10)."""
from .activation import gelu, relu
from .attention import scaled_dot_product_attention
from .common import draw_seed, dropout, linear
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ["cross_entropy", "draw_seed", "dropout", "gelu", "layer_norm",
           "linear", "relu", "scaled_dot_product_attention"]
