"""Functional forms of the layers GPT-2 and LLaMA training use, in
Paddle's semantics. Counterpart of ``paddle_tpu/nn/functional/``; only
what ``models/gpt.py``, ``models/llama.py`` and the fused layers reach is
ported (ROADMAP Queue 1 item 10)."""
from .activation import gelu, relu, silu, swish
from .attention import scaled_dot_product_attention
from .common import draw_seed, dropout, fused_concat_linear, linear
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["cross_entropy", "draw_seed", "dropout", "fused_concat_linear",
           "gelu", "layer_norm", "linear", "relu", "rms_norm",
           "scaled_dot_product_attention", "silu", "swish"]
