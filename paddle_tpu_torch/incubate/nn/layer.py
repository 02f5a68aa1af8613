"""FusedMultiTransformer: the weights of the fused decoder stack.

Counterpart of ``paddle_tpu/incubate/nn/layer.py::FusedMultiTransformer``
with the same per-layer parameter lists, names and shapes, so that
``state_dict()`` keys match the JAX layer's ``named_parameters`` one for
one (``qkv_weights.0``, ``ffn1_biases.3``, ...):

  ln_scales / ln_biases          [E]
  qkv_weights                    [3, nh, hd, E]
  qkv_biases                     [3, nh, hd]
  linear_weights                 [E, E]      (Paddle layout [in, out])
  linear_biases                  [E]
  ffn_ln_scales / ffn_ln_biases  [E]
  ffn1_weights / ffn1_biases     [E, FF] / [FF]
  ffn2_weights / ffn2_biases     [FF, E] / [E]

The parameters are allocated uninitialised (nothing at all on
``device="meta"``); their values arrive through
``paddle_tpu_torch.weights.from_jax_state``. The serving path reads
these lists through ``inference.generation.FusedDecoder``, which stacks
them per layer; the module itself has no forward of its own in this
port.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["FusedMultiTransformer"]


class FusedMultiTransformer(nn.Module):
    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 activation="gelu", normalize_before=True, epsilon=1e-5,
                 num_layers=1, dtype=torch.float32, device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by "
                             f"num_heads {num_heads}")
        self.num_layers = int(num_layers)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dim_feedforward = dim_feedforward
        self.normalize_before = normalize_before
        self.activation = activation
        self.epsilon = epsilon

        def plist(*shape):   # uninitialised: values come from the bridge
            return nn.ParameterList([
                nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                             requires_grad=False)
                for _ in range(self.num_layers)])

        e, hd = embed_dim, self.head_dim
        self.ln_scales = plist(e)
        self.ln_biases = plist(e)
        self.qkv_weights = plist(3, num_heads, hd, e)
        self.qkv_biases = plist(3, num_heads, hd)
        self.linear_weights = plist(e, e)
        self.linear_biases = plist(e)
        self.ffn_ln_scales = plist(e)
        self.ffn_ln_biases = plist(e)
        self.ffn1_weights = plist(e, dim_feedforward)
        self.ffn1_biases = plist(dim_feedforward)
        self.ffn2_weights = plist(dim_feedforward, e)
        self.ffn2_biases = plist(e)
