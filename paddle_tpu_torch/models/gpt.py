"""GPT-2 family for training. Counterpart of ``paddle_tpu/models/gpt.py``.

The same modules, parameter names and shapes as the JAX model (learned
positions, pre-LN blocks, ``[in, out]`` projections, the LM head tied to
``wte``), so ``weights.gpt_from_jax_state`` moves a JAX state across by
name. Attention goes through ``nn.functional.scaled_dot_product_attention``
(the flash attention kernels, forward and backward, dropout in them) and
every LayerNorm through the LayerNorm kernels; the projections are
``torch.matmul`` on cuBLAS, as the JAX package leaves them to XLA, except
that under ``PADDLE_TPU_FUSED_FFN=1`` the MLP is ``ops.fused_ffn`` (the
fused FFN kernels; ``PADDLE_TPU_FUSED_FFN_BWD=1`` also takes its backward
kernels), as in the JAX model.

Every random draw of a model comes from its ``generator``, a CPU
``torch.Generator`` seeded from ``seed``: the initial weights (drawn on the
CPU, so a seed gives the same model on every device) and, in training, one
seed per dropout mask and per attention call.
"""
from __future__ import annotations

import math
import os

import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer.norm import LayerNorm
from ..ops.fused_ffn import fused_ffn

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "gpt2_124m", "gpt2_tiny"]


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None, max_position=1024,
                 dropout=0.1, layer_norm_eps=1e-5, initializer_range=0.02):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position = max_position
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps
        self.initializer_range = initializer_range


def _linear(n_in, n_out, device, dtype):
    return Linear(n_in, n_out, dtype=dtype, device=device, trainable=True)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        c = config
        self.num_heads = c.num_heads
        self.head_dim = c.hidden_size // c.num_heads
        self.qkv_proj = _linear(c.hidden_size, 3 * c.hidden_size, device,
                                dtype)
        self.out_proj = _linear(c.hidden_size, c.hidden_size, device, dtype)
        self.dropout = c.dropout
        self.generator = generator

    def forward(self, x, kv_cache=None):
        if kv_cache is not None:
            raise NotImplementedError(
                "GPTAttention.forward: kv_cache is not ported yet (ROADMAP "
                "Queue 1 item 10(e))")
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        out = F.scaled_dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], is_causal=True,
            dropout_p=self.dropout if self.training else 0.0,
            generator=self.generator)
        return self.out_proj(out.reshape(b, s, self.num_heads
                                         * self.head_dim))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        c = config
        self.fc1 = _linear(c.hidden_size, c.intermediate_size, device, dtype)
        self.fc2 = _linear(c.intermediate_size, c.hidden_size, device, dtype)

    def forward(self, x):
        if os.environ.get("PADDLE_TPU_FUSED_FFN") == "1" \
                and type(self.fc1) is Linear and type(self.fc2) is Linear:
            # the fused FFN kernels (ops.fused_ffn): the [M, F] gelu
            # intermediate is never stored. The JAX branch also asks
            # no_mp_mesh(); the port has no model-parallel mesh, so that
            # always holds here.
            return fused_ffn(x, self.fc1.weight, self.fc1.bias,
                             self.fc2.weight, self.fc2.bias)
        return self.fc2(F.gelu(self.fc1(x), approximate=True))


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        e, eps = config.hidden_size, config.layer_norm_eps
        self.ln1 = LayerNorm(e, eps, dtype=dtype, device=device)
        self.attn = GPTAttention(config, generator=generator,
                                 device=device, dtype=dtype)
        self.ln2 = LayerNorm(e, eps, dtype=dtype, device=device)
        self.mlp = GPTMLP(config, device=device, dtype=dtype)
        self.drop = Dropout(config.dropout, generator=generator)

    def forward(self, x):
        x = x + self.drop(self.attn(self.ln1(x)))
        return x + self.drop(self.mlp(self.ln2(x)))


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        c = config
        self.config = c
        self.wte = Embedding(c.vocab_size, c.hidden_size, dtype=dtype,
                             device=device, trainable=True)
        self.wpe = Embedding(c.max_position, c.hidden_size, dtype=dtype,
                             device=device, trainable=True)
        self.drop = Dropout(c.dropout, generator=generator)
        self.h = nn.ModuleList([GPTBlock(c, generator=generator,
                                         device=device, dtype=dtype)
                                for _ in range(c.num_layers)])
        self.ln_f = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype=dtype,
                              device=device)

    def forward(self, input_ids, position_ids=None):
        if position_ids is not None:
            raise NotImplementedError(
                "GPTModel.forward: position_ids is not ported yet (ROADMAP "
                "Queue 1 item 10(e))")
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for blk in self.h:
            x = blk(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """GPT with the LM head tied to ``wte``: the logits are ``h @
    wte.weight.T``, so the embedding's gradient collects both uses. With
    ``labels`` the forward returns the mean cross entropy instead.

    ``device`` None means the card (``resolve_device``); ``"meta"`` builds
    the modules without storage or initial values (for a state loaded
    afterwards, ``weights.gpt_from_jax_state``)."""

    def __init__(self, config: GPTConfig, *, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.generator = torch.Generator()
        self.generator.manual_seed(seed)
        self.gpt = GPTModel(config, generator=self.generator, device=dev,
                            dtype=dtype)
        if dev.type != "meta":
            self.init_weights()

    @torch.no_grad()
    def init_weights(self):
        """The JAX model's initialisers, drawn from ``self.generator`` on
        the CPU: embeddings and projections normal(0, 0.02), out_proj and
        fc2 normal(0, 0.02 / sqrt(2 L)), biases 0 (LayerNorm starts at
        weight 1, bias 0 when built)."""
        c = self.config
        scaled = c.initializer_range / math.sqrt(2 * c.num_layers)
        for name, module in self.named_modules():
            if isinstance(module, Linear):
                module.bias.zero_()
                std = (scaled if name.endswith(("out_proj", "fc2"))
                       else c.initializer_range)
            elif isinstance(module, Embedding):
                std = c.initializer_range
            else:
                continue
            module.weight.copy_(torch.empty(module.weight.shape).normal_(
                0.0, std, generator=self.generator))

    def forward(self, input_ids, labels=None):
        h = self.gpt(input_ids)
        logits = F.linear(h, self.gpt.wte.weight.t())
        if labels is None:
            return logits
        return F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels.reshape(-1))


def gpt2_124m(vocab_size=50304, *, device=None, dtype=torch.float32,
              seed=0, **kw):
    """GPT-2 124M: E=768, 12 layers, 12 heads (``kw`` overrides any other
    GPTConfig field, e.g. ``num_layers``, ``dropout``)."""
    kw = {"hidden_size": 768, "num_layers": 12, "num_heads": 12, **kw}
    return GPTForCausalLM(GPTConfig(vocab_size=vocab_size, **kw),
                          device=device, dtype=dtype, seed=seed)


def gpt2_tiny(vocab_size=1024, *, device=None, dtype=torch.float32,
              seed=0, **kw):
    """The JAX package's test model: E=64, 2 layers, 2 heads, 128
    positions."""
    kw = {"hidden_size": 64, "num_layers": 2, "num_heads": 2,
          "max_position": 128, **kw}
    return GPTForCausalLM(GPTConfig(vocab_size=vocab_size, **kw),
                          device=device, dtype=dtype, seed=seed)
