"""``scaled_dot_product_attention``. Counterpart of
``paddle_tpu/nn/functional/attention.py``.

Layout [batch, seq, num_heads, head_dim]. Without a mask, attention goes
through ``ops.flash_attention.flash_attention`` — the forward and
backward kernels on the card (attention dropout in them, keyed by a seed
from the caller's generator), their plain versions on the CPU — as the
JAX package routes to its Pallas kernel on the TPU. With a mask it takes
the composite ``_sdpa_ref``, as the JAX package does everywhere.
"""
from __future__ import annotations

import torch

from ...ops import flash_attention as fa
from .common import draw_seed, keep_mask

__all__ = ["scaled_dot_product_attention"]


def _sdpa_ref(q, k, v, mask, dropout_p, causal, generator=None):
    """Composite attention on [B, S, H, D]: fp32 softmax, probabilities
    rounded to q's dtype, then dropout (upscaled) when dropout_p > 0."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    logits = (torch.einsum("bhqd,bhkd->bhqk", qt, kt)
              * q.shape[-1] ** -0.5).float()
    ql, kl = logits.shape[-2], logits.shape[-1]
    neg = torch.tensor(float("-inf"), device=q.device)
    if causal:
        cm = torch.ones((ql, kl), dtype=torch.bool,
                        device=q.device).tril(kl - ql)
        logits = torch.where(cm, logits, neg)
    if mask is not None:
        logits = (torch.where(mask, logits, neg) if mask.dtype == torch.bool
                  else logits + mask.float())
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        keep = keep_mask(probs.shape, dropout_p, generator, q.device)
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=q.device))
    return torch.einsum("bhqk,bhkd->bhqd", probs, vt).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, *,
                                 generator=None):
    """Attention on [B, S, H, D], in the JAX package's parameter order;
    ``dropout_p`` drops attention probabilities while ``training`` (with
    ``training=False`` it is 0), with a mask drawn from ``generator`` (a
    CPU ``torch.Generator``; None: PyTorch's default)."""
    dropout_p = float(dropout_p) if training else 0.0
    if attn_mask is None and query.shape[2] % key.shape[2] == 0 \
            and fa.is_supported(tuple(query.shape), query.dtype):
        seed = draw_seed(generator) if dropout_p > 0.0 else 0
        return fa.flash_attention(query, key, value, causal=is_causal,
                                  dropout_p=dropout_p, dropout_seed=seed)
    return _sdpa_ref(query, key, value, attn_mask, dropout_p, is_causal,
                     generator)
