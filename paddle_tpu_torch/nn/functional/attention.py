"""``scaled_dot_product_attention``, ``flash_attention``,
``flash_attn_unpadded`` and ``sdp_kernel``. Counterpart of
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

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "sdp_kernel"]


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


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None, *, generator=None):
    """``scaled_dot_product_attention`` without a mask (the flash kernels)
    on [B, S, H, D], returned as ``(out, None)`` as in the JAX package;
    ``return_softmax``, ``fixed_seed_offset`` and ``rng_name`` are taken
    and, as there, give nothing more."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training,
                                       generator=generator)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None, dropout=0.0,
                        causal=False, return_softmax=False, name=None):
    """Variable-length attention over packed sequences, the JAX
    package's composite: ``query`` [total_q, H, D] and ``key`` /
    ``value`` [total_k, H, D] hold the sequences back to back, bounded by
    ``cu_seqlens_q`` / ``_k`` ([n + 1] offsets); each query attends the
    keys of its own sequence (causal: up to its position there), fp32
    softmax, probabilities rounded to the query's dtype. Returns
    ``(out [total_q, H, D], None)``. ``max_seqlen_*``, ``dropout`` and
    ``return_softmax`` are taken and, as in JAX, unused."""
    cq, ck = (torch.as_tensor(c, device=query.device).long()
              for c in (cu_seqlens_q, cu_seqlens_k))

    def segments(total, cu):
        starts = torch.zeros(total, dtype=torch.long, device=query.device)
        starts.index_add_(0, cu[1:-1], torch.ones_like(cu[1:-1]))
        return starts.cumsum(0)

    seg_q = segments(query.shape[0], cq)
    seg_k = segments(key.shape[0], ck)
    s = scale if scale is not None else query.shape[-1] ** -0.5
    logits = torch.einsum("qhd,khd->hqk", query, key) * s
    same = seg_q[:, None] == seg_k[None, :]
    if causal:
        pos_q = torch.arange(query.shape[0], device=query.device) - cq[seg_q]
        pos_k = torch.arange(key.shape[0], device=query.device) - ck[seg_k]
        same = same & (pos_q[:, None] >= pos_k[None, :])
    neg = torch.tensor(float("-inf"), device=query.device)
    probs = torch.softmax(torch.where(same[None], logits.float(), neg),
                          -1).to(query.dtype)
    probs = torch.where(same[None], probs,
                        torch.zeros((), dtype=probs.dtype,
                                    device=query.device))
    return torch.einsum("hqk,khd->qhd", probs, value), None


class sdp_kernel:
    """The context that picks an attention backend, as in the JAX
    package a no-op: attention takes the flash kernels without a mask and
    the composite with one."""

    def __init__(self, enable_flash=True, enable_math=True,
                 enable_mem_efficient=True):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
