"""Fused functionals. Counterpart of ``paddle_tpu/incubate/nn/
functional.py``: ``fused_feedforward``, ``fused_rotary_position_embedding``
and ``fused_multi_transformer`` with its KV-cache attention
(``_decode_attn``), each computing what the JAX function computes, its
quirks included (see each docstring).

``fused_feedforward`` takes the fused FFN kernels (``ops.fused_ffn``)
under the JAX function's gate; ``_decode_attn`` takes the one-layer
flash-decode kernel (``ops.decode_attention.decode_attention_bhsd``).
Everything else is torch ops and the ``nn.functional`` forms (LayerNorm
and attention through their kernels). The JAX module's other functionals
(``fused_matmul_bias`` / ``fused_linear``, ``fused_linear_activation``,
``fused_multi_head_attention``, ``fused_bias_dropout_residual_layer_norm``,
``softmax_mask_fuse``, ``softmax_mask_fuse_upper_triangle``,
``fused_dropout_add``) are not ported yet: ROADMAP Queue 1 item 10(e).
"""
from __future__ import annotations

import os

import torch

from ...nn import functional as F
from ...ops import decode_attention as da
from ...ops.fused_ffn import fused_ffn

__all__ = ["fused_feedforward", "fused_rotary_position_embedding",
           "fused_multi_transformer"]


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode="upscale_in_train", name=None, *, generator=None):
    """LN -> linear -> act -> dropout -> linear -> dropout -> residual
    (-> LN). Under ``PADDLE_TPU_FUSED_FFN=1``, with the exact gelu, inert
    dropouts (both rates 0, or inference under ``upscale_in_train``) and
    both biases, the middle linear -> gelu -> linear is ``fused_ffn``
    (the JAX gate; its ``no_mp_mesh()`` always holds here, since the port
    has no model-parallel mesh). Dropout masks come from ``generator``."""
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, x.shape[-1:], ln1_scale, ln1_bias, ln1_epsilon)
    # inert: the composite's dropouts are the identity (downscale_in_infer
    # scales in inference, so it is not)
    drop_inert = (dropout1_rate == 0.0 and dropout2_rate == 0.0) or (
        not training and mode == "upscale_in_train")
    if (os.environ.get("PADDLE_TPU_FUSED_FFN") == "1"
            and activation == "gelu" and drop_inert
            and linear1_bias is not None and linear2_bias is not None):
        out = fused_ffn(x, linear1_weight, linear1_bias, linear2_weight,
                        linear2_bias, "gelu")
    else:
        out = F.linear(x, linear1_weight, linear1_bias)
        out = getattr(F, activation)(out)
        out = F.dropout(out, dropout1_rate, training=training, mode=mode,
                        generator=generator)
        out = F.linear(out, linear2_weight, linear2_bias)
        out = F.dropout(out, dropout2_rate, training=training, mode=mode,
                        generator=generator)
    out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, out.shape[-1:], ln2_scale, ln2_bias,
                           ln2_epsilon)
    return out


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False,
                                    rotary_emb_base=10000.0,
                                    position_offset=0):
    """Rotary position embedding of q, k and v ([batch, seq, heads,
    head_dim]; None passes through), positions shifted by
    ``position_offset``. Without ``sin`` / ``cos`` the angles are computed
    in fp32 from ``rotary_emb_base``. As in the JAX function,
    ``position_ids`` and ``time_major`` are not read, and the non-neox
    style returns fp32 for a low-precision input (its fp32 sin and cos
    promote it)."""
    def rope(x):
        _, seq, _, hd = x.shape
        if sin is None:
            inv = 1.0 / (rotary_emb_base ** (torch.arange(
                0, hd, 2, dtype=torch.float32, device=x.device) / hd))
            t = torch.arange(seq, dtype=torch.float32,
                             device=x.device) + position_offset
            freqs = torch.outer(t, inv)
            s, c = torch.sin(freqs), torch.cos(freqs)
        else:
            s = torch.as_tensor(sin, device=x.device).reshape(seq, hd // 2)
            c = torch.as_tensor(cos, device=x.device).reshape(seq, hd // 2)
        s, c = s[None, :, None, :], c[None, :, None, :]
        if use_neox_rotary_style:
            x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
            ss, cc = torch.cat([s, s], -1), torch.cat([c, c], -1)
            rot = torch.cat([-x2, x1], -1)
            return x * cc.to(x.dtype) + rot * ss.to(x.dtype)
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                           -1).reshape(x.shape)
    return tuple(None if t is None else rope(t) for t in (q, k, v))


def _decode_attn(q, cache, ts, s, attn_mask):
    """Attention of the chunk's queries q [B, s, H, D] over one layer's
    cache [2, B, H, Smax, D], whose positions [ts, ts + s) the chunk has
    just written. Without a mask and within ``da.is_supported``: the
    flash-decode kernel (``decode_attention_bhsd``, every row at lens ts;
    its plain version on CPU tensors), no autograd. Otherwise the JAX
    function's composite: attention over the valid prefix, a new token r
    seeing the prefix and the chunk's tokens up to r."""
    kc = cache[0]
    if attn_mask is None and da.is_supported(
            tuple(q.shape), (kc.shape[0], kc.shape[2], kc.shape[1],
                             kc.shape[3]), q.dtype):
        lens = torch.full((q.shape[0],), ts, dtype=torch.int32,
                          device=q.device)
        out = da.decode_attention_bhsd(
            q.detach().transpose(1, 2).contiguous(), cache[0].detach(),
            cache[1].detach(), lens)
        return out.transpose(1, 2)
    k_full = cache[0, :, :, :ts + s].transpose(1, 2)
    v_full = cache[1, :, :, :ts + s].transpose(1, 2)
    if attn_mask is None and s > 1:
        rows = torch.arange(s, device=q.device)[:, None]
        cols = torch.arange(ts + s, device=q.device)[None, :]
        attn_mask = (cols <= ts + rows)[None, None]
    return F.scaled_dot_product_attention(q, k_full, v_full,
                                          attn_mask=attn_mask)


def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights, qkv_biases,
                            linear_weights, linear_biases, ffn_ln_scales,
                            ffn_ln_biases, ffn1_weights, ffn1_biases,
                            ffn2_weights, ffn2_biases, pre_layer_norm=True,
                            epsilon=1e-5, cache_kvs=None, pre_caches=None,
                            seq_lens=None, rotary_embs=None, time_step=None,
                            attn_mask=None, dropout_rate=0.0,
                            activation="gelu", training=False,
                            mode="upscale_in_train", trans_qkvw=True,
                            ring_id=-1, name=None):
    """The decoder stack with its KV cache; returns ``(out, caches)``.
    x [B, S, E]; per layer the weights of ``FusedMultiTransformer``
    (qkv [3, nh, hd, E]); each cache [2, B, nh, Smax, hd].

    As the JAX function: with ``cache_kvs`` and ``time_step`` every chunk
    (a prefill at time_step 0 too) is written into the caches at
    [time_step, time_step + S), in place, and attends through
    ``_decode_attn``; with ``cache_kvs`` and no ``time_step`` the chunk
    attends causally to itself and the caches come back unchanged;
    without ``cache_kvs`` the second value is None. With ``rotary_embs``
    q and k are rotated at ``position_offset = time_step or 0`` with the
    function's own sin and cos, whatever ``rotary_embs`` holds.
    ``pre_caches``, ``seq_lens``, ``dropout_rate`` and ``training`` are
    not read."""
    out = x
    new_caches = []
    for i in range(len(qkv_weights)):
        residual = out
        h = (F.layer_norm(out, out.shape[-1:], ln_scales[i], ln_biases[i],
                          epsilon) if pre_layer_norm else out)
        _, nh, hd, emb = qkv_weights[i].shape
        qkv = h @ qkv_weights[i].reshape(3 * nh * hd, emb).t()
        if qkv_biases[i] is not None:
            qkv = qkv + qkv_biases[i].reshape(-1)
        b, s = qkv.shape[0], qkv.shape[1]
        qkv = qkv.reshape(b, s, 3, nh, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        cache = cache_kvs[i] if cache_kvs is not None else None
        ts = None
        if cache is not None and time_step is not None:
            ts = int(time_step.item()) if isinstance(
                time_step, torch.Tensor) else int(time_step)
        if rotary_embs is not None:
            # a decode step's new token sits at absolute position ts
            q, k, _ = fused_rotary_position_embedding(
                q, k, position_offset=ts or 0)
        if ts is not None:
            cache[0, :, :, ts:ts + s] = k.transpose(1, 2)
            cache[1, :, :, ts:ts + s] = v.transpose(1, 2)
            attn = _decode_attn(q, cache, ts, s, attn_mask)
            new_caches.append(cache)
        else:
            attn = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, is_causal=attn_mask is None)
            if cache_kvs is not None:
                new_caches.append(cache)
        attn = F.linear(attn.reshape(b, s, nh * hd), linear_weights[i],
                        linear_biases[i])
        out = residual + attn
        if not pre_layer_norm:
            out = F.layer_norm(out, out.shape[-1:], ln_scales[i],
                               ln_biases[i], epsilon)
        residual = out
        h = (F.layer_norm(out, out.shape[-1:], ffn_ln_scales[i],
                          ffn_ln_biases[i], epsilon) if pre_layer_norm
             else out)
        h = F.linear(h, ffn1_weights[i], ffn1_biases[i])
        h = getattr(F, activation)(h)
        h = F.linear(h, ffn2_weights[i], ffn2_biases[i])
        out = residual + h
        if not pre_layer_norm:
            out = F.layer_norm(out, out.shape[-1:], ffn_ln_scales[i],
                               ffn_ln_biases[i], epsilon)
    return out, (new_caches if cache_kvs is not None else None)
