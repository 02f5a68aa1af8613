"""Transformer layers. Counterpart of ``paddle_tpu/nn/layer/transformer.py``
(``MultiHeadAttention`` with its caches, ``TransformerEncoderLayer`` /
``TransformerEncoder``, ``TransformerDecoderLayer`` /
``TransformerDecoder`` and ``Transformer``), with the same modules and
parameter names, so a JAX ``state_dict`` loads by name.

Attention goes through ``nn.functional.scaled_dot_product_attention``:
without a mask the flash attention kernels (forward and backward,
dropout in them), with one the composite, as in the JAX package. Self
attention without a cache computes q, k and v as one matmul over the
three projections' weights side by side (``fused_concat_linear``; the
parameters stay separate). The projections are ``torch.matmul`` on
cuBLAS, as the JAX package leaves them to XLA.

Every layer takes the port's ``dtype``, ``device`` and ``generator``
keyword-only: its parameters are drawn on the CPU from ``generator``
(None: PyTorch's default CPU generator) with JAX's initializers
(``XavierNormal`` weights, zero biases, LayerNorm ones and zeros), and
its dropout masks and attention-dropout seeds come from it too.

As in JAX, ``TransformerEncoder`` / ``Decoder`` build their layers after
the first with ``_clone_layer``, which passes the first layer's widths,
dropouts, activation and ``normalize_before`` but neither its
``weight_attr`` / ``bias_attr`` nor its ``layer_norm_eps``: the clones
take the default epsilon 1e-5.
"""
from __future__ import annotations

import collections

import torch
from torch import nn

from .. import functional as F
from .common import Dropout, Linear
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _gen(generator):
    return torch.default_generator if generator is None else generator


def _linear(n_in, n_out, weight_attr=None, bias_attr=None, *, dtype, device,
            generator):
    return Linear(n_in, n_out, weight_attr, bias_attr, dtype=dtype,
                  device=device, trainable=True, generator=_gen(generator))


class MultiHeadAttention(nn.Module):
    """Multi-head attention on [B, S, E] with q/k/v/out projections
    (``kdim`` / ``vdim`` the key and value widths). ``cache``: a
    ``Cache`` (k and v [B, S_past, H, D], grown by this call's keys and
    values and returned as the last output) or a ``StaticCache`` (k and v
    used as they are, e.g. an encoder's memory); ``gen_cache`` makes
    either. With ``need_weights`` a None stands where the weights would
    be, as in JAX."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        self.generator = _gen(generator)
        kw = {"dtype": dtype, "device": device, "generator": generator}
        self.q_proj = _linear(embed_dim, embed_dim, weight_attr, bias_attr,
                              **kw)
        self.k_proj = _linear(self.kdim, embed_dim, weight_attr, bias_attr,
                              **kw)
        self.v_proj = _linear(self.vdim, embed_dim, weight_attr, bias_attr,
                              **kw)
        self.out_proj = _linear(embed_dim, embed_dim, weight_attr, bias_attr,
                                **kw)

    def _split_heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        """A ``StaticCache`` of ``key``'s (and ``value``'s) projections
        when ``type`` is ``StaticCache``, else an empty ``Cache``."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(
                value if value is not None else key))
            return self.StaticCache(k, v)
        shape = (key.shape[0], 0, self.num_heads, self.head_dim)
        empty = torch.zeros(shape, dtype=key.dtype, device=key.device)
        return self.Cache(empty, empty.clone())

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        self_attn = (key is None or key is query) and (
            value is None or value is key or value is query)
        key = query if key is None else key
        value = key if value is None else value
        if self_attn and cache is None and self.kdim == self.embed_dim \
                and self.vdim == self.embed_dim:
            qkv = F.fused_concat_linear(
                query, [self.q_proj.weight, self.k_proj.weight,
                        self.v_proj.weight],
                [self.q_proj.bias, self.k_proj.bias, self.v_proj.bias])
            qkv = qkv.reshape(qkv.shape[0], qkv.shape[1], 3, self.num_heads,
                              self.head_dim)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q = self._split_heads(self.q_proj(query))
            if isinstance(cache, self.StaticCache):
                k, v = cache.k, cache.v
            else:
                k = self._split_heads(self.k_proj(key))
                v = self._split_heads(self.v_proj(value))
                if isinstance(cache, self.Cache):
                    k = torch.cat([cache.k, k], 1)
                    v = torch.cat([cache.v, v], 1)
                    cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            generator=self.generator)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(None)
        if cache is not None and not isinstance(cache, self.StaticCache):
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


def _convert_attn_mask(attn_mask, dtype):
    """The mask as the attention takes it: a bool mask (True attends)
    or an additive one, both passed as they are, as in JAX."""
    return attn_mask


def _dropouts(dropout, attn_dropout, act_dropout):
    return (dropout if attn_dropout is None else attn_dropout,
            dropout if act_dropout is None else act_dropout)


class TransformerEncoderLayer(nn.Module):
    """Self attention then a two-matmul FFN (``activation`` any name of
    ``nn.functional``), each with dropout and a residual, LayerNorm after
    each (post-LN) or, with ``normalize_before``, before (pre-LN)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        attn_dropout, act_dropout = _dropouts(dropout, attn_dropout,
                                              act_dropout)
        kw = {"dtype": dtype, "device": device, "generator": generator}
        gen = _gen(generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.linear1 = _linear(d_model, dim_feedforward, weight_attr,
                               bias_attr, **kw)
        self.dropout = Dropout(act_dropout, generator=gen)
        self.linear2 = _linear(dim_feedforward, d_model, weight_attr,
                               bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, dtype=dtype,
                               device=device)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, dtype=dtype,
                               device=device)
        self.dropout1 = Dropout(dropout, generator=gen)
        self.dropout2 = Dropout(dropout, generator=gen)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


def _act_name(fn):
    return getattr(fn, "__name__", "relu")


def _clone_layer(layer):
    """A fresh layer like ``layer``, as JAX's ``_clone_layer`` builds it
    (the widths, dropouts, activation and ``normalize_before``; the
    default epsilon and no attrs), on its dtype, device and generator."""
    w = layer.linear1.weight
    args = (layer.self_attn.embed_dim, layer.self_attn.num_heads,
            layer.linear1.out_features, layer.dropout1.p,
            _act_name(layer.activation), layer.self_attn.dropout,
            layer.dropout.p, layer.normalize_before)
    return type(layer)(*args, dtype=w.dtype, device=w.device,
                       generator=layer.self_attn.generator)


class TransformerEncoder(nn.Module):
    """``encoder_layer`` followed by ``num_layers - 1`` clones of it
    (``_clone_layer``), then ``norm`` if given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList([encoder_layer] + [
            _clone_layer(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    """Self attention, cross attention over ``memory``, then the FFN,
    each with dropout, a residual and a LayerNorm (after, or before with
    ``normalize_before``). As in JAX, ``weight_attr`` / ``bias_attr``
    are taken and not passed to the projections."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        attn_dropout, act_dropout = _dropouts(dropout, attn_dropout,
                                              act_dropout)
        kw = {"dtype": dtype, "device": device, "generator": generator}
        gen = _gen(generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **kw)
        self.linear1 = _linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout, generator=gen)
        self.linear2 = _linear(dim_feedforward, d_model, **kw)
        self.norm1, self.norm2, self.norm3 = (
            LayerNorm(d_model, layer_norm_eps, dtype=dtype, device=device)
            for _ in range(3))
        self.dropout1, self.dropout2, self.dropout3 = (
            Dropout(dropout, generator=gen) for _ in range(3))
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache,))

    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory),)


class TransformerDecoder(nn.Module):
    """``decoder_layer`` followed by ``num_layers - 1`` clones of it,
    then ``norm`` if given."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList([decoder_layer] + [
            _clone_layer(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(nn.Module):
    """An encoder and a decoder of the layers above (or the custom ones
    given), each ending in a LayerNorm when ``normalize_before``. As in
    JAX, ``weight_attr`` / ``bias_attr`` are taken and not passed on."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        kw = {"dtype": dtype, "device": device, "generator": generator}
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before)

        def final_norm():
            return (LayerNorm(d_model, dtype=dtype, device=device)
                    if normalize_before else None)
        self.encoder = custom_encoder if custom_encoder is not None else \
            TransformerEncoder(TransformerEncoderLayer(*args, **kw),
                               num_encoder_layers, final_norm())
        self.decoder = custom_decoder if custom_decoder is not None else \
            TransformerDecoder(TransformerDecoderLayer(*args, **kw),
                               num_decoder_layers, final_norm())

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        """[length, length] fp32: 0 on and below the diagonal, -inf
        above, on the model's device."""
        dev = next(self.parameters()).device
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=dev).tril()
        return torch.zeros((length, length), device=dev).masked_fill(
            ~keep, float("-inf"))
