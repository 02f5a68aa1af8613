"""FusedFeedForward and FusedMultiTransformer. Counterparts of
``paddle_tpu/incubate/nn/layer.py``'s layers of the same names, with
their parameter names and shapes.

``FusedFeedForward`` is the transformer FFN block of
``incubate.nn.functional.fused_feedforward``: ``linear1_weight`` [d_model,
dim_feedforward], ``linear2_weight`` [dim_feedforward, d_model], their
biases and the two LayerNorms' ``ln1_scale`` / ``ln1_bias`` /
``ln2_scale`` / ``ln2_bias`` [d_model], trainable, initialised as the
JAX layer does (Xavier-normal weights from ``seed``, drawn on the CPU;
zero biases, unit scales).

``FusedMultiTransformer`` has the same per-layer parameter lists, names
and shapes as the JAX layer, so that
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
them per layer; ``forward`` is ``fused_multi_transformer`` over them
(the KV-cache decode included).

Both take ``device``: None means the card (``resolve_device``);
``"meta"`` allocates nothing (for a state loaded afterwards).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...device import resolve_device
from . import functional as IF

__all__ = ["FusedFeedForward", "FusedMultiTransformer"]


_FFN_ATTRS = ("linear1_weight_attr", "linear1_bias_attr",
              "linear2_weight_attr", "linear2_bias_attr", "ln1_scale_attr",
              "ln1_bias_attr", "ln2_scale_attr", "ln2_bias_attr")


class FusedFeedForward(nn.Module):
    """The JAX layer's parameters in its order and with its defaults. A
    ``*_attr`` other than None is not ported yet (ROADMAP Queue 1 item
    10(e)), nor is a model-parallel ``nranks`` / ``ring_id`` (10(e), fleet's
    model-parallel layers);
    ``name`` is taken and, as there, unused. ``dtype``, ``device`` and
    ``seed`` are the port's own, keyword-only."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None, *, dtype=torch.float32,
                 device=None, seed=0):
        super().__init__()
        attrs = dict(zip(_FFN_ATTRS, (
            linear1_weight_attr, linear1_bias_attr, linear2_weight_attr,
            linear2_bias_attr, ln1_scale_attr, ln1_bias_attr, ln2_scale_attr,
            ln2_bias_attr)))
        given = [k for k, v in attrs.items() if v is not None]
        if given:
            raise NotImplementedError(
                f"FusedFeedForward: {', '.join(given)} not ported yet "
                "(ROADMAP Queue 1 item 10(e)); load the values with "
                "load_state_dict")
        if nranks != 1 or ring_id != -1:
            raise NotImplementedError(
                f"FusedFeedForward: nranks={nranks}, ring_id={ring_id}: "
                "training's tensor parallelism is not ported yet (ROADMAP "
                "Queue 1 item 10(e), fleet's model-parallel layers)")
        dev = resolve_device(device)
        self.generator = torch.Generator()
        self.generator.manual_seed(seed)

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=dev))

        self.linear1_weight = param(d_model, dim_feedforward)
        self.linear1_bias = param(dim_feedforward)
        self.linear2_weight = param(dim_feedforward, d_model)
        self.linear2_bias = param(d_model)
        self.ln1_scale = param(d_model)
        self.ln1_bias = param(d_model)
        self.ln2_scale = param(d_model)
        self.ln2_bias = param(d_model)
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                 else act_dropout_rate)
        self.activation = activation
        self.normalize_before = normalize_before
        self.epsilon = epsilon
        if dev.type != "meta":
            self.init_weights()

    @torch.no_grad()
    def init_weights(self):
        """The JAX layer's initialisers: Xavier-normal weights (std
        sqrt(2 / (fan_in + fan_out))) drawn from ``self.generator`` on the
        CPU, zero biases, unit LayerNorm scales."""
        for name, p in self.named_parameters():
            if name.endswith("weight"):
                std = math.sqrt(2.0 / (p.shape[0] + p.shape[1]))
                p.copy_(torch.empty(p.shape).normal_(
                    0.0, std, generator=self.generator))
            else:
                p.fill_(1.0 if name.endswith("scale") else 0.0)

    def forward(self, src, cache=None):
        return IF.fused_feedforward(
            src, self.linear1_weight, self.linear2_weight, self.linear1_bias,
            self.linear2_bias, self.ln1_scale, self.ln1_bias, self.ln2_scale,
            self.ln2_bias, self.act_dropout_rate, self.dropout_rate,
            self.activation, self.epsilon, self.epsilon,
            self.normalize_before, training=self.training,
            generator=self.generator)


_FMT_ATTRS = ("ln_scale_attrs", "ln_bias_attrs", "qkv_weight_attrs",
              "qkv_bias_attrs", "linear_weight_attrs", "linear_bias_attrs",
              "ffn_ln_scale_attrs", "ffn_ln_bias_attrs", "ffn1_weight_attrs",
              "ffn1_bias_attrs", "ffn2_weight_attrs", "ffn2_bias_attrs")


class FusedMultiTransformer(nn.Module):
    """The JAX layer's parameters in its order and with its defaults:
    ``num_layers < 0`` means one layer per ``qkv_weight_attrs`` entry, or
    one; ``dropout_rate``, ``nranks``, ``trans_qkvw``, ``ring_id`` and
    ``name`` are taken and, as there, unused. A ``*_attrs`` other than
    None is not ported yet (ROADMAP Queue 1 item 10(e)): the values come
    from ``weights.from_jax_state``. ``dtype`` and ``device`` are the
    port's own, keyword-only."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 ln_scale_attrs=None, ln_bias_attrs=None,
                 qkv_weight_attrs=None, qkv_bias_attrs=None,
                 linear_weight_attrs=None, linear_bias_attrs=None,
                 ffn_ln_scale_attrs=None, ffn_ln_bias_attrs=None,
                 ffn1_weight_attrs=None, ffn1_bias_attrs=None,
                 ffn2_weight_attrs=None, ffn2_bias_attrs=None,
                 epsilon=1e-5, num_layers=-1, nranks=1, trans_qkvw=True,
                 ring_id=-1, name=None, *, dtype=torch.float32, device=None):
        super().__init__()
        attrs = dict(zip(_FMT_ATTRS, (
            ln_scale_attrs, ln_bias_attrs, qkv_weight_attrs, qkv_bias_attrs,
            linear_weight_attrs, linear_bias_attrs, ffn_ln_scale_attrs,
            ffn_ln_bias_attrs, ffn1_weight_attrs, ffn1_bias_attrs,
            ffn2_weight_attrs, ffn2_bias_attrs)))
        given = [k for k, v in attrs.items() if v is not None]
        if given:
            raise NotImplementedError(
                f"FusedMultiTransformer: {', '.join(given)} not ported yet "
                "(ROADMAP Queue 1 item 10(e)); load the values with "
                "weights.from_jax_state")
        device = resolve_device(device)
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by "
                             f"num_heads {num_heads}")
        # JAX: len(qkv_weight_attrs) if given, else 1 (attrs are refused
        # above)
        self.num_layers = 1 if num_layers < 0 else int(num_layers)
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

    def forward(self, src, attn_mask=None, caches=None, pre_caches=None,
                rotary_embs=None, rotary_emb_dims=0, seq_lens=None,
                time_step=None):
        """``fused_multi_transformer`` over this stack; returns ``(out,
        caches)`` when ``caches`` is given (updated in place when
        ``time_step`` is), else ``out``."""
        out, new_caches = IF.fused_multi_transformer(
            src, list(self.ln_scales), list(self.ln_biases),
            list(self.qkv_weights), list(self.qkv_biases),
            list(self.linear_weights), list(self.linear_biases),
            list(self.ffn_ln_scales), list(self.ffn_ln_biases),
            list(self.ffn1_weights), list(self.ffn1_biases),
            list(self.ffn2_weights), list(self.ffn2_biases),
            pre_layer_norm=self.normalize_before, epsilon=self.epsilon,
            cache_kvs=caches, pre_caches=pre_caches,
            rotary_embs=rotary_embs, time_step=time_step,
            attn_mask=attn_mask, activation=self.activation,
            training=self.training)
        if caches is not None:
            return out, new_caches
        return out
