"""BERT for pretraining and classification. Counterpart of
``paddle_tpu/models/bert.py`` (BASELINE configs[1]: BERT-base pretraining).

The same modules, parameter names and shapes as the JAX model: learned
word, position and token-type embeddings with a LayerNorm, a post-LN
``nn.TransformerEncoder`` of gelu layers (its layers after the first
built by ``_clone_layer``, with the default epsilon, as in JAX), a tanh
pooler over the first token, and for pretraining an MLM head tied to
the word embedding (transform, gelu, LayerNorm, then ``h @ W_word.T +
mlm_bias``) beside an NSP head on the pooled output; so
``weights.bert_from_jax_state`` moves a JAX state across by name.
Without an attention mask, attention runs the flash attention kernels
(dropout in them); with one, the composite. Every LayerNorm whose
weight is in its input's dtype runs the LayerNorm kernels.

The MLM loss scores only the labelled positions, as JAX's eager path
does: K = ceil(22 S / 100) positions a row, taken by a stable sort of
``labels == -100`` (labelled ones first, in order; the padding slots are
ignored by the loss), unless ``PADDLE_TPU_MLM_GATHER=0`` or K >= S. A
row with more than K labels falls back to the full sequence, with a
warning the first time. Counting the labels reads them on the host (one
sync a forward).

The initial weights are JAX's initializers (``Normal(0, 0.02)`` for the
embeddings, pooler, transform and NSP head, ``XavierNormal`` in the
encoder), drawn on the CPU from the model's ``generator`` (a CPU
``torch.Generator`` seeded from ``seed``), which also keys its dropout.
"""
from __future__ import annotations

import os
import warnings

import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..nn.initializer import Normal
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import TransformerEncoder, TransformerEncoderLayer
from ..nn.utils_ import ParamAttr

__all__ = ["BertConfig", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "bert_base", "bert_tiny"]


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_position=512,
                 type_vocab_size=2, dropout=0.1, layer_norm_eps=1e-12,
                 initializer_range=0.02):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps
        self.initializer_range = initializer_range


def _attr(std):
    return ParamAttr(initializer=Normal(0.0, std))


def _setup(device, seed, generator):
    """(device, generator): the card unless told otherwise, and a CPU
    generator seeded from ``seed`` unless one is given."""
    if generator is None:
        generator = torch.Generator()
        generator.manual_seed(seed)
    return resolve_device(device), generator


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig, *, device=None, dtype=torch.float32,
                 seed=0, generator=None):
        super().__init__()
        dev, gen = _setup(device, seed, generator)
        kw = {"dtype": dtype, "device": dev, "trainable": True,
              "generator": gen}
        std = c.initializer_range
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size,
                                         weight_attr=_attr(std), **kw)
        self.position_embeddings = Embedding(c.max_position, c.hidden_size,
                                             weight_attr=_attr(std), **kw)
        self.token_type_embeddings = Embedding(
            c.type_vocab_size, c.hidden_size, weight_attr=_attr(std), **kw)
        self.layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps,
                                    dtype=dtype, device=dev)
        self.dropout = Dropout(c.dropout, generator=gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)
        emb = self.word_embeddings(input_ids) + \
            self.position_embeddings(position_ids)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class BertPooler(nn.Module):
    def __init__(self, c: BertConfig, *, device=None, dtype=torch.float32,
                 seed=0, generator=None):
        super().__init__()
        dev, gen = _setup(device, seed, generator)
        self.dense = Linear(c.hidden_size, c.hidden_size,
                            weight_attr=_attr(c.initializer_range),
                            dtype=dtype, device=dev, trainable=True,
                            generator=gen)

    def forward(self, hidden):
        return F.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    """Returns ``(sequence output [B, S, E], pooled [B, E])``;
    ``attention_mask`` [B, S] (nonzero: attend) masks the keys."""

    def __init__(self, c: BertConfig, *, device=None, dtype=torch.float32,
                 seed=0, generator=None):
        super().__init__()
        dev, gen = _setup(device, seed, generator)
        kw = {"device": dev, "dtype": dtype, "generator": gen}
        self.config = c
        self.embeddings = BertEmbeddings(c, **kw)
        enc_layer = TransformerEncoderLayer(
            c.hidden_size, c.num_heads, c.intermediate_size, c.dropout,
            activation="gelu", layer_norm_eps=c.layer_norm_eps, **kw)
        self.encoder = TransformerEncoder(enc_layer, c.num_layers)
        self.pooler = BertPooler(c, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        mask = (None if attention_mask is None
                else attention_mask[:, None, None, :] > 0)
        seq = self.encoder(x, mask)
        return seq, self.pooler(seq)


def _gather_budget(labels):
    """(K, order [B, K]) of the masked-position gather, or None when it
    is off or K >= S: each row's labelled positions first, in order."""
    s_len = labels.shape[1]
    kmax = max(1, -(-22 * s_len // 100))
    if os.environ.get("PADDLE_TPU_MLM_GATHER", "1") == "0" or kmax >= s_len:
        return None
    unlabelled = labels == -100
    dens = int((~unlabelled).sum(1).max())
    if dens > kmax:
        if not getattr(BertForPretraining, "_warned_dense_mlm", False):
            BertForPretraining._warned_dense_mlm = True
            warnings.warn(
                f"BertForPretraining: {dens} MLM labels in a row exceed the "
                f"{kmax} gather budget (22% of seq); scoring the full "
                "sequence instead. Set PADDLE_TPU_MLM_GATHER=0 to silence.",
                UserWarning, stacklevel=3)
        kmax = s_len
    order = torch.argsort(unlabelled.to(torch.uint8), dim=1, stable=True)
    return order[:, :kmax]


class BertForPretraining(nn.Module):
    """MLM (tied to the word embedding) and NSP heads. With
    ``masked_lm_labels`` (-100 where unlabelled) the forward returns the
    MLM loss plus, with ``next_sentence_labels``, the NSP loss; without,
    ``(mlm logits [B, S, V], nsp logits [B, 2])``."""

    def __init__(self, c: BertConfig, *, device=None, dtype=torch.float32,
                 seed=0, generator=None):
        super().__init__()
        dev, gen = _setup(device, seed, generator)
        kw = {"dtype": dtype, "device": dev, "trainable": True,
              "generator": gen}
        self.config = c
        self.bert = BertModel(c, device=dev, dtype=dtype, generator=gen)
        self.transform = Linear(c.hidden_size, c.hidden_size,
                                weight_attr=_attr(c.initializer_range), **kw)
        self.transform_ln = LayerNorm(c.hidden_size, c.layer_norm_eps,
                                      dtype=dtype, device=dev)
        self.mlm_bias = nn.Parameter(torch.zeros(c.vocab_size, dtype=dtype,
                                                 device=dev))
        self.nsp = Linear(c.hidden_size, 2,
                          weight_attr=_attr(c.initializer_range), **kw)

    def _mlm_logits(self, h):
        h = self.transform_ln(F.gelu(self.transform(h)))
        return F.linear(h, self.bert.embeddings.word_embeddings.weight.t(),
                        self.mlm_bias)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, next_sentence_labels=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        nsp_logits = self.nsp(pooled)
        if masked_lm_labels is None:
            return self._mlm_logits(seq), nsp_logits
        order = _gather_budget(masked_lm_labels)
        if order is None:
            h_sel, labels_sel = seq, masked_lm_labels
        else:
            h_sel = torch.take_along_dim(seq, order[..., None], 1)
            labels_sel = torch.take_along_dim(masked_lm_labels, order, 1)
        logits = self._mlm_logits(h_sel)
        loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels_sel.reshape(-1), ignore_index=-100)
        if next_sentence_labels is not None:
            loss = loss + F.cross_entropy(nsp_logits, next_sentence_labels)
        return loss


class BertForSequenceClassification(nn.Module):
    """Dropout and a linear classifier on the pooled output; with
    ``labels`` the cross entropy, else the logits."""

    def __init__(self, c: BertConfig, num_classes=2, *, device=None,
                 dtype=torch.float32, seed=0, generator=None):
        super().__init__()
        dev, gen = _setup(device, seed, generator)
        self.bert = BertModel(c, device=dev, dtype=dtype, generator=gen)
        self.dropout = Dropout(c.dropout, generator=gen)
        self.classifier = Linear(c.hidden_size, num_classes,
                                 weight_attr=_attr(c.initializer_range),
                                 dtype=dtype, device=dev, trainable=True,
                                 generator=gen)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels)
        return logits


def bert_base(**kw):
    return BertConfig(**kw)


def bert_tiny(**kw):
    return BertConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                      num_heads=2, intermediate_size=128, max_position=128,
                      **kw)
