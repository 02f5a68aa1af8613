"""The weight bridge from the JAX package.

``from_jax_state`` takes the JAX modules' ``state_dict()`` as numpy
arrays, keyed as ``paddle_tpu``'s ``Layer.named_parameters`` names them
(``ln_scales.0``, ``qkv_weights.0``, ..., ``weight``, ``bias``), and
returns the port's FusedMultiTransformer, Embedding and Linear head with
the same values, frozen for serving. ``gpt_from_jax_state`` does the same
for the training model ``GPTForCausalLM`` (``gpt.wte.weight``,
``gpt.h.0.ln1.weight``, ...), its parameters trainable, and
``feedforward_from_jax_state`` for ``FusedFeedForward``'s eight
parameters (``linear1_weight``, ..., ``ln2_bias``), trainable, and
``llama_from_jax_state`` for ``LlamaForCausalLM``
(``llama.embed_tokens.weight``, ``llama.layers.0.self_attn.q_proj.weight``,
..., ``llama.norm.weight``, ``lm_head.weight``), trainable, and
``bert_from_jax_state`` for the BERT models (``mlm_bias``,
``bert.embeddings.word_embeddings.weight``,
``bert.encoder.layers.0.self_attn.q_proj.weight``, ...), trainable.
These are the only paths by which weights cross; a caller without JAX
builds the same dicts from numpy directly (``random_state``).
``optimizer_state_from_jax`` carries a JAX optimizer's state (its
moments, masters, scalars, scheduler and step) into the port's.
"""
from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from .device import resolve_device
from .incubate.nn.layer import FusedFeedForward, FusedMultiTransformer
from .models.bert import (BertForPretraining, BertForSequenceClassification,
                          BertModel)
from .models.gpt import GPTForCausalLM
from .models.llama import LlamaForCausalLM
from .nn.layer.common import Embedding, Linear

__all__ = ["from_jax_state", "gpt_from_jax_state",
           "feedforward_from_jax_state", "llama_from_jax_state",
           "module_from_jax_state", "gather_full_state",
           "bert_from_jax_state", "optimizer_state_from_jax",
           "random_state"]


def _tensor(arr, device, dtype):
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def _load(module, state, device, dtype, trainable=False):
    own = dict(module.named_parameters())
    if set(own) != set(state):
        raise ValueError(
            f"{type(module).__name__}: state keys differ — missing "
            f"{sorted(set(own) - set(state))}, unexpected "
            f"{sorted(set(state) - set(own))}")
    with torch.no_grad():
        for name, p in own.items():
            t = _tensor(state[name], device, dtype)
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{type(module).__name__}.{name}: shape "
                                 f"{tuple(t.shape)} != {tuple(p.shape)}")
            owner, _, leaf = name.rpartition(".")
            new = nn.Parameter(t, requires_grad=trainable)
            new.__dict__.update(p.__dict__)     # ParamAttr's attributes
            module.get_submodule(owner)._parameters[leaf] = new


def from_jax_state(fmt_np, embed_np, head_np, activation="gelu",
                   normalize_before=True, epsilon=1e-5, device=None,
                   dtype=None):
    """Returns ``(fmt, embed, head)`` on ``device`` (default ``cuda``),
    in ``dtype`` (default: the arrays' own). Shapes are read from the
    arrays; the three scalars the arrays cannot carry are arguments."""
    dev = resolve_device(device)
    layers = [int(m.group(1)) for k in fmt_np
              if (m := re.fullmatch(r"qkv_weights\.(\d+)", k))]
    _, nh, _, e = np.shape(fmt_np["qkv_weights.0"])
    ff = np.shape(fmt_np["ffn1_weights.0"])[1]
    v = np.shape(embed_np["weight"])[0]
    fmt = FusedMultiTransformer(e, nh, ff, activation=activation,
                                normalize_before=normalize_before,
                                epsilon=epsilon, num_layers=len(layers),
                                device="meta")
    embed = Embedding(v, e, device="meta")
    head = Linear(e, np.shape(head_np["weight"])[1],
                  bias_attr=None if "bias" in head_np else False,
                  device="meta")
    for module, state in ((fmt, fmt_np), (embed, embed_np),
                          (head, head_np)):
        _load(module, state, dev, dtype)
    return fmt, embed, head


def gpt_from_jax_state(state_np, config, device=None, dtype=None):
    """The JAX ``GPTForCausalLM``'s ``state_dict()`` as numpy arrays ->
    the port's ``GPTForCausalLM(config)`` on ``device`` (default ``cuda``)
    holding the same values, trainable, in ``dtype`` (default: the
    arrays' own). The tied head needs no entry of its own."""
    dev = resolve_device(device)
    model = GPTForCausalLM(config, device="meta")
    _load(model, state_np, dev, dtype, trainable=True)
    return model


def llama_from_jax_state(state_np, config, device=None, dtype=None):
    """The JAX ``LlamaForCausalLM``'s ``state_dict()`` as numpy arrays ->
    the port's ``LlamaForCausalLM(config)`` on ``device`` (default
    ``cuda``) holding the same values, trainable, in ``dtype`` (default:
    the arrays' own). A tied head needs no entry of its own. Under a
    fleet topology with a model degree over processes each
    model-parallel parameter takes this rank's slice
    (``module_from_jax_state``)."""
    dev = resolve_device(device)
    model = LlamaForCausalLM(config, device="meta")
    module_from_jax_state(model, state_np, device=dev, dtype=dtype,
                          strict=True)
    return model


def _holder(p):
    """(tensor to write, split axis of a stage-3 shard or None, its
    group): a GroupSharded stage-3 parameter at rest is written through
    its shard."""
    if getattr(p, "_stage3", False):
        info = p._shard._shard_info
        return p._shard, info.axis, info.group
    return p, None, None


def module_from_jax_state(module, state_np, *, device=None, dtype=None,
                          strict=False):
    """Load a JAX model's full ``state_dict()`` (numpy arrays by name)
    into ``module``, this rank's part of it: each parameter of fleet's
    model-parallel layers takes its slice along ``split_axis``; a
    pipeline stage's ``PipelineLayer`` holds only its own keys (the
    global names), and only those are read; a GroupSharded stage-3
    parameter at rest takes its shard of that slice. A parameter on the
    meta device is replaced by a trainable one on ``device`` (default
    the card) in ``dtype`` (default the array's); any other is written
    in place. ``strict``: the module's keys must be the state's."""
    from .distributed.fleet.layers.mpu.mp_layers import local_slice, mp_split
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(state_np))
    if missing or (strict and set(own) != set(state_np)):
        raise ValueError(
            f"{type(module).__name__}: state keys differ — missing "
            f"{missing}, unexpected {sorted(set(state_np) - set(own))}")
    with torch.no_grad():
        for name, p in own.items():
            full = _tensor(state_np[name], "cpu", None)
            t = local_slice(full, getattr(p, "split_axis", None),
                            mp_split(p))
            dst, axis, group = _holder(p)
            if axis is not None:
                t = local_slice(t, axis, group)
            if tuple(t.shape) != tuple(dst.shape):
                raise ValueError(f"{type(module).__name__}.{name}: shape "
                                 f"{tuple(t.shape)} != {tuple(dst.shape)}")
            if dst.device.type != "meta":
                dst.copy_(t)
                continue
            owner, _, leaf = name.rpartition(".")
            new = nn.Parameter(
                t.to(device=resolve_device(device), dtype=dtype or t.dtype),
                requires_grad=True)
            new.__dict__.update(p.__dict__)     # ParamAttr's, mp attributes
            module.get_submodule(owner)._parameters[leaf] = new


def gather_full_state(module):
    """``module``'s state as JAX's full ``state_dict()`` names and shapes
    (CPU tensors): a GroupSharded stage-3 model's parameters gathered,
    each model-parallel slice all-gathered along its ``split_axis`` over
    its mp group, and under a pipeline every stage's keys gathered over
    the pipe group (a shared weight once). A collective: every rank of
    those groups calls it."""
    from .distributed.communication.ops import _all_gather_flat
    from .distributed.fleet.base.topology import _HYBRID_GROUP
    from .distributed.fleet.meta_parallel.sharding.group_sharded import (
        GroupShardedStage3, _placeholder)
    layers = getattr(module, "_layers", module)
    if isinstance(module, GroupShardedStage3):
        sd = module.state_dict()
    else:
        st = getattr(layers, "_stage3_state", None)
        for e in (st.at_rest.values() if st is not None else ()):
            e.param.data = e.gather()
        sd = layers.state_dict()
        for e in (st.at_rest.values() if st is not None else ()):
            e.param.data = _placeholder(e.param)
    from .distributed.fleet.layers.mpu.mp_layers import mp_split
    params = dict(layers.named_parameters())
    out = {}
    for name, t in sd.items():
        p = params.get(name)
        g = None if p is None else mp_split(p)
        t = t.detach()
        if g is not None:
            axis = p.split_axis
            moved = t.movedim(axis, 0).contiguous()
            buf = moved.new_empty((g.nranks * moved.shape[0],
                                   *moved.shape[1:]))
            _all_gather_flat(buf, moved, g)
            t = buf.movedim(0, axis)
        out[name] = t.cpu().contiguous()
    hcg = _HYBRID_GROUP[0]
    if hcg is not None and not hcg.is_serving_mesh() and \
            hcg.get_pipe_parallel_world_size() > 1:
        import torch.distributed as dist
        parts = [None] * hcg.get_pipe_parallel_world_size()
        dist.all_gather_object(parts, out,
                               group=hcg.get_pipe_parallel_group())
        for part in parts:
            for k, v in part.items():
                out.setdefault(k, v)
    return out


def bert_from_jax_state(state_np, config, *, device=None, dtype=None):
    """A JAX BERT model's ``state_dict()`` as numpy arrays -> the port's
    model of the same kind (``BertForPretraining`` where the state has
    ``mlm_bias``, ``BertForSequenceClassification`` where it has
    ``classifier.weight``, else ``BertModel``) of ``config``, on
    ``device`` (default ``cuda``) holding the same values, trainable, in
    ``dtype`` (default: the arrays' own). The tied MLM head needs no
    entry of its own."""
    dev = resolve_device(device)
    if "mlm_bias" in state_np:
        model = BertForPretraining(config, device="meta")
    elif "classifier.weight" in state_np:
        model = BertForSequenceClassification(
            config, np.shape(state_np["classifier.weight"])[1],
            device="meta")
    else:
        model = BertModel(config, device="meta")
    _load(model, state_np, dev, dtype, trainable=True)
    return model


def _numpy(value):
    """A JAX tensor, array or number as numpy (no JAX import: anything
    with ``numpy()`` is asked for it)."""
    return np.asarray(value.numpy() if hasattr(value, "numpy") else value)


def optimizer_state_from_jax(jax_state, jax_params, opt):
    """Load a JAX optimizer's ``state_dict()`` into the port's ``opt``.

    JAX keys a parameter's slots by ``p.name`` (``<name>_moment1``,
    ``<name>_master``, ...), a per-process uid, so the slots are matched
    by position: ``jax_params`` is the JAX model's parameter list (or
    their names) in the order the port's optimizer holds its parameters
    (``parameters()`` on both sides). The slot suffixes are JAX's;
    ``LR_Scheduler`` and ``@step`` carry over as they are."""
    names = [p if isinstance(p, str) else p.name for p in jax_params]
    if len(names) != len(opt._params):
        raise ValueError(f"{len(names)} JAX parameters for the port "
                         f"optimizer's {len(opt._params)}")
    state = {}
    for key, value in jax_state.items():
        if key in ("LR_Scheduler", "@step"):
            state[key] = value
            continue
        owner = max((i for i, n in enumerate(names)
                     if key.startswith(n + "_")),
                    key=lambda i: len(names[i]), default=None)
        if owner is None:
            raise ValueError(f"JAX optimizer state {key!r} names no "
                             "parameter of jax_params")
        suffix = key[len(names[owner]) + 1:]
        state[f"{opt._params[owner][0]}_{suffix}"] = _numpy(value)
    opt.set_state_dict(state)


def feedforward_from_jax_state(state_np, dropout_rate=0.1, epsilon=1e-5,
                               activation="relu", act_dropout_rate=None,
                               normalize_before=False, device=None,
                               dtype=None, seed=0):
    """The JAX ``FusedFeedForward``'s ``state_dict()`` as numpy arrays ->
    the port's ``FusedFeedForward`` on ``device`` (default ``cuda``)
    holding the same values, trainable, in ``dtype`` (default: the
    arrays' own). d_model and dim_feedforward are read from
    ``linear1_weight``; the scalars the arrays cannot carry are arguments
    (``seed`` keys the dropout masks)."""
    dev = resolve_device(device)
    d_model, dff = np.shape(state_np["linear1_weight"])
    ffn = FusedFeedForward(d_model, dff, dropout_rate, epsilon, activation,
                           act_dropout_rate, normalize_before,
                           device="meta", seed=seed)
    _load(ffn, state_np, dev, dtype, trainable=True)
    return ffn


def random_state(rng, embed_dim, num_heads, dim_feedforward, num_layers,
                 vocab):
    """Random numpy state dicts for ``from_jax_state``, keyed as the JAX
    layers name them: LN scales near 1, small nonzero biases, matrices
    scaled by 1/sqrt(fan_in), a normal(0, 1) embedding. ``rng`` is a
    ``numpy.random.Generator``."""
    e, h, ff = embed_dim, num_heads, dim_feedforward
    hd = e // h
    shapes = {"ln_scales": (e,), "ln_biases": (e,),
              "qkv_weights": (3, h, hd, e), "qkv_biases": (3, h, hd),
              "linear_weights": (e, e), "linear_biases": (e,),
              "ffn_ln_scales": (e,), "ffn_ln_biases": (e,),
              "ffn1_weights": (e, ff), "ffn1_biases": (ff,),
              "ffn2_weights": (ff, e), "ffn2_biases": (e,)}
    fmt = {}
    for name, shape in shapes.items():
        for i in range(num_layers):
            z = rng.standard_normal(shape, dtype=np.float32)
            if "scales" in name:
                a = 1 + 0.1 * z
            elif "biases" in name:
                a = 0.1 * z
            else:
                a = z / np.float32(np.sqrt(shape[-2]))
            fmt[f"{name}.{i}"] = a.astype(np.float32)
    embed = {"weight": rng.standard_normal((vocab, e), dtype=np.float32)}
    head = {"weight": rng.standard_normal((e, vocab), dtype=np.float32)
            / np.float32(np.sqrt(e))}
    return fmt, embed, head
