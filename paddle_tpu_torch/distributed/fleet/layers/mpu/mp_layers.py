"""Tensor-parallel layers. Counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/mp_layers.py``.

JAX keeps each layer's FULL parameter with a ``PartitionSpec`` on the
'mp' mesh axis and lets GSPMD split the matmul and insert the
collectives. Here each mp rank is a process holding its slice of a
distributed parameter (Megatron's layout, as Paddle's reference), split
along JAX's ``split_axis``: ``ColumnParallelLinear``'s weight
``[in, out/mp]`` and bias ``[out/mp]`` (axis 1 and 0),
``RowParallelLinear``'s weight ``[in/mp, out]`` (axis 0; its bias is
whole), ``VocabParallelEmbedding``'s rows ``[r V/mp, (r+1) V/mp)`` (axis
0). Each such parameter keeps JAX's attributes: ``split_axis``,
``is_distributed`` (read by ``mp_split``) and ``sharding_spec`` (a tuple naming "mp" on the
split axis; the GroupSharded stages compose "sharding" with it,
``group_sharded.augment_spec_for``). The initial weight is the full
logical one drawn on the CPU from the layer's initializer (``weight_attr``,
else JAX's default) and ``generator``, of which this rank keeps its
slice: one seed gives the serial layer's weights at every degree.
Without a ``generator`` or an initializer the parameter is left
uninitialised, as the port's ``Linear`` leaves it (for a state loaded
afterwards, ``weights.module_from_jax_state``).

Collectives (``mp_ops``), over the model-parallel group, a forward and
backward of a layer:

- ``ColumnParallelLinear``: one all-reduce in backward where its input
  needs a gradient (``_c_identity``); with ``gather_output`` one
  all-gather in forward;
- ``RowParallelLinear``: one all-reduce in forward of the partial sums
  (the bias added once, after it); without ``input_is_parallel`` one
  all-gather in backward where the input needs a gradient;
- ``VocabParallelEmbedding``: one all-reduce in forward (an id outside
  this rank's rows gives zeros);
- ``ParallelCrossEntropy``: two all-reduces in forward, the MAX of the
  rows' detached maxima, then the SUM of the exponentials' sums and the
  target logits stacked; none in backward.

A replicated parameter (a Row bias, any other layer's weight) sees the
same full gradient on every mp rank and is reduced over no group. Under
recompute a recomputed layer's forward collectives run again in backward.
At one rank (or without a topology of processes) every layer is its
serial counterpart and issues no collective.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as TF

from .....nn.functional import common as pf
from .....nn.functional.loss import cross_entropy
from .....nn.initializer import Constant, Normal, XavierNormal
from .....nn.utils_ import ParamAttr
from .mp_ops import (_AllReduce, _Concat, _Identity, _Split, _run,
                     mp_group)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy"]


def _rank_n(g):
    return (0, 1) if g is None else (g.rank, g.nranks)


def _dist_param(shape, attr, default, axis, g, *, dtype, device, generator,
                trainable, spec):
    """The parameter of logical ``shape`` this rank holds: its slice along
    ``axis`` (None: whole) of the full value drawn on the CPU."""
    rank, n = _rank_n(g)
    if axis is not None and shape[axis] % n:
        raise ValueError(f"mp layer: dim {axis} of {tuple(shape)} is not "
                         f"divisible by the model-parallel degree {n}")
    init = getattr(attr, "initializer", None)
    local = list(shape)
    if axis is not None:
        local[axis] //= n
    meta = torch.device(device).type == "meta" if device else False
    if meta or (init is None and generator is None):
        data = torch.empty(local, dtype=dtype, device=device)
    else:
        full = (init or default)(shape, torch.float32, generator=generator)
        data = local_slice(full, axis, g).to(device=device, dtype=dtype)
    p = nn.Parameter(data.contiguous(), requires_grad=trainable and getattr(
        attr, "trainable", True))
    if isinstance(attr, ParamAttr):
        p.regularizer = attr.regularizer
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.need_clip = attr.need_clip
    p.sharding_spec = spec
    if axis is not None:
        p.split_axis = axis
        p.is_distributed = n > 1
        p._mp_group = g
    return p


def local_slice(full, axis, group):
    """This rank's slice of the logical tensor ``full`` along ``axis``
    (None, or a group of one rank: ``full`` itself)."""
    if axis is None or group is None:
        return full
    c = full.shape[axis] // group.nranks
    return full.narrow(axis, group.rank * c, c)


def mp_split(p):
    """The model-parallel ``Group`` that ``p`` (a parameter of these
    layers, or a GroupSharded shard of one) is split over, or None for a
    replicated one. Reads the instance attributes: ``torch.Tensor`` has
    an ``is_distributed`` method of its own."""
    d = vars(p)
    return d.get("_mp_group") if d.get("is_distributed") is True else None


def logical_shape(p):
    """The full shape of a parameter of these layers (its slice's shape
    with the split axis times the mp degree)."""
    shape = list(p.shape)
    g = mp_split(p)
    if g is not None:
        shape[p.split_axis] *= g.nranks
    return tuple(shape)


class ColumnParallelLinear(nn.Module):
    """``y = x @ W + b`` with W ``[in, out]`` split on out over mp: this
    rank's ``[in, out/mp]`` columns. ``gather_output=False`` leaves the
    activation split on its last axis for a following
    ``RowParallelLinear``. The port's extras: ``dtype``, ``device``,
    ``generator`` (the initial draw) and ``trainable``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, dtype=torch.float32,
                 device=None, generator=None, trainable=True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self._group = _mp(mp_group)
        self.world_size = _rank_n(self._group)[1]
        kw = dict(dtype=dtype, device=device, generator=generator,
                  trainable=trainable)
        self.weight = _dist_param((in_features, out_features), weight_attr,
                                  XavierNormal(), 1, self._group,
                                  spec=(None, "mp"), **kw)
        self.bias = (None if has_bias is False else _dist_param(
            (out_features,), None, Constant(0.0), 0, self._group,
            spec=("mp",), **kw))

    def forward(self, x):
        out = pf.linear(_run(_Identity, x, self._group), self.weight,
                        self.bias)
        return _run(_Concat, out, self._group) if self.gather_output \
            else out


class RowParallelLinear(nn.Module):
    """``y = x @ W + b`` with W ``[in, out]`` split on in over mp: this
    rank's ``[in/mp, out]`` rows. The input arrives split on its last
    axis (``input_is_parallel``) or is split here; the partial products
    are all-reduced and the whole bias is added once, after."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 dtype=torch.float32, device=None, generator=None,
                 trainable=True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self._group = _mp(mp_group)
        self.world_size = _rank_n(self._group)[1]
        kw = dict(dtype=dtype, device=device, generator=generator,
                  trainable=trainable)
        self.weight = _dist_param((in_features, out_features), weight_attr,
                                  XavierNormal(), 0, self._group,
                                  spec=("mp", None), **kw)
        self.bias = (_dist_param((out_features,), None, Constant(0.0), None,
                                 self._group, spec=(None,), **kw)
                     if has_bias else None)

    def forward(self, x):
        if not self.input_is_parallel:
            x = _run(_Split, x, self._group)
        out = _run(_AllReduce, pf.linear(x, self.weight), self._group)
        return out if self.bias is None else out + self.bias.to(out.dtype)


class VocabParallelEmbedding(nn.Module):
    """Embedding whose ``[V, E]`` table is split on V over mp: this rank
    holds rows ``[r V/mp, (r+1) V/mp)``, an id outside them gives zeros,
    and the ranks' lookups are summed."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, dtype=torch.float32,
                 device=None, generator=None, trainable=True):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self._group = _mp(mp_group)
        rank, n = _rank_n(self._group)
        self.world_size = n
        self.vocab_start = rank * (num_embeddings // max(n, 1))
        self.weight = _dist_param(
            (num_embeddings, embedding_dim), weight_attr, Normal(0.0, 1.0),
            0, self._group, spec=("mp", None), dtype=dtype, device=device,
            generator=generator, trainable=trainable)

    def forward(self, x):
        if self._group is None:
            return TF.embedding(x, self.weight)
        rows = self.weight.shape[0]
        local = x - self.vocab_start
        outside = (local < 0) | (local >= rows)
        out = TF.embedding(local.masked_fill(outside, 0), self.weight)
        out = out.masked_fill(outside[..., None], 0)
        return _run(_AllReduce, out, self._group)


class _VocabParallelCE(torch.autograd.Function):
    """Softmax cross entropy over logits split on the vocabulary: JAX's
    two-pass arithmetic (``mp_layers.py:153-199``) in fp32; the backward
    is softmax minus one-hot on this rank's shard."""

    @staticmethod
    def forward(ctx, logits, label, g, ignore_index):
        from ....communication.group import ReduceOp
        from ....communication.ops import _all_reduce
        lg = logits.float()
        part = lg.shape[-1]
        m = lg.detach().amax(-1)
        _all_reduce(m, ReduceOp.MAX, g)
        e = torch.exp(lg - m[:, None])
        lo = g.rank * part
        in_range = (label >= lo) & (label < lo + part)
        loc = (label - lo).clamp(0, part - 1)
        tgt = torch.where(in_range, lg.gather(1, loc[:, None])[:, 0],
                          torch.zeros((), device=lg.device))
        stats = torch.stack([e.sum(-1), tgt])
        _all_reduce(stats, ReduceOp.SUM, g)
        z, tgt = stats[0], stats[1]
        loss = m + torch.log(z) - tgt
        ignored = label == ignore_index
        loss = torch.where(ignored, torch.zeros((), device=lg.device), loss)
        ctx.save_for_backward(e, z, in_range, loc, ignored)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, grad):
        e, z, in_range, loc, ignored = ctx.saved_tensors
        g = e / z[:, None]
        rows = torch.arange(g.shape[0], device=g.device)
        g[rows[in_range], loc[in_range]] -= 1.0
        scale = torch.where(ignored, torch.zeros((), device=g.device),
                            grad.float())
        return (g * scale[:, None]).to(ctx.dtype), None, None, None


class ParallelCrossEntropy(nn.Module):
    """Per-row softmax cross entropy of logits split on the vocabulary
    over mp (``input`` this rank's ``[..., V/mp]``), without gathering
    the vocabulary: the result is every row's loss (0 at
    ``ignore_index``), the same on each mp rank. Below mp 2 it is the
    dense ``cross_entropy(reduction="none")``, as in JAX."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self._group = _mp(mp_group)

    def forward(self, input, label):
        if self._group is None:
            return cross_entropy(input, label, reduction="none",
                                 ignore_index=self.ignore_index)
        shape = input.shape[:-1]
        loss = _VocabParallelCE.apply(input.reshape(-1, input.shape[-1]),
                                      label.reshape(-1).long(), self._group,
                                      self.ignore_index)
        return loss.reshape(shape)


def _mp(group):
    return mp_group(group)
