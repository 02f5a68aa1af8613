"""Pipeline model description. Counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py``: ``LayerDesc``,
``SharedLayerDesc``, ``PipelineLayer``.

JAX builds every stage (its single controller places them on the mesh).
Here each pp rank is a process and builds only the layers of its own
segments, as Paddle's reference does; without a pipe group of more than
one rank (no fleet topology, or pp 1) it builds them all, as JAX does.
The segmentation is JAX's: ``segment_parts`` cuts the layer list into
``num_stages`` uniform runs (``np.array_split``); with
``num_virtual_pipeline_stages`` v above 1 the list is cut into v times
pp runs and stage i holds runs i, pp + i, ... (Paddle's round-robin
chunks, ``chunk_parts``). A built layer keeps its global index as its
name (``run_function.<i>.…``), so a stage's ``state_dict`` is the subset
of JAX's with the same keys.

A ``SharedLayerDesc`` is built on each stage that uses it, registered
under the index of its first occurrence (JAX's owner), and a later
occurrence runs it through its ``forward_func`` without registering it
again. At build time the owner stage's weights are broadcast to the
other stages that use them, and before each optimizer step their
gradients are summed over those stages (``shared_weight_groups`` and
``hybrid_parallel_util.allreduce_shared_weight_gradients``); a copy on a
stage that does not own it is marked ``_pp_shared_copy``, so a global
norm counts the weight once.

``recompute_interval`` and ``recompute_ctx`` are taken and, as in JAX,
unused: a layer recomputes itself (``LlamaConfig(recompute=True)``).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


class LayerDesc:
    def __init__(self, layer_cls, *inputs, **kwargs):
        self.layer_cls = layer_cls
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_cls, forward_func=None, shared_weight_attr
                 ="weight", *inputs, **kwargs):
        super().__init__(layer_cls, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class _Layers(nn.ModuleDict):
    """The built layers by global index (an int or its string)."""

    def __getitem__(self, idx):
        return super().__getitem__(str(idx))

    def __contains__(self, idx):
        return super().__contains__(str(idx))


def _pipe(topology, num_stages):
    """(stage id, pipe degree, hcg) of this process: the active fleet
    topology's where its pipe group has more than one process, else
    (0, 1, None)."""
    from ..base.topology import _HYBRID_GROUP
    hcg = _HYBRID_GROUP[0]
    if hcg is None or hcg.is_serving_mesh() or \
            hcg.get_pipe_parallel_world_size() == 1:
        return 0, 1, None
    pp = hcg.get_pipe_parallel_world_size()
    if num_stages != pp:
        raise ValueError(f"PipelineLayer: num_stages {num_stages} != the "
                         f"topology's pipe degree {pp}")
    return hcg.get_stage_id(), pp, hcg


class PipelineLayer(nn.Module):
    """A layer list cut into ``num_stages`` pipeline stages; this process
    builds its stage's layers (all of them without a pipe group)."""

    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._topo = topology
        self._num_stages = num_stages or (
            topology.get_dim("pipe") if topology else 1)
        self._num_virtual_pipeline_stages = num_virtual_pipeline_stages or 1
        self._recompute_interval = recompute_interval
        self.descs = list(layers)
        self._segment()
        self._stage_id, pp, self._hcg = _pipe(topology, self._num_stages)
        v = self._num_virtual_pipeline_stages
        self.chunk_parts = [list(map(int, c)) for c in np.array_split(
            np.arange(len(self.descs)), self._num_stages * v)]
        # this stage's chunks, in order (v of them; all of them at pp 1)
        self._chunks = ([self.chunk_parts[c * pp + self._stage_id]
                         for c in range(v)] if pp > 1
                        else [list(range(len(self.descs)))])
        mine = {i for c in self._chunks for i in c}
        first = {}                  # shared key -> index of its owner
        for i, d in enumerate(self.descs):
            if isinstance(d, SharedLayerDesc):
                first.setdefault(d.layer_name, i)
        self.run_function = _Layers()
        shared: dict = {}
        for i, d in enumerate(self.descs):
            if i not in mine:
                continue
            if isinstance(d, SharedLayerDesc):
                owner = first[d.layer_name]
                layer = shared.get(d.layer_name)
                if layer is None:
                    layer = shared[d.layer_name] = d.build_layer()
                    self.run_function[str(owner)] = layer
                if i != owner:
                    self.run_function[str(i)] = _SharedForward(
                        layer, d.forward_func)
            elif isinstance(d, LayerDesc):
                self.run_function[str(i)] = d.build_layer()
            elif isinstance(d, nn.Module):
                self.run_function[str(i)] = d
            elif callable(d):
                self.run_function[str(i)] = _FnLayer(d)
            else:
                raise TypeError(f"bad pipeline item {d!r}")
        self._shared_groups = self._sync_shared(first, pp, mine)

    def _segment(self):
        n = len(self.descs)
        parts = np.array_split(np.arange(n), self._num_stages)
        self.segment_parts = [list(map(int, p)) for p in parts]

    def _sync_shared(self, first, pp, mine):
        """For each shared key used on more than one stage: a group of the
        stages using it (every process makes every such group, as
        ``new_group`` needs), the owner's weights broadcast over it, the
        copies off the owner marked. Returns this stage's (parameters,
        group) pairs."""
        if pp == 1:
            return []
        from ...communication.group import new_group
        topo, hcg = self._hcg.topology(), self._hcg
        out = []
        for key, owner in first.items():
            uses = [i for i, d in enumerate(self.descs)
                    if isinstance(d, SharedLayerDesc) and d.layer_name == key]
            stages = sorted({self._stage_of(i) for i in uses})
            if len(stages) < 2:
                continue
            mine_group = None
            for comm in topo.get_comm_list("pipe"):
                g = new_group([comm[s] for s in stages])
                if g.is_member():
                    mine_group = g
            if mine_group is None:
                continue
            params = list(self.run_function[owner].parameters())
            src = hcg.get_rank_from_stage(self._stage_of(owner))
            _broadcast_from(params, src, mine_group)
            if owner not in mine:
                for p in params:
                    p._pp_shared_copy = True
            out.append((params, mine_group))
        return out

    def _stage_of(self, idx):
        for c, part in enumerate(self.chunk_parts):
            if idx in part:
                return c % self._num_stages
        return self._num_stages - 1

    def shared_weight_groups(self):
        """This stage's shared weights used on other stages too: a list of
        (parameters, ``Group`` of the stages using them)."""
        return self._shared_groups

    def allreduce_shared_weight_gradients(self):
        from ..utils.hybrid_parallel_util import \
            allreduce_shared_weight_gradients
        allreduce_shared_weight_gradients(self._shared_groups)

    def get_stage_from_index(self, idx):
        for s, part in enumerate(self.segment_parts):
            if idx in part:
                return s
        return self._num_stages - 1

    def stage_layers(self, stage_id):
        """The built layers of stage ``stage_id``'s segment."""
        return [self.run_function[i] for i in self.segment_parts[stage_id]
                if i in self.run_function]

    def chunk_count(self):
        """The number of chunks this stage runs (v, or 1 at pp 1)."""
        return len(self._chunks)

    def forward(self, x, *, chunk=None):
        """``x`` through this stage's layers: chunk ``chunk`` of them, or
        (None) all of them in order (the whole model at pp 1)."""
        idx = (self._chunks[chunk] if chunk is not None
               else [i for c in self._chunks for i in c])
        for i in idx:
            layer = self.run_function[i]
            x = layer(*x) if isinstance(x, tuple) else layer(x)
        return x

    def loss(self, output, label):
        if self._loss_fn is None:
            return output
        return self._loss_fn(output, label)


@torch.no_grad()
def _broadcast_from(params, src, group):
    from ...communication.ops import _broadcast
    for p in params:
        _broadcast(p, src, group)


class _FnLayer(nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self._fn = fn

    def forward(self, *args):
        return self._fn(*args)


class _SharedForward(nn.Module):
    """A later occurrence of a ``SharedLayerDesc``: the first one's layer
    (held unregistered) through ``forward_func``."""

    def __init__(self, shared_layer, forward_func):
        super().__init__()
        self._shared_layer_ref = [shared_layer]
        self._forward_func = forward_func

    def forward(self, *args):
        layer = self._shared_layer_ref[0]
        if self._forward_func is not None:
            return self._forward_func(layer, *args)
        return layer(*args)
