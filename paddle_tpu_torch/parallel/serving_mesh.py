"""The single-controller serving mesh and the sharded tensors it holds.

The JAX package gets both from ``jax.sharding``: a ``Mesh`` with an
``mp`` axis, ``NamedSharding`` placements and the GSPMD partial-sum
all-reduce. The port keeps one process that drives ``mp`` shards, as
JAX's serving engine does:

- ``ServingMesh``: the devices of the shards, shard ``i`` on
  ``devices[i]`` (several shards may share one card), and the degree
  ``shape["mp"]`` (the other hybrid axes are 1);
- ``ShardedTensor``: one logical tensor as one contiguous local tensor
  per shard, split on one axis (``axis``) or replicated (``axis`` None:
  one copy per distinct device, shared by the shards that sit on it);
- ``all_reduce``: the row-parallel reduce, the partials summed in shard
  order in their dtype on the first shard's device (a sum of tensors
  where the shards share a device, a peer copy and a sum across cards);
  the controller runs the layer's replicated part there and hands each
  shard its next input;
- ``ControllerGroup``: the model-parallel group as the controller sees
  it (rank 0 of ``mp``).
"""
from __future__ import annotations

import math

import torch

__all__ = ["ServingMesh", "ShardedTensor", "ControllerGroup", "all_reduce",
           "MESH_AXES"]

# the hybrid mesh's axes, outer to inner (the JAX mesh's order)
MESH_AXES = ("pp", "dp", "sharding", "sep", "mp")


class ServingMesh:
    """A tensor-parallel mesh of ``len(devices)`` shards; shard ``i`` runs
    on ``devices[i]``."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("ServingMesh needs at least one device")
        self.shape = {a: 1 for a in MESH_AXES}
        self.shape["mp"] = len(self.devices)


class ControllerGroup:
    """The model-parallel group of a single controller: it holds every
    rank of the mesh and is rank 0 of them."""

    def __init__(self, mesh, name="model_group"):
        self.mesh = mesh
        self.name = name
        self.nranks = mesh.shape["mp"]
        self.ranks = list(range(self.nranks))
        self.rank = 0


class ShardedTensor:
    """A tensor of logical shape ``shape`` held as ``shards``, one
    contiguous tensor per shard of the mesh, each on its shard's device:
    the slice ``i`` of ``axis`` split in equal parts, or (``axis`` None)
    the whole tensor."""

    __slots__ = ("shards", "shape", "axis")

    def __init__(self, shards, shape, axis=None):
        self.shards = list(shards)
        self.shape = torch.Size(shape)
        self.axis = axis

    @classmethod
    def split(cls, t, axis, devices):
        """``t`` split in ``len(devices)`` equal parts along ``axis``, each
        copied into storage of its own on its device."""
        n = len(devices)
        axis = axis % t.dim()
        if t.shape[axis] % n:
            raise ValueError(f"ShardedTensor.split: axis {axis} of "
                             f"{tuple(t.shape)} does not divide {n}")
        shards = []
        for piece, d in zip(t.tensor_split(n, axis), devices):
            out = torch.empty(piece.shape, dtype=t.dtype, device=d)
            shards.append(out.copy_(piece))
        return cls(shards, t.shape, axis)

    @classmethod
    def replicate(cls, t, devices):
        """``t`` on every device: one copy per distinct device (``t``
        itself where it already lies there)."""
        copies = {}
        for d in devices:
            if d not in copies:
                copies[d] = t.to(d)
        return cls([copies[d] for d in devices], t.shape, None)

    @classmethod
    def zeros(cls, shape, axis, dtype, devices):
        """Zeros of logical ``shape`` split along ``axis``, each shard its
        own contiguous tensor."""
        local = list(shape)
        local[axis] //= len(devices)
        return cls([torch.zeros(local, dtype=dtype, device=d)
                    for d in devices], shape, axis)

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def device(self):
        """The first shard's device (the controller's)."""
        return self.shards[0].device

    @property
    def devices(self):
        return [s.device for s in self.shards]

    def dim(self):
        return len(self.shape)

    def element_size(self):
        return self.shards[0].element_size()

    @property
    def nbytes(self):
        """The logical tensor's bytes (the shards' sum when it is split)."""
        return math.prod(self.shape) * self.element_size()

    def shard_shape(self):
        """The local shape each shard holds (JAX's
        ``sharding.shard_shape``): the full shape when replicated."""
        return tuple(self.shards[0].shape)

    def gather(self, device=None):
        """The full tensor on ``device`` (default the first shard's)."""
        device = device or self.device
        if self.axis is None:
            return self.shards[0].to(device)
        return torch.cat([s.to(device) for s in self.shards], self.axis)

    def __repr__(self):
        return (f"ShardedTensor(shape={tuple(self.shape)}, axis={self.axis},"
                f" shards={len(self.shards)}, dtype={self.dtype})")


def all_reduce(parts):
    """The row-parallel reduce: ``parts`` (one partial a shard, in shard
    order) summed in that order in their dtype, on the first part's
    device."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(acc.device)
    return acc
