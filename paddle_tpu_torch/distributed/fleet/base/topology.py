"""Hybrid-parallel topology over ``torch.distributed`` process groups.

Counterpart of ``paddle_tpu/distributed/fleet/base/topology.py``:
``CommunicateTopology`` maps ranks to (data, pipe, sharding, sep, model)
coordinates (pure host code, copied), and ``HybridCommunicateGroup``
builds the groups. Which of two kinds it builds depends on the launched
world alone (``launched_world``): one process with a model degree above
1 and every other degree 1 gets PR 22's single-controller serving mesh
(``parallel.serving_mesh.ServingMesh``), as JAX's ``fleet.init`` builds
one process's mesh over its devices, and this process is rank 0 of the
``mp`` shards; any other topology needs one process per rank, and each
of its five axes gets the process groups of JAX's rank map
(``get_comm_list``: the ranks that differ in that coordinate alone), as
the rows of a ``DeviceMesh`` with the JAX mesh's axes in its order
("pp", "dp", "sharding", "sep", "mp"). The GroupSharded stages shard
over "sharding", dp and sharding both consume distinct data, fleet's
model-parallel layers split over "mp", and the pipeline's point-to-point
calls run over "pp".
"""
from __future__ import annotations

import itertools
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["CommunicateTopology", "HybridCommunicateGroup", "_HYBRID_GROUP",
           "launched_world", "serving_degrees", "check_world"]

# the active HybridCommunicateGroup (parallel.current_mesh reads its mesh)
_HYBRID_GROUP = [None]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "sep",
                                           "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = itertools.product(*map(range, self._dims))
        self._world_size = int(np.prod(self._dims))
        ranks = np.arange(self._world_size).reshape(self._dims)
        self._rank_map = ranks
        self._coord_of = {int(r): tuple(c) for c, r in np.ndenumerate(ranks)}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **kwargs):
        coord = tuple(kwargs[name] for name in self._parallel_names)
        return int(self._rank_map[coord])

    def get_coord(self, rank):
        return self._coord_of[rank]

    def get_axis_list(self, axis_name, index):
        """All ranks whose coordinate on axis == index."""
        ax = self._parallel_names.index(axis_name)
        sel = [slice(None)] * len(self._dims)
        sel[ax] = index
        return sorted(int(r) for r in self._rank_map[tuple(sel)].reshape(-1))

    def get_comm_list(self, axis_name):
        """List of rank-groups along axis (vary axis, fix others)."""
        ax = self._parallel_names.index(axis_name)
        moved = np.moveaxis(self._rank_map, ax, -1)
        return [sorted(int(r) for r in row)
                for row in moved.reshape(-1, self._dims[ax])]

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = list(self.get_coord(global_rank))
        for k, v in kwargs.items():
            coord[self._parallel_names.index(k)] = v
        return int(self._rank_map[tuple(coord)])


# paddle axis name -> mesh axis name
_AXIS_MAP = {"data": "dp", "pipe": "pp", "sharding": "sharding",
             "sep": "sep", "model": "mp"}
# the mesh's axes, outer to inner (the JAX mesh's order)
_MESH_AXES = ("pp", "dp", "sharding", "sep", "mp")


def launched_world() -> int:
    """The number of processes the job was launched with: the initialised
    default group's size, else ``WORLD_SIZE`` (1 without either)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def serving_degrees(degrees, world) -> bool:
    """Whether ``degrees`` (mesh axis -> degree) over ``world`` processes
    is PR 22's serving mesh: a model degree above 1, every other degree
    1, one process."""
    return degrees["mp"] > 1 and world == 1 and all(
        d == 1 for a, d in degrees.items() if a != "mp")


def check_world(degrees, world):
    """Refuse a topology of several ranks in one process other than the
    serving mesh: JAX runs it as one controller over a mesh of devices,
    the port as a process per rank."""
    n = int(np.prod(list(degrees.values())))
    if world == 1 and n > 1 and not serving_degrees(degrees, world):
        raise NotImplementedError(
            f"fleet: the hybrid degrees {degrees} in one process (JAX's "
            "single-controller mesh) are not ported (ROADMAP Queue 1 item "
            f"10(e)); launch {n} processes, one a rank, or run mp alone "
            "for serving")


class HybridCommunicateGroup:
    """The hybrid topology, made the active group. Two kinds, picked by
    the launched world (never by the model):

    - one process with a model degree above 1 and every other degree 1:
      the single-controller serving mesh (``parallel.serving_mesh``) over
      ``devices`` (default the first ``mp`` devices of ``device_type``);
      this process is rank 0 of the ``mp`` shards;
    - otherwise a process per rank: the default process group must hold
      ``topology.world_size()`` processes, and every axis, mp and pp
      included, gets its process groups from JAX's rank map
      (``CommunicateTopology.get_comm_list``), as the rows of a
      ``DeviceMesh`` with the axes ("pp", "dp", "sharding", "sep", "mp")
      (NCCL on the card, gloo on the CPU)."""

    def __init__(self, topology: CommunicateTopology, *,
                 device_type="cuda", devices=None):
        self.nranks = topology.world_size()
        names = topology.get_hybrid_group_names()
        degrees = {axis: topology.get_dim(name) if name in names else 1
                   for name, axis in _AXIS_MAP.items()}
        world = launched_world()
        self._topo = topology
        self._dp_degree = degrees["dp"]
        self._pp_degree = degrees["pp"]
        self._sharding_degree = degrees["sharding"]
        self._sep_degree = degrees["sep"]
        self._mp_degree = degrees["mp"]
        self._serving = serving_degrees(degrees, world)
        if self._serving:
            from ....parallel.serving_mesh import ControllerGroup, ServingMesh
            if devices is None:
                devices = [f"{device_type}:{i}" if device_type == "cuda"
                           else device_type
                           for i in range(self._mp_degree)]
            if len(devices) != self._mp_degree:
                raise ValueError(
                    f"fleet: mp_degree {self._mp_degree} needs as many "
                    f"devices, got {len(devices)}")
            self._mesh = ServingMesh(devices)
            self._mp_group = ControllerGroup(self._mesh)
            self.global_rank = 0
            _HYBRID_GROUP[0] = self
            return
        check_world(degrees, world)
        if world != self.nranks:
            raise ValueError(
                f"fleet: the hybrid degrees {degrees} need {self.nranks} "
                f"processes, the process group has {world}")
        # JAX's rank map (data, pipe, sharding, sep, model), its axes put
        # in the mesh's order: each mesh row is a get_comm_list group
        order = [list(_AXIS_MAP.values()).index(a) for a in _MESH_AXES]
        ranks = np.arange(self.nranks).reshape(
            [degrees[a] for a in _AXIS_MAP.values()]).transpose(order)
        self._mesh = DeviceMesh(device_type, torch.from_numpy(ranks.copy()),
                                mesh_dim_names=_MESH_AXES)
        self._mp_group = None
        self.global_rank = dist.get_rank()
        _HYBRID_GROUP[0] = self

    @property
    def mesh(self):
        return self._mesh

    def get_parallel_mode(self):
        if self._mp_degree == 1 and self._pp_degree == 1 and \
                self._sharding_degree == 1 and self._dp_degree > 1:
            return "data_parallel"
        if self._sharding_degree > 1 and self._mp_degree == 1 and \
                self._pp_degree == 1:
            return "sharding_parallel"
        if self._mp_degree > 1 and self._pp_degree == 1:
            return "tensor_parallel"
        if self._pp_degree > 1:
            return "pipeline_parallel"
        return "data_parallel"

    def topology(self):
        return self._topo

    def get_global_rank(self):
        """This process's rank (0 for the serving mesh's controller)."""
        return self.global_rank

    def _coord(self):
        return dict(zip(self._topo.get_hybrid_group_names(),
                        self._topo.get_coord(self.global_rank)))

    def _local_rank(self, axis):
        if self._serving:
            return 0
        return self._mesh.get_local_rank(axis)

    def _group(self, axis):
        return self._mesh.get_group(axis)

    def _src_rank(self, axis):
        return dist.get_process_group_ranks(self._group(axis))[0]

    # data parallel
    def get_data_parallel_rank(self):
        return self._local_rank("dp")

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._group("dp")

    def get_data_parallel_group_src_rank(self):
        return self._src_rank("dp")

    # model (tensor) parallel: the serving mesh's controller group, or
    # this process's mp group
    def get_model_parallel_rank(self):
        return self._local_rank("mp")

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._mp_group if self._serving else self._group("mp")

    def get_model_parallel_group_src_rank(self):
        return 0 if self._serving else self._src_rank("mp")

    def is_serving_mesh(self) -> bool:
        """Whether this is the single-controller serving mesh (no process
        group per axis)."""
        return self._serving

    # pipeline
    def get_stage_id(self):
        return self._local_rank("pp")

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._group("pp")

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    def get_p2p_groups(self):
        """None, as in JAX: the stages' point-to-point calls go over the
        pipe group (``get_pipe_parallel_group``)."""
        return None

    def get_rank_from_stage(self, stage_id, **kwargs):
        """The global rank of ``stage_id`` with this process's other
        coordinates (``kwargs`` overrides any of them by Paddle's axis
        name)."""
        return self._topo.get_rank_from_stage(self.global_rank,
                                              pipe=stage_id, **kwargs)

    # sharding
    def get_sharding_parallel_rank(self):
        return self._local_rank("sharding")

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._group("sharding")

    def get_sharding_parallel_group_src_rank(self):
        return self._src_rank("sharding")

    # sep (sequence / context parallel)
    def get_sep_parallel_rank(self):
        return self._local_rank("sep")

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_group(self):
        return self._group("sep")

    # fused comm checks
    def get_check_parallel_group(self, *a, **k):
        return self.get_model_parallel_group()
