"""Hybrid-parallel topology over a ``torch.distributed`` device mesh.

Counterpart of ``paddle_tpu/distributed/fleet/base/topology.py``:
``CommunicateTopology`` maps ranks to (data, pipe, sharding, sep, model)
coordinates (pure host code, copied), and ``HybridCommunicateGroup``
builds the mesh. A data / sep topology gets a ``DeviceMesh`` from
``init_device_mesh`` with the JAX mesh's axes in its order, ("pp", "dp",
"sharding", "sep", "mp"), and one process group per axis. A model degree
above 1 with every other degree 1 gets the single-controller serving
mesh (``parallel.serving_mesh.ServingMesh``), as JAX's ``fleet.init``
builds one process's mesh over its devices: this process is rank 0 of
the ``mp`` shards. A data / sharding / sep topology's groups are the
process groups of its ``DeviceMesh`` axes (the GroupSharded stages shard
over "sharding", and dp and sharding both consume distinct data). A
pipeline degree above 1, and a model degree combined with another degree
or spread over processes, raise until ROADMAP Queue 1 item 10(e) ports
fleet's model-parallel layers and pipeline parallelism.
"""
from __future__ import annotations

import itertools
import os

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

__all__ = ["CommunicateTopology", "HybridCommunicateGroup", "_HYBRID_GROUP"]

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
# axes the port does not run yet -> their ROADMAP Queue 1 item
_NOT_PORTED = {"pp": "10(e)"}


class HybridCommunicateGroup:
    """The hybrid mesh over the default process group's ranks, on
    ``device_type`` ("cuda" or "cpu"); becomes the active group. Under a
    model degree above 1 (every other degree 1, one process) it is the
    serving mesh over ``devices`` (default: the first ``mp`` visible
    devices of ``device_type``)."""

    def __init__(self, topology: CommunicateTopology, *,
                 device_type="cuda", devices=None):
        self.nranks = topology.world_size()
        names = topology.get_hybrid_group_names()
        degrees = {axis: topology.get_dim(name) if name in names else 1
                   for name, axis in _AXIS_MAP.items()}
        for axis, item in _NOT_PORTED.items():
            if degrees[axis] > 1:
                raise NotImplementedError(
                    f"fleet: {axis}_degree {degrees[axis]} is not ported "
                    f"yet (ROADMAP Queue 1 item {item}); the port runs "
                    "dp, sharding, sep, and mp alone for serving")
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", "1")))
        self._topo = topology
        self._dp_degree = degrees["dp"]
        self._pp_degree = degrees["pp"]
        self._sharding_degree = degrees["sharding"]
        self._sep_degree = degrees["sep"]
        self._mp_degree = degrees["mp"]
        if self._mp_degree > 1:
            if self.nranks != self._mp_degree or world != 1:
                raise NotImplementedError(
                    f"fleet: mp_degree {self._mp_degree} with the degrees "
                    f"{degrees} over {world} processes is not ported yet "
                    "(ROADMAP Queue 1 item 10(e), fleet's model-parallel "
                    "layers); the port's model degree is one controller "
                    "over the serving mesh, with every other degree 1")
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
            _HYBRID_GROUP[0] = self
            return
        if world != self.nranks:
            raise ValueError(
                f"fleet: the hybrid degrees {degrees} need {self.nranks} "
                f"processes, the process group has {world}")
        self._mesh = init_device_mesh(
            device_type, tuple(degrees[a] for a in _MESH_AXES),
            mesh_dim_names=_MESH_AXES)
        self._mp_group = None
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
        if self._mp_group is not None or not dist.is_initialized():
            return 0
        return dist.get_rank()

    def _local_rank(self, axis):
        if self._mp_group is not None:
            return 0
        return self._mesh.get_local_rank(axis)

    def _src_rank(self, axis):
        return dist.get_process_group_ranks(self._mesh.get_group(axis))[0]

    # data parallel
    def get_data_parallel_rank(self):
        return self._local_rank("dp")

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._mesh.get_group("dp")

    def get_data_parallel_group_src_rank(self):
        return self._src_rank("dp")

    # pipeline (a degree above 1 is refused)
    def get_stage_id(self):
        return 0

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def is_first_stage(self):
        return True

    def is_last_stage(self):
        return True

    # sharding
    def get_sharding_parallel_rank(self):
        return self._local_rank("sharding")

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._mesh.get_group("sharding")

    def get_sharding_parallel_group_src_rank(self):
        return self._src_rank("sharding")

    # model (tensor) parallel: the controller's view of the serving mesh
    def get_model_parallel_rank(self):
        return 0

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._mp_group

    # sep (sequence / context parallel)
    def get_sep_parallel_rank(self):
        return self._local_rank("sep")

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_group(self):
        return self._mesh.get_group("sep")
