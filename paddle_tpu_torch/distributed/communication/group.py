"""Process groups over ``torch.distributed``. Counterpart of
``paddle_tpu/distributed/communication/group.py``.

JAX's ``ProcessGroupXLA`` runs each collective as a compiled XLA program
over a device mesh; here a ``Group`` wraps a ``torch.distributed``
ProcessGroup (NCCL on the card, gloo on the CPU), and ``Task`` wraps the
work handle of an asynchronous call. Every collective of ``ops`` takes
a ``Group``, a torch ProcessGroup (what the fleet topology's
``get_*_parallel_group`` return) or None for the default group.

The collectives need an initialised default group
(``init_parallel_env`` or ``fleet.init``): a world of one runs them too,
over its one-rank group.
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist

__all__ = ["ReduceOp", "Group", "Task", "new_group", "get_group",
           "destroy_process_group", "is_initialized", "wait"]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


class Task:
    """The work handle of one collective: ``wait`` blocks until it is
    done (a synchronous call's task is done already)."""

    def __init__(self, result=None):
        self._result = result

    def wait(self, timeout=None):
        if self._result is not None and hasattr(self._result, "wait"):
            self._result.wait()
        return True

    def is_completed(self):
        if self._result is not None and hasattr(self._result,
                                                "is_completed"):
            return self._result.is_completed()
        return True

    def synchronize(self):
        self.wait()


class Group:
    """A communicator: this process's rank in it (-1 where it is not a
    member), its id, its global ranks and its torch ProcessGroup."""

    def __init__(self, rank_in_group, group_id, ranks, pg=None, name=None):
        self.rank = rank_in_group
        self.id = group_id
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.pg = pg if pg is not None else dist.group.WORLD
        self.name = name or f"group_{group_id}"

    @property
    def process_group(self):
        return self.pg

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, global_rank):
        return (self.ranks.index(global_rank) if global_rank in self.ranks
                else -1)

    def is_member(self):
        return self.rank >= 0

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


_groups: dict[int, Group] = {}
_next_id = [0]


def _require_init():
    if not dist.is_initialized():
        raise RuntimeError(
            "paddle.distributed: no process group; call "
            "distributed.init_parallel_env() or fleet.init() first")


def _default_group() -> Group:
    """The group of every process (id 0), made at first use."""
    _require_init()
    g = _groups.get(0)
    if g is None or g.pg is not dist.group.WORLD:
        ws = dist.get_world_size()
        g = _groups[0] = Group(dist.get_rank(), 0, range(ws),
                               dist.group.WORLD, name="_default_pg")
    return g


def as_group(group) -> Group:
    """``group`` as a ``Group``: None is the default group, a torch
    ProcessGroup is wrapped (its global ranks from torch)."""
    if group is None:
        return _default_group()
    if isinstance(group, Group):
        return group
    _require_init()
    ranks = dist.get_process_group_ranks(group)
    me = dist.get_rank()
    return Group(ranks.index(me) if me in ranks else -1, -1, ranks, group)


def new_group(ranks=None, backend=None, timeout=None, axis_name=None,
              mesh=None) -> Group:
    """A group over the global ``ranks`` (default every process). As
    ``torch.distributed.new_group``, every process of the default group
    makes the call, members or not. With a ``mesh`` (a torch
    ``DeviceMesh``) and its ``axis_name``, the group is that axis's one
    that holds this process, and ``ranks`` must be its ranks."""
    _require_init()
    if ranks is None:
        ranks = list(range(dist.get_world_size()))
    ranks = [int(r) for r in ranks]
    if mesh is not None and axis_name is not None:
        pg = mesh.get_group(axis_name)
        if dist.get_process_group_ranks(pg) != ranks:
            raise ValueError(
                f"new_group: the mesh's {axis_name!r} group holds "
                f"{dist.get_process_group_ranks(pg)}, not {ranks}")
    else:
        kw = {"backend": backend.lower()} if backend else {}
        if timeout is not None:
            kw["timeout"] = timeout
        pg = dist.new_group(ranks, **kw)
    _next_id[0] += 1
    gid = _next_id[0]
    me = dist.get_rank()
    g = Group(ranks.index(me) if me in ranks else -1, gid, ranks, pg)
    _groups[gid] = g
    return g


def get_group(gid: int = 0) -> Optional[Group]:
    if gid == 0 and dist.is_initialized():
        return _default_group()
    return _groups.get(gid)


def destroy_process_group(group=None):
    """Forget ``group`` (None: every group, and the default process group
    is destroyed)."""
    if group is None:
        _groups.clear()
        if dist.is_initialized():
            dist.destroy_process_group()
        return
    _groups.pop(group.id, None)
    if group.pg is not dist.group.WORLD and group.is_member():
        dist.destroy_process_group(group.pg)


def is_initialized() -> bool:
    return dist.is_initialized()


def wait(tensor, group=None, use_calc_stream=True):
    """Block until the work queued on ``tensor``'s device is done."""
    if tensor.is_cuda:
        import torch
        torch.cuda.current_stream(tensor.device).synchronize()
