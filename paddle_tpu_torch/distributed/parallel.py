"""The parallel environment on ``torch.distributed``. Counterpart of
``paddle_tpu/distributed/parallel.py``'s ``init_parallel_env``,
``get_rank``, ``get_world_size``, ``ParallelEnv`` and
``all_reduce_gradients``.

A process joins the default process group that its launcher describes
(``torch.distributed``'s ``env://``: ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``), or uses the one the caller already
initialised (a test's ``FileStore``); without either it starts a group of
one. The device follows the port's rule: the card (``cuda:LOCAL_RANK``,
over NCCL) unless the caller asks for the CPU (over gloo).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
           "all_reduce_gradients"]

_state = {"device": None}


def init_parallel_env(*, device=None) -> torch.device:
    """Join or start the default process group (NCCL on the card, gloo on
    the CPU) and return this process's device (``device`` None: the
    card). A group initialised beforehand is kept as it is."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    _state["device"] = dev
    return dev


def _pg(group):
    return getattr(group, "pg", group)


def get_rank(group=None) -> int:
    """This process's rank in ``group`` (a ``Group`` or a torch
    ProcessGroup; default: the world); 0 before the environment is
    initialised."""
    return dist.get_rank(_pg(group)) if dist.is_initialized() else 0


def get_world_size(group=None) -> int:
    """The number of processes in ``group`` (default: the world); 1 before
    the environment is initialised."""
    return dist.get_world_size(_pg(group)) if dist.is_initialized() else 1


class ParallelEnv:
    """This process's place in the job, from the process group and the
    launcher's environment (``LOCAL_RANK`` or ``PADDLE_LOCAL_RANK``,
    ``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``)."""

    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def world_size(self) -> int:
        return get_world_size()

    @property
    def local_rank(self) -> int:
        return int(os.environ.get("LOCAL_RANK",
                                  os.environ.get("PADDLE_LOCAL_RANK", "0")))

    @property
    def nranks(self) -> int:
        return get_world_size()

    @property
    def dev_id(self) -> int:
        return self.local_rank

    @property
    def device_type(self) -> str:
        dev = _state["device"]
        return "gpu" if dev is not None and dev.type == "cuda" else "cpu"

    @property
    def trainer_endpoints(self) -> list:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []

    @property
    def current_endpoint(self) -> str:
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "")


@torch.no_grad()
def all_reduce_gradients(params, group=None):
    """Mean-all-reduce every ``.grad`` of ``params`` over ``group``
    (default every process), one all-reduce a gradient; nothing at a
    world of one, as in JAX."""
    ws = get_world_size(group)
    if ws <= 1:
        return
    from .communication.all_reduce import all_reduce
    for p in params:
        if p.grad is not None:
            all_reduce(p.grad, group=group)
            p.grad.div_(ws)
