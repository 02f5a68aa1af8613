"""The parallel environment on ``torch.distributed``. Counterpart of
``paddle_tpu/distributed/parallel.py``'s ``init_parallel_env``,
``get_rank`` and ``get_world_size``.

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

__all__ = ["init_parallel_env", "get_rank", "get_world_size"]

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


def get_rank(group=None) -> int:
    """This process's rank in ``group`` (default: the world); 0 before
    the environment is initialised."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def get_world_size(group=None) -> int:
    """The number of processes in ``group`` (default: the world); 1 before
    the environment is initialised."""
    return dist.get_world_size(group) if dist.is_initialized() else 1
