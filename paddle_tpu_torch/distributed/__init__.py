"""paddle.distributed's surface in the port: the parallel environment on
``torch.distributed`` and ``fleet``'s hybrid topology (the slice that
builds a ``sep`` mesh for context parallelism).

Counterpart of ``paddle_tpu/distributed/__init__.py``; the collectives,
groups, checkpointing, launch and resilience stay with ROADMAP Queue 1
item 10(e).
"""
from __future__ import annotations

from . import fleet
from .parallel import get_rank, get_world_size, init_parallel_env

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "fleet"]
