"""paddle.distributed.spawn. Counterpart of
``paddle_tpu/distributed/spawn_mod.py``.

Starts ``func(*args)`` in ``nprocs`` processes (the ``spawn`` start
method) under ``torch.distributed``'s ``env://`` contract (``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and
Paddle's (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_MASTER``), so that ``init_parallel_env`` in each child joins one
group; the rendezvous is on a free port of localhost. With ``join`` it
waits for them and raises if one exits non-zero.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import socket
from typing import Callable

__all__ = ["spawn"]


def _find_free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(fn, rank, nprocs, port, args):
    os.environ.update({
        "RANK": str(rank), "LOCAL_RANK": str(rank),
        "WORLD_SIZE": str(nprocs), "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(port), "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_LOCAL_RANK": str(rank), "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_MASTER": f"127.0.0.1:{port}"})
    fn(*args)


def spawn(func: Callable, args=(), nprocs: int = 1, join: bool = True,
          daemon: bool = False, **options):
    """Returns the processes (None for ``nprocs`` 1, which runs ``func``
    here)."""
    if nprocs <= 1:
        func(*args)
        return None
    ctx = mp.get_context("spawn")
    port = _find_free_port()
    procs = [ctx.Process(target=_worker,
                         args=(func, rank, nprocs, port, args),
                         daemon=daemon) for rank in range(nprocs)]
    for p in procs:
        p.start()
    if join:
        for p in procs:
            p.join()
        bad = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"spawned processes exited non-zero "
                               f"(rank, code): {bad}")
    return procs
