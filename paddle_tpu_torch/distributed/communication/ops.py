"""The collective API over ``torch.distributed``. Counterpart of
``paddle_tpu/distributed/communication/ops.py``.

Each op keeps Paddle's in-place semantics (the result is written into
the tensor or list it is given) and runs on the group's backend: NCCL
for tensors on the card, gloo on the CPU. ``src`` / ``dst`` / ``peer``
are global ranks, as in Paddle (a send to oneself is a copy into the
matching receive, as a ppermute's (r, r) pair is). ``sync_op=False``
returns a ``Task`` over the pending work; otherwise the op has
completed (on the card: has been queued on the current stream) when it
returns.

Every call adds one to ``COLLECTIVES[<op>]`` and to
``COLLECTIVE_BACKENDS[<backend>]`` ("nccl" or "gloo"), kept like the
kernels' ``LAUNCHES``: the gradient reductions, gathers and broadcasts
of ``DataParallel`` and the GroupSharded stages go through the same
counted calls, so a training step's count can be held to its design.
``all_reduce`` with ``AVG`` is NCCL's own average on the card; gloo has
none, so there it is the SUM divided by the group's size, in the
tensor's dtype.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .group import ReduceOp, Task, as_group

__all__ = ["all_gather", "all_gather_object", "broadcast",
           "broadcast_object_list", "reduce", "scatter",
           "scatter_object_list", "gather", "alltoall", "alltoall_single",
           "send", "recv", "isend", "irecv", "P2POp", "batch_isend_irecv",
           "barrier", "reduce_scatter", "get_backend", "stream",
           "COLLECTIVES", "COLLECTIVE_BACKENDS", "reset_collectives"]

# calls by op name, and by backend, since the last reset_collectives()
COLLECTIVES: dict[str, int] = {}
COLLECTIVE_BACKENDS: dict[str, int] = {}

_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}


def reset_collectives():
    COLLECTIVES.clear()
    COLLECTIVE_BACKENDS.clear()


def _count(op, g):
    backend = str(dist.get_backend(g.pg)).lower()
    COLLECTIVES[op] = COLLECTIVES.get(op, 0) + 1
    COLLECTIVE_BACKENDS[backend] = COLLECTIVE_BACKENDS.get(backend, 0) + 1
    return backend


def _native_avg(backend):
    return backend == "nccl"


def _torch_op(op, backend):
    if op == ReduceOp.AVG:
        return dist.ReduceOp.AVG if _native_avg(backend) else \
            dist.ReduceOp.SUM
    return _TORCH_OPS[op]


def _divide(tensor, n):
    """The SUM of an AVG divided by the group's size, in its dtype."""
    if tensor.is_floating_point() or tensor.is_complex():
        tensor.div_(n)
    else:
        tensor.copy_(torch.div(tensor, n, rounding_mode="floor"))


def _task(work, sync_op):
    if sync_op:
        if work is not None:
            work.wait()
        return Task()
    return Task(work)


def _all_reduce(tensor, op, g, sync_op=True):
    backend = _count("all_reduce", g)
    avg = op == ReduceOp.AVG and not _native_avg(backend)
    work = dist.all_reduce(tensor, op=_torch_op(op, backend), group=g.pg,
                           async_op=not sync_op and not avg)
    if avg:
        _divide(tensor, g.nranks)
        return Task()
    return _task(work, sync_op)


def _reduce_scatter_flat(out, inp, g, op=ReduceOp.SUM, sync_op=True):
    """``out`` (contiguous) = this rank's chunk of the reduction of
    ``inp`` (``nranks`` chunks of ``out``'s size, flat) over ``g``."""
    backend = _count("reduce_scatter", g)
    avg = op == ReduceOp.AVG and not _native_avg(backend)
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    work = fn(out.view(-1), inp.reshape(-1), op=_torch_op(op, backend),
              group=g.pg, async_op=not sync_op and not avg)
    if avg:
        _divide(out, g.nranks)
        return Task()
    return _task(work, sync_op)


def _all_gather_flat(out, inp, g, sync_op=True):
    """``out`` (contiguous, ``nranks`` chunks of ``inp``'s size, flat) =
    every rank's ``inp`` in rank order."""
    _count("all_gather", g)
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    return _task(fn(out.view(-1), inp.reshape(-1), group=g.pg,
                    async_op=not sync_op), sync_op)


def _broadcast(tensor, src, g, sync_op=True):
    _count("broadcast", g)
    return _task(dist.broadcast(tensor, src=src, group=g.pg,
                                async_op=not sync_op), sync_op)


@torch.no_grad()
def _sync_from_first(tensors, *groups):
    """Broadcast ``tensors`` from the first rank of each group in turn (a
    group that is None or of one rank skipped): every rank of them ends
    with that rank's values (the reference's ``sync_params_buffers``)."""
    for g in groups:
        if g is None or g.nranks == 1:
            continue
        for t in tensors:
            _broadcast(t, g.ranks[0], g)


def _sync_model(model, *groups):
    """``_sync_from_first`` of the model's parameters and floating
    buffers."""
    _sync_from_first([*model.parameters(), *(
        b for b in model.buffers() if b.is_floating_point())], *groups)


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """``tensor_list`` becomes every rank's ``tensor``, in group-rank
    order."""
    g = as_group(group)
    buf = torch.empty((g.nranks, *tensor.shape), dtype=tensor.dtype,
                      device=tensor.device)
    task = _all_gather_flat(buf, tensor, g, True)
    tensor_list.clear()
    tensor_list.extend(buf.unbind(0))
    return task


def all_gather_object(object_list, obj, group=None):
    g = as_group(group)
    _count("all_gather_object", g)
    out = [None] * g.nranks
    dist.all_gather_object(out, obj, group=g.pg)
    object_list.clear()
    object_list.extend(out)


def broadcast(tensor, src=0, group=None, sync_op=True):
    return _broadcast(tensor, src, as_group(group), sync_op)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Only ``dst`` receives the reduction; the other ranks' tensors are
    left as they were. A process outside the group does nothing."""
    g = as_group(group)
    if not g.is_member():
        return Task()
    if g.get_group_rank(dst) < 0:
        raise ValueError(f"reduce: dst rank {dst} is not in the group")
    backend = _count("reduce", g)
    mine = dist.get_rank() == dst
    buf = tensor if mine else tensor.clone()
    dist.reduce(buf, dst=dst, op=_torch_op(op, backend), group=g.pg)
    if mine and op == ReduceOp.AVG and not _native_avg(backend):
        _divide(tensor, g.nranks)
    return Task()


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """``tensor`` becomes ``src``'s ``tensor_list[group rank]``."""
    g = as_group(group)
    _count("scatter", g)
    mine = dist.get_rank() == src
    work = dist.scatter(tensor, list(tensor_list) if mine else None,
                        src=src, group=g.pg, async_op=not sync_op)
    return _task(work, sync_op)


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """``dst``'s ``gather_list`` becomes every rank's ``tensor``; the
    other ranks' lists are left as they were."""
    g = as_group(group)
    if not g.is_member():
        return Task()
    if g.get_group_rank(dst) < 0:
        raise ValueError(f"dst {dst} is not in the group")
    _count("gather", g)
    mine = dist.get_rank() == dst
    outs = [torch.empty_like(tensor) for _ in range(g.nranks)] if mine \
        else None
    dist.gather(tensor, outs, dst=dst, group=g.pg)
    if mine and gather_list is not None:
        gather_list.clear()
        gather_list.extend(outs)
    return Task()


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """Rank i's ``in_tensor_list[j]`` lands in rank j's
    ``out_tensor_list[i]``. Given one tensor, its dim-0 chunks are the
    list, and the received chunks come back as one tensor."""
    g = as_group(group)
    if isinstance(in_tensor_list, torch.Tensor):
        return alltoall_single(in_tensor_list, group=g)
    _count("alltoall", g)
    outs = [torch.empty_like(t) for t in in_tensor_list]
    work = dist.all_to_all(outs, [t.contiguous() for t in in_tensor_list],
                           group=g.pg, async_op=not sync_op)
    if out_tensor_list is None:
        out_tensor_list = []
    out_tensor_list.clear()
    out_tensor_list.extend(outs)
    return _task(work, sync_op)


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """The dim-0 chunks of ``in_tensor`` (equal, or ``in_split_sizes``)
    exchanged; into ``out_tensor`` when given (returns the Task), else
    returned as a new tensor."""
    g = as_group(group)
    _count("alltoall_single", g)
    out = out_tensor
    if out is None:
        rows = (sum(out_split_sizes) if out_split_sizes is not None
                else in_tensor.shape[0])
        out = in_tensor.new_empty((rows, *in_tensor.shape[1:]))
    work = dist.all_to_all_single(out, in_tensor.contiguous(),
                                  out_split_sizes, in_split_sizes,
                                  group=g.pg, async_op=not sync_op)
    task = _task(work, sync_op)
    return task if out_tensor is not None else out


# sends to oneself waiting for their receive, in order (a ppermute's
# (r, r) pair: a copy; JAX's identity where nothing was sent)
_SELF_SENT: list = []


def _to_self(peer):
    return peer == dist.get_rank()


def send(tensor, dst=0, group=None, sync_op=True):
    g = as_group(group)
    _count("send", g)
    if _to_self(dst):
        _SELF_SENT.append(tensor.detach().clone())
        return Task()
    if sync_op:
        dist.send(tensor.contiguous(), dst=dst, group=g.pg)
        return Task()
    return Task(dist.isend(tensor.contiguous(), dst=dst, group=g.pg))


def recv(tensor, src=0, group=None, sync_op=True):
    g = as_group(group)
    _count("recv", g)
    if _to_self(src):
        if _SELF_SENT:
            tensor.copy_(_SELF_SENT.pop(0))
        return Task()
    if sync_op:
        dist.recv(tensor, src=src, group=g.pg)
        return Task()
    return Task(dist.irecv(tensor, src=src, group=g.pg))


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


def broadcast_object_list(object_list, src=0, group=None):
    """``object_list`` becomes ``src``'s (picklable objects). A process
    outside the group does nothing."""
    g = as_group(group)
    if not g.is_member():
        return
    if g.get_group_rank(src) < 0:
        raise ValueError(f"src {src} is not in the group")
    _count("broadcast_object_list", g)
    dist.broadcast_object_list(object_list, src=src, group=g.pg)


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """``out_object_list`` becomes ``[src's in_object_list[group rank]]``;
    ``src`` must give one object per rank."""
    g = as_group(group)
    if not g.is_member():
        return
    mine = dist.get_rank() == src
    if mine and len(in_object_list or []) != g.nranks:
        raise ValueError(
            f"scatter_object_list: src needs one object per rank "
            f"(got {len(in_object_list or [])}, nranks {g.nranks})")
    _count("scatter_object_list", g)
    out = [None]
    dist.scatter_object_list(out, list(in_object_list) if mine else None,
                             src=src, group=g.pg)
    out_object_list[:] = out


class P2POp:
    """One point-to-point descriptor of ``batch_isend_irecv``: ``op`` is
    ``isend`` or ``irecv``."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv):
            raise ValueError("P2POp op must be paddle.distributed.isend "
                             "or irecv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """Start the batch's sends and receives together; returns their
    Tasks."""
    if not p2p_op_list:
        return []
    ops, tasks = [], []
    for p in p2p_op_list:
        g = as_group(p.group)
        _count("batch_isend_irecv", g)
        if _to_self(p.peer):
            if p.op is isend:
                _SELF_SENT.append(p.tensor.detach().clone())
            elif _SELF_SENT:
                p.tensor.copy_(_SELF_SENT.pop(0))
            tasks.append(Task())
            continue
        ops.append(dist.P2POp(dist.isend if p.op is isend else dist.irecv,
                              p.tensor, p.peer, group=g.pg))
    if ops:
        tasks += [Task(w) for w in dist.batch_isend_irecv(ops)]
    return tasks


def get_backend(group=None):
    """The group's backend, "NCCL" or "GLOO" (JAX's is "XLA")."""
    return str(dist.get_backend(as_group(group).pg)).upper()


def barrier(group=None):
    g = as_group(group)
    _count("barrier", g)
    dist.barrier(group=g.pg)
    return Task()


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """With ``tensor_list`` (one tensor per rank), ``tensor`` becomes this
    rank's reduction of every rank's ``tensor_list[group rank]``; without,
    ``tensor``'s own dim-0 chunks are reduced and ``tensor`` becomes this
    rank's chunk."""
    g = as_group(group)
    if tensor_list is not None:
        inp = torch.cat([t.reshape(-1) for t in tensor_list])
        return _reduce_scatter_flat(tensor.view(-1) if tensor.is_contiguous()
                                    else tensor, inp, g, op, sync_op)
    n = g.nranks
    if tensor.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({tensor.shape[0]}) is "
                         f"not divisible by the group's {n} ranks")
    out = tensor.new_empty((tensor.shape[0] // n, *tensor.shape[1:]))
    task = _reduce_scatter_flat(out, tensor.contiguous(), g, op, True)
    tensor.data = out
    return task


class _StreamNS:
    """``paddle.distributed.stream``: the same ops, with
    ``use_calc_stream`` taken (the ops run on the current stream)."""

    @staticmethod
    def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
                   use_calc_stream=False):
        from .all_reduce import all_reduce as _ar
        return _ar(tensor, op, group, sync_op)

    all_gather = staticmethod(all_gather)
    broadcast = staticmethod(broadcast)
    reduce = staticmethod(reduce)
    scatter = staticmethod(scatter)
    alltoall = staticmethod(alltoall)
    alltoall_single = staticmethod(alltoall_single)
    send = staticmethod(send)
    recv = staticmethod(recv)
    reduce_scatter = staticmethod(reduce_scatter)


stream = _StreamNS()
