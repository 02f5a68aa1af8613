"""The micro-batch pipeline engine over a fleet axis. Counterpart of
``paddle_tpu/parallel/pipeline.py``.

JAX runs every stage as a coordinate of one SPMD program: a ``lax.scan``
of ``ppermute``s inside ``shard_map``, differentiated by ``jax.grad``.
Here each stage is a process of the fleet topology's ``axis_name`` group
("pp": the pipe group), holding only its own stage's parameters, and the
schedule is run eagerly: fill-drain, every micro-batch's forward in
order, the last stage's outputs broadcast over the group (every rank
returns them, as JAX's ``psum`` makes them replicated), then the
backwards in reverse order. Activations move to the next stage and
their gradients back by ``communication.ops.batch_isend_irecv`` (sends
started without waiting and finished before the pass ends, receives
waited on; the same order on both sides of a link). As in JAX, a stage
keeps the micro-batch's shape and dtype (``x_mb[0]``'s), so no shape is
exchanged.

``gpipe`` / ``gpipe_interleaved`` are one ``torch.autograd.Function``:
its backward takes the cotangent of the last stage's outputs from the
last stage's own caller (the other ranks' copies stand for the same
values), runs the stages' backwards and returns each rank's parameter
gradients and, at stage 0, the input's. With ``remat`` (the default)
each tick's stage call runs under ``fleet.utils.recompute``: only its
input is kept and the call is recomputed in backward; without it the
call's activations are kept. ``window`` is taken for JAX's signature:
JAX's block checkpoint bounds a compiled scan's residuals, which an
eager schedule that keeps one input a tick does not have.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

__all__ = ["gpipe", "gpipe_interleaved", "make_gpipe_fn", "microbatch",
           "unmicrobatch"]


def microbatch(x, num_micro: int):
    """[B, ...] -> [M, B/M, ...]."""
    b = x.shape[0]
    assert b % num_micro == 0, f"batch {b} not divisible by {num_micro}"
    return x.reshape(num_micro, b // num_micro, *x.shape[1:])


def unmicrobatch(x):
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _axis(axis_name, mesh=None):
    """(``Group``, this stage, stage count) of ``axis_name`` on ``mesh``
    (default the active fleet topology's)."""
    from ..distributed.communication.group import as_group
    if mesh is None:
        from . import current_mesh
        mesh = current_mesh()
    if mesh is None or axis_name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"pipeline: no fleet mesh with a {axis_name!r} "
                         "axis (fleet.init with pp_degree first)")
    g = as_group(mesh.get_group(axis_name))
    return g, g.rank, g.nranks


class _Schedule:
    """The fill-drain order over the ring of (stage, chunk) slots."""

    def __init__(self, g, stage, n, m, v, spec, stage_fn, remat):
        self.g, self.s, self.p, self.m, self.v = g, stage, n, m, v
        self.spec, self.stage_fn, self.remat = spec, stage_fn, remat
        self.order = [(c, j) for c in range(v) for j in range(m)]
        self.prev = g.ranks[(stage - 1) % n]
        self.next = g.ranks[(stage + 1) % n]
        self.pending = []

    def start(self, c):
        return self.s == 0 and c == 0

    def end(self, c):
        return self.s == self.p - 1 and c == self.v - 1

    def p2p(self, op, t, peer, wait):
        from ..distributed.communication.ops import P2POp, batch_isend_irecv
        tasks = batch_isend_irecv([P2POp(op, t, peer, self.g)])
        if wait:
            for task in tasks:
                task.wait()
        else:
            self.pending.append((tasks, t))

    def flush(self):
        for tasks, _ in self.pending:
            for task in tasks:
                task.wait()
        self.pending.clear()


class _Pipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, x_mb, *flat):
        from ..distributed.communication.ops import _broadcast, irecv, isend
        from ..distributed.fleet.utils.recompute_mod import recompute
        ctx.sched = sched
        ctx.leaves = [t.detach().requires_grad_(t.requires_grad)
                      for t in flat]
        per = len(flat) // sched.v
        params = [pytree.tree_unflatten(ctx.leaves[k * per:(k + 1) * per],
                                        sched.spec) for k in range(sched.v)]
        outs = torch.zeros_like(x_mb)
        ctx.kept = {}
        for c, j in sched.order:
            if sched.start(c):
                h = x_mb[j].detach()
            else:
                h = torch.empty_like(x_mb[0])
                sched.p2p(irecv, h, sched.prev, True)
            h.requires_grad_(True)
            with torch.enable_grad():
                out = (recompute(sched.stage_fn, params[c], h) if sched.remat
                       else sched.stage_fn(params[c], h))
            ctx.kept[c, j] = (h, out)
            if sched.end(c):
                outs[j] = out.detach()
            else:
                sched.p2p(isend, out.detach().contiguous(), sched.next,
                          False)
        sched.flush()
        if sched.p > 1:
            _broadcast(outs, sched.g.ranks[-1], sched.g)
        return outs

    @staticmethod
    def backward(ctx, grad_outs):
        from ..distributed.communication.ops import irecv, isend
        sched = ctx.sched
        grad_x = torch.zeros_like(grad_outs)
        for c, j in reversed(sched.order):
            h, out = ctx.kept.pop((c, j))
            if sched.end(c):
                g = grad_outs[j]
            else:
                g = torch.empty_like(grad_outs[0])
                sched.p2p(irecv, g, sched.next, True)
            torch.autograd.backward(out, g)
            gh = h.grad if h.grad is not None else torch.zeros_like(h)
            if sched.start(c):
                grad_x[j] = gh
            else:
                sched.p2p(isend, gh.contiguous(), sched.prev, False)
        sched.flush()
        return (None, grad_x, *(t.grad if t.grad is not None
                                else torch.zeros_like(t)
                                for t in ctx.leaves))


def _run(stage_fn, chunks, x_mb, axis_name, remat, mesh=None):
    g, stage, n = _axis(axis_name, mesh)
    flats = [pytree.tree_flatten(c) for c in chunks]
    sched = _Schedule(g, stage, n, x_mb.shape[0], len(chunks), flats[0][1],
                      stage_fn, remat)
    return _Pipe.apply(sched, x_mb, *(t for f, _ in flats for t in f))


def gpipe(stage_fn: Callable, stage_params, x_mb, axis_name: str = "pp",
          remat: bool = True, window: int | str | None = "auto"):
    """Run the micro-batch pipeline schedule with this rank as its stage
    of the ``axis_name`` group.

    stage_fn(stage_params, h) -> h: this stage's layers (the same shape
        and dtype out as in).
    stage_params: this stage's parameters (a pytree of tensors).
    x_mb: [M, mb, ...] micro-batched stage-0 input (the same on every
        rank; only stage 0 reads it).
    Returns [M, mb, ...] the last stage's outputs, on every rank."""
    if not (window in ("auto", None) or isinstance(window, int)):
        raise ValueError(f"gpipe: window {window!r}")
    return _run(stage_fn, [stage_params], x_mb, axis_name, remat)


def gpipe_interleaved(stage_fn: Callable, chunk_params, x_mb,
                      axis_name: str = "pp", num_chunks: int = 2,
                      remat: bool = True):
    """The interleaved (virtual-pipeline) schedule: of the v P chunks in
    layer order, stage i holds chunks {i, P + i, ...}; ``chunk_params``
    is a pytree whose tensors lead with v (chunk c = global chunk c P +
    i), ``stage_fn(one_chunk_params, h) -> h``. The last stage's output
    of chunk c feeds stage 0's chunk c + 1. Returns [M, mb, ...] the
    final outputs, on every rank."""
    chunks = [pytree.tree_map(lambda a, c=c: a[c], chunk_params)
              for c in range(num_chunks)]
    return _run(stage_fn, chunks, x_mb, axis_name, remat)


def make_gpipe_fn(stage_fn: Callable, mesh, axis_name: str = "pp",
                  remat: bool = True, num_micro: int | None = None,
                  window: int | str | None = "auto"):
    """Global view: ``fn(stacked_params, x)`` with ``stacked_params`` a
    pytree of [P, ...] tensors (this rank reads its stage's slice, and
    the others' slices get no gradient here) and ``x`` either [M, mb,
    ...] or [B, ...] with ``num_micro`` set; returns the outputs on
    every rank. ``mesh``: the fleet topology's mesh (None: the active
    one)."""

    def fn(stacked_params, x):
        _, stage, _ = _axis(axis_name, mesh)
        local = pytree.tree_map(lambda a: a[stage], stacked_params)
        x_mb = x if num_micro is None else microbatch(x, num_micro)
        out = _run(stage_fn, [local], x_mb, axis_name, remat, mesh)
        return out if num_micro is None else unmicrobatch(out)

    return fn
