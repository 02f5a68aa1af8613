"""Bucketed gradient reduction after backward: the port's counterpart of
Paddle's ``EagerReducer`` (``paddle/fluid/distributed/collective/
reducer.cc``), which JAX leaves to XLA.

``DataParallel`` and the GroupSharded stages hand a ``Reducer`` their
parameters as entries: a replicated parameter (``axis`` None: its
gradient mean all-reduced in place), or a sharded one, split along
``axis`` into one chunk a rank of the group (JAX's layout rule,
``shard_axis``). The reducer gives each sharded parameter its shard:
rank r's chunk, a leaf that the optimizer steps.

Buckets (``bucket_plan``): the entries of one kind (sharded or not) and
dtype, in reverse order (the order backward produces gradients), a
bucket closing once it holds ``cap_bytes``. A sharded bucket is laid out
rank-major: row r holds rank r's chunk of each of its parameters (moved
to lead along ``axis``), one after another. Its shards are views of one
flat buffer, this rank's row, so the parameters' all-gather reads it in
place; its gradients go as one flat buffer of every row, which is
reduce-scattered (stage 2: this rank's row comes back, and the shards'
gradients are views of it) or all-reduced (stage 1: the row is cut out,
and the parameters' gradients take the whole mean). At one rank a row
is the parameters themselves, each in its own layout: they rest in the
shard buffer, and the all-gather runs in place.

A post-accumulate-grad hook on each parameter counts its bucket down,
and a bucket whose gradients are all there is launched asynchronously,
in plan order, so every rank issues the same collectives in the same
order. At the end of backward (a callback queued on the autograd engine)
the buckets still waiting are launched (a parameter without a gradient
sends zeros and keeps None), each is waited for, all-reduced over the
data-parallel group when there is one of more than one rank, divided by
the ranks that consumed distinct data (the sharding group's times the
dp group's) and handed out.

So a backward issues, per bucket: an all-reduce (replicated or stage-1
bucket) or a reduce-scatter (stage-2 bucket), plus one dp all-reduce
where dp has more than one rank.
"""
from __future__ import annotations

import weakref

import torch

from .group import ReduceOp
from .ops import _all_gather_flat, _all_reduce, _reduce_scatter_flat

__all__ = ["Reducer", "bucket_plan", "shard_axis", "reduced_by_hooks",
           "ShardInfo", "shard_leaf", "BUCKET_BYTES"]

# bucket size: DistributedStrategy.fuse_grad_size_in_MB's default
BUCKET_BYTES = 32 * 2 ** 20


def shard_axis(shape, degree):
    """JAX's layout rule (``shard_spec_for`` then ``_valid_spec``): the
    largest axis (the first of equals), or None where the tensor is 0-d
    or that axis does not divide by ``degree``."""
    shape = tuple(shape)
    if not shape:
        return None
    ax = max(range(len(shape)), key=lambda i: shape[i])
    return ax if shape[ax] % degree == 0 else None


def bucket_plan(nbytes, cap_bytes=BUCKET_BYTES):
    """Indices of ``nbytes`` grouped into buckets: in reverse order, a
    bucket closing once it holds ``cap_bytes`` (a larger tensor alone)."""
    buckets, cur, held = [], [], 0
    for i in reversed(range(len(nbytes))):
        cur.append(i)
        held += nbytes[i]
        if held >= cap_bytes:
            buckets.append(cur)
            cur, held = [], 0
    if cur:
        buckets.append(cur)
    return buckets


def reduced_by_hooks(t) -> bool:
    """Whether a live reducer owns ``t``'s gradient."""
    ref = getattr(t, "_grad_reducer", None)
    return ref is not None and ref() is not None


class ShardInfo:
    """What a shard tensor knows of its parameter: the split ``axis``, the
    full shape and the group holding the chunks. ``psum`` sums a partial
    over the group in place (``optimizer`` and ``nn.clip`` use it)."""

    def __init__(self, axis, full_shape, group):
        self.axis, self.full_shape, self.group = axis, tuple(full_shape), \
            group

    def psum(self, x):
        _all_reduce(x, ReduceOp.SUM, self.group)
        return x


_SHARD_ATTRS = ("optimize_attr", "regularizer", "need_clip",
                "trainable", "is_distributed", "split_axis", "_mp_group",
                "_pp_shared_copy")


def shard_leaf(p, chunk, axis, group):
    """``chunk`` (rank r's chunk of ``p`` along ``axis``) as a leaf of
    JAX's shard shape, with ``p``'s optimizer attributes and a
    ``_shard_info``."""
    s = chunk.detach()
    s.requires_grad_(p.requires_grad)
    for a in _SHARD_ATTRS:
        if a in vars(p):        # not torch.Tensor's own is_distributed()
            setattr(s, a, vars(p)[a])
    s._shard_info = ShardInfo(axis, p.shape, group)
    p._shard = s
    return s


class Entry:
    """One parameter of a reducer, split along ``axis`` (None:
    replicated, the gradient stays on ``param``); ``shard`` is its chunk,
    made by the reducer."""

    def __init__(self, param, axis=None):
        self.param, self.axis, self.shard = param, axis, None


# a sharded bucket's chunks start at multiples of this many elements of a
# row, so that the shards (and at one rank the parameters) resting in it
# keep the alignment of the vector loads and of the GEMMs' fast kernels
_ALIGN = 64


class _Bucket:
    def __init__(self, kind, entries, n):
        self.kind = kind                    # "all_reduce" / "reduce_scatter"
        self.entries = entries
        self.sharded = entries[0].axis is not None
        self.n = n if self.sharded else 1
        # the numel of each entry in one row, and the room it takes there
        self.sizes = [e.param.numel() // self.n for e in entries]
        self.slots = ([-(-k // _ALIGN) * _ALIGN for k in self.sizes]
                      if self.sharded else self.sizes)
        self.shard_buf = None
        if self.sharded:
            # (size, stride, offset) of each chunk in a row, at its
            # shard's shape: one view op a chunk where a row is handed out
            row = torch.empty(sum(self.slots), device="meta")
            self.specs = [
                (c.size(), c.stride(), c.storage_offset()) for c in (
                    piece.view(self.moved(e, 1)[1:]).movedim(0, self.lead(e))
                    for e, piece in zip(entries, self.pieces(row)))]
        self.reset()

    def reset(self):
        self.waiting = len(self.entries)
        self.task = self.buf = self.had = None

    def lead(self, e):
        """The axis that leads ``e`` in a row: its split axis; at one rank,
        where the chunk is the whole parameter, its first, so that the
        row holds it in its own layout."""
        return e.axis if self.n > 1 else 0

    def moved(self, e, rows):
        """The shape of ``e`` with its ``lead`` axis first and cut into
        ``rows`` rows."""
        shape = list(e.param.shape)
        lead = shape.pop(self.lead(e))
        return (rows, lead // self.n, *shape)

    def rows(self, tensors):
        """``tensors`` (one of each entry's shape) laid out as the bucket's
        [n, row] buffer: row r holds each one's chunk r, in its slot."""
        parts, pad = [], None
        for t, e, k, slot in zip(tensors, self.entries, self.sizes,
                                 self.slots):
            if self.lead(e):
                t = t.movedim(self.lead(e), 0)
            parts.append(t.reshape(self.n, -1))
            if slot > k:
                if pad is None:
                    pad = t.new_zeros((self.n, _ALIGN))
                parts.append(pad[:, :slot - k])
        return torch.cat(parts, dim=1)

    def pieces(self, flat, dim=0):
        """Each entry's chunk of ``flat`` (laid out in slots along
        ``dim``), the padding left out."""
        return [piece.narrow(dim, 0, k) for piece, k in
                zip(flat.split(self.slots, dim), self.sizes)]

    def chunks(self, row):
        """Each entry's chunk of ``row`` (one row, flat), as a view of its
        shard's shape."""
        base = row.storage_offset()
        return [row.as_strided(size, stride, base + off)
                for size, stride, off in self.specs]

    def make_shards(self, group):
        """The entries' shards: views of one flat buffer, this rank's row.
        At one rank the parameters rest in that buffer too: a shard is
        its parameter's storage."""
        self.shard_buf = self.rows([e.param.detach() for e in self.entries])[
            group.rank].clone()
        for e, chunk in zip(self.entries, self.chunks(self.shard_buf)):
            if self.n == 1:
                e.param.data = chunk
            e.shard = shard_leaf(e.param, chunk, e.axis, group)

    @torch.no_grad()
    def gather_params(self, group):
        """All-gather the shards into the parameters: one collective on
        the flat shard buffer, then one multi-tensor copy (at one rank
        the collective runs in place, and the parameters hold the
        result)."""
        if self.n == 1:
            _all_gather_flat(self.shard_buf, self.shard_buf, group)
            return
        out = self.shard_buf.new_empty((self.n, self.shard_buf.numel()))
        _all_gather_flat(out, self.shard_buf, group)
        dst, src = [], []
        for e, piece in zip(self.entries, self.pieces(out, 1)):
            shape = self.moved(e, self.n)
            dst.append(e.param.detach().movedim(self.lead(e), 0).unflatten(
                0, shape[:2]))
            src.append(piece.view(shape))
        torch._foreach_copy_(dst, src)


class Reducer:
    """The reducer of ``entries`` over ``group`` (a ``Group``; its ranks
    hold the shards) and ``dp_group`` (a ``Group`` or None). ``scatter``:
    sharded entries are reduce-scattered (stage 2), else all-reduced.
    ``hooks=False``: no hooks, the gradients reduced by ``sync_now()``
    alone."""

    def __init__(self, entries, group, dp_group=None, *, scatter=False,
                 cap_bytes=BUCKET_BYTES, hooks=True):
        self.group, self.dp_group = group, dp_group
        self.enabled = True
        self.synced = True
        kinds: dict = {}
        for e in entries:
            kind = ("all_reduce" if e.axis is None else
                    "reduce_scatter" if scatter else "all_reduce_sharded")
            kinds.setdefault((kind, e.param.dtype), []).append(e)
        self.buckets = []
        for (kind, _), es in kinds.items():
            for idx in bucket_plan([e.param.numel() * e.param.element_size()
                                    for e in es], cap_bytes):
                b = _Bucket(kind.replace("_sharded", ""),
                            [es[i] for i in idx], group.nranks)
                if b.sharded:
                    b.make_shards(group)
                self.buckets.append(b)
        self._bucket_of = {}
        self._next = 0
        self._queued = False
        if hooks:
            self._register()

    def _register(self):
        # the tensors hold the reducer weakly: a hook lives in C++, where
        # no garbage collection sees a cycle through it
        me = weakref.ref(self)

        def ready(param):
            reducer = me()
            if reducer is not None:
                reducer._ready(param)

        for b in self.buckets:
            for e in b.entries:
                self._bucket_of[id(e.param)] = b
                e.param._grad_reducer = me
                if e.shard is not None:
                    e.shard._grad_reducer = me
                e.param.register_post_accumulate_grad_hook(ready)

    @property
    def _dp(self):
        return self.dp_group is not None and self.dp_group.nranks > 1

    # ------------------------------------------------------------- hooks
    def _ready(self, param):
        if not self.enabled:
            self.synced = False
            return
        if not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self.finish)
        b = self._bucket_of[id(param)]
        b.waiting -= 1
        while self._next < len(self.buckets) and \
                self.buckets[self._next].waiting == 0:
            self._launch(self.buckets[self._next])
            self._next += 1

    def _launch(self, b):
        grads = [e.param.grad for e in b.entries]
        b.had = [g is not None for g in grads]
        grads = [g if g is not None else torch.zeros_like(e.param)
                 for g, e in zip(grads, b.entries)]
        if b.sharded:
            b.buf = b.rows(grads)
        else:
            b.buf = torch.cat([g.reshape(-1) for g in grads])
        if b.kind == "all_reduce":
            b.task = _all_reduce(b.buf, ReduceOp.SUM, self.group,
                                 sync_op=False)
        else:
            flat = b.buf
            b.buf = flat.new_empty(flat.shape[1])
            b.task = _reduce_scatter_flat(b.buf, flat, self.group,
                                          sync_op=False)

    @torch.no_grad()
    def finish(self):
        """Launch what is left, wait, reduce over dp and hand out."""
        self._queued = False
        while self._next < len(self.buckets):
            self._launch(self.buckets[self._next])
            self._next += 1
        self._next = 0
        denom = self.group.nranks * (self.dp_group.nranks if self._dp
                                     else 1)
        for b in self.buckets:
            b.task.wait()
            if self._dp:
                _all_reduce(b.buf, ReduceOp.SUM, self.dp_group)
            b.buf.div_(denom)
            if not b.sharded:
                for e, had, red in zip(b.entries, b.had,
                                       b.buf.split(b.sizes)):
                    if had:
                        e.param.grad.copy_(red.view(e.param.shape))
            else:
                self._hand_out(b)
            b.reset()
        self.synced = True

    def _hand_out(self, b):
        """A sharded bucket's reduced gradients: each shard's as a view of
        this rank's row; stage 1 also gives each parameter the whole
        mean, stage 2 leaves it none."""
        if b.kind == "all_reduce":
            dst, src = [], []
            for e, had, piece in zip(b.entries, b.had, b.pieces(b.buf, 1)):
                if had:
                    shape = b.moved(e, b.n)
                    dst.append(e.param.grad.movedim(b.lead(e), 0).unflatten(
                        0, shape[:2]))
                    src.append(piece.view(shape))
            if dst:
                torch._foreach_copy_(dst, src)
            row = b.buf[self.group.rank].clone()
        else:
            row = b.buf
        for e, had, g in zip(b.entries, b.had, b.chunks(row)):
            if b.kind == "reduce_scatter":
                e.param.grad = None
            if not had:
                continue
            # stage 1: the parameter holds the whole accumulated mean, so
            # its chunk replaces the shard's; stage 2's accumulate
            if e.shard.grad is None or b.kind == "all_reduce":
                e.shard.grad = g
            else:
                e.shard.grad.add_(g)

    def gather_params(self):
        """All-gather every sharded bucket's shards into its parameters."""
        for b in self.buckets:
            if b.sharded:
                b.gather_params(self.group)

    def sync_now(self):
        """Reduce the gradients accumulated while disabled (``no_sync``),
        as one backward's end would."""
        for b in self.buckets:
            b.waiting = 0
        self.finish()
