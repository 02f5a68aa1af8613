"""Context parallelism for long sequences: ring attention and Ulysses.

Counterpart of ``paddle_tpu/parallel/context_parallel.py``, on
``torch.distributed``. The sequence is split over a mesh axis ("sep");
each rank holds one [B, S/n, H, D] chunk of q, k and v.

- **Ring attention**: K/V chunks rotate around the axis's process group
  (``batch_isend_irecv`` to rank + 1), and each step attends this rank's
  q chunk to the visiting K/V chunk and merges the partial result by its
  log-sum-exp, exactly. The chunk step is the ring chunk kernel
  (``ops/ring_chunk_attention.py``) with the step's diagonal offset, or
  the dense composite ``_chunk_attn``; with ``remat`` each step is
  recomputed in the backward (``torch.utils.checkpoint``), so activation
  memory stays O(S/n). The rotation is an autograd Function whose
  backward sends the gradients the other way round.
- **Ulysses**: ``all_to_all_single`` re-shards [B, S/n, H, D] to [B, S,
  H/n, D], attention runs over the whole sequence on a slice of the heads
  (the flash kernels, or the composite), and the inverse all-to-all
  restores the sequence split. Needs heads % n == 0.

``ring_attention`` and ``ulysses_attention`` take this rank's chunks;
``make_ring_attention_fn`` and ``make_ulysses_attention_fn`` take and
return the full [B, S, H, D] on every rank, as JAX's ``shard_map`` over
``P(None, axis, None, None)`` does: each rank slices its chunk, and
gathers the output chunks, with gradients equal to the global-view ones
on every rank. ``_ring_attention_serial`` runs the same ring loop for n
ranks in one process (rotation is a roll of a list), for a check on one
card, which cannot hold two NCCL ranks.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

__all__ = ["ring_attention", "ulysses_attention", "make_ring_attention_fn",
           "make_ulysses_attention_fn"]

_NEG_INF = -1e30


def _chunk_attn(q, k, v, scale, mask):
    """Blockwise attention returning (out, lse) for one KV chunk.

    q: [B, Sq, H, D]; k, v: [B, Sk, Hk, D] (GQA: H % Hk == 0).
    mask: broadcastable to [Sq, Sk] boolean (True = attend), or None.
    out is the *normalized* chunk output in fp32; lse [B, H, Sq] the row
    log-sum-exp (-1e30 for a row that attends nothing) — the pair merges
    exactly across chunks. fp32 softmax stats.
    """
    h, hk = q.shape[2], k.shape[2]
    if h != hk:
        k = k.repeat_interleave(h // hk, dim=2)
        v = v.repeat_interleave(h // hk, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(-1, keepdim=True).clamp_min(_NEG_INF)  # all-masked: finite
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    empty = l == 0.0
    denom = torch.where(empty, torch.ones_like(l), l)
    lse = torch.where(empty, torch.full_like(l, _NEG_INF),
                      m + torch.log(denom))[..., 0]            # [B, H, Sq]
    return o / denom.transpose(1, 2), lse


def _merge(o_a, lse_a, o_b, lse_b):
    """Merge two normalized partial attentions via their lse (exact)."""
    lse_m = torch.maximum(lse_a, lse_b).clamp_min(_NEG_INF)
    wa = torch.exp(lse_a - lse_m)
    wb = torch.exp(lse_b - lse_m)
    denom = wa + wb
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    lse_new = lse_m + torch.log(denom)
    wa = (wa / denom)[..., None].transpose(1, 2)   # [B, Sq, H, 1]
    wb = (wb / denom)[..., None].transpose(1, 2)
    return o_a * wa + o_b * wb, lse_new


def _use_ring_kernel(q, k) -> bool:
    """Whether the ring's chunk step takes the ring chunk kernel
    (``ops/ring_chunk_attention.py``) rather than the composite.

    ``PADDLE_TPU_RING_COMPOSITE=1`` selects the composite. A CUDA tensor
    takes the kernel wherever it supports the shapes and dtype, and the
    kernel launches or raises. A CPU tensor takes the composite, or with
    ``PADDLE_TPU_RING_KERNEL_CPU=1`` the kernel's plain version (the JAX
    package's interpret-mode switch)."""
    if os.environ.get("PADDLE_TPU_RING_COMPOSITE") == "1":
        return False
    if q.device.type != "cuda" and \
            os.environ.get("PADDLE_TPU_RING_KERNEL_CPU") != "1":
        return False
    from ..ops.ring_chunk_attention import is_supported
    # is_supported takes the kernel layout [B, H, S, D]; the ring holds
    # [B, S, H, D]
    qs = (q.shape[0], q.shape[2], q.shape[1], q.shape[3])
    ks = (k.shape[0], k.shape[2], k.shape[1], k.shape[3])
    return is_supported(qs, ks, q.dtype)


def _chunk_step(q, k, v, my, src, causal, scale, use_kernel):
    """(o fp32 [B, Sq, H, D], lse [B, H, Sq]) of rank ``my``'s q chunk
    against rank ``src``'s K/V chunk: row i of chunk my sees key j of
    chunk src iff src * Sq + j <= my * Sq + i when causal."""
    sq, sk = q.shape[1], k.shape[1]
    offset = (my - src) * sq if causal else sk
    if use_kernel:
        from ..ops.ring_chunk_attention import ring_chunk_attention
        o, lse = ring_chunk_attention(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), offset, scale)
        return o.transpose(1, 2).float(), lse
    mask = None
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        mask = torch.arange(sk, device=q.device)[None, :] <= rows + offset
    return _chunk_attn(q, k, v, scale, mask)


def _ring_loop(qs, ks, vs, ranks, n, rotate, causal, scale, remat):
    """The ring over n ranks for the chunks this process holds: qs, ks,
    vs [B, S/n, H, D] (GQA: fewer K/V heads) of ranks ``ranks``. Step t
    attends rank my's q chunk to the K/V chunk of src = (my - t) mod n
    and merges it; ``rotate(ks, vs)`` then moves every K/V chunk to the
    next rank (not after the last step). Returns the output chunks in
    q's dtype."""
    if scale is None:
        scale = qs[0].shape[-1] ** -0.5
    use_kernel = _use_ring_kernel(qs[0], ks[0])
    accs = []
    for q in qs:
        b, sq, h, d = q.shape
        accs.append((torch.zeros((b, sq, h, d), dtype=torch.float32,
                                 device=q.device),
                     torch.full((b, h, sq), _NEG_INF, dtype=torch.float32,
                                device=q.device)))
    for t in range(n):
        for i, my in enumerate(ranks):
            src = (my - t) % n
            args = (my, src, causal, scale, use_kernel)
            if remat:
                o_i, lse_i = checkpoint(_chunk_step, qs[i], ks[i], vs[i],
                                        *args, use_reentrant=False)
            else:
                o_i, lse_i = _chunk_step(qs[i], ks[i], vs[i], *args)
            accs[i] = _merge(*accs[i], o_i, lse_i)
        if t < n - 1:               # the last rotation would be discarded
            ks, vs = rotate(ks, vs)
    return [o.to(q.dtype) for (o, _), q in zip(accs, qs)]


def _axis(mesh, axis_name):
    """(process group, size, this rank's coordinate) of ``axis_name`` in
    ``mesh`` (default: the active hybrid mesh)."""
    if mesh is None:
        from . import current_mesh
        mesh = current_mesh()
    if axis_name not in (getattr(mesh, "mesh_dim_names", None) or ()):
        raise ValueError(f"no active mesh with a {axis_name!r} axis (call "
                         "fleet.init with a sep_degree first)")
    group = mesh.get_group(axis_name)
    return group, dist.get_world_size(group), mesh.get_local_rank(axis_name)


def _sendrecv(xs, group, shift):
    """Each of ``xs`` sent to the rank ``shift`` places on in ``group``'s
    ring and replaced by the one from ``shift`` places back."""
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    me = ranks.index(dist.get_rank())
    dst, src = ranks[(me + shift) % n], ranks[(me - shift) % n]
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    ops = []
    for x, out in zip(xs, outs):
        ops.append(dist.P2POp(dist.isend, x, dst, group))
        ops.append(dist.P2POp(dist.irecv, out, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _Rotate(torch.autograd.Function):
    """K/V chunks to rank + shift of the group (JAX: ``ppermute``); the
    backward sends their gradients to rank - shift (its transpose)."""

    @staticmethod
    def forward(ctx, group, shift, *xs):
        ctx.group, ctx.shift = group, shift
        return tuple(_sendrecv(xs, group, shift))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_sendrecv(grads, ctx.group, -ctx.shift))


def ring_attention(q, k, v, axis_name: str = "sep", causal: bool = False,
                   scale: Optional[float] = None, remat: bool = True, *,
                   mesh=None):
    """Exact ring attention over the ``axis_name`` group of ``mesh``
    (default: the active hybrid mesh, ``parallel.current_mesh()``).

    q, k, v: this rank's [B, S/n, H, D] chunks, the sequence split over
    the axis in ring order (chunk i on coordinate i). Returns this rank's
    output chunk [B, S/n, H, D] in q's dtype.
    """
    group, n, my = _axis(mesh, axis_name)

    def rotate(ks, vs):
        k_nxt, v_nxt = _Rotate.apply(group, 1, ks[0], vs[0])
        return [k_nxt], [v_nxt]
    return _ring_loop([q], [k], [v], [my], n, rotate, causal, scale,
                      remat)[0]


def _ring_attention_serial(q, k, v, n, causal=False, scale=None,
                           remat=True):
    """``ring_attention`` for n ranks in one process: the full [B, S, H, D]
    q, k and v split into n chunks, each rank's held in a list, the same
    loop and merge, rotation a roll of the list. Returns [B, S, H, D]."""
    _check_split(q, k, v, n)
    chunks = [list(x.chunk(n, dim=1)) for x in (q, k, v)]

    def roll(ks, vs):
        return ks[-1:] + ks[:-1], vs[-1:] + vs[:-1]
    return torch.cat(_ring_loop(*chunks, list(range(n)), n, roll, causal,
                                scale, remat), dim=1)


def _a2a(x, group, n, split_axis, concat_axis):
    """Tiled all-to-all (JAX ``all_to_all(..., tiled=True)``): x split in
    n parts along ``split_axis``, part j to rank j, the received parts
    concatenated along ``concat_axis`` in rank order."""
    send = torch.stack(x.chunk(n, dim=split_axis))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    """``_a2a`` whose backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.args = (group, n, concat_axis, split_axis)
        return _a2a(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g.contiguous(), *ctx.args), None, None, None, None


def ulysses_attention(q, k, v, axis_name: str = "sep", causal: bool = False,
                      scale: Optional[float] = None, *, mesh=None):
    """Ulysses sequence parallelism over the ``axis_name`` group of
    ``mesh`` (default: the active hybrid mesh): all-to-all seq-shard ->
    head-shard, attention over the whole sequence per rank, inverse
    all-to-all.

    q, k, v: this rank's [B, S/n, H, D]; H % n == 0 required. Exact.
    """
    group, n, _ = _axis(mesh, axis_name)
    if q.shape[2] % n != 0:
        raise ValueError(f"heads {q.shape[2]} not divisible by sep={n}")
    if k.shape[2] % n != 0:
        raise ValueError(
            f"kv heads {k.shape[2]} not divisible by sep={n}; Ulysses "
            f"re-shards heads across the sep axis — use ring_attention for "
            f"GQA configs with kv_heads < sep")
    # [B, S/n, H, D] -> [B, S, H/n, D]
    qh, kh, vh = (_AllToAll.apply(x, group, n, 2, 1) for x in (q, k, v))
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # the full-sequence attention streams the flash kernels on the card
    # (PADDLE_TPU_ULYSSES_FLASH_CPU=1: their plain versions on the CPU);
    # the dense composite, O(S^2) scores, is the opt-out and the CPU's
    from ..ops import flash_attention as fa
    use_flash = (q.device.type == "cuda"
                 or os.environ.get("PADDLE_TPU_ULYSSES_FLASH_CPU") == "1")
    if use_flash and os.environ.get("PADDLE_TPU_ULYSSES_COMPOSITE") != "1" \
            and fa.is_supported(qh.shape, qh.dtype):
        o = fa.flash_attention(qh, kh, vh, causal=causal, scale=scale)
    else:
        mask = None
        if causal:
            s = qh.shape[1]
            mask = torch.ones((s, s), dtype=torch.bool,
                              device=q.device).tril()
        o, _ = _chunk_attn(qh, kh, vh, scale, mask)
    return _AllToAll.apply(o.to(q.dtype), group, n, 1, 2)


def _check_split(q, k, v, n):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 4 or x.shape[1] % n:
            raise ValueError(
                f"context parallel: {name} {tuple(x.shape)} must be [B, S, "
                f"H, D] with S divisible by the sep degree {n}")


def _all_gather_seq(x, group, n):
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


class _SeqChunk(torch.autograd.Function):
    """This rank's chunk of a full [B, S, ...] tensor held on every rank
    of the group; the backward gathers every rank's chunk gradient, so the
    full gradient is the global one on each rank."""

    @staticmethod
    def forward(ctx, x, group, n, my):
        ctx.args = (group, n)
        c = x.shape[1] // n
        return x[:, my * c:(my + 1) * c].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_seq(g, *ctx.args), None, None, None


class _SeqGather(torch.autograd.Function):
    """The full [B, S, ...] tensor from every rank's chunk; the backward
    takes this rank's chunk of the (identical on every rank) gradient."""

    @staticmethod
    def forward(ctx, x, group, n, my):
        ctx.c, ctx.my = x.shape[1], my
        return _all_gather_seq(x, group, n)

    @staticmethod
    def backward(ctx, g):
        c = ctx.c
        return g[:, ctx.my * c:(ctx.my + 1) * c], None, None, None


def _cp_fn(impl, mesh, axis_name: str, causal: bool,
           scale: Optional[float]):
    def fn(q, k, v):
        group, n, my = _axis(mesh, axis_name)
        _check_split(q, k, v, n)
        o = impl(*(_SeqChunk.apply(x, group, n, my) for x in (q, k, v)),
                 axis_name=axis_name, causal=causal, scale=scale, mesh=mesh)
        return _SeqGather.apply(o, group, n, my)
    return fn


def make_ring_attention_fn(mesh, axis_name: str = "sep",
                           causal: bool = False,
                           scale: Optional[float] = None):
    """Global-view ring attention over ``mesh``'s ``axis_name`` axis: takes
    and returns the full [B, S, H, D] on every rank of the axis (S
    divisible by its size); differentiable."""
    return _cp_fn(ring_attention, mesh, axis_name, causal, scale)


def make_ulysses_attention_fn(mesh, axis_name: str = "sep",
                              causal: bool = False,
                              scale: Optional[float] = None):
    """Global-view Ulysses attention, as ``make_ring_attention_fn``."""
    return _cp_fn(ulysses_attention, mesh, axis_name, causal, scale)
