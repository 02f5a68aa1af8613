"""Paged flash-decode attention: the CUDA kernels' wrappers and their
plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/decode_attention.py``'s
``decode_attention_paged``, with the same signature and layouts:

  qt      [B, H, Sq, D]            the new queries, kernel layout
  pool    [L, 2, NB, Hk, Bt, D]    the one shared KV block pool
  tables  [B, Smax/Bt] int32       per-row block tables, sentinel NB
  layer   int                      which layer of the pool to read
  cache_lens [B] int32             query row r attends positions <= lens + r

and of its ``decode_attention_paged_flat``, the same attention over the
flat budget dispatch's ragged [T, H, D] query stream in ``FLAT_CHUNK``-
token single-slot chunks with per-chunk (slot, base, count) metadata.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/decode_attention_paged.cu``, ``csrc/decode_attention_paged_flat.cu``)
on the current stream or raises; on a CPU tensor it computes the plain
version, which is what the CPU tests compare against the JAX function.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["decode_attention_paged", "decode_attention_paged_reference",
           "paged_is_supported", "decode_attention_paged_flat",
           "decode_attention_paged_flat_reference", "paged_flat_is_supported",
           "FLAT_CHUNK", "LAUNCHES"]

NEG_INF = -1e30
MAX_SQ, MAX_D = 128, 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# kernel launches per wrapper, counted where the kernel is launched (the
# plain version on CPU tensors does not count)
LAUNCHES = {"decode_attention_paged": 0, "decode_attention_paged_flat": 0}

# the flat stream's query-chunk size: the packer aligns every segment start
# to it, so each chunk belongs to one slot
FLAT_CHUNK = 8


def paged_is_supported(q_shape, pool_shape, dtype, cache_dtype=None) -> bool:
    """q: [B, Sq, H, D] (the model layout, as the JAX gate takes it);
    pool: [L, 2, NB, Hk, Bt, D]. The kernel takes Sq <= 128, D <= 256,
    Hk | H, a block size that is below 32 or a multiple of it, and a
    pool in the query's dtype (fp32, bf16 or fp16)."""
    if len(q_shape) != 4 or len(pool_shape) != 6:
        return False
    _, sq, h, d = q_shape
    hk, bt = pool_shape[3], pool_shape[4]
    if not (1 <= sq <= MAX_SQ and 1 <= d <= MAX_D) or pool_shape[5] != d:
        return False
    if hk < 1 or h % hk or bt < 1 or (bt > 32 and bt % 32):
        return False
    if cache_dtype is not None and cache_dtype != dtype:
        return False
    return dtype in _DTYPE_CODE


def _check(qt, pool, tables, layer, cache_lens):
    if qt.dim() != 4 or pool.dim() != 6:
        raise ValueError(
            f"decode_attention_paged: qt must be [B, H, Sq, D] and pool "
            f"[L, 2, NB, Hk, Bt, D], got {tuple(qt.shape)} and "
            f"{tuple(pool.shape)}")
    b, h, sq, d = qt.shape
    if not paged_is_supported((b, sq, h, d), tuple(pool.shape), qt.dtype,
                              cache_dtype=pool.dtype):
        raise ValueError(
            f"decode_attention_paged: unsupported shapes/dtypes q "
            f"{tuple(qt.shape)} {qt.dtype}, pool {tuple(pool.shape)} "
            f"{pool.dtype} (see paged_is_supported)")
    if tables.dim() != 2 or tables.shape[0] != b \
            or tables.dtype != torch.int32:
        raise ValueError(
            f"decode_attention_paged: tables must be int32 [B, Smax/Bt], "
            f"got {tables.dtype} {tuple(tables.shape)}")
    if tuple(cache_lens.shape) != (b,) or cache_lens.dtype != torch.int32:
        raise ValueError(
            f"decode_attention_paged: cache_lens must be int32 [B], got "
            f"{cache_lens.dtype} {tuple(cache_lens.shape)}")
    if not 0 <= int(layer) < pool.shape[0]:
        raise ValueError(
            f"decode_attention_paged: layer {layer} outside the pool's "
            f"{pool.shape[0]} layers")
    devs = {t.device for t in (qt, pool, tables, cache_lens)}
    if len(devs) != 1:
        raise ValueError(
            f"decode_attention_paged: inputs on several devices {devs}")


def decode_attention_paged(qt, pool, tables, layer, cache_lens, scale=None):
    """Returns [B, H, Sq, D] in q's dtype: attention of the new queries
    over each row's table-resolved prefix plus the new positions."""
    _check(qt, pool, tables, layer, cache_lens)
    b, h, sq, d = qt.shape
    if scale is None:
        scale = d ** -0.5
    if qt.device.type == "cpu":
        return decode_attention_paged_reference(qt, pool, tables, layer,
                                                cache_lens, scale)
    if qt.device.type != "cuda":
        raise ValueError(
            f"decode_attention_paged: no kernel for device {qt.device}")
    for name, t in (("qt", qt), ("pool", pool), ("tables", tables),
                    ("cache_lens", cache_lens)):
        if not t.is_contiguous():
            raise ValueError(f"decode_attention_paged: {name} must be "
                             "contiguous")
    _, _, nb, hk, bt, _ = pool.shape
    out = torch.empty_like(qt)
    fn = _build.load("decode_attention_paged")
    rc = fn(qt.data_ptr(), pool.data_ptr(), tables.data_ptr(),
            cache_lens.data_ptr(), out.data_ptr(), b, h, sq, d, nb, hk, bt,
            tables.shape[1], int(layer), float(scale),
            _DTYPE_CODE[qt.dtype],
            torch.cuda.current_stream(qt.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"decode_attention_paged: kernel launch failed with CUDA error "
            f"{rc} (q {tuple(qt.shape)} {qt.dtype}, pool {tuple(pool.shape)})")
    LAUNCHES["decode_attention_paged"] += 1
    return out


def decode_attention_paged_reference(qt, pool, tables, layer, cache_lens,
                                     scale=None):
    """The plain version: gather each row's blocks through the clamped
    table into a dense [B, Hk, Smax, D] view, mask block-causally and
    compute the softmax in fp32 (p rounded to the value dtype before the
    PV product, as the kernel does)."""
    b, h, sq, d = qt.shape
    _, _, nb, hk, bt, _ = pool.shape
    nblk = tables.shape[1]
    if scale is None:
        scale = d ** -0.5
    tc = tables.long().clamp(max=nb - 1)
    kv = pool[int(layer)][:, tc]                  # [2, B, nblk, Hk, Bt, D]
    kv = kv.permute(0, 1, 3, 2, 4, 5).reshape(2, b, hk, nblk * bt, d)
    kv = kv.repeat_interleave(h // hk, dim=2)     # [2, B, H, Smax, D]
    s = torch.einsum("bhqd,bhsd->bhqs", qt.float(), kv[0].float()) * scale
    pos = torch.arange(nblk * bt, device=qt.device)
    rows = torch.arange(sq, device=qt.device)
    mask = pos[None, None, None, :] <= (cache_lens.long()[:, None, None, None]
                                        + rows[None, None, :, None])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    lsum = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqs,bhsd->bhqd", p.to(pool.dtype).float(),
                     kv[1].float())
    o = o / torch.where(lsum == 0, torch.ones_like(lsum), lsum)
    return o.to(qt.dtype)


# ------------------------------------------------------------ flat stream
def paged_flat_is_supported(t, h, d, pool_shape, dtype,
                            cache_dtype=None) -> bool:
    """q: [t, h, d], t a positive multiple of FLAT_CHUNK; pool: [L, 2, NB,
    Hk, Bt, D]. The same pool rules as ``paged_is_supported``."""
    if len(pool_shape) != 6 or t < FLAT_CHUNK or t % FLAT_CHUNK:
        return False
    return paged_is_supported((1, 1, h, d), pool_shape, dtype, cache_dtype)


def _check_flat(q, pool, tables, chunk_slot, chunk_base, chunk_n, layer):
    name = "decode_attention_paged_flat"
    if q.dim() != 3 or pool.dim() != 6:
        raise ValueError(
            f"{name}: q must be [T, H, D] and pool [L, 2, NB, Hk, Bt, D], "
            f"got {tuple(q.shape)} and {tuple(pool.shape)}")
    t, h, d = q.shape
    if not paged_flat_is_supported(t, h, d, tuple(pool.shape), q.dtype,
                                   cache_dtype=pool.dtype):
        raise ValueError(
            f"{name}: unsupported shapes/dtypes q {tuple(q.shape)} "
            f"{q.dtype}, pool {tuple(pool.shape)} {pool.dtype} (see "
            "paged_flat_is_supported)")
    if tables.dim() != 2 or tables.shape[0] < 1 \
            or tables.dtype != torch.int32:
        raise ValueError(
            f"{name}: tables must be int32 [rows, Smax/Bt], got "
            f"{tables.dtype} {tuple(tables.shape)}")
    for arg, meta in (("chunk_slot", chunk_slot), ("chunk_base", chunk_base),
                      ("chunk_n", chunk_n)):
        if tuple(meta.shape) != (t // FLAT_CHUNK,) \
                or meta.dtype != torch.int32:
            raise ValueError(
                f"{name}: {arg} must be int32 [T / {FLAT_CHUNK}], got "
                f"{meta.dtype} {tuple(meta.shape)}")
    if not 0 <= int(layer) < pool.shape[0]:
        raise ValueError(f"{name}: layer {layer} outside the pool's "
                         f"{pool.shape[0]} layers")
    devs = {x.device for x in (q, pool, tables, chunk_slot, chunk_base,
                               chunk_n)}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices {devs}")


def decode_attention_paged_flat(q, pool, tables, chunk_slot, chunk_base,
                                chunk_n, layer, scale=None):
    """q [T, H, D] -> [T, H, D] in q's dtype: row r of chunk ci (token
    ci * FLAT_CHUNK + r) attends positions <= chunk_base[ci] + r of slot
    chunk_slot[ci] when r < chunk_n[ci], and is 0 otherwise. The chunk's
    own K/V must already be in the pool (write-then-attend)."""
    _check_flat(q, pool, tables, chunk_slot, chunk_base, chunk_n, layer)
    t, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return decode_attention_paged_flat_reference(
            q, pool, tables, chunk_slot, chunk_base, chunk_n, layer, scale)
    if q.device.type != "cuda":
        raise ValueError(
            f"decode_attention_paged_flat: no kernel for device {q.device}")
    args = (("q", q), ("pool", pool), ("tables", tables),
            ("chunk_slot", chunk_slot), ("chunk_base", chunk_base),
            ("chunk_n", chunk_n))
    for name, x in args:
        if not x.is_contiguous():
            raise ValueError(f"decode_attention_paged_flat: {name} must be "
                             "contiguous")
    _, _, nb, hk, bt, _ = pool.shape
    out = torch.empty_like(q)
    fn = _build.load("decode_attention_paged_flat")
    rc = fn(q.data_ptr(), pool.data_ptr(), tables.data_ptr(),
            chunk_slot.data_ptr(), chunk_base.data_ptr(), chunk_n.data_ptr(),
            out.data_ptr(), t, h, d, nb, hk, bt, tables.shape[1],
            tables.shape[0], int(layer), float(scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"decode_attention_paged_flat: kernel launch failed with CUDA "
            f"error {rc} (q {tuple(q.shape)} {q.dtype}, pool "
            f"{tuple(pool.shape)})")
    LAUNCHES["decode_attention_paged_flat"] += 1
    return out


def decode_attention_paged_flat_reference(q, pool, tables, chunk_slot,
                                          chunk_base, chunk_n, layer,
                                          scale=None):
    """The plain version: each chunk's slot row gathered through the
    clamped table (``inference.paged_kv.flat_gather_view``), masked to
    positions <= base + r for rows r < n, softmax in fp32 with p rounded
    to the value dtype before the PV product; rows that attend nothing
    (r >= n, pad chunks) are 0."""
    from ..inference.paged_kv import flat_gather_view
    t, h, d = q.shape
    hk, bt = pool.shape[3], pool.shape[4]
    nc = t // FLAT_CHUNK
    smax = tables.shape[1] * bt
    if scale is None:
        scale = d ** -0.5
    slot = chunk_slot.long().clamp(0, tables.shape[0] - 1)
    kv = flat_gather_view(pool[int(layer)], tables, slot, smax)
    kv = kv.repeat_interleave(h // hk, dim=2)      # [2, nc, H, Smax, D]
    qc = q.reshape(nc, FLAT_CHUNK, h, d).transpose(1, 2).float()
    s = torch.einsum("chrd,chsd->chrs", qc, kv[0]) * scale
    pos = torch.arange(smax, device=q.device)
    rows = torch.arange(FLAT_CHUNK, device=q.device)
    base, n = chunk_base.long(), chunk_n.long()
    mask = ((pos[None, None, :] <= base[:, None, None] + rows[None, :, None])
            & (rows[None, :, None] < n[:, None, None]))[:, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    lsum = p.sum(-1, keepdim=True)
    o = torch.einsum("chrs,chsd->chrd", p.to(pool.dtype).float(), kv[1])
    o = o / torch.where(lsum == 0, torch.ones_like(lsum), lsum)
    return o.transpose(1, 2).reshape(t, h, d).to(q.dtype)
