"""Paged flash-decode attention: the CUDA kernels' wrappers and their
plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/decode_attention.py``'s
``decode_attention_paged``, with the same signature and layouts:

  qt      [B, H, Sq, D]            the new queries, kernel layout
  pool    [L, 2, NB, Hk, Bt, D]    the one shared KV block pool
  tables  [B, Smax/Bt] int32       per-row block tables, sentinel NB
  layer   int                      which layer of the pool to read
  cache_lens [B] int32             query row r attends positions <= lens + r

of its ``decode_attention_paged_flat``, the same attention over the flat
budget dispatch's ragged [T, H, D] query stream in ``FLAT_CHUNK``-token
single-slot chunks with per-chunk (slot, base, count) metadata, and of
the int8 flavors of both, ``decode_attention_paged_i8`` and
``decode_attention_paged_flat_i8``: the pool is int8 and
``pool_scales`` [L, 2, NB, Hk, 1, Bt] fp32 holds each position's scale,
block for block, resolved through the same table entry. Their scores are
``(q . k_int) * scale * k_scale`` and the PV product takes ``p * v_scale``
rounded to the query dtype; the output is in the query dtype.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/decode_attention_paged.cu``, ``csrc/decode_attention_paged_flat.cu``,
``csrc/decode_attention_paged_i8.cu``,
``csrc/decode_attention_paged_flat_i8.cu``) on the current stream or
raises; on a CPU tensor it computes the plain version, which is what the
CPU tests compare against the JAX function.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["decode_attention_paged", "decode_attention_paged_reference",
           "paged_is_supported", "decode_attention_paged_flat",
           "decode_attention_paged_flat_reference", "paged_flat_is_supported",
           "decode_attention_paged_i8", "decode_attention_paged_i8_reference",
           "paged_i8_is_supported", "decode_attention_paged_flat_i8",
           "decode_attention_paged_flat_i8_reference",
           "paged_flat_i8_is_supported", "FLAT_CHUNK", "LAUNCHES"]

NEG_INF = -1e30
MAX_SQ, MAX_D = 128, 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# kernel launches per wrapper, counted where the kernel is launched (the
# plain version on CPU tensors does not count)
LAUNCHES = {"decode_attention_paged": 0, "decode_attention_paged_flat": 0,
            "decode_attention_paged_i8": 0,
            "decode_attention_paged_flat_i8": 0}

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


def paged_i8_is_supported(q_shape, pool_shape, dtype) -> bool:
    """The int8 pool flavor: the layout rules of ``paged_is_supported``
    (every block size the engine makes, so also Bt < 32, where the TPU
    kernel needs Bt % 32 == 0); the compute dtype is the query's."""
    return paged_is_supported(q_shape, pool_shape, dtype)


def _check(name, qt, pool, tables, layer, cache_lens, pool_dtype):
    if qt.dim() != 4 or pool.dim() != 6:
        raise ValueError(
            f"{name}: qt must be [B, H, Sq, D] and pool "
            f"[L, 2, NB, Hk, Bt, D], got {tuple(qt.shape)} and "
            f"{tuple(pool.shape)}")
    b, h, sq, d = qt.shape
    if pool.dtype != pool_dtype or not paged_is_supported(
            (b, sq, h, d), tuple(pool.shape), qt.dtype):
        raise ValueError(
            f"{name}: unsupported shapes/dtypes q {tuple(qt.shape)} "
            f"{qt.dtype}, pool {tuple(pool.shape)} {pool.dtype} (see "
            "paged_is_supported)")
    if tables.dim() != 2 or tables.shape[0] != b \
            or tables.dtype != torch.int32:
        raise ValueError(
            f"{name}: tables must be int32 [B, Smax/Bt], got "
            f"{tables.dtype} {tuple(tables.shape)}")
    if tuple(cache_lens.shape) != (b,) or cache_lens.dtype != torch.int32:
        raise ValueError(
            f"{name}: cache_lens must be int32 [B], got {cache_lens.dtype} "
            f"{tuple(cache_lens.shape)}")
    _check_layer(name, pool, layer)


def _check_layer(name, pool, layer):
    if not 0 <= int(layer) < pool.shape[0]:
        raise ValueError(f"{name}: layer {layer} outside the pool's "
                         f"{pool.shape[0]} layers")


def _check_scales(name, pool, pool_scales):
    want = tuple(pool.shape[:4]) + (1, pool.shape[4])
    if tuple(pool_scales.shape) != want \
            or pool_scales.dtype != torch.float32:
        raise ValueError(
            f"{name}: pool_scales must be fp32 [L, 2, NB, Hk, 1, Bt] = "
            f"{want}, got {pool_scales.dtype} {tuple(pool_scales.shape)}")


def _launch(name, named, out, ints, scale, dtype):
    """Launch kernel ``name`` on the current stream of ``out``'s card:
    the pointers of ``named`` [(arg, tensor)] (each must be contiguous on
    that card) then ``out``, the int arguments, the softmax scale and the
    dtype code. Raises on a refused launch."""
    devs = {t.device for _, t in named} | {out.device}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices {devs}")
    if out.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {out.device}")
    for arg, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    fn = _build.load(name)
    rc = fn(*(t.data_ptr() for _, t in named), out.data_ptr(), *ints,
            float(scale), _DTYPE_CODE[dtype],
            torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{name}: kernel launch failed with CUDA error {rc} ("
            + ", ".join(f"{a} {tuple(t.shape)} {t.dtype}" for a, t in named)
            + ")")
    LAUNCHES[name] += 1
    return out


def decode_attention_paged(qt, pool, tables, layer, cache_lens, scale=None):
    """Returns [B, H, Sq, D] in q's dtype: attention of the new queries
    over each row's table-resolved prefix plus the new positions."""
    name = "decode_attention_paged"
    _check(name, qt, pool, tables, layer, cache_lens, qt.dtype)
    b, h, sq, d = qt.shape
    if scale is None:
        scale = d ** -0.5
    if qt.device.type == "cpu" and len({t.device for t in (
            qt, pool, tables, cache_lens)}) == 1:
        return decode_attention_paged_reference(qt, pool, tables, layer,
                                                cache_lens, scale)
    _, _, nb, hk, bt, _ = pool.shape
    return _launch(name, [("qt", qt), ("pool", pool), ("tables", tables),
                          ("cache_lens", cache_lens)], torch.empty_like(qt),
                   (b, h, sq, d, nb, hk, bt, tables.shape[1], int(layer)),
                   scale, qt.dtype)


def _row_mask(cache_lens, sq, smax, device):
    # [B, 1, Sq, Smax]: query row r of row b attends positions <= lens + r
    pos = torch.arange(smax, device=device)
    rows = torch.arange(sq, device=device)
    return pos[None, None, None, :] <= (cache_lens.long()[:, None, None, None]
                                        + rows[None, None, :, None])


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
    mask = _row_mask(cache_lens, sq, nblk * bt, qt.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    lsum = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqs,bhsd->bhqd", p.to(pool.dtype).float(),
                     kv[1].float())
    o = o / torch.where(lsum == 0, torch.ones_like(lsum), lsum)
    return o.to(qt.dtype)


def decode_attention_paged_i8(qt, pool_i8, pool_scales, tables, layer,
                              cache_lens, scale=None):
    """The int8 pool flavor of ``decode_attention_paged``: pool_i8 [L, 2,
    NB, Hk, Bt, D] int8 with per-position fp32 scales pool_scales [L, 2,
    NB, Hk, 1, Bt]. Returns [B, H, Sq, D] in the query dtype."""
    name = "decode_attention_paged_i8"
    _check(name, qt, pool_i8, tables, layer, cache_lens, torch.int8)
    _check_scales(name, pool_i8, pool_scales)
    b, h, sq, d = qt.shape
    if scale is None:
        scale = d ** -0.5
    if qt.device.type == "cpu" and len({t.device for t in (
            qt, pool_i8, pool_scales, tables, cache_lens)}) == 1:
        return decode_attention_paged_i8_reference(
            qt, pool_i8, pool_scales, tables, layer, cache_lens, scale)
    _, _, nb, hk, bt, _ = pool_i8.shape
    return _launch(name, [("qt", qt), ("pool_i8", pool_i8),
                          ("pool_scales", pool_scales), ("tables", tables),
                          ("cache_lens", cache_lens)], torch.empty_like(qt),
                   (b, h, sq, d, nb, hk, bt, tables.shape[1], int(layer)),
                   scale, qt.dtype)


def _i8_attend(q, kvi, sc, mask, scale, out_dtype):
    """The int8 kernels' arithmetic on dense views: q [..., R, D] fp32,
    kvi [2, ..., S, D] the integer K/V values as fp32, sc [2, ..., S, 1]
    their scales, mask [..., R, S]. Scores (q . k) * scale * k_scale, an
    fp32 softmax whose sum l takes the unscaled p, then (p * v_scale)
    rounded to out_dtype before the PV product; rows that attend nothing
    return 0."""
    s = q @ kvi[0].transpose(-1, -2) * scale * sc[0].transpose(-1, -2)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    lsum = p.sum(-1, keepdim=True)
    pv = (p * sc[1].transpose(-1, -2)).to(out_dtype).float()
    o = (pv @ kvi[1]) / torch.where(lsum == 0, torch.ones_like(lsum), lsum)
    return o.to(out_dtype)


def _gather_i8(pool_i8, pool_scales, tables, rows, layer, h):
    """Each row of ``rows`` (indices into ``tables``) resolved into dense
    integer K/V [2, R, H, Smax, D] fp32 and scales [2, R, H, Smax, 1]
    (``flat_gather_view`` of the pool and of the scales; GQA heads
    repeated)."""
    from ..inference.paged_kv import flat_gather_view
    hk, bt = pool_i8.shape[3], pool_i8.shape[4]
    smax = tables.shape[1] * bt
    kvi = flat_gather_view(pool_i8[int(layer)], tables, rows, smax)
    sc = flat_gather_view(pool_scales[int(layer)].transpose(-1, -2), tables,
                          rows, smax)
    return (kvi.repeat_interleave(h // hk, dim=2),
            sc.repeat_interleave(h // hk, dim=2))


def decode_attention_paged_i8_reference(qt, pool_i8, pool_scales, tables,
                                        layer, cache_lens, scale=None):
    """The plain version: each row's integer K/V and scales gathered
    through the clamped table, masked block-causally, then the int8
    kernel's arithmetic (``_i8_attend``)."""
    b, h, sq, d = qt.shape
    if scale is None:
        scale = d ** -0.5
    rows = torch.arange(b, device=qt.device)
    kvi, sc = _gather_i8(pool_i8, pool_scales, tables, rows, layer, h)
    mask = _row_mask(cache_lens, sq, kvi.shape[3], qt.device)
    return _i8_attend(qt.float(), kvi, sc, mask, scale, qt.dtype)


# ------------------------------------------------------------ flat stream
def paged_flat_is_supported(t, h, d, pool_shape, dtype,
                            cache_dtype=None) -> bool:
    """q: [t, h, d], t a positive multiple of FLAT_CHUNK; pool: [L, 2, NB,
    Hk, Bt, D]. The same pool rules as ``paged_is_supported``."""
    if len(pool_shape) != 6 or t < FLAT_CHUNK or t % FLAT_CHUNK:
        return False
    return paged_is_supported((1, 1, h, d), pool_shape, dtype, cache_dtype)


def paged_flat_i8_is_supported(t, h, d, pool_shape, dtype) -> bool:
    """The int8 pool flavor of ``paged_flat_is_supported`` (every block
    size the engine makes; the compute dtype is the query's)."""
    return paged_flat_is_supported(t, h, d, pool_shape, dtype)


def _check_flat(name, q, pool, tables, chunk_slot, chunk_base, chunk_n,
                layer, pool_dtype):
    if q.dim() != 3 or pool.dim() != 6:
        raise ValueError(
            f"{name}: q must be [T, H, D] and pool [L, 2, NB, Hk, Bt, D], "
            f"got {tuple(q.shape)} and {tuple(pool.shape)}")
    t, h, d = q.shape
    if pool.dtype != pool_dtype or not paged_flat_is_supported(
            t, h, d, tuple(pool.shape), q.dtype):
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
    _check_layer(name, pool, layer)


def decode_attention_paged_flat(q, pool, tables, chunk_slot, chunk_base,
                                chunk_n, layer, scale=None):
    """q [T, H, D] -> [T, H, D] in q's dtype: row r of chunk ci (token
    ci * FLAT_CHUNK + r) attends positions <= chunk_base[ci] + r of slot
    chunk_slot[ci] when r < chunk_n[ci], and is 0 otherwise. The chunk's
    own K/V must already be in the pool (write-then-attend)."""
    name = "decode_attention_paged_flat"
    _check_flat(name, q, pool, tables, chunk_slot, chunk_base, chunk_n,
                layer, q.dtype)
    t, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    meta = (("chunk_slot", chunk_slot), ("chunk_base", chunk_base),
            ("chunk_n", chunk_n))
    if q.device.type == "cpu" and len({x.device for x in (
            q, pool, tables, chunk_slot, chunk_base, chunk_n)}) == 1:
        return decode_attention_paged_flat_reference(
            q, pool, tables, chunk_slot, chunk_base, chunk_n, layer, scale)
    _, _, nb, hk, bt, _ = pool.shape
    return _launch(name, [("q", q), ("pool", pool), ("tables", tables),
                          *meta], torch.empty_like(q),
                   (t, h, d, nb, hk, bt, tables.shape[1], tables.shape[0],
                    int(layer)), scale, q.dtype)


def _chunk_mask(chunk_base, chunk_n, smax, device):
    # [nc, 1, FLAT_CHUNK, Smax]: row r of chunk ci attends positions
    # <= base + r when r < n
    pos = torch.arange(smax, device=device)
    rows = torch.arange(FLAT_CHUNK, device=device)
    base, n = chunk_base.long(), chunk_n.long()
    return ((pos[None, None, :] <= base[:, None, None] + rows[None, :, None])
            & (rows[None, :, None] < n[:, None, None]))[:, None]


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
    mask = _chunk_mask(chunk_base, chunk_n, smax, q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    lsum = p.sum(-1, keepdim=True)
    o = torch.einsum("chrs,chsd->chrd", p.to(pool.dtype).float(), kv[1])
    o = o / torch.where(lsum == 0, torch.ones_like(lsum), lsum)
    return o.transpose(1, 2).reshape(t, h, d).to(q.dtype)


def decode_attention_paged_flat_i8(q, pool_i8, pool_scales, tables,
                                   chunk_slot, chunk_base, chunk_n, layer,
                                   scale=None):
    """The int8 pool flavor of ``decode_attention_paged_flat``: pool_i8
    int8 with pool_scales [L, 2, NB, Hk, 1, Bt] fp32, resolved through
    the same chunk table walk. Returns [T, H, D] in the query dtype."""
    name = "decode_attention_paged_flat_i8"
    _check_flat(name, q, pool_i8, tables, chunk_slot, chunk_base, chunk_n,
                layer, torch.int8)
    _check_scales(name, pool_i8, pool_scales)
    t, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    meta = (("chunk_slot", chunk_slot), ("chunk_base", chunk_base),
            ("chunk_n", chunk_n))
    if q.device.type == "cpu" and len({x.device for x in (
            q, pool_i8, pool_scales, tables, chunk_slot, chunk_base,
            chunk_n)}) == 1:
        return decode_attention_paged_flat_i8_reference(
            q, pool_i8, pool_scales, tables, chunk_slot, chunk_base, chunk_n,
            layer, scale)
    _, _, nb, hk, bt, _ = pool_i8.shape
    return _launch(name, [("q", q), ("pool_i8", pool_i8),
                          ("pool_scales", pool_scales), ("tables", tables),
                          *meta], torch.empty_like(q),
                   (t, h, d, nb, hk, bt, tables.shape[1], tables.shape[0],
                    int(layer)), scale, q.dtype)


def decode_attention_paged_flat_i8_reference(q, pool_i8, pool_scales,
                                             tables, chunk_slot, chunk_base,
                                             chunk_n, layer, scale=None):
    """The plain version: each chunk's slot row of integer K/V and
    scales gathered through the clamped table, the flat chunk mask, then
    the int8 kernel's arithmetic (``_i8_attend``); rows that attend
    nothing are 0."""
    t, h, d = q.shape
    nc = t // FLAT_CHUNK
    if scale is None:
        scale = d ** -0.5
    slot = chunk_slot.long().clamp(0, tables.shape[0] - 1)
    kvi, sc = _gather_i8(pool_i8, pool_scales, tables, slot, layer, h)
    mask = _chunk_mask(chunk_base, chunk_n, kvi.shape[3], q.device)
    qc = q.reshape(nc, FLAT_CHUNK, h, d).transpose(1, 2).float()
    o = _i8_attend(qc, kvi, sc, mask, scale, q.dtype)
    return o.transpose(1, 2).reshape(t, h, d)
