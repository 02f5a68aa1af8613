"""Flash-decode attention over the paged KV pool and the dense KV ring:
the CUDA kernels' wrappers and their plain PyTorch versions.

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

The one-layer cache of ``fused_multi_transformer`` has the counterparts
of the JAX ``decode_attention_bhsd`` (queries ``[B, H, Sq, D]`` over K and
V caches ``[B, Hk, Smax, D]``, two tensors, with per-row lens: query row
r attends positions <= lens[b] + r) and ``decode_attention``, the same
in the model layout (``[B, Sq, H, D]`` over ``[B, Smax, Hk, D]``).

The dense ring ``[L, 2, B, Hk, Smax, D]`` (``FusedDecoder.init_cache``;
Smax a multiple of 128) has the counterparts of the JAX stacked kernels:
``decode_attention_stacked`` (query row r of row b attends layer
``layer``'s positions <= lens[b] + r), ``decode_attention_stacked_i8``
(an int8 ring with fp32 scales [L, 2, B, Hk, 1, Smax], positions on the
last axis), and the fused write+attend kernels for one new token per row,
``decode_attention_stacked_write`` and ``decode_attention_stacked_i8_write``
(which quantizes the new row itself): the new K/V row lands in the ring
IN PLACE at lens[b] (dropped when lens[b] == Smax), and the query attends
the prefix < lens[b] plus the new token, seeded from ``kv_new``. The ring
is a pool of B blocks of Smax positions with one block per row, so the
plain versions reuse the paged ones through that table.

The five reads, ``decode_attention_paged``, ``decode_attention_paged_i8``,
``decode_attention_stacked``, ``decode_attention_stacked_i8`` and
``decode_attention_bhsd``, the two fused writes,
``decode_attention_stacked_write`` and ``decode_attention_stacked_i8_write``,
and the flat streams' ``decode_attention_paged_flat`` and
``decode_attention_paged_flat_i8`` have two designs each, picked by
``paged_path`` from the dtype and D alone, the one place the rule is
stated: bf16 and fp16 at D a multiple of 8 take
``"split_kv"`` (``csrc/split_decode.cuh``: the KV length split into
ranges, each a block per row and KV head holding the GQA group's query
rows, partials merged in split order; the fp pool read's ranges are
``paged_splits`` table blocks, the others' ``decode_splits`` 64-position
tiles, a ring or the one-layer cache read as a pool of one Smax-position
block per row; the writes' ranges stop below lens[b], and range 0 seeds
with the new token and stores it; the flat stream's chunks of FLAT_CHUNK
tokens are its rows, each over its slot's table row, both pools' streams
cut by ``decode_splits``), everything else ``"per_head"`` (one block per
row and head, fp32 staging). ``PATH_LAUNCHES`` counts each
kernel's launches by design; the C entries run the design they are given
or fail.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/decode_attention_paged.cu``, ``csrc/decode_attention_paged_flat.cu``,
``csrc/decode_attention_bhsd.cu``,
``csrc/decode_attention_paged_i8.cu``,
``csrc/decode_attention_paged_flat_i8.cu``,
``csrc/decode_attention_stacked.cu``, ``csrc/decode_attention_stacked_i8.cu``,
``csrc/decode_attention_stacked_write.cu``,
``csrc/decode_attention_stacked_i8_write.cu``) on the current stream or
raises; on a CPU tensor it computes the plain version, which is what the
CPU tests compare against the JAX function.
"""
from __future__ import annotations

import functools

import torch

from . import _build

__all__ = ["decode_attention_paged", "decode_attention_paged_reference",
           "decode_attention_paged_split_reference",
           "paged_is_supported", "decode_attention_paged_flat",
           "decode_attention_paged_flat_reference", "paged_flat_is_supported",
           "decode_attention_paged_i8", "decode_attention_paged_i8_reference",
           "paged_i8_is_supported", "decode_attention_paged_flat_i8",
           "decode_attention_paged_flat_i8_reference",
           "paged_flat_i8_is_supported", "decode_attention_stacked",
           "decode_attention_stacked_reference", "stacked_is_supported",
           "decode_attention_stacked_i8",
           "decode_attention_stacked_i8_reference",
           "stacked_i8_is_supported", "decode_attention_stacked_write",
           "decode_attention_stacked_write_reference",
           "stacked_write_is_supported",
           "decode_attention_stacked_i8_write",
           "decode_attention_stacked_i8_write_reference",
           "stacked_i8_write_is_supported", "ring_table", "FLAT_CHUNK",
           "decode_attention", "decode_attention_bhsd",
           "decode_attention_bhsd_reference", "is_supported", "paged_path",
           "paged_splits", "decode_splits",
           "decode_attention_paged_i8_split_reference",
           "decode_attention_stacked_i8_split_reference",
           "decode_attention_stacked_split_reference",
           "decode_attention_bhsd_split_reference",
           "decode_attention_stacked_write_split_reference",
           "decode_attention_stacked_i8_write_split_reference",
           "decode_attention_paged_flat_i8_split_reference",
           "decode_attention_paged_flat_split_reference", "LAUNCHES",
           "PATH_LAUNCHES"]

NEG_INF = -1e30
MAX_SQ, MAX_D = 128, 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# kernel launches per wrapper, counted where the kernel is launched (the
# plain version on CPU tensors does not count)
LAUNCHES = {"decode_attention_paged": 0, "decode_attention_paged_flat": 0,
            "decode_attention_paged_i8": 0,
            "decode_attention_paged_flat_i8": 0,
            "decode_attention_stacked": 0, "decode_attention_stacked_i8": 0,
            "decode_attention_stacked_write": 0,
            "decode_attention_stacked_i8_write": 0,
            "decode_attention_bhsd": 0}
# the launches of the kernels with two designs, by the design that ran
# them (paged_path)
PATH_LAUNCHES = {name: {"split_kv": 0, "per_head": 0}
                 for name in ("decode_attention_paged",
                              "decode_attention_paged_i8",
                              "decode_attention_stacked",
                              "decode_attention_stacked_i8",
                              "decode_attention_bhsd",
                              "decode_attention_stacked_write",
                              "decode_attention_stacked_i8_write",
                              "decode_attention_paged_flat",
                              "decode_attention_paged_flat_i8")}
_PATH_CODE = {"split_kv": 1, "per_head": 0}
# the split rule: blocks of the split design a wave counts per SM (a full
# table's blocks; rows shorter than the table leave the later ranges
# empty, so the blocks that work are fewer; 8 ran the fp decode shape
# fastest of 2, 4, 8 and 16), the fewest positions a split takes, and
# the range unit of the reads cut in positions (the kernel's tile)
_WAVE_BLOCKS_PER_SM = 8
_MIN_SPLIT_POSITIONS = 128
_SPLIT_TILE = 64

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
    # a pool's [L, 2, NB, Hk, 1, Bt] or a ring's [L, 2, B, Hk, 1, Smax]
    want = tuple(pool.shape[:4]) + (1, pool.shape[4])
    if tuple(pool_scales.shape) != want \
            or pool_scales.dtype != torch.float32:
        raise ValueError(
            f"{name}: scales must be fp32 [L, 2, NB, Hk, 1, Bt] (a ring's "
            f"[L, 2, B, Hk, 1, Smax]) = {want}, got {pool_scales.dtype} "
            f"{tuple(pool_scales.shape)}")


def _all_cpu(*tensors):
    """Whether every tensor lies on the CPU: the wrappers then compute
    their plain versions (a CUDA tensor among them launches, or
    raises)."""
    return all(t.device.type == "cpu" for t in tensors)


def _launch(name, named, out, ints, scale, dtype, extra=(), path=None):
    """Launch kernel ``name`` on the current stream of ``out``'s card:
    the pointers of ``named`` [(arg, tensor)] (each must be contiguous on
    that card), ``out``, then those of ``extra`` (the split design's
    workspace), the int arguments, the softmax scale, the dtype code and,
    for a kernel with two designs, the design ``path`` (``paged_path``'s).
    Raises on an unknown path and on a refused launch (naming the shapes
    and the path: no other design is tried)."""
    if path is not None and path not in _PATH_CODE:
        raise ValueError(f"{name}: unknown kernel path {path!r}, not one of "
                         f"{sorted(_PATH_CODE)}")
    devs = {t.device for _, t in [*named, *extra]} | {out.device}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices {devs}")
    if out.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {out.device}")
    for arg, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    fn = _build.load(name)
    design = () if path is None else (_PATH_CODE[path],)
    rc = fn(*(t.data_ptr() for _, t in named), out.data_ptr(),
            *(t.data_ptr() for _, t in extra), *ints, float(scale),
            _DTYPE_CODE[dtype], *design,
            torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{name}: kernel launch failed with CUDA error {rc} ("
            + ", ".join(f"{a} {tuple(t.shape)} {t.dtype}" for a, t in named)
            + (")" if path is None else f"; {path})"))
    LAUNCHES[name] += 1
    if path is not None:
        PATH_LAUNCHES[name][path] += 1
    return out


def paged_path(dtype, d) -> str:
    """The design of the five reads, ``decode_attention_paged``,
    ``decode_attention_paged_i8``, ``decode_attention_stacked``,
    ``decode_attention_stacked_i8`` and ``decode_attention_bhsd``, of
    the two fused writes, ``decode_attention_stacked_write`` and
    ``decode_attention_stacked_i8_write``, and of the flat streams'
    ``decode_attention_paged_flat`` and ``decode_attention_paged_flat_i8``,
    for queries of ``dtype`` at head dim ``d``: ``"split_kv"``
    (split_decode.cuh, tensor cores) for bf16 and fp16 at D a multiple of
    8, else ``"per_head"``. The wrappers pass it to the C entries, which
    run that design or fail."""
    if dtype in (torch.bfloat16, torch.float16) and d % 8 == 0:
        return "split_kv"
    return "per_head"


def _split_units(b, hk, n_pos, unit, n_sm):
    """(S, per) of the split design: the n_pos positions of each (row,
    KV head) in S ranges of ``per`` units of ``unit`` positions, from the
    shapes and the card's SM count only (never from ``cache_lens``: the
    launch reads nothing back and can be captured in a CUDA graph). S is
    1 where the B * Hk blocks already fill a wave (_WAVE_BLOCKS_PER_SM an
    SM); else the fewest ranges that fill one, no range under
    _MIN_SPLIT_POSITIONS positions (nor under one unit). S =
    ceil(units / per), so the ranges cover every position once."""
    units = -(-n_pos // unit)
    blocks, wave = b * hk, _WAVE_BLOCKS_PER_SM * n_sm
    if blocks >= wave:
        return 1, units
    most = max(1, min(units, n_pos // _MIN_SPLIT_POSITIONS))
    per = -(-units // min(most, -(-wave // blocks)))
    return -(-units // per), per


def paged_splits(b, hk, nblk, bt, n_sm):
    """(S, cb) of the fp pool's split design: ranges of cb whole table
    blocks (``_split_units`` with the block as the unit), S = ceil(nblk /
    cb), so the ranges cover every block exactly once."""
    return _split_units(b, hk, nblk * bt, bt, n_sm)


def decode_splits(b, hk, n_pos, n_sm):
    """(S, span) of the split design cut in positions (the int8 flavors,
    the fp ring and the one-layer cache): ranges of ``span`` positions,
    whole 64-position tiles of the kernel (``_split_units`` with the tile
    as the unit), over a pool's nblk * Bt positions or a contiguous
    cache's Smax alike (any Smax: the last tile is cut at it). S =
    ceil(n_pos / span)."""
    s, per = _split_units(b, hk, n_pos, _SPLIT_TILE, n_sm)
    return s, per * _SPLIT_TILE


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split_work(splits, qt):
    """The split design's fp32 workspace for queries ``qt`` [B, H, Sq,
    D] (or the flat stream's [T, H, D]): the partials o [S, rows, D] and
    (m, l) [S, rows, 2] over its rows = B*H*Sq (T*H) query rows (one
    unused float when S is 1)."""
    rows = qt.numel() // qt.shape[-1]
    return torch.empty(
        (splits * rows * (qt.shape[-1] + 2) if splits > 1 else 1,),
        dtype=torch.float32, device=qt.device)


def _range_splits(qt, hk, n_pos):
    """(path, S, span) of a read cut in positions (the int8 flavors, the
    fp ring, the one-layer cache) over n_pos positions a row of queries
    ``qt`` [B, H, Sq, D] (the flat stream: [T / 8, 8, H, D], a chunk a
    row): the design from ``paged_path``, the ranges from
    ``decode_splits`` (one range of n_pos for the per-head design)."""
    b, _, _, d = qt.shape
    path = paged_path(qt.dtype, d)
    if path != "split_kv" or qt.device.type != "cuda":
        return path, 1, n_pos
    return (path, *decode_splits(b, hk, n_pos, _sm_count(qt.device.index)))


def decode_attention_paged(qt, pool, tables, layer, cache_lens, scale=None):
    """Returns [B, H, Sq, D] in q's dtype: attention of the new queries
    over each row's table-resolved prefix plus the new positions."""
    name = "decode_attention_paged"
    _check(name, qt, pool, tables, layer, cache_lens, qt.dtype)
    b, h, sq, d = qt.shape
    if scale is None:
        scale = d ** -0.5
    if _all_cpu(qt, pool, tables, cache_lens):
        return decode_attention_paged_reference(qt, pool, tables, layer,
                                                cache_lens, scale)
    _, _, nb, hk, bt, _ = pool.shape
    nblk = tables.shape[1]
    path = paged_path(qt.dtype, d)
    splits, cb = 1, nblk
    if path == "split_kv" and qt.device.type == "cuda":
        splits, cb = paged_splits(b, hk, nblk, bt, _sm_count(qt.device.index))
    work = _split_work(splits, qt)
    return _launch(name, [("qt", qt), ("pool", pool), ("tables", tables),
                          ("cache_lens", cache_lens)], torch.empty_like(qt),
                   (b, h, sq, d, nb, hk, bt, nblk, int(layer), splits, cb),
                   scale, qt.dtype, extra=[("work", work)], path=path)


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
    mask = _row_mask(cache_lens, sq, nblk * bt, qt.device)
    return _fp_attend(qt.float(), kv.float(), mask, scale, pool.dtype,
                      qt.dtype)


def decode_attention_paged_split_reference(qt, pool, tables, layer,
                                           cache_lens, scale=None, splits=1):
    """The split design's arithmetic in plain PyTorch: the KV length in
    ``splits`` ranges of cb = ceil(nblk / splits) table blocks, each
    range's fp32 partial (its own max m, the sum l of the unrounded p, o
    the PV product of p rounded to the value dtype), then the partials
    merged in split order with the usual rescaling; a range or row with
    nothing to attend contributes nothing, and a row with nothing at all
    returns 0. Equal to ``decode_attention_paged_reference`` but for
    where p is rounded."""
    b, h, sq, d = qt.shape
    _, _, nb, hk, bt, _ = pool.shape
    nblk = tables.shape[1]
    if scale is None:
        scale = d ** -0.5
    cb = -(-nblk // splits)
    tc = tables.long().clamp(max=nb - 1)
    kv = pool[int(layer)][:, tc].permute(0, 1, 3, 2, 4, 5).reshape(
        2, b, hk, nblk * bt, d).repeat_interleave(h // hk, dim=2).float()
    mask = _row_mask(cache_lens, sq, nblk * bt, qt.device)
    s = qt.float() @ kv[0].transpose(-1, -2) * scale
    return _split_merge(s, mask, kv[1], cb * bt, pool.dtype, qt.dtype)


def _split_merge(s, mask, v, span, p_dtype, out_dtype, v_scale=None,
                 lead=0):
    """The split design's softmax on dense views: s [..., R, S] the
    scores (fp32), mask [..., R, S], v [..., S, D] fp32, v_scale (int8)
    [..., 1, S]. Each range of ``span`` positions keeps its own fp32
    partial (its max m, the sum l of the unrounded, unscaled p, o the PV
    product of p (int8: p * v_scale) rounded to p_dtype); the partials
    merge in split order with the usual rescaling. The first ``lead``
    columns belong to the first range besides its ``span`` (the write
    kernels' new token, which their range 0 seeds). A range or row with
    nothing to attend contributes nothing; a row with nothing returns 0."""
    n = s.shape[-1]
    los = [0, *range(lead + span, n, span)]
    m_all = torch.full(s.shape[:-1] + (1,), NEG_INF, device=s.device)
    parts = []
    for lo, hi in zip(los, [*los[1:], n]):
        mk = mask[..., lo:hi]
        sc = torch.where(mk, s[..., lo:hi], torch.full_like(s[..., lo:hi],
                                                            NEG_INF))
        m = sc.amax(-1, keepdim=True)
        p = torch.where(mk, torch.exp(sc - m), torch.zeros_like(sc))
        pv = p if v_scale is None else p * v_scale[..., lo:hi]
        parts.append((m, p.sum(-1, keepdim=True),
                      pv.to(p_dtype).float() @ v[..., lo:hi, :]))
        m_all = torch.maximum(m_all, m)
    lsum = torch.zeros_like(m_all)
    o = torch.zeros(s.shape[:-1] + v.shape[-1:], device=s.device)
    for m, l, part in parts:
        w = torch.where(l > 0, torch.exp(m - m_all), torch.zeros_like(l))
        lsum = lsum + w * l
        o = o + w * part
    return (o / torch.where(lsum == 0, torch.ones_like(lsum), lsum)).to(
        out_dtype)


def _fp_attend(q, kv, mask, scale, p_dtype, out_dtype):
    """The fp kernels' arithmetic on dense views: q [..., R, D] fp32, kv
    [2, ..., S, D] fp32, mask [..., R, S]. Scores and an fp32 softmax
    whose sum l takes the unrounded p, then p rounded to p_dtype (the
    value dtype) before the PV product; rows that attend nothing return
    0."""
    s = q @ kv[0].transpose(-1, -2) * scale
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    lsum = p.sum(-1, keepdim=True)
    o = (p.to(p_dtype).float() @ kv[1]) / torch.where(
        lsum == 0, torch.ones_like(lsum), lsum)
    return o.to(out_dtype)


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
    if _all_cpu(qt, pool_i8, pool_scales, tables, cache_lens):
        return decode_attention_paged_i8_reference(
            qt, pool_i8, pool_scales, tables, layer, cache_lens, scale)
    _, _, nb, hk, bt, _ = pool_i8.shape
    nblk = tables.shape[1]
    path, splits, span = _range_splits(qt, hk, nblk * bt)
    return _launch(name, [("qt", qt), ("pool_i8", pool_i8),
                          ("pool_scales", pool_scales), ("tables", tables),
                          ("cache_lens", cache_lens)], torch.empty_like(qt),
                   (b, h, sq, d, nb, hk, bt, nblk, int(layer), splits, span),
                   scale, qt.dtype, extra=[("work", _split_work(splits, qt))],
                   path=path)


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


def decode_attention_paged_i8_split_reference(qt, pool_i8, pool_scales,
                                              tables, layer, cache_lens,
                                              scale=None, splits=1):
    """The int8 split design's arithmetic in plain PyTorch: each row's
    nblk * Bt positions in ``splits`` ranges of span = ceil(nblk * Bt /
    splits) positions (the kernel's ranges are whole 64-position tiles,
    ``decode_splits``), each range's fp32 partial over scores (q . k_int)
    * scale * k_scale (l sums the unscaled p, o takes p * v_scale rounded
    to the query dtype), merged in split order (``_split_merge``). Equal
    to ``decode_attention_paged_i8_reference`` but for where p is
    rounded."""
    b, h, sq, d = qt.shape
    if scale is None:
        scale = d ** -0.5
    rows = torch.arange(b, device=qt.device)
    kvi, sc = _gather_i8(pool_i8, pool_scales, tables, rows, layer, h)
    n_pos = kvi.shape[3]
    mask = _row_mask(cache_lens, sq, n_pos, qt.device)
    s = qt.float() @ kvi[0].transpose(-1, -2) * scale * sc[0].transpose(
        -1, -2)
    return _split_merge(s, mask, kvi[1], -(-n_pos // splits), qt.dtype,
                        qt.dtype, sc[1].transpose(-1, -2))


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
    if _all_cpu(q, pool, tables, chunk_slot, chunk_base, chunk_n):
        return decode_attention_paged_flat_reference(
            q, pool, tables, chunk_slot, chunk_base, chunk_n, layer, scale)
    _, _, nb, hk, bt, _ = pool.shape
    nblk = tables.shape[1]
    # a chunk of FLAT_CHUNK tokens is a row of the split design, its ranges
    # cut as the int8 flat stream's are (decode_splits: 64-position tiles,
    # since the kernel resolves each position through the table, and one
    # rule for both pools' flat streams)
    path, splits, span = _range_splits(
        q.reshape(t // FLAT_CHUNK, FLAT_CHUNK, h, d), hk, nblk * bt)
    return _launch(name, [("q", q), ("pool", pool), ("tables", tables),
                          *meta], torch.empty_like(q),
                   (t, h, d, nb, hk, bt, nblk, tables.shape[0], int(layer),
                    splits, span), scale, q.dtype,
                   extra=[("work", _split_work(splits, q))], path=path)


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
    mask = _chunk_mask(chunk_base, chunk_n, smax, q.device)
    o = _fp_attend(qc, kv, mask, scale, pool.dtype, q.dtype)
    return o.transpose(1, 2).reshape(t, h, d)


def decode_attention_paged_flat_split_reference(q, pool, tables, chunk_slot,
                                                chunk_base, chunk_n, layer,
                                                scale=None, splits=1):
    """The fp split design's flat mode in plain PyTorch: each chunk's slot
    row of nblk * Bt positions in ``splits`` ranges of span = ceil(nblk *
    Bt / splits) positions (the kernel's ranges are whole 64-position
    tiles, ``decode_splits`` over T / FLAT_CHUNK chunks), each range's
    fp32 partial (l sums the unrounded p, o takes p rounded to the pool
    dtype), merged in split order (``_split_merge``); rows that attend
    nothing (r >= n, pad chunks) are 0. Equal to
    ``decode_attention_paged_flat_reference`` but for where p is
    rounded."""
    from ..inference.paged_kv import flat_gather_view
    t, h, d = q.shape
    hk, bt = pool.shape[3], pool.shape[4]
    nc = t // FLAT_CHUNK
    n_pos = tables.shape[1] * bt
    if scale is None:
        scale = d ** -0.5
    slot = chunk_slot.long().clamp(0, tables.shape[0] - 1)
    kv = flat_gather_view(pool[int(layer)], tables, slot, n_pos)
    kv = kv.repeat_interleave(h // hk, dim=2).float()  # [2, nc, H, S, D]
    qc = q.reshape(nc, FLAT_CHUNK, h, d).transpose(1, 2).float()
    mask = _chunk_mask(chunk_base, chunk_n, n_pos, q.device)
    s = qc @ kv[0].transpose(-1, -2) * scale
    o = _split_merge(s, mask, kv[1], -(-n_pos // splits), pool.dtype,
                     q.dtype)
    return o.transpose(1, 2).reshape(t, h, d)


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
    if _all_cpu(q, pool_i8, pool_scales, tables, chunk_slot, chunk_base,
                chunk_n):
        return decode_attention_paged_flat_i8_reference(
            q, pool_i8, pool_scales, tables, chunk_slot, chunk_base, chunk_n,
            layer, scale)
    _, _, nb, hk, bt, _ = pool_i8.shape
    nblk = tables.shape[1]
    # a chunk of FLAT_CHUNK tokens is a row of the split design
    path, splits, span = _range_splits(
        q.reshape(t // FLAT_CHUNK, FLAT_CHUNK, h, d), hk, nblk * bt)
    return _launch(name, [("q", q), ("pool_i8", pool_i8),
                          ("pool_scales", pool_scales), ("tables", tables),
                          *meta], torch.empty_like(q),
                   (t, h, d, nb, hk, bt, nblk, tables.shape[0], int(layer),
                    splits, span), scale, q.dtype,
                   extra=[("work", _split_work(splits, q))], path=path)


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


def decode_attention_paged_flat_i8_split_reference(
        q, pool_i8, pool_scales, tables, chunk_slot, chunk_base, chunk_n,
        layer, scale=None, splits=1):
    """The int8 split design's flat mode in plain PyTorch: each chunk's
    slot row of nblk * Bt positions in ``splits`` ranges of span =
    ceil(nblk * Bt / splits) positions (the kernel's ranges are whole
    64-position tiles, ``decode_splits`` over T / FLAT_CHUNK chunks), each
    range's fp32 partial over scores (q . k_int) * scale * k_scale (l sums
    the unscaled p, o takes p * v_scale rounded to the query dtype),
    merged in split order (``_split_merge``); rows that attend nothing
    (r >= n, pad chunks) are 0. Equal to
    ``decode_attention_paged_flat_i8_reference`` but for where p is
    rounded."""
    t, h, d = q.shape
    nc = t // FLAT_CHUNK
    if scale is None:
        scale = d ** -0.5
    slot = chunk_slot.long().clamp(0, tables.shape[0] - 1)
    kvi, sc = _gather_i8(pool_i8, pool_scales, tables, slot, layer, h)
    n_pos = kvi.shape[3]
    mask = _chunk_mask(chunk_base, chunk_n, n_pos, q.device)
    qc = q.reshape(nc, FLAT_CHUNK, h, d).transpose(1, 2).float()
    s = qc @ kvi[0].transpose(-1, -2) * scale * sc[0].transpose(-1, -2)
    o = _split_merge(s, mask, kvi[1], -(-n_pos // splits), q.dtype, q.dtype,
                     sc[1].transpose(-1, -2))
    return o.transpose(1, 2).reshape(t, h, d)


# ------------------------------------------------------- one-layer cache
def is_supported(q_shape, cache_shape, dtype) -> bool:
    """The JAX gate of ``decode_attention``: q [B, Sq, H, D], cache [B,
    Smax, Hk, D] (the model layout); Sq <= 128, D <= 256, Hk | H, fp32,
    bf16 or fp16."""
    if len(q_shape) != 4 or len(cache_shape) != 4:
        return False
    if q_shape[-1] > MAX_D or q_shape[1] > MAX_SQ:
        return False
    if q_shape[2] % cache_shape[2] != 0:
        return False
    return dtype in _DTYPE_CODE


def decode_attention_bhsd(qt, kt, vt, cache_lens, scale=None):
    """qt [B, H, Sq, D], kt and vt [B, Hk, Smax, D] -> [B, H, Sq, D] in
    qt's dtype: query row r of row b attends positions <= cache_lens[b] +
    r of its KV head (the new tokens' K/V already written; positions end
    at Smax). A cache in another dtype is cast to qt's first, as the JAX
    function does."""
    name = "decode_attention_bhsd"
    if qt.dim() != 4 or kt.dim() != 4 or kt.shape != vt.shape:
        raise ValueError(f"{name}: qt must be [B, H, Sq, D] and kt, vt one "
                         f"[B, Hk, Smax, D], got {tuple(qt.shape)}, "
                         f"{tuple(kt.shape)}, {tuple(vt.shape)}")
    b, h, sq, d = qt.shape
    _, hk, smax, _ = kt.shape
    if kt.shape[0] != b or kt.shape[3] != d or smax < 1 or not is_supported(
            (b, sq, h, d), (b, smax, hk, d), qt.dtype) or sq < 1:
        raise ValueError(f"{name}: unsupported q {tuple(qt.shape)} "
                         f"{qt.dtype}, cache {tuple(kt.shape)} (see "
                         "is_supported)")
    if tuple(cache_lens.shape) != (b,):
        raise ValueError(f"{name}: cache_lens must be [B], got "
                         f"{tuple(cache_lens.shape)}")
    kt, vt = kt.to(qt.dtype), vt.to(qt.dtype)
    lens = cache_lens.to(torch.int32)
    if scale is None:
        scale = d ** -0.5
    if _all_cpu(qt, kt, vt, lens):
        return decode_attention_bhsd_reference(qt, kt, vt, lens, scale)
    path, splits, span = _range_splits(qt, hk, smax)
    return _launch(name, [("qt", qt), ("kt", kt), ("vt", vt),
                          ("cache_lens", lens)], torch.empty_like(qt),
                   (b, h, sq, d, hk, smax, splits, span), scale, qt.dtype,
                   extra=[("work", _split_work(splits, qt))], path=path)


def decode_attention_bhsd_reference(qt, kt, vt, cache_lens, scale=None):
    """The plain version: each query head reads its KV head's dense [Smax,
    D] rows, masked block-causally, through ``_fp_attend``."""
    b, h, sq, d = qt.shape
    if scale is None:
        scale = d ** -0.5
    kv = torch.stack([kt, vt]).to(qt.dtype).repeat_interleave(
        h // kt.shape[1], dim=2)                  # [2, B, H, Smax, D]
    mask = _row_mask(cache_lens, sq, kt.shape[2], qt.device)
    return _fp_attend(qt.float(), kv.float(), mask, scale, qt.dtype,
                      qt.dtype)


def decode_attention_bhsd_split_reference(qt, kt, vt, cache_lens,
                                          scale=None, splits=1):
    """The split design's arithmetic over the one-layer cache in plain
    PyTorch: each row's Smax positions in ``splits`` ranges of span =
    ceil(Smax / splits) positions (the kernel's ranges are whole
    64-position tiles, ``decode_splits``), each range's fp32 partial,
    merged in split order (``_split_merge``). Equal to
    ``decode_attention_bhsd_reference`` but for where p is rounded."""
    b, h, sq, d = qt.shape
    smax = kt.shape[2]
    if scale is None:
        scale = d ** -0.5
    kv = torch.stack([kt, vt]).to(qt.dtype).repeat_interleave(
        h // kt.shape[1], dim=2).float()          # [2, B, H, Smax, D]
    mask = _row_mask(cache_lens, sq, smax, qt.device)
    s = qt.float() @ kv[0].transpose(-1, -2) * scale
    return _split_merge(s, mask, kv[1], -(-smax // splits), qt.dtype,
                        qt.dtype)


def decode_attention(q, k_cache, v_cache, cache_lens, scale=None):
    """``decode_attention_bhsd`` in the model layout: q [B, Sq, H, D],
    caches [B, Smax, Hk, D] -> [B, Sq, H, D]."""
    qt, kt, vt = (a.transpose(1, 2).contiguous()
                  for a in (q, k_cache, v_cache))
    return decode_attention_bhsd(qt, kt, vt, cache_lens, scale).transpose(
        1, 2)


# ------------------------------------------------------------ dense ring
def stacked_is_supported(q_shape, caches_shape, dtype,
                         cache_dtype=None) -> bool:
    """q: [B, Sq, H, D] (the model layout, as the JAX gate takes it);
    caches: [L, 2, B, Hk, Smax, D]. The kernel takes Sq <= 128, D <= 256,
    Hk | H, Smax a multiple of 128 (the decoder rounds the ring up to one
    at init) and a ring in the query's dtype (fp32, bf16 or fp16)."""
    if len(q_shape) != 4 or len(caches_shape) != 6:
        return False
    _, sq, h, d = q_shape
    hk, smax = caches_shape[3], caches_shape[4]
    if not (1 <= sq <= MAX_SQ and 1 <= d <= MAX_D) \
            or caches_shape[5] != d:
        return False
    if hk < 1 or h % hk or smax < 1 or smax % 128:
        return False
    if cache_dtype is not None and cache_dtype != dtype:
        return False
    return dtype in _DTYPE_CODE


def stacked_i8_is_supported(q_shape, caches_shape, dtype) -> bool:
    """The int8 ring flavor: the layout rules of ``stacked_is_supported``;
    the compute dtype is the query's."""
    return stacked_is_supported(q_shape, caches_shape, dtype)


def stacked_write_is_supported(q_shape, caches_shape, dtype,
                               cache_dtype=None) -> bool:
    """``stacked_is_supported`` plus the write kernels' one new token per
    call (Sq == 1)."""
    return len(q_shape) == 4 and q_shape[1] == 1 and stacked_is_supported(
        q_shape, caches_shape, dtype, cache_dtype)


def stacked_i8_write_is_supported(q_shape, caches_shape, dtype) -> bool:
    """The int8 flavor of ``stacked_write_is_supported``."""
    return stacked_write_is_supported(q_shape, caches_shape, dtype)


def ring_table(b, device):
    """The dense ring seen as a pool: B blocks of Smax positions, block b
    holding row b. A [B, 1] int32 table for the paged plain versions."""
    return torch.arange(b, dtype=torch.int32, device=device)[:, None]


def _check_stacked(name, qt, ring, layer, cache_lens, ring_dtype,
                   write=False):
    if qt.dim() != 4 or ring.dim() != 6:
        raise ValueError(
            f"{name}: qt must be [B, H, Sq, D] and the ring "
            f"[L, 2, B, Hk, Smax, D], got {tuple(qt.shape)} and "
            f"{tuple(ring.shape)}")
    b, h, sq, d = qt.shape
    if ring.dtype != ring_dtype:
        raise ValueError(
            f"{name}: the ring must be {ring_dtype} for a {qt.dtype} "
            f"query, got {ring.dtype} (mixed query and ring dtypes are not "
            "taken: casting the ring would copy every layer)")
    if write and sq != 1:
        raise ValueError(f"{name}: one new token per call (got Sq={sq}); "
                         "gate with stacked_write_is_supported")
    if ring.shape[2] != b or not stacked_is_supported(
            (b, sq, h, d), tuple(ring.shape), qt.dtype):
        raise ValueError(
            f"{name}: unsupported shapes/dtypes q {tuple(qt.shape)} "
            f"{qt.dtype}, ring {tuple(ring.shape)} {ring.dtype} (see "
            "stacked_is_supported)")
    if tuple(cache_lens.shape) != (b,) or cache_lens.dtype != torch.int32:
        raise ValueError(
            f"{name}: cache_lens must be int32 [B], got {cache_lens.dtype} "
            f"{tuple(cache_lens.shape)}")
    _check_layer(name, ring, layer)


def _check_kv_new(name, kv_new, ring):
    want = (2, ring.shape[2], ring.shape[3], 1, ring.shape[5])
    if tuple(kv_new.shape) != want:
        raise ValueError(f"{name}: kv_new must be [2, B, Hk, 1, D] = "
                         f"{want}, got {tuple(kv_new.shape)}")


def decode_attention_stacked(qt, caches, layer, cache_lens, scale=None):
    """qt [B, H, Sq, D], caches [L, 2, B, Hk, Smax, D] in qt's dtype ->
    [B, H, Sq, D]: query row r of row b attends layer ``layer``'s
    positions <= cache_lens[b] + r (the new tokens' K/V already
    written)."""
    name = "decode_attention_stacked"
    _check_stacked(name, qt, caches, layer, cache_lens, qt.dtype)
    b, h, sq, d = qt.shape
    if scale is None:
        scale = d ** -0.5
    if _all_cpu(qt, caches, cache_lens):
        return decode_attention_stacked_reference(qt, caches, layer,
                                                  cache_lens, scale)
    _, _, _, hk, smax, _ = caches.shape
    path, splits, span = _range_splits(qt, hk, smax)
    return _launch(name, [("qt", qt), ("caches", caches),
                          ("cache_lens", cache_lens)], torch.empty_like(qt),
                   (b, h, sq, d, hk, smax, int(layer), splits, span), scale,
                   qt.dtype, extra=[("work", _split_work(splits, qt))],
                   path=path)


def decode_attention_stacked_reference(qt, caches, layer, cache_lens,
                                       scale=None):
    """The plain version: the ring read as a pool of one Smax-position
    block per row (``ring_table``) by ``decode_attention_paged_reference``."""
    return decode_attention_paged_reference(
        qt, caches, ring_table(qt.shape[0], qt.device), layer, cache_lens,
        scale)


def decode_attention_stacked_split_reference(qt, caches, layer, cache_lens,
                                             scale=None, splits=1):
    """The split design over the fp ring in plain PyTorch: layer
    ``layer``'s K and V planes as the one-layer cache's two tensors
    (``decode_attention_bhsd_split_reference``), ranges of ceil(Smax /
    splits) positions."""
    kv = caches[int(layer)]
    return decode_attention_bhsd_split_reference(qt, kv[0], kv[1],
                                                 cache_lens, scale, splits)


def decode_attention_stacked_i8(qt, caches_i8, cache_scales, layer,
                                cache_lens, scale=None):
    """The int8 ring flavor of ``decode_attention_stacked``: caches_i8
    [L, 2, B, Hk, Smax, D] int8 with per-position fp32 scales
    cache_scales [L, 2, B, Hk, 1, Smax]. Returns [B, H, Sq, D] in the
    query dtype."""
    name = "decode_attention_stacked_i8"
    _check_stacked(name, qt, caches_i8, layer, cache_lens, torch.int8)
    _check_scales(name, caches_i8, cache_scales)
    b, h, sq, d = qt.shape
    if scale is None:
        scale = d ** -0.5
    if _all_cpu(qt, caches_i8, cache_scales, cache_lens):
        return decode_attention_stacked_i8_reference(
            qt, caches_i8, cache_scales, layer, cache_lens, scale)
    _, _, _, hk, smax, _ = caches_i8.shape
    path, splits, span = _range_splits(qt, hk, smax)
    return _launch(name, [("qt", qt), ("caches_i8", caches_i8),
                          ("cache_scales", cache_scales),
                          ("cache_lens", cache_lens)], torch.empty_like(qt),
                   (b, h, sq, d, hk, smax, int(layer), splits, span), scale,
                   qt.dtype, extra=[("work", _split_work(splits, qt))],
                   path=path)


def decode_attention_stacked_i8_reference(qt, caches_i8, cache_scales,
                                          layer, cache_lens, scale=None):
    """The plain version: ``decode_attention_paged_i8_reference`` over the
    ring as a pool of one block per row."""
    return decode_attention_paged_i8_reference(
        qt, caches_i8, cache_scales, ring_table(qt.shape[0], qt.device),
        layer, cache_lens, scale)


def decode_attention_stacked_i8_split_reference(qt, caches_i8, cache_scales,
                                                layer, cache_lens,
                                                scale=None, splits=1):
    """The int8 split design over the ring in plain PyTorch:
    ``decode_attention_paged_i8_split_reference`` over the ring as a pool
    of one Smax-position block per row."""
    return decode_attention_paged_i8_split_reference(
        qt, caches_i8, cache_scales, ring_table(qt.shape[0], qt.device),
        layer, cache_lens, scale, splits)


def _new_token_mask(cache_lens, smax, device):
    # [B, 1, 1, Smax + 1]: the prefix < lens plus the new token's column,
    # which the plain write versions append at index Smax
    pos = torch.arange(smax + 1, device=device)
    lens = cache_lens.long()[:, None]
    return ((pos < lens) | (pos == smax))[:, None, None, :]


def _land_rows(ring, layer, cache_lens, rows, scales=None, row_scales=None):
    """rows [2, B, Hk, D] into ring[layer, :, b, :, lens[b]] (and
    row_scales [2, B, Hk] into scales[layer, :, b, :, 0, lens[b]]), in
    place; a full row (lens[b] == Smax) drops its write: it stores back
    what its last position holds, so no host sync picks the rows."""
    smax = ring.shape[4]
    lens = cache_lens.long()
    keep = lens < smax
    pos = lens.clamp(max=smax - 1)
    b = torch.arange(lens.shape[0], device=lens.device)

    def land(dst, new):           # dst [B, Smax, ...], new [B, ...]
        sel = keep.reshape((-1,) + (1,) * (new.dim() - 1))
        dst[b, pos] = torch.where(sel, new.to(dst.dtype), dst[b, pos])
    land(ring[int(layer)].permute(1, 3, 0, 2, 4), rows.transpose(0, 1))
    if scales is not None:
        land(scales[int(layer), :, :, :, 0].permute(1, 3, 0, 2),
             row_scales.transpose(0, 1))


def decode_attention_stacked_write(qt, kv_new, caches, layer, cache_lens,
                                   scale=None):
    """qt [B, H, 1, D]; kv_new [2, B, Hk, 1, D], the new token's K/V of
    layer ``layer`` (cast to the ring's dtype); caches [L, 2, B, Hk, Smax,
    D] in qt's dtype, updated IN PLACE: row b's K/V land at position
    cache_lens[b] (dropped when it is Smax). Returns (caches, attn
    [B, H, 1, D]): the new query over the prefix < cache_lens[b] plus the
    new token itself. The design is ``paged_path``'s; the split one lands
    the row inside its attention launch."""
    name = "decode_attention_stacked_write"
    _check_stacked(name, qt, caches, layer, cache_lens, qt.dtype,
                   write=True)
    _check_kv_new(name, kv_new, caches)
    b, h, _, d = qt.shape
    if scale is None:
        scale = d ** -0.5
    kvn = kv_new.to(caches.dtype).contiguous()
    if _all_cpu(qt, kvn, caches, cache_lens):
        return decode_attention_stacked_write_reference(
            qt, kvn, caches, layer, cache_lens, scale)
    _, _, _, hk, smax, _ = caches.shape
    path, splits, span = _range_splits(qt, hk, smax)
    out = _launch(name, [("qt", qt), ("kv_new", kvn), ("caches", caches),
                         ("cache_lens", cache_lens)], torch.empty_like(qt),
                  (b, h, d, hk, smax, int(layer), splits, span), scale,
                  qt.dtype, extra=[("work", _split_work(splits, qt))],
                  path=path)
    return caches, out


def decode_attention_stacked_write_reference(qt, kv_new, caches, layer,
                                             cache_lens, scale=None):
    """The plain version: attention over layer ``layer``'s prefix <
    cache_lens with the new token's K/V appended (in the ring's dtype),
    p rounded to the ring dtype before the PV product; then the K/V
    rows land in place (a full row drops them)."""
    b, h, _, d = qt.shape
    hk, smax = caches.shape[3], caches.shape[4]
    if scale is None:
        scale = d ** -0.5
    kvn = kv_new.to(caches.dtype)
    kv = torch.cat([caches[int(layer)], kvn], dim=3)   # [2, B, Hk, S+1, D]
    kv = kv.repeat_interleave(h // hk, dim=2).float()
    mask = _new_token_mask(cache_lens, smax, qt.device)
    out = _fp_attend(qt.float(), kv, mask, scale, caches.dtype, qt.dtype)
    _land_rows(caches, layer, cache_lens, kvn[:, :, :, 0])
    return caches, out


def decode_attention_stacked_write_split_reference(qt, kv_new, caches, layer,
                                                   cache_lens, scale=None,
                                                   splits=1):
    """The split design's write mode over the fp ring in plain PyTorch:
    the new token's column ahead of layer ``layer``'s positions, which are
    cut into ``splits`` ranges of ceil(Smax / splits) and masked below
    cache_lens (the ranges are exclusive); the first range also holds the
    new column, as the kernel's range 0 seeds with it; the partials merge
    in split order (``_split_merge``), then the K/V rows land in place
    (``_land_rows``; a full row drops them). Equal to
    ``decode_attention_stacked_write_reference`` but for where p is
    rounded."""
    b, h, _, d = qt.shape
    hk, smax = caches.shape[3], caches.shape[4]
    if scale is None:
        scale = d ** -0.5
    kvn = kv_new.to(caches.dtype)
    kv = torch.cat([kvn, caches[int(layer)]], dim=3)   # [2, B, Hk, 1+S, D]
    kv = kv.repeat_interleave(h // hk, dim=2).float()
    # column 0 the new token, column 1 + p position p < lens
    mask = _row_mask(cache_lens, 1, smax + 1, qt.device)
    s = qt.float() @ kv[0].transpose(-1, -2) * scale
    out = _split_merge(s, mask, kv[1], -(-smax // splits), caches.dtype,
                       qt.dtype, lead=1)
    _land_rows(caches, layer, cache_lens, kvn[:, :, :, 0])
    return caches, out


def decode_attention_stacked_i8_write(qt, kv_new, caches_i8, cache_scales,
                                      layer, cache_lens, scale=None):
    """The int8 ring flavor of ``decode_attention_stacked_write``: the new
    K/V rows (kv_new, taken as fp32) are quantized with the engine's
    per-row absmax recipe and land with their scales, in place. Returns
    (caches_i8, cache_scales, attn [B, H, 1, D] in the query dtype)."""
    name = "decode_attention_stacked_i8_write"
    _check_stacked(name, qt, caches_i8, layer, cache_lens, torch.int8,
                   write=True)
    _check_scales(name, caches_i8, cache_scales)
    _check_kv_new(name, kv_new, caches_i8)
    b, h, _, d = qt.shape
    if scale is None:
        scale = d ** -0.5
    kvn = kv_new.float().contiguous()
    if _all_cpu(qt, kvn, caches_i8, cache_scales, cache_lens):
        return decode_attention_stacked_i8_write_reference(
            qt, kvn, caches_i8, cache_scales, layer, cache_lens, scale)
    _, _, _, hk, smax, _ = caches_i8.shape
    path, splits, span = _range_splits(qt, hk, smax)
    out = _launch(name, [("qt", qt), ("kv_new", kvn),
                         ("caches_i8", caches_i8),
                         ("cache_scales", cache_scales),
                         ("cache_lens", cache_lens)], torch.empty_like(qt),
                  (b, h, d, hk, smax, int(layer), splits, span), scale,
                  qt.dtype, extra=[("work", _split_work(splits, qt))],
                  path=path)
    return caches_i8, cache_scales, out


def decode_attention_stacked_i8_write_reference(qt, kv_new, caches_i8,
                                                cache_scales, layer,
                                                cache_lens, scale=None):
    """The plain version: the new rows quantized by ``_absmax_int8`` and
    appended to layer ``layer``'s prefix < cache_lens, the int8 kernels'
    arithmetic (``_i8_attend``); then the rows and scales land in place
    (a full row drops them)."""
    from ..inference.generation import _absmax_int8
    b, h, _, d = qt.shape
    hk, smax = caches_i8.shape[3], caches_i8.shape[4]
    if scale is None:
        scale = d ** -0.5
    qn, sn = _absmax_int8(kv_new, -1)           # [2, B, Hk, 1, D], [.., 1]
    kvi = torch.cat([caches_i8[int(layer)], qn], dim=3).float()
    sc = torch.cat([cache_scales[int(layer)].transpose(-1, -2), sn], dim=3)
    g = h // hk
    mask = _new_token_mask(cache_lens, smax, qt.device)
    out = _i8_attend(qt.float(), kvi.repeat_interleave(g, dim=2),
                     sc.repeat_interleave(g, dim=2), mask, scale, qt.dtype)
    _land_rows(caches_i8, layer, cache_lens, qn[:, :, :, 0], cache_scales,
               sn[:, :, :, 0, 0])
    return caches_i8, cache_scales, out


def decode_attention_stacked_i8_write_split_reference(qt, kv_new, caches_i8,
                                                      cache_scales, layer,
                                                      cache_lens, scale=None,
                                                      splits=1):
    """The int8 split design's write mode in plain PyTorch: the new rows
    quantized by ``_absmax_int8``, their column ahead of layer ``layer``'s
    positions (cut into ``splits`` ranges of ceil(Smax / splits), masked
    below cache_lens), the first range also holding the new column, the
    int8 kernels' scores and p * v_scale (``_split_merge``); then the rows
    and scales land in place (a full row drops them). Equal to
    ``decode_attention_stacked_i8_write_reference`` but for where p is
    rounded."""
    from ..inference.generation import _absmax_int8
    b, h, _, d = qt.shape
    hk, smax = caches_i8.shape[3], caches_i8.shape[4]
    if scale is None:
        scale = d ** -0.5
    qn, sn = _absmax_int8(kv_new, -1)           # [2, B, Hk, 1, D], [.., 1]
    g = h // hk
    kvi = torch.cat([qn, caches_i8[int(layer)]], dim=3).float(
        ).repeat_interleave(g, dim=2)
    sc = torch.cat([sn, cache_scales[int(layer)].transpose(-1, -2)], dim=3
                   ).repeat_interleave(g, dim=2)   # [2, B, H, 1+S, 1]
    mask = _row_mask(cache_lens, 1, smax + 1, qt.device)
    s = qt.float() @ kvi[0].transpose(-1, -2) * scale * sc[0].transpose(
        -1, -2)
    out = _split_merge(s, mask, kvi[1], -(-smax // splits), qt.dtype,
                       qt.dtype, sc[1].transpose(-1, -2), lead=1)
    _land_rows(caches_i8, layer, cache_lens, qn[:, :, :, 0], cache_scales,
               sn[:, :, :, 0, 0])
    return caches_i8, cache_scales, out
