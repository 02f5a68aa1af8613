"""Fused int4 dequant-matmul: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/fused_dequant_matmul.py``:
``a @ dequant(w_packed, scales)`` where ``w_packed`` [K/2, O] int8 holds
two int4 values of the contracted axis per byte (the low nibble the even
k, the high nibble the odd k, each sign-extended, in [-7, 7]) and
``scales`` the per-out-channel fp32 scale. The products accumulate in
fp32, the scale multiplies the accumulator, and the result is cast to
``out_dtype``; no unpacked copy of the weight is ever made.

The weight may come in either orientation: contiguous [K/2, O] (the
stacked ``lin_w``, ``f1_w``, ``f2_w``) or the transposed view of a
contiguous [O, K/2] array (``qkv_w.T``); the kernel reads both in place.

Two designs, picked by ``dequant_path`` from the dtype and the shape,
the one place the rule is stated: bf16 and fp16 activations whose rows
the kernel can stage in 16-byte copies take ``"tensor_core"`` (mma.sync
with the int4 weight turned into bf16 / fp16 fragments in registers; where
the output tiles do not fill the card the K walk is split over the blocks
of a thread block cluster, which sum their partials through each other's
shared memory in split order, one launch), everything else ``"fma"``
(fp32 FMAs, never TF32; a split K walk summed by a second launch). ``PATH_LAUNCHES`` counts the launches by design; the C entry runs
the design it is given or fails.

On a CUDA tensor ``fused_dequant_matmul`` launches the hand-written
kernel (``csrc/fused_dequant_matmul.cu``) on the current stream or
raises; on a CPU tensor it computes the plain version.
``dequant_matmul_nibble_split`` is the plain arithmetic the JAX package
runs under a serving mesh (two half-K dots on the nibble planes in the
activation's dtype, no scale), which the serving mesh holds its CPU path
to.
"""
from __future__ import annotations

import functools

import torch

from . import _build

__all__ = ["fused_dequant_matmul", "fused_dequant_matmul_reference",
           "fused_dequant_matmul_split_reference",
           "dequant_matmul_nibble_split",
           "fused_dequant_matmul_is_supported", "unpack_int4",
           "dequant_path", "dequant_splits", "LAUNCHES", "PATH_LAUNCHES"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PATH_CODE = {"tensor_core": 1, "fma": 0}
# packed rows a step of either design's K walk
_BK2 = 32
# the fma design's output columns a block; the tensor-core design's
_BO, _BN_TC = 64, 128
# the tensor-core design's most K ranges, the blocks of a cluster: 16 at
# decode (small blocks), 8 (portable clusters) for the wgmma blocks
_MAX_SPLITS, _MAX_SPLITS_WG = 16, 8

# kernel launches, counted where the kernel is launched (the plain version
# on CPU tensors does not count), and by the design that ran them
LAUNCHES = {"fused_dequant_matmul": 0}
PATH_LAUNCHES = {"fused_dequant_matmul": {"tensor_core": 0, "fma": 0}}


def fused_dequant_matmul_is_supported(m, k, o) -> bool:
    """Whether an [m, k] @ [k, o] contraction can take the kernel with
    the weight int4-packed along k: any m, o >= 1 and an even k (the
    TPU's extra tiling rules do not apply on the card)."""
    return m >= 1 and o >= 1 and k >= 2 and k % 2 == 0


def unpack_int4(w_packed):
    """[K/2, O] packed int8 -> [K, O] int8 in [-7, 7]: row 2i is the
    sign-extended low nibble of packed row i, row 2i + 1 its high
    nibble (arithmetic shifts, as the kernel unpacks)."""
    lo = (w_packed << 4) >> 4
    hi = w_packed >> 4
    return torch.stack([lo, hi], 1).reshape(-1, w_packed.shape[1])


def _check(a, w_packed, scales, out_dtype):
    name = "fused_dequant_matmul"
    if w_packed.dim() != 2 or w_packed.dtype != torch.int8:
        raise ValueError(f"{name}: packed weight must be int8 [K/2, O], got "
                         f"{w_packed.dtype} {tuple(w_packed.shape)}")
    k2, o = w_packed.shape
    if a.dim() < 1 or a.shape[-1] != 2 * k2:
        raise ValueError(f"{name}: activation K={a.shape[-1]} does not "
                         f"match packed K/2={k2}")
    if scales.numel() != o or scales.dim() > 2:
        raise ValueError(f"{name}: scales must be [O] or [1, O] with O={o}, "
                         f"got {tuple(scales.shape)}")
    if a.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: activation and output dtypes must be "
                         f"fp32, bf16 or fp16, got {a.dtype} -> {out_dtype}")


def dequant_path(dtype, k, o, k_contig) -> str:
    """The design for activations of ``dtype`` [M, k] against a packed
    weight of k/2 rows and o columns (``k_contig``: 1 for the transposed
    view of a contiguous [o, k/2], 0 for a contiguous [k/2, o]):
    ``"tensor_core"`` for bf16 and fp16 when the kernel can stage the
    rows in 16-byte copies (k a multiple of 8, and the packed weight's
    rows 16-byte aligned: o % 16 == 0 contiguous, k/2 % 16 == 0 and o % 8
    == 0 for the output's vector stores transposed), else ``"fma"``. The
    wrapper passes it to the C entry, which runs that design or fails."""
    aligned = ((k // 2) % 16 == 0 and o % 8 == 0) if k_contig \
        else o % 16 == 0
    if dtype in (torch.bfloat16, torch.float16) and k % 8 == 0 and aligned:
        return "tensor_core"
    return "fma"


def _ranges(steps, want):
    """(S, per): at most ``want`` ranges of ``per`` whole steps each that
    cover the ``steps`` steps once (S = ceil(steps / per))."""
    per = -(-steps // max(1, min(steps, want)))
    return -(-steps // per), per


def dequant_splits(m, k2, o, path, n_sm):
    """(bm, S, chunk) of a launch: rows a block, and the K walk's S
    ranges of ``chunk`` packed rows (whole 32-row steps), from the shapes
    and the card's SM count alone (the launch reads nothing back and can
    be captured in a CUDA graph).

    tensor_core: tiles of 128 columns by BM 16 at decode (M <= 16, the
    mma.sync kernel), else 64, or 128 past M 256 (the wgmma kernel). S
    ranges, the blocks of a cluster (at most _MAX_SPLITS at decode,
    _MAX_SPLITS_WG otherwise), fill a wave of the card where the output
    tiles do not (a block an SM at BM 16 and 128, two at BM 64), at least
    one step a range at decode and three otherwise (then a power of
    two). fma: BM 16 / 32 / 64 by M, S filling the card twice over where
    the tiles do not."""
    steps = -(-k2 // _BK2)
    if path == "fma":
        bm = 16 if m <= 16 else 32 if m <= 128 else 64
        tiles = -(-o // _BO) * -(-m // bm)
        s, per = _ranges(steps, -(-2 * n_sm // tiles))
        return bm, s, per * _BK2
    bm = 16 if m <= 16 else 64 if m <= 256 else 128
    tiles = -(-o // _BN_TC) * -(-m // bm)
    if bm == 16:
        want = min(_MAX_SPLITS, n_sm // tiles)
    else:
        want = min(_MAX_SPLITS_WG, (2 if bm == 64 else 1) * n_sm // tiles,
                   steps // 3)
        # a power of two: clusters of 5 or 6 of these blocks ran slower
        want = 1 << max(0, want.bit_length() - 1)
    s, per = _ranges(steps, want)
    return bm, s, per * _BK2


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_dequant_matmul(a, w_packed, scales, *, out_dtype=None):
    """a [..., K] @ dequant(w_packed [K/2, O], scales [O] or [1, O])
    -> [..., O] in ``out_dtype`` (default a's dtype; any of fp32, bf16
    and fp16, whatever a's is)."""
    out_dtype = out_dtype or a.dtype
    _check(a, w_packed, scales, out_dtype)
    k2, o = w_packed.shape
    lead = a.shape[:-1]
    a2 = a.reshape(-1, 2 * k2)
    if a.device.type == "cpu" and w_packed.device.type == "cpu" \
            and scales.device.type == "cpu":
        return fused_dequant_matmul_reference(
            a2, w_packed, scales, out_dtype=out_dtype).reshape(*lead, o)
    name = "fused_dequant_matmul"
    devs = {a.device, w_packed.device, scales.device}
    if len(devs) != 1 or a.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for devices {devs}")
    s = scales.reshape(-1)
    if s.dtype != torch.float32 or not s.is_contiguous():
        raise ValueError(f"{name}: scales must be contiguous fp32")
    if s.data_ptr() % 16:                # the tensor-core vector loads
        s = s.clone()
    if w_packed.is_contiguous():
        k_contig = 0                     # [K/2, O], O fastest
    elif w_packed.t().is_contiguous():
        k_contig = 1                     # a view of [O, K/2], K/2 fastest
    else:
        raise ValueError(f"{name}: the packed weight must be contiguous or "
                         "the transpose of a contiguous array, got strides "
                         f"{w_packed.stride()}")
    a2 = a2.contiguous()
    m = a2.shape[0]
    path = dequant_path(a.dtype, 2 * k2, o, k_contig)
    bm, splits, chunk = dequant_splits(m, k2, o, path,
                                       _sm_count(a.device.index))
    out = torch.empty((m, o), dtype=out_dtype, device=a.device)
    # the fma design's partials (the tensor-core design keeps its own in
    # the cluster's shared memory)
    work = (torch.empty((splits, m, o), dtype=torch.float32, device=a.device)
            if splits > 1 and path == "fma" else out)
    fn = _build.load(name)
    rc = fn(a2.data_ptr(), w_packed.data_ptr(), s.data_ptr(),
            work.data_ptr(), out.data_ptr(), m, k2, o,
            k_contig, bm, splits, chunk, _DTYPE_CODE[a.dtype],
            _DTYPE_CODE[out_dtype], _PATH_CODE[path],
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{name}: kernel launch failed with CUDA error {rc} (a "
            f"{tuple(a.shape)} {a.dtype}, w {tuple(w_packed.shape)} strides "
            f"{w_packed.stride()}; {path})")
    LAUNCHES[name] += 1
    PATH_LAUNCHES[name][path] += 1
    return out.reshape(*lead, o)


def fused_dequant_matmul_reference(a, w_packed, scales, *, out_dtype=None):
    """The plain version: the nibbles unpacked to their integer values,
    an fp32 matmul, the scale on the fp32 result, then the cast."""
    out_dtype = out_dtype or a.dtype
    w = unpack_int4(w_packed).float()
    acc = a.float() @ w
    return (acc * scales.reshape(-1).float()).to(out_dtype)


def fused_dequant_matmul_split_reference(a, w_packed, scales, *,
                                         out_dtype=None, splits=1):
    """The split-K arithmetic in plain PyTorch: the K/2 packed rows in
    ``splits`` ranges of whole 32-row steps (``dequant_splits``' ranges:
    ceil(steps / splits) steps each), each range's fp32 partial a @ W
    over its k, the partials summed in split order, then the scale and
    the cast. Equal to ``fused_dequant_matmul_reference`` but for the
    order of the sums."""
    out_dtype = out_dtype or a.dtype
    k2 = w_packed.shape[0]
    steps = -(-k2 // _BK2)
    per = -(-steps // splits) * _BK2
    w = unpack_int4(w_packed).float()
    a32 = a.reshape(-1, 2 * k2).float()
    acc = torch.zeros(a32.shape[0], w.shape[1], device=a.device)
    for lo in range(0, k2, per):
        hi = min(k2, lo + per)
        acc = acc + a32[:, 2 * lo:2 * hi] @ w[2 * lo:2 * hi]
    out = (acc * scales.reshape(-1).float()).to(out_dtype)
    return out.reshape(*a.shape[:-1], w.shape[1])


def dequant_matmul_nibble_split(a, w_packed):
    """a [..., K] @ the int4 values of w_packed [K/2, O] as JAX computes
    it under a mesh: the activation's even and odd k against the sign-
    extended low and high nibble planes, two dots in a's dtype summed in
    a's dtype; the scale is the caller's."""
    k2 = w_packed.shape[0]
    lo = ((w_packed << 4) >> 4).to(a.dtype)
    hi = (w_packed >> 4).to(a.dtype)
    ar = a.reshape(*a.shape[:-1], k2, 2)
    return ar[..., 0] @ lo + ar[..., 1] @ hi
