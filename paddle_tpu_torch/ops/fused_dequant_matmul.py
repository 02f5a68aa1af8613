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

On a CUDA tensor ``fused_dequant_matmul`` launches the hand-written
kernel (``csrc/fused_dequant_matmul.cu``) on the current stream or
raises; on a CPU tensor it computes the plain version.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["fused_dequant_matmul", "fused_dequant_matmul_reference",
           "fused_dequant_matmul_is_supported", "unpack_int4", "LAUNCHES"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the kernel's tile: 64 output columns by 32 packed rows (64 k) per step;
# BM = 16, 32 or 64 activation rows by the size of M
_BO, _BK2, _SMS = 64, 32, 132

# kernel launches, counted where the kernel is launched (the plain version
# on CPU tensors does not count)
LAUNCHES = {"fused_dequant_matmul": 0}


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


def _splits(m, k2, o, bm):
    """(splits, packed rows per split) of the K walk: enough thread blocks
    to cover the card twice over when the output tiles alone do not
    (decode's M = 8), in whole 32-row steps."""
    tiles = -(-o // _BO) * -(-m // bm)
    steps = -(-k2 // _BK2)
    want = min(steps, max(1, -(-2 * _SMS // tiles)))
    per = -(-steps // want)
    return -(-steps // per), per * _BK2


def fused_dequant_matmul(a, w_packed, scales, out_dtype=None):
    """a [..., K] @ dequant(w_packed [K/2, O], scales [O] or [1, O])
    -> [..., O] in ``out_dtype`` (default a's dtype)."""
    out_dtype = out_dtype or a.dtype
    _check(a, w_packed, scales, out_dtype)
    k2, o = w_packed.shape
    lead = a.shape[:-1]
    a2 = a.reshape(-1, 2 * k2)
    if a.device.type == "cpu" and w_packed.device.type == "cpu" \
            and scales.device.type == "cpu":
        return fused_dequant_matmul_reference(a2, w_packed, scales,
                                              out_dtype).reshape(*lead, o)
    name = "fused_dequant_matmul"
    devs = {a.device, w_packed.device, scales.device}
    if len(devs) != 1 or a.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for devices {devs}")
    if out_dtype != a.dtype:
        raise ValueError(f"{name}: the kernel writes the activation's dtype "
                         f"{a.dtype}, not {out_dtype}")
    s = scales.reshape(-1)
    if s.dtype != torch.float32 or not s.is_contiguous():
        raise ValueError(f"{name}: scales must be contiguous fp32")
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
    bm = 16 if m <= 16 else 32 if m <= 128 else 64
    splits, chunk = _splits(m, k2, o, bm)
    out = torch.empty((m, o), dtype=a.dtype, device=a.device)
    work = (torch.empty((splits, m, o), dtype=torch.float32, device=a.device)
            if splits > 1 else out)
    fn = _build.load(name)
    rc = fn(a2.data_ptr(), w_packed.data_ptr(), s.data_ptr(),
            work.data_ptr(), out.data_ptr(), m, k2, o, k_contig, bm, splits,
            chunk, _DTYPE_CODE[a.dtype],
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{name}: kernel launch failed with CUDA error {rc} (a "
            f"{tuple(a.shape)} {a.dtype}, w {tuple(w_packed.shape)} strides "
            f"{w_packed.stride()})")
    LAUNCHES[name] += 1
    return out.reshape(*lead, o)


def fused_dequant_matmul_reference(a, w_packed, scales, out_dtype=None):
    """The plain version: the nibbles unpacked to their integer values,
    an fp32 matmul, the scale on the fp32 result, then the cast."""
    out_dtype = out_dtype or a.dtype
    w = unpack_int4(w_packed).float()
    acc = a.float() @ w
    return (acc * scales.reshape(-1).float()).to(out_dtype)
