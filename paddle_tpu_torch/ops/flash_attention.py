"""Flash attention forward: the CUDA kernel's wrapper and its plain PyTorch
version.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``:
``flash_attention`` keeps the JAX layout [batch, seq, heads, head_dim]
and its keyword names; ``flash_attention_fwd`` is the forward kernel on
the [B, H, S, D] layout, returning ``(o, lse)`` as ``_fwd`` does (lse
[B, H, Sq, 1] fp32, the row log-sum-exp a backward pass reads). Causal
masking is aligned bottom-right (row i attends key j iff j <= i + Sk -
Sq); K/V may have fewer heads than q (GQA, head h reads h // (H / Hk)).

On a CUDA tensor ``flash_attention_fwd`` launches the hand-written kernel
(``csrc/flash_attention_fwd.cu``) on the current stream or raises; on a
CPU tensor it computes the plain version. Only the forward is ported:
dropout needs the TPU kernel's in-kernel PRNG, which belongs with the
backward (ROADMAP Queue 2, flash_attention backward).
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_reference", "is_supported", "LAUNCHES"]

NEG_INF = -1e30
MAX_D = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# kernel launches, counted where the kernel is launched (the plain version
# on CPU tensors does not count)
LAUNCHES = {"flash_attention_fwd": 0}


def is_supported(q_shape, dtype) -> bool:
    """Rank-4 [B, S, H, D] with D <= 256 in fp32, bf16 or fp16."""
    return len(q_shape) == 4 and q_shape[-1] <= MAX_D \
        and dtype in _DTYPE_CODE


def flash_attention(q, k, v, causal=False, scale=None, dropout_p=0.0):
    """q: [B, Sq, H, D]; k, v: [B, Sk, Hk, D] with Hk dividing H. Returns
    [B, Sq, H, D] in q's dtype."""
    if dropout_p > 0:
        raise NotImplementedError(
            "flash_attention(dropout_p > 0): attention dropout comes with "
            "the backward kernels (ROADMAP Queue 2, flash_attention "
            "backward)")
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"q heads ({q.shape[2]}) must be a multiple of kv heads "
            f"({k.shape[2]}) for GQA flash attention")
    o, _ = flash_attention_fwd(*(x.transpose(1, 2).contiguous()
                                 for x in (q, k, v)),
                               causal=causal, scale=scale)
    return o.transpose(1, 2)


def _check(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(
            f"flash_attention_fwd: q must be [B, H, Sq, D] and k, v "
            f"[B, Hk, Sk, D], got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] < 1 \
            or h % k.shape[1]:
        raise ValueError(
            f"flash_attention_fwd: k/v {tuple(k.shape)} do not fit q "
            f"{tuple(q.shape)} (same B and D, Hk dividing H)")
    if not is_supported((b, q.shape[2], h, d), q.dtype) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention_fwd: unsupported dtypes/shapes q {q.dtype} "
            f"{tuple(q.shape)}, k {k.dtype}, v {v.dtype} (see "
            "is_supported)")
    if len({x.device for x in (q, k, v)}) != 1:
        raise ValueError("flash_attention_fwd: inputs on several devices")


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """q [B, H, Sq, D], k/v [B, Hk, Sk, D] -> (o [B, H, Sq, D] in q's
    dtype, lse [B, H, Sq, 1] fp32)."""
    _check(q, k, v)
    b, h, sq, d = q.shape
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for device "
                         f"{q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             "contiguous")
    hk, sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    fn = _build.load("flash_attention_fwd")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, hk, sq, sk, d, int(bool(causal)),
            float(scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_fwd: kernel launch failed with CUDA error "
            f"{rc} (q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)})")
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def flash_attention_reference(q, k, v, causal=False, scale=None):
    """The plain version of ``flash_attention_fwd``: one dense fp32
    softmax with the kernel's masking, p rounded to v's dtype before the
    PV product, the l == 0 guard, lse = m + log(l)."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    kk = k.repeat_interleave(h // hk, dim=1).float()
    vv = v.repeat_interleave(h // hk, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        mask = cols <= rows + (sk - sq)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    else:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    lsum = p.sum(-1, keepdim=True)
    lsafe = torch.where(lsum == 0, torch.ones_like(lsum), lsum)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vv.float())
    return (o / lsafe).to(q.dtype), m + torch.log(lsafe)
