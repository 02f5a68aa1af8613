"""Ring attention's chunk step: the CUDA kernels' wrappers, their plain
PyTorch versions, and the autograd Function that joins them.

Counterpart of ``paddle_tpu/ops/pallas/ring_chunk_attention.py``: one q
chunk against one visiting K/V chunk, returning the normalised chunk
output and its row log-sum-exp, so that the ring
(``parallel/context_parallel.py``) merges chunks exactly. Row i attends
key j iff j <= i + offset, where the offset is a runtime integer: an
offset >= Sk - 1 is full attention, a negative one shifts the diagonal,
and one <= -Sq masks every row, which then returns o = 0 and lse = -1e30
(zero weight in the merge). lse has a gradient: the backward takes (dO,
dlse) and folds dlse into delta = rowsum(dO * O) - dlse, a torch op, then
runs the dK/dV and dQ kernels as the flash backward does. Layout [B, H,
S, D]; K/V may have fewer heads (GQA, head h reads h // (H / Hk); dk and
dv are summed over the group in fp32 and cast once). No dropout.

On a CUDA tensor the wrappers launch the hand-written kernels
(``csrc/ring_chunk_attention_fwd.cu``, ``_bwd_dkv.cu`` and ``_bwd_dq.cu``,
the flash kernels' templates with the diagonal an argument) on the
current stream or raise; on a CPU tensor they compute the plain versions.
Each launch takes the design ``flash_attention.kernel_path`` picks from
(dtype, D) (bf16 and fp16 at D 64 and 128 on the tensor cores), which the
C entry points run or fail; ``PATH_LAUNCHES`` counts the launches of each.
"""
from __future__ import annotations

import torch

from . import _build
from .flash_attention import (_DTYPE_CODE, MAX_D, _aligned, _bwd_plain,
                              _fwd_plain, _on_card, _terms_plain,
                              kernel_path)

__all__ = ["ring_chunk_attention", "ring_chunk_attention_fwd",
           "ring_chunk_attention_bwd_dkv", "ring_chunk_attention_bwd_dq",
           "ring_chunk_attention_reference",
           "ring_chunk_attention_bwd_reference",
           "ring_chunk_rounding_terms", "is_supported", "LAUNCHES",
           "PATH_LAUNCHES"]

# kernel launches, counted where a kernel is launched (the plain versions
# on CPU tensors do not count)
LAUNCHES = {"ring_chunk_attention_fwd": 0, "ring_chunk_attention_bwd_dkv": 0,
            "ring_chunk_attention_bwd_dq": 0}
# the same launches by the design that ran them (flash_attention.kernel_path)
PATH_LAUNCHES = {"tc": 0, "fp32_cores": 0}


def is_supported(q_shape, k_shape, dtype) -> bool:
    """q [B, H, Sq, D] and k [B, Hk, Sk, D] with Hk dividing H, D <= 256,
    in fp32, bf16 or fp16."""
    return len(q_shape) == 4 and len(k_shape) == 4 \
        and q_shape[-1] <= MAX_D and q_shape[1] % k_shape[1] == 0 \
        and dtype in _DTYPE_CODE


class _RingChunk(torch.autograd.Function):
    """(o, lse) of one ring step, differentiable through both; the
    residuals are q, k, v, o, lse and the offset (an int)."""

    @staticmethod
    def forward(ctx, q, k, v, offset, scale):
        o, lse = ring_chunk_attention_fwd(q, k, v, offset, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (offset, scale)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1) - dlse
        dk, dv = ring_chunk_attention_bwd_dkv(q, k, v, do, lse, delta,
                                              *ctx.args)
        dq = ring_chunk_attention_bwd_dq(q, k, v, do, lse, delta, *ctx.args)
        return dq, dk, dv, None, None


def ring_chunk_attention(q, k, v, offset, scale=None):
    """q [B, H, Sq, D], k and v [B, Hk, Sk, D] (Hk dividing H), ``offset``
    an int: row i attends key j iff j <= i + offset. Returns (o [B, H, Sq,
    D] in q's dtype, lse [B, H, Sq] fp32), differentiable through both."""
    _check(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _RingChunk.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            int(offset), float(scale))


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"ring_chunk_attention: q must be [B, H, Sq, D] and k, v "
            f"[B, Hk, Sk, D], got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or not is_supported(q.shape, k.shape, q.dtype) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"ring_chunk_attention: unsupported q {tuple(q.shape)} "
            f"{q.dtype}, k/v {tuple(k.shape)} {k.dtype} {v.dtype} (same B, "
            f"D and dtype, Hk dividing H, D <= {MAX_D}, fp32, bf16 or fp16)")
    if len({x.device for x in (q, k, v)}) != 1:
        raise ValueError("ring_chunk_attention: inputs on several devices")


def _check_grad_args(q, do, lse, delta):
    b, h, sq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype \
            or tuple(lse.shape) != (b, h, sq) \
            or tuple(delta.shape) != (b, h, sq) \
            or lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(
            f"ring_chunk_attention backward: do {tuple(do.shape)} "
            f"{do.dtype}, lse {tuple(lse.shape)} {lse.dtype} and delta "
            f"{tuple(delta.shape)} {delta.dtype} do not fit q "
            f"{tuple(q.shape)} {q.dtype} (lse and delta [B, H, Sq] fp32)")


def _kernel_offset(offset, sq, sk):
    """The offset as the kernels take it: clamped to [-Sq, Sk], which
    masks the same elements and fits a C int."""
    return max(-sq, min(int(offset), sk))


def ring_chunk_attention_fwd(q, k, v, offset, scale=None):
    """(o [B, H, Sq, D] in q's dtype, lse [B, H, Sq] fp32) of one ring
    step: one block per (b, h, 64-row q tile)."""
    _check(q, k, v)
    b, h, sq, d = q.shape
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return ring_chunk_attention_reference(q, k, v, offset, scale)
    stream = _on_card("ring_chunk_attention_fwd", q, k, v)
    q, k, v = _aligned(q, k, v)
    hk, sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    path = kernel_path(q.dtype, d)
    rc = _build.load("ring_chunk_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, hk, sq, sk, d, _kernel_offset(offset, sq, sk),
        float(scale), _DTYPE_CODE[q.dtype], int(path == "tc"), stream)
    if rc != 0:
        raise RuntimeError(
            f"ring_chunk_attention_fwd: kernel launch failed with CUDA error "
            f"{rc} (q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}, "
            f"{path})")
    LAUNCHES["ring_chunk_attention_fwd"] += 1
    PATH_LAUNCHES[path] += 1
    return o, lse


def _bwd_kernel(name, outs, q, k, v, do, lse, delta, offset, scale):
    """Launch one backward kernel; CPU tensors take the plain version."""
    _check(q, k, v)
    _check_grad_args(q, do, lse, delta)
    b, h, sq, d = q.shape
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        dq, dk, dv = _bwd_plain(q, k, v, do, lse[..., None],
                                delta[..., None], offset, scale)
        return (dq,) if name.endswith("dq") else (dk, dv)
    stream = _on_card(name, q, k, v, do, lse, delta)
    q, k, v, do = _aligned(q, k, v, do)
    hk, sk = k.shape[1], k.shape[2]
    outs = tuple(torch.empty_like(x) for x in outs)
    path = kernel_path(q.dtype, d)
    rc = _build.load(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in outs),
        b, h, hk, sq, sk, d, _kernel_offset(offset, sq, sk), float(scale),
        _DTYPE_CODE[q.dtype], int(path == "tc"), stream)
    if rc != 0:
        raise RuntimeError(
            f"{name}: kernel launch failed with CUDA error {rc} (q "
            f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}, {path})")
    LAUNCHES[name] += 1
    PATH_LAUNCHES[path] += 1
    return outs


def ring_chunk_attention_bwd_dkv(q, k, v, do, lse, delta, offset,
                                 scale=None):
    """(dk, dv) [B, Hk, Sk, D] in k's dtype from q, k, v, dO, the
    forward's lse and delta = rowsum(dO * O) - dlse (both [B, H, Sq]
    fp32): one block per KV head and key tile, the GQA group summed in
    it."""
    return _bwd_kernel("ring_chunk_attention_bwd_dkv", (k, v), q, k, v, do,
                       lse, delta, offset, scale)


def ring_chunk_attention_bwd_dq(q, k, v, do, lse, delta, offset,
                                scale=None):
    """dq [B, H, Sq, D] in q's dtype from the same arguments as
    ``ring_chunk_attention_bwd_dkv``: one block per head and 64-row q
    tile."""
    return _bwd_kernel("ring_chunk_attention_bwd_dq", (q,), q, k, v, do, lse,
                       delta, offset, scale)[0]


def ring_chunk_attention_reference(q, k, v, offset, scale=None):
    """The plain version of ``ring_chunk_attention_fwd``: one dense fp32
    softmax masked at key j > row i + offset, p rounded to v's dtype before
    the PV product, the l == 0 guard (o = 0, lse = -1e30 for a row that
    attends nothing), lse = m + log(l)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    o, lse = _fwd_plain(q, k, v, offset, scale)
    return o, lse[..., 0]


def ring_chunk_attention_bwd_reference(q, k, v, o, lse, do, dlse, offset,
                                       scale=None):
    """The plain version of the backward: delta = rowsum(dO * O) - dlse,
    then the flash backward's dense fp32 arithmetic under the offset (p =
    exp(s - lse) where attended and selected away elsewhere, ds = p (dO
    V^T - delta) scale, p and ds rounded as the kernels round them, dk and
    dv summed over each GQA group in fp32). Returns (dq, dk, dv)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    delta = (do.float() * o.float()).sum(-1) - dlse
    return _bwd_plain(q, k, v, do, lse[..., None], delta[..., None], offset,
                      scale)


def ring_chunk_rounding_terms(q, k, v, o, lse, do, dlse, offset,
                              scale=None):
    """``flash_attention.rounding_terms`` for the chunk step: the
    magnitude of the terms behind each element of (o, dq, dk, dv) under
    the offset, with delta = rowsum(dO * O) - dlse."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    delta = (do.float() * o.float()).sum(-1) - dlse
    return _terms_plain(q, k, v, do, lse[..., None], delta[..., None],
                        offset, scale)
