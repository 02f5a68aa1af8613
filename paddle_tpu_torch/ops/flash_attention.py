"""Flash attention forward and backward: the CUDA kernels' wrappers, their
plain PyTorch versions, and the autograd Function that joins them.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``:
``flash_attention`` keeps the JAX layout [batch, seq, heads, head_dim]
and its keyword names and is differentiable; ``flash_attention_fwd`` is
the forward kernel on the [B, H, S, D] layout, returning ``(o, lse)`` as
``_fwd`` does (lse [B, H, Sq, 1] fp32, the row log-sum-exp the backward
reads), and ``flash_attention_bwd`` the backward, ``(dq, dk, dv)`` from
``(q, k, v, o, lse, do)`` with ``delta = rowsum(dO * O)`` taken as a torch
op (JAX takes it in XLA outside its kernels). Causal masking is aligned
bottom-right (row i attends key j iff j <= i + Sk - Sq); K/V may have
fewer heads than q (GQA, head h reads h // (H / Hk); dk and dv sum over
the group).

Attention dropout (``dropout_p > 0``) drops softmax probabilities after
normalisation (the denominator sums the raw p) and scales the kept ones
by 1 / (1 - p). The keep mask is a counter-based hash of (seed, b, h,
q_pos, k_pos) — Philox4x32-10, ``csrc/dropout.cuh`` — so the backward
regenerates the forward's mask from the seed and the mask is never
stored: the autograd Function saves q, k, v, o, lse and the seed, as the
TPU kernels' custom VJP does. ``dropout_keep`` computes the same bits
with torch integer ops, so kernel and plain version use byte-equal
masks.

On a CUDA tensor the wrappers launch the hand-written kernels
(``csrc/flash_attention_fwd.cu``, ``flash_attention_bwd_dkv.cu`` and
``flash_attention_bwd_dq.cu``) on the current stream or raise; on a CPU
tensor they compute the plain versions. ``kernel_path`` picks each
launch's design from (dtype, D) alone and the C entry points run that one
or fail: bf16 and fp16 at D 64 and 128 on the tensor cores (``wgmma``,
``csrc/wgmma_tile.cuh``), every other case on the fp32 cores (fp32 never
goes through TF32). ``PATH_LAUNCHES`` counts the launches of each.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "flash_attention_reference", "flash_attention_bwd_reference",
           "rounding_terms", "rounding_bound", "dropout_keep",
           "is_supported", "kernel_path", "LAUNCHES", "PATH_LAUNCHES"]

NEG_INF = -1e30
MAX_D = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# kernel launches, counted where a kernel is launched (the plain versions
# on CPU tensors do not count)
LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0,
            "flash_attention_bwd_dq": 0}
# the same launches by the design that ran them (kernel_path)
PATH_LAUNCHES = {"tc": 0, "fp32_cores": 0}


def kernel_path(dtype, d) -> str:
    """The design of the flash and ring chunk kernels for inputs of
    ``dtype`` and head dim ``d``, the one place the rule is stated: ``"tc"``
    (wgmma tiles) for bf16 and fp16 at D 64 and 128, else ``"fp32_cores"``.
    The wrappers pass it to the C entry points, which run that design or
    fail."""
    return ("tc" if dtype in (torch.bfloat16, torch.float16)
            and d in (64, 128) else "fp32_cores")


def is_supported(q_shape, dtype) -> bool:
    """Rank-4 [B, S, H, D] with D <= 256 in fp32, bf16 or fp16."""
    return len(q_shape) == 4 and q_shape[-1] <= MAX_D \
        and dtype in _DTYPE_CODE


class _FlashAttention(torch.autograd.Function):
    """[B, H, S, D] flash attention whose backward runs the backward
    kernels; the residuals are q, k, v, o, lse and the dropout seed."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, dropout_p, seed):
        o, lse = flash_attention_fwd(q, k, v, causal, scale, dropout_p, seed)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, dropout_p, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal=False, scale=None, dropout_p=0.0,
                    dropout_seed=0):
    """q: [B, Sq, H, D]; k, v: [B, Sk, Hk, D] with Hk dividing H. Returns
    [B, Sq, H, D] in q's dtype; differentiable. ``dropout_p > 0`` drops
    attention probabilities with the mask that ``dropout_seed`` (an int
    in [0, 2**64)) keys."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"q heads ({q.shape[2]}) must be a multiple of kv heads "
            f"({k.shape[2]}) for GQA flash attention")
    o = _FlashAttention.apply(*(x.transpose(1, 2).contiguous()
                                for x in (q, k, v)),
                              bool(causal), scale, float(dropout_p),
                              int(dropout_seed))
    return o.transpose(1, 2)


def _check(q, k, v, dropout_p=0.0, seed=0):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(
            f"flash_attention: q must be [B, H, Sq, D] and k, v "
            f"[B, Hk, Sk, D], got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] < 1 \
            or h % k.shape[1]:
        raise ValueError(
            f"flash_attention: k/v {tuple(k.shape)} do not fit q "
            f"{tuple(q.shape)} (same B and D, Hk dividing H)")
    if not is_supported((b, q.shape[2], h, d), q.dtype) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: unsupported dtypes/shapes q {q.dtype} "
            f"{tuple(q.shape)}, k {k.dtype}, v {v.dtype} (see "
            "is_supported)")
    if len({x.device for x in (q, k, v)}) != 1:
        raise ValueError("flash_attention: inputs on several devices")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"flash_attention: dropout_p must be in [0, 1), "
                         f"got {dropout_p}")
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"flash_attention: dropout seed {seed} is not in "
                         "[0, 2**64)")


def _drop_args(dropout_p, seed):
    """The kernels' dropout arguments: on/off, the seed's two words, the
    keep threshold floor(p * 2^32) and 1 / (1 - p)."""
    if dropout_p <= 0.0:
        return (0, 0, 0, 0, 1.0)
    return (1, seed & 0xFFFFFFFF, seed >> 32, _threshold(dropout_p),
            1.0 / (1.0 - dropout_p))


def _threshold(dropout_p):
    return min(int(dropout_p * 4294967296.0), 4294967295)


def _on_card(name, *xs):
    if xs[0].device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {xs[0].device}")
    for i, x in enumerate(xs):
        if not x.is_contiguous():
            raise ValueError(f"{name}: input {i} must be contiguous")
    return torch.cuda.current_stream(xs[0].device).cuda_stream


def _aligned(*xs):
    """The tensor-core kernels load 16-byte chunks: a view whose start is
    not 16-byte aligned is copied (a fresh allocation is)."""
    return tuple(x if x.data_ptr() % 16 == 0 else x.clone() for x in xs)


def flash_attention_fwd(q, k, v, causal=False, scale=None, dropout_p=0.0,
                        seed=0):
    """q [B, H, Sq, D], k/v [B, Hk, Sk, D] -> (o [B, H, Sq, D] in q's
    dtype, lse [B, H, Sq, 1] fp32)."""
    _check(q, k, v, dropout_p, seed)
    b, h, sq, d = q.shape
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, dropout_p,
                                         seed)
    stream = _on_card("flash_attention_fwd", q, k, v)
    q, k, v = _aligned(q, k, v)
    hk, sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    path = kernel_path(q.dtype, d)
    fn = _build.load("flash_attention_fwd")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, hk, sq, sk, d, int(bool(causal)),
            float(scale), _DTYPE_CODE[q.dtype], int(path == "tc"),
            *_drop_args(dropout_p, seed), stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_fwd: kernel launch failed with CUDA error "
            f"{rc} (q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}, "
            f"{path})")
    LAUNCHES["flash_attention_fwd"] += 1
    PATH_LAUNCHES[path] += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=None,
                        dropout_p=0.0, seed=0):
    """Gradients of ``flash_attention_fwd`` with the same arguments: from
    q, k, v, its o and lse, and dO [B, H, Sq, D], returns (dq in q's
    dtype, dk and dv [B, Hk, Sk, D] in k's). delta = rowsum(dO * O) is a
    torch op; then the dK/dV kernel and the dQ kernel."""
    _check(q, k, v, dropout_p, seed)
    if o.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} "
                         f"{o.dtype} does not fit q {tuple(q.shape)} "
                         f"{q.dtype}")
    _check_grad_args(q, do, lse)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                             scale, dropout_p, seed)
    delta = (do.float() * o.float()).sum(-1)          # [B, H, Sq] fp32
    args = (q, k, v, do, lse, delta, causal, scale, dropout_p, seed)
    dk, dv = flash_attention_bwd_dkv(*args)
    return flash_attention_bwd_dq(*args), dk, dv


def _check_grad_args(q, do, lse, delta=None):
    b, h, sq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype \
            or tuple(lse.shape) != (b, h, sq, 1) \
            or lse.dtype != torch.float32 or (delta is not None and (
                tuple(delta.shape) != (b, h, sq)
                or delta.dtype != torch.float32)):
        raise ValueError(
            f"flash_attention backward: do {tuple(do.shape)} {do.dtype}, "
            f"lse {tuple(lse.shape)} {lse.dtype} and delta do not fit q "
            f"{tuple(q.shape)} {q.dtype} (lse [B, H, Sq, 1] and delta "
            "[B, H, Sq] fp32)")


def _bwd_kernel(name, outs, q, k, v, do, lse, delta, causal, scale,
                dropout_p, seed):
    """Launch one backward kernel; CPU tensors take the plain version."""
    _check(q, k, v, dropout_p, seed)
    _check_grad_args(q, do, lse, delta)
    b, h, sq, d = q.shape
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        dq, dk, dv = _bwd_plain(q, k, v, do, lse, delta[..., None],
                                _diagonal(causal, q.shape[2], k.shape[2]),
                                scale, dropout_p, seed)
        return (dq,) if name.endswith("dq") else (dk, dv)
    stream = _on_card(name, q, k, v, do, lse, delta)
    q, k, v, do = _aligned(q, k, v, do)
    hk, sk = k.shape[1], k.shape[2]
    outs = tuple(torch.empty_like(x) for x in outs)
    path = kernel_path(q.dtype, d)
    rc = _build.load(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in outs),
        b, h, hk, sq, sk, d, int(bool(causal)), float(scale),
        _DTYPE_CODE[q.dtype], int(path == "tc"),
        *_drop_args(dropout_p, seed), stream)
    if rc != 0:
        raise RuntimeError(
            f"{name}: kernel launch failed with CUDA error {rc} (q "
            f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}, {path})")
    LAUNCHES[name] += 1
    PATH_LAUNCHES[path] += 1
    return outs


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False,
                            scale=None, dropout_p=0.0, seed=0):
    """(dk, dv) [B, Hk, Sk, D] in k's dtype from q, k, v, dO, the
    forward's lse [B, H, Sq, 1] and delta = rowsum(dO * O) [B, H, Sq]
    fp32: one block per KV head and key tile, the GQA group summed in
    it."""
    return _bwd_kernel("flash_attention_bwd_dkv", (k, v), q, k, v, do, lse,
                       delta, causal, scale, dropout_p, seed)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=False,
                           scale=None, dropout_p=0.0, seed=0):
    """dq [B, H, Sq, D] in q's dtype from the same arguments as
    ``flash_attention_bwd_dkv``: one block per head and 64-row q tile."""
    return _bwd_kernel("flash_attention_bwd_dq", (q,), q, k, v, do, lse,
                       delta, causal, scale, dropout_p, seed)[0]


# Philox4x32-10's multipliers and key increments (csrc/dropout.cuh)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a, m):
    """(high, low) 32-bit words of a * m, for an int64 tensor a of uint32
    values and an int m < 2**32, exactly and without leaving int64: the
    product is taken in two 16-bit halves of m."""
    t = a * (m & 0xFFFF)
    x = a * (m >> 16) + (t >> 16)
    return x >> 16, ((x & 0xFFFF) << 16) | (t & 0xFFFF)


def _philox(c0, c1, c2, c3, k0, k1):
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def dropout_keep(seed, b, h, sq, sk, dropout_p, device="cpu"):
    """The keep mask [B, H, Sq, Sk] (bool) that the kernels draw: element
    (b, h, i, j) is word i % 4 of Philox4x32-10 with key (seed low word,
    seed high word) and counter (j, i // 4, b * H + h, 0), kept iff it is
    >= floor(p * 2**32). On a CUDA device the bits come from the
    forward kernel's library (``paddle_flash_dropout_mask``, a check that
    the two agree byte for byte)."""
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"dropout seed {seed} is not in [0, 2**64)")
    device = torch.device(device)
    thresh = _threshold(dropout_p)
    if device.type == "cuda":
        mask = torch.empty((b, h, sq, sk), dtype=torch.uint8, device=device)
        rc = _build.load("flash_dropout_mask")(
            mask.data_ptr(), b, h, sq, sk, seed & _MASK32, seed >> 32,
            thresh, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flash_dropout_mask: kernel launch failed "
                               f"with CUDA error {rc}")
        return mask.bool()
    sq4 = -(-sq // 4)
    i64 = {"dtype": torch.int64, "device": device}
    cols = torch.arange(sk, **i64)[None, None, :]
    rows4 = torch.arange(sq4, **i64)[None, :, None]
    heads = torch.arange(b * h, **i64)[:, None, None]
    zero = torch.zeros((), **i64)
    words = _philox(cols, rows4, heads, zero, seed & _MASK32, seed >> 32)
    bits = torch.stack([w.expand(b * h, sq4, sk) for w in words], dim=2)
    return (bits.reshape(b, h, 4 * sq4, sk)[:, :, :sq] >= thresh)


def _keep_scale(q, k, dropout_p, seed):
    """keep / (1 - p) as fp32 [B, H, Sq, Sk], or None without dropout."""
    if dropout_p <= 0.0:
        return None
    keep = dropout_keep(seed, q.shape[0], q.shape[1], q.shape[2],
                        k.shape[2], dropout_p, q.device)
    return keep.float() * (1.0 / (1.0 - dropout_p))


def _diagonal(causal, sq, sk):
    """The kernels' diagonal offset: row i attends key j iff j <= i +
    offset (bottom-right when causal; no key lies past Sk)."""
    return sk - sq if causal else sk


def _scores(q, k, offset, scale):
    """fp32 scaled scores [B, H, Sq, Sk] against K repeated over the GQA
    group, and the bool mask [Sq, Sk] of attended positions (key j <= row
    i + offset)."""
    h, hk = q.shape[1], k.shape[1]
    sq, sk = q.shape[2], k.shape[2]
    kk = k.repeat_interleave(h // hk, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    return s, cols <= rows + offset


def flash_attention_reference(q, k, v, causal=False, scale=None,
                              dropout_p=0.0, seed=0):
    """The plain version of ``flash_attention_fwd``: one dense fp32
    softmax with the kernel's masking, p times the keep multiplier (under
    dropout) rounded to v's dtype before the PV product, the l == 0 guard,
    lse = m + log(l) with l the sum of the raw p."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _fwd_plain(q, k, v, _diagonal(causal, q.shape[2], k.shape[2]),
                      scale, dropout_p, seed)


def _fwd_plain(q, k, v, offset, scale, dropout_p=0.0, seed=0):
    """The forward's dense fp32 arithmetic under the diagonal ``offset``:
    (o in q's dtype, lse [B, H, Sq, 1]); a row that attends nothing keeps
    m = -1e30, so o = 0 and lse = -1e30."""
    h, hk = q.shape[1], k.shape[1]
    s, mask = _scores(q, k, offset, scale)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    vv = v.repeat_interleave(h // hk, dim=1)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    lsum = p.sum(-1, keepdim=True)
    lsafe = torch.where(lsum == 0, torch.ones_like(lsum), lsum)
    dm = _keep_scale(q, k, dropout_p, seed)
    pv = p if dm is None else p * dm
    o = torch.einsum("bhqk,bhkd->bhqd", pv.to(v.dtype).float(), vv.float())
    return (o / lsafe).to(q.dtype), m + torch.log(lsafe)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal=False,
                                  scale=None, dropout_p=0.0, seed=0):
    """The plain version of ``flash_attention_bwd``, the TPU kernels'
    arithmetic on dense fp32 matrices: delta = rowsum(dO * O), p = exp(s -
    lse) where attended, dv = (p m)^T dO with p m rounded to dO's dtype,
    ds = p ((dO V^T) m - delta) scale, dk = ds^T q and dq = ds K with ds
    rounded to q's dtype, dk and dv summed over each GQA group; m is the
    keep multiplier (1 without dropout)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    return _bwd_plain(q, k, v, do, lse, delta,
                      _diagonal(causal, q.shape[2], k.shape[2]), scale,
                      dropout_p, seed)


def _bwd_plain(q, k, v, do, lse, delta, offset, scale, dropout_p=0.0,
               seed=0):
    """The backward's dense fp32 arithmetic; lse and delta [B, H, Sq, 1].
    A masked p is selected away, never multiplied (at lse = -1e30 its exp
    is inf)."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    s, mask = _scores(q, k, offset, scale)
    p = torch.where(mask, torch.exp(s - lse), torch.zeros_like(s))
    dm = _keep_scale(q, k, dropout_p, seed)
    vv = v.repeat_interleave(h // hk, dim=1).float()
    kk = k.repeat_interleave(h // hk, dim=1).float()
    pd = p if dm is None else p * dm
    dv = torch.einsum("bhqk,bhqd->bhkd", pd.to(do.dtype).float(), do.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vv)
    if dm is not None:
        dp = dp * dm
    ds = p * (dp - delta) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), kk)
    g = h // hk
    dk = dk.reshape(b, hk, g, sk, d).sum(2)
    dv = dv.reshape(b, hk, g, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rounding_terms(q, k, v, o, lse, do, causal=False, scale=None,
                   dropout_p=0.0, seed=0):
    """The magnitude of the terms behind each element of (o, dq, dk, dv),
    on the plain versions' dense fp32 arithmetic: o_i over sum_j |p m|_ij
    |v_j|, dv_j over sum_i |p m|_ij |dO_i|, dk_j over sum_i |ds_ij| |q_i|
    and dq_i over sum_j |ds_ij| |k_j| (p = exp(s - lse), m the keep
    multiplier, ds as the backward takes it; dk and dv summed over each
    GQA group). Kernel and plain version round p m and ds to the working
    dtype after fp32 sums taken in another order, so one operand may land
    on the neighbouring value; ``rounding_bound`` turns these into each
    element's tolerance."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    return _terms_plain(q, k, v, do, lse, delta,
                        _diagonal(causal, q.shape[2], k.shape[2]), scale,
                        dropout_p, seed)


def _terms_plain(q, k, v, do, lse, delta, offset, scale, dropout_p=0.0,
                 seed=0):
    """``rounding_terms`` under the diagonal ``offset``, lse and delta
    [B, H, Sq, 1], as ``_bwd_plain`` takes them."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    s, mask = _scores(q, k, offset, scale)
    p = torch.where(mask, torch.exp(s - lse), torch.zeros_like(s))
    del s
    dm = _keep_scale(q, k, dropout_p, seed)
    vv = v.repeat_interleave(h // hk, dim=1).float()
    kk = k.repeat_interleave(h // hk, dim=1).float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vv)
    if dm is not None:
        dp = dp * dm
        pd = p * dm
    else:
        pd = p
    ds = (p * (dp - delta) * scale).abs_()
    del dp, p
    to = torch.einsum("bhqk,bhkd->bhqd", pd, vv.abs())
    tv = torch.einsum("bhqk,bhqd->bhkd", pd, do.float().abs())
    tk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float().abs())
    tq = torch.einsum("bhqk,bhkd->bhqd", ds, kk.abs())
    g = h // hk
    return (to, tq, tk.reshape(b, hk, g, sk, d).sum(2),
            tv.reshape(b, hk, g, sk, d).sum(2))


def rounding_bound(want, terms, atol, rtol):
    """Each element's bound on |kernel - plain version| for an output of
    the flash or ring chunk kernels: ``atol`` times the plain output's rms,
    ``rtol`` times the element, and one unit of the working dtype's
    rounding (``finfo.eps``, at least the gap from a value to its
    neighbour over the value) times the element's ``terms``
    (``rounding_terms``): an operand of the products that the two sides
    round to neighbouring values moves the element by at most that."""
    w = want.float()
    rms = w.pow(2).mean().sqrt()
    return atol * rms + rtol * w.abs() + torch.finfo(want.dtype).eps * terms
