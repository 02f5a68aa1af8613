"""LayerNorm and RMSNorm forward and backward: the CUDA kernels' wrappers,
their plain PyTorch versions, and the autograd Functions that join them.

Counterpart of ``paddle_tpu/ops/pallas/layer_norm.py``, which keeps both.
``layer_norm``: rows normalised over the last dim with fp32 statistics
(mean, then the variance of the deviations, rstd = rsqrt(var + eps)) and
the affine fused; the backward gives dx and fp32 dgamma / dbeta partials,
one pair a block, that the same call sums in a fixed order, so the result
does not depend on scheduling.
``rms_norm``: rows scaled by rstd = rsqrt(mean(x^2) + eps) and the weight,
the product taken in fp32 and rounded once to x's dtype; its backward
gives dx and fp32 dgamma partials that the same call sums in a fixed
order. Unlike the TPU kernels, any row count is taken (no padding to 8).

The RMSNorm kernels have two designs each, picked by ``rms_norm_path``:
``"row_block"`` (a row held in a block's registers, read once and
written once, a persistent grid of ``rms_norm_blocks`` blocks walking the
rows; the backward's dgamma partials one a block, ``rms_bwd_partials``)
where D fills whole 16-byte vectors, 128 to 512 of them (bf16 and fp16 D
1024-4096, fp32 D 512-2048, LLaMA-2 7B's 4096 in bf16), and
``"per_warp"`` (a warp a row, two passes over it) elsewhere.
The LayerNorm backward has two designs, picked by ``layer_norm_path``:
``"row_warp"`` (a row held by a warp's registers, read once and written
once, a persistent grid of ``layer_norm_blocks`` blocks of _ROW_WARPS
warps walking the rows, each warp's next rows in flight into shared
memory; the dgamma / dbeta partials one pair a block,
``ln_bwd_partials``) where D fills 32 to 128 whole 16-byte vectors (bf16
and fp16 D 256-1024, GPT-2's 768 among them; fp32 D 128-512), and
``"per_warp"`` (a warp a row, two passes, a block of 32 rows a partial)
elsewhere. ``PATH_LAUNCHES`` counts the launches of the kernels with two
designs by design; the C entries run the design they are given or fail.

On a CUDA tensor ``layer_norm_fwd`` / ``layer_norm_bwd`` and
``rms_norm_fwd`` / ``rms_norm_bwd`` launch ``csrc/layer_norm_fwd.cu``,
``csrc/layer_norm_bwd.cu``, ``csrc/rms_norm_fwd.cu`` and
``csrc/rms_norm_bwd.cu`` on the current stream or raise; on a CPU tensor
they compute the plain versions.
"""
from __future__ import annotations

import functools

import torch

from . import _build

__all__ = ["layer_norm", "layer_norm_fwd", "layer_norm_bwd",
           "layer_norm_fwd_reference", "layer_norm_bwd_reference",
           "rms_norm", "rms_norm_fwd", "rms_norm_bwd",
           "rms_norm_fwd_reference", "rms_norm_bwd_reference",
           "is_supported", "LAUNCHES", "PATH_LAUNCHES", "ROWS_PER_PARTIAL",
           "rms_norm_path", "rms_norm_blocks", "rms_bwd_partials",
           "layer_norm_path", "layer_norm_blocks", "ln_bwd_partials",
           "layer_norm_bwd_row_warp_reference"]

MAX_D = 16384
# rows a dgamma (and dbeta) partial covers in the per-warp designs: kRows
# in csrc/layer_norm_bwd.cu and rms_norm_bwd.cu
ROWS_PER_PARTIAL = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# kernel launches, counted where a kernel is launched (the plain versions
# on CPU tensors do not count)
LAUNCHES = {"layer_norm_fwd": 0, "layer_norm_bwd": 0, "rms_norm_fwd": 0,
            "rms_norm_bwd": 0}
# the launches of the kernels with two designs by the design that ran
# them (rms_norm_path, layer_norm_path)
PATH_LAUNCHES = {"rms_norm_fwd": {"row_block": 0, "per_warp": 0},
                 "rms_norm_bwd": {"row_block": 0, "per_warp": 0},
                 "layer_norm_bwd": {"row_warp": 0, "per_warp": 0}}
_PATH_CODE = {"per_warp": 0, "row_block": 1, "row_warp": 1}
# the row-block design: 16-byte vectors a row must fill (csrc/row_block.cuh
# holds at most two a thread of its 256; fewer than 128 leave most of the
# block idle)
_ROW_BLOCK_VECTORS = (128, 512)
# the row-warp design (csrc/layer_norm_bwd.cu): 16-byte vectors a row must
# fill (a warp's 32 lanes, at most kMaxLaneNv = 4 a lane) and warps a block
# (kWarps)
_ROW_WARP_VECTORS = (32, 128)
_ROW_WARPS = 8
# the persistent grids' blocks per SM
_ROW_BLOCKS_PER_SM = {"rms_norm_fwd": 4, "rms_norm_bwd": 2,
                      "layer_norm_bwd": 1}
_PER_WARP_ROWS = {"rms_norm_fwd": 8, "rms_norm_bwd": ROWS_PER_PARTIAL,
                  "layer_norm_bwd": ROWS_PER_PARTIAL}
# warps a block of the partials' sum, each taking every _SUM_WARPS-th
# partial (kSumWarps in csrc/layer_norm_bwd.cu)
_SUM_WARPS = 32


def is_supported(shape, dtype) -> bool:
    """A last dim of at most 16384 in fp32, bf16 or fp16 (the TPU kernels'
    gate, without its row minimum)."""
    return len(shape) >= 1 and 1 <= shape[-1] <= MAX_D \
        and dtype in _DTYPE_CODE


class _LayerNorm(torch.autograd.Function):
    """[N, D] LayerNorm whose backward runs the backward kernel; the
    residuals are x, gamma and the fp32 mean and rstd."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, eps):
        y, mean, rstd = layer_norm_fwd(x2, gamma, beta, eps)
        ctx.save_for_backward(x2, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, gamma, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_bwd(x2, gamma, mean, rstd,
                                           dy.contiguous())
        return dx, dgamma, dbeta, None


def layer_norm(x, gamma, beta, eps=1e-5):
    """Normalise x [..., D] over its last dim; gamma, beta [D] in x's
    dtype. Differentiable."""
    d = x.shape[-1]
    y = _LayerNorm.apply(x.reshape(-1, d).contiguous(), gamma.contiguous(),
                         beta.contiguous(), float(eps))
    return y.reshape(x.shape)


def _check(x2, params, others=(), name="layer_norm"):
    """x2 [N >= 1, D], the affine ``params`` [D] in its dtype, and every
    tensor on one device."""
    if x2.dim() != 2 or not is_supported(x2.shape, x2.dtype):
        raise ValueError(f"{name}: x must be [N, D <= {MAX_D}] in fp32, "
                         f"bf16 or fp16, got {tuple(x2.shape)} {x2.dtype}")
    if x2.shape[0] < 1:
        raise ValueError(f"{name}: x has no rows")
    for t in (*params, *others):
        if t.device != x2.device:
            raise ValueError(f"{name}: inputs on several devices")
    for t in params:
        if tuple(t.shape) != (x2.shape[1],) or t.dtype != x2.dtype:
            raise ValueError(
                f"{name}: the weights must be [{x2.shape[1]}] in "
                f"{x2.dtype}, got {tuple(t.shape)} {t.dtype}")


def _check_stats(name, x2, dy, *stats):
    """dy like x2, each of ``stats`` [N, 1] fp32."""
    n = x2.shape[0]
    if dy.shape != x2.shape or dy.dtype != x2.dtype or any(
            tuple(t.shape) != (n, 1) or t.dtype != torch.float32
            for t in stats):
        raise ValueError(
            f"{name}: dy {tuple(dy.shape)} {dy.dtype} and the fp32 "
            f"statistics {[tuple(t.shape) for t in stats]} "
            f"{[t.dtype for t in stats]} do not fit x {tuple(x2.shape)} "
            f"{x2.dtype}")


def _stream(name, *xs):
    if xs[0].device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {xs[0].device}")
    for i, x in enumerate(xs):
        if not x.is_contiguous():
            raise ValueError(f"{name}: input {i} must be contiguous")
    return torch.cuda.current_stream(xs[0].device).cuda_stream


def layer_norm_fwd(x2, gamma, beta, eps=1e-5):
    """x2 [N, D], gamma/beta [D] -> (y [N, D] in x2's dtype, mean [N, 1]
    and rstd [N, 1] fp32)."""
    _check(x2, (gamma, beta))
    if x2.device.type == "cpu":
        return layer_norm_fwd_reference(x2, gamma, beta, eps)
    stream = _stream("layer_norm_fwd", x2, gamma, beta)
    n, d = x2.shape
    y = torch.empty_like(x2)
    mean = torch.empty((n, 1), dtype=torch.float32, device=x2.device)
    rstd = torch.empty_like(mean)
    rc = _build.load("layer_norm_fwd")(
        x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), n, d, float(eps),
        _DTYPE_CODE[x2.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm_fwd: kernel launch failed with CUDA "
                           f"error {rc} (x {tuple(x2.shape)} {x2.dtype})")
    LAUNCHES["layer_norm_fwd"] += 1
    return y, mean, rstd


def layer_norm_bwd(x2, gamma, mean, rstd, dy):
    """Gradients of ``layer_norm_fwd``: from x2 [N, D], gamma, its fp32
    mean and rstd [N, 1] and dy [N, D], returns (dx in x2's dtype, dgamma
    and dbeta [D] in gamma's dtype, summed in fp32 over the partials of
    ``ln_bwd_partials`` in a fixed order by the same call)."""
    name = "layer_norm_bwd"
    _check(x2, (gamma,), (mean, rstd, dy))
    _check_stats(name, x2, dy, mean, rstd)
    if x2.device.type == "cpu":
        return layer_norm_bwd_reference(x2, gamma, mean, rstd, dy)
    _stream(name, x2, gamma, mean, rstd, dy)
    n, d = x2.shape
    dx = torch.empty_like(x2)
    dgb = torch.empty((2, d), dtype=gamma.dtype, device=x2.device)
    path, blocks = _design(name, x2, gamma, dy, dx)
    parts = torch.empty((blocks, 2 * d), dtype=torch.float32,
                        device=x2.device)
    _call(name, x2, (x2, gamma, mean, rstd, dy, dx, parts, dgb), (n, d),
          path, blocks)
    return dx, dgb[0], dgb[1]


def layer_norm_fwd_reference(x2, gamma, beta, eps=1e-5):
    """The plain version of ``layer_norm_fwd``, the TPU kernel's
    arithmetic: fp32 mean, variance of the deviations, rsqrt, affine in
    fp32, one rounding to x's dtype."""
    x = x2.float()
    mean = x.mean(1, keepdim=True)
    xc = x - mean
    rstd = torch.rsqrt((xc * xc).mean(1, keepdim=True) + eps)
    y = xc * rstd * gamma.float() + beta.float()
    return y.to(x2.dtype), mean, rstd


def layer_norm_bwd_reference(x2, gamma, mean, rstd, dy):
    """The plain version of ``layer_norm_bwd``, the TPU kernel's
    arithmetic in fp32: dx = (w - mean(w) - xhat mean(w xhat)) rstd with
    w = dy gamma; dgamma = sum(dy xhat), dbeta = sum(dy) over the rows."""
    x, g = x2.float(), dy.float()
    xhat = (x - mean) * rstd
    w = g * gamma.float()
    c1 = w.mean(1, keepdim=True)
    c2 = (w * xhat).mean(1, keepdim=True)
    dx = (w - c1 - xhat * c2) * rstd
    return (dx.to(x2.dtype), (g * xhat).sum(0).to(gamma.dtype),
            g.sum(0).to(gamma.dtype))


def layer_norm_path(dtype, d, aligned=True) -> str:
    """The design of the LayerNorm backward kernel for rows of ``d``
    elements of ``dtype``: ``"row_warp"`` where d fills 32 to 128 whole
    16-byte vectors (a row in one warp's registers, one to four vectors
    of x and of dy a lane: bf16 and fp16 D 256-1024, GPT-2's 768 among
    them, fp32 D 128-512) and the tensors are 16-byte ``aligned``, else
    ``"per_warp"``. The one place the rule is stated; the wrapper passes
    it to the C entry, which runs that design or fails."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    lo, hi = _ROW_WARP_VECTORS
    if aligned and d % per == 0 and lo <= d // per <= hi:
        return "row_warp"
    return "per_warp"


def layer_norm_blocks(n, path, n_sm):
    """Thread blocks of the LayerNorm backward kernel over n rows on design
    ``path``: the row-warp design's persistent grid of _ROW_WARPS-warp
    blocks, _ROW_BLOCKS_PER_SM an SM but never more than the rows fill
    (from the shapes and the SM count alone, so the launch reads nothing
    back and can be captured in a CUDA graph); the per-warp design's block
    of ROWS_PER_PARTIAL rows."""
    if path == "row_warp":
        return min(-(-n // _ROW_WARPS),
                   _ROW_BLOCKS_PER_SM["layer_norm_bwd"] * n_sm)
    return -(-n // _PER_WARP_ROWS["layer_norm_bwd"])


def ln_bwd_partials(n, path, n_sm):
    """The rows each dgamma / dbeta partial of ``layer_norm_bwd`` covers,
    one partial a block (``layer_norm_blocks``), in the order the kernel
    adds them: warp w of block b of the row-warp design walks rows b * W
    + w, then that plus blocks * W, ... (W = _ROW_WARPS), and the block
    adds its warps in order; block b of the per-warp design takes
    ROWS_PER_PARTIAL rows from b * ROWS_PER_PARTIAL. Every row lies in
    exactly one partial."""
    blocks = layer_norm_blocks(n, path, n_sm)
    if path == "row_warp":
        w = _ROW_WARPS
        return [[r for warp in range(w)
                 for r in range(b * w + warp, n, blocks * w)]
                for b in range(blocks)]
    return [range(b * ROWS_PER_PARTIAL, min(n, (b + 1) * ROWS_PER_PARTIAL))
            for b in range(blocks)]


def layer_norm_bwd_row_warp_reference(x2, gamma, mean, rstd, dy, n_sm):
    """The plain version of the row-warp design's arithmetic on ``n_sm``
    SMs, in fp32 and in the kernel's order: dx as
    ``layer_norm_bwd_reference``; each warp's dy xhat (dgamma) and dy
    (dbeta) added row by row in its walk order, a block's warps added in
    warp order into its partial (``ln_bwd_partials``), the partials summed
    as the sum kernel sums them (warp w of _SUM_WARPS takes partials w, w +
    _SUM_WARPS, ... in order, then the warps' sums in order), rounded once
    to gamma's dtype."""
    n, d = x2.shape
    g = dy.float()
    terms = torch.stack((g * ((x2.float() - mean) * rstd), g))
    blocks = layer_norm_blocks(n, "row_warp", n_sm)
    w = _ROW_WARPS
    steps = -(-n // (blocks * w))
    # row step * blocks * w + b * w + warp, padded with zero rows
    terms = torch.cat((terms, terms.new_zeros(2, steps * blocks * w - n, d)),
                      1).reshape(2, steps, blocks, w, d)
    warp_acc = functools.reduce(torch.add, terms.unbind(1))
    part = functools.reduce(torch.add, warp_acc.unbind(2))   # [2, blocks, d]
    sums = [functools.reduce(torch.add, part[:, s::_SUM_WARPS].unbind(1))
            for s in range(min(_SUM_WARPS, blocks))]
    dgamma, dbeta = functools.reduce(torch.add, sums).to(gamma.dtype)
    dx = layer_norm_bwd_reference(x2, gamma, mean, rstd, dy)[0]
    return dx, dgamma, dbeta


class _RMSNorm(torch.autograd.Function):
    """[N, D] RMSNorm whose backward runs the backward kernel; the
    residuals are x, gamma and the fp32 rstd."""

    @staticmethod
    def forward(ctx, x2, gamma, eps):
        y, rstd = rms_norm_fwd(x2, gamma, eps)
        ctx.save_for_backward(x2, gamma, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, gamma, rstd = ctx.saved_tensors
        dx, dgamma = rms_norm_bwd(x2, gamma, rstd, dy.contiguous())
        return dx, dgamma, None


def rms_norm(x, gamma, eps=1e-6):
    """Scale x [..., D] by the reciprocal root of its rows' mean square and
    by gamma [D] in x's dtype. Differentiable."""
    d = x.shape[-1]
    y = _RMSNorm.apply(x.reshape(-1, d).contiguous(), gamma.contiguous(),
                       float(eps))
    return y.reshape(x.shape)


def rms_norm_path(dtype, d, aligned=True) -> str:
    """The design of the RMSNorm kernels for rows of ``d`` elements of
    ``dtype``: ``"row_block"`` where d fills 128 to 512 whole 16-byte
    vectors (a row in the registers of a 256-thread block, at most two
    vectors of x and two of dy a thread) and the tensors are 16-byte
    ``aligned``, else ``"per_warp"``. The one place the rule is stated;
    the wrappers pass it to the C entries, which run that design or
    fail."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    lo, hi = _ROW_BLOCK_VECTORS
    if aligned and d % per == 0 and lo <= d // per <= hi:
        return "row_block"
    return "per_warp"


def rms_norm_blocks(name, n, path, n_sm):
    """Thread blocks of kernel ``name`` (``"rms_norm_fwd"`` or
    ``"rms_norm_bwd"``) over n rows on design ``path``: the row-block
    design's persistent grid, _ROW_BLOCKS_PER_SM blocks an SM but never
    more than the rows (from the shapes and the SM count alone, so the
    launch reads nothing back and can be captured in a CUDA graph); the
    per-warp design's block of 8 (forward) or ROWS_PER_PARTIAL (backward)
    rows."""
    if path == "row_block":
        return min(n, _ROW_BLOCKS_PER_SM[name] * n_sm)
    return -(-n // _PER_WARP_ROWS[name])


def rms_bwd_partials(n, path, n_sm):
    """The rows each dgamma partial of ``rms_norm_bwd`` covers, one
    partial a block (``rms_norm_blocks``): block b of the row-block design
    walks rows b, b + blocks, ...; block b of the per-warp design takes
    ROWS_PER_PARTIAL rows from b * ROWS_PER_PARTIAL. Every row lies in
    exactly one partial."""
    blocks = rms_norm_blocks("rms_norm_bwd", n, path, n_sm)
    if path == "row_block":
        return [range(b, n, blocks) for b in range(blocks)]
    return [range(b * ROWS_PER_PARTIAL, min(n, (b + 1) * ROWS_PER_PARTIAL))
            for b in range(blocks)]


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _design(name, x2, *tensors):
    """(path, blocks) of kernel ``name`` (an RMSNorm kernel or the
    LayerNorm backward) over x2 and ``tensors`` (their 16-byte alignment
    is part of ``rms_norm_path``'s and ``layer_norm_path``'s rules)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, *tensors))
    (n, d), n_sm = x2.shape, _sm_count(x2.device.index)
    if name == "layer_norm_bwd":
        path = layer_norm_path(x2.dtype, d, aligned)
        return path, layer_norm_blocks(n, path, n_sm)
    path = rms_norm_path(x2.dtype, d, aligned)
    return path, rms_norm_blocks(name, n, path, n_sm)


def _call(name, x2, tensors, ints, path, blocks):
    """Launch kernel ``name`` on the current stream: the pointers of
    ``tensors``, the ints, the dtype code, the design and its block count.
    Raises on a refused launch, naming the design: no other is tried."""
    rc = _build.load(name)(
        *(t.data_ptr() for t in tensors), *ints, _DTYPE_CODE[x2.dtype],
        _PATH_CODE[path], blocks,
        torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc} (x {tuple(x2.shape)} {x2.dtype}; {path})")
    LAUNCHES[name] += 1
    PATH_LAUNCHES[name][path] += 1


def rms_norm_fwd(x2, gamma, eps=1e-6):
    """x2 [N, D], gamma [D] -> (y [N, D] in x2's dtype, rstd [N, 1]
    fp32)."""
    name = "rms_norm_fwd"
    _check(x2, (gamma,), name="rms_norm")
    if x2.device.type == "cpu":
        return rms_norm_fwd_reference(x2, gamma, eps)
    _stream(name, x2, gamma)
    n, d = x2.shape
    y = torch.empty_like(x2)
    rstd = torch.empty((n, 1), dtype=torch.float32, device=x2.device)
    path, blocks = _design(name, x2, gamma, y)
    _call(name, x2, (x2, gamma, y, rstd), (n, d, float(eps)), path, blocks)
    return y, rstd


def rms_norm_bwd(x2, gamma, rstd, dy):
    """Gradients of ``rms_norm_fwd``: from x2 [N, D], gamma, its fp32 rstd
    [N, 1] and dy [N, D], returns (dx in x2's dtype, dgamma [D] in gamma's
    dtype, summed in fp32 over the partials of ``rms_bwd_partials`` in a
    fixed order by the same call)."""
    name = "rms_norm_bwd"
    _check(x2, (gamma,), (rstd, dy), name="rms_norm")
    _check_stats(name, x2, dy, rstd)
    if x2.device.type == "cpu":
        return rms_norm_bwd_reference(x2, gamma, rstd, dy)
    _stream(name, x2, gamma, rstd, dy)
    n, d = x2.shape
    dx = torch.empty_like(x2)
    dgamma = torch.empty_like(gamma)
    path, blocks = _design(name, x2, gamma, dy, dx)
    parts = torch.empty((blocks, d), dtype=torch.float32, device=x2.device)
    _call(name, x2, (x2, gamma, rstd, dy, dx, parts, dgamma), (n, d), path,
          blocks)
    return dx, dgamma


def rms_norm_fwd_reference(x2, gamma, eps=1e-6):
    """The plain version of ``rms_norm_fwd``, the TPU kernel's arithmetic:
    fp32 mean square, rsqrt, x * rstd * gamma in fp32, one rounding to x's
    dtype."""
    x = x2.float()
    rstd = torch.rsqrt((x * x).mean(1, keepdim=True) + eps)
    return (x * rstd * gamma.float()).to(x2.dtype), rstd


def rms_norm_bwd_reference(x2, gamma, rstd, dy):
    """The plain version of ``rms_norm_bwd``, the TPU kernel's arithmetic
    in fp32: dx = (w - xhat mean(w xhat)) rstd with w = dy gamma and xhat =
    x rstd; dgamma = sum(dy xhat) over the rows."""
    x, g = x2.float(), dy.float()
    xhat = x * rstd
    w = g * gamma.float()
    c = (w * xhat).mean(1, keepdim=True)
    dx = (w - xhat * c) * rstd
    return dx.to(x2.dtype), (g * xhat).sum(0).to(gamma.dtype)
