"""LayerNorm and RMSNorm forward and backward: the CUDA kernels' wrappers,
their plain PyTorch versions, and the autograd Functions that join them.

Counterpart of ``paddle_tpu/ops/pallas/layer_norm.py``, which keeps both.
``layer_norm``: rows normalised over the last dim with fp32 statistics
(mean, then the variance of the deviations, rstd = rsqrt(var + eps)) and
the affine fused; the backward gives dx in one pass and dgamma / dbeta
as per-block partial sums (32 rows a block on the card) that the wrapper
sums after the kernel, so the result does not depend on scheduling.
``rms_norm``: rows scaled by rstd = rsqrt(mean(x^2) + eps) and the weight,
the product taken in fp32 and rounded once to x's dtype; its backward
gives dx and dgamma partials the same way. Unlike the TPU kernels, any
row count is taken (no padding to 8).

On a CUDA tensor ``layer_norm_fwd`` / ``layer_norm_bwd`` and
``rms_norm_fwd`` / ``rms_norm_bwd`` launch ``csrc/layer_norm_fwd.cu``,
``csrc/layer_norm_bwd.cu``, ``csrc/rms_norm_fwd.cu`` and
``csrc/rms_norm_bwd.cu`` on the current stream or raise; on a CPU tensor
they compute the plain versions.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["layer_norm", "layer_norm_fwd", "layer_norm_bwd",
           "layer_norm_fwd_reference", "layer_norm_bwd_reference",
           "rms_norm", "rms_norm_fwd", "rms_norm_bwd",
           "rms_norm_fwd_reference", "rms_norm_bwd_reference",
           "is_supported", "LAUNCHES", "ROWS_PER_PARTIAL"]

MAX_D = 16384
ROWS_PER_PARTIAL = 32      # kRows in csrc/layer_norm_bwd.cu, rms_norm_bwd.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# kernel launches, counted where a kernel is launched (the plain versions
# on CPU tensors do not count)
LAUNCHES = {"layer_norm_fwd": 0, "layer_norm_bwd": 0, "rms_norm_fwd": 0,
            "rms_norm_bwd": 0}


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
    and dbeta [D] in gamma's dtype, summed in fp32)."""
    _check(x2, (gamma,), (mean, rstd, dy))
    _check_stats("layer_norm_bwd", x2, dy, mean, rstd)
    n, d = x2.shape
    if x2.device.type == "cpu":
        return layer_norm_bwd_reference(x2, gamma, mean, rstd, dy)
    stream = _stream("layer_norm_bwd", x2, gamma, mean, rstd, dy)
    dx = torch.empty_like(x2)
    parts = torch.empty((2, -(-n // ROWS_PER_PARTIAL), d),
                        dtype=torch.float32, device=x2.device)
    rc = _build.load("layer_norm_bwd")(
        x2.data_ptr(), gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), parts[0].data_ptr(),
        parts[1].data_ptr(), n, d, _DTYPE_CODE[x2.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm_bwd: kernel launch failed with CUDA "
                           f"error {rc} (x {tuple(x2.shape)} {x2.dtype})")
    LAUNCHES["layer_norm_bwd"] += 1
    dgamma, dbeta = parts.sum(1).to(gamma.dtype)
    return dx, dgamma, dbeta


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


def rms_norm_fwd(x2, gamma, eps=1e-6):
    """x2 [N, D], gamma [D] -> (y [N, D] in x2's dtype, rstd [N, 1]
    fp32)."""
    _check(x2, (gamma,), name="rms_norm")
    if x2.device.type == "cpu":
        return rms_norm_fwd_reference(x2, gamma, eps)
    stream = _stream("rms_norm_fwd", x2, gamma)
    n, d = x2.shape
    y = torch.empty_like(x2)
    rstd = torch.empty((n, 1), dtype=torch.float32, device=x2.device)
    rc = _build.load("rms_norm_fwd")(
        x2.data_ptr(), gamma.data_ptr(), y.data_ptr(), rstd.data_ptr(), n,
        d, float(eps), _DTYPE_CODE[x2.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"rms_norm_fwd: kernel launch failed with CUDA "
                           f"error {rc} (x {tuple(x2.shape)} {x2.dtype})")
    LAUNCHES["rms_norm_fwd"] += 1
    return y, rstd


def rms_norm_bwd(x2, gamma, rstd, dy):
    """Gradients of ``rms_norm_fwd``: from x2 [N, D], gamma, its fp32 rstd
    [N, 1] and dy [N, D], returns (dx in x2's dtype, dgamma [D] in gamma's
    dtype, summed in fp32)."""
    _check(x2, (gamma,), (rstd, dy), name="rms_norm")
    _check_stats("rms_norm_bwd", x2, dy, rstd)
    if x2.device.type == "cpu":
        return rms_norm_bwd_reference(x2, gamma, rstd, dy)
    stream = _stream("rms_norm_bwd", x2, gamma, rstd, dy)
    n, d = x2.shape
    dx = torch.empty_like(x2)
    parts = torch.empty((-(-n // ROWS_PER_PARTIAL), d), dtype=torch.float32,
                        device=x2.device)
    rc = _build.load("rms_norm_bwd")(
        x2.data_ptr(), gamma.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), parts.data_ptr(), n, d, _DTYPE_CODE[x2.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"rms_norm_bwd: kernel launch failed with CUDA "
                           f"error {rc} (x {tuple(x2.shape)} {x2.dtype})")
    LAUNCHES["rms_norm_bwd"] += 1
    return dx, parts.sum(0).to(gamma.dtype)


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
