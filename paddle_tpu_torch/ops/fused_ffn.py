"""The fused transformer FFN: the CUDA kernels' wrappers, their plain
PyTorch versions, and the autograd Function that joins them.

Counterpart of ``paddle_tpu/ops/pallas/fused_ffn.py``'s ``fused_ffn``:

    out = act(x @ W1 + b1) @ W2 + b2,   x [..., K], W1 [K, F], W2 [F, K]

with ``act`` GPT-2's tanh gelu (``"gelu_tanh"``) or the exact gelu
(``"gelu"``), computed in fp32; the [M, F] intermediate never reaches
device memory. The route is the JAX function's: the composite
(``_composite``) where its gate fails (``ffn_is_supported``, or no row
or F tile from ``_pick_bm`` / ``_pick_bf``), else the fused path. Only
the inputs are saved for the backward, which recomputes the
intermediate: under ``PADDLE_TPU_FUSED_FFN_BWD=1`` (read when the
backward runs) and the same gate with ``_pick_bm_bwd``, the dx and the
dW1 / dW2 / db1 kernels, else the composite backward, plain matmuls with
fp32 sums (the JAX package leaves that one to XLA). db2 is the fp32 sum
of the output gradient either way.

On a CUDA tensor ``fused_ffn_fwd``, ``fused_ffn_bwd_dx`` and
``fused_ffn_bwd_dw`` launch ``csrc/fused_ffn_fwd.cu``,
``csrc/fused_ffn_bwd_dx.cu`` and ``csrc/fused_ffn_bwd_dw.cu`` on the
current stream or raise; on a CPU tensor they compute the plain versions,
which keep the TPU kernels' roundings (the activation rounded to x's
dtype before the second product, dpre rounded before its products, db1
from the fp32 dpre). ``kernel_path`` picks all three kernels' design
from the dtype alone and their C entry points run that one or fail: bf16
and fp16 on the tensor cores (``wgmma``, ``csrc/wgmma_tile.cuh``), fp32
on the fp32 cores. ``PATH_LAUNCHES`` counts their launches by design.
"""
from __future__ import annotations

import functools
import math
import os

import torch

from . import _build

__all__ = ["fused_ffn", "ffn_is_supported", "fused_ffn_fwd",
           "fused_ffn_bwd_dx", "fused_ffn_bwd_dw",
           "fused_ffn_fwd_reference", "fused_ffn_bwd_dx_reference",
           "fused_ffn_bwd_dw_reference", "kernel_is_supported",
           "kernel_path", "LAUNCHES", "PATH_LAUNCHES"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ACT_CODE = {"gelu_tanh": 0, "gelu": 1}
# a block of the fp32-core dW kernel owns 32 F columns and walks its rows
# 32 at a time; about this many blocks keep the card's 132 SMs busy for
# four waves
_DW_BF, _DW_ROWS, _DW_TARGET_BLOCKS = 32, 64, 528
# a block of the tensor-core dW kernel owns 64 F rows and walks its rows
# 64 at a time; at most this many row ranges (fp32 partials of
# 2 * K * F * 4 bytes each)
_DW_TC_TILE, _DW_TC_MAX_SPLITS = 64, 8
# a cluster of the tensor-core dx kernel (and of the forward) owns 128
# rows; it walks F in at most this many ranges (fp32 partials of M * K * 4
# bytes each)
_DX_TC_ROWS, _DX_TC_MAX_SPLITS = 128, 4
# the F columns a range of the tensor-core forward takes at least (two of
# its 64-column sub-tiles)
_FWD_TC_MIN_F = 128
# the tensor-core kernels take the fewest ranges whose clusters fill this
# share of the card's cluster slots, in whole waves
_TC_FILL = 0.95

# kernel launches, counted where a kernel is launched (the plain versions
# on CPU tensors do not count)
LAUNCHES = {"fused_ffn_fwd": 0, "fused_ffn_bwd_dx": 0, "fused_ffn_bwd_dw": 0}
# the three kernels' launches by the design that ran them (kernel_path)
PATH_LAUNCHES = {"tc": 0, "fp32_cores": 0}
_PATH_CODE = {"tc": 1, "fp32_cores": 0}


def _gelu_tanh(x):
    # GPT-2's approximate gelu, in fp32
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def _gelu_erf(x):
    # the exact gelu (the reference fused_feedforward op's "gelu")
    return 0.5 * x * (1.0 + torch.erf(x * (2.0 ** -0.5)))


_ACTS = {"gelu_tanh": _gelu_tanh, "gelu": _gelu_erf}


def _dgelu(pre, activation):
    if activation == "gelu_tanh":
        c = math.sqrt(2.0 / math.pi)
        u = c * (pre + 0.044715 * pre ** 3)
        th = torch.tanh(u)
        return 0.5 * (1.0 + th) + 0.5 * pre * (1.0 - th * th) * c * (
            1.0 + 3 * 0.044715 * pre ** 2)
    # exact gelu: d/dx = Phi(x) + x * phi(x)
    return (0.5 * (1.0 + torch.erf(pre * (2.0 ** -0.5)))
            + pre * torch.exp(-0.5 * pre * pre)
            * (1.0 / math.sqrt(2.0 * math.pi)))


def ffn_is_supported(m, k, f, dtype) -> bool:
    """The JAX function's gate: K and F multiples of 128, at least 8 rows,
    fp32, bf16 or fp16."""
    if k % 128 or f % 128:
        return False
    if m < 8:
        return False
    return dtype in _DTYPE_CODE


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


def _pick_bf(f):
    """The TPU kernels' F tile (it must divide F)."""
    return next((c for c in (512, 256, 128) if f % c == 0), None)


def _pick_bm(m, k, f, bf, dtype):
    """The TPU forward's row tile: the largest of 1024 .. 8 dividing M
    whose tiles fit its 12 MB VMEM budget, else None (the composite)."""
    itemsize = _itemsize(dtype)
    for bm in (1024, 512, 256, 128, 64, 32, 16, 8):
        if m % bm:
            continue
        vmem = (bm * k * itemsize + 2 * k * bf * itemsize + bm * bf * 4
                + bm * k * 4)
        if vmem <= 12 * 1024 * 1024:
            return bm
    return None


def _pick_bm_bwd(m, k, bf, dtype, which):
    """The TPU backward kernels' row tile, ``which`` in {"dx", "dw"}."""
    itemsize = _itemsize(dtype)
    for bm in (512, 256, 128, 64, 32, 16, 8):
        if m % bm:
            continue
        vmem = 2 * bm * k * itemsize + 2 * k * bf * itemsize + 3 * bm * bf * 4
        if which == "dx":
            vmem += bm * bf * itemsize + bm * k * 4
        else:
            vmem += 2 * bm * bf * itemsize + 2 * k * bf * 4 + bf * 4
        if vmem <= 12 * 1024 * 1024:
            return bm
    return None


def _composite(x2, w1, b1, w2, b2, activation="gelu_tanh"):
    """The JAX function's composite forward, its roundings included."""
    t = _ACTS[activation]((x2 @ w1 + b1).float()).to(x2.dtype)
    return t @ w2 + b2


def _composite_bwd(x2, g2, w1, b1, w2, activation):
    """The JAX function's composite backward: the intermediate recomputed,
    the grads as matmuls of the stored dtypes' values with fp32 sums.
    Returns (dx2, dW1, db1, dW2) in the inputs' dtypes."""
    x32, g32, w1_32, w2_32 = (a.float() for a in (x2, g2, w1, w2))
    pre = x32 @ w1_32 + b1.float()
    t = _ACTS[activation](pre)
    dpre = (g32 @ w2_32.t()) * _dgelu(pre, activation)
    dpre_r = dpre.to(x2.dtype).float()
    dx = dpre_r @ w1_32.t()
    dw1 = x32.t() @ dpre_r
    dw2 = t.to(x2.dtype).float().t() @ g32
    return (dx.to(x2.dtype), dw1.to(w1.dtype), dpre.sum(0).to(b1.dtype),
            dw2.to(w2.dtype))


class _FusedFFN(torch.autograd.Function):
    """``fused_ffn`` with JAX's custom VJP: the inputs are the only
    residuals."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, activation):
        k, f = x.shape[-1], w1.shape[1]
        x2 = x.reshape(-1, k)
        m = x2.shape[0]
        bf = _pick_bf(f)
        bm = _pick_bm(m, k, f, bf or 128, x.dtype)
        if not ffn_is_supported(m, k, f, x.dtype) or bm is None or bf is None:
            out = _composite(x2, w1, b1, w2, b2, activation)
        else:
            out = fused_ffn_fwd(x2.contiguous(), w1, b1, w2, b2, activation)
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.activation = activation
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        act = ctx.activation
        k, f = x.shape[-1], w1.shape[1]
        x2 = x.reshape(-1, k).contiguous()
        g2 = g.reshape(-1, k).contiguous()
        m = x2.shape[0]
        db2 = g2.float().sum(0).to(b2.dtype)
        bf = _pick_bf(f)
        bm_dx = _pick_bm_bwd(m, k, bf or 128, x.dtype, "dx")
        bm_dw = _pick_bm_bwd(m, k, bf or 128, x.dtype, "dw")
        if (os.environ.get("PADDLE_TPU_FUSED_FFN_BWD") == "1"
                and ffn_is_supported(m, k, f, x.dtype)
                and bm_dx is not None and bm_dw is not None
                and bf is not None):
            dx = fused_ffn_bwd_dx(x2, g2, w1, b1, w2, act)
            dw1, dw2, db1 = fused_ffn_bwd_dw(x2, g2, w1, b1, w2, act)
            db1 = db1.to(b1.dtype)
        else:
            dx, dw1, db1, dw2 = _composite_bwd(x2, g2, w1, b1, w2, act)
        return dx.reshape(x.shape), dw1, db1, dw2, db2, None


def fused_ffn(x, w1, b1, w2, b2, activation="gelu_tanh"):
    """out = act(x @ w1 + b1) @ w2 + b2 with act in {"gelu_tanh",
    "gelu"}; x [..., K] is flattened to [M, K] inside. Differentiable."""
    if activation not in _ACTS:
        raise ValueError(f"fused_ffn: activation {activation!r} is not one "
                         f"of {sorted(_ACTS)}")
    return _FusedFFN.apply(x, w1, b1, w2, b2, activation)


# ----------------------------------------------------------------- kernels
def kernel_is_supported(m, k, f, dtype) -> bool:
    """What the kernels take: M >= 1 rows, K and F multiples of 128, fp32,
    bf16 or fp16 (every shape ``ffn_is_supported`` passes)."""
    return m >= 1 and k >= 128 and k % 128 == 0 and f >= 128 \
        and f % 128 == 0 and dtype in _DTYPE_CODE


def kernel_path(dtype, k, f) -> str:
    """The design of the three kernels (forward, dx and dW) for inputs of
    ``dtype`` at K = ``k``, F = ``f`` (multiples of 128, as
    ``kernel_is_supported`` asks), the one place the rule is stated:
    ``"tc"`` (wgmma tiles) for bf16 and fp16, ``"fp32_cores"`` for fp32.
    The wrappers pass it to the C entry points, which run that design or
    fail."""
    return "tc" if dtype in (torch.bfloat16, torch.float16) else "fp32_cores"


def _tc_cols(k):
    """The K columns of a tensor-core block (forward, dx, dW): 256 where
    it divides K, else 128 (a warpgroup's m64n128 accumulators, one or
    two)."""
    return 256 if k % 256 == 0 else 128


def _block_cols(k, sizes):
    """The K columns of a kernel block: the largest of ``sizes`` dividing
    K (a multiple of 128, so 128 always does)."""
    return next(c for c in sizes if k % c == 0)


def _check(name, x2, w1, b1, w2, b2=None, g2=None, activation="gelu_tanh"):
    if x2.dim() != 2 or w1.dim() != 2:
        raise ValueError(f"{name}: x must be [M, K] and w1 [K, F], got "
                         f"{tuple(x2.shape)} and {tuple(w1.shape)}")
    m, k = x2.shape
    f = w1.shape[1]
    want = {"w1": (k, f), "b1": (f,), "w2": (f, k), "b2": (k,),
            "g": (m, k)}
    named = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "g": g2}
    for arg, t in named.items():
        if t is None:
            continue
        if tuple(t.shape) != want[arg] or t.dtype != x2.dtype \
                or t.device != x2.device:
            raise ValueError(
                f"{name}: {arg} must be {want[arg]} {x2.dtype} on "
                f"{x2.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not kernel_is_supported(m, k, f, x2.dtype):
        raise ValueError(f"{name}: unsupported x {tuple(x2.shape)} "
                         f"{x2.dtype}, F={f} (see kernel_is_supported)")
    if activation not in _ACT_CODE:
        raise ValueError(f"{name}: activation {activation!r} is not one of "
                         f"{sorted(_ACT_CODE)}")
    return m, k, f


def _launch(name, tensors, ints, activation, dtype, path):
    """Launch kernel ``name`` on the current stream of the tensors' card:
    the pointers of ``tensors`` (each contiguous), the int arguments, the
    activation and dtype codes, and the design ``path``
    (``kernel_path``'s). Raises on an unknown path and on a refused
    launch (a misaligned pointer among them: no fallback)."""
    if path not in _PATH_CODE:
        raise ValueError(f"{name}: unknown kernel path {path!r}, not one of "
                         f"{sorted(_PATH_CODE)}")
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for i, t in enumerate(tensors):
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} must be contiguous")
    rc = _build.load(name)(*(t.data_ptr() for t in tensors), *ints,
                           _ACT_CODE[activation], _DTYPE_CODE[dtype],
                           _PATH_CODE[path],
                           torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{name}: kernel launch failed with CUDA error {rc} ("
            + ", ".join(f"{tuple(t.shape)} {t.dtype}" for t in tensors)
            + f"; {path})")
    LAUNCHES[name] += 1
    PATH_LAUNCHES[path] += 1


def fused_ffn_fwd(x2, w1, b1, w2, b2, activation="gelu_tanh"):
    """x2 [M, K], w1 [K, F], b1 [F], w2 [F, K], b2 [K] of one dtype ->
    act(x2 @ w1 + b1) @ w2 + b2 [M, K] in that dtype. The tensor-core
    kernel may walk F in several ranges (``_fwd_splits_tc``, from the
    card's cluster slots); their fp32 partials (b2 in the first) are
    summed here in a fixed order and rounded once."""
    m, k, f = _check("fused_ffn_fwd", x2, w1, b1, w2, b2,
                     activation=activation)
    if x2.device.type == "cpu":
        return fused_ffn_fwd_reference(x2, w1, b1, w2, b2, activation)
    path = kernel_path(x2.dtype, k, f)
    if path == "tc":
        bn = _tc_cols(k)
        splits = _fwd_splits_tc(m, k, f, bn, _slots(
            "fused_ffn_fwd", x2.device.index, k, bn, x2.dtype))
    else:
        bn, splits = _block_cols(k, (768, 512, 384, 256, 128)), 1
    if splits == 1:
        out = torch.empty_like(x2)
    else:  # fp32 partials over the F ranges, summed in a fixed order
        out = torch.empty((splits, m, k), dtype=torch.float32,
                          device=x2.device)
    _launch("fused_ffn_fwd", [x2, w1, b1, w2, b2, out],
            (m, k, f, bn, splits), activation, x2.dtype, path)
    return out if splits == 1 else out.sum(0).to(x2.dtype)


def fused_ffn_bwd_dx(x2, g2, w1, b1, w2, activation="gelu_tanh"):
    """dx [M, K] of ``fused_ffn_fwd`` from its inputs and the output
    gradient g2 [M, K], in x2's dtype. The tensor-core kernel may walk F
    in several ranges (``_dx_splits_tc``, from the card's cluster slots);
    their fp32 partials are summed here in a fixed order, and dx is
    rounded once from that sum."""
    m, k, f = _check("fused_ffn_bwd_dx", x2, w1, b1, w2, g2=g2,
                     activation=activation)
    if x2.device.type == "cpu":
        return fused_ffn_bwd_dx_reference(x2, g2, w1, b1, w2, activation)
    path = kernel_path(x2.dtype, k, f)
    if path == "tc":
        bn = _tc_cols(k)
        splits = _dx_splits_tc(m, k, f, bn, _slots(
            "fused_ffn_bwd_dx", x2.device.index, k, bn, x2.dtype))
    else:
        bn, splits = _block_cols(k, (768, 512, 384, 256, 128)), 1
    if splits == 1:
        dx = torch.empty_like(x2)
    else:  # fp32 partials over the F ranges, summed in a fixed order
        dx = torch.empty((splits, m, k), dtype=torch.float32,
                         device=x2.device)
    _launch("fused_ffn_bwd_dx", [x2, g2, w1, b1, w2, dx],
            (m, k, f, bn, splits), activation, x2.dtype, path)
    return dx if splits == 1 else dx.sum(0).to(x2.dtype)


def _fill_splits(clusters, most, slots):
    """Of 1 .. most ranges, each range's work a cluster each of
    ``clusters``: the fewest whose clusters fill at least _TC_FILL of the
    ``slots`` clusters the card holds at once, in whole waves; if none
    does, the count that fills them best."""
    slots = max(1, slots)

    def fill(s):
        return clusters * s / (-(-clusters * s // slots) * slots)
    counts = range(1, max(1, most) + 1)
    return next((s for s in counts if fill(s) >= _TC_FILL),
                max(counts, key=lambda s: (fill(s), -s)))


def _clusters_per_tile(k, bn):
    """Clusters along K of a tensor-core backward kernel: its K / bn
    blocks in clusters of the largest divisor up to four (the kernels'
    rule)."""
    nblk = k // bn
    return nblk // next(c for c in (4, 3, 2, 1) if nblk % c == 0)


def _fwd_splits_tc(m, k, f, bn, slots):
    """F ranges of the tensor-core forward, a cluster being one 128-row
    block's columns: one where the clusters fill a wave of the card's
    ``slots`` (at GPT-2's training shape summing three ranges' partials
    cost more than the 1.64-wave tail they fill), else _fill_splits'
    count, at most one range per two 64-column sub-tiles."""
    clusters = -(-m // _DX_TC_ROWS) * _clusters_per_tile(k, bn)
    if clusters >= slots:
        return 1
    return _fill_splits(clusters,
                        min(_DX_TC_MAX_SPLITS, f // _FWD_TC_MIN_F), slots)


def _dx_splits_tc(m, k, f, bn, slots):
    """F ranges of the tensor-core dx kernel (_fill_splits), a cluster
    being one 128-row block's columns."""
    return _fill_splits(-(-m // _DX_TC_ROWS) * _clusters_per_tile(k, bn),
                        min(_DX_TC_MAX_SPLITS, f // 64), slots)


@functools.lru_cache(maxsize=None)
def _slots(name, index, k, bn, dtype):
    """Clusters of tensor-core kernel ``name`` (fused_ffn_fwd, _bwd_dx or
    _bwd_dw) the card holds at once: the occupancy API, through its
    library."""
    with torch.cuda.device(index):
        n = _build.load(name + "_slots")(k, bn, _DTYPE_CODE[dtype])
    if n < 1:
        raise RuntimeError(f"{name}: no cluster fits the card (occupancy "
                           f"query returned {n})")
    return n


def _dw_splits(m, k, f, bn):
    """Row ranges of the fp32-core dW kernel: enough blocks for about four
    waves, at most one range per 64 rows."""
    base = (f // _DW_BF) * (k // bn)
    return max(1, min(-(-m // _DW_ROWS), -(-_DW_TARGET_BLOCKS // base)))


def _dw_splits_tc(m, k, f, bn, slots):
    """Row ranges of the tensor-core dW kernel (_fill_splits), a cluster
    being one 64-row F tile's columns, at most one range per 64-row
    step."""
    return _fill_splits((f // _DW_TC_TILE) * _clusters_per_tile(k, bn),
                        min(_DW_TC_MAX_SPLITS, -(-m // _DW_TC_TILE)), slots)


def fused_ffn_bwd_dw(x2, g2, w1, b1, w2, activation="gelu_tanh"):
    """(dW1 [K, F] in w1's dtype, dW2 [F, K] in w2's dtype, db1 [F] fp32)
    of ``fused_ffn_fwd`` from its inputs and the output gradient g2. The
    kernel writes fp32 partials over row ranges (``_dw_splits_tc`` or
    ``_dw_splits``), summed here in a fixed order."""
    m, k, f = _check("fused_ffn_bwd_dw", x2, w1, b1, w2, g2=g2,
                     activation=activation)
    if x2.device.type == "cpu":
        return fused_ffn_bwd_dw_reference(x2, g2, w1, b1, w2, activation)
    path = kernel_path(x2.dtype, k, f)
    if path == "tc":
        bn = _tc_cols(k)
        splits = _dw_splits_tc(m, k, f, bn, _slots(
            "fused_ffn_bwd_dw", x2.device.index, k, bn, x2.dtype))
    else:
        bn = _block_cols(k, (512, 384, 256, 128))
        splits = _dw_splits(m, k, f, bn)
    f32 = dict(dtype=torch.float32, device=x2.device)
    dw1p = torch.empty((splits, k, f), **f32)
    dw2p = torch.empty((splits, f, k), **f32)
    db1p = torch.empty((splits, f), **f32)
    _launch("fused_ffn_bwd_dw", [x2, g2, w1, b1, w2, dw1p, dw2p, db1p],
            (m, k, f, bn, splits), activation, x2.dtype, path)
    # the S partial sums, summed in a fixed order
    return (dw1p.sum(0).to(w1.dtype), dw2p.sum(0).to(w2.dtype),
            db1p.sum(0))


def fused_ffn_fwd_reference(x2, w1, b1, w2, b2, activation="gelu_tanh"):
    """The plain version of ``fused_ffn_fwd``, the TPU kernel's
    arithmetic: fp32 products, act in fp32 rounded to x's dtype, one
    rounding of the output."""
    pre = x2.float() @ w1.float() + b1.float()
    t = _ACTS[activation](pre).to(x2.dtype).float()
    return (t @ w2.float() + b2.float()).to(x2.dtype)


def _recompute(x2, g2, w1, b1, w2, activation):
    """pre and dt [M, F] in fp32, as both backward kernels recompute them."""
    pre = x2.float() @ w1.float() + b1.float()
    return pre, g2.float() @ w2.float().t()


def fused_ffn_bwd_dx_reference(x2, g2, w1, b1, w2, activation="gelu_tanh"):
    """The plain version of ``fused_ffn_bwd_dx``: dpre = dt * act'(pre)
    rounded to x's dtype, dx = dpre @ w1^T summed in fp32."""
    pre, dt = _recompute(x2, g2, w1, b1, w2, activation)
    dpre = (dt * _dgelu(pre, activation)).to(x2.dtype).float()
    return (dpre @ w1.float().t()).to(x2.dtype)


def fused_ffn_bwd_dw_reference(x2, g2, w1, b1, w2, activation="gelu_tanh"):
    """The plain version of ``fused_ffn_bwd_dw``: dW1 = x^T dpre, dW2 =
    t^T g with t and dpre rounded to x's dtype, db1 the fp32 sum of the
    unrounded dpre."""
    pre, dt = _recompute(x2, g2, w1, b1, w2, activation)
    t = _ACTS[activation](pre).to(x2.dtype).float()
    dpre32 = dt * _dgelu(pre, activation)
    dpre = dpre32.to(x2.dtype).float()
    return ((x2.float().t() @ dpre).to(w1.dtype),
            (t.t() @ g2.float()).to(w2.dtype), dpre32.sum(0))
