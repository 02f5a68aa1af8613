"""FusedDecoder: the step cores of the serving path and one-shot
generation.

Counterpart of ``paddle_tpu/inference/generation.py::FusedDecoder`` and
``generate_fused`` but for the mesh: the ``_stacked`` weight layout (qkv
fused head-major), the two KV layouts (``init_paged_cache``, the block pool
the engine defaults to, and ``init_cache``, the dense ring [L, 2, B, H,
Smax, D] of ``generate`` and ``ServingEngine(paged=False)``), the
per-layer step pieces (``ln``, ``qkv_of``, ``proj_ffn_tail``,
``kv_write``, ``attend``, ``write_attend``, ``layer_step``), the four
hidden cores (``hidden`` for one token per row, ``spec_hidden`` for a
[B, C] block, ``flat_hidden`` for the flat budget's ragged [T] stream,
``bulk_hidden`` for a whole prompt), the dispatches the serving engine
builds from them (``_build_budget_core``, ``_build_flat_budget_core``,
each with a chain mode for draft acceptance, the speculative verify core
``_build_verify_core`` and the trailing decode scan ``_make_budget_tail``),
and ``generate`` (greedy, sampled, beam search, speculative with
``spec_k``; prefilled a position at a time or, with ``bulk_prefill``, in
one flash pass; with a ``PrefixCache`` from its adopted chain).

Sampling is JAX's, draw for draw: ``_filter_logits`` (temperature,
top-k, top-p), ``_sample_next`` (one key over the whole [B, V], as
``generate`` draws) and ``_sample_rows`` (a fold_in(PRNGKey(seed), nt)
key a row, as the engine draws) over ``core.rng``'s threefry keys and
gumbel noise; ``_penalize`` and ``_penalize_slots`` apply the
repetition penalty and min_length. Rotary embeddings (``use_rotary``)
rotate q and k at each token's absolute position in every hidden core;
the FFN takes any of ``ACTIVATIONS``.

The step pieces take the caches as a dict: ``{"kv"(, "sc")}`` is a dense
ring (int8 with fp32 scales [L, 2, B, H, 1, Smax] under
``kv_quant="int8"``), and the paged pool's dict also carries the
dispatch's block tables as ``"tbl"``.

Where JAX traced a pure function, the port runs eagerly: the layer loop
is a Python loop, and the KV cache is updated IN PLACE (a write through
the block table, or at a ring position, lands in ``caches["kv"]``
directly, where JAX returned a new array). Attention goes through the
wrappers of ``ops`` — the CUDA kernels on the card, their plain versions
on the CPU: ``decode_attention.decode_attention_paged`` and
``decode_attention_stacked`` (decode rows and budget blocks over the pool
and the ring), ``decode_attention.decode_attention_paged_flat`` (the flat
stream's segments over the pool; over a ring they stay torch ops, as
JAX's are XLA ops), ``flash_attention.flash_attention`` (bulk prefill)
and, with ``cache_write_kernel=True`` (JAX:
``PADDLE_TPU_KERNEL_CACHE_WRITE=1``), ``decode_attention_stacked_write``
for a ring's one-token steps. Each is looked up on its module at call
time.

Quantized serving: ``weight_quant="int8"|"int4"`` quantizes the stacked
layer weights per (layer, out-channel) with the module-level absmax
recipes (``_absmax_int8``, ``_absmax_int4``, ``_pack_int4``), bit-equal
to JAX's; ``mm_p`` applies int8 weights as a matmul on the integer
values with the scale after it, and int4 weights (packed two nibbles a
byte along the contracted axis) through ``ops.fused_dequant_matmul``.
``kv_quant="int8"`` gives the pool and the ring an int8 flavor with fp32
scales per (layer, kv, block or row, head, position); every write
quantizes its new rows with ``_absmax_int8`` and the reads take
``decode_attention.decode_attention_paged_i8``,
``decode_attention_paged_flat_i8`` and ``decode_attention_stacked_i8``
(``decode_attention_stacked_i8_write`` quantizes in the kernel). The LM
head stays fp unless ``head_quant="int8"``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import rng as _rng
from ..device import resolve_device
from ..ops import decode_attention as _attn
from ..ops import flash_attention as _fa
from ..nn.layer.common import Linear
from ..ops import fused_dequant_matmul as _fdm

__all__ = ["FusedDecoder", "generate_fused", "dispatch_kind",
           "DISPATCH_KINDS"]

NEG_INF = -1e30

# ---- dispatch-kind vocabulary (serving telemetry) ---------------------
# The step timeline labels every serving dispatch with one canonical
# kind, keyed by the dispatch family (JAX's jit-cache key head), so the
# two packages' timelines read alike.
DISPATCH_KINDS = {
    "bulk_admit": "prefill",      # one-row causal-flash prompt pass
    "prefill": "prefill",         # masked chunked prefill scan
    "admit_sample": "admit",      # first-token sample on prefill hiddens
    "decode": "decode",           # the decode-chunk scan
    "verify": "verify",           # the K+1-position spec-verify block
    "budget": "budget",           # the [B, C] token-budget core
    "flat_budget": "budget",      # the token-flattened [T] budget core
}


def dispatch_kind(jit_key):
    """Canonical telemetry kind for a dispatch key (a tuple whose head
    names the dispatch family; shape parameters follow). Unknown
    families pass through as their own name."""
    return DISPATCH_KINDS.get(jit_key[0], str(jit_key[0]))


def _absmax_int8(w, axis, qmax=127):
    """Per-slice absmax int8 quantization, the one recipe of every
    quantized site (weight stacks and K/V writes): scales = absmax / qmax
    over ``axis`` in fp32 (kept as a size-1 axis), values = round-half-
    to-even of w / max(scale, 1e-8) clipped to [-qmax, qmax]. Returns
    (int8 tensor, fp32 scales)."""
    a = w.float()
    # divide by a tensor on a's device: CUDA turns a division by a host
    # scalar into a multiplication by its reciprocal, which can round the
    # last bit differently from JAX's (and the kernels') true division
    s = a.abs().amax(dim=axis, keepdim=True) / torch.full(
        (), qmax, dtype=torch.float32, device=a.device)
    q = torch.round(a / s.clamp(min=1e-8)).clamp(-qmax, qmax)
    return q.to(torch.int8), s


def _absmax_int4(w, axis):
    """``_absmax_int8`` at 4 bits (scales absmax / 7, values in [-7, 7]),
    held in int8 until ``_pack_int4``."""
    return _absmax_int8(w, axis, qmax=7)


def _pack_int4(q, axis):
    """Pack adjacent pairs of int4-valued int8 entries along ``axis`` (of
    even length) into one byte each: the low nibble holds the even
    index, the high nibble the odd one. Returns a contiguous int8 tensor
    with ``axis`` halved."""
    axis = axis % q.dim()
    if q.shape[axis] % 2:
        raise ValueError(
            f"_pack_int4: axis {axis} has odd length {q.shape[axis]} — "
            "int4 packing pairs adjacent contracted elements")
    lead = (slice(None),) * axis
    lo = q[lead + (slice(0, None, 2),)]
    hi = q[lead + (slice(1, None, 2),)]
    return ((lo & 0x0F) | (hi << 4)).to(torch.int8).contiguous()


def _scalar(v, like):
    """``v`` as a 0-d tensor of ``like``'s dtype on its device: JAX turns
    a Python scalar into a weak-typed constant of the array's dtype. The
    value passes through fp32, so -1e30 becomes fp16's -inf (JAX's)
    instead of an overflow error."""
    return torch.full((), v, dtype=torch.float32,
                      device=like.device).to(like.dtype)


def _div_const(x, v):
    """x / v for a constant v (a Python scalar baked into the program, as
    the temperature and generate's repetition penalty are), as XLA
    compiles it: x times the reciprocal of v, taken in x's dtype, or in
    fp32 for bf16, which XLA computes in fp32."""
    if x.dtype == torch.bfloat16:
        r = torch.ones((), device=x.device) / _scalar(v, x).float()
        return (x.float() * r).to(x.dtype)
    return x * (torch.ones((), dtype=x.dtype, device=x.device)
                / _scalar(v, x))


def _blocked_cumsum(p, base=16):
    """Cumulative sum over the last axis of p [B, V] in p's dtype, in the
    order XLA gives JAX's ``cumsum`` on the CPU: each block of ``base``
    summed left to right with every add rounded to the dtype, the blocks'
    totals scanned the same way (recursively), each block's exclusive
    prefix added last. The adds are elementwise, so the card and the CPU
    round alike."""
    b, v = p.shape
    nb = -(-v // base)
    blocks = F.pad(p, (0, nb * base - v)).reshape(b, nb, base)
    acc, within = blocks[:, :, 0], [blocks[:, :, 0]]
    for j in range(1, base):
        acc = acc + blocks[:, :, j]
        within.append(acc)
    within = torch.stack(within, -1)
    if nb == 1:
        return within.reshape(b, -1)[:, :v]
    inc = _blocked_cumsum(within[:, :, -1], base)
    pre = F.pad(inc[:, :-1], (1, 0))
    return (pre[:, :, None] + within).reshape(b, -1)[:, :v]


def _filter_logits(logits, do_sample, top_k, top_p, temperature):
    """Temperature, then top-k (every logit below the k-th largest masked
    to -1e30, ties kept), then top-p (every logit below the one at which
    the sorted softmax's cumulative sum first reaches top_p), each in the
    logits' dtype as JAX's ``_filter_logits``."""
    if not do_sample:
        return logits
    logits = _div_const(logits, max(temperature, 1e-6))
    neg = _scalar(NEG_INF, logits)
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, neg, logits)
    if top_p and top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        # jax.nn.softmax op by op in the dtype; its sum upcasts to fp32.
        # For bf16, XLA's excess precision hands the sum the fp32
        # exponentials of the bf16 difference, never rounded to bf16; the
        # numerator is the rounded one. fp16 keeps no excess precision.
        d = srt - srt[:, :1]
        e = torch.exp(d)
        summed = torch.exp(d.float()) if d.dtype == torch.bfloat16 \
            else e.float()
        probs = e / summed.sum(-1, keepdim=True).to(e.dtype)
        cut = (_blocked_cumsum(probs) < _scalar(top_p, probs)).sum(
            -1, keepdim=True)
        kth = srt.gather(-1, cut.clamp(max=srt.shape[-1] - 1))
        logits = torch.where(logits < kth, neg, logits)
    return logits


def _penalize(logits, presence, repetition_penalty, nt, min_length, eos):
    """``generate``'s logit controls: repetition_penalty divides positive
    and multiplies negative logits of every token in ``presence`` [B, V]
    (the context so far), and min_length masks the eos column while
    fewer than min_length tokens (``nt``) were generated."""
    if repetition_penalty != 1.0 and presence is not None:
        pen = _scalar(repetition_penalty, logits)
        logits = torch.where(
            presence, torch.where(logits > 0, _div_const(
                logits, repetition_penalty), logits * pen), logits)
    if min_length and eos is not None and nt < min_length:
        logits = logits.clone()
        logits[:, eos] = _scalar(NEG_INF, logits)
    return logits


def _host_seed(key):
    """A key's last word masked to 31 bits: the seed of a host-side draw
    (a request's sampling seed in the serving engine)."""
    return int(key.reshape(-1)[-1]) & 0x7FFFFFFF


def _presence_from(ids, vocab):
    """[B, V] bool: which tokens each row of ids [B, S] holds."""
    p = torch.zeros((ids.shape[0], vocab), dtype=torch.bool,
                    device=ids.device)
    return p.scatter_(1, ids.long(), True)


def _sample_next(logits, do_sample, top_k, top_p, temperature, key=None):
    """logits [B, V] -> [B] token ids: argmax, or one categorical draw
    under ``key`` (default ``next_key()``) whose counters run over the
    whole [B, V]."""
    if not do_sample:
        return logits.argmax(-1)
    logits = _filter_logits(logits, do_sample, top_k, top_p, temperature)
    return _rng.categorical(key if key is not None else _rng.next_key(),
                            logits)


def _sample_rows(logits, do_sample, top_k, top_p, temperature, seeds, nt):
    """The serving engine's per-row draw: row b samples from
    fold_in(PRNGKey(seeds[b]), nt[b]) over its own [V], so a request's
    nt-th token depends on its seed and nt only, whatever dispatch or
    slot produced it. logits [B, V]; seeds, nt [B] -> [B] token ids."""
    if not do_sample:
        return logits.argmax(-1)
    logits = _filter_logits(logits, do_sample, top_k, top_p, temperature)
    keys = _rng.fold_in(_rng.prng_key(seeds, device=logits.device), nt)
    return _rng.categorical(keys, logits)


def _position_controls(logits, seen, pen, nt_eff, min_len, eos_ids):
    """Logit controls at each position (..., V), the position counted as
    its row's nt_eff-th generated token: with ``seen`` (the tokens in its
    context; None: off) the repetition penalty divides positive and
    multiplies negative logits by ``pen`` (fp32: the logits promote, as
    JAX's do), then min_length suppresses the eos column while nt_eff <
    min_len (eos_ids < 0: no eos). ``pen``, ``min_len`` and ``eos_ids``
    broadcast against nt_eff."""
    if seen is not None:
        logits = torch.where(seen, torch.where(
            logits > 0, logits / pen, logits * pen), logits)
    cols = torch.arange(logits.shape[-1], device=logits.device)
    suppress = (cols == eos_ids[..., None]) & (nt_eff < min_len)[..., None]
    return torch.where(suppress, _scalar(NEG_INF, logits), logits)


def _penalize_slots(logits, presence, rep_pen, nt, min_len, eos_ids):
    """The engine's per-slot logit controls (``_position_controls`` at
    one position a row): presence [B, V] (None: off), rep_pen, nt,
    min_len and eos_ids [B]."""
    return _position_controls(
        logits, presence, None if presence is None else rep_pen[:, None],
        nt, min_len, eos_ids)


# the elementwise activations of jax.nn the FFN may name
# (``fmt.activation``; JAX applies ``getattr(jax.nn, act)``), at jax.nn's
# defaults: the tanh gelu, leaky_relu's slope 0.01, elu's alpha 1
ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu, "relu6": F.relu6, "silu": F.silu, "swish": F.silu,
    "sigmoid": torch.sigmoid, "tanh": torch.tanh, "elu": F.elu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
}


class FusedDecoder:
    """Decode around a FusedMultiTransformer, an embedding and an LM head
    (moved to ``device``, default ``cuda``), over the paged pool or the
    dense ring. ``use_rotary`` applies rotary embeddings (base
    ``rope_base``, which JAX fixes at 10000) to q and k at every token's
    absolute position. The port's own keyword-only options stand for the
    JAX package's environment knobs: ``cache_write_kernel=True``
    (``PADDLE_TPU_KERNEL_CACHE_WRITE=1``): a ring's one-token steps land
    their K/V inside the fused write+attend kernels instead of a write
    followed by the read kernel; ``head_quant="int8"``
    (``PADDLE_TPU_DECODE_INT8_HEAD=1``): a Linear LM head runs on int8
    weights with per-vocab-column fp32 scales; ``bulk_prefill=True``
    (``PADDLE_TPU_BULK_PREFILL=1``): ``generate`` prefills the whole
    prompt in one causal flash pass. The arguments before them are JAX's,
    in JAX's order."""

    def __init__(self, fmt, embed, head, max_seq_len, use_rotary=False,
                 rope_base=10000.0, weight_quant=None, kv_quant=None, *,
                 cache_write_kernel=False, head_quant=None,
                 bulk_prefill=False, device=None):
        if use_rotary and float(rope_base) != 10000.0:
            raise NotImplementedError(
                "FusedDecoder prefill uses the fused stack's default rotary "
                "base (10000); plumb rotary_emb_base through "
                "fused_multi_transformer before changing it")
        if head_quant not in (None, "none", "int8"):
            raise ValueError(
                f"head_quant={head_quant!r}: expected 'none' or 'int8'")
        if weight_quant not in (None, "none", "int8", "int4"):
            raise ValueError(
                f"weight_quant={weight_quant!r}: expected 'none', "
                "'int8' or 'int4'")
        if kv_quant not in (None, "none", "int8"):
            raise ValueError(
                f"kv_quant={kv_quant!r}: expected 'none' or 'int8' — "
                "the KV pool has no int4 flavor (per-row absmax at 4 "
                "bits clips decode tails; weights are where int4 pays)")
        if fmt.activation not in ACTIVATIONS:
            # the error JAX's getattr(jax.nn, act) raises
            raise AttributeError(
                f"activation {fmt.activation!r}: not one of jax.nn's "
                f"elementwise activations {sorted(ACTIVATIONS)}")
        self.act = ACTIVATIONS[fmt.activation]
        self.device = resolve_device(device)
        self.fmt = fmt.to(self.device)
        self.embed = embed.to(self.device)
        self.head = head.to(self.device)
        # the JAX ring rounds capacity up to a 128-multiple; the port keeps
        # the same Smax so block tables have the same width
        self.smax = -(-int(max_seq_len) // 128) * 128
        self.use_rotary = bool(use_rotary)
        self.rope_base = rope_base
        self._weight_quant_arg = weight_quant
        self._kv_quant_arg = kv_quant
        self.head_quant = head_quant == "int8"
        self.cache_write_kernel = bool(cache_write_kernel)
        self.bulk_prefill = bool(bulk_prefill)
        self._stk_cache = None
        self._head_cache = None
        if self._weight_quant_mode() == "int4":
            self._validate_int4_dims()

    # ------------------------------------------------------------ weights
    def _weight_quant_mode(self) -> str:
        """The stacked weights' flavor: 'none', 'int8' or 'int4' (from the
        constructor argument only; None means 'none')."""
        return self._weight_quant_arg or "none"

    def _int8_cache(self) -> bool:
        """Whether the KV pool is int8 with fp32 per-position scales."""
        return self._kv_quant_arg == "int8"

    def _validate_int4_dims(self):
        """int4 packs two adjacent contracted-axis elements per byte, so
        every contracted axis of the stacked weights must be even:
        embed_dim (qkv_w, f1_w), num_heads*head_dim (lin_w) and ffn_dim
        (f2_w)."""
        f = self.fmt
        e = int(f.qkv_weights[0].shape[-1])
        ff = int(f.ffn1_weights[0].shape[-1])
        heads = f.num_heads * f.head_dim
        bad = [n for n, v in (("embed_dim", e),
                              ("num_heads*head_dim", heads),
                              ("ffn_dim", ff)) if v % 2]
        if bad:
            raise ValueError(
                "weight_quant='int4' needs even contracted axes to pack "
                f"two nibbles per byte; odd: {', '.join(bad)} "
                f"(embed_dim={e}, num_heads*head_dim={heads}, "
                f"ffn_dim={ff})")

    def _stacked(self):
        """Per-layer weights stacked on a leading [L] axis, with qkv fused
        HEAD-MAJOR: [3, nh, hd, E] per layer becomes [L, nh*3*hd, E] (bias
        [L, nh*3*hd]), which ``qkv_of`` unfuses with a (nh, 3, hd)
        reshape. Under weight_quant the four matrices become int8 (int4:
        packed along the contracted axis) with fp32 scales ``*_w_s`` [L,
        1, O]; the biases and LN parameters stay fp. Cached until a
        parameter is replaced or edited, or the mode changes."""
        f = self.fmt
        mode = self._weight_quant_mode()
        sig = (mode, tuple((id(p), p._version) for p in f.parameters()))
        if self._stk_cache is not None and self._stk_cache[0] == sig:
            return self._stk_cache[1]
        self._stk_cache = None

        def stk(plist):
            return torch.stack([p.detach() for p in plist])
        e = f.qkv_weights[0].shape[-1]
        # the four matrices per layer: qkv fused head-major [nh*3*hd, E]
        # (used as h @ W.T), lin/f1/f2 [I, O] (used as h @ W)
        mats = {"qkv_w": [p.detach().transpose(0, 1).reshape(-1, e)
                          for p in f.qkv_weights],
                "lin_w": f.linear_weights, "f1_w": f.ffn1_weights,
                "f2_w": f.ffn2_weights}
        out = {
            "ln_s": stk(f.ln_scales), "ln_b": stk(f.ln_biases),
            "qkv_b": stk(f.qkv_biases).transpose(1, 2).reshape(
                f.num_layers, -1),
            "lin_b": stk(f.linear_biases),
            "fln_s": stk(f.ffn_ln_scales), "fln_b": stk(f.ffn_ln_biases),
            "f1_b": stk(f.ffn1_biases), "f2_b": stk(f.ffn2_biases),
        }
        if mode == "none":
            out.update((k, stk(ws)) for k, ws in mats.items())
        else:
            recipe = _absmax_int8 if mode == "int8" else _absmax_int4
            for k, ws in mats.items():
                # one layer at a time, so the fp32 temporaries of the
                # recipe never exceed one layer's matrix; the scales
                # become [L, 1, O] and int4 packs the contracted axis
                axis = 1 if k == "qkv_w" else 0
                qs, ss = [], []
                for w in ws:
                    q, sc = recipe(w.detach(), axis)
                    qs.append(_pack_int4(q, axis) if mode == "int4" else q)
                    ss.append(sc.T if axis else sc)
                out[k], out[k + "_s"] = torch.stack(qs), torch.stack(ss)
        self._stk_cache = (sig, out)
        return out

    def init_cache(self, batch, dtype=None):
        """The dense ring [L, 2, batch, H, Smax, D] in the weights' dtype
        (or ``dtype``), zeroed; under kv_quant="int8" the pair (int8 ring,
        fp32 scales [L, 2, batch, H, 1, Smax]), positions on the scales'
        last axis. ``ring_caches`` turns either into the step pieces'
        dict."""
        f = self.fmt
        dtype = dtype or f.qkv_weights[0].dtype
        shape = (f.num_layers, 2, int(batch), f.num_heads, self.smax,
                 f.head_dim)
        if self._int8_cache():
            return (torch.zeros(shape, dtype=torch.int8, device=self.device),
                    torch.zeros(shape[:4] + (1, self.smax),
                                dtype=torch.float32, device=self.device))
        return torch.zeros(shape, dtype=dtype, device=self.device)

    @staticmethod
    def ring_caches(cache):
        """``init_cache``'s ring (or int8 pair) as the caches dict the step
        pieces take: {"kv": ring(, "sc": scales)}; the tensors are shared,
        not copied."""
        if isinstance(cache, tuple):
            return {"kv": cache[0], "sc": cache[1]}
        return {"kv": cache}

    def init_paged_cache(self, pool, dtype=None):
        """The one KV pool {"kv": [L, 2, NB, H, Bt, D]} for a BlockPool;
        under kv_quant="int8" "kv" is int8 and "sc" [L, 2, NB, H, 1, Bt]
        holds its fp32 scales, block for block. The engine adds this
        dispatch's block tables as "tbl"."""
        f = self.fmt
        if pool.smax != self.smax:
            raise ValueError(
                f"BlockPool was sized for max_seq_len={pool.smax} but this "
                f"decoder's capacity is Smax={self.smax}")
        dtype = dtype or f.qkv_weights[0].dtype
        shape = (f.num_layers, 2, pool.num_blocks, f.num_heads,
                 pool.block_tokens, f.head_dim)
        if self._int8_cache():
            return {"kv": torch.zeros(shape, dtype=torch.int8,
                                      device=self.device),
                    "sc": torch.zeros(shape[:4] + (1, pool.block_tokens),
                                      dtype=torch.float32,
                                      device=self.device)}
        return {"kv": torch.zeros(shape, dtype=dtype, device=self.device)}

    # ---------------------------------------------------- step pieces
    def ln(self, x, s, b):
        # fp32 statistics with the population variance, affine in fp32,
        # then back to x's dtype
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        out = (x32 - mu) * torch.rsqrt(var + self.fmt.epsilon)
        return (out * s + b).to(x.dtype)

    @staticmethod
    def mm_p(a, w, s=None):
        """a @ W for a stacked weight of any flavor. int8: the matmul on
        the integer values, then the per-out-channel scale (cast to a's
        dtype, as JAX does). int4 arrives packed — a packed weight's
        contracted axis is half the activation's — and goes through the
        fused dequant-matmul kernel (fp32 accumulation, scale on the
        accumulator). fp: a plain matmul."""
        if s is None:
            return a @ w
        if 2 * w.shape[0] == a.shape[-1]:
            return _fdm.fused_dequant_matmul(a, w, s.reshape(1, -1),
                                             out_dtype=a.dtype)
        return (a @ w.to(a.dtype)) * s.to(a.dtype)

    def qkv_of(self, h, p):
        # [B, T, E] -> q, k, v [B, T, nh, hd] from the head-major fused qkv
        f = self.fmt
        qkv = self.mm_p(h, p["qkv_w"].T, p.get("qkv_w_s")) \
            + p["qkv_b"].to(h.dtype)
        qkv = qkv.reshape(h.shape[0], h.shape[1], f.num_heads, 3,
                          f.head_dim)
        return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]

    def proj_ffn_tail(self, residual, attn_flat, p):
        # out-projection + residual + FFN, pre- or post-LN
        pre_ln = self.fmt.normalize_before
        x = residual + (self.mm_p(attn_flat, p["lin_w"], p.get("lin_w_s"))
                        + p["lin_b"].to(attn_flat.dtype))
        if not pre_ln:
            x = self.ln(x, p["ln_s"], p["ln_b"])
        residual = x
        h = self.ln(x, p["fln_s"], p["fln_b"]) if pre_ln else x
        h = self.mm_p(h, p["f1_w"], p.get("f1_w_s")) + p["f1_b"].to(h.dtype)
        h = self.act(h)
        h = self.mm_p(h, p["f2_w"], p.get("f2_w_s")) + p["f2_b"].to(h.dtype)
        x = residual + h
        if not pre_ln:
            x = self.ln(x, p["fln_s"], p["fln_b"])
        return x

    def _paged_blk_off(self, tbl, tv, nb):
        """Resolve positions tv ([B] or [B, Sq]) through the block table:
        a position past the table (the masked-write position Smax) and an
        unmapped entry both resolve to the sentinel block ``nb``."""
        nblk = tbl.shape[1]
        bt = self.smax // nblk
        ji = tv // bt
        jc = ji.clamp(max=nblk - 1)
        tv2 = tv if tv.dim() == 2 else tv[:, None]
        blk = torch.gather(tbl.long(), 1, jc.reshape(tv2.shape).long())
        blk = blk.reshape(tv.shape)
        return torch.where(ji < nblk, blk, torch.full_like(blk, nb)), tv % bt

    def write_targets(self, caches, tv, slots=None):
        """Where the writes of positions tv ([B] or [B, Sq], or one int
        for every row) land: positions resolving to nowhere are dropped
        here, as JAX's scatter with mode="drop" drops them (a write is
        never clamped into a neighbour). Paged: (block, offset, selector)
        through the table rows ``slots`` index (default: row b of the
        table for row b of tv); a position past the table or an unmapped
        entry drops. Ring: (row, position, selector), row ``slots``
        (default b), a position >= Smax drops; an int t is a slice write
        at t (None: dropped). Computed once per hidden pass; every layer
        reuses it."""
        if "tbl" not in caches:
            if isinstance(tv, int):
                return tv if tv < self.smax else None
            if slots is None:
                slots = torch.arange(tv.shape[0], device=tv.device)
                if tv.dim() == 2:
                    slots = slots[:, None].expand_as(tv)
            keep = (tv < self.smax).nonzero(as_tuple=True)
            return slots[keep].long(), tv[keep].long(), keep
        tbl = caches["tbl"] if slots is None else caches["tbl"][slots]
        nb = caches["kv"].shape[2]
        blk, off = self._paged_blk_off(tbl, tv, nb)
        keep = (blk < nb).nonzero(as_tuple=True)
        return blk[keep], off[keep].long(), keep

    def kv_write(self, caches, l, targets, kv_new):
        """Land the new K/V rows kv_new [2, B, H, Sq, D] of layer l in the
        pool or the ring, in place, at ``write_targets``. An int8 cache
        takes each row quantized (``_absmax_int8`` over D) and its scale,
        at the same targets."""
        if targets is None:
            return
        if "sc" in caches:
            kv_new, sc_new = _absmax_int8(kv_new, -1)
        if isinstance(targets, int):     # a ring's slice write at t
            caches["kv"][l, :, :, :, targets] = kv_new[:, :, :, 0]
            if "sc" in caches:
                caches["sc"][l, :, :, :, 0, targets] = sc_new[:, :, :, 0, 0]
            return
        blk, off, keep = targets

        def rows(a):              # [2, B, H, Sq, ...] -> the kept rows
            a = a.permute(1, 3, 0, 2, *range(4, a.dim()))  # [B, Sq, 2, H, .]
            return (a[:, 0] if len(keep) == 1 else a)[keep]   # tv was [B]
        # [NB, Bt, 2, H, D] of the pool, [B, Smax, 2, H, D] of a ring
        kv_l = caches["kv"][l].permute(1, 3, 0, 2, 4)
        kv_l[blk, off] = rows(kv_new).to(kv_l.dtype)
        if "sc" in caches:
            sc_l = caches["sc"][l, :, :, :, 0].permute(1, 3, 0, 2)
            sc_l[blk, off] = rows(sc_new[..., 0])

    @staticmethod
    def _lens_arg(t, b, device):
        # int32 [B] positions for the kernels: t is [B] or one int
        if isinstance(t, int):
            return torch.full((b,), t, dtype=torch.int32, device=device)
        return t.to(torch.int32).contiguous()

    def attend(self, q, caches, l, t):
        # q: [B, Sq, H, D]; t: [B] base positions (or one int) — query row
        # j attends cache positions <= t + j. Looked up on the module at
        # call time.
        qt = q.transpose(1, 2).contiguous()
        tb = self._lens_arg(t, q.shape[0], q.device)
        kv = caches["kv"]
        if "tbl" not in caches:
            if "sc" in caches:
                o = _attn.decode_attention_stacked_i8(qt, kv, caches["sc"],
                                                      l, tb)
            else:
                o = _attn.decode_attention_stacked(qt, kv, l, tb)
        elif "sc" in caches:
            o = _attn.decode_attention_paged_i8(qt, kv, caches["sc"],
                                                caches["tbl"], l, tb)
        else:
            o = _attn.decode_attention_paged(qt, kv, caches["tbl"], l, tb)
        return o.transpose(1, 2)

    def _fused_write(self, caches, b, dtype):
        """Whether a one-token step over ``caches`` lands its K/V inside
        the fused write+attend kernels: cache_write_kernel on, a ring,
        and a shape they take (JAX's ``kw_on`` and its gate)."""
        if not self.cache_write_kernel or "tbl" in caches:
            return False
        f = self.fmt
        q_shape = (b, 1, f.num_heads, f.head_dim)
        if "sc" in caches:
            return _attn.stacked_i8_write_is_supported(
                q_shape, tuple(caches["kv"].shape), dtype)
        return _attn.stacked_write_is_supported(
            q_shape, tuple(caches["kv"].shape), dtype, caches["kv"].dtype)

    def write_attend(self, q, kv_new, caches, l, t):
        """The fused write+attend of one token per row over a ring: q [B,
        1, H, D], kv_new [2, B, H, 1, D]; row b's K/V land at t[b] inside
        the kernel (int8: quantized there) and q attends the prefix < t[b]
        plus itself."""
        qt = q.transpose(1, 2).contiguous()
        tb = self._lens_arg(t, q.shape[0], q.device)
        if "sc" in caches:
            *_, o = _attn.decode_attention_stacked_i8_write(
                qt, kv_new, caches["kv"], caches["sc"], l, tb)
        else:
            _, o = _attn.decode_attention_stacked_write(
                qt, kv_new, caches["kv"], l, tb)
        return o.transpose(1, 2)

    def rope_tables(self, pos, dtype):
        """Rotary cos and sin [B, Sq, 1, D] in ``dtype`` for absolute
        positions pos [B, Sq] (None without use_rotary): JAX's
        ``rope_block`` tables, inverse frequencies 1 / base^(2i / D) in
        fp32, each angle's sin and cos repeated over the two halves. A
        hidden pass computes them once; every layer reuses them."""
        if not self.use_rotary:
            return None
        hd = self.fmt.head_dim
        f32 = dict(dtype=torch.float32, device=pos.device)
        inv = 1.0 / (torch.full((), self.rope_base, **f32) ** (
            torch.arange(0, hd, 2, **f32) * (1.0 / hd)))
        fr = pos.float()[..., None] * inv                 # [B, Sq, D/2]
        fr = torch.cat([fr, fr], -1)[:, :, None]
        return torch.cos(fr).to(dtype), torch.sin(fr).to(dtype)

    @staticmethod
    def rope(x, tables):
        """x [B, Sq, H, D] rotated by ``rope_tables``' (cos, sin): x cos
        + (-x2, x1) sin, x1 and x2 the halves of D."""
        cos, sin = tables
        x1, x2 = x.chunk(2, -1)
        return x * cos + torch.cat([-x2, x1], -1) * sin

    def layer_step(self, x, p, caches, l, t, targets, rope=None):
        """One layer over [B, Sq] tokens at base positions t: K/V written at
        ``targets`` then attended, or with targets "fused" through
        ``write_attend``; q and k rotated by the tables ``rope``."""
        f = self.fmt
        residual = x
        h = self.ln(x, p["ln_s"], p["ln_b"]) if f.normalize_before else x
        b, kp = h.shape[0], h.shape[1]
        q, k, v = self.qkv_of(h, p)
        if rope is not None:
            q, k = self.rope(q, rope), self.rope(k, rope)
        kv_new = torch.stack([k.transpose(1, 2), v.transpose(1, 2)])
        if isinstance(targets, str):
            attn = self.write_attend(q, kv_new, caches, l, t)
        else:
            self.kv_write(caches, l, targets, kv_new)
            attn = self.attend(q, caches, l, t)
        return self.proj_ffn_tail(
            residual, attn.reshape(b, kp, f.num_heads * f.head_dim), p)

    def _layers(self, stk):
        return [{k: v[i] for k, v in stk.items()}
                for i in range(self.fmt.num_layers)]

    def hidden(self, stk, caches, tok, t, write_mask=None):
        """tok [B], t [B] per-row positions or one int (a ring only) -> x
        [B, 1, E]; every row's K/V is written at its position t (unless it
        resolves to nowhere), or with write_mask [B] only the rows where
        it holds (the others still attend; the masked-scan prefill's
        rows). A masked write never takes the fused write kernels, as in
        JAX."""
        x = self.embed(tok[:, None])
        if write_mask is None and self._fused_write(caches, x.shape[0],
                                                    x.dtype):
            targets = "fused"
        elif write_mask is None:
            targets = self.write_targets(caches, t)
        else:
            tv = self._lens_arg(t, x.shape[0], x.device).long()
            targets = self.write_targets(caches, torch.where(
                write_mask, tv, torch.full_like(tv, self.smax)))
        t = self._lens_arg(t, x.shape[0], x.device)
        rope = self.rope_tables(t[:, None], x.dtype)
        for l, p in enumerate(self._layers(stk)):
            x = self.layer_step(x, p, caches, l, t, targets, rope)
        return x

    def spec_hidden(self, stk, caches, toks, lens, write_mask):
        """toks [B, Sq] at positions lens[b] + j -> x [B, Sq, E]; only the
        positions where write_mask [B, Sq] holds write their K/V."""
        offs = torch.arange(toks.shape[1], device=toks.device)[None, :]
        tv = torch.where(write_mask, lens[:, None] + offs,
                         torch.full_like(toks, self.smax))
        x = self.embed(toks)
        targets = self.write_targets(caches, tv)
        rope = self.rope_tables(lens[:, None] + offs, x.dtype)
        for l, p in enumerate(self._layers(stk)):
            x = self.layer_step(x, p, caches, l, lens, targets, rope)
        return x

    # ------------------------------------------------ flat budget stream
    def flat_targets(self, caches, tslot, tpos, b):
        """``write_targets`` of the flat stream: token i writes its slot
        tslot[i]'s position tpos[i]. Pad tokens carry the slot sentinel
        b and drop, as does a position past the table or an unmapped
        entry (never clamped into block NB - 1) or a position >= Smax of
        a ring."""
        tv = torch.where(tslot < b, tpos, torch.full_like(tpos, self.smax))
        return self.write_targets(caches, tv, slots=tslot.clamp(max=b - 1))

    def flat_write(self, caches, l, targets, kv_new):
        """Land the stream's K/V kv_new [2, 1, H, T, D] of layer l, in
        place: each token is a row of one position."""
        self.kv_write(caches, l, targets,
                      kv_new[:, 0].transpose(1, 2)[:, :, :, None])

    def flat_attend_seg(self, q_s, caches, l, cmeta, b):
        """The segment region's attention: q_s [Ts, H, D] in aligned
        single-slot chunks with cmeta = (cslot, cbase, cn) int32 per
        chunk. Over the pool the flat kernel takes every block size the
        engine makes, so there is no gather fallback on the card. Over a
        ring the segments are torch ops, as JAX's are XLA ops: the plain
        flat attention with the ring read as a pool of one block per slot
        (``ring_table``)."""
        cslot, cbase, cn = cmeta
        slot = cslot.clamp(max=b - 1)
        if "tbl" not in caches:
            tbl = _attn.ring_table(b, q_s.device)
            if "sc" in caches:
                return _attn.decode_attention_paged_flat_i8_reference(
                    q_s, caches["kv"], caches["sc"], tbl, slot, cbase, cn, l)
            return _attn.decode_attention_paged_flat_reference(
                q_s, caches["kv"], tbl, slot, cbase, cn, l)
        if "sc" in caches:
            return _attn.decode_attention_paged_flat_i8(
                q_s.contiguous(), caches["kv"], caches["sc"], caches["tbl"],
                slot, cbase, cn, l)
        return _attn.decode_attention_paged_flat(
            q_s.contiguous(), caches["kv"], caches["tbl"], slot, cbase, cn,
            l)

    def flat_layer_step(self, x, p, caches, l, tpos, targets, cmeta, b,
                        rope=None):
        """One layer over the whole [1, T] stream: dense ops on every
        token, K/V written to (slot, pos), then attention by region —
        tokens [0, b) are the decode region (token i is slot i, through
        decode_attention_paged over all b rows; idle rows' outputs are
        discarded by the caller), the rest go through the flat kernel."""
        f = self.fmt
        nh, hd = f.num_heads, f.head_dim
        residual = x
        h = self.ln(x, p["ln_s"], p["ln_b"]) if f.normalize_before else x
        t_all = h.shape[1]
        q, k, v = self.qkv_of(h, p)                   # [1, T, H, D]
        if rope is not None:
            q, k = self.rope(q, rope), self.rope(k, rope)
        kv_new = torch.stack([k.transpose(1, 2), v.transpose(1, 2)])
        self.flat_write(caches, l, targets, kv_new)
        ad = self.attend(q[0, :b][:, None], caches, l, tpos[:b])
        parts = [ad.reshape(1, b, nh * hd)]
        if t_all > b:
            a_s = self.flat_attend_seg(q[0, b:], caches, l, cmeta, b)
            parts.append(a_s.reshape(1, t_all - b, nh * hd))
        return self.proj_ffn_tail(residual, torch.cat(parts, 1), p)

    def flat_hidden(self, stk, caches, toks, tslot, tpos, cmeta, b):
        """toks/tslot/tpos [T], the flat stream (decode region [0, b) plus
        aligned segments) -> x [1, T, E], every valid token's K/V landed
        at (slot, pos)."""
        x = self.embed(toks[None, :])
        targets = self.flat_targets(caches, tslot, tpos, b)
        rope = self.rope_tables(tpos[None, :], x.dtype)
        for l, p in enumerate(self._layers(stk)):
            x = self.flat_layer_step(x, p, caches, l, tpos, targets, cmeta,
                                     b, rope)
        return x

    # ------------------------------------------------------- bulk prefill
    def bulk_hidden(self, stk, toks):
        """Whole-prompt prefill: toks [B, S] at positions 0..S-1 through
        the layer stack with causal flash attention. Returns (x [B, S, E],
        kv_all [L, 2, B, H, S, D]); writing kv_all into a cache is the
        caller's."""
        f = self.fmt
        x = self.embed(toks)
        pos = torch.arange(toks.shape[1], device=toks.device)[None, :]
        rope = self.rope_tables(pos, x.dtype)
        kvs = []
        for p in self._layers(stk):
            residual = x
            h = self.ln(x, p["ln_s"], p["ln_b"]) if f.normalize_before else x
            bsz, sl = h.shape[:2]
            q, k, v = self.qkv_of(h, p)
            if rope is not None:
                q, k = self.rope(q, rope), self.rope(k, rope)
            o = _fa.flash_attention(q, k, v, causal=True)
            x = self.proj_ffn_tail(
                residual, o.reshape(bsz, sl, f.num_heads * f.head_dim), p)
            kvs.append(torch.stack([k.transpose(1, 2), v.transpose(1, 2)]))
        return x, torch.stack(kvs)

    def _head_int8(self):
        """The Linear head's weight [E, V] as int8 with fp32 scales [1, V]
        (absmax per vocab column, ``_absmax_int8``) and its bias; cached
        until a head parameter is replaced or edited."""
        sig = tuple((id(p), p._version) for p in self.head.parameters())
        if self._head_cache is None or self._head_cache[0] != sig:
            self._head_cache = None
            q, s = _absmax_int8(self.head.weight.detach(), 0)
            b = self.head.bias
            self._head_cache = (sig, (q, s, None if b is None
                                      else b.detach()))
        return self._head_cache[1]

    def head_logits(self, x):
        """The LM head. Under head_quant="int8" a Linear head (JAX's
        ``_maybe_quant_head`` takes no other kind) multiplies by its int8
        weight converted to x's dtype, then the scales; its bias after."""
        if not self.head_quant or not isinstance(self.head, Linear):
            return self.head(x)
        w_q, s, b = self._head_int8()
        out = (x @ w_q.to(x.dtype)) * s.to(x.dtype)
        return out if b is None else out + b.to(out.dtype)

    # ------------------------------------------------- serving dispatches
    # Each dispatch samples with ``_sample_rows`` (argmax unless
    # do_sample) after ``_penalize_slots``; under rep_on the [B, V]
    # presence carry (each slot's prompt and generated tokens) feeds the
    # penalty and takes every emitted token, in place.
    @staticmethod
    def _mark_presence(presence, tok, emitted):
        if presence is not None:
            rows = torch.arange(tok.shape[0], device=tok.device)
            presence[rows, tok] |= emitted

    def _make_budget_tail(self, nscan, rep_on=False, do_sample=False,
                          top_k=0, top_p=1.0, temperature=1.0):
        """The trailing decode scan (also the plain decode chunk): nscan
        steps over all rows. Every row writes its K/V at its lens (sentinel
        rows drop); only active rows advance. Returns run(stk, caches, tok,
        lens, active, nt, max_nt, eos_ids, min_len, rep_pen, presence,
        seeds) -> ((tok, lens, active, nt), (toks [nscan, B], emitted
        [nscan, B])); rep_pen and presence matter only under rep_on, seeds
        only under do_sample."""
        def run(stk, caches, tok, lens, active, nt, max_nt, eos_ids,
                min_len, rep_pen=None, presence=None, seeds=None):
            ys_t, ys_e = [], []
            for _ in range(nscan):
                x = self.hidden(stk, caches, tok, lens)
                lg = self.head_logits(x).reshape(x.shape[0], -1)
                lg = _penalize_slots(lg, presence if rep_on else None,
                                     rep_pen, nt, min_len, eos_ids)
                nxt = _sample_rows(lg, do_sample, top_k, top_p,
                                   temperature, seeds, nt).to(tok.dtype)
                emitted = active
                hit_eos = (eos_ids >= 0) & (nxt == eos_ids)
                step = active.to(nt.dtype)
                nt = nt + step
                lens = lens + step
                active = active & ~hit_eos & (nt < max_nt)
                tok = torch.where(emitted, nxt, tok)
                if rep_on:
                    self._mark_presence(presence, nxt, emitted)
                ys_t.append(nxt)
                ys_e.append(emitted)
            if nscan:
                ys = (torch.stack(ys_t), torch.stack(ys_e))
            else:
                ys = (tok.new_zeros((0, tok.shape[0])),
                      active.new_zeros((0, active.shape[0])))
            return (tok, lens, active, nt), ys
        return run

    @staticmethod
    def _block_seen(toks, valid, presence, vocab):
        """[B, C, V]: the carried presence [B, V] or'ed with the block's
        valid tokens consumed at columns <= j (JAX's cumulative one-hot)."""
        oh = F.one_hot(toks.long(), vocab) * valid[..., None]
        return (oh.cumsum(1) > 0) | presence[:, None, :]

    def _build_verify_core(self, k, rep_on=False, greedy_out=False):
        """The speculative-decoding verify step: K+1 positions a row (its
        input token, then the drafts) through ``spec_hidden`` in one pass,
        writing K/V where ``valid`` = active & (j <= dlen) & (lens + j <
        Smax), then the head at every position with the per-position
        controls (position j as the (nt + j)-th generated token; the
        presence extended by the drafts consumed up to j). Acceptance is
        the host's. Returns verify(stk, caches, toks [B, K+1], lens, dlen,
        active, nt, eos_ids, min_len, rep_pen, presence) -> logits [B,
        K+1, V], or their argmax [B, K+1] under greedy_out."""
        kp = int(k) + 1

        def verify(stk, caches, toks, lens, dlen, active, nt, eos_ids,
                   min_len, rep_pen=None, presence=None):
            offs = torch.arange(kp, device=toks.device)[None, :]
            valid = (active[:, None] & (offs <= dlen[:, None])
                     & (lens[:, None] + offs < self.smax))
            x = self.spec_hidden(stk, caches, toks, lens, valid)
            logits = self.head_logits(x).reshape(x.shape[0], kp, -1)
            seen = (self._block_seen(toks, valid, presence, logits.shape[-1])
                    if rep_on else None)
            logits = _position_controls(
                logits, seen, None if seen is None else rep_pen[:, None, None],
                nt[:, None] + offs, min_len[:, None], eos_ids[:, None])
            return logits.argmax(-1) if greedy_out else logits
        return verify

    def _build_budget_core(self, c, rep_on=False, do_sample=False, top_k=0,
                           top_p=1.0, temperature=1.0, full_logits=False,
                           chain=False, scan_tail=0):
        """The row-layout token-budget step: row b feeds seg[b] tokens of
        toks [B, C] at positions lens[b].. (a decode row its input token
        and any drafts, a prefill row its next prompt chunk). Without
        ``chain`` the last valid column's logits sample the row's next
        token (kept when gen0[b] < seg[b], i.e. the row is generating),
        then ``scan_tail`` trailing decode steps run in the same call:
        budget(stk, caches, toks, lens, seg, gen0, nt, max_nt, eos_ids,
        min_len, rep_pen, presence, seeds) -> (tok0, emit0, ys, tok, lens,
        active, nt), the last three as ``_make_budget_tail``'s. With
        ``chain`` (drafts in the block) it returns every column's argmax
        [B, C] (``full_logits``: the controlled logits [B, C, V]), column
        j controlled as the (nt + max(0, j - gen0))-th generated token,
        for the host's acceptance."""
        c = int(c)
        sample = (do_sample, top_k, top_p, temperature)
        tail = self._make_budget_tail(int(scan_tail), rep_on, *sample)

        def budget(stk, caches, toks, lens, seg, gen0, nt, max_nt, eos_ids,
                   min_len, rep_pen=None, presence=None, seeds=None):
            offs = torch.arange(c, device=toks.device)[None, :]
            valid = (offs < seg[:, None]) & (lens[:, None] + offs < self.smax)
            x = self.spec_hidden(stk, caches, toks, lens, valid)
            if chain:
                logits = self.head_logits(x).reshape(x.shape[0], c, -1)
                seen = (self._block_seen(toks, valid, presence,
                                         logits.shape[-1])
                        if rep_on else None)
                logits = _position_controls(
                    logits, seen,
                    None if seen is None else rep_pen[:, None, None],
                    nt[:, None] + (offs - gen0[:, None]).clamp(min=0),
                    min_len[:, None], eos_ids[:, None])
                return logits if full_logits else logits.argmax(-1)
            last = (seg - 1).clamp(min=0).long()
            xl = x[torch.arange(x.shape[0], device=x.device), last][:, None]
            logits = self.head_logits(xl).reshape(x.shape[0], -1)
            logits = _penalize_slots(logits, presence if rep_on else None,
                                     rep_pen, nt, min_len, eos_ids)
            tok0 = _sample_rows(logits, *sample, seeds, nt).to(toks.dtype)
            emit0 = (seg > 0) & (gen0 < seg)
            hit_eos = (eos_ids >= 0) & (tok0 == eos_ids)
            lens = lens + seg
            nt = nt + emit0.to(nt.dtype)
            active = emit0 & ~hit_eos & (nt < max_nt)
            tok = torch.where(emit0, tok0, toks[:, 0])
            if rep_on:
                self._mark_presence(presence, tok0, emit0)
            (tok, lens, active, nt), ys = tail(
                stk, caches, tok, lens, active, nt, max_nt, eos_ids,
                min_len, rep_pen, presence, seeds)
            return tok0, emit0, ys, tok, lens, active, nt
        return budget

    def _build_flat_budget_core(self, b, rep_on=False, do_sample=False,
                                top_k=0, top_p=1.0, temperature=1.0,
                                full_logits=False, chain=False, scan_tail=0):
        """The token-flattened budget step: one ragged [T] stream (decode
        region [0, b), then segments aligned to FLAT_CHUNK: prefill
        chunks and draft claims). Without ``chain`` each slot's next token
        is sampled from its last valid stream index ``last_idx``, then
        ``scan_tail`` trailing decode steps run; ``emit0`` and ``adv``
        come from the packer. With ``chain`` it returns every token's
        argmax [T] (``full_logits``: the controlled logits [T, V]), token
        i controlled as its slot's (nt + max(0, tcol[i] - gen0))-th
        generated token with the presence extended by its segment's
        tokens (the segment starts at stream index tstart[i]). Returns
        flat_budget(stk, caches, toks, tslot, tpos, cslot, cbase, cn,
        tcol, tstart, gen0, tok_in, last_idx, emit0, adv, lens, nt,
        max_nt, eos_ids, min_len, rep_pen, presence, seeds) -> (tok0,
        emit0, ys, tok, lens, active, nt) as the row core, or the chain."""
        b = int(b)
        sample = (do_sample, top_k, top_p, temperature)
        tail = self._make_budget_tail(int(scan_tail), rep_on, *sample)

        def flat_budget(stk, caches, toks, tslot, tpos, cslot, cbase, cn,
                        tcol, tstart, gen0, tok_in, last_idx, emit0, adv,
                        lens, nt, max_nt, eos_ids, min_len, rep_pen=None,
                        presence=None, seeds=None):
            x = self.flat_hidden(stk, caches, toks, tslot, tpos,
                                 (cslot, cbase, cn), b)
            if chain:
                logits = self.head_logits(x[0])             # [T, V]
                cl = tslot.clamp(max=b - 1).long()
                seen = pen = None
                if rep_on:
                    # segment-local cumulative one-hot: the stream's
                    # cumsum minus its value before each segment's start
                    oh = F.one_hot(toks.long(), logits.shape[-1]) \
                        * (tslot < b)[:, None]
                    cs = oh.cumsum(0)
                    prev = torch.where((tstart > 0)[:, None],
                                       cs[(tstart - 1).clamp(min=0).long()],
                                       torch.zeros_like(cs))
                    seen = ((cs - prev) > 0) | presence[cl]
                    pen = rep_pen[cl][:, None]
                logits = _position_controls(
                    logits, seen, pen,
                    nt[cl] + (tcol - gen0[cl]).clamp(min=0), min_len[cl],
                    eos_ids[cl])
                return logits if full_logits else logits.argmax(-1)
            xl = x[0, last_idx][:, None]
            logits = self.head_logits(xl).reshape(b, -1)
            logits = _penalize_slots(logits, presence if rep_on else None,
                                     rep_pen, nt, min_len, eos_ids)
            tok0 = _sample_rows(logits, *sample, seeds, nt).to(tok_in.dtype)
            hit_eos = (eos_ids >= 0) & (tok0 == eos_ids)
            lens = lens + adv
            nt = nt + emit0.to(nt.dtype)
            active = emit0 & ~hit_eos & (nt < max_nt)
            tok = torch.where(emit0, tok0, tok_in)
            if rep_on:
                self._mark_presence(presence, tok0, emit0)
            (tok, lens, active, nt), ys = tail(
                stk, caches, tok, lens, active, nt, max_nt, eos_ids,
                min_len, rep_pen, presence, seeds)
            return tok0, emit0, ys, tok, lens, active, nt
        return flat_budget

    # ------------------------------------------------- one-shot generation
    def _refuse_combinations(self, num_beams, spec_k, do_sample, pen_on,
                             rep_on):
        """JAX's refusals of option combinations."""
        if spec_k and num_beams > 1:
            raise ValueError(
                "spec_k composes with greedy/sampling generation, not "
                "beam search (a draft has no beam lineage to verify)")
        if num_beams > 1 and do_sample:
            raise ValueError("beam search (num_beams>1) is deterministic; "
                             "do_sample=True is not supported with it")
        if pen_on and num_beams > 1:
            raise NotImplementedError(
                "min_length/repetition_penalty with beam search is not "
                "supported; use greedy/sampling generation")
        if rep_on and not isinstance(self.head, Linear):
            raise NotImplementedError(
                "repetition_penalty needs a Linear LM head (vocab "
                "size must be known for the presence mask)")

    def _prefill(self, stk, toks, pc=None):
        """The prompt toks [B, S] into a fresh ring: one causal flash pass
        with its K/V padded into the ring (bulk_prefill, for S > 1; an
        int8 ring takes them quantized), else one hidden pass a position.
        With a PrefixCache ``pc`` the shortest adoptable chain over the
        rows is copied into every row first (one prefill position serves
        the batch, as in JAX) and prefill starts after it, a position at
        a time (the flash pass cannot attend an adopted prefix); then
        every row's full blocks are published. Returns (caches, the last
        position's hidden state [B, 1, E])."""
        b, prompt = toks.shape
        ids = toks.cpu().numpy()
        pos, chains = 0, None
        if pc is not None and prompt > 1:
            ms = [pc.lookup(ids[r]) for r in range(b)]
            n = min(len(mt) for mt in ms)
            if n:
                chains = [mt[:n] for mt in ms]
                pos = n * pc.block_tokens
        if self.bulk_prefill and prompt > 1 and not pos:
            x_all, kv_all = self.bulk_hidden(stk, toks)
            caches = self.ring_caches(self.init_cache(b))
            if "sc" in caches:
                kv_all, sc = _absmax_int8(kv_all, -1)
                caches["sc"][..., 0, :prompt] = sc[..., 0]
            caches["kv"][:, :, :, :, :prompt] = kv_all.to(caches["kv"].dtype)
            last_x = x_all[:, -1:]
        else:
            caches = self.ring_caches(self.init_cache(b))
            for r, chain in enumerate(chains or ()):
                pc.store.acquire(chain)
                try:
                    pc.adopt(caches, r, chain)
                finally:
                    pc.store.release(chain)
            for t in range(pos, prompt):
                last_x = self.hidden(stk, caches, toks[:, t], t)
        if pc is not None and prompt >= pc.block_tokens:
            for r in range(b):
                pc.publish(caches, r, ids[r])
        return caches, last_x

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=20, eos_token_id=None,
                 do_sample=False, top_k=0, top_p=1.0, temperature=1.0,
                 num_beams=1, length_penalty=1.0, min_length=0,
                 repetition_penalty=1.0, prefix_cache=None, spec_k=0):
        """Generation over a dense ring of B rows: the prompt [B, S] is
        prefilled (``_prefill``; JAX's chunk ladder only groups
        dispatches), the LM head samples the first token from the last
        hidden state, then decode runs in chunks of 8 steps with eos (64
        without), checking between chunks whether every row has finished.
        A finished row emits eos. min_length suppresses eos while fewer
        tokens exist; repetition_penalty penalizes the prompt's and the
        generated tokens (a [B, V] presence carry). do_sample draws the
        first token under ``next_key()`` and each chunk's tokens under
        ``split(next_key(), chunk)``, one key a step over the whole [B,
        V], as JAX does. num_beams > 1 runs beam search over the ring
        (``_generate_beam``). ``prefix_cache`` (a ``PrefixCache``, which a
        dense ServingEngine may share) adopts the rows' shortest published
        chain and publishes their full blocks after prefill. ``spec_k``
        (0 or a power of two) decodes speculatively with the n-gram
        drafter and the verify core (``_generate_spec``). Returns int64
        [B, S + generated] on the CPU: when every row has finished, cut
        after the step where the last row emitted its first eos."""
        from .spec_decode import validate_spec_k
        spec_k = validate_spec_k(spec_k)
        rep_on = repetition_penalty != 1.0
        pen_on = bool(min_length) or rep_on
        self._refuse_combinations(num_beams, spec_k, do_sample, pen_on,
                                  rep_on)
        ids = np.asarray(input_ids.cpu() if torch.is_tensor(input_ids)
                         else input_ids).astype(np.int64)
        if ids.ndim != 2 or ids.shape[1] < 1:
            raise ValueError(f"input_ids must be [B, S >= 1], got "
                             f"{ids.shape}")
        b, prompt = ids.shape
        if prompt + max_new_tokens > self.smax:
            raise ValueError(f"max_seq_len {self.smax} < prompt {prompt} + "
                             f"max_new_tokens {max_new_tokens}")
        stk = self._stacked()
        toks = torch.from_numpy(ids).to(self.device)
        caches, last_x = self._prefill(stk, toks, prefix_cache)
        eos = None if eos_token_id is None else int(eos_token_id)
        if num_beams > 1:
            return self._generate_beam(ids, last_x, caches, stk,
                                       max_new_tokens, eos, int(num_beams),
                                       float(length_penalty))
        presence = (_presence_from(toks, self.head.weight.shape[1])
                    if rep_on else None)
        sample = (do_sample, top_k, top_p, temperature)

        rows = torch.arange(b, device=self.device)

        def next_token(x, nt, key):
            logits = self.head_logits(x).reshape(b, -1)
            if pen_on:
                logits = _penalize(logits, presence, repetition_penalty, nt,
                                   min_length, eos)
            return _sample_next(logits, *sample, key)
        nxt = next_token(last_x, 0, _rng.next_key() if do_sample else None)
        if rep_on:
            presence[rows, nxt] = True
        if spec_k:
            return self._generate_spec(
                ids, caches, stk, nxt, max_new_tokens, eos, sample,
                min_length, repetition_penalty, presence, spec_k)
        parts = [nxt[:, None]]
        finished = (nxt == eos) if eos is not None else None
        remaining = max_new_tokens - 1
        if eos is not None and bool(finished.all()):
            remaining = 0                 # every row ended at prefill
        cap = 8 if eos is not None else 64
        t = prompt
        while remaining > 0:
            chunk = cap
            while chunk > remaining:
                chunk //= 2
            keys = (_rng.split(_rng.next_key(), chunk) if do_sample
                    else [None] * chunk)
            for i in range(chunk):
                nxt = next_token(self.hidden(stk, caches, nxt, t),
                                 t - prompt + 1, keys[i])
                if eos is not None:
                    nxt = torch.where(finished, torch.full_like(nxt, eos),
                                      nxt)
                    finished = finished | (nxt == eos)
                if rep_on:
                    presence[rows, nxt] = True
                parts.append(nxt[:, None])
                t += 1
            remaining -= chunk
            if eos is not None and bool(finished.all()):
                break
        gen = torch.cat(parts, 1).cpu().numpy()
        if eos is not None and bool(finished.all()):
            first_eos = np.argmax(gen == eos, axis=1)   # rows all have one
            gen = gen[:, :int(first_eos.max()) + 1]
        return torch.from_numpy(np.concatenate([ids, gen], axis=1))

    def _generate_spec(self, ids, caches, stk, first, max_new_tokens, eos,
                       sample, min_length, repetition_penalty, presence, k):
        """Speculative decoding after the first token: per row an n-gram
        drafter's proposal (capped at the remaining budget minus one) ->
        one verify pass over K+1 positions -> the host's acceptance
        (greedy exact match, or rejection sampling under a
        ``np.random.RandomState`` seeded from ``next_key()``) -> each row
        advances by its accepted tokens plus the bonus. Rows that finish
        early are padded with eos (0 without) to the longest row."""
        from .spec_decode import (NGramDrafter, filtered_probs,
                                  greedy_accept, rejection_sample,
                                  truncate_emitted)
        do_sample, top_k, top_p, temperature = sample
        b, prompt = ids.shape
        rep_on = repetition_penalty != 1.0
        first = first.cpu().numpy()
        rows = [[int(first[r])] for r in range(b)]
        drafters = []
        for r in range(b):
            d = NGramDrafter(k)
            d.reset(ids[r])
            d.update(rows[r])
            drafters.append(d)
        lens = np.full(b, prompt, np.int64)
        nt = np.ones(b, np.int64)
        finished = (first == eos) if eos is not None else np.zeros(b, bool)
        dev = self.device

        def vec(v, dtype=torch.int64):
            return torch.full((b,), v, dtype=dtype, device=dev)
        eos_vec = vec(-1 if eos is None else eos)
        min_vec = vec(int(min_length))
        rp_vec = vec(float(repetition_penalty), torch.float32)
        vstep = self._build_verify_core(k, rep_on, greedy_out=not do_sample)
        rng = (np.random.RandomState(_host_seed(_rng.next_key()))
               if do_sample else None)
        while True:
            act = ~finished & (nt < max_new_tokens)
            if not act.any():
                break
            drafts = np.zeros((b, k), np.int64)
            dlen = np.zeros(b, np.int64)
            toks = np.zeros((b, k + 1), np.int64)
            for r in range(b):
                toks[r, 0] = rows[r][-1]
                if not act[r]:
                    continue
                d = drafters[r].propose()
                m = min(int(d.size), int(max_new_tokens - nt[r]) - 1)
                if m > 0:
                    drafts[r, :m] = d[:m]
                    dlen[r] = m
            toks[:, 1:] = drafts
            out = vstep(stk, caches, *(torch.from_numpy(a).to(dev) for a in (
                toks, lens, dlen, act, nt)), eos_vec, min_vec, rp_vec,
                presence)
            out = out.float().cpu().numpy() if do_sample else \
                out.cpu().numpy()
            new_rows, new_cols = [], []
            for r in range(b):
                if not act[r]:
                    continue
                m = int(dlen[r])
                if do_sample:
                    probs = filtered_probs(out[r, :m + 1], top_k, top_p,
                                           temperature)
                    kept, _ = rejection_sample(drafts[r, :m], probs, rng)
                else:
                    kept, _ = greedy_accept(drafts[r, :m], out[r, :m + 1])
                emitted, hit_eos = truncate_emitted(
                    kept, int(max_new_tokens - nt[r]), eos)
                nt[r] += len(emitted)
                rows[r].extend(emitted)
                lens[r] += len(emitted)
                finished[r] |= hit_eos
                drafters[r].update(emitted)
                new_rows.extend([r] * len(emitted))
                new_cols.extend(emitted)
            if rep_on and new_rows:
                presence[torch.tensor(new_rows, device=dev),
                         torch.tensor(new_cols, device=dev)] = True
        width = max(len(t) for t in rows)
        out = np.full((b, prompt + width), eos if eos is not None else 0,
                      np.int64)
        out[:, :prompt] = ids
        for r in range(b):
            out[r, prompt:prompt + len(rows[r])] = rows[r]
        return torch.from_numpy(out)

    # ------------------------------------------------- beam over the ring
    # The beams share the prompt's ring rows: prefilled once at batch B,
    # replicated to B*K on the batch axis (row b*K + j is beam j of row
    # b); each step reorders the rows to their winners' parents. The host
    # rebuilds the sequences by backtracking the (token, parent) lineage.
    @staticmethod
    def _log_softmax(logits):
        # jax.nn.log_softmax in fp32: x - max - log(sum(exp(x - max)))
        x = logits.float()
        sh = x - x.max(-1, keepdim=True).values
        return sh - torch.log(torch.exp(sh).sum(-1, keepdim=True))

    @staticmethod
    def _top_k(x, k):
        """lax.top_k over the last axis: the k largest, the lower index
        first among equals (a stable descending sort)."""
        v, i = torch.sort(x, dim=-1, descending=True, stable=True)
        return v[..., :k], i[..., :k]

    def _build_beam_init(self, k, eos, length_penalty):
        """Step 1: the prefill's last hidden state -> logits -> the first
        top-k (scores [0, -1e9, ...] make all k picks come from beam 0).
        Returns init(last_x) -> (tok, beam_idx, fin_score, finished,
        scores, gen_len), each [B, K]."""
        def init(last_x):
            logits = self.head_logits(last_x).reshape(last_x.shape[0], -1)
            b, v = logits.shape
            logp = self._log_softmax(logits)
            scores0 = torch.full((b, k), -1e9, device=logp.device)
            scores0[:, 0] = 0.0
            cand = scores0[..., None] + logp[:, None, :]        # [B, K, V]
            top_scores, top_idx = self._top_k(cand.reshape(b, k * v), k)
            tok = top_idx % v
            gen_len = torch.ones((b, k), dtype=torch.int64,
                                 device=logp.device)
            return (tok, torch.zeros_like(tok),
                    *self._beam_finish(tok, torch.zeros_like(tok, dtype=
                                                             torch.bool),
                                       top_scores, gen_len, eos,
                                       length_penalty),
                    top_scores, gen_len)
        return init

    @staticmethod
    def _beam_finish(tok, finished, scores, gen_len, eos, length_penalty):
        """(fin_score, finished): a beam that emits eos now is admitted to
        the finished pool at its GNMT-normalized score, scores /
        max(gen_len, 1)^length_penalty; -inf for every other beam."""
        if eos is None:
            return torch.full_like(scores, -torch.inf), finished
        newly = ~finished & (tok == eos)
        pen = gen_len.clamp(min=1).float() ** length_penalty
        fin = torch.where(newly, scores / pen,
                          torch.full_like(scores, -torch.inf))
        return fin, finished | newly

    def _build_beam_scan(self, k, eos, length_penalty, split=0):
        """One beam step over the ring at batch B*K: logits -> log-probs
        (a finished beam may only continue with eos, at no cost) -> the
        top K of the K*V candidates of each row, the ring's rows reordered
        to each winner's parent at positions >= split (the prompt's
        positions are the same in every beam). Returns step(stk, caches,
        tok_flat, t, scores, finished, gen_len) -> (tok_flat, scores,
        finished, gen_len, ys), ys the step's (tok, beam_idx, fin_score,
        finished, scores, gen_len)."""
        def step(stk, caches, tok_flat, t, scores, finished, gen_len):
            b, kk = scores.shape
            x = self.hidden(stk, caches, tok_flat, t)
            logp = self._log_softmax(
                self.head_logits(x).reshape(b * kk, -1)).reshape(b, kk, -1)
            v = logp.shape[-1]
            if eos is not None:
                only_eos = torch.full((v,), -torch.inf, device=logp.device)
                only_eos[eos] = 0.0
                logp = torch.where(finished[..., None], only_eos, logp)
            cand = scores[..., None] + logp
            top_scores, top_idx = self._top_k(cand.reshape(b, kk * v), kk)
            beam_idx = top_idx // v
            tok = top_idx % v
            src = (torch.arange(b, device=tok.device)[:, None] * kk
                   + beam_idx).reshape(-1)
            for name in caches:        # ring [..., Smax, D], scales [.., Smax]
                c = caches[name]
                pos = (slice(None),) * (4 if name == "kv" else 5)
                tail = pos + (slice(split, None),)
                c[tail] = c[tail][:, :, src]
            finished = finished.gather(1, beam_idx)
            gen_len = gen_len.gather(1, beam_idx)
            gen_len = torch.where(finished, gen_len, gen_len + 1)
            fin_score, finished = self._beam_finish(
                tok, finished, top_scores, gen_len, eos, length_penalty)
            ys = (tok, beam_idx, fin_score, finished, top_scores, gen_len)
            return tok.reshape(-1), top_scores, finished, gen_len, ys
        return step

    def _generate_beam(self, ids, last_x, caches, stk, max_new_tokens, eos,
                       k, length_penalty):
        """Beam search after the prefill: ``_build_beam_init``, then beam
        steps in chunks (8 with eos, 64 without; the host checks between
        chunks whether every beam finished), then each row's winner: the
        best live beam by normalized score at the first step where every
        beam had finished (else the last), unless a finished beam scored
        higher (eos-padded). JAX's ``_generate_beam`` selection."""
        b, prompt = ids.shape
        ys0 = self._build_beam_init(k, eos, length_penalty)(last_x)
        tok1, _, _, finished, scores, gen_len = ys0
        for name in caches:
            caches[name] = caches[name].repeat_interleave(k, dim=2)
        hist = [ys0]
        tok_flat, t, remaining = tok1.reshape(-1), prompt, max_new_tokens - 1
        cap = 8 if eos is not None else 64
        # the prompt's region [0, split) needs no reorder: a power of two
        # <= prompt, as JAX takes it (0 below 64)
        split = 1 << (prompt.bit_length() - 1) if prompt >= 64 else 0
        step = self._build_beam_scan(k, eos, length_penalty, split)
        while remaining > 0:
            if eos is not None and bool(finished.all()):
                break
            chunk = cap
            while chunk > remaining:
                chunk //= 2
            for _ in range(chunk):
                tok_flat, scores, finished, gen_len, ys = step(
                    stk, caches, tok_flat, t, scores, finished, gen_len)
                hist.append(ys)
                t += 1
            remaining -= chunk
        toks, bidx, fin_sc, fin_fl, sc_h, gl_h = (
            torch.stack([h[i] for h in hist]).cpu().numpy()
            for i in range(6))
        n_steps = toks.shape[0]
        all_fin = fin_fl.all(axis=(1, 2))
        t_stop = int(np.argmax(all_fin)) if all_fin.any() else n_steps - 1

        def backtrack(t, row, beam):
            seq = np.empty(t + 1, np.int64)
            cur = beam
            for s in range(t, -1, -1):
                seq[s] = toks[s, row, cur]
                cur = bidx[s, row, cur]
            return seq

        norm = (sc_h[t_stop]
                / np.maximum(gl_h[t_stop], 1).astype(np.float32)
                ** length_penalty)
        out = np.empty((b, prompt + t_stop + 1), np.int64)
        out[:, :prompt] = ids
        for row in range(b):
            best = int(np.argmax(norm[row]))
            seq = backtrack(t_stop, row, best)
            if eos is not None:
                pool = fin_sc[:t_stop + 1, row]            # [T', K]
                if pool.max() > norm[row, best]:
                    t_f, k_f = np.unravel_index(int(np.argmax(pool)),
                                                pool.shape)
                    fin = backtrack(t_f, row, k_f)
                    seq = np.concatenate(
                        [fin, np.full(t_stop - t_f, eos, np.int64)])
            out[row, prompt:] = seq
        return torch.from_numpy(out)


def generate_fused(fmt, input_ids, embed, head, max_new_tokens=20,
                   max_seq_len=None, eos_token_id=None, do_sample=False,
                   top_k=0, top_p=1.0, temperature=1.0, use_rotary=False,
                   num_beams=1, length_penalty=1.0, min_length=0,
                   repetition_penalty=1.0, prefix_cache=None, spec_k=0, *,
                   weight_quant=None, kv_quant=None, cache_write_kernel=False,
                   head_quant=None, bulk_prefill=False, device=None):
    """One-shot generation over FusedDecoder: a decoder whose ring holds
    ``max_seq_len`` positions (default prompt + max_new_tokens), then
    ``generate``. The keyword-only options stand for the JAX package's
    environment knobs (PADDLE_TPU_DECODE_INT8_CACHE,
    ..._INT8_WEIGHTS / ..._INT4_WEIGHTS, PADDLE_TPU_KERNEL_CACHE_WRITE,
    PADDLE_TPU_DECODE_INT8_HEAD, PADDLE_TPU_BULK_PREFILL)."""
    prompt = np.shape(input_ids.cpu() if torch.is_tensor(input_ids)
                      else input_ids)[1]
    dec = FusedDecoder(fmt, embed, head,
                       max_seq_len or prompt + max_new_tokens,
                       use_rotary=use_rotary, weight_quant=weight_quant,
                       kv_quant=kv_quant,
                       cache_write_kernel=cache_write_kernel,
                       head_quant=head_quant, bulk_prefill=bulk_prefill,
                       device=device)
    return dec.generate(input_ids, max_new_tokens, eos_token_id, do_sample,
                        top_k, top_p, temperature, num_beams=num_beams,
                        length_penalty=length_penalty, min_length=min_length,
                        repetition_penalty=repetition_penalty,
                        prefix_cache=prefix_cache, spec_k=spec_k)
