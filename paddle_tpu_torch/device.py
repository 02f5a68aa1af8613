"""Device resolution and the tolerance table of the port.

Entry points run on the card unless the caller asks for the CPU: a
``device`` of None means ``cuda``, and with no card that raises instead
of falling back. The CPU is for tests, which pass ``device="cpu"``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "TOLERANCES"]

# Tolerances the port is held to, each with its reason. Comparisons of
# the port against the JAX package run fp32 on the CPU; comparisons of a
# kernel against its plain version run on the card in the working dtype.
TOLERANCES = {
    # the same fp32 arithmetic in another summation order (block-wise
    # online softmax vs one dense softmax)
    "attention_fp32": {"atol": 1e-5, "rtol": 1e-5},
    # bf16 output rounding (2^-8 relative) plus p rounded to bf16 against
    # a different running max in the kernel and the plain version
    "attention_bf16": {"atol": 2e-2, "rtol": 2e-2},
    # the row log-sum-exp of the flash and ring chunk kernels in any input
    # dtype, kernel vs plain: fp32 in both, from products of the same
    # inputs (a product of two bf16 or fp16 values is exact in fp32)
    # summed in another order, exp2 in the kernel and exp in the plain one;
    # about 1e-6 on an lse of 8
    "attention_lse": {"atol": 1e-5, "rtol": 1e-5},
    # fp32 logits through two layers of products summed in another order
    "logits_fp32": {"atol": 1e-4, "rtol": 1e-4},
    # gumbel noise -log(-log(u)) from bit-equal uniforms, the port against
    # JAX on the CPU, in ulps of max(|g|, 1): each log is XLA's on one side
    # and PyTorch's on the other, each within an ulp of the exact value,
    # and the inner log's ulp (of a value near 1 where g is near 0) passes
    # through the outer one unscaled
    "gumbel": {"ulps": 2},
    # the int4 dequant-matmul in fp32: exact integer weights, products
    # summed in another order (a [K] dot in two nibble halves on the TPU
    # kernel, one pass here)
    "matmul_fp32": {"atol": 1e-5, "rtol": 1e-5},
    # the same in bf16 or fp16 on the card: one rounding of the output
    # (2^-8 relative) on either side of a sum taken in another order
    "matmul_bf16": {"atol": 1e-2, "rtol": 1e-2},
    # an int8 pool's scales: absmax / 127 of K/V rows computed by two
    # frameworks in fp32 (the rows agree within logits_fp32, so their
    # absmax does too)
    "kv_int8_scales": {"atol": 1e-6, "rtol": 1e-4},
    # flash attention gradients in fp32: the same arithmetic (p recomputed
    # from lse, three or four products over up to 1024 keys or rows) summed
    # in another order, and dk, dv summed over a GQA group
    "attention_grad_fp32": {"atol": 1e-4, "rtol": 1e-4},
    # the same in bf16 on the card, kernel vs plain: both round p m to dO's
    # dtype and ds to q's before the products and the outputs to bf16
    # (2^-8 relative), but a p recomputed in another summation order can
    # round ds to the neighbouring bf16 value
    "attention_grad_bf16": {"atol": 2e-2, "rtol": 2e-2},
    # the ring chunk kernels in fp16 on the card, kernel vs plain: the
    # same roundings as attention_bf16 / attention_grad_bf16 (o, p, ds and
    # the outputs to the working dtype, p and ds after fp32 sums taken in
    # another order) with fp16's 2^-11 in place of bf16's 2^-8; eight of
    # its steps, on outputs of O(1)
    "attention_fp16": {"atol": 4e-3, "rtol": 4e-3},
    "attention_grad_fp16": {"atol": 4e-3, "rtol": 4e-3},
    # LayerNorm in fp32: row statistics and dgamma / dbeta sums over up to
    # 8192 rows of O(1) terms, taken in another order (blocks of 32 rows
    # and a sum of partials on the card, one reduction in the plain one)
    "layer_norm_fp32": {"atol": 1e-4, "rtol": 1e-4},
    # LayerNorm in bf16 on the card: one rounding of y and dx (2^-8
    # relative) on either side of statistics summed in another order, and
    # dgamma / dbeta rounded to bf16 after an fp32 sum
    "layer_norm_bf16": {"atol": 2e-2, "rtol": 2e-2},
    # RMSNorm in fp16 on the card: one rounding of y, dx and dgamma to
    # fp16 after fp32 sums taken in another order, which can land on the
    # neighbouring fp16 value (2^-10 relative at most); rtol allows two
    # such steps, atol the fp32 noise of a dx or dgamma that cancels to 0
    "layer_norm_fp16": {"atol": 2e-3, "rtol": 2e-3},
    # GPT training in fp32, the port against the JAX package on the CPU
    # and the card's run against the CPU's. The loss: a mean over B * S
    # tokens of logsumexp minus a logit, through the same products summed
    # in another order (gpt2_tiny: 1.4e-6 on 6.95)
    "train_loss_fp32": {"atol": 1e-5, "rtol": 1e-5},
    # every gradient of step 1: sums of the same products in another
    # order, largest O(1) (gpt2_tiny: 1.1e-7 at most)
    "train_grads_fp32": {"atol": 1e-6, "rtol": 1e-5},
    # the parameters after 3 AdamW steps. Adam divides each moment by
    # sqrt(v) + 1e-8, so where a gradient is rounding noise the noise is
    # what moves the weight: the K third of qkv_proj.bias has a zero
    # gradient in exact arithmetic (softmax ignores a shift shared by a
    # row's scores), ~2e-11 of noise here, and moves by lr * noise / eps
    # per step (gpt2_tiny at lr 1e-3: 9.3e-6 there, 3e-6 elsewhere)
    "train_params_fp32": {"atol": 5e-5, "rtol": 1e-5},
    # the same at GPT-2 124M widths (54M parameters at L=2), where more
    # elements have a gradient within rounding noise of zero: fp32 against
    # fp64 on the CPU, 3 steps at lr 1e-3, put 55 elements (1e-6 of them,
    # most in the K third of qkv_proj.bias) outside train_params_fp32, by
    # up to 2.1e-4. At most this share of a model's elements may fall
    # outside it, and each by at most per_step_lr * lr per step (Adam's
    # step: m / sqrt(v) stays near 1 when noise drives it)
    "train_params_outliers": {"share": 1e-4, "per_step_lr": 2.0},
    # the fused FFN in fp32 against the JAX package on the CPU (M up to 64,
    # K 128, F 256 or 512): the same products summed in another order
    # (measured: under 2e-6 on O(1) outputs and gradients)
    "ffn_fp32": {"atol": 1e-5, "rtol": 1e-5},
    # the fused FFN kernels in fp32 on the card against their plain
    # versions, at up to M 8192, K 1024, F 3072: dots K or F deep, and the
    # weight gradients sums over up to 8192 rows of O(1) terms (|dW| up to
    # ~100), taken in another order (blocks of rows and partial sums on
    # the card, one product on cuBLAS)
    "ffn_fp32_large": {"atol": 1e-3, "rtol": 1e-4},
    # the same in bf16 (and the port against JAX in bf16 on the CPU): one
    # rounding of each output (2^-8 relative) after fp32 sums in another
    # order, and the activation and dpre rounded to bf16 from a pre
    # computed in another order, which can land on the neighbouring bf16
    # value
    "ffn_bf16": {"atol": 2e-2, "rtol": 2e-2},
    # the bf16 weight gradients dW1 = x^T dpre and dW2 = t^T g, sums over
    # the M rows of products whose factor dpre or t was rounded to bf16:
    # where that factor's fp32 value (pre summed K deep in another order)
    # lies by a rounding boundary, the two sides round it to neighbouring
    # bf16 values, and every element of its dW row moves by 2^-8 |t| |g|,
    # up to ~0.1 for |t| ~ 4 and |g| ~ 5 (at K = 1024, M = 136 this put
    # elements of |dW2| < 5 outside ffn_bf16 by up to 0.125)
    "ffn_wgrad_bf16": {"atol": 0.125, "rtol": 2e-2},
    # an optimizer's update in fp32, the port against the JAX package on
    # the CPU: the same formulas over O(1) parameters and gradients, a
    # few steps, with products and sums rounded in another order (XLA's
    # fused expressions, PyTorch's in-place ops) and the scalars (bias
    # corrections, schedules) taken in fp32 on the host here and on the
    # device there
    "optimizer_fp32": {"atol": 1e-6, "rtol": 1e-5},
    # a bf16 parameter under multi_precision: its fp32 master (held to
    # optimizer_fp32) rounded to bf16 on each side, which lands on the
    # neighbouring bf16 value where the two masters straddle a rounding
    # boundary: one bf16 ulp, 2^-7 relative at most
    "optimizer_bf16_params": {"atol": 0.0, "rtol": 2 ** -7},
    # BERT pretraining under AMP O2 (bf16 parameters and activations,
    # fp32 masters), the port against the JAX package on the CPU, the
    # loss of each of 3 AdamW steps: the activations round to bf16 at
    # other points on each side (the LayerNorm kernel's plain version
    # rounds y once, JAX's composite after normalising, scaling and
    # shifting; products summed in another order), 2^-8 relative each,
    # through two layers into a mean of logsumexp minus a logit, and the
    # masters' updates follow the bf16 gradients (bert_tiny, B 2, S 64:
    # 4.8e-4 on 7.0, held to 4x that)
    "bert_o2_loss_bf16": {"atol": 2e-3, "rtol": 0.0},
}


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when a CUDA device is asked for and
    none is available (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
