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
    # fp32 logits through two layers of products summed in another order
    "logits_fp32": {"atol": 1e-4, "rtol": 1e-4},
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
