"""Automatic mixed precision. Counterpart of ``paddle_tpu/amp/``:
``auto_cast`` (O1's casts in ``nn.functional.linear`` and
``fused_concat_linear``), ``decorate`` (O2: the model cast to the low
dtype, fp32 masters in the optimizer), ``GradScaler`` and
``debugging``."""
import torch

from . import debugging
from .auto_cast import (amp_guard, auto_cast, black_list, decorate,
                        get_amp_dtype, is_auto_cast_enabled, white_list)
from .grad_scaler import AmpScaler, GradScaler, OptimizerState

__all__ = ["AmpScaler", "GradScaler", "OptimizerState", "amp_guard",
           "auto_cast", "black_list", "debugging", "decorate",
           "get_amp_dtype", "is_auto_cast_enabled", "is_bfloat16_supported",
           "is_float16_supported", "white_list"]


def _on_card(device):
    return torch.device("cuda" if device is None else device).type == "cuda"


def is_bfloat16_supported(device=None):
    """bf16 on ``device`` (default the card): the CPU always; a CUDA card
    where there is one that supports it."""
    if not _on_card(device):
        return True
    return torch.cuda.is_available() and torch.cuda.is_bf16_supported()


def is_float16_supported(device=None):
    """fp16 on ``device`` (default the card): the CPU always; a CUDA card
    where there is one."""
    return not _on_card(device) or torch.cuda.is_available()
