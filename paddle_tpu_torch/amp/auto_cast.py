"""``auto_cast`` and ``decorate``. Counterpart of
``paddle_tpu/amp/auto_cast.py``.

O1: inside ``auto_cast`` the white-list functionals cast their floating
inputs to the amp dtype (``cast_if_amp``), which the port calls where
the JAX package does: ``nn.functional.linear`` and
``fused_concat_linear``. Everything else keeps its inputs' dtypes (a
LayerNorm whose input and weight differ in dtype takes the composite).
O2: ``decorate`` casts the models' floating parameters and buffers to
the low dtype in place (the same ``nn.Parameter`` objects, so an
optimizer built before keeps them) and turns on the optimizers'
``multi_precision``: their fp32 masters are seeded from the rounded
values at the first step.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["auto_cast", "amp_guard", "decorate", "amp_state", "white_list",
           "black_list", "is_auto_cast_enabled", "get_amp_dtype"]

WHITE_LIST = {"matmul", "linear", "conv", "einsum", "bmm", "mm", "attention"}
BLACK_LIST = {"softmax", "log_softmax", "layer_norm", "cross_entropy", "mean",
              "sum", "exp", "log", "pow"}


def _dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_amp = _AmpState()


def amp_state():
    return _amp


def is_auto_cast_enabled() -> bool:
    return _amp.enabled


def get_amp_dtype():
    return _amp.dtype


def white_list():
    return (WHITE_LIST | _amp.custom_white) - _amp.custom_black


def black_list():
    return (BLACK_LIST | _amp.custom_black) - _amp.custom_white


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    prev = (_amp.enabled, _amp.dtype, _amp.level, _amp.custom_white,
            _amp.custom_black)
    _amp.enabled = enable
    _amp.dtype = _dtype(dtype)
    _amp.level = level
    _amp.custom_white = set(custom_white_list or ())
    _amp.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_amp.enabled, _amp.dtype, _amp.level, _amp.custom_white,
         _amp.custom_black) = prev


amp_guard = auto_cast


def cast_if_amp(op_name: str, *arrays):
    """Inside ``auto_cast``, a white-list op's floating inputs cast to
    the amp dtype; otherwise the inputs as they are."""
    if not _amp.enabled or op_name not in white_list():
        return arrays
    return tuple(t.to(_amp.dtype) if t.is_floating_point() else t
                 for t in arrays)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: the models cast to ``dtype`` and the optimizers'
    ``multi_precision`` on (unless ``master_weight`` is False); O1 leaves
    both. Returns what it was given, as JAX's does."""
    dt = _dtype(dtype)
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dt)
    if optimizers is None:
        return model_list[0] if single_model else model_list
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    if level == "O2" and (master_weight is None or master_weight):
        for o in opt_list:
            o._multi_precision = True
    return (model_list[0] if single_model else model_list,
            opt_list[0] if single_opt else opt_list)
