"""NaN / inf checks. Counterpart of ``paddle_tpu/amp/debugging.py``.

``check_numerics`` counts a tensor's NaNs and infs (one host read) and
raises ``FloatingPointError`` unless a tensor checker is on in a mode
that only reports. ``enable_tensor_checker`` stands where the JAX package
turns on ``jax_debug_nans``: here it turns on autograd's anomaly
detection, which raises where a backward function returns a NaN.
Operator statistics are taken and, as in JAX, not collected.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["check_numerics", "enable_operator_stats_collection",
           "disable_operator_stats_collection", "TensorCheckerConfig",
           "enable_tensor_checker", "disable_tensor_checker",
           "collect_operator_stats", "DebugMode"]


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 4


class TensorCheckerConfig:
    def __init__(self, enable=True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None, skipped_op_list=None,
                 debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode


_checker = {"config": None}


def enable_tensor_checker(config: TensorCheckerConfig):
    _checker["config"] = config
    torch.autograd.set_detect_anomaly(bool(config.enable))


def disable_tensor_checker():
    _checker["config"] = None
    torch.autograd.set_detect_anomaly(False)


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """(NaN count, inf count) of ``tensor`` as 0-d int64 tensors."""
    counts = torch.stack([torch.isnan(tensor).sum(),
                          torch.isinf(tensor).sum()]).cpu()
    n_nan, n_inf = int(counts[0]), int(counts[1])
    if n_nan or n_inf:
        msg = (f"check_numerics: op={op_type} var={var_name} "
               f"nan={n_nan} inf={n_inf}")
        cfg = _checker["config"]
        if cfg is None or cfg.debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
            raise FloatingPointError(msg)
        print(msg)
    return counts[0], counts[1]


_op_stats: dict = {}


def enable_operator_stats_collection():
    _op_stats.clear()


def disable_operator_stats_collection():
    pass


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    yield
    disable_operator_stats_collection()
