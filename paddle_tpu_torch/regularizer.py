"""Weight-decay regularizers. Counterpart of ``paddle_tpu/regularizer.py``.

A regularizer is a callable on ``(grad, param)``, both fp32 tensors of
the parameter's shape (its master under ``multi_precision``), returning
the gradient with the decay folded in. The optimizer applies a
parameter's own ``regularizer`` (``ParamAttr(regularizer=)``) before its
own ``weight_decay``.
"""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay", "WeightDecayRegularizer"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    @property
    def _coeff(self):
        """The coefficient, under the name the optimizers read."""
        return self.coeff

    def __call__(self, grad_arr, param_arr):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    """grad + coeff * param."""

    def __call__(self, grad_arr, param_arr):
        return grad_arr + self.coeff * param_arr


class L1Decay(WeightDecayRegularizer):
    """grad + coeff * sign(param)."""

    def __call__(self, grad_arr, param_arr):
        return grad_arr + self.coeff * torch.sign(param_arr)
