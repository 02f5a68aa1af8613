"""Optimizer base, Adam and AdamW with Paddle's update. Counterpart of
``paddle_tpu/optimizer/optimizer.py`` (``Optimizer``, ``Adam``,
``AdamW``).

The update is Paddle's, not ``torch.optim.AdamW``'s (whose bias correction
and decay order differ): per parameter, fp32 moments m and v and the
powers beta1^t and beta2^t, then

    m = beta1 m + (1 - beta1) g,   v = beta2 v + (1 - beta2) g^2
    new = master - lr (m / (1 - beta1^t) / (sqrt(v / (1 - beta2^t)) + eps)
                       + wd master)

where ``wd`` is AdamW's decoupled decay (``Adam`` folds an L2
``weight_decay`` into g instead) and ``master`` is the parameter itself or,
with ``multi_precision`` and a bf16/fp16 parameter, an fp32 copy that the
update keeps and rounds into the parameter. The powers are fp32 numbers
kept on the host (the JAX package keeps them as fp32 scalars on the
device), so they cost no launch. Moments and masters live on the
parameter's device; the update runs in place under ``torch.no_grad``.

Not ported yet (ROADMAP Queue 1 item 10): learning-rate schedulers,
``grad_clip``, the other optimizers, ``state_dict``, ``minimize``,
``L2Decay`` objects and callables as ``weight_decay`` (a real number is
the decay coefficient; anything else is refused at construction).
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

__all__ = ["Optimizer", "Adam", "AdamW"]


def _check_weight_decay(weight_decay):
    """Refuse a ``weight_decay`` that is not a real coefficient."""
    if not isinstance(weight_decay, numbers.Real):
        raise NotImplementedError(
            f"weight_decay={weight_decay!r}: only a real coefficient is "
            "ported; L2Decay objects, callables and a parameter's own "
            "regularizer are not ported yet (ROADMAP Queue 1 item 10(e), "
            "regularizer)")


class Optimizer:
    """``parameters``: tensors, or ``(name, tensor)`` pairs such as
    ``model.named_parameters()`` (the names are what
    ``apply_decay_param_fun`` sees). ``name`` is taken and, as in JAX,
    unused."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("the port's optimizers take parameters= (there "
                             "is no global parameter registry)")
        if not isinstance(learning_rate, numbers.Real):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet (ROADMAP Queue "
                "1 item 10, optimizer); pass a number")
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not ported yet (ROADMAP Queue 1 item 10, "
                "optimizer)")
        if weight_decay is not None:
            _check_weight_decay(weight_decay)
        self._lr = float(learning_rate)
        self._params = [p if isinstance(p, tuple)
                        else (getattr(p, "name", None), p)
                        for p in parameters]
        self._weight_decay = weight_decay
        self._multi_precision = multi_precision
        self._accumulators: dict[str, dict[int, object]] = {}
        self._master_weights: dict[int, torch.Tensor] = {}

    def _acc(self, name, p, init=None):
        """The accumulator ``name`` of p, created on first use: zeros like
        p's master, or ``init``."""
        slot = self._accumulators.setdefault(name, {})
        if id(p) not in slot:
            slot[id(p)] = (torch.zeros_like(self._master(p)) if init is None
                           else init)
        return slot[id(p)]

    def _master(self, p):
        """The fp32 master of p under multi_precision for a low-precision
        p, else p itself."""
        if not self._multi_precision or p.dtype == torch.float32:
            return p
        if id(p) not in self._master_weights:
            self._master_weights[id(p)] = p.detach().float()
        return self._master_weights[id(p)]

    @torch.no_grad()
    def step(self):
        for name, p in self._params:
            if p.requires_grad and p.grad is not None:
                self._update_param(name, p, p.grad, self._lr)

    def _update_param(self, name, p, g, lr):
        raise NotImplementedError

    def _apply(self, p, master):
        """Round an updated master into its low-precision parameter."""
        if master is not p:
            p.copy_(master)

    def _decayed(self, g32, m32):
        """L2 decay folded into the gradient (Paddle's ``weight_decay``
        for optimizers other than AdamW)."""
        if self._weight_decay is None:
            return g32
        return g32 + self._weight_decay * m32

    def clear_grad(self, set_to_zero: bool = False):
        """Drop every gradient, or with ``set_to_zero`` zero those that
        exist, as JAX's ``clear_gradient`` does."""
        for _, p in self._params:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None


class Adam(Optimizer):
    """Adam with an L2 ``weight_decay`` folded into the gradient.
    ``lazy_mode``, ``use_multi_tensor`` and ``name`` are taken and, as in
    JAX, unused."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _adam_update(self, p, g, lr, decoupled_wd=0.0):
        mw = self._master(p)
        g32 = g.float()
        if decoupled_wd == 0.0:
            g32 = self._decayed(g32, mw)
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        f32 = np.float32
        b1p = self._accumulators["beta1_pow"][id(p)] = f32(
            self._acc("beta1_pow", p, f32(1.0)) * f32(self._beta1))
        b2p = self._accumulators["beta2_pow"][id(p)] = f32(
            self._acc("beta2_pow", p, f32(1.0)) * f32(self._beta2))
        m.mul_(self._beta1).add_(g32, alpha=1 - self._beta1)
        v.mul_(self._beta2).addcmul_(g32, g32, value=1 - self._beta2)
        upd = (m / float(f32(1) - b1p)) / (
            (v / float(f32(1) - b2p)).sqrt_().add_(self._epsilon))
        if decoupled_wd:
            upd.add_(mw, alpha=decoupled_wd)
        mw.add_(upd, alpha=-lr)
        self._apply(p, mw)

    def _update_param(self, name, p, g, lr):
        self._adam_update(p, g, lr, 0.0)


class AdamW(Adam):
    """Adam with decoupled weight decay. ``apply_decay_param_fun(name)``
    returning False skips the decay of that parameter; ``lr_ratio(p)``
    scales its learning rate. ``lazy_mode`` and ``name`` are taken and,
    as in JAX, unused."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision)
        _check_weight_decay(weight_decay)
        self._wd_coeff = float(weight_decay)
        self._apply_decay_fn = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _update_param(self, name, p, g, lr):
        wd = self._wd_coeff
        if self._apply_decay_fn is not None and not self._apply_decay_fn(
                name):
            wd = 0.0
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        self._adam_update(p, g, lr, wd)
