"""The optimizers, with Paddle's updates. Counterpart of
``paddle_tpu/optimizer/optimizer.py`` (``Optimizer``, ``SGD``,
``Momentum``, ``Adam``, ``AdamW``, ``Adafactor``, ``Adagrad``,
``Adadelta``, ``RMSProp``, ``Lamb``, ``Adamax``, ``NAdam``, ``RAdam``,
``ASGD``, ``Rprop``).

The updates are the JAX package's formulas, not ``torch.optim``'s (whose
bias corrections and decay orders differ). A step:

1. takes the trainable parameters that hold a gradient, in the order
   they were given, and reads the learning rate (a number, or an
   ``lr.LRScheduler``'s current value; the caller advances the
   scheduler);
2. applies ``grad_clip`` (``nn.clip``) to all of them;
3. updates each parameter at the learning rate times its own scale
   (``p.optimize_attr["learning_rate"]``, set by ``ParamAttr``).

The L2-style decay that all but ``AdamW``, ``Lamb`` and ``Rprop`` fold
into the gradient (``_decayed``) takes the parameter's own
``regularizer`` over the optimizer's ``weight_decay``: a callable (an
``L1Decay`` / ``L2Decay`` object or a function of ``(grad, param)``) is
called, a number is the L2 coefficient. ``AdamW``'s decay is decoupled:
a number, or an object's ``_coeff`` (0.01 for anything else, as in JAX).

Every update works in fp32: on the parameter itself, or with
``multi_precision`` and a bf16 / fp16 parameter on an fp32 master that
is seeded from the parameter's value at its first update (so under
``amp.decorate`` the masters hold the rounded values, as JAX's do) and
rounded into the parameter after each update. Tensor accumulators are
fp32 on the parameter's device; the scalar ones (``beta1_pow``, a step
count, ...) are fp32 numbers on the host, so they cost no launch.

JAX's ``_fused_eager_step`` (the whole step as one compiled program) is
how XLA runs the update, not part of its semantics: here each parameter
is updated in turn. ``state_dict`` keys are JAX's: ``<name>_<slot>``,
``<name>_master``, ``LR_Scheduler`` and ``@step``, where ``<name>`` is
the name the parameter was given with (``model.named_parameters()``) or
``param_<i>`` by its position.

A parameter may be a shard of a larger one (the GroupSharded stages step
one shard tensor per sharded parameter; it carries ``_shard_info``). The
elementwise updates run on it as they are; where an update reads a
statistic of the whole parameter (``Lamb``'s trust ratio, ``Adafactor``'s
means and RMS), the shard's partial sum is summed over the group that
holds the shards (``_norm``, ``_mean``), so each shard takes the step of
the whole parameter.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adafactor",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Adamax", "NAdam",
           "RAdam", "ASGD", "Rprop"]

f32 = np.float32
# the accumulators held as fp32 numbers on the host
SCALAR_ACCUMULATORS = ("beta1_pow", "beta2_pow", "step", "mu_prod")


def _flatten(parameters):
    """(name, tensor) pairs from tensors, pairs or parameter groups
    (dicts whose ``params`` are flattened, as JAX does)."""
    out = []
    for item in parameters:
        if isinstance(item, dict):
            out.extend(_flatten(item["params"]))
        else:
            out.append(item if isinstance(item, tuple)
                       else (getattr(item, "name", None), item))
    return [(name if name else f"param_{i}", p)
            for i, (name, p) in enumerate(out)]


def _host_tensor(val, like):
    """``val`` (a tensor, numpy array or number) as an fp32 tensor on
    ``like``'s device."""
    t = val if isinstance(val, torch.Tensor) else torch.from_numpy(
        np.array(val, np.float32))
    return t.to(device=like.device, dtype=torch.float32).clone()


class Optimizer:
    """``parameters``: tensors, ``(name, tensor)`` pairs such as
    ``model.named_parameters()``, or parameter groups. ``name`` is taken
    and, as in JAX, unused."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("the port's optimizers take parameters= (there "
                             "is no global parameter registry)")
        if not isinstance(learning_rate, (numbers.Real, LRScheduler)):
            raise TypeError(f"learning_rate must be a number or an "
                            f"LRScheduler, got {learning_rate!r}")
        self._lr = learning_rate
        self._params = _flatten(parameters)
        self._names = {id(p): n for n, p in self._params}
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._accumulators: dict[str, dict[int, object]] = {}
        self._master_weights: dict[int, torch.Tensor] = {}
        self._step_count = 0

    # ----------------------------------------------------------------- lr
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return float(self._lr)

    def set_lr(self, value: float):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler):
        self._lr = scheduler

    @property
    def _learning_rate(self):
        return self._lr

    # --------------------------------------------------------- accumulators
    def _acc(self, name, p, init=None):
        """The accumulator ``name`` of p, created at first use: fp32
        zeros of the master's shape, or ``init`` (a value, or a callable
        evaluated then)."""
        slot = self._accumulators.setdefault(name, {})
        if id(p) not in slot:
            if init is None:
                slot[id(p)] = torch.zeros_like(self._master(p),
                                               dtype=torch.float32)
            else:
                slot[id(p)] = init() if callable(init) else init
        return slot[id(p)]

    def _set(self, name, p, value):
        self._accumulators[name][id(p)] = value
        return value

    def _seed_master(self, p, value):
        """The fp32 master of p, created from ``value`` if it has none."""
        if id(p) not in self._master_weights:
            self._master_weights[id(p)] = _host_tensor(value, p)
        return self._master_weights[id(p)]

    def _master(self, p):
        """The fp32 master under multi_precision for a low-precision p,
        else p itself."""
        if not self._multi_precision or p.dtype == torch.float32:
            return p
        return self._seed_master(p, p.detach())

    # ----------------------------------------------------------------- step
    @torch.no_grad()
    def step(self):
        params_grads = [(p, p.grad) for _, p in self._params
                        if p.requires_grad and p.grad is not None]
        lr = self.get_lr()
        self._step_count += 1
        self._step_core(params_grads, lr)

    def _step_core(self, params_grads, lr):
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        for p, g in params_grads:
            scale = getattr(p, "optimize_attr", None)
            self._update_param(p, g, lr * scale["learning_rate"] if scale
                               else lr)

    def _update_param(self, p, g, lr):
        raise NotImplementedError

    def _apply(self, p, new):
        """Write the updated fp32 value into the master and the
        parameter (rounded to its dtype)."""
        m = self._master(p)
        if m is not p:
            m.copy_(new)
        p.copy_(new)

    def _decayed(self, p, g32, m32):
        """The L2-style decay folded into the gradient: p's own
        regularizer over the optimizer's weight_decay."""
        reg = getattr(p, "regularizer", None)
        wd = self._weight_decay if reg is None else reg
        if wd is None:
            return g32
        if callable(wd):
            return wd(g32, m32)
        coeff = (float(wd) if isinstance(wd, numbers.Real)
                 else getattr(wd, "_coeff", getattr(wd, "coeff", 0.0)))
        return g32 + coeff * m32

    def _grad32(self, p, g):
        """(master, decayed fp32 gradient)."""
        mw = self._master(p)
        return mw, self._decayed(p, g.float(), mw)

    @staticmethod
    def _norm(x, p):
        """The L2 norm of ``x`` (laid out as p), over the whole parameter
        where p is a shard."""
        info = getattr(p, "_shard_info", None)
        if info is None:
            return torch.linalg.vector_norm(x)
        return info.psum(x.float().square().sum()).sqrt()

    @staticmethod
    def _mean(x, p, dims):
        """``x.mean(dims, keepdim=True)`` for ``x`` of p's rank, over the
        whole parameter where p is a shard split along one of ``dims``."""
        info = getattr(p, "_shard_info", None)
        dims = tuple(d % x.dim() for d in dims)
        if info is None or info.axis not in dims:
            return x.mean(dims, keepdim=True)
        count = 1
        for d in dims:
            count *= info.full_shape[d]
        return info.psum(x.sum(dims, keepdim=True)) / count

    def clear_grad(self, set_to_zero: bool = False):
        """Drop every gradient, or with ``set_to_zero`` zero those that
        exist, as JAX's ``clear_gradient`` does."""
        for _, p in self._params:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # ------------------------------------------------------------- state io
    def state_dict(self) -> dict:
        sd: dict = {}
        for acc_name, slot in self._accumulators.items():
            for pid, t in slot.items():
                sd[f"{self._names[pid]}_{acc_name}"] = t
        for pid, t in self._master_weights.items():
            sd[f"{self._names[pid]}_master"] = t
        if isinstance(self._lr, LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
        sd["@step"] = self._step_count
        return sd

    def set_state_dict(self, state_dict: dict):
        """Load a ``state_dict`` (tensors, numpy arrays or numbers),
        matching each key to the longest parameter name it starts with."""
        self._step_count = int(state_dict.get("@step", 0))
        if "LR_Scheduler" in state_dict and isinstance(self._lr,
                                                       LRScheduler):
            self._lr.set_state_dict(state_dict["LR_Scheduler"])
        by_name = sorted(self._params, key=lambda np_: -len(np_[0]))
        for key, val in state_dict.items():
            if key in ("LR_Scheduler", "@step"):
                continue
            for pname, p in by_name:
                if not key.startswith(pname + "_"):
                    continue
                suffix = key[len(pname) + 1:]
                if suffix == "master":
                    self._master_weights[id(p)] = _host_tensor(val, p)
                elif suffix in SCALAR_ACCUMULATORS:
                    self._accumulators.setdefault(suffix, {})[id(p)] = f32(
                        np.asarray(val.cpu() if isinstance(val, torch.Tensor)
                                   else val))
                else:
                    self._accumulators.setdefault(suffix, {})[id(p)] = \
                        _host_tensor(val, p)
                break

    set_dict = set_state_dict

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """The dygraph branch of JAX's: backward, step, clear the grads.
        ``startup_program``, ``parameters`` and ``no_grad_set`` are taken
        and unused."""
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update_param(self, p, g, lr):
        m, g32 = self._grad32(p, g)
        self._apply(p, m - lr * g32)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update_param(self, p, g, lr):
        m, g32 = self._grad32(p, g)
        v_new = self._set("velocity", p,
                          self._momentum * self._acc("velocity", p) + g32)
        upd = g32 + self._momentum * v_new if self._nesterov else v_new
        self._apply(p, m - lr * upd)


class Adam(Optimizer):
    """Adam with an L2 ``weight_decay`` folded into the gradient.
    ``lazy_mode``, ``use_multi_tensor`` and ``name`` are taken and, as in
    JAX, unused. The update runs in place on the moments and the
    master."""

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
            g32 = self._decayed(p, g32, mw)
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        b1p = self._set("beta1_pow", p, f32(
            self._acc("beta1_pow", p, f32(1.0)) * f32(self._beta1)))
        b2p = self._set("beta2_pow", p, f32(
            self._acc("beta2_pow", p, f32(1.0)) * f32(self._beta2)))
        m.mul_(self._beta1).add_(g32, alpha=1 - self._beta1)
        v.mul_(self._beta2).addcmul_(g32, g32, value=1 - self._beta2)
        upd = (m / float(f32(1) - b1p)) / (
            (v / float(f32(1) - b2p)).sqrt_().add_(self._epsilon))
        if decoupled_wd:
            upd.add_(mw, alpha=decoupled_wd)
        if mw is p:
            p.add_(upd, alpha=-lr)
        else:
            mw.add_(upd, alpha=-lr)
            p.copy_(mw)

    def _update_param(self, p, g, lr):
        self._adam_update(p, g, lr, 0.0)


class AdamW(Adam):
    """Adam with decoupled weight decay. ``apply_decay_param_fun(name)``
    returning False skips the decay of that parameter (it then takes
    ``_decayed``'s, as in JAX); ``lr_ratio(p)`` scales its rate.
    ``lazy_mode`` and ``name`` are taken and, as in JAX, unused."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision)
        self._wd_coeff = (float(weight_decay)
                          if isinstance(weight_decay, numbers.Real)
                          else getattr(weight_decay, "_coeff", 0.01))
        self._apply_decay_fn = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _update_param(self, p, g, lr):
        wd = self._wd_coeff
        if self._apply_decay_fn is not None and not self._apply_decay_fn(
                self._names[id(p)]):
            wd = 0.0
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        self._adam_update(p, g, lr, wd)


class Adafactor(Optimizer):
    """Factored second moments (Shazeer & Stern 2018) as the JAX package
    runs them: beta2_t = 1 - t^-decay_rate, the last two axes of a
    parameter of rank 2 or more factored into row and column statistics,
    the update clipped to ``clip_threshold`` by its RMS, the lr scaled by
    the parameter's RMS with ``scale_parameter``; no relative step."""

    # the factored moments: means over the last axis and the one before
    _reduced_axes = {"vrow": -1, "vcol": -2}

    def __init__(self, learning_rate=1e-3, beta1=None, decay_rate=0.8,
                 epsilon1=1e-30, epsilon2=1e-3, clip_threshold=1.0,
                 scale_parameter=True, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._decay_rate = decay_rate
        self._eps1 = epsilon1
        self._eps2 = epsilon2
        self._clip_threshold = clip_threshold
        self._scale_parameter = scale_parameter

    def _update_param(self, p, g, lr):
        mw, g32 = self._grad32(p, g)
        t = self._set("step", p, f32(self._acc("step", p, f32(0.0)) + 1))
        beta2_t = float(f32(1) - t ** f32(-self._decay_rate))
        g2 = g32 * g32 + self._eps1
        every = tuple(range(p.dim()))
        if p.dim() >= 2:
            vr = self._acc("vrow", p, lambda: torch.zeros(
                p.shape[:-1], device=p.device))
            vc = self._acc("vcol", p, lambda: torch.zeros(
                (*p.shape[:-2], p.shape[-1]), device=p.device))
            vr = self._set("vrow", p, beta2_t * vr + (1 - beta2_t)
                           * self._mean(g2, p, (-1,)).squeeze(-1))
            vc = self._set("vcol", p, beta2_t * vc + (1 - beta2_t)
                           * self._mean(g2, p, (-2,)).squeeze(-2))
            denom = self._mean(vr[..., None], p, (-2,))
            vhat = (vr[..., None] / denom.clamp(min=self._eps1)) \
                * vc[..., None, :]
        else:
            vhat = self._set("moment2", p, beta2_t * self._acc("moment2", p)
                             + (1 - beta2_t) * g2)
        u = g32 / vhat.clamp(min=self._eps1).sqrt()
        rms_u = (self._mean(u * u, p, every) + self._eps1).sqrt()
        u = u / torch.clamp(rms_u / self._clip_threshold, min=1.0)
        if self._beta1 is not None:
            u = self._set("moment1", p, self._beta1 * self._acc("moment1", p)
                          + (1 - self._beta1) * u)
        alpha = lr
        if self._scale_parameter:
            alpha = lr * torch.clamp(self._mean(mw * mw, p, every).sqrt(),
                                     min=self._eps2)
        self._apply(p, mw - alpha * u)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _update_param(self, p, g, lr):
        m, g32 = self._grad32(p, g)
        acc = self._acc("moment", p, lambda: torch.full_like(
            m, self._init_acc, dtype=torch.float32))
        acc = self._set("moment", p, acc + g32 * g32)
        self._apply(p, m - lr * g32 / (acc.sqrt() + self._epsilon))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = epsilon
        self._rho = rho

    def _update_param(self, p, g, lr):
        m, g32 = self._grad32(p, g)
        rho, eps = self._rho, self._epsilon
        avg_sq = self._set("_avg_squared_grad", p, rho * self._acc(
            "_avg_squared_grad", p) + (1 - rho) * g32 * g32)
        avg_upd = self._acc("_avg_squared_update", p)
        upd = ((avg_upd + eps).sqrt() / (avg_sq + eps).sqrt()) * g32
        self._set("_avg_squared_update", p,
                  rho * avg_upd + (1 - rho) * upd * upd)
        self._apply(p, m - lr * upd)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _update_param(self, p, g, lr):
        mw, g32 = self._grad32(p, g)
        rho = self._rho
        ms = self._set("mean_square", p, rho * self._acc("mean_square", p)
                       + (1 - rho) * g32 * g32)
        mom = self._acc("momentum", p)
        denom = ms
        if self._centered:
            mg = self._set("mean_grad", p, rho * self._acc("mean_grad", p)
                           + (1 - rho) * g32)
            denom = denom - mg * mg
        mom = self._set("momentum", p, self._momentum * mom
                        + lr * g32 / (denom + self._epsilon).sqrt())
        self._apply(p, mw - mom)


def _adam_moments(opt, p, g32, beta1, beta2):
    """Update moment1 / moment2 of p with g32; returns (m, v)."""
    m = opt._set("moment1", p, beta1 * opt._acc("moment1", p)
                 + (1 - beta1) * g32)
    v = opt._set("moment2", p, beta2 * opt._acc("moment2", p)
                 + (1 - beta2) * g32 * g32)
    return m, v


def _pow_step(opt, name, p, beta):
    """Advance the host scalar ``name`` (a power of ``beta``) of p."""
    return opt._set(name, p, f32(opt._acc(name, p, f32(1.0)) * f32(beta)))


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._wd = lamb_weight_decay
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update_param(self, p, g, lr):
        mw = self._master(p)
        m, v = _adam_moments(self, p, g.float(), self._beta1, self._beta2)
        b1p = _pow_step(self, "beta1_pow", p, self._beta1)
        b2p = _pow_step(self, "beta2_pow", p, self._beta2)
        mhat = m / float(f32(1) - b1p)
        vhat = v / float(f32(1) - b2p)
        wd = self._wd
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        r = mhat / (vhat.sqrt() + self._epsilon) + wd * mw
        w_norm = self._norm(mw, p)
        r_norm = self._norm(r, p)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones((), device=mw.device))
        self._apply(p, mw - lr * trust * r)


class Adamax(Optimizer):
    """Adam with an infinity-norm second moment (no bias correction on
    it)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update_param(self, p, g, lr):
        mw, g32 = self._grad32(p, g)
        b1p = _pow_step(self, "beta1_pow", p, self._beta1)
        m = self._set("moment", p, self._beta1 * self._acc("moment", p)
                      + (1 - self._beta1) * g32)
        u = self._set("inf_norm", p, torch.maximum(
            self._beta2 * self._acc("inf_norm", p), g32.abs()))
        self._apply(p, mw - (lr / float(f32(1) - b1p)) * m
                    / (u + self._epsilon))


class NAdam(Optimizer):
    """Adam with Nesterov momentum and the momentum schedule
    mu_t = beta1 (1 - 0.96^(t psi) / 2)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._psi = momentum_decay

    def _update_param(self, p, g, lr):
        mw, g32 = self._grad32(p, g)
        b1, psi = f32(self._beta1), f32(self._psi)
        t = self._set("step", p, f32(self._acc("step", p, f32(0.0)) + 1))
        mu_t = f32(b1 * (f32(1) - f32(0.5) * f32(0.96) ** (t * psi)))
        mu_next = f32(b1 * (f32(1) - f32(0.5)
                            * f32(0.96) ** ((t + f32(1)) * psi)))
        mu_prod = self._set("mu_prod", p, f32(
            self._acc("mu_prod", p, f32(1.0)) * mu_t))
        b2p = _pow_step(self, "beta2_pow", p, self._beta2)
        m, v = _adam_moments(self, p, g32, self._beta1, self._beta2)
        mhat = (float(mu_next) * m / float(f32(1) - mu_prod * mu_next)
                + float(f32(1) - mu_t) * g32 / float(f32(1) - mu_prod))
        vhat = v / float(f32(1) - b2p)
        self._apply(p, mw - lr * mhat / (vhat.sqrt() + self._epsilon))


class RAdam(Optimizer):
    """Rectified Adam: the variance rectification picks Adam's step
    (rho_t > 5) or SGD with momentum's."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update_param(self, p, g, lr):
        mw, g32 = self._grad32(p, g)
        t = self._set("step", p, f32(self._acc("step", p, f32(0.0)) + 1))
        b1p = f32(self._beta1) ** t
        b2p = f32(self._beta2) ** t
        m, v = _adam_moments(self, p, g32, self._beta1, self._beta2)
        mhat = m / float(f32(1) - b1p)
        rho_inf = f32(2.0 / (1 - self._beta2) - 1.0)
        rho_t = f32(rho_inf - f32(2) * t * b2p / (f32(1) - b2p))
        if rho_t > 5.0:
            r = np.sqrt(max(f32((rho_t - 4) * (rho_t - 2) * rho_inf / max(
                f32((rho_inf - 4) * (rho_inf - 2) * rho_t), f32(1e-12))),
                f32(0)))
            upd = float(r) * mhat / ((v / float(f32(1) - b2p)).sqrt()
                                     + self._epsilon)
        else:
            upd = mhat
        self._apply(p, mw - lr * upd)


class ASGD(Optimizer):
    """Averaged SGD: each step moves by the mean of the last
    ``batch_num`` gradients (d <- d - ys[i] + g; ys[i] <- g), and keeps a
    running average of the parameter (``averaged_value``)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._batch_num = int(batch_num)

    def _update_param(self, p, g, lr):
        mw, g32 = self._grad32(p, g)
        n = self._batch_num
        t = self._acc("step", p, f32(0.0))
        avg = self._acc("averaged", p, lambda: mw.float().clone())
        d = self._acc("d", p)
        ys = self._acc("ys", p, lambda: torch.zeros(
            (n, *mw.shape), device=mw.device))
        idx = int(t % n)
        d = self._set("d", p, d - ys[idx] + g32)
        ys = ys.clone()
        ys[idx] = g32
        self._set("ys", p, ys)
        self._set("step", p, f32(t + 1))
        new = mw - lr * d / float(min(t + 1, n))
        self._set("averaged", p, avg + (new - avg) / float(t + 1))
        self._apply(p, new)

    def averaged_value(self, p):
        return self._acc("averaged", p)


class Rprop(Optimizer):
    """Resilient backprop (Rprop-): per-element step sizes grown by
    ``etas[1]`` where the gradient keeps its sign, shrunk by ``etas[0]``
    where it flips (and that gradient zeroed), kept in
    ``learning_rate_range``."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         name, multi_precision)
        self._eta_minus, self._eta_plus = etas
        self._lr_min, self._lr_max = learning_rate_range

    def _update_param(self, p, g, lr):
        mw = self._master(p)
        g32 = g.float()
        prev = self._acc("prev_grad", p)
        steps = self._acc("step_size", p, lambda: torch.full_like(
            mw, lr, dtype=torch.float32))
        sign = g32 * prev
        grow, shrink = sign > 0, sign < 0
        steps = self._set("step_size", p, torch.where(
            grow, steps * self._eta_plus, torch.where(
                shrink, steps * self._eta_minus, steps)).clamp(
            self._lr_min, self._lr_max))
        eff = self._set("prev_grad", p, torch.where(
            shrink, torch.zeros((), device=g32.device), g32))
        self._apply(p, mw - torch.sign(eff) * steps)
